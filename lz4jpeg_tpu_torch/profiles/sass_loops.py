"""The instruction mix of each kernel's innermost loops, from its SASS.

    python -m lz4jpeg_tpu_torch.profiles.sass_loops SOURCE [SOURCE ...]
        [--output F.json]

SOURCE names a file ``lz4jpeg_tpu_torch/csrc/SOURCE.cu``.  Each is
compiled and disassembled by ``sass_diff.py``'s own step (``nvcc -cubin``
with ``kernels/build.py``'s device flags, then ``cuobjdump -sass``); a
loop is a branch back to an earlier instruction (sm_90 instructions are 16
bytes apart, so a target address is an instruction index times 16), and
an innermost loop one that holds no other.  For every kernel it prints
each innermost loop's length and its tensor-core instructions (``HMMA``,
``IMMA``), shared-memory fragment loads (``LDSM``), shared stores and loads
(``STS``, ``LDS``), generic loads (``LD``: what ``nvcuda::wmma`` fragment
loads became), global loads (``LDG``) and shuffles (``SHFL``), and with
``--output`` every opcode's count (``mix``).  ``band_path`` counts the
forward megakernel's band loop along its aligned route's path.  The one-hot
gathers' k-loop is the innermost loop with ``HMMA`` or ``IMMA``: two
k-slices an iteration.  ``spill_stores(source)`` gives each kernel's
spill-store bytes from ptxas.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``,
``cu++filt``), not a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path
from typing import Dict, List

REPO = Path(__file__).resolve().parents[2]
COUNTED = ("HMMA", "IMMA", "LDSM", "STS", "LDS", "LD", "LDG", "SHFL")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")


def opcode(instruction: str) -> str:
    """The opcode of a SASS instruction without its predicate and
    modifiers: ``@!P0 LDSM.16.MT88.4 R4, [R2]`` → ``LDSM``."""
    words = instruction.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def loops(instructions: List[str]) -> List[Dict]:
    """The innermost loops of a function's instructions: each as its first
    and last index, its length, the count of every opcode of ``COUNTED``
    and of every opcode (``mix``), all over the instructions that can
    execute (ptxas pads each ``LDGSTS`` with ``@!PT LDS``, never
    executed)."""
    spans = _spans(instructions)
    inner = [s for s in spans
             if not any(o != s and s[0] <= o[0] and o[1] <= s[1]
                        for o in spans)]
    result = []
    for first, last in sorted(set(inner)):
        ops = [opcode(x) for x in instructions[first:last + 1]
               if not x.startswith("@!PT ")]  # never executed
        result.append({"first": first, "last": last, "length": len(ops),
                       **{c: ops.count(c) for c in COUNTED},
                       "mix": dict(Counter(ops).most_common())})
    return result


def _blocks(instructions: List[str], first: int, last: int):
    """The basic blocks of instructions[first..last]: leaders at ``first``,
    at every branch target inside and after every branch; returns [(start,
    end)] (end inclusive) and each block's successor indices."""
    leaders = {first}
    for i in range(first, last + 1):
        ins = instructions[i]
        m = _TARGET.search(ins)
        if opcode(ins) in ("BRA", "EXIT", "RET") and i < last:
            leaders.add(i + 1)
        if opcode(ins) == "BRA" and m:
            t = int(m.group(1), 16) // 16
            if first <= t <= last:
                leaders.add(t)
    starts = sorted(leaders)
    blocks = [(a, (starts[k + 1] - 1) if k + 1 < len(starts) else last)
              for k, a in enumerate(starts)]
    index = {a: k for k, (a, _) in enumerate(blocks)}
    succ = []
    for a, b in blocks:
        ins = instructions[b]
        nxt = []
        unconditional = ins.split()[0] in ("BRA", "EXIT", "RET")
        m = _TARGET.search(ins)
        if opcode(ins) == "BRA" and m:
            t = int(m.group(1), 16) // 16
            if t in index and t > a:
                nxt.append(index[t])
        if not unconditional and opcode(ins) != "EXIT" and b + 1 <= last:
            nxt.append(index[b + 1])
        succ.append(nxt)
    return blocks, succ


def _spans(instructions: List[str]):
    """(first, last) of every loop: a branch back to an earlier
    instruction."""
    spans = []
    for i, ins in enumerate(instructions):
        m = _TARGET.search(ins)
        if opcode(ins) == "BRA" and m and int(m.group(1), 16) // 16 < i:
            spans.append((int(m.group(1), 16) // 16, i))
    return spans


def loop_path(instructions: List[str], outer, inner=None,
              trips: int = 1) -> Dict:
    """The instructions a warp issues in one pass of the loop ``outer``
    (first, last): the longest path from its head to its back branch over
    basic blocks that read no device memory (``LDG``, ``LD``: the direct
    route's bytes), each loop inside counted once a pass but ``inner``,
    counted ``trips`` times.  Returns the count and the count of each
    stretch between barriers (``BAR``) on that path."""
    blocks, succ = _blocks(instructions, *outer)

    def cost(i):
        if instructions[i].startswith("@!PT "):
            return 0  # never executed
        return trips if inner and inner[0] <= i <= inner[1] else 1

    banned = {k for k, (a, b) in enumerate(blocks)
              if any(opcode(x) in ("LD", "LDG")
                     for x in instructions[a:b + 1])}
    best, via = {0: sum(cost(i) for i in range(*blocks[0]))
                 + cost(blocks[0][1])}, {0: None}
    for k in range(len(blocks)):  # blocks are in address order: a DAG
        if k not in best:
            continue
        for n in succ[k]:
            if n in banned or n <= k:
                continue
            a, b = blocks[n]
            cand = best[k] + sum(cost(i) for i in range(a, b + 1))
            if cand > best.get(n, -1):
                best[n], via[n] = cand, k
    end = len(blocks) - 1
    path, k = [], end
    while k is not None:
        path.append(k)
        k = via[k]
    segments, count = [], 0
    for k in reversed(path):
        a, b = blocks[k]
        for i in range(a, b + 1):
            count += cost(i)
            if opcode(instructions[i]) == "BAR" and cost(i):
                segments.append(count)
                count = 0
    segments.append(count)
    return {"count": best[end], "segments": segments}


def band_path(instructions: List[str], trips: int) -> Dict:
    """The instructions of one band in the forward megakernel's SASS
    (``csrc/fwd_megakernel.cuh``): ``consumer``, a consumer warp's pass of
    the band loop, the innermost loop that holds the HMMA loop (the
    product's m-tiles, ``trips`` a band), by ``loop_path`` (so on the
    aligned route), with its stretches between barriers (``segments``) and
    the HMMA loop's length; ``producer``, the producer warp's pass of its
    loop (the one that issues the bulk copies, ``UBLKCP``, or the
    ``cp.async`` copies, ``LDGSTS``, outside the band loop), 0 where the
    consumers copy.  None where there is no HMMA loop."""
    spans = _spans(instructions)

    def innermost(sp):
        return not any(o != sp and sp[0] <= o[0] and o[1] <= sp[1]
                       for o in spans)

    hmma = [sp for sp in spans if innermost(sp) and any(
        opcode(x) == "HMMA" for x in instructions[sp[0]:sp[1] + 1])]
    if not hmma:
        return None
    inner = hmma[0]
    outer = min((sp for sp in spans if sp != inner and sp[0] <= inner[0]
                 and inner[1] <= sp[1]), key=lambda sp: sp[1] - sp[0])
    consumer = loop_path(instructions, outer, inner, trips)
    copies = [sp for sp in spans if not (outer[0] <= sp[0] <= outer[1])
              and any(opcode(x) in ("UBLKCP", "LDGSTS")
                      for x in instructions[sp[0]:sp[1] + 1])]
    producer = 0
    if copies:
        loop = max(copies, key=lambda sp: sp[1] - sp[0])
        producer = loop_path(instructions, loop)["count"]
    return {"consumer": consumer["count"], "segments": consumer["segments"],
            "hmma_loop": inner[1] - inner[0] + 1, "producer": producer}


def _sass_diff():
    spec = importlib.util.spec_from_file_location("sass_diff",
                                                  REPO / "sass_diff.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def source_loops(source: str, root: Path = REPO) -> Dict[str, List[Dict]]:
    """{demangled kernel: its innermost loops} of ``csrc/{source}.cu`` in
    the checkout at ``root``."""
    sd = _sass_diff()
    with tempfile.TemporaryDirectory() as tmp:
        functions = sd.sass(Path(root), source, Path(tmp))
    names = sd.demangle(list(functions))
    return {name: loops(ins) for name, ins in zip(names, functions.values())}


def spill_stores(source: str) -> Dict[str, int]:
    """{demangled kernel: bytes of spill stores} of ``csrc/{source}.cu``,
    as ptxas reports them (``nvcc -cubin -Xptxas -v`` with ``sass_diff``'s
    device flags)."""
    sd = _sass_diff()
    src = REPO / "lz4jpeg_tpu_torch" / "csrc" / f"{source}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sd.tool("nvcc"), "-cubin", *sd.DEVICE_FLAGS, "-Xptxas", "-v",
             "-o", str(Path(tmp) / "k.cubin"), str(src)],
            capture_output=True, text=True, check=True)
    names, spills = [], []
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            names.append(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and len(spills) < len(names):
            spills.append(int(m.group(1)))
    return dict(zip(sd.demangle(names), spills))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="+", help="csrc file names without .cu")
    ap.add_argument("--output", help="write the loops as JSON here")
    args = ap.parse_args(argv)
    found = {}
    for source in args.sources:
        found[source] = source_loops(source)
        for name, inner in found[source].items():
            for lp in inner:
                mix = ", ".join(f"{c} {lp[c]}" for c in COUNTED if lp[c])
                print(f"{source}: {name}: loop {lp['first']}-{lp['last']} "
                      f"({lp['length']} instructions): {mix or 'none counted'}")
    if args.output:
        Path(args.output).write_text(json.dumps(found, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
