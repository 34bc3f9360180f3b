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
forward megakernel's band loop along its aligned route's path, and
``kt_band_path`` that of its KT variants by warp role.  The one-hot
gathers' k-loop is the innermost loop with ``HMMA`` or ``IMMA``: two
k-slices an iteration.  ``spill_stores(source)`` gives each kernel's
spill-store bytes from ptxas, ``ptxas_usage(source, root)`` its registers
and spill bytes in any checkout.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump``, ``cu++filt``), not a card.
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


def loops(instructions: List[str], innermost: bool = True) -> List[Dict]:
    """The innermost loops (every loop, if not ``innermost``) of a
    function's instructions: each as its first and last index, its length,
    the count of every opcode of ``COUNTED`` and of every opcode (``mix``),
    all over the instructions that can execute (ptxas pads each ``LDGSTS``
    with ``@!PT LDS``, never executed)."""
    spans = _spans(instructions)
    inner = [s for s in spans
             if not innermost or not any(o != s and s[0] <= o[0]
                                         and o[1] <= s[1] for o in spans)]
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
              trips: int = 1, avoid=(), must=()) -> Dict:
    """The instructions a warp issues in one pass of the loop ``outer``
    (first, last): the longest path from its head to its back branch over
    basic blocks that read no device memory (``LDG``, ``LD``: the direct
    route's bytes), each loop inside counted once a pass but ``inner``,
    counted ``trips`` times (or ``inner`` a dict {loop: trips} of such
    loops).  The path enters no block of the loops in ``avoid`` and passes
    through each loop of ``must`` (the warp role that runs them).  Returns
    the count and the count of each stretch between barriers (``BAR``) on
    that path."""
    counted = inner if isinstance(inner, dict) else (
        {inner: trips} if inner else {})
    blocks, succ = _blocks(instructions, *outer)

    def cost(i):
        if instructions[i].startswith("@!PT "):
            return 0  # never executed
        for (a, b), t in counted.items():
            if a <= i <= b:
                return t
        return 1

    heads = {a for a, _ in must}
    big = 1 << 40  # a path through every loop of ``must`` outweighs any other

    def weight(k):
        a, b = blocks[k]
        return (sum(cost(i) for i in range(a, b + 1))
                + big * sum(i in heads for i in range(a, b + 1)))

    banned = {k for k, (a, b) in enumerate(blocks)
              if any(opcode(x) in ("LD", "LDG")
                     for x in instructions[a:b + 1])
              or any(lo <= a <= hi for lo, hi in avoid)}
    best, via = {0: weight(0)}, {0: None}
    for k in range(len(blocks)):  # blocks are in address order: a DAG
        if k not in best:
            continue
        for n in succ[k]:
            if n in banned or n <= k:
                continue
            cand = best[k] + weight(n)
            if cand > best.get(n, -1):
                best[n], via[n] = cand, k
    end = len(blocks) - 1
    path, k = [], end
    while k is not None:
        path.append(k)
        k = via[k]
    segments, count, total = [], 0, 0
    for k in reversed(path):
        a, b = blocks[k]
        for i in range(a, b + 1):
            count += cost(i)
            total += cost(i)
            if opcode(instructions[i]) == "BAR" and cost(i):
                segments.append(count)
                count = 0
    segments.append(count)
    on_path = {i for k in path for i in range(blocks[k][0], blocks[k][1] + 1)}
    if not heads <= on_path:
        raise ValueError(f"no path of {outer} passes the loops {sorted(must)}")
    return {"count": total, "segments": segments}


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

    def has_hmma(sp):
        return any(opcode(x) == "HMMA" for x in instructions[sp[0]:sp[1] + 1])

    hmma = [sp for sp in spans if innermost(sp) and has_hmma(sp)]
    if hmma:
        inner = hmma[0]
        outer = min((sp for sp in spans if sp != inner and sp[0] <= inner[0]
                     and inner[1] <= sp[1]), key=lambda sp: sp[1] - sp[0])
    elif trips == 1 and any(has_hmma(sp) for sp in spans):
        # One m-tile a band (T = 16): ptxas drops the loop, and the band
        # loop holds the product itself.
        inner = None
        outer = min((sp for sp in spans if has_hmma(sp)),
                    key=lambda sp: sp[1] - sp[0])
    else:
        return None
    consumer = loop_path(instructions, outer, inner, trips)
    # ptxas may move a wait's retry loop past the function's end, with a
    # jump back to the loop: a "span" holding an EXIT is such a jump.
    copies = [sp for sp in spans if not (outer[0] <= sp[0] <= outer[1])
              and any(opcode(x) in ("UBLKCP", "LDGSTS")
                      for x in instructions[sp[0]:sp[1] + 1])
              and not any(opcode(x) == "EXIT"
                          for x in instructions[sp[0]:sp[1] + 1])]
    producer = 0
    if copies:
        loop = max(copies, key=lambda sp: sp[1] - sp[0])
        producer = loop_path(instructions, loop)["count"]
    return {"consumer": consumer["count"], "segments": consumer["segments"],
            "hmma_loop": inner[1] - inner[0] + 1 if inner else 0,
            "producer": producer}


def _hmma(instructions: List[str], span) -> int:
    return sum(opcode(x) == "HMMA" for x in instructions[span[0]:span[1] + 1])


def _reaches(instructions: List[str], outer, src, dst) -> bool:
    """Whether the loop ``dst`` lies on a forward path from the loop
    ``src`` inside ``outer``."""
    blocks, succ = _blocks(instructions, *outer)
    start = next(k for k, (a, _) in enumerate(blocks) if a == src[0])
    seen, todo = {start}, [start]
    while todo:
        for n in succ[todo.pop()]:
            if n not in seen:
                seen.add(n)
                todo.append(n)
    return any(blocks[k][0] == dst[0] for k in seen)


def kt_band_path(instructions: List[str], tiles: int, chunks: int) -> Dict:
    """The instructions of one band of a KT variant of the forward
    megakernel (``csrc/fwd_megakernel.cuh``), T = ``tiles``, split by warp
    role, each role's pass of the band loop by ``loop_path`` on the aligned
    route.  A copy variant has no ``HMMA``: ``consumer`` is the pass of its
    8 warps through the longest loop that issues no copy.  The innermost
    loops with ``HMMA`` are told apart by their
    mma an iteration: 18 (the samples as A: an m-tile of luma and chroma,
    T/16 trips for each of the 8 warps), 12 (the basis as A: a luma
    m-tile's 8 tiles) and 6 (a chroma m-tile's).  Basis as A: ``luma`` is
    the pass of warps 0-3, which enter no 6-mma loop; ``chroma`` the pass
    of warps 4-7 through the 6-mma loop (T/8 trips).  Where the 12-mma loop
    lies on a path from the 6-mma loop (the balanced split), warps 0-3 take
    3T/32 n-tiles of it and warps 4-7 the last T/32; else the luma warps
    take all T/8.  ``producer``: the producer warps, whose ``LDGSTS`` copy
    the band's ``chunks`` 16-byte chunks, and one warp's pass of its band
    loop: with an inner copy loop (one producer warp) taken as often as its
    copies need, or with none (the copies unrolled), the warps that
    ``chunks`` needs at that pass's copies.  Each role's ``count`` is one
    warp's; ``per_tile``: every role's warps' instructions over T."""
    spans = _spans(instructions)
    inner = [sp for sp in spans if not any(
        o != sp and sp[0] <= o[0] and o[1] <= sp[1] for o in spans)]
    hmma = {sp: _hmma(instructions, sp) for sp in inner
            if _hmma(instructions, sp)}
    if hmma:
        outer = min((sp for sp in spans if all(
            sp[0] <= h[0] and h[1] <= sp[1] and sp != h for h in hmma)),
            key=lambda sp: sp[1] - sp[0])
    by_mma = {}
    for sp, n in hmma.items():
        by_mma.setdefault(n, []).append(sp)
    roles = {}
    if not by_mma:  # a copy variant: the band loop holds no product
        outer = max((sp for sp in spans if not any(
            opcode(x) == "LDGSTS" for x in instructions[sp[0]:sp[1] + 1])),
            key=lambda sp: sp[1] - sp[0])
        roles["consumer"] = (8, loop_path(instructions, outer))
    elif set(by_mma) == {18}:
        path = loop_path(instructions, outer,
                         {sp: tiles // 16 for sp in by_mma[18]})
        roles["consumer"] = (8, path)
    elif set(by_mma) == {12, 6}:
        luma, chroma = by_mma[12], by_mma[6]
        balanced = any(_reaches(instructions, outer, c, m)
                       for c in chroma for m in luma)
        roles["luma"] = (4, loop_path(
            instructions, outer,
            {sp: (3 * tiles // 32 if balanced else tiles // 8) for sp in luma},
            avoid=chroma))
        counted = {sp: tiles // 8 for sp in chroma}
        if balanced:
            counted.update({sp: tiles // 32 for sp in luma})
        roles["chroma"] = (4, loop_path(instructions, outer, counted,
                                        avoid=() if balanced else luma,
                                        must=chroma[:1]))
    else:
        raise ValueError(f"unexpected mma loops {sorted(by_mma)}")
    copies = [sp for sp in spans if not (outer[0] <= sp[0] <= outer[1])
              and any(opcode(x) == "LDGSTS"
                      for x in instructions[sp[0]:sp[1] + 1])]
    loop = max(copies, key=lambda sp: sp[1] - sp[0])
    body = [sp for sp in copies if sp != loop and loop[0] <= sp[0]
            and sp[1] <= loop[1]]

    def ldgsts(a, b):
        return sum(opcode(x) == "LDGSTS" and not x.startswith("@!PT ")
                   for x in instructions[a:b + 1])

    if body:  # one producer warp, its lanes' copies in a loop
        per_lane = chunks // 32
        counted = {sp: per_lane // ldgsts(*sp) for sp in body}
        producer = loop_path(instructions, loop, counted)["count"]
        warps = 1
    else:
        producer = loop_path(instructions, loop)["count"]
        warps = chunks // (32 * ldgsts(*loop))
    out = {role: {"warps": w, "count": p["count"], "segments": p["segments"]}
           for role, (w, p) in roles.items()}
    out["producer"] = {"warps": warps, "count": producer}
    out["per_tile"] = (sum(w * p["count"] for w, p in roles.values())
                       + warps * producer) / tiles
    return out


def ptxas_usage(source: str, root: Path = REPO) -> Dict[str, Dict[str, int]]:
    """{demangled kernel: {"registers", "spill_stores", "spill_loads"}} of
    ``csrc/{source}.cu`` in the checkout at ``root``, as ptxas reports them
    (``nvcc -cubin -Xptxas -v`` with ``sass_diff``'s device flags)."""
    sd = _sass_diff()
    src = Path(root) / "lz4jpeg_tpu_torch" / "csrc" / f"{source}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sd.tool("nvcc"), "-cubin", *sd.DEVICE_FLAGS, "-Xptxas", "-v",
             "-o", str(Path(tmp) / "k.cubin"), str(src)],
            capture_output=True, text=True, check=True)
    usage, current = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?([^'\s]+)'?", line)
        if m:
            current = usage.setdefault(m.group(1), {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current is not None:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            current["registers"] = int(m.group(1))
    usage = {k: v for k, v in usage.items() if "registers" in v}
    return dict(zip(sd.demangle(list(usage)), usage.values()))


def _sass_diff():
    spec = importlib.util.spec_from_file_location("sass_diff",
                                                  REPO / "sass_diff.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def source_loops(source: str, root: Path = REPO,
                 innermost: bool = True) -> Dict[str, List[Dict]]:
    """{demangled kernel: its innermost loops (every loop, if not
    ``innermost``)} of ``csrc/{source}.cu`` in the checkout at ``root``."""
    sd = _sass_diff()
    with tempfile.TemporaryDirectory() as tmp:
        functions = sd.sass(Path(root), source, Path(tmp))
    names = sd.demangle(list(functions))
    return {name: loops(ins, innermost)
            for name, ins in zip(names, functions.values())}


def spill_stores(source: str) -> Dict[str, int]:
    """{demangled kernel: bytes of spill stores} of ``csrc/{source}.cu``,
    as ptxas reports them (``ptxas_usage``)."""
    return {name: use["spill_stores"]
            for name, use in ptxas_usage(source).items()}


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
