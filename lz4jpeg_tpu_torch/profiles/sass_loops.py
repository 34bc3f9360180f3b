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
``--output`` every opcode's count (``mix``).  The one-hot
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
    spans = []
    for i, ins in enumerate(instructions):
        m = _TARGET.search(ins)
        if opcode(ins) == "BRA" and m and int(m.group(1), 16) // 16 < i:
            spans.append((int(m.group(1), 16) // 16, i))
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
