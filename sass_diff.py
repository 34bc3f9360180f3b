#!/usr/bin/env python3
"""Compare the machine code of this checkout's kernels with another
checkout's, function by function.

    python3 sass_diff.py --other DIR SOURCE [SOURCE ...]
    python3 sass_diff.py SOURCE [SOURCE ...]

SOURCE names a file ``lz4jpeg_tpu_torch/csrc/SOURCE.cu``.  Each checkout's
file is compiled to a cubin with the device flags of
``lz4jpeg_tpu_torch/kernels/build.py`` (``nvcc -cubin``, sm_90a, -O3),
disassembled with ``cuobjdump -sass``, and each kernel's instructions,
without addresses and encodings, are compared with the kernel of the same
name and template arguments in the other checkout, namespaces left out
(nvcc may name an anonymous namespace after its file).  A kernel with no
such counterpart pairs with the one kernel of its name whose arguments
are a prefix of its own (a template that gained defaulted trailing
parameters, as ``expand16_plane_kernel<64>`` became
``expand16_plane_kernel<64, Phase::kFull>``); where two kernels could take
the same counterpart, the pairing is ambiguous and fails.  Prints one line
per kernel: identical or not, and the instruction counts.  Exits 1 if a
kernel differs, has no counterpart or pairs ambiguously.  Without
``--other`` it lists each kernel's instruction count in this checkout.
Needs the CUDA toolkit (``nvcc``, ``cuobjdump`` and ``cu++filt``), not a
card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
DEVICE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def tool(name: str) -> str:
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _close(text: str, i: int, step: int) -> int:
    """Index of the bracket matching ``text[i]``, scanning by ``step`` (-1
    back from a closing one, 1 on from an opening one)."""
    depth = 0
    while True:
        c = text[i]
        if c in "(<" if step > 0 else c in ")>":
            depth += 1
        elif c in ")>" if step > 0 else c in "(<":
            depth -= 1
            if depth == 0:
                return i
        i += step


def _top_level_split(text: str) -> list:
    """``text`` split at the commas outside brackets, stripped."""
    parts, depth, start = [], 0, 0
    for i, c in enumerate(text):
        depth += c in "(<"
        depth -= c in ")>"
        if c == "," and depth == 0:
            parts.append(text[start:i].strip())
            start = i + 1
    return parts + [text[start:].strip()]


def _unqualified(text: str) -> str:
    """``text`` with its namespace qualifiers removed."""
    text = re.sub(r"\((?:anonymous namespace)\)::|<unnamed>::", "", text)
    return re.sub(r"\b\w+::", "", text)


def kernel_key(demangled: str) -> tuple:
    """(name, template arguments) of a demangled kernel signature, such as
    ``void <unnamed>::k<(int)64, (<unnamed>::Phase)4>(const int *, int)``,
    both without namespaces: ``("k", ("(int)64", "(Phase)4"))``."""
    sig = demangled.strip()
    if sig.endswith(")"):  # drop the parameter list
        sig = sig[:_close(sig, len(sig) - 1, -1)]
    args = ()
    if sig.endswith(">"):
        lt = _close(sig, len(sig) - 1, -1)
        args = tuple(_unqualified(a) for a in _top_level_split(sig[lt + 1:-1]))
        sig = sig[:lt]
    return _unqualified(sig).split(" ")[-1], args


def pair_kernels(this: dict, other: dict):
    """Pair the keys of ``this`` with the keys of ``other`` (see the module's
    docstring); returns (pairs, only here, only there, ambiguous), each a
    list of keys or key pairs."""
    pairs = [(k, k) for k in this if k in other]
    here = [k for k in this if k not in other]
    there = [k for k in other if k not in this]
    claims = {}
    for side, keys, targets in ((0, here, there), (1, there, here)):
        for k in keys:
            for t in targets:
                if t[0] == k[0] and len(t[1]) < len(k[1]) \
                        and k[1][:len(t[1])] == t[1]:
                    claims.setdefault(t, []).append((side, k))
    ambiguous, taken = [], set()
    for t, by in claims.items():
        if len(by) > 1:
            ambiguous.append(t)
        else:
            side, k = by[0]
            pairs.append((k, t) if side == 0 else (t, k))
        taken.update([t, *(k for _, k in by)])
    here = [k for k in here if k not in taken]
    there = [k for k in there if k not in taken]
    return pairs, here, there, ambiguous


def _show(key: tuple) -> str:
    return key[0] + (f"<{', '.join(key[1])}>" if key[1] else "")


def demangle(names) -> list:
    return subprocess.run([tool("cu++filt")], input="\n".join(names), text=True,
                          capture_output=True, check=True).stdout.splitlines()


def sass(root: Path, source: str, work: Path) -> dict:
    """{mangled kernel name: [instruction, ...]} of ``root``'s ``source``."""
    src = root / "lz4jpeg_tpu_torch" / "csrc" / f"{source}.cu"
    cubin = work / f"{abs(hash(str(root)))}-{source}.cubin"
    subprocess.run([tool("nvcc"), "-cubin", *DEVICE_FLAGS, "-o", str(cubin),
                    str(src)], check=True)
    text = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    functions, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if m and current is not None:
            current.append(m.group(1))
    return functions


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the checkout to compare with this one")
    ap.add_argument("sources", nargs="+", help="csrc file names without .cu")
    args = ap.parse_args()
    same = True
    with tempfile.TemporaryDirectory() as tmp:
        for source in args.sources:
            this = sass(HERE, source, Path(tmp))
            if args.other is None:
                for name, instructions in sorted(zip(demangle(this),
                                                     this.values())):
                    print(f"{source}: {name}: {len(instructions)} instructions")
                continue
            that = sass(args.other.resolve(), source, Path(tmp))
            keyed = []
            for functions in (this, that):
                keys = [kernel_key(n) for n in demangle(functions)]
                if len(set(keys)) != len(keys):
                    print(f"{source}: two kernels share a name and arguments")
                    return 1
                keyed.append(dict(zip(keys, functions.values())))
            pairs, here, there, ambiguous = pair_kernels(*keyed)
            for key in ambiguous:
                print(f"{source}: {_show(key)}: more than one kernel pairs "
                      "with it")
            for key in here + there:
                print(f"{source}: {_show(key)}: only in "
                      f"{'this checkout' if key in here else 'the other one'}")
            same &= not (ambiguous or here or there)
            for a_key, b_key in sorted(pairs):
                a, b = keyed[0][a_key], keyed[1][b_key]
                verdict = "identical" if a == b else "DIFFERS"
                same &= a == b
                named = _show(a_key) + ("" if a_key == b_key else
                                        f" (the other's {_show(b_key)})")
                print(f"{source}: {named}: SASS {verdict} ({len(a)} "
                      f"instructions here, {len(b)} in the other)")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
