"""K10 and K11 on the card: what K10's walk costs, and both kernels beside
their plain versions.

    python -m lz4jpeg_tpu_torch.profiles.parse_probe [--output F.json]

Builds of ``csrc/lz4_parse_kernel.cu`` with constants set
(``inv_probe.shaped_source``, ``BUILDS``): the source's; ``kWalk`` false (K10
without its walk: the load and store steps alone); ``kWalkBatch`` 1 (a
walker's dependent shared-memory load a slot, the first build's walk).
Each is compiled with the toolkit (ptxas's registers and spill bytes)
and launched like ``parse_candidates``; every walking build's fields
must equal the plain version's.

1. K10 on K2's words of 2048 generated-text blocks of 16 KiB (the last
   ragged), stride 1, 2 and 4 (lcp 4): every build, then the plain
   version, by ``timing.time_ms`` in turns (the builds in order, then in
   reverse), with the bytes bound.
2. K11 (``parity_parse``) at 255 × 300 and 30 × 1,024 blocks of the same
   text and at 3 × 4,096: kernel and plain queued in turns (plain,
   kernel, kernel, plain), outputs identical.

CUDA only: a run without a card raises.  Prints the card's name and power
limit and every time; ``--output`` writes them as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import CSRC_DIR, NVCC_FLAGS, nvcc_path
from lz4jpeg_tpu_torch.ops import lz4_parse
from lz4jpeg_tpu_torch.ops.fused_match import match_candidates
from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
from lz4jpeg_tpu_torch.ops.match import pad_blocks
from lz4jpeg_tpu_torch.profiles.inv_probe import shaped_source
from lz4jpeg_tpu_torch.profiles.timing import bytes_bound_ms, time_ms
from lz4jpeg_tpu_torch.utils.inputs import generate_text

BLOCKS = 2048
PARITY = ((76_500, 300), (30_000, 1024), (3 * 4096, 4096))
BUILDS = {
    "source": {},
    "no walk": {"kWalk": "false"},
    "walk batch 1": {"kWalkBatch": "1"},
}


def build(name: str, values: dict, tmp: Path):
    """The library with ``values`` set and ptxas's report of K10's
    candidate entry: (lib, {"registers", "spill_stores"})."""
    stem = re.sub(r"\W+", "_", name)
    src = tmp / f"parse_{stem}.cu"
    src.write_text(shaped_source(
        (CSRC_DIR / "lz4_parse_kernel.cu").read_text(), **values))
    lib_path = tmp / f"libparse_{stem}.so"
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib_path),
         str(src)], capture_output=True, text=True, check=True)
    use, kernel = {}, False
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            kernel = "segment_parse_kernelIiLb1E" in line
        m = re.search(r"(\d+) bytes spill stores", line)
        if kernel and m:
            use["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            use["registers"] = int(m.group(1))
            kernel = False
    lib = ctypes.CDLL(str(lib_path))
    lib.segment_parse_candidates_launch.restype = ctypes.c_int
    lib.segment_parse_candidates_launch.argtypes = (
        lz4_parse.load_kernel().segment_parse_candidates_launch.argtypes)
    return lib, use


def launch(lib, packed, lengths, p, stride):
    """``parse_candidates``'s launch through ``lib`` (segments of 512)."""
    b, pa = packed.shape
    outs = [torch.empty((b, p), dtype=torch.int32, device=packed.device)
            for _ in range(3)]
    rc = lib.segment_parse_candidates_launch(
        packed.data_ptr(), lengths.data_ptr(), *(o.data_ptr() for o in outs),
        b, pa, stride, 512, 512 // stride, (pa - 1).bit_length(), 65535,
        torch.cuda.current_stream(packed.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed ({rc})")
    return tuple(outs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("parse_probe needs a CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    result = {"card": card, "k10": {}, "k11": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(name, values, Path(tmp))
                for name, values in BUILDS.items()}
        for name, (_, use) in libs.items():
            print(f"K10 {name}: {use}")
            result["k10"].setdefault(name, {})["ptxas"] = use
        text = generate_text(BLOCKS * 16384 - 7000, np.random.default_rng(0))
        padded, lengths = pad_blocks_fast(text)
        x = torch.from_numpy(padded.astype(np.uint8)).to(dev)
        lens = torch.from_numpy(lengths).to(dev)
        b, p = x.shape
        for stride in (1, 2, 4):
            packed = match_candidates(x, lens, stride, 4)
            want = lz4_parse.parse_candidates_ref(packed, lens, p, stride=stride)
            fns = {name: (lambda a, lib=lib: launch(lib, a, lens, p, stride))
                   for name, (lib, _) in libs.items()}
            for name, fn in fns.items():
                got = fn(packed)
                same = all(torch.equal(g, w) for g, w in zip(got, want))
                if name != "no walk" and not same:
                    raise RuntimeError(f"K10 {name} differs at stride {stride}")
            fns["plain"] = lambda a: lz4_parse.parse_candidates_ref(
                a, lens, p, stride=stride)
            ms = {}
            for name in [*fns, *reversed(list(fns))]:
                ms.setdefault(name, []).append(time_ms(fns[name], packed, dev))
            bound = bytes_bound_ms(packed.numel() * 4 + b * 4 + 3 * b * p * 4)
            for name, t in ms.items():
                print(f"K10 {b}x16KiB stride {stride} {name}: {t[0]:.4f}, "
                      f"{t[1]:.4f} ms; bound {bound:.4f} ms, "
                      f"{bound / (sum(t) / 2):.1%} of it")
                result["k10"].setdefault(name, {})[f"stride {stride}"] = t
            result["k10"][f"bound stride {stride}"] = bound
            del packed, want
        del x, lens
        for n, block_length in PARITY:
            blocks, _ = pad_blocks(text[:n], block_length)
            xb = torch.from_numpy(blocks).to(dev)
            got = lz4_parse.parity_parse(xb)
            want = lz4_parse.parity_parse_ref(xb)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"K11 differs at {n} B / {block_length}")
            fns = {"plain": lz4_parse.parity_parse_ref,
                   "kernel": lz4_parse.parity_parse}
            ms = {}
            for name in [*fns, *reversed(list(fns))]:
                ms.setdefault(name, []).append(time_ms(fns[name], xb, dev))
            bound = bytes_bound_ms(xb.numel() * 13)
            label = f"{xb.shape[0]} x {block_length}"
            print(f"K11 {label}: kernel {ms['kernel'][0]:.4f}, "
                  f"{ms['kernel'][1]:.4f} ms; plain {ms['plain'][0]:.4f}, "
                  f"{ms['plain'][1]:.4f} ms; bound {bound:.6f} ms")
            result["k11"][label] = {**ms, "bound": bound}
    if args.output:
        Path(args.output).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
