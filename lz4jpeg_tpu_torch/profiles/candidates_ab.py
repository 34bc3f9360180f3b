"""A/B of the kernel candidates against the port's shipped formulations.

Port of ``profiles/profile_pallas.py``, the A/B behind the JAX package's
choice to ship the XLA einsum (``ops/fused.py``) and the XLA sort RLE
(``ops/rle.py``) rather than its Pallas candidates.  Here the candidates are
the hand-written kernels of ``profiles/mcu.py`` and ``profiles/rle.py`` and
the shipped formulations the port's own: ``fused_forward`` and
``fused_inverse`` (one float32 matmul, cuBLAS on a card, never TF32) and
``rle_encode_batched`` (``torch.sort``).  The question the probe asked is
asked again on this device; the verdict comes from this run's numbers.

Methodology.  Gates first, on the device, before any timing: the forward
and inverse candidates equal their shipped twins up to the one-step flips at
summation ties that ``utils/parity.py::transform_flips`` admits (at most
1e-5 of the outputs), the RLE candidate's pairs and lengths equal
``rle_encode_batched``'s.  Then each op runs ``chain`` times in a row with
a carry taken from the checksum of each output
(``utils/profiling.py::device_checksum``, one read), the host reading the
sum once per chain; per-iteration time is the best of ``runs`` chains after
a warm one (``bench/roofline.py::_chain_bench``).  On CUDA each candidate
chain must launch its kernel ``chain`` times (the launch guard).
``fence_floor_s`` is the perturbation and checksum alone, on the
candidate's output.

Run on the card from the repository root::

    python -m lz4jpeg_tpu_torch.profiles.candidates_ab --output candidates_ab.json
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.bench.roofline import _carry, _chain_bench
from lz4jpeg_tpu_torch.ops.fused import fused_forward, fused_inverse
from lz4jpeg_tpu_torch.ops.quantize import LUMINANCE_QUANTIZATION_TABLE as TABLE
from lz4jpeg_tpu_torch.ops.rle import rle_encode_batched
from lz4jpeg_tpu_torch.profiles.mcu import (
    fused_forward_candidate,
    fused_inverse_candidate,
)
from lz4jpeg_tpu_torch.profiles.rle import rle_encode_candidate
from lz4jpeg_tpu_torch.utils.parity import transform_flips
from lz4jpeg_tpu_torch.utils.profiling import device_checksum

MAX_FLIP_SHARE = 1e-5
# (op, key of the shipped formulation's time)
SHIPPED = {
    "fused_forward": "torch_matmul_s",
    "fused_inverse": "torch_matmul_s",
    "rle_encode": "torch_sort_s",
}


def _checksum(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return sum(device_checksum(t) for t in outs)


def _perturb(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The input of a chain step: ``x`` plus the carry (0 or 1)."""
    return x + c.to(x.dtype)


def _body(fn: Callable) -> Callable:
    """A chain step: ``fn`` of the perturbed input, every output
    checksummed."""
    def body(x, c, s):
        s = s + _checksum(fn(_perturb(x, c)))
        return _carry(s, torch.int16), s

    return body


def _floor(out) -> Callable:
    """The fence alone: the perturbation, and the checksum of ``out``."""
    def body(x, c, s):
        _perturb(x, c)
        s = s + _checksum(out)
        return _carry(s, torch.int16), s

    return body


def run_candidates_ab(
    n_blocks: int = 2 * 1024 * 1024,
    chain: int = 8,
    runs: int = 4,
    output: Optional[str] = None,
    device="cuda",
) -> Dict:
    """Gate, then time each candidate against its shipped formulation on
    ``n_blocks`` random 8×8 luma tiles (seed 0) and their coefficients;
    returns the result and writes it to ``output`` if given."""
    dev = bench_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 is IEEE fp32
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(
        rng.integers(0, 256, size=(n_blocks, 8, 8), dtype=np.uint8)).to(dev)
    zz = fused_forward(tiles, TABLE, 8, 8)
    zz16 = zz.to(torch.int16)

    # -- gates: a faster but wrong kernel must not win -----------------------
    flips = {
        "fused_forward": transform_flips(
            "forward", tiles, fused_forward_candidate(tiles, TABLE, 8, 8), zz,
            TABLE, 8, 8),
        "fused_inverse": transform_flips(
            "inverse", zz, fused_inverse_candidate(zz, TABLE, 8, 8),
            fused_inverse(zz, TABLE, 8, 8), TABLE, 8, 8),
    }
    for op, count in flips.items():
        if count > MAX_FLIP_SHARE * n_blocks * 64:
            raise AssertionError(f"{op}: {count} flips exceed {MAX_FLIP_SHARE}")
    pa, la = rle_encode_batched(zz16)
    pb, lb = rle_encode_candidate(zz16)
    if not (torch.equal(pa, pb.to(torch.int32)) and torch.equal(la, lb)):
        raise AssertionError("rle candidate differs from rle_encode_batched")
    del pa, la, pb, lb
    print(f"gates: candidates match their shipped twins (forward flips "
          f"{flips['fused_forward']}, inverse flips {flips['fused_inverse']}, "
          "rle identical)", flush=True)

    guard = dev.type == "cuda"
    cases = (
        ("fused_forward", tiles, fused_forward, fused_forward_candidate,
         (TABLE, 8, 8)),
        ("fused_inverse", zz, fused_inverse, fused_inverse_candidate,
         (TABLE, 8, 8)),
        ("rle_encode", zz16, rle_encode_batched, rle_encode_candidate, ()),
    )
    ops: Dict[str, Dict] = {}
    for op, data, shipped, candidate, args in cases:
        shipped_s = _chain_bench(
            _body(lambda x: shipped(x, *args)), data, chain, torch.int16,
            runs=runs)
        kernel_s = _chain_bench(
            _body(lambda x: candidate(x, *args)), data, chain, torch.int16,
            runs=runs, kernel=candidate if guard else None)
        floor_s = _chain_bench(
            _floor(candidate(data, *args)), data, chain, torch.int16,
            runs=runs)
        ops[op] = {
            SHIPPED[op]: shipped_s,
            "kernel_s": kernel_s,
            "fence_floor_s": floor_s,
            "speedup": shipped_s / kernel_s,
        }
        for label, t in ((f"{op} torch", shipped_s), (f"{op} kernel", kernel_s),
                         (f"{op} fence floor", floor_s)):
            print(f"{label:28s} {t * 1e3:9.4f} ms/iter "
                  f"{n_blocks / t / 1e6:9.1f} Mblk/s", flush=True)

    where = device_record(dev)
    parts = []
    for label, wins in (("the kernel beats torch at", True),
                        ("torch beats the kernel at", False)):
        named = [f"{op} ({r['speedup']:.2f}x)" for op, r in ops.items()
                 if (r["speedup"] > 1) == wins]
        if named:
            parts.append(f"{label} {', '.join(named)}")
    verdict = (f"on {where.get('card', dev)}: {'; '.join(parts)} "
               "(speedup = torch time / kernel time)")
    result = {
        "n_blocks": n_blocks,
        "chain": chain,
        "runs": runs,
        "backend": dev.type,
        **where,
        "gates": {"fused_forward_flips": flips["fused_forward"],
                  "fused_inverse_flips": flips["fused_inverse"],
                  "rle_encode": "identical"},
        "ops": ops,
        "verdict": verdict,
    }
    print(f"verdict: {verdict}")
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.candidates_ab",
        description="A/B of the MCU and RLE kernel candidates against the "
                    "port's shipped formulations.",
    )
    ap.add_argument("--n-blocks", type=int, default=2 * 1024 * 1024)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    run_candidates_ab(args.n_blocks, args.chain, args.runs, args.output,
                      args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
