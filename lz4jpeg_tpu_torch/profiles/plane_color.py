"""The plane YCbCr → RGB merge with the 4:2:2 upsample, as a hand-written
kernel, and its A/B against the port's colour merge.

Port of ``profiles/profile_plane_color_kernel.py``: its ``_kernel`` becomes
``plane_color`` (``csrc/plane_color_kernel.cu``), its ``main`` becomes
``run_plane_color_ab``.  ``plane_color(y, cr_sub, cb_sub)`` takes (n, w)
uint8 luma and (n, w/2) uint8 chroma planes (w even) and returns three (n,
w) uint8 planes R, G, B: each chroma column serves two luma columns, then
``assemble_image``'s float32 per-term truncations and clamps
(``ops/color.py::ycbcr_planes_to_rgb``).  The plain version is
``torch.repeat_interleave`` of each chroma plane and
``ycbcr_planes_to_rgb``, split into planes; the kernel is identical to it.
A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.

Run the A/B on the card from the repository root::

    python -m lz4jpeg_tpu_torch.profiles.plane_color --output plane_color.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.bench.roofline import _carry, _chain_bench
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.utils.profiling import device_checksum

GATE_ROWS = 4096  # rows of the exactness gate, as the TPU probe's
CHAIN = 4  # merges per fenced chain, as the TPU probe's


def _planes(y: torch.Tensor, cr_sub: torch.Tensor, cb_sub: torch.Tensor):
    if y.dim() != 2 or y.shape[1] % 2:
        raise ValueError(f"expected (n, w) luma with w even, got {tuple(y.shape)}")
    half = (y.shape[0], y.shape[1] // 2)
    for name, t in (("cr_sub", cr_sub), ("cb_sub", cb_sub)):
        if tuple(t.shape) != half:
            raise ValueError(f"{name} {tuple(t.shape)} is not (n, w/2) = {half}")
    for t in (y, cr_sub, cb_sub):
        if t.dtype != torch.uint8:
            raise TypeError(f"expected uint8 planes, got {t.dtype}")
    _check_device(y, cr_sub, cb_sub)
    return y.contiguous(), cr_sub.contiguous(), cb_sub.contiguous()


def plane_color_ref(y: torch.Tensor, cr_sub: torch.Tensor,
                    cb_sub: torch.Tensor):
    """Plain version of the kernel: the 4:2:2 column repeat, then
    ``ycbcr_planes_to_rgb``; returns the (R, G, B) planes."""
    y, cr_sub, cb_sub = _planes(y, cr_sub, cb_sub)
    n, w = y.shape
    rgb = ycbcr_planes_to_rgb(
        y, torch.repeat_interleave(cr_sub, 2, dim=-1),
        torch.repeat_interleave(cb_sub, 2, dim=-1), n, w,
    )
    return tuple(rgb.permute(2, 0, 1).contiguous().unbind(0))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/plane_color_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("plane_color_kernel")
    lib.plane_color_launch.restype = ctypes.c_int
    lib.plane_color_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.plane_color_error_string.restype = ctypes.c_char_p
    lib.plane_color_error_string.argtypes = [ctypes.c_int]
    return lib


def plane_color(y: torch.Tensor, cr_sub: torch.Tensor, cb_sub: torch.Tensor):
    """(n, w) uint8 luma, (n, w/2) uint8 Cr and Cb (w even) → (R, G, B),
    three (n, w) uint8 planes.

    A CPU tensor runs ``plane_color_ref``.  A CUDA tensor launches the merge
    kernel on the current stream and adds one to ``plane_color.launches``."""
    y, cr_sub, cb_sub = _planes(y, cr_sub, cb_sub)
    if y.device.type == "cpu":
        return plane_color_ref(y, cr_sub, cb_sub)
    # 16-byte vectors need aligned planes; a view off a boundary is copied.
    y, cr_sub, cb_sub = (t if t.data_ptr() % 16 == 0 else t.clone()
                         for t in (y, cr_sub, cb_sub))
    out = tuple(torch.empty_like(y) for _ in range(3))
    if y.numel():
        _launch(load_kernel(), "plane_color_launch", "plane_color_error_string",
                y.device, y.data_ptr(), cr_sub.data_ptr(), cb_sub.data_ptr(),
                *(t.data_ptr() for t in out), y.numel())
        plane_color.launches += 1
    return out


plane_color.launches = 0


def run_plane_color_ab(size: int = 2048, batch: int = 64, runs: int = 4,
                       output: Optional[str] = None,
                       device="cuda") -> Dict:
    """The kernel (planar out) against the port's merge
    (``ycbcr_planes_to_rgb`` on upsampled chroma, interleaved out) on
    ``batch`` frames of ``size``² stacked as (batch·size, size) planes.

    An exactness gate on the first 4,096 rows comes first; then each
    version runs ``CHAIN`` times in a fenced chain (the luma perturbed by
    the carry, every output's checksum read once per chain), best of
    ``runs`` chains after a warm one; on CUDA each kernel chain must launch
    the kernel ``CHAIN`` times.  Writes the result to ``output`` if given."""
    dev = bench_device(device)
    rng = np.random.default_rng(0)
    h = batch * size
    y = torch.from_numpy(rng.integers(0, 256, size=(h, size), dtype=np.uint8))
    cr, cb = (torch.from_numpy(rng.integers(0, 256, size=(h, size // 2),
                                            dtype=np.uint8))
              for _ in range(2))
    y, cr, cb = y.to(dev), cr.to(dev), cb.to(dev)

    rows = min(GATE_ROWS, h)
    got = plane_color(y[:rows], cr[:rows], cb[:rows])
    want = plane_color_ref(y[:rows], cr[:rows], cb[:rows])
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("plane colour kernel disagrees with the torch merge")
    print("exactness OK", flush=True)
    del got, want

    data = {
        "y": y, "cr": cr, "cb": cb,
        "cr_up": torch.repeat_interleave(cr, 2, dim=-1),
        "cb_up": torch.repeat_interleave(cb, 2, dim=-1),
    }

    def kernel_body(d, c, s):
        planes = plane_color(d["y"] ^ c.to(torch.uint8), d["cr"], d["cb"])
        s = s + sum(device_checksum(p) for p in planes)
        return _carry(s, torch.int16), s

    def torch_body(d, c, s):
        rgb = ycbcr_planes_to_rgb(d["y"] ^ c.to(torch.uint8), d["cr_up"],
                                  d["cb_up"], h, size)
        s = s + device_checksum(rgb)
        return _carry(s, torch.int16), s

    def floor_body(d, c, s):
        s = s + device_checksum(d["y"] ^ c.to(torch.uint8))
        return _carry(s, torch.int16), s

    guard = plane_color if dev.type == "cuda" else None
    npix = h * size
    ops = {}
    for name, body, kernel in (
        ("kernel_planar_s", kernel_body, guard),
        ("torch_interleaved_s", torch_body, None),
        ("fence_floor_s", floor_body, None),
    ):
        ops[name] = _chain_bench(body, data, CHAIN, torch.int16, runs=runs,
                                 kernel=kernel)
        print(f"{name:22s} {ops[name] * 1e3:9.4f} ms "
              f"({npix / 1e6 / ops[name]:9.1f} MPix/s)", flush=True)
    speedup = ops["torch_interleaved_s"] / ops["kernel_planar_s"]
    winner = "kernel" if speedup > 1 else "torch"
    where = device_record(dev)
    result = {
        "size": size,
        "batch": batch,
        "chain": CHAIN,
        "runs": runs,
        "backend": dev.type,
        **where,
        "mpix_per_iter": npix / 1e6,
        "exact_rows": rows,
        "ops": {"plane_color": {
            **ops,
            "bytes": 2 * npix + 3 * npix,  # y + two half chroma in, RGB out
            "kernel_mpix_s": npix / 1e6 / ops["kernel_planar_s"],
            "torch_mpix_s": npix / 1e6 / ops["torch_interleaved_s"],
            "speedup": speedup,
        }},
        "verdict": (
            f"{winner} wins the colour merge on {where.get('card', dev)}: "
            f"kernel {ops['kernel_planar_s'] * 1e3:.4f} ms vs torch "
            f"{ops['torch_interleaved_s'] * 1e3:.4f} ms per {npix / 1e6:.4g} "
            f"MPix ({speedup:.2f}x); fence floor "
            f"{ops['fence_floor_s'] * 1e3:.4f} ms"
        ),
    }
    print(result["verdict"])
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.plane_color",
        description="A/B of the plane colour kernel against the torch merge.",
    )
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    run_plane_color_ab(args.size, args.batch, args.runs, args.output,
                       args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
