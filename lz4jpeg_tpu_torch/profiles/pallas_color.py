"""The TPU colour probe as a hand-written kernel, and its run.

Port of ``profiles/profile_pallas_color.py::color_kernel`` (``pallas_call``
:43), which asked whether Mosaic could de-interleave RGB inside a kernel.
``color_probe(x)`` takes (..., W, 3) uint8 RGB, W even, and returns Y
(..., W) and the odd columns of Cr and Cb (..., W / 2), each int16, as the
probe's body computes them in interpret mode: float32 sums in the order
XLA on the CPU contracts them into FMAs,

    Y  = fma(0.114, b, fma(0.299, r, 0.587·g))
    Cr = fma(-0.071, b, fma(0.439, r, -(0.368·g))) + 128
    Cb = fma(0.439, b, fma(-0.148, r, -(0.291·g))) + 128,

the chroma clipped to [0, 255], then truncated toward zero with no tie
snap.  So it is not ``ops/color.py::rgb_to_ycbcr`` (which snaps values
within 1e-4 of an integer first): over the 2²⁴ colours the two differ in a
few hundred colours a channel, and the run reports the counts as the probe
printed them.  A CPU tensor runs ``color_probe_ref`` (the same order in
float64, where an f32 × f32 product and its sum with an f32 are exact, each
sum rounded once to float32); a CUDA tensor launches
``csrc/rgb_color_probe_kernel.cu`` (a thread 16 pixels: three 16-byte
loads, the de-interleave in registers; an input off a 16-byte boundary is
copied first) and adds one to ``color_probe.launches``, or raises.

The run (``python -m lz4jpeg_tpu_torch.profiles.pallas_color``) holds the
kernel to its plain version on the probe's (16, 2048, 3) case and on the
whole colour cube as (8192, 2048, 3) in both column phases (natural order,
then shifted by one pixel, so that every colour meets an odd column),
counts each channel's mismatches against ``rgb_to_ycbcr`` +
``chroma_subsample_422``, then times the kernel at ``frames`` × ``side``²
beside its plain version, that torch chain (``.to(torch.int16)`` after
it) and K1's colour share (the forward megakernel's "full" and
"no_colour" probe variants on the same frames; ``profiles/megakernel.py``).
Times: ``profiles/timing.py``; bound: 7 bytes a pixel over 3.35 TB/s.  Run
on the card from the repository root (on the CPU add ``--device cpu
--frames 1 --side 64 --cube-rows 16``)::

    python -m lz4jpeg_tpu_torch.profiles.pallas_color --output c.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import chroma_subsample_422, rgb_to_ycbcr
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.profiles import timing
from lz4jpeg_tpu_torch.profiles.megakernel import megakernel_variant

BYTES_PER_PIXEL = 7  # 3 read; 2 of Y and 2 of chroma (half a pixel each) written
CUBE_ROWS, CUBE_WIDTH = 8192, 2048  # the 2^24 colours as one (R, W, 3) image


def _rgb(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 RGB, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != 3 or x.shape[-2] % 2:
        raise ValueError(f"expected (..., W, 3) RGB with W even, got "
                         f"{tuple(x.shape)}")
    return x.contiguous()


def _f32(x: torch.Tensor) -> torch.Tensor:
    """float64 values rounded once to float32, held in float64."""
    return x.to(torch.float32).to(torch.float64)


def _fma(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fma(a, x, c) of float32 values held in float64: the product
    and the sum are exact in float64 (|values| < 2^9, 24 + 8 bits), so one
    rounding to float32 gives the fused result."""
    return _f32(float(np.float32(a)) * x + c)


def _mul(a: float, x: torch.Tensor) -> torch.Tensor:
    return _f32(float(np.float32(a)) * x)


def color_probe_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain version: the probe's FMA order in float64, each step rounded
    once to float32; chroma clipped to [0, 255] at the odd columns; all
    truncated to int16."""
    x = _rgb(x).to(torch.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = _fma(0.114, b, _fma(0.299, r, _mul(0.587, g)))
    r, g, b = r[..., 1::2], g[..., 1::2], b[..., 1::2]
    cr = _f32(_fma(-0.071, b, _fma(0.439, r, -_mul(0.368, g))) + 128.0)
    cb = _f32(_fma(0.439, b, _fma(-0.148, r, -_mul(0.291, g))) + 128.0)
    return tuple(p.trunc().to(torch.int16) for p in
                 (y, cr.clamp(0.0, 255.0), cb.clamp(0.0, 255.0)))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/rgb_color_probe_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("rgb_color_probe_kernel")
    lib.rgb_color_launch.restype = ctypes.c_int
    lib.rgb_color_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    timing.bind_attributes(lib, "rgb_color_attributes", n_args=0)
    lib.rgb_color_error_string.restype = ctypes.c_char_p
    lib.rgb_color_error_string.argtypes = [ctypes.c_int]
    return lib


def color_probe(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(..., W, 3) uint8 RGB, W even → (Y (..., W), Cr (..., W/2), Cb (...,
    W/2)) int16.  A CPU tensor runs ``color_probe_ref``; a CUDA tensor
    launches the colour kernel on the current stream and adds one to
    ``color_probe.launches``."""
    x = _rgb(x)
    dev = _check_device(x)
    if dev.type == "cpu":
        return color_probe_ref(x)
    if x.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        x = x.clone()
    lead, w = x.shape[:-2], x.shape[-2]
    y = torch.empty((*lead, w), dtype=torch.int16, device=dev)
    cr = torch.empty((*lead, w // 2), dtype=torch.int16, device=dev)
    cb = torch.empty_like(cr)
    rows = x.numel() // (3 * w) if w else 0
    if rows * w:
        _launch(load_kernel(), "rgb_color_launch", "rgb_color_error_string",
                dev, x.data_ptr(), y.data_ptr(), cr.data_ptr(), cb.data_ptr(),
                rows, w)
        color_probe.launches += 1
    return y, cr, cb


color_probe.launches = 0


def attributes(device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of the kernel; None on the
    CPU."""
    return timing.attributes(load_kernel, "rgb_color_attributes",
                             "rgb_color_error_string", (),
                             torch.device(device))


# ---------------------------------------------------------------------------
# The probe's data and its check against the snapped colour transform
# ---------------------------------------------------------------------------


def probe_case(seed: int = 0) -> torch.Tensor:
    """The probe's input: (16, 2048, 3) uint8 from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, size=(16, 2048, 3)).astype(np.uint8))


def colour_cube(shift: int, dev: torch.device,
                rows: int = CUBE_ROWS) -> torch.Tensor:
    """The first ``rows`` × 2048 of the 2²⁴ colours (r, g, b = bits 16-23,
    8-15, 0-7 of the colour's index) as a (rows, 2048, 3) image, rolled by
    ``shift`` pixels: colour c at pixel (c + shift) mod the pixel count."""
    c = torch.arange(rows * CUBE_WIDTH, dtype=torch.int32, device=dev)
    c = torch.roll(c, shift)
    rgb = torch.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], dim=-1)
    return rgb.to(torch.uint8).reshape(rows, CUBE_WIDTH, 3)


def snapped_chain(x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The port's colour transform the probe checks against:
    ``rgb_to_ycbcr`` (float32, snapped), ``chroma_subsample_422``, int16."""
    y, cr, cb = rgb_to_ycbcr(x, torch.float32)
    return (y.to(torch.int16), chroma_subsample_422(cr).to(torch.int16),
            chroma_subsample_422(cb).to(torch.int16))


def mismatches(got, x: torch.Tensor) -> Dict[str, int]:
    """Per channel, the outputs of ``got`` that differ from
    ``snapped_chain(x)`` (the probe's check, :64-68)."""
    want = snapped_chain(x)
    return {name: int((a != b).sum())
            for name, a, b in zip(("y", "cr", "cb"), got, want)}


def _identical(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def run_pallas_color(device="cuda", frames: int = 32, side: int = 2048,
                     cube_rows: int = CUBE_ROWS, runs: int = 4, reps: int = 8,
                     output: Optional[str] = None, seed: int = 0) -> Dict:
    """The kernel against its plain version on the probe's case and the
    colour cube, the mismatches against the snapped transform, then the
    times; returns the result and writes it to ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)

    x = probe_case(seed).to(dev)
    got = color_probe(x)
    if not _identical(got, color_probe_ref(x)):
        raise AssertionError("the colour kernel differs from its plain "
                             "version on the probe's case")
    probe = mismatches(got, x)
    print(f"probe case (16, 2048, 3): identical to the plain version; "
          f"against rgb_to_ycbcr {probe}", flush=True)
    cube = {"y": 0, "cr": 0, "cb": 0}
    for shift in (0, 1):
        x = colour_cube(shift, dev, cube_rows)
        got = color_probe(x)
        if not _identical(got, color_probe_ref(x)):
            raise AssertionError(f"the colour kernel differs from its plain "
                                 f"version on the cube shifted by {shift}")
        counts = mismatches(got, x)
        if shift == 0:  # every colour's Y once; its chroma once per phase
            cube["y"] = counts["y"]
        cube["cr"] += counts["cr"]
        cube["cb"] += counts["cb"]
        del x, got
    print(f"colour cube ({cube_rows}, {CUBE_WIDTH}, 3), both column phases: "
          f"identical to the plain version; against rgb_to_ycbcr {cube}",
          flush=True)

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (frames, side, side, 3), dtype=torch.uint8,
                      device=dev, generator=gen)
    if not _identical(color_probe(x), color_probe_ref(x)):
        raise AssertionError(f"the colour kernel differs at {tuple(x.shape)}")
    before = color_probe.launches
    ms = timing.time_ms(color_probe, x, dev, reps=reps, runs=runs,
                        kernel=color_probe if cuda else None)
    launches = color_probe.launches - before
    plain_ms = timing.time_ms(color_probe_ref, x, dev, reps=reps, runs=runs)
    chain_ms = timing.time_ms(snapped_chain, x, dev, reps=reps, runs=runs)
    k1 = {name: timing.time_ms(
        functools.partial(megakernel_variant, name=name, lum_table=LUM,
                          chr_table=CHR), x, dev, reps=reps, runs=runs,
        kernel=megakernel_variant if cuda else None)
        for name in ("full", "no_colour")}
    del x
    pixels = frames * side * side
    bound = timing.bytes_bound_ms(BYTES_PER_PIXEL * pixels)
    where = device_record(dev)
    row = {"shape": [frames, side, side, 3], "site":
           "profile_pallas_color.py:21", key: ms, f"plain_{key}": plain_ms,
           f"chain_{key}": chain_ms, "library": None,
           f"k1_full_{key}": k1["full"],
           f"k1_no_colour_{key}": k1["no_colour"],
           f"k1_colour_share_{key}": k1["full"] - k1["no_colour"],
           "launches": launches, "bytes": BYTES_PER_PIXEL * pixels,
           "bytes_bound_ms": bound, "share": bound / ms if cuda else None,
           **attributes(dev)}
    share = row[f"k1_colour_share_{key}"]
    verdict = (f"on {where.get('card', dev)}: identical to the probe's "
               f"interpret-mode arithmetic over the colour cube; against the "
               f"snapped rgb_to_ycbcr Y {cube['y']}, Cr {cube['cr']}, Cb "
               f"{cube['cb']} colours differ; {ms / chain_ms:.2f}x the torch "
               "chain, " + (f"{ms / share:.2f}x K1's colour share" if share > 0
                            else "K1's colour share not positive"))
    print(f"colour probe {tuple(row['shape'])}: {ms:9.4f} ms  plain "
          f"{plain_ms:9.4f}  torch chain {chain_ms:9.4f}  K1 full "
          f"{k1['full']:9.4f} - no colour {k1['no_colour']:9.4f}"
          + ("" if row["share"] is None else
             f"  {row['share']:.1%} of {bound:.4f}  regs {row['registers']}  "
             f"ctas/SM {row['ctas_per_sm']}"), flush=True)
    print(f"verdict: {verdict}")
    result = {"frames": frames, "side": side, "cube_rows": cube_rows,
              "runs": runs, "reps": reps, "seed": seed, "backend": dev.type,
              "timer": "cuda events" if cuda else "host clock", **where,
              "probe_mismatches": probe, "cube_mismatches": cube,
              "timed": row, "verdict": verdict}
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.pallas_color",
        description="The TPU colour probe: exactness over the colour cube, "
                    "mismatches against rgb_to_ycbcr, times.")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--cube-rows", type=int, default=CUBE_ROWS)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_pallas_color(args.device, args.frames, args.side, args.cube_rows,
                     args.runs, args.reps, args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
