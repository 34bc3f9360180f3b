"""The inverse megakernel: the sparse16 decode in one CUDA pass.

Port of the sparse16 branch of ``lz4jpeg_tpu/models/jpeg.py::_inverse_impl``
(:408-436, fed by ``_inverse_sparse_impl`` :448), which XLA ran with no
Pallas kernel.  ``inverse_combined`` maps the (B, N, 128) int16 combined
sparse16 buffer (N = bpc · bpr tiles a frame, block-row-major; lanes as
``ops/fwd_megakernel.py::CHANNEL_SLICES``) to (B, height, width, 3) uint8
RGB.  On a CUDA tensor it launches the hand-written Hopper kernel K9
``csrc/inv_megakernel.cu`` (un-bias, suffix-basis product and colour merge
fused); on a CPU tensor it runs ``inverse_combined_ref``, the plain torch
chain (un-bias, ``fused_inverse_plane_sparse`` per channel,
``ycbcr_planes_to_rgb``).  There is no fallback between the two: a CUDA
call launches the kernel or raises.  ``inverse_plan`` mirrors the kernel's
work map in numpy.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    fused_inverse_plane_sparse,
    inverse_suffix_basis,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES, COMBINED_LANES
from lz4jpeg_tpu_torch.ops.rle import SPARSE16_DELTA_BIAS

CHANNELS = ("lum", "r", "b")
_CHANNEL_WIDTHS = {"lum": 8, "r": 4, "b": 4}  # tile columns of each channel
# The kernel's work map (csrc/inv_megakernel.cu): a unit is up to BAND_TILES
# tiles of one block row, THREADS threads a CTA, a warp a pixel row.
BAND_TILES = 32
THREADS = 256
VECTOR_BYTES = 16


def _check(combined: torch.Tensor, bpc: int, bpr: int, height: int,
           width: int) -> int:
    """Validate a (B, bpc · bpr, 128) int16 contiguous buffer and the image
    size it decodes to; return B."""
    if combined.dtype != torch.int16:
        raise TypeError(f"expected an int16 combined buffer, got {combined.dtype}")
    if combined.dim() != 3 or tuple(combined.shape[1:]) != (bpc * bpr,
                                                            COMBINED_LANES):
        raise ValueError(
            f"expected a (B, {bpc * bpr}, {COMBINED_LANES}) buffer for "
            f"{bpc} x {bpr} blocks, got {tuple(combined.shape)}")
    if not (0 <= height <= 8 * bpc and 0 <= width <= 8 * bpr):
        raise ValueError(f"a {height} x {width} image does not lie in "
                         f"{bpc} x {bpr} blocks")
    if not combined.is_contiguous():
        raise ValueError("combined buffer must be contiguous")
    return combined.shape[0]


def inverse_combined_ref(
    combined: torch.Tensor, tables: Dict[str, np.ndarray], bpc: int, bpr: int,
    height: int, width: int,
) -> torch.Tensor:
    """Plain torch version: (B, N, 128) sparse deltas → (B, height, width,
    3) uint8 RGB: per channel one folded-basis einsum, then the color
    merge."""
    b = combined.shape[0]
    # One name for both int32 buffers, and freed before the merge, so
    # that at most one 4-byte copy of the batch lives at a time (a
    # 1-GiPix batch holds 8 GiB in each).
    d = combined.to(torch.int32)
    d = torch.where(d != 0, d - SPARSE16_DELTA_BIAS, 0)
    planes = {}
    for name in CHANNELS:
        tw = _CHANNEL_WIDTHS[name]
        d_kt = d[..., CHANNEL_SLICES[name]].reshape(b * bpc, bpr, 8 * tw)
        plane = fused_inverse_plane_sparse(
            d_kt.transpose(1, 2), tables[name], tw,
            upsample_cols=(name != "lum"),
        )
        planes[name] = plane.reshape(b, 8 * bpc, 8 * bpr)
    del d, d_kt
    return ycbcr_planes_to_rgb(
        planes["lum"], planes["r"], planes["b"], height, width
    )


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/inv_megakernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("inv_megakernel")
    lib.inv_megakernel_launch.restype = ctypes.c_int
    lib.inv_megakernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.inv_megakernel_plan.restype = ctypes.c_int
    lib.inv_megakernel_plan.argtypes = [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_int64)]
    lib.inv_megakernel_attributes.restype = ctypes.c_int
    lib.inv_megakernel_attributes.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.inv_megakernel_error_string.restype = ctypes.c_char_p
    lib.inv_megakernel_error_string.argtypes = [ctypes.c_int]
    return lib


def basis_arrays(keys) -> Dict[str, np.ndarray]:
    """Per channel the float32 suffix basis the product runs, [pixel][term]:
    luma ``inverse_suffix_basis(8, 8, key)`` (64, 64), each chroma channel
    ``inverse_suffix_basis(4, 8, key)`` (32, 32), not column-duplicated (the
    kernel computes 32 samples and stores each twice).  These are the
    float32 values ``ops/fused.py::_plane_product`` casts."""
    return {
        name: inverse_suffix_basis(_CHANNEL_WIDTHS[name], 8, key).astype(
            np.float32)
        for name, key in zip(CHANNELS, keys)
    }


@functools.lru_cache(maxsize=None)
def _device_bases(keys, device: torch.device) -> torch.Tensor:
    """The kernel's basis operand on ``device``: ``basis_arrays(keys)``'s
    luma, Cr and Cb bases flattened into one float32 vector of 6,144."""
    arrays = basis_arrays(keys)
    flat = np.concatenate([arrays[c].ravel() for c in CHANNELS])
    return torch.from_numpy(flat).to(device)


def table_keys(tables: Dict[str, np.ndarray]) -> tuple:
    return tuple(_table_key(tables[c]) for c in CHANNELS)


def inverse_combined(
    combined: torch.Tensor, tables: Dict[str, np.ndarray], bpc: int, bpr: int,
    height: int, width: int,
) -> torch.Tensor:
    """(B, bpc · bpr, 128) int16 combined sparse16 buffer → (B, height,
    width, 3) uint8 RGB.

    A CPU tensor runs ``inverse_combined_ref``.  A CUDA tensor launches K9
    on the current stream into a new contiguous output and adds one to
    ``inverse_combined.launches``; a refused launch raises.  Both devices
    raise on a buffer of another shape or type or a non-contiguous one."""
    b = _check(combined, bpc, bpr, height, width)
    if combined.device.type == "cpu":
        return inverse_combined_ref(combined, tables, bpc, bpr, height, width)
    if combined.device.type != "cuda":
        raise ValueError(f"unsupported device {combined.device}")
    out = torch.empty((b, height, width, 3), dtype=torch.uint8,
                      device=combined.device)
    if out.numel() == 0:
        return out
    bases = _device_bases(table_keys(tables), combined.device)
    lib = load_kernel()
    with torch.cuda.device(combined.device):
        stream = torch.cuda.current_stream(combined.device).cuda_stream
        rc = lib.inv_megakernel_launch(
            combined.data_ptr(), out.data_ptr(), bases.data_ptr(), b, bpc,
            bpr, height, width, stream,
        )
    if rc != 0:
        msg = lib.inv_megakernel_error_string(rc).decode()
        raise RuntimeError(f"inv_megakernel launch failed: {msg} ({rc})")
    inverse_combined.launches += 1
    return out


inverse_combined.launches = 0


@dataclasses.dataclass(frozen=True)
class InversePlan:
    """K9's launch (the C entry ``inv_megakernel_plan``'s fields)."""

    units: int  # frames × block rows × ceil(bpr / BAND_TILES)
    tiles: int  # tiles a unit: BAND_TILES
    resident: Optional[int]  # resident CTAs on the card, if known
    ctas: Optional[int]  # min(units, resident)
    threads: int
    vec_in: bool  # 16-byte loads (input base 16-byte aligned)
    vec_out: bool  # 16-byte stores (output base and W·3 16-byte aligned)


def inverse_plan(batch: int, bpc: int, bpr: int, height: int, width: int,
                 in_offset: int = 0, out_offset: int = 0,
                 resident: Optional[int] = None) -> InversePlan:
    """The numpy mirror of ``inv_megakernel_plan`` for a (batch, bpc · bpr,
    128) buffer decoded to (batch, height, width, 3), its input and output
    bases ``in_offset`` and ``out_offset`` bytes past a 16-byte boundary,
    on a card where ``resident`` CTAs fit."""
    if not (min(batch, bpc, bpr, height, width) >= 0 and height <= 8 * bpc
            and width <= 8 * bpr):
        raise ValueError(f"a {height} x {width} image does not lie in "
                         f"{bpc} x {bpr} blocks")
    units = batch * bpc * (-(-bpr // BAND_TILES))
    if units > 2**31 - 1:  # the kernel's unit index is 32-bit
        raise ValueError(f"{units} units do not fit a 32-bit index")
    return InversePlan(
        units=units, tiles=BAND_TILES, resident=resident,
        ctas=None if resident is None else min(units, resident),
        threads=THREADS, vec_in=in_offset % VECTOR_BYTES == 0,
        vec_out=out_offset % VECTOR_BYTES == 0 and (3 * width) % VECTOR_BYTES == 0,
    )


def launch_plan(batch: int, bpc: int, bpr: int, height: int, width: int,
                in_ptr: int, out_ptr: int) -> InversePlan:
    """The C entry's plan of a launch between these device addresses (CUDA
    only)."""
    plan = (ctypes.c_int64 * 8)()
    lib = load_kernel()
    rc = lib.inv_megakernel_plan(batch, bpc, bpr, height, width, in_ptr % 16,
                                 out_ptr % 16, plan)
    if rc != 0:
        msg = lib.inv_megakernel_error_string(rc).decode()
        raise RuntimeError(f"inv_megakernel_plan failed: {msg} ({rc})")
    return InversePlan(units=plan[0], tiles=plan[1], resident=plan[2],
                       ctas=plan[3], threads=plan[4], vec_in=bool(plan[5]),
                       vec_out=bool(plan[6]))


def inverse_stores(plan: InversePlan, bpc: int, bpr: int, height: int,
                   width: int) -> Dict[str, np.ndarray]:
    """Every store of the launch, one per unit and pixel row whose warp
    stores anything (as ``unit_row`` in the source): the row's first output
    byte ``start``, its 16-byte vectors ``n_vec`` from ``start`` (on the
    vector route), the bytes after them stored a byte a lane ``n_bytes``,
    and the unit's ``tiles``."""
    units = np.arange(plan.units, dtype=np.int64)
    fr, j = np.divmod(units, -(-bpr // BAND_TILES))
    col0 = j * BAND_TILES
    ntiles = np.minimum(BAND_TILES, bpr - col0)
    frame, block_row = np.divmod(fr, bpc)
    row = (8 * block_row[:, None] + np.arange(8)).ravel()
    cols = np.repeat(np.minimum(8 * ntiles, width - 8 * col0), 8)
    keep = (row < height) & (cols > 0)
    count = 3 * cols[keep]
    start = ((np.repeat(frame, 8)[keep] * height + row[keep]) * width
             + 8 * np.repeat(col0, 8)[keep]) * 3
    n_vec = count // VECTOR_BYTES if plan.vec_out else np.zeros_like(count)
    return {"start": start, "n_vec": n_vec,
            "n_bytes": count - VECTOR_BYTES * n_vec,
            "tiles": np.repeat(ntiles, 8)[keep]}


def kernel_attributes(device) -> dict:
    """K9's registers a thread, static shared memory a CTA and resident CTAs
    an SM on ``device``'s card."""
    lib = load_kernel()
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.inv_megakernel_attributes(
            ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(lib.inv_megakernel_error_string(rc).decode())
    return {"registers": regs.value, "shared_bytes": smem.value,
            "ctas_per_sm": ctas.value}
