"""The forward megakernel: color + DCT + sparse RLE in one CUDA pass.

Port of ``lz4jpeg_tpu/ops/pallas_fwd.py``.  ``forward_combined`` maps a
(B, H, W, 3) uint8 image batch to the (B·bpc·bpr, 128) int16 combined
sparse-delta streams (lanes: 64 luma + 32 Cr + 32 Cb slots per block;
frames outermost, then block-row-major).  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/fwd_megakernel.cu``; on a CPU tensor it
runs ``forward_combined_ref``, the plain torch version of the same function
(the JAX package's tile chain, ``models/jpeg.py:365-376``).  There is no
fallback between the two: a CUDA call launches the kernel or raises.
``rgb_to_kt`` is the JAX package's "stage A", the (3, 64, N) KT block
layout that its Pallas kernel read (K1 reads RGB; the layout probes of
``profiles/megakernel.py`` read KT).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, fused_forward
from lz4jpeg_tpu_torch.ops.rle import rle_encode_sparse16

# Combined-output lane ranges: [0, 64) luma, [64, 96) Cr, [96, 128) Cb.
COMBINED_LANES = 128
LUM_SLICE = slice(0, 64)
CR_SLICE = slice(64, 96)
CB_SLICE = slice(96, 128)
CHANNEL_SLICES = {"lum": LUM_SLICE, "r": CR_SLICE, "b": CB_SLICE}


@functools.lru_cache(maxsize=None)
def kt_bases(lum_key: bytes, chr_key: bytes):
    """(my (64,64), mc64 (64,64 zero-padded), offs (128,1)) f32 numpy.

    ``mc64`` folds the 4:2:2 odd-column subsample into the chroma forward
    basis: chroma block position (r, c') reads full-res tile column 2c'+1
    (JPEG.c:327-333).  Rows 32..63 are zero padding.  A copy of
    ``lz4jpeg_tpu/ops/pallas_fwd.py::_kt_bases``."""
    my, offy = forward_basis(8, 8, lum_key)
    mc, offc = forward_basis(4, 8, chr_key)
    mc64 = np.zeros((64, 64))
    k_idx = np.arange(32)[:, None, None]
    r_idx = np.arange(8)[None, :, None]
    c_idx = np.arange(4)[None, None, :]
    mc64[k_idx, r_idx * 8 + 2 * c_idx + 1] = mc.reshape(32, 8, 4)[
        k_idx, r_idx, c_idx
    ]
    offs = np.concatenate([offy, offc, offc])[:, None]
    return (
        my.astype(np.float32),
        mc64.astype(np.float32),
        offs.astype(np.float32),
    )


def rgb_to_kt(rgb: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 → (3, 64, N) uint8 KT block layout, contiguous.

    N = prod(batch) · (H/8) · (W/8), blocks in block-row-major order
    (frames outermost); axis 1 is the position 8·row + col within the 8x8
    block.  A pure relayout (``reshape``/``permute``/``contiguous``), as
    ``lz4jpeg_tpu/ops/pallas_fwd.py::rgb_to_kt``; requires H % 8 == 0 and
    W % 8 == 0."""
    *batch, h, w, c = rgb.shape
    if c != 3 or h % 8 or w % 8:
        raise ValueError(f"expected (..., H, W, 3) with H, W multiples of 8, "
                         f"got {tuple(rgb.shape)}")
    x = rgb.reshape(*batch, h // 8, 8, w // 8, 8, 3)
    nb = len(batch)
    perm = (nb + 4, nb + 1, nb + 3, *range(nb), nb, nb + 2)
    return x.permute(*perm).contiguous().reshape(3, 64, -1)


def kt_tiles(kt: torch.Tensor):
    """(3, 64, N) KT layout → its (N, 64) R, G and B tiles (positions
    8·row + col), the blocks the plain versions work on."""
    if kt.dim() != 3 or tuple(kt.shape[:2]) != (3, 64):
        raise ValueError(f"expected a (3, 64, N) KT array, got {tuple(kt.shape)}")
    return tuple(kt[c].T for c in range(3))


def _blocks(rgb: torch.Tensor):
    """Validate a (B, H, W, 3) uint8 contiguous batch; return (B, bpc, bpr)."""
    if rgb.dtype != torch.uint8:
        raise TypeError(f"expected uint8 RGB, got {rgb.dtype}")
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"expected a (B, H, W, 3) batch, got {tuple(rgb.shape)}")
    if not rgb.is_contiguous():
        raise ValueError("RGB batch must be contiguous")
    b, h, w, _ = rgb.shape
    return b, -(-h // 8), -(-w // 8)


def forward_combined_ref(
    rgb: torch.Tensor, lum_table: np.ndarray, chr_table: np.ndarray
) -> torch.Tensor:
    """Plain torch version: color → 4:2:2 → ``split_mcus`` → fused basis
    matmul per channel → ``rle_encode_sparse16``, concatenated to
    (B·bpc·bpr, 128) int16."""
    _blocks(rgb)
    y, cr, cb = rgb_to_ycbcr(rgb)
    lum, r, b = split_mcus(
        y, chroma_subsample_422(cr), chroma_subsample_422(cb)
    )
    parts = []
    for tiles, table, width in ((lum, lum_table, 8), (r, chr_table, 4),
                                (b, chr_table, 4)):
        zz = fused_forward(tiles, table, width, 8)
        sp, _ = rle_encode_sparse16(zz.to(torch.int16))
        parts.append(sp)
    return torch.cat(parts, dim=1)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/fwd_megakernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("fwd_megakernel")
    lib.fwd_megakernel_launch.restype = ctypes.c_int
    lib.fwd_megakernel_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.fwd_megakernel_error_string.restype = ctypes.c_char_p
    lib.fwd_megakernel_error_string.argtypes = [ctypes.c_int]
    return lib


def split_basis(m: np.ndarray) -> np.ndarray:
    """(3, *m.shape) float32 parts hi, mid, lo of the float32 basis ``m``:
    each part holds bf16 values only (round to nearest even of the rest),
    and hi + mid + lo equals ``m.astype(np.float32)`` exactly.  An f32
    significand has 24 bits and each part takes the next 8 (one more through
    the rounding's sign), so three parts always suffice; raises otherwise."""
    rest = np.asarray(m, dtype=np.float32)
    parts = []
    for _ in range(3):
        bits = rest.view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        part = bits.astype(np.uint32).view(np.float32)
        parts.append(part)
        rest = rest - part  # exact: the rounding error of a float32
    if np.any(rest != 0):
        raise ValueError("basis is not the sum of three bf16 parts")
    return np.stack(parts)


@functools.lru_cache(maxsize=None)
def _device_bases(lum_key: bytes, chr_key: bytes, device: torch.device):
    """The kernel's basis operand on ``device``: the bf16 bits of
    ``split_basis`` of the luma basis (64, 64), then of the chroma basis
    (32, 32) (no pick folded in: the kernel's chroma operand is already the
    32 odd-column samples), as one int16 vector."""
    bases = (forward_basis(8, 8, lum_key)[0], forward_basis(4, 8, chr_key)[0])
    bits = [(split_basis(b).view(np.uint32) >> 16).astype(np.uint16).ravel()
            for b in bases]
    return torch.from_numpy(np.concatenate(bits).view(np.int16)).to(device)


def forward_combined(
    rgb: torch.Tensor, lum_table: np.ndarray, chr_table: np.ndarray
) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B·bpc·bpr, 128) int16 combined sparse streams.

    A CPU tensor runs ``forward_combined_ref``.  A CUDA tensor launches the
    Hopper kernel on the current stream and adds one to
    ``forward_combined.launches``; a refused launch raises.  The kernel
    stages bands with 16-byte asynchronous copies when the batch's address
    and row stride ``W·3`` are 16-byte aligned, and reads the bytes directly
    otherwise (both routes are the same kernel)."""
    b, bpc, bpr = _blocks(rgb)
    if rgb.device.type == "cpu":
        return forward_combined_ref(rgb, lum_table, chr_table)
    if rgb.device.type != "cuda":
        raise ValueError(f"unsupported device {rgb.device}")
    n = b * bpc * bpr
    out = torch.empty((n, COMBINED_LANES), dtype=torch.int16, device=rgb.device)
    if n == 0:
        return out
    parts = _device_bases(
        _table_key(lum_table), _table_key(chr_table), rgb.device
    )
    h, w = rgb.shape[1:3]
    staged = rgb.data_ptr() % 16 == 0 and (w * 3) % 16 == 0
    lib = load_kernel()
    with torch.cuda.device(rgb.device):
        stream = torch.cuda.current_stream(rgb.device).cuda_stream
        rc = lib.fwd_megakernel_launch(
            rgb.data_ptr(), out.data_ptr(), parts.data_ptr(), b, h, w, bpc,
            bpr, int(staged), stream,
        )
    if rc != 0:
        msg = lib.fwd_megakernel_error_string(rc).decode()
        raise RuntimeError(f"fwd_megakernel launch failed: {msg} ({rc})")
    forward_combined.launches += 1
    return out


forward_combined.launches = 0


def sparse_lengths(combined: torch.Tensor) -> dict:
    """(N, 128) combined sparse streams → per-channel symbol lengths
    ((N,) int32 each, 2·runs — the ``rle_encode_sparse16`` side channel)."""
    nz = (combined != 0).to(torch.int32)
    return {
        c: 2 * nz[:, sl].sum(dim=1, dtype=torch.int32)
        for c, sl in CHANNEL_SLICES.items()
    }
