"""The inverse megakernel: the sparse16 decode in one CUDA pass.

Port of the sparse16 branch of ``lz4jpeg_tpu/models/jpeg.py::_inverse_impl``
(:408-436, fed by ``_inverse_sparse_impl`` :448), which XLA ran with no
Pallas kernel.  ``inverse_combined`` maps the (B, N, 128) int16 combined
sparse16 buffer (N = bpc · bpr tiles a frame, block-row-major; lanes as
``ops/fwd_megakernel.py::CHANNEL_SLICES``) to (B, height, width, 3) uint8
RGB.  On a CUDA tensor it launches the hand-written Hopper kernel K9
``csrc/inv_megakernel.cu`` (un-bias, suffix-basis product on the tensor
cores as exact bf16 part products, ties recomputed by the fp32 FMA chain,
colour merge); on a CPU tensor it runs ``inverse_combined_ref``, the plain
torch chain (un-bias, ``fused_inverse_plane_sparse`` per channel,
``ycbcr_planes_to_rgb``).  There is no fallback between the two: a CUDA
call launches the kernel or raises.

The kernel's maps run on the card only; this module mirrors them in numpy
for the CPU tests (``tests/test_torch_inv_plan.py``): the k slots
(``slot_map``) and output columns (``column_map``), the operand fragments
(``operand_map``, ``operand_loads``, ``basis_loads``), the delta split and
the vote (``split_deltas``, ``products_issued``), the accumulators and the
colour merge they feed (``accumulator_map``, ``value_map``,
``merge_map``), the epilogue and its tie test (``pixel_fast``,
``row_windows``), the staged rows and the stores (``stage_stores``,
``inverse_stores``), the ring (``inverse_plan``, ``chunk_tiles``,
``chunk_schedule``), and ``emulate``, which composes them with exact part
products and a truncated k-step accumulation; ``parent_decode`` is the
fp32 FMA chain every byte must equal.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    fused_inverse_plane_sparse,
    inverse_suffix_basis,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    CHANNEL_SLICES,
    COMBINED_LANES,
    split_basis,
)
from lz4jpeg_tpu_torch.ops.rle import SPARSE16_DELTA_BIAS

CHANNELS = ("lum", "r", "b")
_CHANNEL_WIDTHS = {"lum": 8, "r": 4, "b": 4}  # tile columns of each channel
# csrc/inv_megakernel.cu's k9:: constants: tiles a unit (the A operand's 16
# rows), consumer warps a CTA (a unit each a chunk), ring slots, CTAs an SM,
# bytes a tile and a staged RGB row, the tie window, the scale of a row's
# weighted |Δ| sum that widens it and the window past which every value of
# a row takes the chain.
UNIT_TILES = 16
WARPS = 8
STAGES = 2
CTAS_PER_SM = 1
THREADS = 32 * WARPS
TILE_BYTES = 2 * COMBINED_LANES
STAGE_ROW = 448
DELTA_ROW = COMBINED_LANES + 4  # floats a staged delta row (the tie pass's)
VECTOR_BYTES = 16
TIE_WINDOW = 2.0 ** -9
ROW_SCALE = 2.0 ** -21
EVERY_WINDOW = 2.0 ** -4
_STRIDES = {64: 72, 32: 40}  # bf16 a staged basis row, by terms
_ROWS = {64: 68, 32: 36}  # fp32 a staged basis row (the tie pass's)


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
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
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
    """The kernel's fp32 basis operand (its tie pass's) on ``device``:
    ``basis_arrays(keys)``'s luma, Cr and Cb bases flattened into one
    float32 vector of 6,144."""
    arrays = basis_arrays(keys)
    flat = np.concatenate([arrays[c].ravel() for c in CHANNELS])
    return torch.from_numpy(flat).to(device)


@functools.lru_cache(maxsize=None)
def basis_parts(keys) -> Dict[str, np.ndarray]:
    """Per channel the (3, P, P) float32 parts hi, mid, lo of
    ``split_basis`` of ``basis_arrays(keys)`` in the kernel's operand order:
    row n is output column n (basis row ``column_map(P)[n]``), column k is
    k slot k (term ``m`` at ``slot_map(P)[m]``)."""
    out = {}
    for name, basis in basis_arrays(keys).items():
        hw = basis.shape[0]
        parts = split_basis(basis)[:, column_map(hw)]
        staged = np.empty_like(parts)
        staged[:, :, slot_map(hw)] = parts
        out[name] = staged
    return out


@functools.lru_cache(maxsize=None)
def _device_parts(keys, device: torch.device) -> torch.Tensor:
    """The kernel's bf16 basis operand on ``device``: the bits of
    ``basis_parts(keys)``, luma, Cr, Cb, as one int16 vector of 18,432."""
    flat = np.concatenate([basis_parts(keys)[c].ravel() for c in CHANNELS])
    bits = (flat.view(np.uint32) >> 16).astype(np.uint16)
    return torch.from_numpy(bits.view(np.int16)).to(device)


def table_keys(tables: Dict[str, np.ndarray]) -> tuple:
    return tuple(_table_key(tables[c]) for c in CHANNELS)


def inverse_combined(
    combined: torch.Tensor, tables: Dict[str, np.ndarray], bpc: int, bpr: int,
    height: int, width: int, ties: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, bpc · bpr, 128) int16 combined sparse16 buffer → (B, height,
    width, 3) uint8 RGB.

    A CPU tensor runs ``inverse_combined_ref``.  A CUDA tensor launches K9
    on the current stream into a new contiguous output and adds one to
    ``inverse_combined.launches``; a refused launch raises.  Both devices
    raise on a buffer of another shape or type or a non-contiguous one.
    ``ties``, a CUDA int64 tensor, receives in its first element the count of plane values K9's tie pass
    recomputed (added to what it holds)."""
    b = _check(combined, bpc, bpr, height, width)
    if ties is not None and (ties.dtype != torch.int64 or ties.numel() < 1
                             or ties.device != combined.device):
        raise ValueError("ties must be an int64 tensor on the buffer's device")
    if combined.device.type == "cpu":
        return inverse_combined_ref(combined, tables, bpc, bpr, height, width)
    if combined.device.type != "cuda":
        raise ValueError(f"unsupported device {combined.device}")
    out = torch.empty((b, height, width, 3), dtype=torch.uint8,
                      device=combined.device)
    if out.numel() == 0:
        return out
    keys = table_keys(tables)
    bases = _device_bases(keys, combined.device)
    parts = _device_parts(keys, combined.device)
    lib = load_kernel()
    with torch.cuda.device(combined.device):
        stream = torch.cuda.current_stream(combined.device).cuda_stream
        rc = lib.inv_megakernel_launch(
            combined.data_ptr(), out.data_ptr(), parts.data_ptr(),
            bases.data_ptr(), b, bpc, bpr, height, width,
            None if ties is None else ties.data_ptr(), stream,
        )
    if rc != 0:
        msg = lib.inv_megakernel_error_string(rc).decode()
        raise RuntimeError(f"inv_megakernel launch failed: {msg} ({rc})")
    inverse_combined.launches += 1
    return out


inverse_combined.launches = 0


# ---------------------------------------------------------------------------
# The operand, accumulator and merge maps
# ---------------------------------------------------------------------------


def slot_map(hw: int) -> np.ndarray:
    """σ: the k slot of term j of a channel's HW terms, ``16 v + 2 c + (e &
    1) + 8 (e >> 1)`` where lane c of a row's four lanes holds terms j =
    (HW/4)·c + 4 v + e: one 32-byte (luma) or 16-byte (chroma) run of the
    tile's int16 words."""
    j = np.arange(hw)
    c, v, e = j // (hw // 4), (j % (hw // 4)) // 4, j % 4
    return 16 * v + 2 * c + (e & 1) + 8 * (e >> 1)


def column_map(hw: int) -> np.ndarray:
    """The basis row (output) of each product column n = 8 t + 2 c + e (n-
    tile t, held by lanes c = lane % 4 as accumulators e = 0, 1): luma pixel
    (u, v) = (2 (t >> 1) + (c >> 1), 4 (c & 1) + 2 (t & 1) + e), row 8 u + v;
    chroma sample (u, s) = (2 t + (c >> 1), 2 (c & 1) + e), row 4 u + s.  So
    lane c holds, for pixel rows u ≡ c >> 1 (mod 2), the Y of pixels 4 (c &
    1) .. + 3 and the Cr and Cb of the two samples they take."""
    n = np.arange(hw)
    t, c, e = n // 8, (n % 8) // 2, n % 2
    if hw == 64:
        return 8 * (2 * (t >> 1) + (c >> 1)) + 4 * (c & 1) + 2 * (t & 1) + e
    return 4 * (2 * t + (c >> 1)) + 2 * (c & 1) + e


def operand_map(hw: int) -> np.ndarray:
    """(32, HW/16, 4, 2, 2) int: for lane, k-step, A register and half, the
    (row of the unit's 16, term j) it holds, as the kernel fills them:
    register 0 row g, 1 row g + 8, 2 row g, 3 row g + 8 (g = lane / 4), the
    low half term e = 0 or 2 (registers 0-1 or 2-3) of the lane's four for
    the k-step, the high half e + 1: each register one 32-bit word of the
    row."""
    lane = np.arange(32)[:, None, None, None]
    ks = np.arange(hw // 16)[None, :, None, None]
    reg = np.arange(4)[None, None, :, None]
    half = np.arange(2)[None, None, None, :]
    g, c = lane // 4, lane % 4
    row = g + 8 * (reg & 1)
    j = (hw // 4) * c + 4 * ks + 2 * (reg >> 1) + half
    row, j = np.broadcast_arrays(row, j)
    return np.stack([row, j], axis=-1)


def a_fragment_slot(hw: int) -> np.ndarray:
    """(32, HW/16, 4, 2, 2) int: the (row, k slot) of mma.m16n8k16's A
    fragment (PTX: register r of lane (g, c) holds row g + 8 (r & 1), k
    16 ks + 2c + 8 (r >> 1) + half)."""
    lane = np.arange(32)[:, None, None, None]
    ks = np.arange(hw // 16)[None, :, None, None]
    reg = np.arange(4)[None, None, :, None]
    half = np.arange(2)[None, None, None, :]
    g, c = lane // 4, lane % 4
    row = g + 8 * (reg & 1)
    k = 16 * ks + 2 * c + 8 * (reg >> 1) + half
    row, k = np.broadcast_arrays(row, k)
    return np.stack([row, k], axis=-1)


def operand_loads() -> List[Tuple[int, np.ndarray]]:
    """Each shared load of a warp's A operand as (bytes a lane, (32,) byte
    offsets in the slot from the unit's first tile): per row g, then g + 8,
    the luma's two 16-byte halves of bytes 32c .. + 31, then Cr (bytes 128
    + 16c) and Cb (192 + 16c)."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    out = []
    for h in range(2):
        row = (g + 8 * h) * TILE_BYTES
        out += [(16, row + 32 * c), (16, row + 32 * c + 16),
                (16, row + 128 + 16 * c), (16, row + 192 + 16 * c)]
    return out


def basis_loads(hw: int) -> List[np.ndarray]:
    """The row addresses (bytes from the part's start) the 32 lanes give
    each ldmatrix.x4 of a product, one array per (k-step, n-tile pair):
    lane l names row 16p + (l & 7) + 8 (l >> 4) at k 16ks + 8 ((l >> 3) &
    1) of rows ``_STRIDES[hw]`` bf16 apart."""
    lane = np.arange(32)
    stride = _STRIDES[hw]
    return [2 * ((16 * p + (lane & 7) + 8 * (lane >> 4)) * stride
                 + 16 * ks + 8 * ((lane >> 3) & 1))
            for ks in range(hw // 16) for p in range(hw // 16)]


def accumulator_map(hw: int) -> np.ndarray:
    """(32, HW/8, 4, 2) int: for lane, n-tile and accumulator register, the
    (row, column) of the warp's (16, HW) product (PTX m16n8 C fragment: row
    g + 8 (i >> 1), column 8 nt + 2c + (i & 1))."""
    lane = np.arange(32)[:, None, None]
    nt = np.arange(hw // 8)[None, :, None]
    i = np.arange(4)[None, None, :]
    row = lane // 4 + 8 * (i >> 1)
    col = 8 * nt + 2 * (lane % 4) + (i & 1)
    row, col = np.broadcast_arrays(row, col)
    return np.stack([row, col], axis=-1)


def value_map() -> np.ndarray:
    """(32, 64, 3) int: each lane's 64 plane values by index i (its
    accumulators: luma 4 nt + i for nt < 8, Cr 32 + 4 nt + i, Cb 48 + 4 nt
    + i), as (channel 0 luma / 1 Cr / 2 Cb, row of the unit, basis row)."""
    out = np.empty((32, 64, 3), dtype=np.int64)
    for ch, (hw, at) in enumerate(((64, 0), (32, 32), (32, 48))):
        acc = accumulator_map(hw).reshape(32, -1, 2)
        k = acc.shape[1]
        out[:, at:at + k, 0] = ch
        out[:, at:at + k, 1] = acc[..., 0]
        out[:, at:at + k, 2] = column_map(hw)[acc[..., 1]]
    return out


def merge_map() -> np.ndarray:
    """(32, 2, 4, 4, 6) int: for lane (g, c), tile h (row g + 8h), group k
    (pixel row u = 2k + (c >> 1)) and pixel q of its four (column v = 4 (c
    & 1) + q): (Y value, Cr value, Cb value as indices into the lane's 64,
    row of the unit, u, v).  The Y is luma n-tile 2k + (q >> 1)'s
    accumulator 2h + (q & 1), the chroma n-tile k's accumulator 2h + (q >>
    1) of Cr and of Cb."""
    out = np.empty((32, 2, 4, 4, 6), dtype=np.int64)
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for h in range(2):
            for k in range(4):
                for q in range(4):
                    y = 4 * (2 * k + (q >> 1)) + 2 * h + (q & 1)
                    s = 4 * k + 2 * h + (q >> 1)
                    out[lane, h, k, q] = (y, 32 + s, 48 + s, g + 8 * h,
                                          2 * k + (c >> 1), 4 * (c & 1) + q)
    return out


def stage_stores() -> List[np.ndarray]:
    """Each staging store of a warp as (32,) byte offsets of a lane's 4-byte
    word in its buffer (rows of ``STAGE_ROW`` bytes): for tile h, group k
    and word w of the lane's 12 bytes, row 2k + (c >> 1) at byte 24 (g + 8h)
    + 12 (c & 1) + 4 w."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    return [(2 * k + (c >> 1)) * STAGE_ROW + 24 * (g + 8 * h) + 12 * (c & 1)
            + 4 * w for h in range(2) for k in range(4) for w in range(3)]


# ---------------------------------------------------------------------------
# The arithmetic
# ---------------------------------------------------------------------------


def unbias(words: np.ndarray) -> np.ndarray:
    """Δ = (w ≠ 0) ? w − 1024 : 0, as int64."""
    w = np.asarray(words, dtype=np.int64)
    return np.where(w != 0, w - SPARSE16_DELTA_BIAS, 0)


def split_deltas(delta: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's split of integer deltas (|Δ| < 2¹⁶) into float32 bf16
    values hi + mid = Δ exactly: hi the float's top 16 bits (its sign,
    exponent and 7 significand bits), mid = Δ − hi, exact in float32 and,
    with at most 8 significant bits, in bf16.  |Δ| < 2⁸ needs hi alone."""
    f = np.asarray(delta, dtype=np.float32)
    hi = (f.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    return hi, f - hi


def products_issued(live_mid: bool) -> List[Tuple[int, int]]:
    """The (delta part, basis part) products a warp issues on a channel, in
    order: part indices 0 hi, 1 mid (2 lo of the basis); by level pa + pb
    from 3 (mid · lo) down to 0 (hi · hi), the mid delta part first within
    a level; the mid part only where the warp's vote finds it non-zero."""
    return [(pa, level - pa) for level in range(3, -1, -1)
            for pa in (1, 0) if 0 <= level - pa <= 2 and (pa == 0 or live_mid)]


def accumulate(acc: np.ndarray, products: np.ndarray,
               bits: int = 24) -> np.ndarray:
    """One k-step of the tensor core's fp32 accumulation, as this mirror
    models it: the accumulator (float64 holding float32 values, (..., n))
    and the step's exact products ((..., k, n)) each cut toward zero to
    ``bits`` bits from the top of the largest magnitude among them, summed
    exactly, the sum cut toward zero to float32."""
    terms = np.concatenate([acc[..., None, :], products], axis=-2)
    top = np.abs(terms).max(axis=-2, keepdims=True)
    _, e = np.frexp(top)
    ulp = np.where(top > 0, np.ldexp(1.0, e - bits), 1.0)
    s = (np.trunc(terms / ulp) * ulp).sum(axis=-2)
    return _rz32(s).astype(np.float64)


def _rz32(x: np.ndarray) -> np.ndarray:
    """Float64 values rounded toward zero to float32, as ``__fadd_rz``."""
    f = np.asarray(x, dtype=np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """fmaf on float32 arrays: a·b + c rounded once to float32 (nearest,
    ties to even).  The product of an integer |a| < 2²⁹ and a float32 is
    exact in float64; the sum is rounded to float64 with its error kept
    (TwoSum), which decides the one case where rounding twice differs: a
    float64 sum exactly half-way between two float32 values."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c64 = np.asarray(c, np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    up = np.nextafter(r, np.float32(np.inf))
    dn = np.nextafter(r, np.float32(-np.inf))
    with np.errstate(invalid="ignore"):
        fix_up = (err > 0) & (r64 < s) & (up.astype(np.float64) - s == s - r64)
        fix_dn = (err < 0) & (r64 > s) & (s - dn.astype(np.float64) == r64 - s)
    return np.where(fix_up, up, np.where(fix_dn, dn, r))


def chain(delta: np.ndarray, basis: np.ndarray) -> np.ndarray:
    """The parent's plane values: (..., M) integer deltas and a (P, M)
    float32 basis → (..., P) float32 ``acc = fmaf(Δ_m, S[p, m], acc)`` for
    m = 0 .. M − 1 from 0 (the tie pass's order)."""
    d = np.asarray(delta, dtype=np.float32)
    acc = np.zeros(d.shape[:-1] + (basis.shape[0],), dtype=np.float32)
    for m in range(d.shape[-1]):
        acc = fma32(d[..., m:m + 1], basis[:, m], acc)
    return acc


def pixel(acc: np.ndarray) -> np.ndarray:
    """The parent's byte of a float32 plane value: x = acc + 128, then
    sign(x) · floor(|x| + 0.5) clamped to [0, 255] (every x ≤ 0 gives 0)."""
    f32 = np.float32
    x = np.asarray(acc, dtype=f32) + f32(128)
    r = np.floor(x + f32(0.5))
    return np.where(x > 0, np.minimum(r, f32(255)), f32(0)).astype(np.int64)


K23 = 2.0 ** 23
BITS23 = int(np.float32(K23).view(np.int32))


def pixel_fast(acc: np.ndarray, window) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's epilogue on a tensor-core plane value, step for step: v
    = acc + 128.5, ``bits`` the int32 bits of v + 2²³ rounded toward zero,
    the byte clamp(bits, 2²³'s bits, + 255) − 2²³'s (floor(v) in [0, 255]);
    ``near`` where v lies within ``window`` of an integer and the clamp
    left ``bits`` as it was (the byte steps there).  Returns (bytes,
    near)."""
    f32 = np.float32
    v = np.asarray(acc, dtype=f32) + f32(128.5)
    with np.errstate(invalid="ignore", over="ignore"):
        shifted = _rz32(v.astype(np.float64) + K23)
        bits = shifted.view(np.int32).astype(np.int64)
        clamped = np.clip(bits, BITS23, BITS23 + 255)
        u = v - (shifted - f32(K23 - 0.5))
        near = (np.abs(u) > f32(0.5) - np.asarray(window, dtype=f32)) & (
            clamped == bits)
    return clamped - BITS23, near


def term_weights(keys) -> np.ndarray:
    """(128,) float32: each term's weight in its row's window, as the kernel
    stages them (``stage_weights``): the largest |S[p, m]| over the
    channel's outputs p, times ROW_SCALE."""
    bases = basis_arrays(keys)
    return np.concatenate([np.abs(bases[name]).max(axis=0) * np.float32(
        ROW_SCALE) for name in CHANNELS]).astype(np.float32)


def row_windows(deltas: np.ndarray, keys) -> Tuple[np.ndarray, np.ndarray]:
    """Each (unit, row, channel)'s tie window from (units, 16, 128) deltas:
    TIE_WINDOW, or the row's Σ_m |Δ_m| · weight_m where that is larger (a
    bound of the row's Σ|Δ·S| for every output, scaled: the two summation
    orders' distance grows with it); and whether every value of the row
    takes the chain (its window past EVERY_WINDOW).  Returns ((U, 16, 3)
    windows, (U, 16, 3) bools)."""
    wt = term_weights(keys).astype(np.float64)
    a = np.abs(np.asarray(deltas, dtype=np.float64)) * wt
    sums = np.stack([a[..., CHANNEL_SLICES[name]].sum(axis=-1)
                     for name in CHANNELS], axis=-1)
    w = np.maximum(np.float32(TIE_WINDOW), sums.astype(np.float32))
    return w, w > np.float32(EVERY_WINDOW)


def merge(y, cr, cb) -> np.ndarray:
    """(..., 3) uint8 RGB of Y, Cr, Cb bytes by ``csrc/color_merge.cuh``'s
    arithmetic: each chroma term an fp32 product of (float)c − 128 by the
    fp32 constant, truncated toward zero; each channel clamped."""
    f32 = np.float32
    fr = np.asarray(cr, dtype=f32) - f32(128)
    fb = np.asarray(cb, dtype=f32) - f32(128)

    def term(k, x):
        return np.trunc(f32(k) * x).astype(np.int64)

    y = np.asarray(y, dtype=np.int64)
    rgb = np.stack([y + term(1.402, fr),
                    y - (term(0.344136, fb) + term(0.714136, fr)),
                    y + term(1.772, fb)], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# The work map and the ring
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InversePlan:
    """K9's launch (the C entry ``inv_megakernel_plan``'s fields)."""

    units: int  # frames × block rows × ceil(bpr / UNIT_TILES)
    tiles: int  # tiles a unit: UNIT_TILES
    chunk: int  # units a ring slot: WARPS
    chunks: int
    resident: Optional[int]  # resident CTAs on the card, if known
    ctas: Optional[int]  # min(chunks, resident)
    threads: int
    stages: int
    smem: int  # dynamic shared memory a CTA
    vec_in: bool  # bulk copies (input base 16-byte aligned), else words
    vec_out: bool  # 16-byte stores (output base and W·3 16-byte aligned)


def smem_bytes() -> int:
    """``k9::kSmem``: the basis parts (3 parts of luma rows of 72 and two
    chroma channels' rows of 40 bf16), the fp32 bases (luma rows of 68 and
    chroma rows of 36 floats), the 128 term weights, rounded up to 128
    bytes; the ring; each warp's buffer (its unit's deltas as fp32 rows of
    DELTA_ROW, then its staged RGB rows over them); the slots' mbarriers
    and release counters."""
    basis = 3 * (64 * _STRIDES[64] + 2 * 32 * _STRIDES[32]) * 2
    basis += 64 * (_ROWS[64] + _ROWS[32]) * 4 + 128 * 4
    return (-(-basis // 128) * 128 + STAGES * WARPS * UNIT_TILES * TILE_BYTES
            + WARPS * UNIT_TILES * DELTA_ROW * 4 + 12 * STAGES)


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
    units = batch * bpc * (-(-bpr // UNIT_TILES))
    if units > 2**31 - 1:  # the kernel's unit index is 32-bit
        raise ValueError(f"{units} units do not fit a 32-bit index")
    chunks = -(-units // WARPS)
    return InversePlan(
        units=units, tiles=UNIT_TILES, chunk=WARPS, chunks=chunks,
        resident=resident,
        ctas=None if resident is None else min(chunks, resident),
        threads=THREADS, stages=STAGES, smem=smem_bytes(),
        vec_in=in_offset % VECTOR_BYTES == 0,
        vec_out=out_offset % VECTOR_BYTES == 0 and (3 * width) % VECTOR_BYTES == 0,
    )


def launch_plan(batch: int, bpc: int, bpr: int, height: int, width: int,
                in_ptr: int, out_ptr: int) -> InversePlan:
    """The C entry's plan of a launch between these device addresses (CUDA
    only)."""
    plan = (ctypes.c_int64 * 11)()
    lib = load_kernel()
    rc = lib.inv_megakernel_plan(batch, bpc, bpr, height, width, in_ptr % 16,
                                 out_ptr % 16, plan)
    if rc != 0:
        msg = lib.inv_megakernel_error_string(rc).decode()
        raise RuntimeError(f"inv_megakernel_plan failed: {msg} ({rc})")
    return InversePlan(units=plan[0], tiles=plan[1], chunk=plan[2],
                       chunks=plan[3], resident=plan[4], ctas=plan[5],
                       threads=plan[6], stages=plan[7], smem=plan[8],
                       vec_in=bool(plan[9]), vec_out=bool(plan[10]))


class Unit(NamedTuple):
    """Unit ``index``'s tiles: ``tile0`` its first in the buffer, ``tiles``
    of them, of block row ``block_row`` of frame ``frame`` from block
    column ``col0``."""

    tile0: np.ndarray
    tiles: np.ndarray
    frame: np.ndarray
    block_row: np.ndarray
    col0: np.ndarray


def unit_of(units, bpc: int, bpr: int) -> Unit:
    """``k9::unit_of`` on an array of unit indices."""
    u = np.asarray(units, dtype=np.int64)
    fr, j = np.divmod(u, -(-bpr // UNIT_TILES))
    col0 = j * UNIT_TILES
    frame, block_row = np.divmod(fr, bpc)
    return Unit(fr * bpr + col0, np.minimum(UNIT_TILES, bpr - col0), frame,
                block_row, col0)


def chunk_tiles(plan: InversePlan, bpc: int, bpr: int,
                chunk: int) -> Tuple[int, int, np.ndarray]:
    """Chunk ``chunk``'s copy: (first tile, tiles) of its units (WARPS
    consecutive ones, fewer in the last chunk, so one contiguous run), and
    each warp's unit's first tile in the slot (−1 past the last unit)."""
    units = np.arange(chunk * plan.chunk, (chunk + 1) * plan.chunk)
    live = units < plan.units
    g = unit_of(units[live], bpc, bpr)
    first = int(g.tile0[0])
    count = int(g.tile0[-1] + g.tiles[-1]) - first
    offsets = np.full(plan.chunk, -1, dtype=np.int64)
    offsets[live] = g.tile0 - first
    return first, count, offsets


def chunk_schedule(plan: InversePlan) -> List[np.ndarray]:
    """Each CTA's walk, as the kernel's loop makes it: one (T, 4) int64
    array a CTA of rows (chunk, slot, parity, refill): chunk b, b + ctas,
    ... of CTA b, its i-th in slot i % stages, its warps waiting on the
    slot's "full" mbarrier with parity (i // stages) & 1; the first
    ``stages`` chunks are filled at the start, and the last warp to
    release chunk i fills the slot with chunk i + stages (``refill``, the
    row of that chunk; −1 past the CTA's last)."""
    out = []
    for b in range(plan.ctas):
        chunk = np.arange(b, plan.chunks, plan.ctas, dtype=np.int64)
        i = np.arange(chunk.size, dtype=np.int64)
        refill = np.where(i + plan.stages < chunk.size, i + plan.stages, -1)
        out.append(np.stack([chunk, i % plan.stages, (i // plan.stages) & 1,
                             refill], 1))
    return out


def inverse_stores(plan: InversePlan, bpc: int, bpr: int, height: int,
                   width: int) -> Dict[str, np.ndarray]:
    """Every store of the launch, one per unit and pixel row with bytes to
    store (as ``store_unit`` in the source): the row's first output byte
    ``start``, its 16-byte vectors ``n_vec`` from ``start`` (on the vector
    route), the bytes after them stored a byte a lane ``n_bytes``, and the
    unit's ``tiles``."""
    g = unit_of(np.arange(plan.units), bpc, bpr)
    row = (8 * g.block_row[:, None] + np.arange(8)).ravel()
    cols = np.repeat(np.minimum(8 * g.tiles, width - 8 * g.col0), 8)
    keep = (row < height) & (cols > 0)
    count = 3 * cols[keep]
    start = ((np.repeat(g.frame, 8)[keep] * height + row[keep]) * width
             + 8 * np.repeat(g.col0, 8)[keep]) * 3
    n_vec = count // VECTOR_BYTES if plan.vec_out else np.zeros_like(count)
    return {"start": start, "n_vec": n_vec,
            "n_bytes": count - VECTOR_BYTES * n_vec,
            "tiles": np.repeat(g.tiles, 8)[keep]}


# ---------------------------------------------------------------------------
# The kernel composed
# ---------------------------------------------------------------------------


def _unit_deltas(combined, bpc: int, bpr: int) -> np.ndarray:
    """(units, 16, 128) int64 deltas of each unit's 16 rows; the rows past
    a block row's last tile are 0, as the kernel forms them."""
    d = unbias(np.asarray(combined)).reshape(-1, bpr, COMBINED_LANES)
    ur = -(-bpr // UNIT_TILES)
    pad = np.zeros((d.shape[0], ur * UNIT_TILES, COMBINED_LANES), np.int64)
    pad[:, :bpr] = d
    return pad.reshape(-1, UNIT_TILES, COMBINED_LANES)


def _products(delta: np.ndarray, parts: np.ndarray,
              live: np.ndarray) -> np.ndarray:
    """(U, 16, HW) float64 tensor-core sums in column order of a channel's
    (U, 16, HW) deltas, the A operand filled by ``operand_map`` and read
    as the PTX fragment (``a_fragment_slot``), the products of
    ``products_issued`` by the unit's vote ``live`` accumulated a k-step at
    a time (``accumulate``)."""
    u, _, hw = delta.shape
    fill, frag = operand_map(hw), a_fragment_slot(hw)
    split = split_deltas(delta)
    a = np.zeros((2, u, 16, hw))
    for pa in range(2):
        regs = split[pa][:, fill[..., 0], fill[..., 1]]
        a[pa][:, frag[..., 0], frag[..., 1]] = regs
    acc = np.zeros((u, 16, hw))
    for vote in (False, True):
        sel = live == vote
        if not sel.any():
            continue
        t = np.zeros((int(sel.sum()), 16, hw))
        for pa, pb in products_issued(vote):
            b = parts[pb].astype(np.float64).T  # B[k][n]
            for ks in range(hw // 16):
                k = slice(16 * ks, 16 * ks + 16)
                t = accumulate(t, a[pa][sel][:, :, k, None] * b[None, None, k])
        acc[sel] = t
    return acc


def emulate(combined, tables: Dict[str, np.ndarray], bpc: int, bpr: int,
            height: int, width: int, ties: bool = True,
            stats: Optional[dict] = None) -> np.ndarray:
    """K9 composed from the mirrored maps: (B, N, 128) int16 → (B, height,
    width, 3) uint8.  Per unit: each channel's tensor-core sums
    (``_products``), placed into the lanes' accumulators
    (``accumulator_map``) and read as their 64 plane values
    (``value_map``); the epilogue (``pixel_fast``) with its row's window
    (``row_windows``); the tie pass (``chain``, ``pixel``) for each value
    near a step (every value of a row past EVERY_WINDOW), unless ``ties``
    is False;
    the merge (``merge_map``, ``merge``) into the staged rows
    (``stage_stores``) and the stores (``inverse_stores``).  ``stats``, a
    dict, receives the count of values, of tie-pass values, of values
    whose fast byte differs from the chain's (``wrong``) and of those
    outside the window (``missed``), the largest |sum − chain| in its
    row's windows (``distance``) of the values whose byte may step (v =
    chain + 128.5 in (−1, 256)) in the rows that do not chain every
    value."""
    combined = np.asarray(combined)
    b = combined.shape[0]
    keys = table_keys(tables)
    bases, parts = basis_arrays(keys), basis_parts(keys)
    d = _unit_deltas(combined, bpc, bpr)  # (U, 16, 128)
    n_units = d.shape[0]
    row_w, row_every = row_windows(d, keys)
    vmap = value_map()  # (32, 64, 3)
    sums = np.empty((n_units, 32, 64))
    exact = np.empty((n_units, 32, 64), dtype=np.int64)
    chained = np.empty((n_units, 32, 64))
    for ch, name in enumerate(CHANNELS):
        delta = d[:, :, CHANNEL_SLICES[name]]
        live = (split_deltas(delta)[1] != 0).any(axis=(1, 2))
        t = _products(delta, parts[name], live)  # columns n
        plane = np.empty_like(t)
        plane[:, :, column_map(t.shape[2])] = t  # basis rows p
        c = chain(delta, bases[name]).astype(np.float64)
        at = vmap[..., 0] == ch
        lanes, idx = np.nonzero(at)
        rows, ps = vmap[lanes, idx, 1], vmap[lanes, idx, 2]
        sums[:, lanes, idx] = plane[:, rows, ps]
        chained[:, lanes, idx] = c[:, rows, ps]
    exact[:] = pixel(chained)
    window = row_w[:, vmap[..., 1], vmap[..., 0]]  # (U, 32, 64)
    every = row_every[:, vmap[..., 1], vmap[..., 0]]
    fast, near = pixel_fast(sums, window)
    near |= every
    chosen = np.where(near, exact, fast) if ties else fast
    if stats is not None:
        wrong = fast != exact
        stats["values"] = stats.get("values", 0) + sums.size
        stats["ties"] = stats.get("ties", 0) + int(near.sum())
        stats["wrong"] = stats.get("wrong", 0) + int(wrong.sum())
        stats["missed"] = stats.get("missed", 0) + int((wrong & ~near).sum())
        dist = np.abs(sums - chained) / window
        steps = (chained > -129.5) & (chained < 127.5)  # a byte may step
        dist = np.where(every | ~steps, 0.0, dist)
        stats["distance"] = max(stats.get("distance", 0.0),
                                float(dist.max(initial=0.0)))
    # the merge into each warp's staged rows, then the stores
    mm = merge_map()  # (32, 2, 4, 4, 6)
    lane = np.arange(32)[:, None, None, None]
    rgb = merge(chosen[:, lane, mm[..., 0]], chosen[:, lane, mm[..., 1]],
                chosen[:, lane, mm[..., 2]])  # (U, 32, 2, 4, 4, 3)
    staged = np.zeros((n_units, 8 * STAGE_ROW), dtype=np.uint8)
    words = rgb.reshape(n_units, 32, 2, 4, 3, 4)  # 12 bytes: 3 words
    offs = stage_stores()
    for n, (h, k, w) in enumerate((h, k, w) for h in range(2)
                                  for k in range(4) for w in range(3)):
        for byte in range(4):
            staged[:, offs[n] + byte] = words[:, :, h, k, w, byte]
    out = np.zeros(b * height * width * 3, dtype=np.uint8)
    plan = inverse_plan(b, bpc, bpr, height, width)
    g = unit_of(np.arange(plan.units), bpc, bpr)
    for unit in range(plan.units):
        for u in range(8):
            row = 8 * g.block_row[unit] + u
            cols = min(8 * g.tiles[unit], width - 8 * g.col0[unit])
            if row >= height or cols <= 0:
                continue
            start = ((g.frame[unit] * height + row) * width
                     + 8 * g.col0[unit]) * 3
            src = staged[unit, u * STAGE_ROW:u * STAGE_ROW + 3 * cols]
            out[start:start + 3 * cols] = src
    return out.reshape(b, height, width, 3)


def parent_decode(combined, tables: Dict[str, np.ndarray], bpc: int,
                  bpr: int, height: int, width: int) -> np.ndarray:
    """The bytes of K9's parent kernel, whose every plane value is the fp32
    FMA chain in term order (``chain``) rounded by ``pixel``: (B, N, 128)
    int16 → (B, height, width, 3) uint8."""
    combined = np.asarray(combined)
    b = combined.shape[0]
    bases = basis_arrays(table_keys(tables))
    d = unbias(combined).reshape(b, bpc, bpr, COMBINED_LANES)
    planes = {}
    for name in CHANNELS:
        tw = _CHANNEL_WIDTHS[name]
        v = pixel(chain(d[..., CHANNEL_SLICES[name]], bases[name]))
        v = v.reshape(b, bpc, bpr, 8, tw).transpose(0, 1, 3, 2, 4)
        v = v.reshape(b, 8 * bpc, bpr * tw)
        planes[name] = v if tw == 8 else np.repeat(v, 2, axis=2)
    return merge(planes["lum"], planes["r"], planes["b"])[:, :height, :width]


def part_products(combined: torch.Tensor, bpc: int, bpr: int) -> int:
    """The tensor-core operations K9's warps issue on this (B, bpc · bpr,
    128) buffer: per unit and channel, the hi part's 3 products (one a
    basis part) and, where the unit's fragment has a mid part (a delta not
    exact in bf16, the vote), the mid part's 3, each 2 · 16 · K² operations
    (K = 64 terms luma, 32 chroma; a ragged unit's missing rows included).
    The tensor work of K9's bound; computed a frame at a time on the
    buffer's device."""
    ur = -(-bpr // UNIT_TILES)
    total = 0
    for frame in combined:
        d = frame.reshape(bpc, bpr, COMBINED_LANES).to(torch.int32)
        d = torch.where(d != 0, d - SPARSE16_DELTA_BIAS, 0)
        mid = (d.to(torch.float32).view(torch.int32) & 0xFFFF) != 0
        pad = torch.zeros((bpc, ur * UNIT_TILES, COMBINED_LANES),
                          dtype=torch.bool, device=d.device)
        pad[:, :bpr] = mid
        pad = pad.reshape(bpc, ur, UNIT_TILES, COMBINED_LANES)
        for name in CHANNELS:
            k = 8 * _CHANNEL_WIDTHS[name]
            live = int(pad[..., CHANNEL_SLICES[name]].any(dim=(2, 3)).sum())
            total += (3 * bpc * ur + 3 * live) * 2 * UNIT_TILES * k * k
    return total


def kernel_attributes(device) -> dict:
    """K9's registers a thread, shared memory a CTA (static and dynamic)
    and resident CTAs an SM on ``device``'s card."""
    lib = load_kernel()
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = lib.inv_megakernel_attributes(
            ctypes.byref(regs), ctypes.byref(smem), ctypes.byref(ctas))
    if rc != 0:
        raise RuntimeError(lib.inv_megakernel_error_string(rc).decode())
    return {"registers": regs.value, "shared_bytes": smem.value,
            "ctas_per_sm": ctas.value}
