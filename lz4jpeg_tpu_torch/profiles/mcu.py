"""The fused MCU transforms as hand-written kernels.

Port of ``profiles/pallas_mcu.py``, the Pallas candidate that the JAX
package measured against its XLA einsum (``ops/fused.py``) and kept out of
the package.  Two wrappers, each with a plain torch version of the same
function:

* ``fused_forward_candidate``: (N, H, W) uint8 tiles → (N, HW) float32
  quantized zigzag coefficients, ``trunc(snap(x @ M.T - off))`` with ``(M,
  off) = forward_basis(...)`` (``fused_forward_pallas``);
* ``fused_inverse_candidate``: (N, HW) zigzag coefficients → (N, H, W)
  uint8 pixels, ``clamp(c_round(zz @ Minv.T + 128))`` with ``Minv =
  inverse_basis(...)`` (``fused_inverse_pallas``).

HW is 64 (8×8 luma) or 32 (8 rows of 4: a 4:2:2 chroma block).  The plain
versions compute what ``ops/fused.py::fused_forward`` and ``fused_inverse``
compute in float32.  A CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/mcu_transform_kernel.cu`` or raises.  The kernels run the
product on the tensor cores (``mma.sync``) as exact bf16 parts: the three
parts of ``ops/fwd_megakernel.py::split_basis`` of the basis, against the
centred pixels (forward) or the coefficients split in registers into up to
three parts (inverse, ``split_coefficients``), fed by a ring of bulk copies
and stored from a staged block as whole lines (the source's header gives
the design).  Where a value lies within ``TIE_WINDOW`` of a point where the
output steps, the kernel recomputes that output by the fp32 FMA chain in
index order, the order of cuBLAS's product; elsewhere any fp32 order gives
the same output, and ``utils/parity.py::transform_flips`` counts what
differs.  The bases are built in float64 by ``ops/fused.py``, rounded to
float32 and sent to each device once per (table, shape): the fp32 matrices
and the parts' bf16 bits in the kernels' k-slot order (``device_parts``).

The kernels' maps run on the card only; this module mirrors them in numpy
for the CPU tests (``tests/test_torch_mcu_plan.py``): the k slots
(``slot_map``), the operand fragments (``operand_map``, ``operand_loads``,
``basis_loads``), the accumulator → staged block → device memory maps
(``accumulator_map``, ``stage_stores``, ``store_map``), the split and the
vote (``split_coefficients``, ``fragment_votes``, ``products_issued``), the
epilogues and their tie tests (``snap_trunc_fast``, ``pixel_fast``), the
ring (``chunk_plan``, ``chunk_schedule``), and
``emulate``, which composes them into the product.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import _snap_trunc
from lz4jpeg_tpu_torch.ops.fused import (
    _round_clamp,
    _table_key,
    forward_basis,
    inverse_basis,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import split_basis
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

TILE_SHAPES = ((8, 8), (4, 8))  # (width, height): luma, 4:2:2 chroma
KINDS = ("forward", "inverse")
# csrc/mcu_transform_kernel.cu's mcu:: constants and Shape: consumer warps
# a CTA, tiles a ring slot, ring slots and CTAs an SM by direction, the tie
# window, and the staged u8 row of the inverse by HW.
WARPS = 4
CHUNK = 16 * WARPS
STAGES = {"forward": 3, "inverse": 2}
CTAS_PER_SM = {"forward": 3, "inverse": 3}
TIE_WINDOW = 2.0 ** -12
PIXEL_ROW = {64: 80, 32: 48}


def _check_shape(width: int, height: int) -> int:
    if (width, height) not in TILE_SHAPES:
        raise ValueError(
            f"tile {width}x{height} is not one of {TILE_SHAPES} (width, height)"
        )
    return width * height


def _tiles(tiles: torch.Tensor, width: int, height: int) -> torch.Tensor:
    _check_shape(width, height)
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (height, width):
        raise ValueError(
            f"expected (N, {height}, {width}) tiles, got {tuple(tiles.shape)}"
        )
    if tiles.dtype != torch.uint8:
        raise TypeError(f"expected uint8 tiles, got {tiles.dtype}")
    _check_device(tiles)
    return tiles.contiguous()


def _coefficients(zz: torch.Tensor, width: int, height: int) -> torch.Tensor:
    hw = _check_shape(width, height)
    if zz.dim() != 2 or zz.shape[1] != hw:
        raise ValueError(f"expected (N, {hw}) coefficients, got {tuple(zz.shape)}")
    _check_device(zz)
    return zz.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _forward_basis_on(width: int, height: int, table_key: bytes,
                      device: torch.device):
    """``forward_basis`` on ``device`` in float32: (M.T, the plain
    version's operand as ``fused_forward`` builds it; M row-major, the
    kernel's tie pass's; the offset)."""
    m, off = forward_basis(width, height, table_key)
    mt = torch.from_numpy(m.T).to(device=device, dtype=torch.float32)
    offs = torch.from_numpy(off).to(device=device, dtype=torch.float32)
    return mt, mt.T.contiguous(), offs


@functools.lru_cache(maxsize=None)
def _inverse_basis_on(width: int, height: int, table_key: bytes,
                      device: torch.device):
    """``inverse_basis`` on ``device`` in float32: (Minv.T, the plain
    version's operand as ``fused_inverse`` builds it; Minv row-major, the
    kernel's tie pass's).  ``inverse_basis`` is Fortran-ordered in numpy, so
    the kernel's copy must be made contiguous explicitly."""
    minv = inverse_basis(width, height, table_key)
    mt = torch.from_numpy(minv.T).to(device=device, dtype=torch.float32)
    return mt, mt.T.contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_forward_candidate_ref(tiles: torch.Tensor, table: np.ndarray,
                                width: int, height: int,
                                snap_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the forward kernel: ``ops/fused.py::fused_forward``
    in float32 with the snap threshold ``snap_eps``."""
    x = _tiles(tiles, width, height)
    mt, _, off = _forward_basis_on(width, height, _table_key(table), x.device)
    ratio = x.reshape(x.shape[0], -1).to(torch.float32) @ mt - off
    return _snap_trunc(ratio, snap_eps)


def fused_inverse_candidate_ref(zz: torch.Tensor, table: np.ndarray,
                                width: int, height: int) -> torch.Tensor:
    """Plain version of the inverse kernel: ``ops/fused.py::fused_inverse``
    in float32."""
    z = _coefficients(zz, width, height)
    mt, _ = _inverse_basis_on(width, height, _table_key(table), z.device)
    return _round_clamp(z @ mt + 128.0).reshape(z.shape[0], height, width)


# ---------------------------------------------------------------------------
# The kernels' maps, mirrored
# ---------------------------------------------------------------------------


def _kind(kind: str) -> bool:
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    return kind == "forward"


def slot_map(hw: int, kind: str) -> np.ndarray:
    """σ: the k slot of element j of a tile row in the kernels' products,
    ``16 v + 2 c + (e & 1) + 8 (e >> 1)``, where lane c of a row's four
    lanes holds element j = (HW/4)·c + 4 v + e (forward: one vector of
    bytes) or j = 16 v + 4 c + e (inverse: the float4s 4c + 16v)."""
    j = np.arange(hw)
    if _kind(kind):
        c, v, e = j // (hw // 4), (j % (hw // 4)) // 4, j % 4
    else:
        v, c, e = j // 16, (j % 16) // 4, j % 4
    return 16 * v + 2 * c + (e & 1) + 8 * (e >> 1)


@functools.lru_cache(maxsize=None)
def _slot_parts(kind: str, width: int, height: int, table_key: bytes):
    """(3, HW, HW) float32 parts of ``split_basis`` of the basis (M or Minv,
    row n the basis of output n) with column j moved to slot σ(j),
    C-contiguous (``inverse_basis`` is Fortran-ordered)."""
    hw = width * height
    basis = (forward_basis(width, height, table_key)[0] if _kind(kind)
             else inverse_basis(width, height, table_key))
    parts = split_basis(np.asarray(basis, dtype=np.float32))
    out = np.empty(parts.shape, dtype=np.float32)
    out[:, :, slot_map(hw, kind)] = parts
    return out


@functools.lru_cache(maxsize=None)
def device_parts(kind: str, width: int, height: int, table_key: bytes,
                 device: torch.device) -> torch.Tensor:
    """The kernel's basis operand on ``device``: the bf16 bits of
    ``_slot_parts``, (3, HW, HW) int16, built once per (kind, shape, table,
    device)."""
    bits = _slot_parts(kind, width, height, table_key).view(np.uint32) >> 16
    return torch.from_numpy(bits.astype(np.uint16).view(np.int16)).to(device)


def split_coefficients(z: torch.Tensor) -> torch.Tensor:
    """(3, *z.shape) float32 parts hi, mid, lo of float32 ``z``, as the
    inverse kernel splits them in registers: each the round to nearest
    even of the rest to bf16 (``split_basis``'s rounding), hi clamped to
    bf16's largest finite value.  Each part is a bf16 value and their sum
    is ``z`` exactly for every finite z with |z| ≥ 2⁻¹¹⁰ or z = ±0."""
    if z.dtype != torch.float32:
        raise TypeError(f"expected float32, got {z.dtype}")

    def bf16_bits(b):  # round to nearest even, on uint32 bits in int64
        return (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000

    def bits_of(x):
        return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF

    def float_of(b):
        return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(
            torch.float32)

    b = bits_of(z)
    hi = float_of(torch.clamp(bf16_bits(b & 0x7FFFFFFF), max=0x7F7F0000)
                  | (b & 0x80000000))
    rest = z - hi  # exact, as each part below
    mid = float_of(bf16_bits(bits_of(rest)))
    lo = rest - mid
    return torch.stack([hi, mid, lo])


def fragment_votes(block: torch.Tensor) -> Tuple[bool, bool, bool]:
    """The inverse's warp vote on one (16, HW) block of coefficients: for
    hi, mid and lo, whether any value of the part is non-zero (±0 counts as
    zero), i.e. whether the warp issues that part's products."""
    parts = split_coefficients(block.to(torch.float32))
    return tuple(bool((p != 0).any()) for p in parts)


def products_issued(live: Tuple[bool, bool, bool], kind: str = "inverse"
                    ) -> List[Tuple[int, int]]:
    """The (A part, basis part) products a warp issues, in order: part
    indices 0 hi, 1 mid, 2 lo; by level pa + pb from 4 (lo · lo) down to 0
    (hi · hi), lower A parts first within a level; an A part only where
    ``live``.  The forward's A is one exact part: (0, 2), (0, 1), (0, 0)."""
    if _kind(kind):
        return [(0, 2), (0, 1), (0, 0)]
    return [(pa, level - pa) for level in range(4, -1, -1)
            for pa in range(2, -1, -1)
            if 0 <= level - pa <= 2 and live[pa]]


def operand_map(hw: int, kind: str) -> np.ndarray:
    """(32, HW/16, 4, 2, 2) int: for lane, k-step, A register and half, the
    (row of the warp's 16, element j) it holds, as the kernel fills them:
    register 0 row g, 1 row g + 8, 2 row g, 3 row g + 8 (g = lane / 4), the
    low half element e = 0 or 2 (registers 0-1 or 2-3) of the lane's vector
    for the k-step, the high half e + 1."""
    lane = np.arange(32)[:, None, None, None]
    ks = np.arange(hw // 16)[None, :, None, None]
    reg = np.arange(4)[None, None, :, None]
    half = np.arange(2)[None, None, None, :]
    g, c = lane // 4, lane % 4
    row = g + 8 * (reg & 1)
    e = 2 * (reg >> 1) + half
    if _kind(kind):
        j = (hw // 4) * c + 4 * ks + e
    else:
        j = 16 * ks + 4 * c + e
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


def operand_loads(hw: int, kind: str) -> List[Tuple[int, np.ndarray]]:
    """Each shared load of a warp's A operand as (bytes a lane, (32,) byte
    offsets in the slot from the warp's first row): the forward's two
    vectors of HW/4 bytes (rows g and g + 8), the inverse's HW/16 float4s of
    row g, then of g + 8, the u-th at float 16 (u ^ (g & 1)) + 4c."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    if _kind(kind):
        return [(hw // 4, (g + 8 * h) * hw + (hw // 4) * c) for h in range(2)]
    return [(16, ((g + 8 * h) * hw + 16 * (u ^ (g & 1)) + 4 * c) * 4)
            for h in range(2) for u in range(hw // 16)]


def basis_loads(hw: int) -> List[np.ndarray]:
    """The row addresses (bytes from the part's start) the 32 lanes give
    each ldmatrix.x4 of a product, one array per (k-step, n-tile pair):
    lane l names row 16p + (l & 7) + 8 (l >> 4) at k 16ks + 8 ((l >> 3) &
    1) of rows HW + 8 bf16 apart."""
    lane = np.arange(32)
    stride = hw + 8
    return [2 * ((16 * p + (lane & 7) + 8 * (lane >> 4)) * stride
                 + 16 * ks + 8 * ((lane >> 3) & 1))
            for ks in range(hw // 16) for p in range(hw // 16)]


def b_fragment(hw: int, part: np.ndarray, ks: int, p: int) -> np.ndarray:
    """(32, 4, 2) of ``part`` ((HW, HW) in slot order, row n): the four
    registers ldmatrix.x4 gives each lane for (k-step ks, n-tile pair p):
    matrix m = register m is the 8×8 block at the rows the lanes 8m .. 8m
    + 7 address; lane t gets its row t / 4, columns 2 (t % 4) and + 1."""
    lane = np.arange(32)
    rows = (16 * p + (lane & 7) + 8 * (lane >> 4)).reshape(4, 8)
    cols = (16 * ks + 8 * ((lane >> 3) & 1)).reshape(4, 8)[:, 0]
    t = np.arange(32)
    out = np.empty((32, 4, 2))
    for m in range(4):
        for h in range(2):
            out[:, m, h] = part[rows[m][t // 4], cols[m] + 2 * (t % 4) + h]
    return out


def accumulator_map(hw: int) -> np.ndarray:
    """(32, HW/8, 4, 2) int: for lane, n-tile and accumulator register, the
    (row, column) of the warp's (16, HW) block (PTX m16n8 C fragment: row g
    + 8 (i >> 1), column 8 nt + 2c + (i & 1))."""
    lane = np.arange(32)[:, None, None]
    nt = np.arange(hw // 8)[None, :, None]
    i = np.arange(4)[None, None, :]
    row = lane // 4 + 8 * (i >> 1)
    col = 8 * nt + 2 * (lane % 4) + (i & 1)
    row, col = np.broadcast_arrays(row, col)
    return np.stack([row, col], axis=-1)


def stage_row_bytes(hw: int, kind: str) -> int:
    """Bytes a staged row: HW + 8 floats (forward), PIXEL_ROW (inverse)."""
    return 4 * (hw + 8) if _kind(kind) else PIXEL_ROW[hw]


def stage_stores(hw: int, kind: str) -> List[Tuple[int, np.ndarray]]:
    """Each staging store of a warp as (bytes a lane, (32,) byte offsets in
    its buffer): for n-tile nt and half h, accumulators 2h, 2h + 1 as one
    float2 (forward) or two packed bytes (inverse) at row g + 8h, column 8
    nt + 2c."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    row_bytes = stage_row_bytes(hw, kind)
    size = 4 if _kind(kind) else 1
    return [(2 * size, (g + 8 * h) * row_bytes + (8 * nt + 2 * c) * size)
            for nt in range(hw // 8) for h in range(2)]


def store_map(hw: int, kind: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each 16-byte store of a warp's block to device memory as ((32,) rows,
    (32,) vector indices within the row): the forward's float4 f = lane +
    32 i (row f / (HW/4)); the inverse's rows (lane >> 3) + 4 ((lane >> 2)
    & 1) + 8 i, vector lane & 3 (luma) or ((lane >> 3) & 1) + 2 ((lane >>
    1) & 3) + 8 (lane >> 4), vector lane & 1 (chroma)."""
    lane = np.arange(32)
    if _kind(kind):
        f = [lane + 32 * i for i in range(hw // 8)]
        return [(x // (hw // 4), x % (hw // 4)) for x in f]
    if hw == 64:
        return [((lane >> 3) + 4 * ((lane >> 2) & 1) + 8 * i, lane & 3)
                for i in range(2)]
    return [(((lane >> 3) & 1) + 2 * ((lane >> 1) & 3) + 8 * (lane >> 4),
             lane & 1)]


def emulate(kind: str, inputs: torch.Tensor, table: np.ndarray, width: int,
            height: int) -> np.ndarray:
    """The kernel's product composed from the mirrored maps, in float64:
    (N, HW) (x − 128)·M, which is x·M − off in real numbers (forward, from
    (N, H, W) uint8), or z·Minv (inverse, from (N, HW) float32), with the
    float32 bases, before the epilogue.  Per warp block of 16 tiles: each
    lane's A registers filled by ``operand_map`` (centred pixels, or
    ``split_coefficients``' parts), read back as the PTX A fragment
    (``a_fragment_slot``); the basis parts' B registers by ``b_fragment``;
    the products of ``products_issued`` for the parts the block holds (the
    vote) summed per k-step in float64 (which holds each part product
    exactly), placed by ``accumulator_map``, and the block's rows written
    out by ``store_map``."""
    hw = _check_shape(width, height)
    fwd = _kind(kind)
    key = _table_key(table)
    parts = _slot_parts(kind, width, height, key).astype(np.float64)
    x = inputs.reshape(inputs.shape[0], hw)
    n = x.shape[0]
    if fwd:
        vals = (x.numpy().astype(np.float64) - 128.0)[None]
    else:
        vals = split_coefficients(x.to(torch.float32)).numpy().astype(np.float64)
    pad = -n % 16
    vals = np.concatenate([vals, np.zeros((vals.shape[0], pad, hw))], axis=1)
    fill = operand_map(hw, kind)
    frag = a_fragment_slot(hw)
    acc_map = accumulator_map(hw)
    stores = store_map(hw, kind)
    bfrag = {(pb, ks, p): b_fragment(hw, parts[pb], ks, p)
             for pb in range(3) for ks in range(hw // 16)
             for p in range(hw // 16)}
    t = np.arange(32)  # lane
    out = np.zeros((n + pad, hw))
    for b0 in range(0, n + pad, 16):
        block = vals[:, b0:b0 + 16]
        live = ((True,) if fwd else
                tuple(bool((block[p] != 0).any()) for p in range(3)))
        regs = block[:, fill[..., 0], fill[..., 1]]  # (parts, 32, ks, 4, 2)
        acc = np.zeros((32, hw // 8, 4))
        for pa, pb in products_issued(live, kind):
            a = np.zeros((16, hw))  # the A matrix in slot coordinates
            a[frag[..., 0], frag[..., 1]] = regs[pa]
            for ks in range(hw // 16):
                for p in range(hw // 16):
                    bf = bfrag[(pb, ks, p)]
                    for half_nt in range(2):
                        nt = 2 * p + half_nt
                        bmat = np.zeros((16, 8))  # B[k][n] of the n-tile
                        for r in range(2):
                            for h in range(2):
                                bmat[2 * (t % 4) + 8 * r + h, t // 4] = \
                                    bf[:, 2 * half_nt + r, h]
                        c = a[:, 16 * ks:16 * ks + 16] @ bmat  # (16, 8)
                        for i in range(4):
                            acc[:, nt, i] += c[t // 4 + 8 * (i >> 1),
                                               2 * (t % 4) + (i & 1)]
        staged = np.zeros((16, hw))
        staged[acc_map[..., 0], acc_map[..., 1]] = acc
        vec = 4 if fwd else 16  # elements a 16-byte vector
        for rows, q in stores:
            for e in range(vec):
                out[b0 + rows, q * vec + e] = staged[rows, q * vec + e]
    return out[:n]


def _rz32(x: np.ndarray) -> np.ndarray:
    """Float64 values (exact sums of float32 ones) rounded toward zero to
    float32, as ``__fadd_rz``."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


K23 = 2.0 ** 23


def snap_trunc_fast(ratio: np.ndarray, snap_eps: float = 1e-5):
    """The forward kernel's epilogue on float32 ``ratio`` (|ratio| < 2²²),
    step for step: t = |ratio| + snap_eps rounded toward zero, the output
    ±floor(t) from t + 2²³ rounded toward zero; ``near`` where t − floor(t)
    lies within ``TIE_WINDOW`` of an integer, an output step.  Returns
    (output, near)."""
    f32 = np.float32
    r = np.asarray(ratio, dtype=f32)
    t = _rz32(np.abs(r).astype(np.float64) + float(f32(snap_eps)))
    mag = (_rz32(t.astype(np.float64) + K23).astype(np.float64) - K23).astype(f32)
    near = np.abs((t - mag) - f32(0.5)) > f32(0.5) - f32(TIE_WINDOW)
    return np.copysign(mag, r), near


def pixel_fast(acc: np.ndarray):
    """The inverse kernel's epilogue on float32 ``acc``, step for step: v =
    acc + 128.5, ``bits`` the int32 bits of v + 2²³ rounded toward zero,
    the byte clamp(bits, 2²³'s bits, 2²³'s + 255) less 2²³'s (floor(v)
    clamped to [0, 255]); ``near`` where v lies within ``TIE_WINDOW`` of an
    integer (p = acc + 128 of a round-half tie) and the unsigned 32-bit
    difference of ``bits`` and 2²³'s is at most 255 (where the step changes
    the clamped byte): there the tie pass takes the byte.  Returns (bytes
    as uint8, near)."""
    f32 = np.float32
    v = np.asarray(acc, dtype=f32) + f32(128.5)
    k = int(np.float32(K23).view(np.int32))
    with np.errstate(invalid="ignore", over="ignore"):
        shifted = _rz32(v.astype(np.float64) + K23)
        bits = shifted.view(np.int32).astype(np.int64)
        diff = (bits - k) % 2**32  # unsigned
        frac = v - (shifted - f32(K23))
        near = ((np.abs(frac - f32(0.5)) > f32(0.5) - f32(TIE_WINDOW))
                & (diff <= 255))
    return (np.clip(bits, k, k + 255) - k).astype(np.uint8), near


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


class McuPlan(NamedTuple):
    """A launch for ``n`` tiles: ``chunks`` chunks of ``chunk`` tiles over
    ``ctas`` persistent CTAs (``resident`` fit on the card), each with a
    ring of ``stages`` slots, ``threads`` threads (the last warp the
    producer) and ``smem`` bytes of dynamic shared memory."""

    chunks: int
    resident: int
    ctas: int
    chunk: int
    stages: int
    threads: int
    smem: int


def smem_bytes(hw: int, kind: str) -> int:
    """``Shape<HW, Forward>::kSmem``: the basis parts (rows HW + 8 bf16,
    rounded up to 128 bytes), the ring, the warps' staging, the mbarriers."""
    fwd = _kind(kind)
    basis = -(-3 * hw * (hw + 8) * 2 // 128) * 128
    slot = CHUNK * (hw if fwd else 4 * hw)
    staging = WARPS * 16 * stage_row_bytes(hw, kind)
    return basis + STAGES[kind] * slot + staging + 16 * STAGES[kind]


def chunk_plan(n: int, resident: int, kind: str, hw: int = 64) -> McuPlan:
    """``csrc/mcu_transform_kernel.cu::plan_of`` for ``n`` tiles on a card
    where ``resident`` CTAs fit."""
    chunks = -(-n // CHUNK)
    return McuPlan(chunks, resident, min(chunks, resident), CHUNK,
                   STAGES[kind], 32 * WARPS + 32, smem_bytes(hw, kind))


def chunk_schedule(plan: McuPlan) -> List[np.ndarray]:
    """Each CTA's walk, as the kernel's loops make it: one (T, 4) int64
    array a CTA of rows (chunk, slot, producer parity, consumer parity):
    chunk b, b + ctas, ... of CTA b, its i-th in slot i % stages; the
    producer waits on the slot's "empty" barrier with parity ((i // stages)
    & 1) ^ 1, the consumers on "full" with (i // stages) & 1."""
    out = []
    for b in range(plan.ctas):
        chunk = np.arange(b, plan.chunks, plan.ctas, dtype=np.int64)
        i = np.arange(chunk.size, dtype=np.int64)
        rnd = i // plan.stages
        out.append(np.stack([chunk, i % plan.stages, (rnd & 1) ^ 1, rnd & 1],
                            1))
    return out


def chunk_rows(plan: McuPlan, n: int, chunk: int) -> List[Tuple[int, int]]:
    """(first tile, rows) of each consumer warp in ``chunk``: warp w takes
    tiles chunk·CHUNK + 16 w .., min(16, n − that) of them, none where
    that is ≤ 0."""
    out = []
    for w in range(WARPS):
        t0 = chunk * plan.chunk + 16 * w
        out.append((t0, max(0, min(16, n - t0))))
    return out


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/mcu_transform_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("mcu_transform_kernel")
    lib.mcu_forward_launch.restype = ctypes.c_int
    lib.mcu_forward_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.mcu_inverse_launch.restype = ctypes.c_int
    lib.mcu_inverse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mcu_plan.restype = ctypes.c_int
    lib.mcu_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int64)]
    timing.bind_attributes(lib, "mcu_attributes", n_args=2)
    lib.mcu_transform_error_string.restype = ctypes.c_char_p
    lib.mcu_transform_error_string.argtypes = [ctypes.c_int]
    return lib


def launch_plan(kind: str, hw: int, n: int, device="cuda") -> McuPlan:
    """The plan the C code launches for ``n`` tiles of ``kind`` at ``hw``
    on ``device`` (``mcu_plan``)."""
    out = (ctypes.c_int64 * 7)()
    lib = load_kernel()
    with torch.cuda.device(torch.device(device)):
        rc = lib.mcu_plan(int(_kind(kind)), hw, n, out)
    if rc != 0:
        raise RuntimeError(f"mcu_plan failed: "
                           f"{lib.mcu_transform_error_string(rc).decode()} "
                           f"({rc})")
    return McuPlan(*out)


def attributes(kind: str, hw: int, device="cuda"):
    """Registers, shared memory (static + dynamic) and CTAs an SM of the
    (kind, hw) kernel; None on the CPU."""
    return timing.attributes(load_kernel, "mcu_attributes",
                             "mcu_transform_error_string",
                             (int(_kind(kind)), hw), torch.device(device))


def fused_forward_candidate(tiles: torch.Tensor, table: np.ndarray,
                            width: int, height: int,
                            snap_eps: float = 1e-5) -> torch.Tensor:
    """(N, height, width) uint8 tiles → (N, HW) float32 quantized zigzag
    coefficients; (width, height) is (8, 8) or (4, 8).

    A CPU tensor runs ``fused_forward_candidate_ref``.  A CUDA tensor
    launches the forward kernel on the current stream and adds one to
    ``fused_forward_candidate.launches``."""
    x = _tiles(tiles, width, height)
    if x.device.type == "cpu":
        return fused_forward_candidate_ref(x, table, width, height, snap_eps)
    if x.data_ptr() % 16:  # the ring's bulk copies start on 16 bytes
        x = x.clone()
    key = _table_key(table)
    _, m, off = _forward_basis_on(width, height, key, x.device)
    parts = device_parts("forward", width, height, key, x.device)
    n, hw = x.shape[0], width * height
    out = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    if n:
        _launch(load_kernel(), "mcu_forward_launch",
                "mcu_transform_error_string", x.device, x.data_ptr(),
                parts.data_ptr(), m.data_ptr(), off.data_ptr(),
                out.data_ptr(), n, hw, snap_eps)
        fused_forward_candidate.launches += 1
    return out


def fused_inverse_candidate(zz: torch.Tensor, table: np.ndarray,
                            width: int, height: int) -> torch.Tensor:
    """(N, HW) zigzag quantized coefficients (any real dtype, computed in
    float32) → (N, height, width) uint8 pixels.

    A CPU tensor runs ``fused_inverse_candidate_ref``.  A CUDA tensor
    launches the inverse kernel and adds one to
    ``fused_inverse_candidate.launches``."""
    z = _coefficients(zz, width, height)
    if z.device.type == "cpu":
        return fused_inverse_candidate_ref(z, table, width, height)
    if z.data_ptr() % 16:
        z = z.clone()
    key = _table_key(table)
    _, minv = _inverse_basis_on(width, height, key, z.device)
    parts = device_parts("inverse", width, height, key, z.device)
    n = z.shape[0]
    out = torch.empty((n, height, width), dtype=torch.uint8, device=z.device)
    if n:
        _launch(load_kernel(), "mcu_inverse_launch",
                "mcu_transform_error_string", z.device, z.data_ptr(),
                parts.data_ptr(), minv.data_ptr(), out.data_ptr(), n,
                width * height)
        fused_inverse_candidate.launches += 1
    return out


fused_forward_candidate.launches = 0
fused_inverse_candidate.launches = 0


def inverse_products(zz: torch.Tensor) -> int:
    """Part products the inverse's data needs: for each tile, 3 (the basis
    parts) for each coefficient part that is non-zero somewhere in the
    tile.  Times 2·HW² operations, the tensor-core work of the bound."""
    parts = split_coefficients(zz.to(torch.float32).reshape(zz.shape[0], -1))
    return int(3 * (parts != 0).any(dim=2).sum())
