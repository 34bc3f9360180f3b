"""Fused MCU transforms: the per-block JPEG chain as one matmul.

DCT, quantize and zigzag are linear (or a static permutation) up to the
final truncation, so the chain folds into one matrix (JPEG.c:451-494,
:621-629, :693-728):

    M[k, (x,y)] = alpha_u * alpha_v * cos_u[u,x] * cos_v[v,y] / table[u,v]
    with (u,v) = zigzag⁻¹(k)
    out_zz[k]   = trunc( X_flat @ Mᵀ  -  128 * Σ_xy M[k] )

The numpy basis builders are copies of ``lz4jpeg_tpu/ops/fused.py``
(``tests/test_torch_basis.py`` holds them equal); the transforms are torch
ops in float32 (``fused_forward`` and ``fused_inverse`` take another dtype,
as the JAX functions do).  Every matmul here must run in IEEE float32: TF32 keeps
about three decimal digits and would flip quantized coefficients across
truncation boundaries, as bf16 multiplies did on the TPU.  ``JPEGPipeline``
turns TF32 off where it is built.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.color import _snap_trunc
from lz4jpeg_tpu_torch.ops.quantize import zigzag_indices


def _cos_basis(n: int) -> np.ndarray:
    u = np.arange(n, dtype=np.float64)[:, None]
    x = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(np.pi * (2 * x + 1) * u / (2.0 * n))


def _alpha(n: int) -> np.ndarray:
    a = np.full(n, np.sqrt(2.0 / n))
    a[0] = np.sqrt(1.0 / n)
    return a


@functools.lru_cache(maxsize=None)
def forward_basis(width: int, height: int, table_key: bytes):
    """(M, offset): fused DCT+quant+zigzag as (HW, HW) matrix + (HW,) offset.

    ``out_zz = trunc(X_flat @ M.T - offset)`` for X_flat row-major uint8.
    """
    table = np.frombuffer(table_key, dtype=np.int64).astype(np.float64)
    cu, cv = _cos_basis(height), _cos_basis(width)
    au, av = _alpha(height), _alpha(width)
    scale = np.outer(au, av).reshape(-1) / table  # (HW,) over (u,v)
    kron = np.einsum("ux,vy->uvxy", cu, cv).reshape(
        height * width, height * width
    )
    full = scale[:, None] * kron
    zz = zigzag_indices(width, height)
    m = full[zz]  # rows permuted into zigzag order
    offset = 128.0 * m.sum(axis=1)
    return m, offset


@functools.lru_cache(maxsize=None)
def inverse_basis(width: int, height: int, table_key: bytes):
    """(Minv): fused reverse-zigzag+dequant+IDCT as an (HW, HW) matrix.

    ``pixels = clamp(round(Q_zz @ Minv.T + 128))`` for zigzag-ordered
    quantized coefficients.
    """
    table = np.frombuffer(table_key, dtype=np.int64).astype(np.float64)
    cu, cv = _cos_basis(height), _cos_basis(width)
    au, av = _alpha(height), _alpha(width)
    scale = np.outer(au, av).reshape(-1) * table  # dequant folded in
    kron = np.einsum("ux,vy->xyuv", cu, cv).reshape(
        height * width, height * width
    )
    full = kron * scale[None, :]  # [(x,y), (u,v)]
    zz = zigzag_indices(width, height)
    return full[:, zz]  # columns permuted: input arrives in zigzag order


@functools.lru_cache(maxsize=None)
def inverse_suffix_basis(width: int, height: int, table_key: bytes):
    """Suffix-summed inverse basis: folds the sparse16 prefix sum into the
    IDCT.  With ``zz[k] = Σ_{m≤k} Δ[m]``,

        pixels = Σ_k Minv[p, k] · zz[k] = Σ_m Δ[m] · (Σ_{k≥m} Minv[p, k])

    so one matmul runs straight from the deltas; the suffix sums are taken
    here in float64.  Reference inverse chain: JPEG.c:399-448, :811-842.
    """
    minv = inverse_basis(width, height, table_key)
    return np.cumsum(minv[:, ::-1], axis=1)[:, ::-1].copy()


def _table_key(table: np.ndarray) -> bytes:
    return np.ascontiguousarray(table, dtype=np.int64).tobytes()


def fused_forward(
    tiles: torch.Tensor, table: np.ndarray, width: int, height: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """(N, H, W) uint8 tiles → (N, HW) quantized zigzag coefficients in
    ``dtype`` (float32 on the fast path).

    Truncation toward zero with tie snapping: ratios within 1e-5 of an
    integer snap first (``lz4jpeg_tpu/ops/quantize.py``).
    """
    m, off = forward_basis(width, height, _table_key(table))
    n = tiles.shape[0]
    x = tiles.reshape(n, height * width).to(dtype)
    mt = torch.from_numpy(m.T).to(device=x.device, dtype=dtype)
    offs = torch.from_numpy(off).to(device=x.device, dtype=dtype)
    return _snap_trunc(x @ mt - offs, 1e-5)


def fused_forward_plane(
    plane: torch.Tensor, table: np.ndarray, width: int
) -> torch.Tensor:
    """Plane-view fused forward: (..., H, Wp) uint8 channel planes →
    (bh, 8·width, bw) float32 quantized zigzag coefficients in the KT layout
    (block positions along the middle axis), with no 8×8 tile relayout.
    Leading dimensions stack as block rows (bh = frames · H / 8).  Requires
    H % 8 == 0 and Wp % width == 0.  The coefficients equal ``fused_forward``
    of the same tiles up to sum order."""
    m, off = forward_basis(width, 8, _table_key(table))
    h, wp = plane.shape[-2:]
    if h % 8 or wp % width:
        raise ValueError(f"plane {h}x{wp} is not a whole number of 8x{width} blocks")
    bh, bw = plane.numel() // (8 * wp), wp // width
    x = plane.reshape(bh, 8, bw, width).to(torch.float32)
    mt = torch.from_numpy(m.reshape(8 * width, 8, width).astype(np.float32))
    offs = torch.from_numpy(off.astype(np.float32)).to(x.device)
    ratio = torch.einsum("krc,arbc->akb", mt.to(x.device), x)
    return _snap_trunc(ratio - offs[None, :, None], 1e-5)


def _round_clamp(pix: torch.Tensor) -> torch.Tensor:
    """C ``round`` (half away from zero, JPEG.c:443), clamp to [0, 255],
    uint8."""
    rounded = torch.sign(pix) * torch.floor(pix.abs() + 0.5)
    return torch.clamp(rounded, 0, 255).to(torch.uint8)


def fused_inverse(
    zz: torch.Tensor, table: np.ndarray, width: int, height: int,
    dtype=torch.float32,
) -> torch.Tensor:
    """(N, HW) zigzag quantized coefficients → (N, H, W) uint8 pixels: one
    matmul against ``inverse_basis`` in ``dtype``, +128, C round, clamp (the
    staged tile inverse of the fast pair layouts)."""
    minv = inverse_basis(width, height, _table_key(table))
    mt = torch.from_numpy(minv.T).to(device=zz.device, dtype=dtype)
    pix = zz.to(dtype) @ mt + 128.0
    return _round_clamp(pix).reshape(zz.shape[0], height, width)


def fused_inverse_plane(
    zz_kt: torch.Tensor, table: np.ndarray, width: int,
    upsample_cols: bool = False,
) -> torch.Tensor:
    """Plane-view fused inverse: (bh, HW, bw) KT-layout zigzag coefficients
    → (8·bh, width·bw, or 2·width·bw with ``upsample_cols``) uint8 plane,
    with no tile relayout.  ``upsample_cols`` duplicates each basis column,
    so the 4:2:2 horizontal upsample happens inside the product."""
    mi_np = inverse_basis(width, 8, _table_key(table)).T.reshape(-1, 8, width)
    return _plane_product(zz_kt, mi_np, width, upsample_cols)


def _plane_product(
    coef_kt: torch.Tensor, mi_np: np.ndarray, width: int, upsample_cols: bool
) -> torch.Tensor:
    """One ``akb,kuv->aubv`` einsum of KT coefficients against a (HW, 8,
    width) basis, +128, C round, clamp, as an (8·bh, out_w·bw) plane."""
    bh, _, bw = coef_kt.shape
    out_w = width
    if upsample_cols:
        mi_np = np.repeat(mi_np, 2, axis=2)
        out_w = 2 * width
    mi = torch.from_numpy(mi_np.astype(np.float32)).to(coef_kt.device)
    pix = torch.einsum("akb,kuv->aubv", coef_kt.to(torch.float32), mi) + 128.0
    return _round_clamp(pix).reshape(8 * bh, out_w * bw)


def fused_inverse_plane_sparse(
    d_kt: torch.Tensor, table: np.ndarray, width: int,
    upsample_cols: bool = False,
) -> torch.Tensor:
    """Plane-view fused inverse from sparse-delta coefficients:
    (bh, HW, bw) KT-layout integer value-deltas (already un-biased) →
    (8·bh, width·bw, or 2·width·bw with ``upsample_cols``) uint8 plane.

    One ``akb,kuv->aubv`` einsum against ``inverse_suffix_basis``; with
    ``upsample_cols`` each basis column is duplicated, so the 4:2:2
    horizontal upsample happens inside the same product.  The result is
    rounded half away from zero (C ``round``, JPEG.c:443) and clamped.
    Summation order differs from the JAX package's, so about 1e-4 of pixels
    may differ by ±1 at the round-half boundary (the reference's own
    fast-path envelope, ``lz4jpeg_tpu/ops/fused.py``).
    """
    m2 = inverse_suffix_basis(width, 8, _table_key(table))
    return _plane_product(d_kt, m2.T.reshape(-1, 8, width), width, upsample_cols)
