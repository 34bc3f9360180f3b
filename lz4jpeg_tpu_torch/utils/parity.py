"""Admissible differences between two forward results.

Exact precision (float64): ``assert_quantized_parity`` and
``quantization_tie_mask`` are copies of ``lz4jpeg_tpu/utils/parity.py``.
The C reference's ``(int)(coeff / table)`` (JPEG.c:626-627) is
order-dependent at quantization ties, coefficients that are exact integer
multiples of their table entry; the pipelines snap those ties.  Two results
must be equal everywhere the float64 ratio is not within ``eps`` of an
integer; at ties they may differ by at most 1, and ``ours`` must hold the
snapped value.

Fast precision (float32), the rule between two forward buffers:

Two float32 evaluations of the forward basis product that sum in different
orders (the CUDA kernel's FMA chain, cuBLAS, a CPU BLAS) agree except where
a quantized ratio lies within rounding noise of an integer: there the
truncation may land one step apart.  ``sum_order_flips`` accepts exactly
those differences: a coefficient off by 1 whose float64 ratio, recomputed in
numpy from the same pixels, lies within ``eps`` of an integer.  Anything
else raises.  Callers bound the count (at most 1e-5 of the coefficients).
``combined_of`` brings pair and packed16 encodes to the same buffer, so the
rule covers the int16 pair layout's forward (cuBLAS on a card) too.
"""

from __future__ import annotations

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis
from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
from lz4jpeg_tpu_torch.ops.rle import (
    rle_decode_batched,
    rle_decode_packed16,
    rle_decode_sparse16,
    rle_encode_sparse16,
)


def combined_of(enc) -> np.ndarray:
    """A pair or packed16 ``JPEGEncoded``'s runs as the (N, 128) int16
    sparse-delta buffer ``sum_order_flips`` compares (the deltas of values
    past ±511 still fit int16)."""
    parts = []
    for c, sl in CHANNEL_SLICES.items():
        arr = np.ascontiguousarray(enc.rle[c])
        rle = torch.from_numpy(arr.view(np.int16) if enc.rle_packed16 else arr)
        lengths = torch.from_numpy(np.asarray(enc.rle_lengths[c], np.int32))
        k = sl.stop - sl.start
        if enc.rle_packed16:
            zz = rle_decode_packed16(rle, lengths, k)
        else:
            zz = rle_decode_batched(rle, lengths, k)
        parts.append(rle_encode_sparse16(zz)[0])
    return torch.cat(parts, dim=1).numpy()


def sum_order_flips(
    rgb: np.ndarray,
    got: np.ndarray,
    want: np.ndarray,
    lum_table: np.ndarray,
    chr_table: np.ndarray,
    eps: float = 1e-4,
) -> int:
    """Count admissible coefficient flips between two (N, 128) combined
    buffers of the (B, H, W, 3) uint8 batch ``rgb``; raise AssertionError
    on any other difference."""
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {got.shape} vs {want.shape}")
    (rows,) = np.nonzero((got != want).any(axis=1))
    if rows.size == 0:
        return 0
    y, cr, cb = rgb_to_ycbcr(torch.from_numpy(np.ascontiguousarray(rgb)))
    tiles = split_mcus(y, chroma_subsample_422(cr), chroma_subsample_422(cb))
    flips = 0
    for (name, sl), t, table, width in zip(
        CHANNEL_SLICES.items(), tiles, (lum_table, chr_table, chr_table),
        (8, 4, 4),
    ):
        coef_got = rle_decode_sparse16(torch.from_numpy(got[rows, sl])).numpy()
        coef_want = rle_decode_sparse16(torch.from_numpy(want[rows, sl])).numpy()
        r_idx, k_idx = np.nonzero(coef_got != coef_want)
        if r_idx.size == 0:
            continue
        delta = np.abs(coef_got - coef_want)[r_idx, k_idx]
        m, off = forward_basis(width, 8, _table_key(table))
        x = t.numpy().reshape(t.shape[0], -1)[rows[r_idx]].astype(np.float64)
        ratio = np.einsum("ij,ij->i", x, m[k_idx]) - off[k_idx]
        near = np.abs(ratio - np.round(ratio)) <= eps
        bad = (delta != 1) | ~near
        if bad.any():
            i = int(np.argmax(bad))
            raise AssertionError(
                f"{name}: block {int(rows[r_idx[i]])} coefficient "
                f"{int(k_idx[i])} differs by {int(delta[i])}, float64 ratio "
                f"{float(ratio[i])!r} is not a sum-order flip"
            )
        flips += int(r_idx.size)
    return flips


def quantization_tie_mask(
    coefficients64: np.ndarray, table: np.ndarray, eps: float = 1e-9
) -> np.ndarray:
    """True where coeff / table is within ``eps`` of an integer (from
    float64 coefficients)."""
    ratio = coefficients64 / table.astype(np.float64)
    return np.abs(ratio - np.round(ratio)) <= eps


def assert_quantized_parity(
    ours: np.ndarray,
    oracle_vals: np.ndarray,
    coefficients64: np.ndarray,
    table: np.ndarray,
    eps: float = 1e-9,
) -> int:
    """Raise AssertionError unless ``ours`` equals ``oracle_vals`` up to
    quantization ties; return the number of tie differences."""
    ties = quantization_tie_mask(coefficients64, table, eps)
    mismatch = ours != oracle_vals
    bad = mismatch & ~ties
    if np.any(bad):
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"non-tie quantized mismatch at {idx.tolist()}: "
            f"ours={ours[bad][:5]}, oracle={oracle_vals[bad][:5]}"
        )
    if np.any(mismatch):
        ratio = coefficients64 / table.astype(np.float64)
        snapped = np.round(ratio)
        if not np.all(ours[mismatch] == snapped[mismatch]):
            raise AssertionError("tie mismatch is not the snapped value")
        if np.abs(ours[mismatch] - oracle_vals[mismatch]).max() > 1:
            raise AssertionError("tie mismatch exceeds one quantization step")
    return int(mismatch.sum())
