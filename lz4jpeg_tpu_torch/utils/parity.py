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
The rule itself lives in ``transform_flips``, which ``sum_order_flips``
calls per channel and which the tile transforms of ``profiles/mcu.py`` use
directly: a forward coefficient one step apart where the float64 ratio is
within ``eps`` of an integer, an inverse pixel one step apart where the
float64 pixel value is within the float32 summation error of a round-half
tie.

The sparse16 decode (K9 against its plain version): ``decode_flips``
explains each differing RGB pixel by such one-step flips of the Y, Cr or
Cb plane value it takes, over the suffix basis and the un-biased deltas.
"""

from __future__ import annotations

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
    ycbcr_planes_to_rgb,
)
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, inverse_basis
from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
from lz4jpeg_tpu_torch.ops.inv_megakernel import basis_arrays, table_keys
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
        flips += transform_flips(
            "forward", t[torch.from_numpy(rows)],
            rle_decode_sparse16(torch.from_numpy(got[rows, sl])),
            rle_decode_sparse16(torch.from_numpy(want[rows, sl])),
            table, width, 8, eps, name=name, index=rows,
        )
    return flips


def transform_flips(
    kind: str,
    inputs: torch.Tensor,
    got: torch.Tensor,
    want: torch.Tensor,
    table: np.ndarray,
    width: int,
    height: int,
    eps: float = 1e-4,
    *,
    name: str | None = None,
    index: np.ndarray | None = None,
    basis: np.ndarray | None = None,
    offset: np.ndarray | None = None,
) -> int:
    """Count admissible one-step differences between two results of a tile
    transform; raise AssertionError on any other difference, naming it
    ``name`` (default ``kind``) and its tile by ``index[row]`` (default the
    row).

    ``kind`` "forward": ``inputs`` are the (N, height, width) uint8 tiles and
    ``got``/``want`` (N, HW) quantized coefficients; a difference of 1 is
    admissible where the float64 ratio ``x · M[k] - off[k]`` lies within
    ``eps`` of an integer (``sum_order_flips``' rule).  ``kind`` "inverse":
    ``inputs`` are the (N, HW) coefficients and ``got``/``want`` (N, height,
    width) uint8 pixels; a difference of 1 is admissible where the float64
    pixel value ``v = z · Minv[p] + 128`` lies within
    2⁻²⁴·(2·HW·Σ|z_k·Minv[p,k]| + 2|v|) of a half-integer (the float32 error
    bound of two summation orders and of the + 128).
    ``basis`` and ``offset`` ("forward") replace ``forward_basis``'s
    (HW, HW) basis and (HW,) offset with those the results were computed
    with: the hi bf16 part of a one-pass product
    (``ops/fwd_megakernel.py::split_basis``) with its own centring offset
    128·Σ hi, or a raw product's basis with offset 0
    (``profiles/megakernel.py``).  With an explicit basis a difference of 1
    is admissible also within 2⁻²⁴·2·HW·Σ|x_k·M[k]| of an integer, the
    float32 error bound of two summation orders: raw samples make larger
    sums than centred ones.  ``basis`` ("inverse") replaces
    ``inverse_basis``'s (HW, K) basis: the suffix basis of the sparse16
    decode (``ops/inv_megakernel.py::basis_arrays``), whose ``inputs`` are
    the (N, K) un-biased deltas; the window then counts K terms.
    Only the rows that differ leave the device."""
    if kind not in ("forward", "inverse"):
        raise ValueError(f"kind must be 'forward' or 'inverse', not {kind!r}")
    n = got.shape[0]
    g, w = got.reshape(n, -1), want.reshape(n, -1)
    if g.shape != w.shape:
        raise AssertionError(
            f"shapes differ: {tuple(got.shape)} vs {tuple(want.shape)}")
    rows = torch.nonzero((g != w).any(dim=1)).flatten()
    if rows.numel() == 0:
        return 0
    g = g[rows].cpu().numpy().astype(np.int64)
    w = w[rows].cpu().numpy().astype(np.int64)
    x = inputs.reshape(n, -1)[rows].cpu().numpy().astype(np.float64)
    r_idx, k_idx = np.nonzero(g != w)
    delta = np.abs(g - w)[r_idx, k_idx]
    key = _table_key(table)
    if kind == "forward":
        if basis is None:
            m, off = forward_basis(width, height, key)
        else:
            m = np.asarray(basis, dtype=np.float64)
            off = np.zeros(len(m)) if offset is None else np.asarray(offset)
        value = np.einsum("ij,ij->i", x[r_idx], m[k_idx]) - off[k_idx]
        window = eps
        if basis is not None:
            window = np.maximum(eps, 2.0**-24 * 2 * x.shape[1] * np.abs(
                x[r_idx] * m[k_idx]).sum(axis=1))
        near = np.abs(value - np.round(value)) <= window
    else:
        minv = (inverse_basis(width, height, key) if basis is None
                else np.asarray(basis, dtype=np.float64))
        terms = x[r_idx] * minv[k_idx]
        value = terms.sum(axis=1) + 128.0
        window = 2.0**-24 * (2 * x.shape[1] * np.abs(terms).sum(axis=1)
                             + 2 * np.abs(value))  # the sums, then + 128
        near = np.abs(value - np.floor(value) - 0.5) <= window
    bad = (delta != 1) | ~near
    if bad.any():
        i = int(np.argmax(bad))
        tile = int(rows[r_idx[i]])
        raise AssertionError(
            f"{name or kind}: tile {tile if index is None else int(index[tile])} "
            f"element {int(k_idx[i])} differs by {int(delta[i])}, float64 "
            f"value {float(value[i])!r} is not at a tie: not a sum-order flip"
        )
    return int(r_idx.size)


def merge_rgb(y, cr, cb) -> np.ndarray:
    """(..., 3) uint8 RGB of integer Y, Cr, Cb values in [0, 255] of one
    shape: ``ops/color.py::ycbcr_planes_to_rgb`` on them as (n, 1) planes."""
    planes = [torch.from_numpy(np.asarray(v, dtype=np.uint8).reshape(-1, 1))
              for v in (y, cr, cb)]
    rgb = ycbcr_planes_to_rgb(*planes, planes[0].shape[0], 1)[:, 0].numpy()
    return rgb.reshape(*np.shape(y), 3)


def decode_flips(
    combined, got_rgb, want_rgb, tables, bpc: int, bpr: int,
) -> int:
    """Count the pixels of two sparse16 decodes of ``combined`` ((B, bpc ·
    bpr, 128) int16) that differ, each explained by admissible plane flips;
    raise AssertionError on any other difference.

    A decoded pixel takes its plane values Y (its own), Cr and Cb (the
    sample of its column pair), each sign(x) · floor(|x| + 0.5) clamped to
    [0, 255], x = Σ_m Δ_m·S[p, m] + 128 over the suffix basis ``S`` (the
    float32 values of ``ops/inv_megakernel.py::basis_arrays``, summed in
    float64).  A plane value may round to either neighbour where x lies
    within 2⁻²⁴·(2·K·Σ_m|Δ_m·S[p,m]| + 2|x|) of a half-integer (K = 64 or
    32: two float32 summation orders and the + 128), else only to its own
    round.  A differing pixel is admissible when both results are among
    ``merge_rgb`` of those choices.  ``got_rgb`` and ``want_rgb`` are
    (B, H, W, 3) uint8 arrays or tensors."""
    got = np.asarray(got_rgb.cpu() if isinstance(got_rgb, torch.Tensor)
                     else got_rgb)
    want = np.asarray(want_rgb.cpu() if isinstance(want_rgb, torch.Tensor)
                      else want_rgb)
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {got.shape} vs {want.shape}")
    frame, row, col = np.nonzero((got != want).any(axis=-1))
    if frame.size == 0:
        return 0
    comb = combined.cpu().numpy() if isinstance(combined, torch.Tensor) \
        else np.asarray(combined)
    comb = comb.astype(np.int64).reshape(got.shape[0], bpc * bpr, -1)
    words = comb[frame, (row // 8) * bpr + col // 8]
    delta = np.where(words != 0, words - 1024, 0).astype(np.float64)
    bases = basis_arrays(table_keys(tables))
    u, v = row % 8, col % 8
    choices = []  # per plane: (value rounded down, rounded up) per pixel
    for name, p in (("lum", 8 * u + v), ("r", 4 * u + v // 2),
                    ("b", 4 * u + v // 2)):
        terms = delta[:, CHANNEL_SLICES[name]] * bases[name].astype(
            np.float64)[p]
        x = terms.sum(axis=1) + 128.0
        window = 2.0**-24 * (2 * terms.shape[1] * np.abs(terms).sum(axis=1)
                             + 2 * np.abs(x))
        own = np.clip(np.sign(x) * np.floor(np.abs(x) + 0.5), 0, 255)
        near = np.abs(x - np.floor(x) - 0.5) <= window
        down = np.where(near, np.clip(np.floor(x), 0, 255), own)
        up = np.where(near, np.clip(np.floor(x) + 1, 0, 255), own)
        choices.append((down, up))
    g, w = got[frame, row, col], want[frame, row, col]
    has_got = np.zeros(frame.size, bool)
    has_want = np.zeros(frame.size, bool)
    for pick in range(8):
        y, cr, cb = (choices[i][(pick >> i) & 1] for i in range(3))
        rgb = merge_rgb(y, cr, cb)
        has_got |= (rgb == g).all(axis=1)
        has_want |= (rgb == w).all(axis=1)
    bad = ~(has_got & has_want)
    if bad.any():
        i = int(np.argmax(bad))
        raise AssertionError(
            f"decode: frame {int(frame[i])} pixel ({int(row[i])}, "
            f"{int(col[i])}) is {g[i].tolist()} against {w[i].tolist()}: "
            "no admissible plane flip explains it")
    return int(frame.size)


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
