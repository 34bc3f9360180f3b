"""Sparse-delta run-length layout (sparse16) as torch ops.

Port of ``lz4jpeg_tpu/ops/rle.py::rle_encode_sparse16`` /
``rle_decode_sparse16``.  Slot ``m`` of a block holds the run's value delta
(``x[m] - x[m-1]``, with ``x[-1] := 0``) biased by 1024 at run starts, and
exactly 0 elsewhere.  Decode is an inclusive prefix sum of the deltas, which
is linear, so the decode path folds it into the inverse DCT basis
(``ops/fused.py::inverse_suffix_basis``).  Reference stage: ``RLE``,
JPEG.c:767-809.

The JAX package types the layout uint16; here it is int16 (biased values
lie in [2, 2046], so both read the same numbers) because ``torch.uint16``
supports few operations.  It is viewed as uint16 only at the numpy boundary.
"""

from __future__ import annotations

import torch

SPARSE16_DELTA_BIAS = 1024  # biased value delta; valid slots are nonzero


def rle_encode_sparse16(values: torch.Tensor):
    """(N, L) int blocks → ((N, L) int16 sparse deltas, (N,) int32 symbol
    lengths = 2·runs).  Requires |value| ≤ 511."""
    x = values.to(torch.int32)
    prev = torch.nn.functional.pad(x[:, :-1], (1, 0))
    starts = torch.ones_like(x, dtype=torch.bool)
    starts[:, 1:] = x[:, 1:] != x[:, :-1]
    w = torch.where(starts, x - prev + SPARSE16_DELTA_BIAS, 0)
    return w.to(torch.int16), 2 * starts.sum(dim=1, dtype=torch.int32)


def rle_decode_sparse16(sparse: torch.Tensor) -> torch.Tensor:
    """(N, L) sparse deltas (int16, int32 or uint16-valued) → (N, L) int32
    zigzag values, by one inclusive prefix sum."""
    w = sparse.to(torch.int32)
    d = torch.where(w != 0, w - SPARSE16_DELTA_BIAS, 0)
    return torch.cumsum(d, dim=-1, dtype=torch.int32)
