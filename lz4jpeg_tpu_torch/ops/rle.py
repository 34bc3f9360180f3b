"""Run-length layouts as torch ops.

Port of ``lz4jpeg_tpu/ops/rle.py``.  Reference stage: ``RLE``,
JPEG.c:767-809, and its inverse, JPEG.c:811-842.  Three layouts of one
block's runs:

* pairs: (N, 2L) interleaved [count, value] ints, front-compacted and
  zero-padded, with (N,) lengths counting symbols (2·runs);
* packed16: one word per pair, ``(count - 1) << 10 | (value + 512)``, same
  lengths (``ops/pack16.py`` holds its kernels and the shared run cores);
* sparse16: slot ``m`` holds the run's value delta (``x[m] - x[m-1]``, with
  ``x[-1] := 0``) biased by 1024 at run starts, and exactly 0 elsewhere.
  Decode is an inclusive prefix sum, so the fast decode path folds it into
  the inverse DCT basis (``ops/fused.py::inverse_suffix_basis``).

The JAX package types the 16-bit layouts uint16; here they are int16 (the
same bits) because ``torch.uint16`` supports few operations.  They are
viewed as uint16 only at the numpy boundary.

On a CUDA tensor ``rle_encode_packed16`` launches K4 and
``rle_decode_packed16`` K6; on a CPU tensor both run the kernels' plain
versions, which take any shape.  The pair decoders run in (N, K) memory
where the JAX spec contracts an (N, out_size, K) membership tensor.
"""

from __future__ import annotations

import torch

from lz4jpeg_tpu_torch.ops.pack16 import (
    PACK16_VALUE_BIAS,
    _rle_runs,
    expand_runs,
    pack16_decode,
    pack16_decode_ref,
    pack16_encode,
    pack16_encode_ref,
    pack_words,
    unpack16_pairs,
)

SPARSE16_DELTA_BIAS = 1024  # biased value delta; valid slots are nonzero


def rle_encode_batched(values: torch.Tensor):
    """(N, L) int blocks → ((N, 2L) int32 padded [count, value] pairs, (N,)
    int32 symbol lengths = 2·runs)."""
    counts, run_values, num_runs = _rle_runs(values)
    n, length = counts.shape
    pairs = torch.stack([counts, run_values], dim=2).reshape(n, 2 * length)
    return pairs, 2 * num_runs


def rle_encode_packed16(values: torch.Tensor):
    """``rle_encode_batched`` with each pair packed into one word: ((N, L)
    int16 packed words, (N,) int32 lengths).  Valid for |value| ≤ 511.
    A CUDA tensor launches K4 (L a power of two ≤ 64)."""
    if values.device.type == "cuda":
        return pack16_encode(values)
    return pack16_encode_ref(values)


def pack16_pairs(pairs: torch.Tensor) -> torch.Tensor:
    """(N, 2L) interleaved [count, value] pairs → (N, L) int16 packed words
    (padding slots, count 0, stay 0)."""
    p = pairs.to(torch.int32)
    return pack_words(p[:, 0::2], p[:, 1::2])


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


def sparse16_to_packed16(sparse: torch.Tensor):
    """Sparse-delta layout → (packed16 words, lengths); exact on canonical
    streams (maximal runs, everything the encoders emit).  On a CUDA tensor
    the compaction is K4."""
    return rle_encode_packed16(rle_decode_sparse16(sparse))


def packed16_to_sparse16(packed: torch.Tensor, lengths: torch.Tensor):
    """Packed16 words + lengths → (sparse-delta words, lengths)."""
    k = packed.shape[-1]
    return rle_encode_sparse16(rle_decode_packed16(packed, lengths, k))


def rle_decode_packed16(
    packed: torch.Tensor, lengths: torch.Tensor, out_size: int
) -> torch.Tensor:
    """``rle_decode_batched`` over packed16 words → (N, out_size) int32.
    A CUDA tensor launches K6 (K a power of two ≤ 64, out_size ≤ 64)."""
    if packed.device.type == "cuda":
        return pack16_decode(packed, lengths, out_size)
    return pack16_decode_ref(packed, lengths, out_size)


def rle_decode_batched(
    pairs: torch.Tensor, lengths: torch.Tensor, out_size: int
) -> torch.Tensor:
    """((N, 2K) pairs, (N,) lengths) → (N, out_size) int32, cut at
    ``out_size`` and zero-padded, matching ``inverse_RLE``."""
    p = pairs.to(torch.int32)
    return expand_runs(p[:, 0::2], p[:, 1::2], lengths, out_size)


__all__ = [
    "PACK16_VALUE_BIAS", "SPARSE16_DELTA_BIAS", "pack16_pairs",
    "packed16_to_sparse16", "rle_decode_batched", "rle_decode_packed16",
    "rle_decode_sparse16", "rle_encode_batched", "rle_encode_packed16",
    "rle_encode_sparse16", "sparse16_to_packed16", "unpack16_pairs",
]
