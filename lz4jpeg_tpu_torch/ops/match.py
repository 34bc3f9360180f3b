"""LZ4 parity-mode match finding as batched torch ops.

Port of ``lz4jpeg_tpu/ops/match.py``.  The reference's hot loop is a
brute-force O(n²·L) scan per position (``find_longest_match``,
LZ4.c:290-323).  Here the *entire* match-length table of a block is
computed at once, for all blocks of a batch, on the tensors' device:

1. ``EQ[d, k] = x[k] == x[k-d]`` — a (P, P) byte-compare matrix per block
   (one gather of a shift matrix);
2. run lengths ``R[d, k]`` = length of the leading-ones run of ``EQ[d]``
   starting at ``k``, via a *reversed cumulative min* over next-zero
   positions;
3. per-position best match = max over ``d`` with ties broken toward the
   **largest** ``d`` (the reference scans candidates oldest→newest with a
   strict ``>``, so the earliest position / largest offset wins,
   LZ4.c:307-311): ``flip`` the ``d`` axis, then ``argmax``, whose first
   maximum is the largest ``d``, as ``jnp.argmax``'s is.

The (B, P, P) tables stay int32 and bool as in JAX, so ``batch_blocks``
bounds memory as it does there (B·P²·4 bytes per table).  The greedy parse
that follows is a sequential dependency: a loop over the P positions whose
only state is ``skip_until`` per block, each step a few ops over B blocks
(``lax.scan`` in JAX).

Padding: blocks are right-padded with *distinct negative* sentinels so
padding never matches anything (including itself), which caps every run at
the true block end — reproducing the oracle's block-end semantics.
"""

from __future__ import annotations

import numpy as np
import torch

MIN_MATCH_LENGTH = 4


def pad_blocks(data: bytes, block_length: int) -> tuple[np.ndarray, np.ndarray]:
    """Split ``data`` into (B, P) int32 blocks padded with distinct
    negatives, plus the (B,) true lengths."""
    n = len(data)
    num_blocks = -(-n // block_length)
    arr = np.frombuffer(data, np.uint8).astype(np.int32)
    padded = np.empty((num_blocks, block_length), np.int32)
    sentinel = -(np.arange(block_length, dtype=np.int32) + 1)
    lengths = np.empty(num_blocks, np.int32)
    for i in range(num_blocks):
        chunk = arr[i * block_length : (i + 1) * block_length]
        lengths[i] = len(chunk)
        padded[i, : len(chunk)] = chunk
        padded[i, len(chunk) :] = sentinel[len(chunk) :]
    return padded, lengths


def match_tables(blocks: torch.Tensor, max_match: int = 1024):
    """(B, P) int32 blocks → per-position best matches.

    Returns ``(best_len, best_dist)``, both (B, P) int32: the reference's
    *untruncated* greedy best match length (0 where < MIN_MATCH) and its
    distance.  ``greedy_parse`` applies the uint8 truncation.
    """
    if blocks.dtype != torch.int32 or blocks.dim() != 2:
        raise TypeError(f"blocks must be (B, P) int32, not {blocks.dtype} "
                        f"{tuple(blocks.shape)}")
    _, p = blocks.shape
    k = torch.arange(p, dtype=torch.int32, device=blocks.device)
    d = k
    # shifted[n, d, k] = blocks[n, k - d]  (clamped; d=0 row unused)
    idx = (k[None, :] - d[:, None]).clamp_(min=0)
    shifted = blocks[:, idx.long()]  # (B, P, P) int32
    eq = (shifted == blocks[:, None, :]) & (k[None, :] >= d[:, None])
    del shifted
    # Next zero position at or after k, per (n, d) row: reversed cummin of
    # (k where ~eq else P).
    zpos = torch.where(eq, torch.tensor(p, dtype=torch.int32,
                                        device=blocks.device), k)
    del eq
    next_zero = torch.cummin(zpos.flip(-1), dim=-1).values.flip(-1)
    del zpos
    run = (next_zero - k).clamp_(max=max_match)  # R[d, k], 0 where ~eq[k]
    del next_zero
    # Valid candidates: 1 <= d <= k (candidate j = k - d >= 0).
    valid = (d[:, None] >= 1) & (d[:, None] <= k[None, :])
    run = torch.where(valid, run, torch.tensor(-1, dtype=torch.int32,
                                               device=blocks.device))
    # Tie-break toward the largest d: argmax over the reversed d axis keeps
    # the first (= largest-d) maximum.
    arg_rev = run.flip(1).argmax(dim=1)
    best_len = run.amax(dim=1)
    best_dist = (p - 1 - arg_rev).int()
    found = best_len >= MIN_MATCH_LENGTH
    zero = torch.zeros((), dtype=torch.int32, device=blocks.device)
    return torch.where(found, best_len, zero), torch.where(found, best_dist, zero)


def greedy_parse(best_len: torch.Tensor, best_dist: torch.Tensor):
    """Greedy left-to-right parse (``block_encode``'s while loop,
    LZ4.c:516-583), one step per position over all blocks at once.

    A position starts a match iff it is not consumed by a previous match
    and its (uint8-truncated) best length is ≥ 1; otherwise it is a literal
    — except that a *zero* truncated length (true length ≡ 0 mod 256)
    degrades to a literal exactly like the reference, where
    ``find_longest_match`` returns 0 and the encoder emits a literal.

    Returns ``(is_match_start, emit_len, emit_dist)``: (B, P) bool, int32,
    int32 (the JAX parse's dtypes), where ``emit_len`` is the truncated
    length the parse advances by.
    """
    len_u8 = best_len & 0xFF
    b, p = len_u8.shape
    starts = len_u8 > 0
    ends = torch.arange(p, dtype=torch.int32, device=len_u8.device) + len_u8
    skip_until = torch.zeros(b, dtype=torch.int32, device=len_u8.device)
    is_match = torch.empty((b, p), dtype=torch.bool, device=len_u8.device)
    for k in range(p):
        take = starts[:, k] & (skip_until <= k)
        is_match[:, k] = take
        skip_until = torch.where(take, ends[:, k], skip_until)
    zero = torch.zeros((), dtype=torch.int32, device=len_u8.device)
    return (is_match, torch.where(is_match, len_u8, zero),
            torch.where(is_match, best_dist, zero))
