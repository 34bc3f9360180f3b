"""Fast-mode LZ4 match finding as plain torch: the sort matcher.

Port of ``lz4jpeg_tpu/ops/lz4_fast.py`` (``matcher="sort"``), the portable
formulation the fused matcher (``ops/fused_match.py``) is held against:

1. **Candidates by sort.**  ``w32[i]`` packs the 4-byte window at ``i``;
   one sort keyed by ``(hash16(w32) << pos_bits) | i`` makes each
   position's candidate its sorted predecessor (the most recent previous
   position in the same bucket); the two-back neighbor is a second chain
   entry.  Keys are unique, so ``torch.sort`` plus a gather of the payload
   words by its indices gives ``lax.sort``'s multi-operand result exactly.
2. **Match lengths** from the carried suffix words (``lcp_words`` packed
   words, cap ``4·lcp_words`` bytes; emission extends past the cap).
3. **Un-sort** by a scatter to the sorted positions (the JAX package pays a
   second sort; the result is the same permutation).
4. **Greedy parse, segment-anchored**: matches never cross a ``seg``-byte
   boundary, so segments parse independently: ``ops/lz4_parse.py::
   greedy_parse``, K10's field entry on a CUDA tensor (its plain version,
   ``seg`` lockstep steps of torch ops, on the CPU).

Integer note: torch has no uint32 arithmetic, so words live in int64 and
the hash's low 32 bits come from 16-bit halves (no signed overflow).
"""

from __future__ import annotations

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.lz4_parse import greedy_parse

TPU_BLOCK_LOG = 14  # 16 KiB blocks: dist fits the 64 KiB window trivially
HASH_MULT = 2654435761
LCP_WORDS = 4  # carried suffix words → in-parse match cap 4*LCP_WORDS bytes
SEG = 512  # parse segment: matches never cross a segment boundary
INVALID_BUCKET = 0x10000  # first bucket of windows that may not chain


def pad_blocks_fast(data: bytes, block_log: int = TPU_BLOCK_LOG):
    """Split into (B, 2**block_log) uint8-valued int32 blocks + lengths."""
    p = 1 << block_log
    n = len(data)
    num = max(1, -(-n // p))
    padded = np.zeros(num * p, np.int32)
    padded[:n] = np.frombuffer(data, np.uint8)
    lengths = np.clip(n - p * np.arange(num), 0, p).astype(np.int32)
    return padded.reshape(num, p), lengths


def hash16(w32: torch.Tensor) -> torch.Tensor:
    """``((w32 · 2654435761) mod 2**32) >> 16`` for int64 tensors holding
    uint32 values, computed from 16-bit halves so no product exceeds 2**49."""
    lo = w32 & 0xFFFF
    hi = w32 >> 16
    low32 = (lo * HASH_MULT + (((hi * HASH_MULT) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return low32 >> 16


def _leading_equal_bytes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element count (0-4) of leading equal bytes of two uint32 words
    (little-endian byte order: byte 0 is the low byte)."""
    x = a ^ b
    return (
        ((x & 0x000000FF) == 0).to(torch.int32)
        + ((x & 0x0000FFFF) == 0).to(torch.int32)
        + ((x & 0x00FFFFFF) == 0).to(torch.int32)
        + (x == 0).to(torch.int32)
    )


def _shift_back(x: torch.Tensor, shift: int, fill) -> torch.Tensor:
    """Row-wise ``x[:, s - shift]``, with ``fill`` for the first slots."""
    head = torch.full((x.shape[0], shift), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:, :-shift]], dim=1)


def _lcp_from_payloads(pay, shift: int) -> torch.Tensor:
    """LCP (in bytes, ≤ 4·len(pay)) between sorted row ``s`` and row
    ``s-shift``, from the carried suffix words."""
    lcp = torch.zeros(pay[0].shape, dtype=torch.int32, device=pay[0].device)
    alive = torch.ones(pay[0].shape, dtype=torch.bool, device=pay[0].device)
    for w in pay:
        eq_bytes = _leading_equal_bytes(w, _shift_back(w, shift, 0))
        lcp = lcp + torch.where(alive, eq_bytes, 0)
        alive = alive & (eq_bytes == 4)
    return lcp


def _pack32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, P) int64 word of the bytes ``k..k+3`` ahead of each position
    (0 past the row end)."""
    p = x.shape[1]
    out = torch.zeros_like(x)
    for j in range(4):
        if k + j < p:
            out[:, : p - k - j] |= x[:, k + j :] << (8 * j)
    return out


def fast_match_blocks(
    blocks: torch.Tensor,
    lengths: torch.Tensor,
    max_dist: int = 65535,
    lcp_words: int = LCP_WORDS,
    seg: int = SEG,
):
    """(B, P) blocks (uint8 or int32 byte values) + (B,) lengths → greedy
    parse fields ``(is_match, emit_len, emit_dist)``, (B, P) int32.

    ``lcp_words`` sets the carried-suffix width (in-parse cap
    ``4·lcp_words`` bytes); ``seg`` (a power of two dividing P) the parse
    segment length."""
    b, p = blocks.shape
    dev = blocks.device
    idx = torch.arange(p, dtype=torch.int64, device=dev)
    x = blocks.to(torch.int64)
    lengths = lengths.to(device=dev, dtype=torch.int64)

    w32 = _pack32(x, 0)
    window_ok = idx[None, :] + 4 <= lengths[:, None]
    # Invalid windows get a per-position unique bucket so they never chain.
    h = torch.where(window_ok, hash16(w32), INVALID_BUCKET + idx[None, :])
    pos_bits = (p - 1).bit_length()
    key = (h << pos_bits) | idx[None, :]
    payload_words = [w32] + [_pack32(x, 4 * k) for k in range(1, lcp_words)]
    key_s, order = torch.sort(key, dim=1)
    pay_s = [torch.gather(w, 1, order) for w in payload_words]
    h_s = key_s >> pos_bits
    pos_s = key_s & (p - 1)

    def candidate(shift: int):
        """Match fields against the ``shift``-back sorted neighbor."""
        same = (h_s == _shift_back(h_s, shift, -1)) & (h_s < INVALID_BUCKET)
        dist = pos_s - _shift_back(pos_s, shift, -1)
        # lcp >= 4 is the exact first-window verification (the first word
        # must byte-equal the neighbor's): hash false positives drop out.
        lcp = _lcp_from_payloads(pay_s, shift)
        ok = same & (dist <= max_dist) & (lcp >= 4)
        return torch.where(ok, lcp, 0), torch.where(ok, dist, 0)

    len1, dist1 = candidate(1)
    len2, dist2 = candidate(2)
    better2 = len2 > len1  # prefer the longer; ties keep the nearer (1-back)
    cand_len = torch.where(better2, len2, len1).to(torch.int64)
    cand_dist = torch.where(better2, dist2, dist1)

    # Un-sort: scatter (len << pos_bits) | dist back to each position.
    lendist = torch.empty_like(key).scatter_(
        1, pos_s, (cand_len << pos_bits) | cand_dist
    )
    match_len = lendist >> pos_bits
    match_dist = lendist & (p - 1)

    # Caps: block's true end, and the parse segment boundary (so segments
    # parse independently).  Re-check the 4-byte minimum afterwards.
    seg_left = seg - (idx[None, :] & (seg - 1))
    limit = torch.minimum(lengths[:, None] - idx[None, :], seg_left)
    match_len = torch.minimum(match_len, limit.clamp(min=0))
    match_len = torch.where(match_len >= 4, match_len, 0)
    match_dist = torch.where(match_len > 0, match_dist, 0)
    return greedy_parse(match_len, match_dist, seg)


def compact_parse(is_match, emit_len, emit_dist):
    """Parse fields → sparse per-block match records, on the device.

    One stable sort moves each block's matches to the front in position
    order — ``(positions, len << pos_bits | dist, counts)`` — so the host
    fetches only ``max(counts)`` records per block.  Non-match slots carry
    key P and payload 0, so the order among them does not matter."""
    b, p = is_match.shape
    pos_bits = (p - 1).bit_length()
    idx = torch.arange(p, dtype=torch.int32, device=is_match.device)[None, :]
    key = torch.where(is_match > 0, idx, p)
    payload = (emit_len << pos_bits) | emit_dist
    pos_sorted, order = torch.sort(key, dim=1, stable=True)
    packed = torch.gather(payload, 1, order)
    counts = (is_match > 0).sum(dim=1, dtype=torch.int32)
    return pos_sorted, packed, counts
