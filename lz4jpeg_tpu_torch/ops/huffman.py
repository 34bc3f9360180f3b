"""Canonical Huffman codebooks of the shared entropy mode.

Copy of ``lz4jpeg_tpu/ops/huffman.py`` (``CanonicalCodebook``,
``_canonical_codes``, ``build_canonical_codebook_from_counts``, the Python
walk of ``unpack_symbols``): one
canonical codebook per channel, built from global symbol statistics and
serializable in a few bytes per symbol.  ``tests/test_torch_container.py``
holds the containers it writes byte-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class CanonicalCodebook:
    """Canonical Huffman codebook over int32 symbols."""

    symbols: np.ndarray   # (S,) int32, sorted by (length, symbol)
    lengths: np.ndarray   # (S,) uint8 code lengths, ascending
    codes: np.ndarray     # (S,) uint32 canonical codewords (MSB-first)

    def serialize(self) -> bytes:
        """(count:u32, then per symbol: symbol:i32 length:u8) — canonical
        codes are reconstructible from lengths alone."""
        out = bytearray()
        out += np.uint32(len(self.symbols)).tobytes()
        out += self.symbols.astype("<i4").tobytes()
        out += self.lengths.astype(np.uint8).tobytes()
        return bytes(out)

    @staticmethod
    def deserialize(data: bytes, offset: int = 0) -> Tuple["CanonicalCodebook", int]:
        count = int(np.frombuffer(data, "<u4", 1, offset)[0])
        offset += 4
        symbols = np.frombuffer(data, "<i4", count, offset).copy()
        offset += 4 * count
        lengths = np.frombuffer(data, np.uint8, count, offset).copy()
        offset += count
        codes = _canonical_codes(lengths)
        return CanonicalCodebook(symbols, lengths, codes), offset


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Assign canonical codewords to length-sorted symbols."""
    codes = np.zeros(len(lengths), np.uint32)
    code = 0
    prev_len = int(lengths[0]) if len(lengths) else 0
    for i, l in enumerate(lengths):
        code <<= int(l) - prev_len
        prev_len = int(l)
        codes[i] = code
        code += 1
    return codes


def build_canonical_codebook_from_counts(
    values: np.ndarray, counts: np.ndarray
) -> CanonicalCodebook:
    """Optimal code lengths via Huffman (stable heap), then canonical codes,
    from a (values ascending and unique, counts positive) frequency table —
    what the native ``rle_symbol_hist_sparse16`` pass produces.  A
    single-symbol alphabet gets a 1-bit code."""
    values = np.asarray(values, np.int64)
    counts = np.asarray(counts)
    if len(values) == 1:
        return CanonicalCodebook(
            values.astype(np.int32),
            np.array([1], np.uint8),
            np.array([0], np.uint32),
        )
    # (count, tiebreak, id): deterministic merge order.
    heap: List[Tuple[int, int, int]] = [
        (int(c), i, i) for i, c in enumerate(counts)
    ]
    heapq.heapify(heap)
    parent = {}
    next_id = len(values)
    while len(heap) > 1:
        c1, _, a = heapq.heappop(heap)
        c2, _, b = heapq.heappop(heap)
        parent[a] = next_id
        parent[b] = next_id
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    depths = np.zeros(len(values), np.uint8)
    for i in range(len(values)):
        d, node = 0, i
        while node in parent:
            node = parent[node]
            d += 1
        depths[i] = d
    order = np.lexsort((values, depths))
    lengths = depths[order]
    if lengths[-1] > 32:
        # Codewords are uint32 end to end (native packer and walker).
        raise ValueError(
            f"Huffman code length {int(lengths[-1])} exceeds the 32-bit "
            "codeword limit"
        )
    return CanonicalCodebook(
        values[order].astype(np.int32), lengths, _canonical_codes(lengths)
    )


def unpack_symbols(
    packed: bytes, total_bits: int, codebook: CanonicalCodebook
) -> np.ndarray:
    """Table-driven canonical decode (first-code arithmetic per length): the
    executable spec and the container's last fallback tier.  Raises
    ``ValueError`` when the bit count exceeds the buffer or trailing bits
    form no codeword."""
    if total_bits == 0:
        return np.zeros(0, np.int32)
    if (total_bits + 7) // 8 > len(packed):
        raise ValueError(
            f"bit count {total_bits} exceeds packed buffer of "
            f"{len(packed)} bytes"
        )
    bits = np.unpackbits(np.frombuffer(packed, np.uint8))[:total_bits]
    lengths = codebook.lengths.astype(np.int64)
    first_code = {}
    first_index = {}
    for l in np.unique(lengths):
        idx = int(np.searchsorted(lengths, l))
        first_code[int(l)] = int(codebook.codes[idx])
        first_index[int(l)] = idx
    count_per_len = {l: int((lengths == l).sum()) for l in first_code}
    out: List[int] = []
    code = 0
    code_len = 0
    symbols = codebook.symbols
    for bit in bits.tolist():
        code = (code << 1) | bit
        code_len += 1
        fc = first_code.get(code_len)
        if fc is not None and fc <= code < fc + count_per_len[code_len]:
            out.append(int(symbols[first_index[code_len] + (code - fc)]))
            code = 0
            code_len = 0
    if code_len != 0:
        raise ValueError("trailing bits do not form a codeword")
    return np.asarray(out, np.int32)
