"""Canonical Huffman codebooks of the shared entropy mode.

Port of ``lz4jpeg_tpu/ops/huffman.py``: one canonical codebook per channel,
built from global symbol statistics and serializable in a few bytes per
symbol.  ``CanonicalCodebook``, the codebook builders, ``pack_symbols`` (the
native packer), ``unpack_symbols`` (the native walker, with the Python walk
kept as ``unpack_symbols_spec``) and ``concat_bitstreams`` are copies;
``pack_symbols_device`` packs with torch
ops on the symbols' device.  ``tests/test_torch_container.py`` and
``tests/test_torch_entropy_modes.py`` hold their bytes equal to the JAX
package's.  The per-block parity mode lives in the oracle copy
(``oracle/jpeg_oracle.py``) and its native twin (``native.huff_per_block``).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np
import torch


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


def build_canonical_codebook(symbols: np.ndarray) -> CanonicalCodebook:
    """Optimal code lengths via Huffman (stable heap), then canonical codes,
    from a symbol stream.  A single-symbol alphabet gets a 1-bit code (the
    reference emits an empty code there, JPEG.c:963-975)."""
    values, counts = np.unique(np.asarray(symbols, np.int64), return_counts=True)
    return build_canonical_codebook_from_counts(values, counts)


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


def _check_bit_count(packed: bytes, total_bits: int) -> None:
    # A corrupt container could claim more bits than its buffer holds: checked
    # here so the native walker never reads out of bounds.
    if (total_bits + 7) // 8 > len(packed):
        raise ValueError(
            f"bit count {total_bits} exceeds packed buffer of "
            f"{len(packed)} bytes"
        )


def unpack_symbols(
    packed: bytes, total_bits: int, codebook: CanonicalCodebook
) -> np.ndarray:
    """Canonical decode of ``total_bits`` bits through ``codebook`` by the
    native walker (``native.huff_unpack``), as the JAX package's
    ``unpack_symbols`` runs it: the container's last fallback tier.  Raises
    ``ValueError`` when the bit count exceeds the buffer and
    ``RuntimeError`` when the walker rejects the stream (trailing bits that
    form no codeword)."""
    from lz4jpeg_tpu_torch.native import native_backend

    if total_bits == 0:
        return np.zeros(0, np.int32)
    _check_bit_count(packed, total_bits)
    return native_backend().huff_unpack(packed, total_bits, codebook.lengths,
                                        codebook.symbols)


def unpack_symbols_spec(
    packed: bytes, total_bits: int, codebook: CanonicalCodebook
) -> np.ndarray:
    """The executable spec of ``unpack_symbols``: the table-driven canonical
    decode (first-code arithmetic per length) walked bit by bit in Python.
    Raises ``ValueError`` when the bit count exceeds the buffer or trailing
    bits form no codeword."""
    if total_bits == 0:
        return np.zeros(0, np.int32)
    _check_bit_count(packed, total_bits)
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


def _codebook_rows(symbols: np.ndarray, codebook: CanonicalCodebook) -> np.ndarray:
    """Row of each symbol in the codebook; raises on a symbol outside it."""
    sym_order = np.argsort(codebook.symbols, kind="stable")
    sorted_syms = codebook.symbols[sym_order]
    idx = np.minimum(np.searchsorted(sorted_syms, symbols), len(sorted_syms) - 1)
    rows = sym_order[idx]
    if not np.array_equal(codebook.symbols[rows], symbols):
        raise ValueError("symbol outside codebook")
    return rows


def pack_symbols(
    symbols: np.ndarray, codebook: CanonicalCodebook
) -> Tuple[bytes, int]:
    """Symbols → (MSB-first packed bytes, total bit count): a searchsorted
    gather of each symbol's codeword, then the native bit packer."""
    from lz4jpeg_tpu_torch.native import native_backend

    symbols = np.asarray(symbols, np.int32)
    if len(symbols) == 0:
        return b"", 0
    rows = _codebook_rows(symbols, codebook)
    return native_backend().huff_pack(codebook.codes[rows],
                                      codebook.lengths[rows])


def pack_symbols_device(
    symbols, codebook: CanonicalCodebook, pad_bits: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pack_symbols`` as torch ops on the symbols' device.

    Every output bit finds its source symbol with one ``searchsorted`` over
    the exclusive bit-offset prefix sum and extracts its bit of the
    codeword; the bits fold to bytes.  ``pad_bits`` is the output capacity
    in bits (a multiple of 8).  Returns ``(packed uint8[pad_bits // 8],
    total_bits)``, both on the device; bits past ``total_bits`` are zero,
    as ``np.packbits`` leaves them.

    If ``total_bits > pad_bits`` the buffer holds only a truncated prefix:
    the caller must compare the returned ``total_bits`` with its capacity
    (``unpack_symbols`` of a truncated buffer fails).  Symbols outside the
    codebook are not checked here (the JAX op clamps their gather too)."""
    if pad_bits % 8:
        raise ValueError("pad_bits must be a multiple of 8")
    symbols = torch.as_tensor(symbols, dtype=torch.int32)
    dev = symbols.device
    n = symbols.shape[0]
    if n == 0:
        return (torch.zeros(pad_bits // 8, dtype=torch.uint8, device=dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    sym_order = np.argsort(codebook.symbols, kind="stable")
    sorted_syms = torch.from_numpy(
        codebook.symbols[sym_order].astype(np.int32)).to(dev)
    row_of_sorted = torch.from_numpy(sym_order.astype(np.int64)).to(dev)
    idx = torch.searchsorted(sorted_syms, symbols).clamp(max=len(sym_order) - 1)
    rows = row_of_sorted[idx]
    lengths = torch.from_numpy(codebook.lengths.astype(np.int64)).to(dev)[rows]
    codes = torch.from_numpy(codebook.codes.astype(np.int64)).to(dev)[rows]
    offsets = torch.cumsum(lengths, 0) - lengths  # exclusive prefix
    total_bits = offsets[-1] + lengths[-1]
    j = torch.arange(pad_bits, dtype=torch.int64, device=dev)
    s = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, n - 1)
    shift = (lengths[s] - 1 - (j - offsets[s])).clamp(min=0)
    bits = torch.where(j < total_bits, (codes[s] >> shift) & 1, 0)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    packed = (bits.reshape(-1, 8) * weights).sum(dim=1).to(torch.uint8)
    return packed, total_bits


def concat_bitstreams(pieces):
    """Concatenate MSB-first bitstreams: ``[(packed bytes, nbits), ...]`` →
    ``(packed bytes, total_bits)``.

    Each piece is ``np.packbits``-style (bit 0 = MSB of byte 0, zero padding
    in the final partial byte).  The banded encode joins its per-band
    substreams, which end at arbitrary bit offsets, with it."""
    val = 0
    total = 0
    for data, nbits in pieces:
        if nbits == 0:
            continue
        nbytes = (nbits + 7) // 8
        if nbytes > len(data):
            raise ValueError("bit count exceeds piece buffer")
        piece = int.from_bytes(data[:nbytes], "big") >> (8 * nbytes - nbits)
        val = (val << nbits) | piece
        total += nbits
    if total % 8:
        val <<= 8 - (total % 8)
    return val.to_bytes((total + 7) // 8, "big"), total
