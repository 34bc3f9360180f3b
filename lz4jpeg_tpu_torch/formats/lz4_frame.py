"""LZ4 container format: frame/block/sequence pack & unpack.

A copy of ``lz4jpeg_tpu/formats/lz4_frame.py`` (``describe_frame`` reads
LZ4T frames through the port's ``formats/fast_frame.py``;
``tests/test_torch_lz4_parity.py`` holds every output equal to the
original's).  This is the framework's L1 serialization layer (SURVEY.md
§2.1).  The wire
format is byte-identical to the reference encoder's output
(``write_output``/``write_block``/``write_sequence``,
``Algorithms/sequential/LZ4/LZ4.c:365-441``):

    Frame    := block_count:u8
    Block    := seq_count:u8  block_byte_size:u16le  Sequence*
    Sequence := token:u8  seq_byte_size:u16le
                [litlen_ext:u8  if litcount>=15]
                literals:u8[litcount]
                match_offset:u16le
                [matchlen_ext:u8  if (matchlen-4)&0xFF >= 15]

Unlike the reference *decoder*, which reads length fields through signed
``char`` (LZ4.c:763-773, :863) and therefore invokes undefined behavior on
streams its own encoder can produce, this unpacker reads every field
unsigned — it agrees with the reference decoder on every stream the
reference handles correctly, and additionally round-trips all encoder
output.  The C-faithful (bug-compatible) decoder lives in
``oracle/lz4_oracle.py``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List


class FormatError(ValueError):
    pass


@dataclasses.dataclass
class Sequence:
    literals: bytes
    match_offset: int  # 0 = literals-only tail sequence
    match_length: int  # true length (>= 4), or 0 for literals-only

    @property
    def token(self) -> int:
        lit = len(self.literals)
        token_lit = 15 if lit >= 15 else lit
        if self.match_length == 0:
            return (token_lit << 4) & 0xFF
        ml = self.match_length & 0xFF
        token_ml = 15 if ml >= 19 else (ml - 4) & 0xFF
        return ((token_lit << 4) | token_ml) & 0xFF

    @property
    def byte_size(self) -> int:
        lit = len(self.literals)
        size = lit + 5
        if lit >= 15:
            size += _ext_len((lit - 15) & 0xFF)
        if self.match_length != 0:
            adjusted = (self.match_length - 4) & 0xFF
            if adjusted >= 15:
                size += _ext_len((adjusted - 15) & 0xFF)
        return size


@dataclasses.dataclass
class Block:
    sequences: List[Sequence]

    @property
    def byte_size(self) -> int:
        return sum(s.byte_size for s in self.sequences) + 3


def _ext_len(value: int) -> int:
    n = 0
    while value >= 255:
        n += 1
        value -= 255
    return n + 1


def _write_ext(out: bytearray, value: int) -> None:
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)


def pack_sequence(seq: Sequence, out: bytearray) -> None:
    lit = len(seq.literals)
    if lit > 270:
        # The reference stores literal counts in uint8 struct fields and
        # truncates the extension byte arithmetic (&0xFF, LZ4.c:371-386), so
        # runs above 270 produce a stream its own decoder desyncs on (the
        # ext encoding reaches at most 15+255).  Refuse to emit a corrupt
        # stream; the fast-mode frame has widened headers for this.
        raise FormatError(
            f"literal run of {lit} exceeds the parity format's 270-byte limit"
        )
    out.append(seq.token)
    out += struct.pack("<H", seq.byte_size & 0xFFFF)
    if lit >= 15:
        _write_ext(out, (lit - 15) & 0xFF)
    out += seq.literals
    out += struct.pack("<H", seq.match_offset & 0xFFFF)
    if seq.match_length >= 4:
        adjusted = (seq.match_length - 4) & 0xFF
        if adjusted >= 15:
            _write_ext(out, (adjusted - 15) & 0xFF)


def pack_frame(blocks: List[Block]) -> bytes:
    out = bytearray()
    out.append(len(blocks) & 0xFF)
    for block in blocks:
        out.append(len(block.sequences) & 0xFF)
        out += struct.pack("<H", block.byte_size & 0xFFFF)
        for seq in block.sequences:
            pack_sequence(seq, out)
    return bytes(out)


def unpack_sequence(data: bytes, start: int) -> tuple[Sequence, int]:
    """Parse one sequence starting at ``start``; returns (seq, next_offset)."""
    n = len(data)

    def need(pos, k):
        if pos + k > n:
            raise FormatError("truncated sequence")

    need(start, 3)
    token = data[start]
    byte_size = data[start + 1] | (data[start + 2] << 8)
    p = start + 3
    lit_count = (token & 0xF0) >> 4
    match_bits = token & 0x0F
    if lit_count >= 15:
        # The encoder emits (count-15) & 0xFF as one or two bytes: 255 only
        # when the wrapped remainder is exactly 255 (LZ4.c:371-386).
        need(p, 1)
        while data[p] == 255:
            lit_count += 255
            p += 1
            need(p, 1)
        lit_count += data[p]
        p += 1
    literals = data[p : p + lit_count]
    if len(literals) != lit_count:
        raise FormatError("truncated literals")
    p += lit_count
    need(p, 2)
    offset = data[p] | (data[p + 1] << 8)
    p += 2
    match_length = match_bits
    if offset != 0:
        if match_bits >= 15:
            need(p, 1)
            while data[p] == 255:
                match_length += 255
                p += 1
                need(p, 1)
            match_length += data[p]
            p += 1
        match_length += 4
    else:
        match_length = 0
    expected_end = start + byte_size
    if p != expected_end:
        raise FormatError(
            f"sequence size mismatch: parsed to {p}, header says {expected_end}"
        )
    return Sequence(literals, offset, match_length), p


def unpack_frame(data: bytes) -> List[Block]:
    if not data:
        raise FormatError("empty frame")
    block_count = data[0]
    p = 1
    blocks: List[Block] = []
    for i in range(block_count):
        if p + 3 > len(data):
            raise FormatError(f"truncated block header at block {i}")
        seq_count = data[p]
        block_size = data[p + 1] | (data[p + 2] << 8)
        end = p + block_size
        if end > len(data):
            raise FormatError(f"block {i} overruns the frame")
        q = p + 3
        seqs: List[Sequence] = []
        for _ in range(seq_count):
            seq, q = unpack_sequence(data, q)
            seqs.append(seq)
        if q != end:
            raise FormatError(f"block {i} size mismatch")
        blocks.append(Block(seqs))
        p = end
    if p != len(data):
        raise FormatError("trailing bytes after frame")
    return blocks


def apply_sequences(blocks: List[Block]) -> bytes:
    """LZ77 reconstruction: literals then overlapping match copy-back against
    the global output buffer (``interpret_sequence``, LZ4.c:937-982)."""
    out = bytearray()
    for block in blocks:
        for seq in block.sequences:
            out += seq.literals
            if seq.match_offset != 0:
                if seq.match_offset > len(out):
                    # The reference reads out of bounds here (interpret_
                    # sequence trusts the offset); our decoder types it.
                    raise FormatError(
                        f"match offset {seq.match_offset} before stream start"
                    )
                for _ in range(seq.match_length):
                    out.append(out[len(out) - seq.match_offset])
    return bytes(out)


def decode_frame_bytes(data: bytes) -> bytes:
    """One-shot frame decode: unpack + LZ77 reconstruction."""
    return apply_sequences(unpack_frame(data))


def describe_frame(data: bytes) -> str:
    """Human-readable frame structure — the framework's version of the
    reference's ``print_{sequence,block,frame}_details`` log printers
    (LZ4.c:220-287), driven from the wire bytes instead of in-memory
    structs."""
    from lz4jpeg_tpu_torch.formats import fast_frame

    if fast_frame.is_fast_frame(data):
        return _describe_fast_frame(data)
    blocks = unpack_frame(data)
    lines = [f"parity frame: {len(blocks)} block(s), {len(data)} bytes"]
    for bi, block in enumerate(blocks):
        lines.append(
            f"  block {bi}: {len(block.sequences)} sequence(s), "
            f"{block.byte_size} bytes"
        )
        for si, seq in enumerate(block.sequences):
            kind = (
                "literals-only"
                if seq.match_offset == 0
                else f"match len={seq.match_length} offset={seq.match_offset}"
            )
            lines.append(
                f"    seq {si}: token=0x{seq.token:02X} "
                f"size={seq.byte_size} literals={len(seq.literals)} {kind}"
            )
    return "\n".join(lines)


def _describe_fast_frame(data: bytes) -> str:
    import struct

    from lz4jpeg_tpu_torch.formats.fast_frame import RAW_FLAG

    _magic, version, block_log, _res, raw_size, block_count = (
        struct.unpack_from("<IBBHQI", data, 0)
    )
    sizes = struct.unpack_from(f"<{block_count}I", data, 20)
    lines = [
        f"LZ4T frame v{version}: {raw_size} raw bytes, "
        f"{block_count} x {1 << block_log} B block(s), "
        f"{len(data)} compressed bytes "
        f"(ratio {len(data) / raw_size:.3f})" if raw_size else
        f"LZ4T frame v{version}: empty",
    ]
    for i, rec in enumerate(sizes):
        if rec & RAW_FLAG:
            lines.append(f"  block {i}: stored raw, {rec & ~RAW_FLAG} bytes")
        else:
            lines.append(f"  block {i}: compressed, {rec} bytes")
    return "\n".join(lines)
