"""Executable specification of the reference LZ4-style codec.

A copy of ``lz4jpeg_tpu/oracle/lz4_oracle.py`` (pure Python, so the port
carries its ground truth onto machines without JAX;
``tests/test_torch_lz4_parity.py`` holds its outputs equal to the
original's): a faithful transcription of the reference's
``Algorithms/sequential/LZ4/LZ4.c`` semantics into pure Python — including
its quirks, which are load-bearing for
bit-exactness against the committed golden pair
(``Output-Input/input/input.txt`` ↔ ``Output-Input/out/compressed.bin``):

* greedy longest-match with a strict ``>`` comparison, so on ties the
  *earliest* candidate (largest offset) wins (LZ4.c:297-312);
* the match length is returned as ``uint8_t`` and silently truncated mod 256
  (LZ4.c:317), and all downstream length arithmetic (`token`, `byte_size`,
  extension bytes) wraps the same way (LZ4.c:540-575);
* match comparisons never run past the current block's end in this oracle —
  the C reads past the malloc'd block buffer (LZ4.c:301-302), which is
  undefined behavior; capping at the block end reproduces the committed
  golden bytes;
* the decoder reads sequence bytes through signed ``char``, so the
  ``== 255`` extension loops never fire and a literal-length extension byte
  ≥ 0x80 is *subtracted* (LZ4.c:763-773), while the match-length extension
  byte is added unsigned (LZ4.c:834);
* block ``byte_size`` headers are sign-extended through ``(uint16_t)(char)``
  during decode (LZ4.c:863);
* the frame header is a single byte, so ≥128 blocks sign-extend to a bogus
  count during decode (LZ4.c:1057) — the oracle raises instead of hanging;
* the decoder's text writer renders non-printable bytes as literal
  ``"0x%02X"`` (LZ4.c:1024-1031), so round-trips are byte-exact only for
  printable ASCII (the experiment harness guarantees this by replacing
  newlines with spaces, ``Experiment/random_extract.c:49-53``).

Frame layout (verified against the golden ``compressed.bin``):

    Frame    := block_count:u8
    Block    := seq_count:u8  block_byte_size:u16le  Sequence*
    Sequence := token:u8  seq_byte_size:u16le
                [litlen_ext:u8  if litcount>=15]      (single byte, wrapped)
                literals:u8[litcount]
                match_offset:u16le
                [matchlen_ext:u8  if (matchlen-4)&0xFF >= 15]
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

MIN_MATCH_LENGTH = 4
MAX_MATCH_LENGTH = 1024
WINDOW_SIZE = 65535
DEFAULT_BLOCK_LENGTH = 300


class ParityError(ValueError):
    """Input drives the reference implementation into undefined behavior."""


@dataclasses.dataclass
class LZ4Sequence:
    token: int
    byte_size: int
    literals: bytes
    literals_count: int
    match_offset: int
    match_length: int


@dataclasses.dataclass
class LZ4Block:
    token: int            # sequence count (mod 256)
    byte_size: int        # serialized size including its own 3-byte header
    sequences: List[LZ4Sequence]


def _signed8(b: int) -> int:
    return b - 256 if b >= 128 else b


def find_longest_match_oracle(block: bytes, current_index: int) -> Tuple[int, int]:
    """Greedy longest-match scan (LZ4.c:290-323).

    Returns ``(match_length, match_distance)`` with the reference's exact
    semantics: candidates scanned oldest→newest, a strict ``>`` keeps the
    first maximum (earliest position / largest offset), the ≥4 minimum is
    checked on the *untruncated* length, and the returned length is the
    uint8 truncation of the true length.  Returns ``(0, 0)`` when no match.
    """
    n = len(block)
    best_len = 0
    best_dist = 0
    window_start = current_index - WINDOW_SIZE if current_index >= WINDOW_SIZE else 0
    for i in range(window_start, current_index):
        m = 0
        # The C compares unconditionally while bytes agree; we stop at the
        # block end (current_index + m is always the larger index).
        while (
            m < MAX_MATCH_LENGTH
            and current_index + m < n
            and block[i + m] == block[current_index + m]
        ):
            m += 1
        if m > best_len:
            best_len = m
            best_dist = current_index - i
    if best_len >= MIN_MATCH_LENGTH:
        return best_len & 0xFF, best_dist & 0xFFFF
    return 0, 0


def _length_ext_count(value: int) -> int:
    """Number of extension bytes byte_size accounts for (LZ4.c:549-575).

    ``value`` is the already-uint8-wrapped ``count - 15`` remainder.
    """
    n = 0
    rem = value
    while rem >= 255:
        n += 1
        rem -= 255
    return n + 1


def block_encode_oracle(block: bytes) -> LZ4Block:
    """Transcription of ``block_encode`` (LZ4.c:506-620)."""
    seqs: List[LZ4Sequence] = []
    idx = 0
    lit_start = 0
    lit_count = 0
    n = len(block)
    while idx < n:
        ml, dist = find_longest_match_oracle(block, idx)
        if ml == 0:
            if lit_count == 0:
                lit_start = idx
            idx += 1
            lit_count += 1
        else:
            literals = block[lit_start : lit_start + lit_count]
            token_lit = 15 if lit_count >= 15 else lit_count
            token_ml = 15 if ml >= 19 else (ml - MIN_MATCH_LENGTH) & 0xFF
            token = ((token_lit << 4) | token_ml) & 0xFF
            byte_size = lit_count + 5
            if lit_count >= 15:
                byte_size += _length_ext_count((lit_count - 15) & 0xFF)
            adjusted_ml = (ml - 4) & 0xFF
            if adjusted_ml >= 15:
                byte_size += _length_ext_count((adjusted_ml - 15) & 0xFF)
            seqs.append(LZ4Sequence(token, byte_size, literals, lit_count, dist, ml))
            lit_count = 0
            idx += ml
    if lit_count > 0:
        # Tail literal run with no match: offset 0, match length 0
        # (LZ4.c:585-613); the decoder treats offset 0 as literals-only.
        literals = block[lit_start : lit_start + lit_count]
        token_lit = 15 if lit_count >= 15 else lit_count
        token = (token_lit << 4) & 0xFF
        byte_size = lit_count + 5
        if lit_count >= 15:
            byte_size += _length_ext_count((lit_count - 15) & 0xFF)
        seqs.append(LZ4Sequence(token, byte_size, literals, lit_count, 0, 0))
    return LZ4Block(
        token=len(seqs) & 0xFF,
        byte_size=sum(s.byte_size for s in seqs) + 3,
        sequences=seqs,
    )


def _write_length_ext(out: bytearray, value: int) -> None:
    """Emit wrapped extension bytes (LZ4.c:371-386, :397-411)."""
    rem = value
    while rem >= 255:
        out.append(255)
        rem -= 255
    out.append(rem)


def write_sequence_oracle(seq: LZ4Sequence, out: bytearray) -> None:
    """Transcription of ``write_sequence`` (LZ4.c:365-413)."""
    out.append(seq.token)
    out += struct.pack("<H", seq.byte_size & 0xFFFF)
    if seq.literals_count >= 15:
        _write_length_ext(out, (seq.literals_count - 15) & 0xFF)
    out += seq.literals
    out += struct.pack("<H", seq.match_offset & 0xFFFF)
    if seq.match_length >= 4:
        adjusted = (seq.match_length - 4) & 0xFF
        if adjusted >= 15:
            _write_length_ext(out, (adjusted - 15) & 0xFF)


def lz4_encode_oracle(
    data: bytes, block_length: int = DEFAULT_BLOCK_LENGTH
) -> bytes:
    """Full encode: ``lz4_encode`` (LZ4.c:670-742) minus the file I/O.

    Splits ``data`` into ``block_length``-byte blocks (last one ragged,
    LZ4.c:123-177), greedily encodes each block independently, and serializes
    the frame (LZ4.c:427-441).
    """
    if block_length == 500:
        raise ParityError("block length cannot have the value 500")
    if len(data) < block_length:
        raise ParityError("default block length is too high for this input")
    block_count = (len(data) + block_length - 1) // block_length
    out = bytearray()
    out.append(block_count & 0xFF)
    for i in range(block_count):
        block = data[i * block_length : (i + 1) * block_length]
        encoded = block_encode_oracle(block)
        out.append(encoded.token)
        out += struct.pack("<H", encoded.byte_size & 0xFFFF)
        for seq in encoded.sequences:
            write_sequence_oracle(seq, out)
    return bytes(out)


def parse_sequence_oracle(data: bytes) -> LZ4Sequence:
    """Transcription of ``sequence_decode`` (LZ4.c:744-843).

    ``data`` starts at the sequence token and spans ``byte_size`` bytes.
    Reproduces the signed-char quirks: the ``== 255`` loops never fire, the
    literal-length extension byte is added *signed*, the match-length
    extension byte is added unsigned.
    """
    token = data[0]
    p = 3  # skip token + seq_byte_size
    lit_count = (token & 0xF0) >> 4
    match_len = token & 0x0F
    if lit_count >= 15:
        # char(0xFF) == 255 is false, so exactly one ext byte, sign-extended.
        lit_count += _signed8(data[p])
        p += 1
        if lit_count < 0:
            raise ParityError("negative literal count after signed extension")
    literals = data[p : p + lit_count]
    p += lit_count
    offset = data[p] | (data[p + 1] << 8)
    p += 2
    if match_len >= 15:
        match_len += data[p]  # unsigned add (LZ4.c:834)
        p += 1
    match_len += 4
    return LZ4Sequence(token, len(data), literals, lit_count, offset, match_len)


def parse_block_oracle(block_data: bytes) -> List[LZ4Sequence]:
    """Transcription of ``block_decode`` (LZ4.c:845-888).

    ``block_data`` includes the 3-byte block header.  Each sequence's size is
    read through ``(uint16_t)(char)`` sign extension (LZ4.c:863).
    """
    seq_count = block_data[0]
    seqs = []
    p = 0
    for _ in range(seq_count):
        lo = block_data[p + 4]
        hi = block_data[p + 5]
        lo16 = lo | 0xFF00 if lo >= 128 else lo
        hi16 = hi | 0xFF00 if hi >= 128 else hi
        byte_size = lo16 + (hi16 << 8)
        if byte_size > len(block_data):
            raise ParityError(
                "sequence byte_size sign-extended out of range "
                f"({byte_size}) — reference would read out of bounds"
            )
        seqs.append(parse_sequence_oracle(block_data[p + 3 : p + 3 + byte_size]))
        p += byte_size
    return seqs


def interpret_sequence_oracle(seq: LZ4Sequence, out: bytearray) -> None:
    """Transcription of ``interpret_sequence`` (LZ4.c:937-982).

    Literals are appended, then the match is copied byte-by-byte against the
    *global* output buffer (offsets were computed intra-block, consistent
    because blocks are appended in order).  Offset 0 means literals-only.
    """
    out += seq.literals
    if seq.match_offset != 0:
        for _ in range(seq.match_length):
            match_pos = len(out) - seq.match_offset
            if match_pos < 0:
                raise ParityError("match offset out of bounds")
            out.append(out[match_pos])


def lz4_decode_oracle(compressed: bytes) -> bytes:
    """Full decode to raw bytes: ``LZ4_decode`` (LZ4.c:1038-1121) +
    ``interpret_frame`` (LZ4.c:984-1036), minus the text rendering."""
    block_count = _signed8(compressed[0])
    if block_count < 0:
        raise ParityError(
            "frame block count >= 128 sign-extends to a bogus size_t in the "
            "reference decoder"
        )
    p = 1
    out = bytearray()
    for i in range(block_count):
        byte1 = compressed[p + 1]
        byte2 = compressed[p + 2]
        byte_size = byte1 + (byte2 << 8)
        if byte_size <= 0:
            raise ParityError(f"invalid block size at block {i}")
        block_data = compressed[p : p + byte_size]
        for seq in parse_block_oracle(block_data):
            interpret_sequence_oracle(seq, out)
        p += byte_size
    return bytes(out)


def lz4_decode_to_text(compressed: bytes) -> bytes:
    """Decode and render like the reference's ``uncompressed.txt`` writer:
    printable ASCII bytes verbatim, everything else as ``0x%02X`` text
    (LZ4.c:1021-1032)."""
    raw = lz4_decode_oracle(compressed)
    out = bytearray()
    for b in raw:
        if 32 <= b <= 126:
            out.append(b)
        else:
            out += b"0x%02X" % b
    return bytes(out)
