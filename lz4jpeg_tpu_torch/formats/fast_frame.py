"""The fast-mode LZ4 frame (LZ4T) and the TJPG content checksum.

Copy of ``lz4jpeg_tpu/formats/fast_frame.py`` (pure Python and zlib; the
tests hold every function byte-identical to its original):

    Frame   := magic:u32le ("LZ4T") version:u8 block_log:u8 checksum:u16le
               raw_size:u64le block_count:u32le
               comp_size:u32le[block_count]        (bit31 set → stored raw)
               payload[block_count]
    Payload := Sequence* FinalSequence            (standard LZ4 block coding)
    Sequence:= token:u8 (lit<<4 | (matchlen-4 capped at 15))
               [litlen ext: (255)* final<255  if lit>=15]
               literals  offset:u16le (>=1)
               [matchlen ext: (255)* final<255  if matchlen-4>=15]
    FinalSequence := literals-only token (match nibble 0), no offset field.

The per-block compressed sizes live up front, so decode framing is one
prefix sum and blocks decode independently; incompressible blocks are
stored raw; the header's 16-bit content checksum (CRC32 folded into
[1, 0xFFFF], 0 = absent) makes every decoder raise ``FastFormatError`` on a
corrupt but parseable stream.  This module is the executable spec; the
native ``lz4core.cpp`` implements the same walks byte-identically.
"""

from __future__ import annotations

import struct
import zlib

MAGIC = 0x54345A4C  # "LZ4T" little-endian
VERSION = 1
DEFAULT_BLOCK_LOG = 16  # 64 KiB blocks
RAW_FLAG = 0x80000000
_HASH_MULT = 2654435761
_HASH_LOG = 13  # 8192-entry table


class FastFormatError(ValueError):
    pass


def content_checksum16(data: bytes, crc: int = 0) -> int:
    """CRC32 of the raw content folded into [1, 0xFFFF] (0 means "absent").

    Streaming callers fold chunk CRCs with ``fold_checksum16(running_crc)``
    after accumulating ``running_crc = zlib.crc32(chunk, running_crc)``.
    """
    return fold_checksum16(zlib.crc32(data, crc))


def fold_checksum16(crc32_value: int) -> int:
    return (crc32_value & 0xFFFFFFFF) % 0xFFFF + 1


def _hash32(x: int) -> int:
    return ((x * _HASH_MULT) & 0xFFFFFFFF) >> (32 - _HASH_LOG)


def compress_block(block: bytes) -> bytes:
    """Greedy single-probe hash-table encoder (executable spec).

    Deterministic: candidates are only inserted at scanned positions (bytes
    inside matches are skipped), matches require a 4-byte prefix equality at
    distance ≤ 65535 and extend to the block end.  The native encoder
    replicates this walk exactly.
    """
    n = len(block)
    out = bytearray()
    table = [-1] * (1 << _HASH_LOG)
    i = 0
    anchor = 0
    while i + 4 <= n:
        h = _hash32(int.from_bytes(block[i : i + 4], "little"))
        cand = table[h]
        table[h] = i
        if (
            cand >= 0
            and i - cand <= 0xFFFF
            and block[cand : cand + 4] == block[i : i + 4]
        ):
            length = 4
            while i + length < n and block[cand + length] == block[i + length]:
                length += 1
            _emit_sequence(out, block[anchor:i], i - cand, length)
            i += length
            anchor = i
        else:
            i += 1
    _emit_final(out, block[anchor:n])
    return bytes(out)


def _emit_ext(out: bytearray, value: int) -> None:
    while value >= 255:
        out.append(255)
        value -= 255
    out.append(value)


def _emit_sequence(out: bytearray, literals: bytes, offset: int, length: int) -> None:
    lit = len(literals)
    ml = length - 4
    out.append((min(lit, 15) << 4) | min(ml, 15))
    if lit >= 15:
        _emit_ext(out, lit - 15)
    out += literals
    out += struct.pack("<H", offset)
    if ml >= 15:
        _emit_ext(out, ml - 15)


def _emit_final(out: bytearray, literals: bytes) -> None:
    lit = len(literals)
    out.append(min(lit, 15) << 4)
    if lit >= 15:
        _emit_ext(out, lit - 15)
    out += literals


def emit_block_from_parse(
    block: bytes, is_match, emit_len, emit_dist
) -> bytes:
    """LZ4T payload from parse arrays (the device matcher's output shape).

    ``is_match[k]`` marks a sequence starting at ``k`` with total match
    length ``emit_len[k]`` (≥4) at distance ``emit_dist[k]``; the gaps are
    literals.  Each taken match is greedily extended while the distance-d
    prediction keeps holding, undoing the device matcher's length cap and
    its parse-segment truncation (parse marks swallowed by an extension are
    skipped).  Python twin of the native ``lz4t_emit_block``.
    """
    out = bytearray()
    n = len(block)
    anchor = 0
    k = 0
    while k < n:
        if not is_match[k]:
            k += 1
            continue
        length = int(emit_len[k])
        d = int(emit_dist[k])
        # Backward extension first (recovers starts the anchor-strided
        # matcher cannot mark), then forward extension past the carry cap.
        while k > anchor and k > d and block[k - 1] == block[k - 1 - d]:
            k -= 1
            length += 1
        while k + length < n and block[k + length] == block[k + length - d]:
            length += 1
        _emit_sequence(out, block[anchor:k], d, length)
        k += length
        anchor = k
    _emit_final(out, block[anchor:n])
    return bytes(out)


def assemble_frame(
    block_payloads, block_raws, total_size: int, block_log: int
) -> bytes:
    """Wrap per-block payloads into a frame, raw-storing incompressible
    blocks.  ``block_payloads[i]`` is block i's compressed payload and
    ``block_raws[i]`` its raw bytes."""
    sizes = []
    body = bytearray()
    for payload, raw in zip(block_payloads, block_raws):
        if payload is None or len(payload) >= len(raw):
            sizes.append(len(raw) | RAW_FLAG)
            body += raw
        else:
            sizes.append(len(payload))
            body += payload
    crc = 0
    for raw in block_raws:
        crc = zlib.crc32(raw, crc)
    out = bytearray()
    out += struct.pack(
        "<IBBHQI", MAGIC, VERSION, block_log, fold_checksum16(crc),
        total_size, len(sizes),
    )
    out += struct.pack(f"<{len(sizes)}I", *sizes)
    out += body
    return bytes(out)


def decompress_block(payload: bytes, raw_size: int) -> bytes:
    out = bytearray()
    p = 0
    n = len(payload)

    def need(k):
        if p + k > n:
            raise FastFormatError("truncated sequence")

    while p < n:
        token = payload[p]
        p += 1
        lit = token >> 4
        if lit == 15:
            while True:
                need(1)
                b = payload[p]
                p += 1
                lit += b
                if b != 255:
                    break
        if p + lit > n:
            raise FastFormatError("truncated literals")
        out += payload[p : p + lit]
        p += lit
        if p == n:
            break  # final literals-only sequence
        need(2)
        offset = payload[p] | (payload[p + 1] << 8)
        p += 2
        if offset == 0 or offset > len(out):
            raise FastFormatError("bad match offset")
        ml = (token & 0xF) + 4
        if token & 0xF == 15:
            while True:
                need(1)
                b = payload[p]
                p += 1
                ml += b
                if b != 255:
                    break
        for _ in range(ml):
            out.append(out[len(out) - offset])
    if len(out) != raw_size:
        raise FastFormatError(
            f"decoded {len(out)} bytes, header promised {raw_size}"
        )
    return bytes(out)


def encode_fast(data: bytes, block_log: int = DEFAULT_BLOCK_LOG) -> bytes:
    block_size = 1 << block_log
    blocks = [data[i : i + block_size] for i in range(0, len(data), block_size)]
    payloads = []
    sizes = []
    for block in blocks:
        comp = compress_block(block)
        if len(comp) >= len(block):
            payloads.append(block)
            sizes.append(len(block) | RAW_FLAG)
        else:
            payloads.append(comp)
            sizes.append(len(comp))
    out = bytearray()
    out += struct.pack(
        "<IBBHQI", MAGIC, VERSION, block_log, content_checksum16(data),
        len(data), len(blocks),
    )
    out += struct.pack(f"<{len(sizes)}I", *sizes)
    for p in payloads:
        out += p
    return bytes(out)


def decode_fast(data: bytes) -> bytes:
    if len(data) < 20:
        raise FastFormatError("frame too short")
    magic, version, block_log, checksum, raw_size, block_count = (
        struct.unpack_from("<IBBHQI", data, 0)
    )
    if magic != MAGIC:
        raise FastFormatError("bad magic")
    if version != VERSION:
        raise FastFormatError(f"unsupported version {version}")
    try:
        sizes = struct.unpack_from(f"<{block_count}I", data, 20)
    except struct.error as e:
        raise FastFormatError(f"truncated size table: {e}") from e
    p = 20 + 4 * block_count
    block_size = 1 << block_log
    out = bytearray()
    for i, s in enumerate(sizes):
        expected = min(block_size, raw_size - i * block_size)
        if s & RAW_FLAG:
            length = s & ~RAW_FLAG
            out += data[p : p + length]
            if length != expected:
                raise FastFormatError(f"raw block {i} size mismatch")
        else:
            out += decompress_block(data[p : p + s], expected)
            length = s
        p += length
    if p != len(data) or len(out) != raw_size:
        raise FastFormatError("frame size mismatch")
    if checksum and content_checksum16(bytes(out)) != checksum:
        raise FastFormatError("content checksum mismatch")
    return bytes(out)


def is_fast_frame(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data, 0)[0] == MAGIC


def verify_frame_checksum(frame: bytes, decoded: bytes) -> None:
    """Raise the typed error if ``frame``'s header checksum (nonzero) does
    not match ``decoded``.  Decoders that reconstruct outside
    ``decode_fast`` (the device resolve, streaming) share this gate."""
    (checksum,) = struct.unpack_from("<H", frame, 6)
    if checksum and content_checksum16(decoded) != checksum:
        raise FastFormatError("content checksum mismatch")
