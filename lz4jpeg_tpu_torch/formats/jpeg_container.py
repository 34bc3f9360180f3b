"""Serializable TJPG container for JPEG-pipeline encodes.

Port of ``lz4jpeg_tpu/formats/jpeg_container.py`` (same wire format, so
containers cross-decode between the two packages):

    Container := magic:u32le ("TJPG") version:u8 quality:u8
                 height:u32le width:u32le checksum:u16le     (v2)
                 Channel["lum"] Channel["r"] Channel["b"]
    Channel   := codebook_len:u32le codebook (see CanonicalCodebook)
                 nbits:u32le packed_len:u32le packed bytes

The header's quality byte (0 = the reference's fixed tables) says which
tables decode it.  ``checksum`` (v2) is CRC32 of the header's first 14 bytes
plus everything after the checksum field, folded into [1, 0xFFFF]; v1
containers (no checksum) still decode.

``unpack_container`` decodes into the sparse16 layout only.  A stream that
the native sparse16 walker rejects raises ``JPEGContainerError``; the JAX
package's packed16 and int32-pair fallbacks are not ported yet (ROADMAP.md
queue 1, "JPEG remaining modes").
"""

from __future__ import annotations

import struct
import zlib
from typing import TYPE_CHECKING

import numpy as np

from lz4jpeg_tpu_torch.formats.fast_frame import content_checksum16
from lz4jpeg_tpu_torch.ops.huffman import CanonicalCodebook

if TYPE_CHECKING:
    from lz4jpeg_tpu_torch.models.jpeg import JPEGEncoded

MAGIC = 0x47504A54  # "TJPG"
VERSION = 2


class JPEGContainerError(ValueError):
    pass


def _container_checksum16(data: bytes) -> int:
    """Checksum over the container with the checksum field excluded."""
    return content_checksum16(data[16:], zlib.crc32(data[:14]))


def pack_container(enc: "JPEGEncoded") -> bytes:
    if enc.entropy_mode != "shared":
        raise JPEGContainerError(
            "only shared-codebook encodes are serializable; run "
            "JPEGPipeline.entropy_encode first"
        )
    out = bytearray()
    quality = enc.quality or 0
    out += struct.pack(
        "<IBBII", MAGIC, VERSION, quality, enc.height, enc.width
    )
    out += b"\x00\x00"  # checksum backfilled below
    for c in ("lum", "r", "b"):
        codebook, packed, nbits = enc.shared_streams[c]
        blob = codebook.serialize()
        out += struct.pack("<I", len(blob))
        out += blob
        out += struct.pack("<II", nbits, len(packed))
        out += packed
    struct.pack_into("<H", out, 14, _container_checksum16(bytes(out)))
    return bytes(out)


def unpack_container(data: bytes) -> "JPEGEncoded":
    from lz4jpeg_tpu_torch.models.jpeg import _CHANNEL_SHAPES, JPEGEncoded
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        CHANNEL_SLICES,
        COMBINED_LANES,
    )

    if len(data) < 14:
        raise JPEGContainerError("container too short")
    magic, version, quality, height, width = struct.unpack_from(
        "<IBBII", data, 0
    )
    if magic != MAGIC:
        raise JPEGContainerError("bad magic")
    if version not in (1, VERSION):
        raise JPEGContainerError(f"unsupported version {version}")
    if version >= 2:
        if len(data) < 16:
            raise JPEGContainerError("container too short")
        (checksum,) = struct.unpack_from("<H", data, 14)
        if checksum and _container_checksum16(data) != checksum:
            raise JPEGContainerError("container checksum mismatch")
        p = 16
    else:
        p = 14  # legacy v1: no checksum field
    bpc, bpr = -(-height // 8), -(-width // 8)
    num_blocks = bpc * bpr
    shared = {}
    for c in ("lum", "r", "b"):
        try:
            (blob_len,) = struct.unpack_from("<I", data, p)
            p += 4
            codebook, _ = CanonicalCodebook.deserialize(data[p : p + blob_len])
            p += blob_len
            nbits, packed_len = struct.unpack_from("<II", data, p)
            p += 8
            packed = data[p : p + packed_len]
            if len(packed) != packed_len:
                raise JPEGContainerError(f"truncated stream for {c!r}")
            p += packed_len
            shared[c] = (codebook, packed, nbits)
        except JPEGContainerError:
            raise
        except (struct.error, ValueError, IndexError) as e:
            raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
    if p != len(data):
        raise JPEGContainerError("trailing bytes after container")

    native = native_backend()
    combined = np.zeros((num_blocks, COMBINED_LANES), np.uint16)
    lengths = {}
    for c in ("lum", "r", "b"):
        codebook, packed, nbits = shared[c]
        h, w = _CHANNEL_SHAPES[c]
        try:
            got = native.huff_unpack_sparse16(
                packed, nbits, codebook, h * w, num_blocks,
                out_sparse=combined, col_off=CHANNEL_SLICES[c].start,
            )
        except ValueError as e:
            raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
        if got is None:
            raise JPEGContainerError(
                f"channel {c!r} is not a canonical sparse16 stream (the "
                "pair-layout fallbacks are not ported)"
            )
        lengths[c] = got[1]
    return JPEGEncoded(
        quality=quality or None,
        height=height,
        width=width,
        blocks_per_col=bpc,
        blocks_per_row=bpr,
        rle={c: combined[:, sl] for c, sl in CHANNEL_SLICES.items()},
        rle_lengths=lengths,
        entropy_mode="shared",
        rle_combined=combined,
        shared_streams=shared,
    )


def is_jpeg_container(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data, 0)[0] == MAGIC
