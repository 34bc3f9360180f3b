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

``unpack_container`` decodes into the sparse16 layout where the strict
native walker takes every channel, and falls back, as the JAX container
does, to packed16 pairs, then to int32 pairs (the native pair walker, then
``unpack_symbols`` and the host re-blocking), keeping all channels in one
layout.
"""

from __future__ import annotations

import struct
import zlib
from typing import TYPE_CHECKING

import numpy as np

from lz4jpeg_tpu_torch.formats.fast_frame import content_checksum16
from lz4jpeg_tpu_torch.ops.huffman import CanonicalCodebook, unpack_symbols

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
    """Container bytes → JPEGEncoded in the first layout whose native
    walker takes every channel: sparse16 (the combined buffer), then packed16
    pairs, then int32 pairs (native, else ``unpack_symbols`` and the host
    re-blocking), as the JAX container does."""
    from lz4jpeg_tpu_torch.models.jpeg import (
        _CHANNEL_SHAPES,
        JPEGEncoded,
        _split_symbols,
    )
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

    header = dict(
        quality=quality or None, height=height, width=width,
        blocks_per_col=bpc, blocks_per_row=bpr, entropy_mode="shared",
        shared_streams=shared,
    )
    native = native_backend()

    def walk(unpack, extra):
        """Every channel through one native walker (``extra(channel, block
        size)`` gives its last arguments); None if it rejects a channel."""
        out = {}
        for c in ("lum", "r", "b"):
            codebook, packed, nbits = shared[c]
            h, w = _CHANNEL_SHAPES[c]
            try:
                got = unpack(packed, nbits, codebook, h * w, num_blocks,
                             *extra(c, h * w))
            except ValueError as e:
                raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
            if got is None:
                return None
            out[c] = got
        return out

    combined = np.zeros((num_blocks, COMBINED_LANES), np.uint16)
    got = walk(native.huff_unpack_sparse16,
               lambda c, k: (combined, CHANNEL_SLICES[c].start))
    if got is not None:
        return JPEGEncoded(
            rle={c: combined[:, sl] for c, sl in CHANNEL_SLICES.items()},
            rle_lengths={c: got[c][1] for c in got},
            rle_sparse16=True,
            rle_combined=combined,
            **header,
        )
    got = walk(native.huff_unpack_pairs16, lambda c, k: (k,))
    if got is not None:
        return JPEGEncoded(
            rle={c: v[0] for c, v in got.items()},
            rle_lengths={c: v[1] for c, v in got.items()},
            rle_packed16=True,
            **header,
        )
    rle, lengths = {}, {}
    for c in ("lum", "r", "b"):
        codebook, packed, nbits = shared[c]
        h, w = _CHANNEL_SHAPES[c]
        try:
            pairs = native.huff_unpack_pairs(
                packed, nbits, codebook, h * w, num_blocks, 2 * h * w
            )
            if pairs is None:
                symbols = unpack_symbols(packed, nbits, codebook)
                pairs = _split_symbols(symbols, num_blocks, 2 * h * w, h * w)
        except (ValueError, IndexError, RuntimeError) as e:
            raise JPEGContainerError(f"corrupt channel {c!r}: {e}") from e
        rle[c], lengths[c] = pairs
    return JPEGEncoded(rle=rle, rle_lengths=lengths, **header)


def is_jpeg_container(data: bytes) -> bool:
    return len(data) >= 4 and struct.unpack_from("<I", data, 0)[0] == MAGIC
