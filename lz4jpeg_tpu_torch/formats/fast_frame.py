"""The 16-bit content checksum the TJPG container carries.

Copy of ``lz4jpeg_tpu/formats/fast_frame.py::content_checksum16`` and
``fold_checksum16`` (zlib only; the LZ4T frame itself is not ported).
"""

from __future__ import annotations

import zlib


def content_checksum16(data: bytes, crc: int = 0) -> int:
    """CRC32 of the raw content folded into [1, 0xFFFF] (0 means "absent").

    Streaming callers fold chunk CRCs with ``fold_checksum16(running_crc)``
    after accumulating ``running_crc = zlib.crc32(chunk, running_crc)``.
    """
    return fold_checksum16(zlib.crc32(data, crc))


def fold_checksum16(crc32_value: int) -> int:
    return (crc32_value & 0xFFFFFFFF) % 0xFFFF + 1
