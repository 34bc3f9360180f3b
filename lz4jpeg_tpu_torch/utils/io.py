"""Host-side I/O & trace utilities (the reference's L0 layer, SURVEY.md §1).

A copy of ``lz4jpeg_tpu/utils/io.py``, except PNG I/O, which the port does
with the standard library's ``zlib`` and ``struct`` (the JAX package uses
PIL, which the machines the port runs on need not have):

* PNG read/write (replacing the vendored stb_image / stb_image_write,
  ``Algorithms/sequential/JPEG/stb_image.h``): 8-bit grey, RGB and RGBA,
  non-interlaced; every row filter on read, filter 0 on write;
* hex dump mirroring ``dump_to_hex_file`` (``"%02X "`` per byte,
  ``Algorithms/sequential/LZ4/LZ4.c:75-107``);
* binary pretty printer mirroring ``print_binary_to_file`` (LZ4.c:66-72);
* append-mode encoding log mirroring ``encoding_log.txt`` (LZ4.c:24,683)
  and the ``clear_files`` truncation (LZ4.c:204-213).

``tests/test_torch_cli.py`` holds the PNG codec against PIL both ways and
the rest against the original.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels, for the 8-bit types this codec takes.
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec §9.2) → (height, width·bpp) u8."""
    stride = width * bpp
    if len(raw) != height * (stride + 1):
        raise ValueError(
            f"PNG data holds {len(raw)} bytes, not {height * (stride + 1)}"
        )
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:  # None
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            cur = _unfilter_left(kind, line.tolist(), prior.tolist(), bpp)
        else:
            raise ValueError(f"unknown PNG row filter {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def _unfilter_left(kind: int, line, prior, bpp: int) -> np.ndarray:
    cur = [0] * len(line)
    for i, x in enumerate(line):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.array(cur, np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG → (H, W, 3) uint8 RGB (grey replicated, alpha dropped, like
    ``read_image`` forcing 4 channels then using rgb, JPEG.c:66-103).
    Takes 8-bit grey, RGB and RGBA without interlacing; anything else
    raises ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, colour, compression, filters, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(
            f"{path}: PNG bit depth {depth}, colour type {colour}: only 8-bit "
            "grey (0), RGB (2) and RGBA (6) are read"
        )
    if compression or filters or interlace:
        raise ValueError(f"{path}: interlaced or non-standard PNG")
    bpp = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from e
    pixels = _unfilter(raw, height, width, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 RGB → PNG (``create_png_image``, JPEG.c:187-217);
    (H, W) grey and (H, W, 4) RGBA are written as such.  Every row takes
    filter 0."""
    pixels = np.asarray(rgb, dtype=np.uint8)
    if pixels.ndim == 2:
        pixels = pixels[..., None]
    colour = {1: 0, 3: 2, 4: 6}.get(pixels.shape[-1]) if pixels.ndim == 3 else None
    if colour is None:
        raise ValueError(f"cannot write an array of shape {pixels.shape} as PNG")
    height, width = pixels.shape[:2]
    rows = np.zeros((height, 1 + width * pixels.shape[2]), np.uint8)
    rows[:, 1:] = pixels.reshape(height, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8,
                                           colour, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def hex_dump(data: bytes) -> str:
    """``"%02X "`` per byte — the exact ``compressed.txt`` mirror format."""
    return "".join(f"{b:02X} " for b in data)


def dump_to_hex_file(input_path: str, output_path: str) -> None:
    """File-to-file variant matching the reference helper."""
    with open(input_path, "rb") as f:
        data = f.read()
    with open(output_path, "w") as f:
        f.write(hex_dump(data))


def binary_string(byte: int) -> str:
    """8-char MSB-first bit string (``print_binary_to_file``)."""
    return format(byte & 0xFF, "08b")


class EncodingLog:
    """Append-mode text log, the reference's only logging facility."""

    def __init__(self, path: str = "encoding_log.txt"):
        self.path = path

    def clear(self) -> None:
        open(self.path, "w").close()

    def write(self, message: str) -> None:
        with open(self.path, "a") as f:
            f.write(message)
            if not message.endswith("\n"):
                f.write("\n")


def clear_files(*paths: str) -> None:
    """Truncate output files before an encode run (``clear_files``)."""
    for p in paths:
        open(p, "wb").close()


def write_text_rendering(path: str, raw: bytes) -> None:
    """The reference decoder's text writer: printable ASCII verbatim,
    other bytes as literal ``0x%02X`` text (LZ4.c:1021-1032)."""
    out = bytearray()
    for b in raw:
        if 32 <= b <= 126:
            out.append(b)
        else:
            out += b"0x%02X" % b
    with open(path, "wb") as f:
        f.write(bytes(out))


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
