"""The LZ4T fast codec on PyTorch.

Port of ``lz4jpeg_tpu/models/lz4.py`` for ``LZ4Config(mode="fast")``:

* encode, ``engine="device"`` (the JAX package's ``"tpu"`` engine; it runs
  on the codec's ``device``): 16 KiB blocks go up as uint8 → the matcher
  (``matcher="fused"``: ``ops/fused_match.py``, the Hopper kernel on a CUDA
  device and its plain version on the CPU; ``"sort"``:
  ``ops/lz4_fast.py::fast_match_blocks``) → ``compact_parse`` → only the
  ``max(counts)`` compacted match records come back → the native batched
  emitter → ``assemble_frame``;
* encode, ``"native"`` / ``"python"``: the C++ host encoder or the Python
  spec (64 KiB blocks); ``"auto"`` is native;
* decode, ``"device"``: ``ops/lz4t_decode.py::decode_fast_device`` (the
  Hopper rooted-resolve kernel on a CUDA device); ``"native"`` /
  ``"python"`` / ``"auto"`` as for encode.

Parity mode and the encode log are not ported yet: the codec refuses them.
The codec runs where its ``device`` says and nowhere else.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import LZ4Config
from lz4jpeg_tpu_torch.formats.fast_frame import (
    DEFAULT_BLOCK_LOG,
    MAGIC,
    RAW_FLAG,
    VERSION,
    FastFormatError,
    assemble_frame,
    compress_block,
    decode_fast,
    encode_fast,
    fold_checksum16,
    is_fast_frame,
)
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.fused_match import fast_match_blocks_fused
from lz4jpeg_tpu_torch.ops.lz4_fast import (
    TPU_BLOCK_LOG,
    compact_parse,
    fast_match_blocks,
    pad_blocks_fast,
)
from lz4jpeg_tpu_torch.ops.lz4t_decode import decode_fast_device

_PARITY = "ROADMAP.md queue 1, item 8 (LZ4 parity mode on device)"
ENGINES = ("auto", "device", "native", "python")


class LZ4Codec:
    """LZ4T fast codec with device match finding and device decode."""

    def __init__(self, config: LZ4Config, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but CUDA is not available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        if config.mode == "parity":
            raise NotImplementedError(
                f'mode="parity" is not ported yet ({_PARITY})'
            )
        if config.log_path is not None:
            raise NotImplementedError(
                "log_path is not ported yet (describe_frame and EncodingLog "
                f"come with {_PARITY})"
            )
        self.config = config

    @staticmethod
    def _engine(engine: str) -> str:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        return "native" if engine == "auto" else engine

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    def encode(self, data: bytes, engine: str = "auto") -> bytes:
        """Compress ``data`` into one LZ4T frame.

        ``"device"`` runs the matcher on the codec's device (16 KiB
        blocks), ``"native"`` the C++ host encoder, ``"python"`` the
        executable spec; ``"auto"`` is native.  Every engine's frame
        decodes with every decoder (match choices differ)."""
        engine = self._engine(engine)
        if engine == "device":
            return self._encode_fast_device(data)
        if engine == "native":
            return native_backend().encode_fast(data)
        return encode_fast(data)

    def _encode_fast_device(self, data: bytes) -> bytes:
        """Fast-mode encode with device match finding (16 KiB blocks)."""
        payloads, raws = self._device_chunk_payloads(data)
        return assemble_frame(payloads, raws, len(data), TPU_BLOCK_LOG)

    def _device_fast_encode(self, blocks: torch.Tensor, lengths: torch.Tensor):
        """Matcher + compactor: (B, P) uint8 blocks + (B,) int32 lengths on
        the device → the compacted ``(positions, len << pos_bits | dist,
        counts)`` records.  ``matcher="fused"`` runs ``match_candidates``
        (K2 on a CUDA device, its plain version on the CPU); ``"sort"``
        the sort matcher."""
        cfg = self.config
        if cfg.matcher == "fused":
            fields = fast_match_blocks_fused(
                blocks, lengths, stride=cfg.match_stride,
                lcp_words=cfg.match_lcp_words,
            )
        else:
            fields = fast_match_blocks(
                blocks, lengths, lcp_words=cfg.match_lcp_words
            )
        return compact_parse(*fields)

    def _device_chunk_payloads(self, data: bytes):
        """Device match + host emission for consecutive ``TPU_BLOCK_LOG``
        blocks; returns ``(payloads, raws)`` ready for frame assembly —
        shared by ``encode`` and ``encode_file(engine="device")``.

        Blocks go up as uint8, and only the compacted match records come
        back: ``max(counts)`` (pos, len·dist) int32 pairs per block instead
        of the 12·P-byte dense parse fields."""
        padded, lengths = pad_blocks_fast(data, TPU_BLOCK_LOG)
        num_blocks, p = padded.shape
        data_u8 = padded.astype(np.uint8)
        pos_sorted, packed, counts = self._device_fast_encode(
            torch.from_numpy(data_u8).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        records = fetch_records(pos_sorted, packed, counts, p)
        payloads = native_backend().emit_blocks(
            data_u8, lengths, *densify_records(*records, p)
        )
        raws = [
            data_u8[bi, : int(lengths[bi])].tobytes()
            for bi in range(num_blocks)
        ]
        return payloads, raws

    def encode_file(
        self,
        input_path: str,
        output_path: str,
        chunk_blocks: int = 1024,
        engine: str = "auto",
    ) -> int:
        """Stream-encode a file of any size into one LZ4T frame.

        Reads ``chunk_blocks`` blocks at a time; the size table and content
        checksum are backfilled after the payloads.  ``"native"`` compresses
        each chunk in one C++ call, ``"device"`` runs the device matcher per
        chunk (16 KiB blocks), ``"python"`` is the spec loop; ``"auto"`` is
        native.  Returns the compressed size."""
        engine = self._engine(engine)
        block_log = TPU_BLOCK_LOG if engine == "device" else DEFAULT_BLOCK_LOG
        block_size = 1 << block_log
        total = os.path.getsize(input_path)
        block_count = -(-total // block_size) if total else 0
        sizes: List[int] = []
        crc = 0
        with open(input_path, "rb") as src, open(output_path, "wb") as dst:
            dst.write(struct.pack(
                "<IBBHQI", MAGIC, VERSION, block_log, 0, total, block_count,
            ))
            dst.write(b"\x00" * (4 * block_count))  # size table backfilled
            while True:
                chunk = src.read(block_size * chunk_blocks)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
                if engine == "native":
                    body, recs = native_backend().encode_chunk(chunk, block_log)
                    sizes.extend(int(r) for r in recs)
                    dst.write(body)
                    continue
                if engine == "device":
                    payloads, raws = self._device_chunk_payloads(chunk)
                else:
                    raws = [chunk[i : i + block_size]
                            for i in range(0, len(chunk), block_size)]
                    payloads = [compress_block(raw) for raw in raws]
                for payload, raw in zip(payloads, raws):
                    if len(payload) >= len(raw):
                        sizes.append(len(raw) | RAW_FLAG)
                        dst.write(raw)
                    else:
                        sizes.append(len(payload))
                        dst.write(payload)
            dst.seek(6)
            dst.write(struct.pack("<H", fold_checksum16(crc) if total else 0))
            dst.seek(20)
            dst.write(struct.pack(f"<{len(sizes)}I", *sizes))
        return os.path.getsize(output_path)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def decode_file(
        self, input_path: str, output_path: str, chunk_blocks: int = 1024
    ) -> int:
        """Stream-decode an LZ4T file with the native chunk decoder
        (``chunk_blocks`` blocks per call), verifying the content checksum
        incrementally.  Returns the raw size."""
        native = native_backend()
        with open(input_path, "rb") as src:
            header = src.read(20)
            if len(header) < 20:
                raise FastFormatError("frame too short")
            magic, version, block_log, checksum, raw_size, block_count = (
                struct.unpack("<IBBHQI", header)
            )
            if magic != MAGIC:
                raise FastFormatError("bad magic")
            if version != VERSION:
                raise FastFormatError(f"unsupported version {version}")
            table = src.read(4 * block_count)
            if len(table) < 4 * block_count:
                raise FastFormatError("truncated size table")
            sizes = struct.unpack(f"<{block_count}I", table)
            block_size = 1 << block_log
            written = 0
            crc = 0
            with open(output_path, "wb") as dst:
                for group in range(0, block_count, chunk_blocks):
                    recs = sizes[group : group + chunk_blocks]
                    payload_len = sum(
                        (r & ~RAW_FLAG) if r & RAW_FLAG else r for r in recs
                    )
                    payloads = src.read(payload_len)
                    if len(payloads) != payload_len:
                        raise FastFormatError("truncated payloads")
                    raw_total = min(block_size * len(recs), raw_size - written)
                    if raw_total < 0:
                        raise FastFormatError("block count exceeds raw size")
                    try:
                        data = native.decode_chunk(
                            payloads, recs, block_log, raw_total
                        )
                    except RuntimeError as e:
                        raise FastFormatError(str(e)) from e
                    crc = zlib.crc32(data, crc)
                    dst.write(data)
                    written += len(data)
                if src.read(1):
                    raise FastFormatError("trailing garbage after frame")
            if written != raw_size:
                raise FastFormatError("frame size mismatch")
            if checksum and fold_checksum16(crc) != checksum:
                raise FastFormatError("content checksum mismatch")
        return written

    def decode(self, compressed: bytes, engine: str = "auto") -> bytes:
        """Decompress an LZ4T frame.  ``"device"`` resolves every block's
        matches on the codec's device (``decode_fast_device``),
        ``"native"`` runs the C++ decoder, ``"python"`` the spec;
        ``"auto"`` is native."""
        engine = self._engine(engine)
        if not is_fast_frame(compressed):
            raise NotImplementedError(
                f"parity frames are not ported yet ({_PARITY})"
            )
        if engine == "device":
            return decode_fast_device(compressed, self.device)
        if engine == "native":
            (raw_size,) = struct.unpack_from("<Q", compressed, 8)
            return native_backend().decode_fast(compressed, raw_size)
        return decode_fast(compressed)

    def roundtrip(self, data: bytes) -> bytes:
        return self.decode(self.encode(data))


def fetch_records(pos_sorted, packed, counts, p: int):
    """Device records of ``compact_parse`` → host numpy, fetching only the
    first ``k`` slots per block (``k`` = ``max(counts)`` rounded up to a
    power of two, at most P)."""
    counts_h = counts.cpu().numpy()
    k = min(1 << max(1, (int(counts_h.max()) - 1).bit_length()), p)
    return (pos_sorted[:, :k].cpu().numpy(), packed[:, :k].cpu().numpy(),
            counts_h)


def densify_records(pos, packed, counts, p: int):
    """Compacted (B, k) match records → dense (B, P) ``(is_match uint8,
    emit_len int32, emit_dist int32)`` for the emitters (a vectorized
    host scatter)."""
    num_blocks, k = pos.shape
    pos_bits = (p - 1).bit_length()
    is_match = np.zeros((num_blocks, p), np.uint8)
    emit_len = np.zeros((num_blocks, p), np.int32)
    emit_dist = np.zeros((num_blocks, p), np.int32)
    slot = np.arange(k)[None, :] < counts[:, None]
    rows = np.broadcast_to(np.arange(num_blocks)[:, None], (num_blocks, k))
    r, c = rows[slot], pos[slot]
    is_match[r, c] = 1
    emit_len[r, c] = packed[slot] >> pos_bits
    emit_dist[r, c] = packed[slot] & (p - 1)
    return is_match, emit_len, emit_dist
