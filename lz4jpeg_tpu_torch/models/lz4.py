"""The LZ4 block codec on PyTorch: the reference's parity format and the
LZ4T fast frame.

Port of ``lz4jpeg_tpu/models/lz4.py``.  ``LZ4Config(mode="parity")``:

* encode (every ``engine`` alike, as in JAX): blocks of ``block_length``
  bytes padded by ``ops/match.py::pad_blocks`` → per chunk of
  ``batch_blocks`` blocks, ``ops/lz4_parse.py::parity_parse`` on the
  codec's ``device`` (K11 on a CUDA device; ``match_tables`` and
  ``greedy_parse`` as torch ops on the CPU) → one copy of the three parse
  fields to the host →
  ``_build_sequences`` → ``formats/lz4_frame.py::pack_frame``; the frame is
  byte-identical to the reference encoder's;
* decode of a parity frame, ``"device"``: ``ops/lz4_decode.py``'s pointer
  doubling on the codec's device; every other engine:
  ``decode_frame_bytes`` on the host.

``LZ4Config(mode="fast")``:

* encode, ``engine="device"`` (the JAX package's ``"tpu"`` engine; it runs
  on the codec's ``device``): 16 KiB blocks go up as uint8 → the matcher
  (``matcher="fused"``: ``ops/fused_match.py``, the Hopper kernels K2 and
  K10 on a CUDA device and their plain versions on the CPU; ``"sort"``:
  ``ops/lz4_fast.py::fast_match_blocks``, whose parse is K10 on a CUDA
  device) → ``compact_parse`` → only the
  ``max(counts)`` compacted match records come back → the native batched
  emitter → ``assemble_frame``;
* encode, ``"native"`` / ``"python"``: the C++ host encoder or the Python
  spec (64 KiB blocks); ``"auto"`` is native;
* decode, ``"device"``: ``ops/lz4t_decode.py::decode_fast_device`` (the
  Hopper rooted-resolve kernel on a CUDA device); ``"native"`` /
  ``"python"`` / ``"auto"`` as for encode.

``log_path`` appends each encode's record (``_log_encode``) to a file, in
both modes.  The codec runs where its ``device`` says and nowhere else.
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
from lz4jpeg_tpu_torch.formats.lz4_frame import (
    Block,
    Sequence,
    decode_frame_bytes,
    describe_frame,
    pack_frame,
)
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.fused_match import fast_match_blocks_fused
from lz4jpeg_tpu_torch.ops.lz4_fast import (
    TPU_BLOCK_LOG,
    compact_parse,
    fast_match_blocks,
    pad_blocks_fast,
)
from lz4jpeg_tpu_torch.ops.lz4_decode import decode_frame_device
from lz4jpeg_tpu_torch.ops.lz4t_decode import decode_fast_device
from lz4jpeg_tpu_torch.ops.lz4_parse import parity_parse
from lz4jpeg_tpu_torch.ops.match import pad_blocks
from lz4jpeg_tpu_torch.utils.io import EncodingLog

ENGINES = ("auto", "device", "native", "python")


class LZ4Codec:
    """Block LZ4 codec (parity or LZ4T) with device match finding and
    device decode."""

    def __init__(self, config: LZ4Config, device, batch_blocks: int = 256):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but CUDA is not available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.config = config
        # Blocks per parity match batch: bounds the (B, P, P) match tables
        # (B·P²·4 bytes each).
        self.batch_blocks = batch_blocks

    @staticmethod
    def _engine(engine: str) -> str:
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; one of {ENGINES}")
        return "native" if engine == "auto" else engine

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    def encode(self, data: bytes, engine: str = "auto") -> bytes:
        """Compress ``data`` into one frame of the configured mode.

        Parity mode matches on the codec's device whatever ``engine`` says.
        Fast mode: ``"device"`` runs the matcher on the codec's device (16
        KiB blocks), ``"native"`` the C++ host encoder, ``"python"`` the
        executable spec; ``"auto"`` is native.  Every engine's LZ4T frame
        decodes with every decoder (match choices differ)."""
        engine = self._engine(engine)
        if self.config.mode == "parity":
            frame = self._encode_parity(data)
        elif engine == "device":
            frame = self._encode_fast_device(data)
        elif engine == "native":
            frame = native_backend().encode_fast(data)
        else:
            frame = encode_fast(data)
        return self._log_encode(data, frame)

    def _log_encode(self, data: bytes, frame: bytes) -> bytes:
        """Append an encode record to the configured log — the role of the
        reference's ``encoding_log.txt`` + ``print_frame_details``
        (LZ4.c:24,683 opens the log per encode; :220-287 are the printers).
        Full per-sequence structure is logged for parity frames (bounded at
        ≤255 blocks by the format); fast frames get the block-size summary.
        """
        if self.config.log_path is None:
            return frame
        log = EncodingLog(self.config.log_path)
        log.write(
            f"encode mode={self.config.mode} in={len(data)}B "
            f"out={len(frame)}B ratio={len(frame)/max(len(data),1):.4f}"
        )
        detail = describe_frame(frame).splitlines()
        if len(detail) > 1024:  # keep multi-GB encodes from exploding the log
            detail = detail[:1024] + [f"... ({len(detail) - 1024} more lines)"]
        log.write("\n".join(detail))
        return frame

    def _encode_parity(self, data: bytes) -> bytes:
        """Parity frame: device match tables and greedy parse per chunk of
        ``batch_blocks`` blocks (``parity_parse``: K11 once a chunk on a
        CUDA device), one copy of the parse fields to the host, host
        sequence building and framing."""
        block_length = self.config.block_length
        if len(data) < block_length:
            raise ValueError("default block length is too high for this input")
        padded, lengths = pad_blocks(data, block_length)
        blocks: List[Block] = []
        for start in range(0, padded.shape[0], self.batch_blocks):
            chunk = torch.from_numpy(
                padded[start : start + self.batch_blocks]).to(self.device)
            is_match, emit_len, emit_dist = parity_parse(
                chunk, max_match=self.config.max_match_length
            )
            fields = torch.stack(
                [is_match.int(), emit_len, emit_dist]).cpu().numpy()
            for bi in range(chunk.shape[0]):
                n = int(lengths[start + bi])
                offset = (start + bi) * block_length
                blocks.append(_build_sequences(
                    data[offset : offset + n], *fields[:, bi], n))
        return pack_frame(blocks)

    def _encode_fast_device(self, data: bytes) -> bytes:
        """Fast-mode encode with device match finding (16 KiB blocks)."""
        payloads, raws = self._device_chunk_payloads(data)
        return assemble_frame(payloads, raws, len(data), TPU_BLOCK_LOG)

    def _device_fast_encode(self, blocks: torch.Tensor, lengths: torch.Tensor):
        """Matcher + compactor: (B, P) uint8 blocks + (B,) int32 lengths on
        the device → the compacted ``(positions, len << pos_bits | dist,
        counts)`` records.  ``matcher="fused"`` runs ``match_candidates``
        and ``parse_candidates`` (K2 and K10 on a CUDA device, their plain
        versions on the CPU); ``"sort"`` the sort matcher (its parse K10
        on a CUDA device)."""
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

    def block_payloads(self, blocks: np.ndarray, lengths: np.ndarray):
        """(B, P) uint8 blocks + (B,) int32 lengths → the B fast-mode
        payloads: device match and compaction, host emission in one native
        call.

        Blocks go up as uint8, and only the compacted match records come
        back: ``max(counts)`` (pos, len·dist) int32 pairs per block instead
        of the 12·P-byte dense parse fields.  Blocks are independent, so
        any subset of a frame's blocks gives exactly those blocks' payloads
        (``parallel/lz4.py::multihost_fast_encode`` passes one process's)."""
        p = blocks.shape[1]
        pos_sorted, packed, counts = self._device_fast_encode(
            torch.from_numpy(blocks).to(self.device),
            torch.from_numpy(lengths).to(self.device),
        )
        records = fetch_records(pos_sorted, packed, counts, p)
        return native_backend().emit_blocks(
            blocks, lengths, *densify_records(*records, p)
        )

    def _device_chunk_payloads(self, data: bytes):
        """``block_payloads`` of consecutive ``TPU_BLOCK_LOG`` blocks;
        returns ``(payloads, raws)`` ready for frame assembly — shared by
        ``encode`` and ``encode_file(engine="device")``."""
        padded, lengths = pad_blocks_fast(data, TPU_BLOCK_LOG)
        data_u8 = padded.astype(np.uint8)
        raws = [
            data_u8[bi, : int(lengths[bi])].tobytes()
            for bi in range(data_u8.shape[0])
        ]
        return self.block_payloads(data_u8, lengths), raws

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
        native.  Fast mode only: the parity format caps inputs at 255
        blocks.  Returns the compressed size."""
        engine = self._engine(engine)
        if self.config.mode != "fast":
            raise ValueError("encode_file requires fast mode")
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
        """Decompress a parity or LZ4T frame (format auto-detected).

        ``"device"`` resolves the match chains on the codec's device: every
        LZ4T block's (``decode_fast_device``), or a parity frame's whole
        output by pointer doubling (``decode_frame_device``).  Otherwise
        parity frames decode on the host (``decode_frame_bytes``), and LZ4T
        frames with the C++ decoder (``"native"``, ``"auto"``) or the spec
        (``"python"``)."""
        engine = self._engine(engine)
        if not is_fast_frame(compressed):
            if engine == "device":
                return decode_frame_device(compressed, self.device)
            return decode_frame_bytes(compressed)
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


def _build_sequences(
    block: bytes,
    is_match: np.ndarray,
    emit_len: np.ndarray,
    emit_dist: np.ndarray,
    n: int,
) -> Block:
    """Parse flags → Sequence list (mirrors block_encode's emission,
    LZ4.c:516-613): each match closes the pending literal run; a trailing
    literal run becomes an offset-0 sequence."""
    seqs: List[Sequence] = []
    match_positions = np.nonzero(is_match[:n])[0]
    prev_end = 0
    for k in match_positions:
        k = int(k)
        seqs.append(
            Sequence(
                literals=block[prev_end:k],
                match_offset=int(emit_dist[k]),
                match_length=int(emit_len[k]),
            )
        )
        prev_end = k + int(emit_len[k])
    if prev_end < n:
        seqs.append(Sequence(block[prev_end:n], 0, 0))
    return Block(seqs)
