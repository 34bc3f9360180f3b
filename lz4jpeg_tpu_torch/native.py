"""The host runtime: ctypes bindings of twenty native functions.

The C++ source is the JAX package's own ``lz4jpeg_tpu/native/lz4core.cpp``,
compiled here with the flags of its Makefile (``native/Makefile:3``) into
the port's build directory, so both packages run the same host code and
write byte-identical containers and frames.  The bindings are copies of
``lz4jpeg_tpu/native/__init__.py`` (same argtypes): the sparse16, int32-pair
and packed16 entropy walkers of the JPEG path (histogram, pack, unpack for
each layout), the codeword packer of ``pack_symbols`` and the walker of
``unpack_symbols``, the per-block parity
Huffman (``huff_per_block``), the parity-frame encoder (``encode_parity``),
and the LZ4T fast encoder/decoder, one-block and batched block emitters,
chunk codec and device-decode copy-program builder.  A failed
build raises (no Python fallback; the Python spec paths are reached only
through ``engine="python"``): ``tests/test_torch_container.py`` and
``tests/test_torch_lz4_frame.py`` and ``tests/test_torch_lz4_parity.py``
hold the results equal to the JAX package's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from lz4jpeg_tpu_torch.kernels.build import PACKAGE_DIR, build_library

SOURCE = PACKAGE_DIR.parent / "lz4jpeg_tpu" / "native" / "lz4core.cpp"
# native/Makefile:3 (CXXFLAGS) plus -shared from its link rule.
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra")


class NativeBackend:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.lz4_encode_fast.restype = ctypes.c_ssize_t
        lib.lz4_encode_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4_decode_fast.restype = ctypes.c_ssize_t
        lib.lz4_decode_fast.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4_encode_parity.restype = ctypes.c_ssize_t
        lib.lz4_encode_parity.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_size_t,
        ]
        lib.lz4t_emit_block.restype = ctypes.c_ssize_t
        lib.lz4t_emit_block.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4t_emit_blocks.restype = ctypes.c_int64
        lib.lz4t_emit_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.lz4t_encode_chunk.restype = ctypes.c_int64
        lib.lz4t_encode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.lz4t_decode_chunk.restype = ctypes.c_int64
        lib.lz4t_decode_chunk.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.lz4t_build_copy_program.restype = ctypes.c_int64
        lib.lz4t_build_copy_program.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.rle_symbol_hist_sparse16.restype = ctypes.c_int64
        lib.rle_symbol_hist_sparse16.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.huff_pack_sparse16.restype = ctypes.c_int64
        lib.huff_pack_sparse16.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.huff_unpack_sparse16.restype = ctypes.c_int64
        lib.huff_unpack_sparse16.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.huff_pack.restype = ctypes.c_ssize_t
        lib.huff_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.huff_unpack.restype = ctypes.c_ssize_t
        lib.huff_unpack.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.huff_per_block_ascii.restype = ctypes.c_int64
        lib.huff_per_block_ascii.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        # The pair layouts: int32 (N, 2L) pairs and packed16 (N, L) words
        # take the same arguments.
        for suffix in ("", "16"):
            hist = getattr(lib, f"rle_symbol_hist{suffix}")
            hist.restype = ctypes.c_int64
            hist.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_size_t,
            ]
            pack = getattr(lib, f"huff_pack_pairs{suffix}")
            pack.restype = ctypes.c_int64
            pack.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ]
            unpack = getattr(lib, f"huff_unpack_pairs{suffix}")
            unpack.restype = ctypes.c_int64
            unpack.argtypes = [
                ctypes.c_char_p, ctypes.c_uint64,
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p,
            ]

    def encode_fast(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(len(data) + len(data) // 32 + 4096)
        n = self._lib.lz4_encode_fast(data, len(data), out, len(out))
        if n < 0:
            raise RuntimeError(f"native fast encode failed ({n})")
        return out.raw[:n]

    def decode_fast(self, data: bytes, max_out: int) -> bytes:
        out = ctypes.create_string_buffer(max_out)
        n = self._lib.lz4_decode_fast(data, len(data), out, len(out))
        if n < 0:
            raise RuntimeError(f"native fast decode failed ({n})")
        return out.raw[:n]

    def encode_parity(self, data: bytes, block_length: int = 300) -> bytes:
        """The reference's parity frame of ``data`` in one C++ pass (the
        same parse as ``LZ4Codec(LZ4Config(mode="parity"))``)."""
        out = ctypes.create_string_buffer(2 * len(data) + 65536)
        n = self._lib.lz4_encode_parity(
            data, len(data), out, len(out), block_length
        )
        if n < 0:
            raise RuntimeError(f"native parity encode failed ({n})")
        return out.raw[:n]

    def emit_block(self, data: bytes, is_match, emit_len, emit_dist) -> bytes:
        """LZ4T payload of one block from its parse arrays (numpy
        uint8/int32/int32, one entry per byte of ``data``)."""
        is_match = np.ascontiguousarray(is_match, np.uint8)
        emit_len = np.ascontiguousarray(emit_len, np.int32)
        emit_dist = np.ascontiguousarray(emit_dist, np.int32)
        if not len(is_match) == len(emit_len) == len(emit_dist) == len(data):
            raise ValueError("parse arrays must have one entry per byte")
        out = ctypes.create_string_buffer(len(data) + len(data) // 128 + 64)
        n = self._lib.lz4t_emit_block(
            data, len(data),
            is_match.tobytes(),
            emit_len.ctypes.data, emit_dist.ctypes.data,
            out, len(out),
        )
        if n < 0:
            raise RuntimeError(f"native block emit failed ({n})")
        return out.raw[:n]

    def emit_blocks(self, data, lengths, is_match, emit_len, emit_dist):
        """Batched LZ4T payloads from (B, P) parse arrays — one native call.

        ``data`` is the padded (B, P) uint8 block matrix; ``lengths`` the
        valid prefix per row.  Returns a list of B payload ``bytes``.
        """
        data = np.ascontiguousarray(data, np.uint8)
        b, p = data.shape
        lengths = np.ascontiguousarray(lengths, np.int32)
        is_match = np.ascontiguousarray(is_match, np.uint8)
        emit_len = np.ascontiguousarray(emit_len, np.int32)
        emit_dist = np.ascontiguousarray(emit_dist, np.int32)
        cap = int(lengths.astype(np.int64).sum()) + b * (p // 128 + 64)
        out = ctypes.create_string_buffer(cap)
        sizes = np.zeros(b, np.int64)
        total = self._lib.lz4t_emit_blocks(
            data.ctypes.data_as(ctypes.c_char_p), b, p,
            lengths.ctypes.data,
            is_match.ctypes.data_as(ctypes.c_char_p),
            emit_len.ctypes.data, emit_dist.ctypes.data,
            out, cap, sizes.ctypes.data,
        )
        if total < 0:
            raise RuntimeError(f"native batched emit failed ({total})")
        buf = out.raw[:total]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        return [buf[offsets[i] : offsets[i + 1]] for i in range(b)]

    def encode_chunk(self, data: bytes, block_log: int):
        """Compress a chunk as consecutive 2**block_log blocks in one
        native call (the streaming ``encode_file`` granularity).  Returns
        ``(payload_bytes, size_records uint32[count])`` with RAW_FLAG
        semantics matching the frame writer."""
        block_size = 1 << block_log
        count = max(0, -(-len(data) // block_size))
        sizes = np.zeros(max(count, 1), np.uint32)
        cap = len(data) + count * (block_size // 255 + 64) + 64
        out = ctypes.create_string_buffer(cap)
        n = self._lib.lz4t_encode_chunk(
            data, len(data), block_log, out, cap, sizes.ctypes.data
        )
        if n < 0:
            raise RuntimeError(f"native chunk encode failed ({n})")
        return out.raw[:n], sizes[:count]

    def decode_chunk(
        self, payloads: bytes, recs, block_log: int, raw_total: int
    ) -> bytes:
        """Decode consecutive block payloads in one native call (the
        streaming ``decode_file`` granularity; no per-block sub-frames)."""
        recs = np.ascontiguousarray(recs, np.uint32)
        out = ctypes.create_string_buffer(max(raw_total, 1))
        n = self._lib.lz4t_decode_chunk(
            payloads, len(payloads),
            recs.ctypes.data, len(recs), block_log,
            raw_total, out, max(raw_total, 1),
        )
        if n < 0:
            raise RuntimeError(f"native chunk decode failed ({n})")
        return out.raw[:n]

    def build_copy_program(
        self, frame: bytes, block_count: int, block_size: int,
        depth_cap: int = 4,
    ):
        """LZ4T frame → device-decode copy program.

        Returns ``(lit (B, P) uint8, src (B, P) int32, raw_sizes (B,) int64,
        max_depth int)`` with ``src == -1`` at literal positions; chains
        deeper than ``depth_cap`` are pre-rooted host-side.  See
        ``lz4core.cpp::lz4t_build_copy_program``."""
        lit = np.zeros((block_count, block_size), np.uint8)
        src = np.full((block_count, block_size), -1, np.int32)
        sizes = np.zeros(block_count, np.int64)
        depth = np.zeros(1, np.int64)
        got = self._lib.lz4t_build_copy_program(
            frame, len(frame),
            lit.ctypes.data, src.ctypes.data, sizes.ctypes.data,
            depth_cap, depth.ctypes.data,
        )
        if got != block_count:
            raise RuntimeError(f"native copy-program build failed ({got})")
        return lit, src, sizes, int(depth[0])

    def rle_symbol_hist_sparse16(
        self, sparse, col_off: int, row_len: int, offset: int, nbins: int
    ):
        """Symbol histogram over one channel of a sparse-delta buffer,
        walked in place: ``sparse`` is the (N, stride) uint16 combined
        array and ``col_off``/``row_len`` select the channel lanes.  Returns
        (counts int64[nbins], per-block symbol lengths, total symbols)."""
        sparse = np.ascontiguousarray(sparse, np.uint16)
        counts = np.zeros(nbins, np.int64)
        out_lengths = np.zeros(sparse.shape[0], np.int32)
        total = self._lib.rle_symbol_hist_sparse16(
            sparse.ctypes.data, sparse.shape[0], row_len, sparse.shape[1],
            col_off, offset, counts.ctypes.data, nbins,
            out_lengths.ctypes.data,
        )
        if total < 0:
            raise RuntimeError(f"native sparse16 hist failed ({total})")
        return counts, out_lengths, int(total)

    def huff_pack_sparse16(
        self, sparse, col_off: int, row_len: int, codebook, total_symbols: int
    ) -> tuple:
        """Map + MSB-first pack one channel of a sparse-delta combined
        buffer through a CanonicalCodebook.  Returns (packed bytes, bits)."""
        sparse = np.ascontiguousarray(sparse, np.uint16)
        base = int(codebook.symbols.min())
        size = int(codebook.symbols.max()) - base + 1
        lut_codes = np.zeros(size, np.uint32)
        lut_lens = np.zeros(size, np.uint8)
        lut_codes[codebook.symbols - base] = codebook.codes
        lut_lens[codebook.symbols - base] = codebook.lengths
        cap = total_symbols * 4 + 16  # ≤32 bits per symbol
        out = ctypes.create_string_buffer(cap)
        nbits = ctypes.c_uint64(0)
        n = self._lib.huff_pack_sparse16(
            sparse.ctypes.data, sparse.shape[0], row_len, sparse.shape[1],
            col_off, base,
            lut_codes.ctypes.data, lut_lens.ctypes.data, size,
            out, cap, ctypes.byref(nbits),
        )
        if n < 0:
            raise RuntimeError(f"native sparse16 pack failed ({n})")
        return out.raw[:n], int(nbits.value)

    def huff_pack(self, codes, lengths) -> tuple:
        """(uint32 codes, uint8 lengths) → (MSB-first packed bytes, total
        bits)."""
        codes = np.ascontiguousarray(codes, np.uint32)
        lengths = np.ascontiguousarray(lengths, np.uint8)
        cap = int(lengths.astype(np.int64).sum()) // 8 + 8
        out = ctypes.create_string_buffer(cap)
        nbits = self._lib.huff_pack(
            codes.ctypes.data, lengths.tobytes(), len(codes), out, cap
        )
        if nbits < 0:
            raise RuntimeError(f"native huffman pack failed ({nbits})")
        return out.raw[: (nbits + 7) // 8], int(nbits)

    def huff_unpack(self, packed: bytes, nbits: int, lengths, symbols):
        """Canonical Huffman decode of ``nbits`` bits through a codebook's
        (uint8 lengths, int32 symbols) → int32 symbols.  Raises
        ``RuntimeError`` where the walker rejects the stream (trailing bits
        that form no codeword, a code longer than 32 bits); the caller
        checks ``nbits`` against the buffer first."""
        lengths = np.ascontiguousarray(lengths, np.uint8)
        symbols = np.ascontiguousarray(symbols, np.int32)
        out = np.empty(max(nbits, 1), np.int32)
        n = self._lib.huff_unpack(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            out.ctypes.data, len(out),
        )
        if n < 0:
            raise RuntimeError(f"native huffman unpack failed ({n})")
        return out[:n].copy()

    def huff_per_block(self, pairs, lengths):
        """Per-block parity Huffman (the reference's JPEG.c:844-1097, with
        the oracle's quirk-exact heap): padded (N, W) int32 RLE symbols +
        (N,) valid lengths → N ASCII '0'/'1' bitstrings, in one C++ pass.
        Returns None on input the native pass refuses (a length outside
        [0, W] or a symbol outside its range): the caller then runs the
        oracle's ``encode_huffman_oracle``, as the JAX pipeline does."""
        pairs = np.ascontiguousarray(pairs, np.int32)
        lengths = np.ascontiguousarray(lengths, np.int32)
        n, w = pairs.shape
        # ≤ ~32 bits per symbol is the practical worst case, but the quirky
        # heap can emit code lengths up to (#unique − 1) ≤ 127 for wide
        # blocks: on output-full (-1) retry with a doubled buffer.
        cap = int(lengths.astype(np.int64).sum()) * 64 + 1024
        counts = np.zeros(n, np.int64)
        total = -1
        for _ in range(3):
            out = ctypes.create_string_buffer(cap)
            total = self._lib.huff_per_block_ascii(
                pairs.ctypes.data, lengths.ctypes.data, n, w,
                out, cap, counts.ctypes.data,
            )
            if total != -1:  # success, or bad input (-2): stop retrying
                break
            cap *= 2
        if total < 0:
            return None
        buf = out.raw[:total].decode("ascii")
        offsets = np.concatenate([[0], np.cumsum(counts)])
        return [buf[offsets[i] : offsets[i + 1]] for i in range(n)]

    def _hist(self, fn, rows, dtype, lengths, offset: int, nbins: int):
        rows = np.ascontiguousarray(rows, dtype)
        lengths = np.ascontiguousarray(lengths, np.int32)
        counts = np.zeros(nbins, np.int64)
        total = fn(
            rows.ctypes.data, lengths.ctypes.data,
            rows.shape[0], rows.shape[1], offset,
            counts.ctypes.data, nbins,
        )
        if total < 0:
            raise RuntimeError(f"native symbol hist failed ({total})")
        return counts, int(total)

    def rle_symbol_hist(self, pairs, lengths, offset: int, nbins: int):
        """Histogram of the valid symbols of padded (N, 2L) int32 RLE pairs,
        shifted by ``offset`` into [0, nbins).  Returns (counts int64[nbins],
        total symbols)."""
        return self._hist(self._lib.rle_symbol_hist, pairs, np.int32,
                          lengths, offset, nbins)

    def rle_symbol_hist16(self, packed, lengths, offset: int, nbins: int):
        """``rle_symbol_hist`` over (N, L) packed16 words (one uint16 per
        [count, value] pair; lengths still count symbols)."""
        return self._hist(self._lib.rle_symbol_hist16, packed, np.uint16,
                          lengths, offset, nbins)

    def _pack(self, fn, rows, dtype, lengths, codebook) -> tuple:
        rows = np.ascontiguousarray(rows, dtype)
        lengths = np.ascontiguousarray(lengths, np.int32)
        base = int(codebook.symbols.min())
        size = int(codebook.symbols.max()) - base + 1
        lut_codes = np.zeros(size, np.uint32)
        lut_lens = np.zeros(size, np.uint8)  # 0 = unseen: the C++ refuses it
        lut_codes[codebook.symbols - base] = codebook.codes
        lut_lens[codebook.symbols - base] = codebook.lengths
        cap = int(lengths.astype(np.int64).sum()) * 4 + 16  # ≤32 bits/symbol
        out = ctypes.create_string_buffer(cap)
        nbits = ctypes.c_uint64(0)
        n = fn(
            rows.ctypes.data, lengths.ctypes.data,
            rows.shape[0], rows.shape[1], base,
            lut_codes.ctypes.data, lut_lens.ctypes.data, size,
            out, cap, ctypes.byref(nbits),
        )
        if n < 0:
            raise RuntimeError(f"native pair pack failed ({n})")
        return out.raw[:n], int(nbits.value)

    def huff_pack_pairs(self, pairs, lengths, codebook) -> tuple:
        """Map + MSB-first pack the valid symbols of padded (N, 2L) int32
        pairs through a CanonicalCodebook.  Returns (packed bytes, bits)."""
        return self._pack(self._lib.huff_pack_pairs, pairs, np.int32,
                          lengths, codebook)

    def huff_pack_pairs16(self, packed_pairs, lengths, codebook) -> tuple:
        """``huff_pack_pairs`` over (N, L) packed16 words."""
        return self._pack(self._lib.huff_pack_pairs16, packed_pairs,
                          np.uint16, lengths, codebook)

    def _unpack(self, fn, dtype, packed: bytes, nbits: int, codebook,
                block_size: int, num_blocks: int, pad_width: int):
        if (nbits + 7) // 8 > len(packed):
            raise ValueError(
                f"bit count {nbits} exceeds packed buffer of {len(packed)} bytes"
            )
        lengths = np.ascontiguousarray(codebook.lengths, np.uint8)
        symbols = np.ascontiguousarray(codebook.symbols, np.int32)
        out_rows = np.zeros((num_blocks, pad_width), dtype)
        out_lengths = np.zeros(num_blocks, np.int32)
        n = fn(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            block_size, num_blocks, pad_width,
            out_rows.ctypes.data, out_lengths.ctypes.data,
        )
        if n < 0:
            return None
        return out_rows, out_lengths

    def huff_unpack_pairs(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int, pad_width: int,
    ):
        """Canonical decode + re-blocking into (N, pad_width) int32 pairs: a
        pair belongs to the block where its running count total lands.
        Returns (pairs, lengths), or None when the strict walker rejects the
        stream."""
        return self._unpack(self._lib.huff_unpack_pairs, np.int32, packed,
                            nbits, codebook, block_size, num_blocks, pad_width)

    def huff_unpack_pairs16(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int, pad_pairs: int,
    ):
        """Decode + re-block into (N, pad_pairs) packed16 words.  Returns
        (words uint16, lengths), or None when a pair does not fit the word
        (count > 64, |value| > 511 with -512 allowed) or the walker rejects
        the stream."""
        return self._unpack(self._lib.huff_unpack_pairs16, np.uint16, packed,
                            nbits, codebook, block_size, num_blocks, pad_pairs)

    def huff_unpack_sparse16(
        self, packed: bytes, nbits: int, codebook,
        block_size: int, num_blocks: int,
        out_sparse=None, col_off: int = 0,
    ):
        """Decode straight into the sparse-delta layout.

        ``out_sparse`` may be a pre-allocated zeroed (N, stride) uint16
        combined buffer to decode several channels in place; defaults to a
        fresh (N, block_size) array.  Returns (out_sparse, lengths), or None
        when the strict walker rejects the stream."""
        if (nbits + 7) // 8 > len(packed):
            raise ValueError(
                f"bit count {nbits} exceeds packed buffer of {len(packed)} bytes"
            )
        lengths = np.ascontiguousarray(codebook.lengths, np.uint8)
        symbols = np.ascontiguousarray(codebook.symbols, np.int32)
        if out_sparse is None:
            out_sparse = np.zeros((num_blocks, block_size), np.uint16)
        out_lengths = np.zeros(num_blocks, np.int32)
        n = self._lib.huff_unpack_sparse16(
            packed, nbits,
            lengths.tobytes(), symbols.ctypes.data, len(symbols),
            block_size, num_blocks, out_sparse.shape[1], col_off,
            out_sparse.ctypes.data, out_lengths.ctypes.data,
        )
        if n < 0:
            return None
        return out_sparse, out_lengths


@functools.lru_cache(maxsize=None)
def native_backend() -> NativeBackend:
    """Build ``lz4core.cpp`` into ``_build/`` at first use and bind it."""
    path = build_library("lz4core", SOURCE, ["g++", *CXXFLAGS, "-shared"])
    return NativeBackend(ctypes.CDLL(str(path)))
