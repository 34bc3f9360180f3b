"""The host entropy runtime: ctypes bindings of three native functions.

The C++ source is the JAX package's own ``lz4jpeg_tpu/native/lz4core.cpp``,
compiled here with the flags of its Makefile (``native/Makefile:3``) into
the port's build directory, so both packages run the same entropy code and
write byte-identical containers.  The bindings are copies of
``lz4jpeg_tpu/native/__init__.py`` (same argtypes); the port binds only the
sparse16 walkers of its main path.  A failed build raises (no Python
fallback): ``tests/test_torch_container.py`` holds the results equal to the
JAX package's.
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
