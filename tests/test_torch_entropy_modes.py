"""The per-block entropy mode and the rest of ``ops/huffman.py``, held
against the JAX package and the oracle.

Tolerance: identity everywhere (bitstrings, bytes and bit counts).  Inputs
are made from a seed with numpy and fed to both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.formats import jpeg_container as jax_container
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.native import native_backend as jax_native_backend
from lz4jpeg_tpu.ops import huffman as jax_huffman
from lz4jpeg_tpu.oracle import jpeg_oracle as jax_oracle

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    JPEGContainerError,
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.native import NativeBackend, native_backend
from lz4jpeg_tpu_torch.ops import huffman
from lz4jpeg_tpu_torch.oracle import jpeg_oracle

CHANNELS = ("lum", "r", "b")


def _noise(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("shape", [(16, 16), (24, 40)])
def test_per_block_bits_equal_jax_and_oracle(precision, shape):
    cfg = dict(precision=precision, entropy="per_block")
    img = _noise(sum(shape), *shape)
    enc = JPEGPipeline(JPEGConfig(**cfg), device="cpu").encode(img)
    jax_enc = JaxJPEGPipeline(JaxJPEGConfig(**cfg)).encode(img)
    _, ref = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
    assert enc.entropy_mode == "per_block" and not enc.rle_sparse16
    assert enc.per_block_bits == jax_enc.per_block_bits
    assert enc.per_block_bits == ref["huff_bits"]
    assert enc.compressed_bytes() == jax_enc.compressed_bytes()
    # Per-block trees are never serialized: the RLE arrays decode.
    rle, lengths = JPEGPipeline(JPEGConfig(**cfg), device="cpu").entropy_decode(enc)
    assert rle is enc.rle and lengths is enc.rle_lengths
    with pytest.raises(JPEGContainerError):
        pack_container(enc)


def test_per_block_decode_equals_jax():
    cfg = dict(precision="exact", entropy="per_block")
    img = _noise(5, 24, 16)
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(**cfg))
    assert np.array_equal(pipe.roundtrip(img), np.asarray(jax_pipe.roundtrip(img)))


def _crafted_pairs(rng, n=40, width=64):
    """Padded (n, width) int32 RLE symbol rows: random runs, a one-symbol
    block, a length-0 block, wide value ranges."""
    pairs = np.zeros((n, width), np.int32)
    lengths = np.zeros(n, np.int32)
    for i in range(n):
        runs = int(rng.integers(1, width // 2 + 1))
        counts = rng.integers(1, 4, size=runs)
        vals = rng.integers(-900, 900, size=runs)
        pairs[i, 0 : 2 * runs : 2] = counts
        pairs[i, 1 : 2 * runs : 2] = vals
        lengths[i] = 2 * runs
    pairs[1, :2], lengths[1] = (64, 5), 2
    lengths[2] = 0
    return pairs, lengths


def test_huff_per_block_binding_equals_jax():
    pairs, lengths = _crafted_pairs(np.random.default_rng(0))
    ours = native_backend().huff_per_block(pairs, lengths)
    assert ours == jax_native_backend().huff_per_block(pairs, lengths)
    assert ours[2] == ""  # an empty block (the oracle's heap needs a symbol)
    for i in np.nonzero(lengths)[0]:
        rle = [int(v) for v in pairs[i, : lengths[i]]]
        assert ours[i] == jax_oracle.encode_huffman_oracle(rle)[0]
    bad = lengths.copy()
    bad[3] = pairs.shape[1] + 2  # longer than the row: refused
    assert native_backend().huff_per_block(pairs, bad) is None
    assert jax_native_backend().huff_per_block(pairs, bad) is None


def test_per_block_refused_rows_take_the_oracle_tier():
    """Where the native pass refuses a block (a symbol outside its range),
    the pipeline runs the oracle per block, as the JAX pipeline does."""
    pipe = JPEGPipeline(JPEGConfig(precision="exact", entropy="per_block"), "cpu")
    enc = pipe.encode(_noise(9, 16, 16), entropy=False)
    enc.rle["lum"] = enc.rle["lum"].copy()
    enc.rle["lum"][0, 1] = 100_000
    assert native_backend().huff_per_block(enc.rle["lum"],
                                           enc.rle_lengths["lum"]) is None
    pipe.entropy_encode(enc)
    for i, bits in enumerate(enc.per_block_bits["lum"]):
        n = int(enc.rle_lengths["lum"][i])
        rle = [int(v) for v in enc.rle["lum"][i, :n]]
        assert bits == jax_oracle.encode_huffman_oracle(rle)[0]


@pytest.mark.parametrize("seed,n,lo,hi", [(0, 1000, -50, 50), (1, 257, 0, 10),
                                         (2, 1, 3, 4), (3, 4000, -2000, 2000)])
def test_codebook_and_packers_equal_jax(seed, n, lo, hi):
    symbols = np.random.default_rng(seed).integers(lo, hi, size=n).astype(np.int32)
    ours = huffman.build_canonical_codebook(symbols)
    theirs = jax_huffman.build_canonical_codebook(symbols)
    assert ours.serialize() == theirs.serialize()
    assert np.array_equal(ours.codes, theirs.codes)
    packed, nbits = huffman.pack_symbols(symbols, ours)
    assert (packed, nbits) == jax_huffman.pack_symbols(symbols, theirs)
    assert np.array_equal(huffman.unpack_symbols(packed, nbits, ours), symbols)
    pad_bits = ((nbits + 1023) // 1024 + 1) * 1024
    dev, dev_bits = huffman.pack_symbols_device(torch.from_numpy(symbols), ours,
                                                pad_bits)
    jax_dev, jax_bits = jax.jit(
        lambda s: jax_huffman.pack_symbols_device(s, theirs, pad_bits))(symbols)
    assert int(dev_bits) == int(jax_bits) == nbits
    assert dev.dtype == torch.uint8
    assert np.array_equal(dev.numpy(), np.asarray(jax_dev))
    assert dev.numpy()[: (nbits + 7) // 8].tobytes() == packed


def test_pack_symbols_device_truncated_prefix():
    """A capacity below the stream keeps the prefix and reports the full
    bit count (the caller's cue to re-pack)."""
    symbols = np.random.default_rng(4).integers(-40, 40, size=500).astype(np.int32)
    cb = huffman.build_canonical_codebook(symbols)
    jax_cb = jax_huffman.build_canonical_codebook(symbols)
    packed, total = huffman.pack_symbols_device(torch.from_numpy(symbols), cb, 64)
    jax_packed, jax_total = jax_huffman.pack_symbols_device(symbols, jax_cb, 64)
    assert int(total) == int(jax_total) > 64
    assert np.array_equal(packed.numpy(), np.asarray(jax_packed))
    full, _ = huffman.pack_symbols(symbols, cb)
    assert packed.numpy().tobytes() == full[:8]
    empty, zero = huffman.pack_symbols_device(torch.zeros(0, dtype=torch.int32),
                                              cb, 16)
    assert int(zero) == 0 and not empty.any() and empty.shape == (2,)
    with pytest.raises(ValueError):
        huffman.pack_symbols_device(torch.from_numpy(symbols), cb, 12)


def test_concat_bitstreams_equals_jax():
    rng = np.random.default_rng(6)
    pieces = []
    for nbits in (0, 1, 7, 8, 13, 64, 3):
        data = rng.integers(0, 256, size=(nbits + 7) // 8, dtype=np.uint8)
        if nbits % 8:
            data[-1] &= (0xFF << (8 - nbits % 8)) & 0xFF
        pieces.append((data.tobytes(), nbits))
    assert huffman.concat_bitstreams(pieces) == jax_huffman.concat_bitstreams(pieces)
    with pytest.raises(ValueError):
        huffman.concat_bitstreams([(b"\x00", 9)])


def test_per_block_refuses_16_bit_layouts():
    """A per-block pipeline writes int32 pairs; sparse16 and packed16
    encodes (from a shared pipeline) are refused, not misread as pairs."""
    shared = JPEGPipeline(JPEGConfig(), device="cpu")
    parity = JPEGPipeline(JPEGConfig(entropy="per_block"), device="cpu")
    sparse = shared.encode(_noise(7, 16, 16), entropy=False)
    (packed,) = shared.to_packed16([sparse])
    for enc in (sparse, packed):
        with pytest.raises(ValueError, match="int32 pair"):
            parity.entropy_encode(enc)


@pytest.mark.parametrize("kwargs", [
    {},
    {"mcu_size": 8},
    {"mcu_size": 16, "quality": 90},
    {"precision": "exact", "entropy": "per_block"},
    {"quality": 1, "entropy": "shared"},
])
def test_jpeg_config_carries_the_jax_fields(kwargs):
    assert dataclasses.asdict(JPEGConfig(**kwargs)) == dataclasses.asdict(
        JaxJPEGConfig(**kwargs))
    assert [f.name for f in dataclasses.fields(JPEGConfig)] == [
        f.name for f in dataclasses.fields(JaxJPEGConfig)]


@pytest.mark.parametrize("seed,n,lo,hi", [(0, 1000, -50, 50), (1, 257, 0, 10),
                                         (2, 1, 3, 4), (3, 4000, -2000, 2000),
                                         (4, 3000, -3, 3)])
def test_unpack_symbols_runs_the_native_walker_as_jax(seed, n, lo, hi,
                                                      monkeypatch):
    """Generated streams: the native walk, the JAX package's and the Python
    spec give the same symbols, and ``unpack_symbols`` reached the binding."""
    rng = np.random.default_rng(seed)
    symbols = rng.integers(lo, hi, size=n).astype(np.int32)
    cb = huffman.build_canonical_codebook(symbols)
    packed, nbits = huffman.pack_symbols(symbols, cb)
    calls = []
    native_unpack = NativeBackend.huff_unpack
    monkeypatch.setattr(NativeBackend, "huff_unpack",
                        lambda self, *a: calls.append(1) or native_unpack(self, *a))
    got = huffman.unpack_symbols(packed, nbits, cb)
    assert calls == [1]
    assert got.dtype == np.int32 and np.array_equal(got, symbols)
    assert np.array_equal(got, jax_huffman.unpack_symbols(packed, nbits, cb))
    assert np.array_equal(got, huffman.unpack_symbols_spec(packed, nbits, cb))
    assert np.array_equal(
        native_backend().huff_unpack(packed, nbits, cb.lengths, cb.symbols),
        jax_native_backend().huff_unpack(packed, nbits, cb.lengths, cb.symbols))


def _corrupt_stream(kind):
    """(codebook, bytes, bits) of a luma stream that is valid for two 8×8
    blocks but for ``kind``: codes 64 → 0, 5 → 10, 9 → 11 over 6 bits."""
    cb = huffman.build_canonical_codebook(np.array([64, 5, 64, 9], np.int32))
    packed, nbits = huffman.pack_symbols(np.array([64, 5, 64, 9], np.int32), cb)
    assert nbits == 6
    if kind == "trailing_bits":
        return cb, packed, nbits - 1  # ends inside the code 11
    return cb, packed, 8 * len(packed) + 3  # the bit count passes the buffer


@pytest.mark.parametrize("kind", ["trailing_bits", "bits_past_buffer"])
def test_corrupt_streams_raise_what_jax_raises(kind):
    """The same exception type as the JAX package's ``unpack_symbols``, and a
    container error from both containers."""
    cb, packed, nbits = _corrupt_stream(kind)
    with pytest.raises(Exception) as theirs:
        jax_huffman.unpack_symbols(packed, nbits, cb)
    with pytest.raises(Exception) as ours:
        huffman.unpack_symbols(packed, nbits, cb)
    assert type(ours.value) is type(theirs.value)
    assert type(ours.value) is (RuntimeError if kind == "trailing_bits"
                                else ValueError)
    with pytest.raises(ValueError):
        huffman.unpack_symbols_spec(packed, nbits, cb)

    enc = JPEGPipeline(JPEGConfig(), device="cpu").encode(_noise(11, 8, 16))
    enc.shared_streams["lum"] = (cb, packed, nbits)
    data = pack_container(enc)
    with pytest.raises(jax_container.JPEGContainerError):
        jax_container.unpack_container(data)
    with pytest.raises(JPEGContainerError):
        unpack_container(data)
