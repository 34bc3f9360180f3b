"""Entropy stage and TJPG container, held against the JAX package.

* ``pack_container`` bytes of the port's CPU ``encode`` / ``encode_batch``
  equal the JAX package's, for aligned and ragged images (the forward
  buffers are bit-identical on the CPU and both packages run the same
  native entropy code).
* Containers cross-decode both ways.  Decoded RGB against the JAX decode:
  max |Δ| ≤ 3 with at most 2e-3 of pixels differing — the JAX package's
  own fast-path envelope (its inverse einsum sums in another order than
  torch's, which moves a few pixels by ±1 at the round-half boundary and
  up to ±3 after the color merge).
* The port's native hist / pack / unpack bindings give the same arrays
  and bytes as ``lz4jpeg_tpu.native`` on the same buffer.
"""

import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.formats import jpeg_container as jax_container
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.native import native_backend as jax_native_backend
from lz4jpeg_tpu.ops.huffman import (
    build_canonical_codebook_from_counts as jax_build_codebook,
)

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.fast_frame import content_checksum16
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    JPEGContainerError,
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.huffman import (
    CanonicalCodebook,
    build_canonical_codebook_from_counts,
)

SHAPES = [(64, 64), (37, 53), (40, 24), (8, 8), (1, 1)]


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _pipes(quality=None):
    return (
        JaxJPEGPipeline(JaxJPEGConfig(quality=quality)),
        JPEGPipeline(JPEGConfig(quality=quality), device="cpu"),
    )


def _assert_envelope(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert a.shape == b.shape
    assert diff.max() <= 3
    assert (diff != 0).mean() <= 2e-3


@pytest.mark.parametrize("shape", SHAPES)
def test_container_bytes_equal(shape):
    jax_pipe, pipe = _pipes()
    rgb = _image(*shape, seed=shape[0])
    assert pack_container(pipe.encode(rgb)) == jax_container.pack_container(
        jax_pipe.encode(rgb)
    )


def test_container_bytes_equal_scaled_quality():
    jax_pipe, pipe = _pipes(quality=75)
    rgb = _image(48, 40, seed=75)
    ours = pack_container(pipe.encode(rgb))
    assert ours == jax_container.pack_container(jax_pipe.encode(rgb))
    assert ours[5] == 75  # the header's quality byte


def test_encode_batch_bytes_equal():
    jax_pipe, pipe = _pipes()
    rgbs = np.stack([_image(24, 40, seed=s) for s in range(3)])
    ours = [pack_container(e) for e in pipe.encode_batch(rgbs)]
    theirs = [jax_container.pack_container(e) for e in jax_pipe.encode_batch(rgbs)]
    assert ours == theirs
    # One batch launch equals three single encodes.
    assert ours == [pack_container(pipe.encode(f)) for f in rgbs]


@pytest.mark.parametrize("shape", SHAPES)
def test_cross_decode(shape):
    jax_pipe, pipe = _pipes()
    rgb = _image(*shape, seed=100 + shape[1])
    ours = pack_container(pipe.encode(rgb))
    theirs = jax_container.pack_container(jax_pipe.encode(rgb))
    ref = jax_pipe.decode(jax_container.unpack_container(theirs))
    # JAX container → port decode, port container → JAX decode.
    _assert_envelope(pipe.decode(unpack_container(theirs)), ref)
    _assert_envelope(jax_pipe.decode(jax_container.unpack_container(ours)), ref)
    assert pipe.decode(unpack_container(ours)).shape == rgb.shape


def test_decode_batch_and_roundtrip():
    jax_pipe, pipe = _pipes()
    rgbs = np.stack([_image(32, 24, seed=s) for s in (1, 2)])
    encs = [unpack_container(pack_container(e)) for e in pipe.encode_batch(rgbs)]
    ours = pipe.decode_batch(encs)
    theirs = jax_pipe.decode_batch(jax_pipe.encode_batch(rgbs))
    for a, b in zip(ours, theirs):
        _assert_envelope(a, np.asarray(b))
    assert np.array_equal(pipe.roundtrip(rgbs[0]), ours[0])


def test_entropy_decode_restores_combined():
    _, pipe = _pipes()
    enc = pipe.encode(_image(40, 56, seed=3))
    before = enc.rle_combined.copy()
    enc.rle_combined = None
    pipe.entropy_decode(enc)
    assert np.array_equal(enc.rle_combined, before)
    assert enc.compressed_bytes() > 0


def test_decode_rejects_other_quality():
    _, pipe = _pipes()
    enc = JPEGPipeline(JPEGConfig(quality=75), device="cpu").encode(_image(8, 8, 1))
    with pytest.raises(ValueError, match="quality"):
        pipe.decode(enc)


def _combined_buffer(seed=0):
    _, pipe = _pipes()
    return pipe.encode(_image(48, 64, seed), entropy=False).rle_combined


@pytest.mark.parametrize("channel,col,row_len", [("lum", 0, 64), ("r", 64, 32),
                                                 ("b", 96, 32)])
def test_native_bindings_match_jax(channel, col, row_len):
    comb = _combined_buffer()
    ours, theirs = native_backend(), jax_native_backend()
    counts, lens, total = ours.rle_symbol_hist_sparse16(comb, col, row_len, 2048, 4096)
    j_counts, j_lens, j_total = theirs.rle_symbol_hist_sparse16(
        comb, col, row_len, 2048, 4096
    )
    assert np.array_equal(counts, j_counts) and np.array_equal(lens, j_lens)
    assert total == j_total
    (bins,) = np.nonzero(counts)
    cb = build_canonical_codebook_from_counts(bins - 2048, counts[bins])
    j_cb = jax_build_codebook(bins - 2048, counts[bins])
    assert cb.serialize() == j_cb.serialize()
    packed = ours.huff_pack_sparse16(comb, col, row_len, cb, total)
    assert packed == theirs.huff_pack_sparse16(comb, col, row_len, j_cb, total)
    out = ours.huff_unpack_sparse16(packed[0], packed[1], cb, row_len,
                                    comb.shape[0])
    j_out = theirs.huff_unpack_sparse16(packed[0], packed[1], j_cb, row_len,
                                        comb.shape[0])
    assert np.array_equal(out[0], j_out[0]) and np.array_equal(out[1], j_out[1])
    assert np.array_equal(out[0], comb[:, col : col + row_len])


def test_codebook_serialization_round_trip():
    rng = np.random.default_rng(4)
    values = np.unique(rng.integers(-500, 500, size=60))
    cb = build_canonical_codebook_from_counts(values, rng.integers(1, 1000, size=len(values)))
    back, end = CanonicalCodebook.deserialize(cb.serialize())
    assert end == len(cb.serialize())
    for a, b in ((back.symbols, cb.symbols), (back.lengths, cb.lengths),
                 (back.codes, cb.codes)):
        assert np.array_equal(a, b)
    single = build_canonical_codebook_from_counts(np.array([7]), np.array([3]))
    assert single.lengths.tolist() == [1]


def test_checksum_matches_jax():
    from lz4jpeg_tpu.formats.fast_frame import content_checksum16 as jax_checksum

    for data in (b"", b"x", bytes(range(256)) * 9):
        assert content_checksum16(data) == jax_checksum(data)
        assert content_checksum16(data, 12345) == jax_checksum(data, 12345)


def test_corrupt_containers_raise():
    _, pipe = _pipes()
    data = pack_container(pipe.encode(_image(16, 16, seed=8)))
    flipped = bytearray(data)
    flipped[-1] ^= 0x10
    for bad in (data[:10], b"XXXX" + data[4:], bytes(flipped), data + b"\0"):
        with pytest.raises(JPEGContainerError):
            unpack_container(bad)


def test_non_canonical_stream_raises_typed_error():
    """A run longer than its one-block image ([65, 0]) passes no tier: the
    sparse16 and packed16 walkers refuse a count of 65, the native int32
    walker a pair past the last block, and the Python re-blocking indexes
    past it.  The JAX container raises JPEGContainerError for it; so does
    the port's."""
    _, pipe = _pipes()
    enc = pipe.encode(_image(8, 8, seed=9))
    cb = CanonicalCodebook(np.array([0, 65], np.int32), np.array([1, 1], np.uint8),
                           np.array([0, 1], np.uint32))
    enc.shared_streams["lum"] = (cb, bytes([0b10000000]), 2)  # [65, 0]
    data = pack_container(enc)
    with pytest.raises(jax_container.JPEGContainerError, match="'lum'"):
        jax_container.unpack_container(data)
    with pytest.raises(JPEGContainerError, match="'lum'"):
        unpack_container(data)
