"""The encode entry points: the overlapped (banded) encode, the bucketed
encode and decode, and ``warmup``, held against the one-shot paths and the
JAX package.

Tolerance: identity (container bytes, RLE arrays, lengths, decoded pixels),
except ``decode_bucketed`` of a fast sparse16 encode, which runs the staged
tile inverse where ``decode`` runs the folded one: there the fast-path
envelope (max |Δ| ≤ 3 on ≤ 2e-3 of pixels) holds, as between the JAX
package's two inverses.  Inputs are made from a seed with numpy.
"""

import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.formats.jpeg_container import pack_container as jax_pack
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container
from lz4jpeg_tpu_torch.native import native_backend

CHANNELS = ("lum", "r", "b")
CONFIGS = [{}, {"precision": "exact"}, {"quality": 90},
           {"precision": "exact", "entropy": "per_block"}]
SHAPES = [(8, 8), (16, 24), (40, 16), (24, 40), (37, 53), (9, 17)]


def _noise(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _banded(bands=4):
    pipe = JPEGPipeline(JPEGConfig(), device="cpu")
    pipe._OVERLAP_MIN_BLOCKS = 1  # engage the overlapped path
    pipe._OVERLAP_BANDS = bands
    return pipe


@pytest.mark.parametrize("shape,bands", [((48, 56), 4), ((8, 8), 4),
                                         ((37, 53), 4), ((64, 40), 3)])
def test_overlapped_encode_equals_one_shot_and_jax(shape, bands):
    img = _noise(sum(shape), *shape)
    one = JPEGPipeline(JPEGConfig(), device="cpu").encode_batch(img[None])[0]
    got = _banded(bands).encode(img)
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig())
    jax_pipe._OVERLAP_MIN_BLOCKS = 1
    jax_pipe._OVERLAP_BANDS = bands
    jax_got = jax_pipe.encode(img)
    assert pack_container(got) == pack_container(one) == jax_pack(jax_got)
    for c in CHANNELS:
        assert np.array_equal(got.rle[c], one.rle[c])
        assert np.array_equal(got.rle_lengths[c], one.rle_lengths[c])
        assert np.array_equal(got.rle_lengths[c], np.asarray(jax_got.rle_lengths[c]))
    assert np.array_equal(got.rle_combined, np.asarray(jax_got.rle_combined))


def test_overlapped_encode_takes_its_gate():
    """``encode`` takes the banded path only for sparse16, shared, entropy-on
    encodes of at least ``_OVERLAP_MIN_BLOCKS`` blocks; its stages report
    through ``mark`` in order."""
    img = _noise(1, 32, 32)  # 16 blocks
    pipe = JPEGPipeline(JPEGConfig(), device="cpu")
    calls = []
    pipe._encode_overlapped = lambda *a, **k: calls.append(a) or "banded"
    assert pipe.encode(img) != "banded"
    pipe._OVERLAP_MIN_BLOCKS = 16
    assert pipe.encode(img) == "banded" and len(calls) == 1
    assert pipe.encode(img, entropy=False) != "banded"
    exact = JPEGPipeline(JPEGConfig(precision="exact"), device="cpu")
    exact._OVERLAP_MIN_BLOCKS = 1
    exact._encode_overlapped = pipe._encode_overlapped
    assert exact.encode(img) != "banded" and len(calls) == 1
    marks = []
    x = _banded()._image(img)
    _banded()._encode_overlapped(x, 4, 4, marks.append)
    assert marks[0] == "forward" and marks[-1] == "concat"
    assert marks.count("wait") == marks.count("walk") == 4
    assert marks.count("pack") == 3


def test_overlapped_encode_keeps_earlier_encodes():
    """Each encode gets its own host buffer: a second encode leaves the
    first's streams and container as they were."""
    pipe = _banded()
    a, b = _noise(2, 48, 56), _noise(3, 48, 56)
    enc_a = pipe.encode(a)
    kept, data = enc_a.rle_combined.copy(), pack_container(enc_a)
    enc_b = pipe.encode(b)
    assert not np.array_equal(enc_b.rle_combined, kept)
    assert np.array_equal(enc_a.rle_combined, kept)
    assert pack_container(enc_a) == data
    assert np.array_equal(pipe.decode(enc_a), pipe.decode(
        JPEGPipeline(JPEGConfig(), device="cpu").encode(a)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "fast")
def test_encode_bucketed_equals_encode_and_jax(cfg):
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(**cfg))
    for i, shape in enumerate(SHAPES):
        img = _noise(10 + i, *shape)
        plain = pipe.encode(img, entropy=False)
        bucketed = pipe.encode_bucketed(img, entropy=False)
        jax_bucketed = jax_pipe.encode_bucketed(img, entropy=False)
        assert bucketed.rle_sparse16 == plain.rle_sparse16
        for c in CHANNELS:
            assert np.array_equal(bucketed.rle[c], plain.rle[c])
            assert np.array_equal(bucketed.rle[c], np.asarray(jax_bucketed.rle[c]))
        if plain.rle_lengths is not None:
            for c in CHANNELS:
                assert np.array_equal(bucketed.rle_lengths[c],
                                      plain.rle_lengths[c])
        full = pipe.encode_bucketed(img)
        if pipe.config.entropy == "shared":
            assert pack_container(full) == pack_container(pipe.encode(img))
        else:
            assert full.per_block_bits == pipe.encode(img).per_block_bits


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "fast")
def test_decode_bucketed_equals_decode_and_jax(cfg):
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(**cfg))
    for i, shape in enumerate(SHAPES):
        img = _noise(20 + i, *shape)
        enc = pipe.encode(img)
        got = pipe.decode_bucketed(enc)
        assert got.shape == img.shape and got.dtype == np.uint8
        want = pipe.decode(enc)
        if pipe.sparse16:
            diff = np.abs(got.astype(np.int32) - want)
            assert diff.max() <= 3 and (diff != 0).mean() <= 2e-3
        else:
            assert np.array_equal(got, want)
        assert np.array_equal(
            got, np.asarray(jax_pipe.decode_bucketed(jax_pipe.encode(img))))


@pytest.mark.parametrize("cfg", [{}, {"precision": "exact"}])
def test_warmup_builds_nothing_twice(cfg):
    native_backend.cache_clear()
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    pipe.warmup([(16, 24), (37, 53)])
    assert native_backend.cache_info().misses == 1
    hits = native_backend.cache_info().hits
    pipe.encode(_noise(4, 16, 24))
    pipe.encode(_noise(5, 37, 53))
    assert native_backend.cache_info().misses == 1
    assert native_backend.cache_info().hits > hits
