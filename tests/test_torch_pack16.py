"""The packed16 kernels' plain versions and the rest of ``ops/rle.py``, held
against the JAX package.

What the CPU wrappers of ``ops/pack16.py`` run (the plain versions of K4–K7)
must equal, exactly (all integers):

* the JAX Pallas kernels in interpret mode
  (``rle_encode_packed16_pallas``, ``_kt``, ``rle_decode_packed16_pallas``,
  ``_plane``), on the shapes of ``tests/test_pallas_rle.py``;
* the XLA specs ``rle_encode_packed16`` / ``rle_decode_packed16`` on shapes
  the TPU gates reject (N = 100, C = 96, bw = 40), on crafted rows (lengths
  shorter than the nonzero words, count sums below and above K, value -512
  with count 1, which packs to word 0) and on values ±511.

The torch ops of ``ops/rle.py`` equal their JAX namesakes on the same
seeded numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops import pallas_rle as jax_pallas
from lz4jpeg_tpu.ops import rle as jax_rle

from lz4jpeg_tpu_torch.ops import pack16, rle
from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows


def _runny(rng, n, k):
    """(n, k) int16 values in ±511, every other row made of 8-long runs."""
    vals = rng.integers(-511, 512, size=(n, k)).astype(np.int16)
    rep = np.repeat(rng.integers(-511, 512, size=(n, (k + 7) // 8)), 8, axis=1)
    vals[::2] = rep[::2, :k]
    return vals


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _words(p: torch.Tensor) -> np.ndarray:
    return p.numpy().view(np.uint16)


def _spec_encode(vals):
    p, l = jax_rle.rle_encode_packed16(jnp.asarray(vals))
    return np.asarray(p), np.asarray(l)


def _spec_decode(words, lengths, out_size):
    return np.asarray(jax_rle.rle_decode_packed16(
        jnp.asarray(words), jnp.asarray(lengths), out_size))


def _crafted(k, rng):
    """``crafted_packed16_rows`` as uint16 words for the JAX spec."""
    words, lengths = crafted_packed16_rows(k, rng)
    return words.view(np.uint16), lengths


# ---- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("n,k,runny", [(517, 64, False), (300, 32, True),
                                       (7, 64, True)])
def test_k4_plain_matches_pallas(n, k, runny):
    rng = np.random.default_rng(n + k)
    vals = (_runny(rng, n, k) if runny
            else rng.integers(-511, 512, size=(n, k)).astype(np.int16))
    p, l = jax_pallas.rle_encode_packed16_pallas(jnp.asarray(vals), interpret=True)
    got_p, got_l = pack16.pack16_encode(_t(vals))
    assert np.array_equal(_words(got_p), np.asarray(p))
    assert np.array_equal(got_l.numpy(), np.asarray(l))


def _edge_blocks(k):
    vals = np.zeros((8, k), np.int32)
    vals[1] = 7                          # one nonzero run
    vals[2, ::2] = 1                     # alternating: k runs
    vals[3] = np.arange(k) - k // 2      # all distinct
    vals[4, -1] = -511
    vals[5, 0] = 511
    vals[6] = np.where(np.arange(k) % 3, 511, -511)
    vals[7, : k // 2] = -511
    return vals


def _offset_view(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a view that starts one element past its buffer's
    start (off a 16-byte boundary on the card)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


@pytest.mark.parametrize("n", [100, 1, 3, 17, 130])
@pytest.mark.parametrize("k", [64, 32, 16, 8, 2, 1])
def test_k4_plain_matches_spec(n, k):
    """Row counts the TPU wrapper had to pad (N = 100) and counts that are no
    multiple of the kernel's rows per warp step (17, 130), narrow segments,
    the value limits ±511; int16 and int32 inputs, also as offset views."""
    rng = np.random.default_rng(n * k)
    vals = np.concatenate([_runny(rng, n, k).astype(np.int32), _edge_blocks(k)])
    want_p, want_l = _spec_encode(vals)
    for dtype in (torch.int16, torch.int32):
        for x in (_t(vals).to(dtype), _offset_view(_t(vals).to(dtype))):
            got_p, got_l = pack16.pack16_encode(x)
            assert np.array_equal(_words(got_p), want_p)
            assert np.array_equal(got_l.numpy(), want_l)


# ---- K5 ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 64, 256), (10, 32, 128), (5, 64, 128)])
def test_k5_plain_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    r, k, c = shape
    kt = rng.integers(-511, 512, size=shape).astype(np.int16)
    kt[:, :, ::2] = np.repeat(kt[:, ::8, ::2], 8, axis=1)[:, :k]
    p, l = jax_pallas.rle_encode_packed16_pallas_kt(jnp.asarray(kt), interpret=True)
    got_p, got_l = pack16.pack16_encode_kt(_t(kt))
    assert np.array_equal(_words(got_p), np.asarray(p))
    assert np.array_equal(got_l.numpy(), np.asarray(l))


@pytest.mark.parametrize("shape", [(3, 64, 96), (2, 32, 40), (1, 16, 1)])
def test_k5_plain_matches_spec(shape):
    """Column counts the TPU kernel refused (C % 128 != 0)."""
    rng = np.random.default_rng(sum(shape))
    r, k, c = shape
    kt = rng.integers(-511, 512, size=shape).astype(np.int16)
    kt[:, :, 1::3] = np.repeat(kt[:, ::4, 1::3], 4, axis=1)[:, :k]
    kt[0, :, 0] = 511
    want_p, want_l = _spec_encode(kt.transpose(0, 2, 1).reshape(r * c, k))
    got_p, got_l = pack16.pack16_encode_kt(_t(kt))
    assert got_p.shape == (r * c, k)
    assert np.array_equal(_words(got_p), want_p)
    assert np.array_equal(got_l.numpy(), want_l)


# ---- K6 ---------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [(256, 64), (384, 32), (128, 64)])
def test_k6_plain_matches_pallas(n, k):
    """Canonical streams: the lengths-honouring decode equals the Pallas
    kernel, which ignores lengths."""
    rng = np.random.default_rng(n + 2 * k)
    vals = _runny(rng, n, k)
    vals[3] = 0
    words, lengths = _spec_encode(vals)
    want = jax_pallas.rle_decode_packed16_pallas(
        jnp.asarray(words), jnp.asarray(lengths), k, interpret=True)
    got = pack16.pack16_decode(_t(words.view(np.int16)), _t(lengths), k)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), vals.astype(np.int32))


@pytest.mark.parametrize("k", [64, 32, 8])
def test_k6_plain_matches_spec_on_crafted_rows(k):
    words, lengths = _crafted(k, np.random.default_rng(k))
    for out_size in sorted({k, max(1, k // 2), min(64, k + 9)}):
        got = pack16.pack16_decode(_t(words), _t(lengths), out_size)
        assert np.array_equal(got.numpy(), _spec_decode(words, lengths, out_size))


def test_k6_plain_matches_spec_unaligned_rows():
    """N = 100 (the TPU kernel wanted N % 128 == 0)."""
    rng = np.random.default_rng(100)
    words, lengths = _spec_encode(_runny(rng, 100, 64))
    got = pack16.pack16_decode(_t(words), _t(lengths), 64)
    assert np.array_equal(got.numpy(), _spec_decode(words, lengths, 64))


def test_valid_word_zero_is_not_padding():
    """A valid word 0 is value -512 with count 1 (the Pallas kernels read
    it as padding); the spec and the plain version decode it."""
    words = np.array([[(4 << 10) | 515, 0, (1 << 10) | 512, 0]], np.uint16)
    lengths = np.array([8], np.int32)
    got = pack16.pack16_decode(_t(words), _t(lengths), 4)
    assert got.tolist() == [[3, 3, 3, 3]]
    got = pack16.pack16_decode(_t(words), _t(np.array([6], np.int32)), 4)
    assert np.array_equal(got.numpy(), _spec_decode(words, np.array([6]), 4))
    words = np.array([[0, (2 << 10) | 517, 0, 0]], np.uint16)
    got = pack16.pack16_decode(_t(words), _t(np.array([8], np.int32)), 4)
    assert got.tolist() == [[-512, 5, 5, 5]]


# ---- K7 ---------------------------------------------------------------------


def test_k7_plain_matches_pallas():
    rng = np.random.default_rng(7)
    bh, bw, k = 4, 128, 64
    vals = rng.integers(-511, 512, size=(bh * bw, k)).astype(np.int16)
    vals[::3] = np.repeat(rng.integers(-511, 512, size=(bh * bw, k // 8)), 8,
                          axis=1)[::3]
    words, lengths = _spec_encode(vals)
    want = jax_pallas.rle_decode_packed16_pallas_plane(
        jnp.asarray(words), bw, interpret=True)
    got = pack16.pack16_decode_plane(_t(words.view(np.int16)), _t(lengths), bw)
    assert got.shape == (bh, k, bw) and got.dtype == torch.int16
    assert np.array_equal(got.numpy(), np.asarray(want))


# The kernel's tiles are 64 blocks of one block row: widths below, at and
# around one and two tiles.
K7_EDGES = [(k, bw) for k in (64, 32, 8, 2, 1) for bw in (1, 7, 63, 64, 65, 131)]


@pytest.mark.parametrize("k,bw", [(64, 40), (32, 13)] + K7_EDGES)
def test_k7_plain_matches_spec(k, bw):
    """Plane widths the TPU kernel refused (bw % 128 != 0), on crafted and
    random rows, also as offset views: plane[a, :, b] is the spec's row
    a·bw + b."""
    rng = np.random.default_rng(k + bw)
    words, lengths = crafted_packed16_rows(k, rng, n_random=max(40, 3 * bw))
    words = words.view(np.uint16)
    n = (len(words) // bw) * bw
    words, lengths = words[:n], lengths[:n]
    want = _spec_decode(words, lengths, k).reshape(n // bw, bw, k)
    for w, l in ((_t(words), _t(lengths)),
                 (_offset_view(_t(words)), _offset_view(_t(lengths)))):
        got = pack16.pack16_decode_plane(w, l, bw)
        assert np.array_equal(got.numpy(), want.transpose(0, 2, 1))


# ---- K8 ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(256, 64), (512, 32)])
def test_k8_plain_matches_pallas(shape):
    """Canonical streams from the JAX encoder (as tests/test_pallas_rle.py
    holds the wide kernel to K6): the plain version equals the
    interpret-mode lane-dense kernel, which reads validity from nonzero
    words."""
    n, k = shape
    rng = np.random.default_rng(n + k)
    vals = _runny(rng, n, k)
    vals[3] = 0  # constant-zero block
    vals[4] = 7  # single-run block
    words, lengths = _spec_encode(vals)
    want = jax_pallas.rle_decode_packed16_pallas_wide(jnp.asarray(words),
                                                      interpret=True)
    got = pack16.pack16_decode_wide(_t(words.view(np.int16)), _t(lengths))
    assert got.dtype == torch.int16 and got.shape == (n, k)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), vals)


@pytest.mark.parametrize("k", [64, 32, 8, 1])
def test_k8_plain_matches_k6_on_crafted_rows(k):
    """Valid word 0, count sums below and above K, short and negative
    lengths: K6's plain version at out_size = K, cast to int16."""
    words, lengths = _crafted(k, np.random.default_rng(5 * k))
    got = pack16.pack16_decode_wide(_t(words), _t(lengths))
    want = pack16.pack16_decode(_t(words), _t(lengths), k).to(torch.int16)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(),
                          _spec_decode(words, lengths, k).astype(np.int16))


def test_k8_takes_shapes_the_tpu_gate_refused():
    """N·K % 2048 != 0 is refused by the TPU wrapper, not by the port."""
    rng = np.random.default_rng(8)
    vals = _runny(rng, 100, 64)
    words, lengths = _spec_encode(vals)
    with pytest.raises(ValueError):
        jax_pallas.rle_decode_packed16_pallas_wide(jnp.asarray(words))
    got = pack16.pack16_decode_wide(_t(words.view(np.int16)), _t(lengths))
    assert np.array_equal(got.numpy(), vals)


# ---- gates and counters -----------------------------------------------------


@pytest.mark.parametrize("k", [48, 128])
def test_wrappers_reject_bad_segments(k):
    """The 6-bit count field allows segments of at most 64, powers of two."""
    z16 = torch.zeros((4, k), dtype=torch.int16)
    with pytest.raises(ValueError, match="power of two"):
        pack16.pack16_encode(z16)
    with pytest.raises(ValueError, match="power of two"):
        pack16.pack16_encode_kt(torch.zeros((2, k, 3), dtype=torch.int16))
    with pytest.raises(ValueError, match="power of two"):
        pack16.pack16_decode(z16, torch.zeros(4, dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="power of two"):
        pack16.pack16_decode_plane(z16, torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="power of two"):
        pack16.pack16_decode_wide(z16, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        jax_pallas.rle_encode_packed16_pallas(
            jnp.zeros((4, k), jnp.int16), interpret=True)


def test_wrappers_check_their_inputs():
    z = torch.zeros((4, 64), dtype=torch.int16)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        pack16.pack16_encode(torch.zeros((4, 64), dtype=torch.float32))
    with pytest.raises(ValueError):
        pack16.pack16_encode(torch.zeros(64, dtype=torch.int16))
    with pytest.raises(ValueError):
        pack16.pack16_decode(z, torch.zeros(3, dtype=torch.int32), 64)
    with pytest.raises(ValueError):
        pack16.pack16_decode(z, lens, 65)
    with pytest.raises(ValueError):
        pack16.pack16_decode_plane(z, lens, 3)
    with pytest.raises(ValueError):
        pack16.pack16_decode_wide(z, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        pack16.pack16_decode_wide(z.to(torch.int32), lens)
    with pytest.raises(ValueError):
        pack16.pack16_decode_wide(z, lens.to("meta"))
    with pytest.raises(ValueError):
        pack16.pack16_encode(torch.zeros((4, 64), dtype=torch.int16,
                                         device="meta"))


def test_cpu_tensors_never_count_launches():
    wrappers = (pack16.pack16_encode, pack16.pack16_encode_kt,
                pack16.pack16_decode, pack16.pack16_decode_plane,
                pack16.pack16_decode_wide)
    for w in wrappers:
        w.launches = 0
    vals = torch.zeros((6, 64), dtype=torch.int16)
    words, lengths = pack16.pack16_encode(vals)
    pack16.pack16_encode_kt(torch.zeros((2, 64, 3), dtype=torch.int16))
    pack16.pack16_decode(words, lengths, 64)
    pack16.pack16_decode_plane(words, lengths, 3)
    pack16.pack16_decode_wide(words, lengths)
    rle.rle_decode_packed16(words, lengths, 64)
    assert [w.launches for w in wrappers] == [0, 0, 0, 0, 0]


# ---- the rest of ops/rle.py -------------------------------------------------


@pytest.mark.parametrize("k", [64, 32, 48])
def test_rle_encoders_match_jax(k):
    """Any L on the CPU, 48 included (only the kernels need powers of two)."""
    rng = np.random.default_rng(k)
    vals = np.concatenate([_runny(rng, 50, k), _edge_blocks(k).astype(np.int16)])
    pairs, lengths = rle.rle_encode_batched(_t(vals))
    j_pairs, j_lengths = jax_rle.rle_encode_batched(jnp.asarray(vals))
    assert np.array_equal(pairs.numpy(), np.asarray(j_pairs))
    assert np.array_equal(lengths.numpy(), np.asarray(j_lengths))
    words, lengths16 = rle.rle_encode_packed16(_t(vals))
    j_words, j_lengths16 = _spec_encode(vals)
    assert np.array_equal(_words(words), j_words)
    assert np.array_equal(lengths16.numpy(), j_lengths16)
    assert np.array_equal(_words(rle.pack16_pairs(pairs)),
                          np.asarray(jax_rle.pack16_pairs(j_pairs)))
    for ours, theirs in zip(rle.unpack16_pairs(words),
                            jax_rle.unpack16_pairs(jnp.asarray(j_words))):
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
    sp, sp_len = rle.rle_encode_sparse16(_t(vals))
    j_sp, j_sp_len = jax_rle.rle_encode_sparse16(jnp.asarray(vals))
    assert np.array_equal(sp.numpy().view(np.uint16), np.asarray(j_sp))
    assert np.array_equal(sp_len.numpy(), np.asarray(j_sp_len))


def jax_rle_unpack_pairs(words):
    """(N, K) packed words → (N, 2K) int32 interleaved pairs, via JAX."""
    counts, vals = jax_rle.unpack16_pairs(jnp.asarray(words))
    return jnp.stack([counts, vals], axis=2).reshape(words.shape[0], -1)


@pytest.mark.parametrize("k", [64, 32])
def test_rle_decoders_match_jax(k):
    words, lengths = _crafted(k, np.random.default_rng(3 * k))
    pairs = np.asarray(jax_rle_unpack_pairs(words))
    for out_size in (k, k // 2, k + 7):
        got = rle.rle_decode_packed16(_t(words), _t(lengths), out_size)
        assert np.array_equal(got.numpy(), _spec_decode(words, lengths, out_size))
        got = rle.rle_decode_batched(_t(pairs), _t(lengths), out_size)
        want = jax_rle.rle_decode_batched(jnp.asarray(pairs),
                                          jnp.asarray(lengths), out_size)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_layout_conversions_match_jax():
    rng = np.random.default_rng(11)
    for k in (64, 32):
        vals = np.concatenate([_runny(rng, 40, k), _edge_blocks(k).astype(np.int16)])
        sp, _ = jax_rle.rle_encode_sparse16(jnp.asarray(vals))
        sp = np.asarray(sp)
        words, lengths = rle.sparse16_to_packed16(_t(sp.view(np.int16)))
        j_words, j_lengths = jax_rle.sparse16_to_packed16(jnp.asarray(sp))
        assert np.array_equal(_words(words), np.asarray(j_words))
        assert np.array_equal(lengths.numpy(), np.asarray(j_lengths))
        back, back_len = rle.packed16_to_sparse16(words, lengths)
        j_back, j_back_len = jax_rle.packed16_to_sparse16(j_words, j_lengths)
        assert np.array_equal(back.numpy().view(np.uint16), np.asarray(j_back))
        assert np.array_equal(back.numpy().view(np.uint16), sp)
        assert np.array_equal(back_len.numpy(), np.asarray(j_back_len))
        assert np.array_equal(rle.rle_decode_sparse16(_t(sp)).numpy(),
                              np.asarray(jax_rle.rle_decode_sparse16(sp)))
