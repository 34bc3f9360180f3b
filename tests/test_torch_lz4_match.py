"""The LZ4 matchers, held against the JAX package on the CPU.

* ``fast_match_blocks`` (the sort matcher) and ``compact_parse`` are
  identical to ``lz4jpeg_tpu/ops/lz4_fast.py``'s at block_log 14, lcp
  words 1, 2 and 4.
* K2's plain version: ``match_candidates_ref`` is identical to the packed
  words of the interpret-mode Pallas kernel, and ``fast_match_blocks_fused``
  to interpret-mode ``fast_match_blocks_pallas``, at (stride 2, lcp 2) and
  (stride 4, lcp 4), block_log 12, on text and on blocks whose matches end
  on a segment's end.  At stride 1 (block_log 14, lcp 4) the
  fused matcher is identical to the JAX sort matcher, as the two JAX
  matchers are to each other.
* The hash's low 32 bits come out right without uint32 (all-0xFF windows).
* K2's plain version at stride 1 (through ``fast_match_blocks_fused``) is
  identical to the JAX sort matcher on each crafted block of
  ``utils/inputs.py::crafted_match_blocks``: one repeated byte (one bucket
  for every anchor), a 4-byte period, a block shorter than a hash window,
  zeros, a zero-length padding block, a ragged text block.

Inputs: generated text with a block of uniform noise and a ragged tail.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lz4jpeg_tpu.ops.pallas_match as jax_pallas_match
from lz4jpeg_tpu.ops import lz4_fast as jax_fast

from lz4jpeg_tpu_torch.ops import lz4_fast
from lz4jpeg_tpu_torch.ops.fused_match import (
    fast_match_blocks_fused,
    match_candidates,
    match_candidates_ref,
)
from lz4jpeg_tpu_torch.utils.inputs import (
    MATCH_BLOCK_KINDS,
    crafted_match_blocks,
    generate_text,
)


def _data(n_text, seed):
    rng = np.random.default_rng(seed)
    return (generate_text(n_text, rng)
            + rng.integers(0, 256, 9000, dtype=np.uint8).tobytes()
            + generate_text(7001, rng))


DATA = _data(2 * 16384 + 3000, seed=0)


def _torch(fields):
    return [torch.from_numpy(np.asarray(f)) for f in fields]


def _assert_identical(got, want):
    for name, g, w in zip(("is_match", "emit_len", "emit_dist"), got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name


@pytest.mark.parametrize("block_log", [10, 14])
def test_pad_blocks_matches_jax(block_log):
    for data in (b"", b"x", DATA):
        got = lz4_fast.pad_blocks_fast(data, block_log)
        want = jax_fast.pad_blocks_fast(data, block_log)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want))


def test_hash_low_bits_without_uint32():
    rng = np.random.default_rng(0)
    words = np.concatenate([
        np.array([0xFFFFFFFF, 0, 1, 0xFFFF0000, 0x0000FFFF], np.uint64),
        rng.integers(0, 1 << 32, 10_000, dtype=np.uint64),
    ])
    want = ((words * 2654435761) & 0xFFFFFFFF) >> 16  # numpy uint64 wraps
    got = lz4_fast.hash16(torch.from_numpy(words.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # The same through both matchers' key paths: windows of all 0xFF.
    ff = b"\xff" * 20000 + b"ab" * 6000
    padded, lengths = jax_fast.pad_blocks_fast(ff)
    _assert_identical(
        lz4_fast.fast_match_blocks(*_torch((padded, lengths))),
        jax_fast.fast_match_blocks(jnp.asarray(padded), jnp.asarray(lengths)),
    )


@pytest.mark.parametrize("lcp_words", [1, 2, 4])
def test_sort_matcher_and_compaction_match_jax(lcp_words):
    padded, lengths = jax_fast.pad_blocks_fast(DATA)
    want = jax_fast.fast_match_blocks(
        jnp.asarray(padded), jnp.asarray(lengths), lcp_words=lcp_words)
    got = lz4_fast.fast_match_blocks(*_torch((padded, lengths)),
                                     lcp_words=lcp_words)
    _assert_identical(got, want)
    assert int(got[0].sum()) > 1000
    for g, w in zip(lz4_fast.compact_parse(*got), jax_fast.compact_parse(*want)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_fused_stride1_matches_jax_sort_matcher():
    padded, lengths = jax_fast.pad_blocks_fast(DATA)
    want = jax_fast.fast_match_blocks(
        jnp.asarray(padded), jnp.asarray(lengths), lcp_words=4)
    got = fast_match_blocks_fused(*_torch((padded, lengths)), stride=1,
                                  lcp_words=4)
    _assert_identical(got, want)


@pytest.mark.parametrize("kind", MATCH_BLOCK_KINDS)
def test_fused_stride1_matches_jax_sort_matcher_on_crafted_blocks(kind):
    blocks, lengths = crafted_match_blocks(16384, np.random.default_rng(1))
    i = MATCH_BLOCK_KINDS.index(kind)
    padded, lens = blocks[i : i + 1], lengths[i : i + 1]
    want = jax_fast.fast_match_blocks(
        jnp.asarray(padded.astype(np.int32)), jnp.asarray(lens), lcp_words=4)
    got = fast_match_blocks_fused(*_torch((padded, lens)), stride=1,
                                  lcp_words=4)
    _assert_identical(got, want)
    if kind in ("one_byte", "period4", "zeros"):
        assert int(got[0].sum()) > 1000  # long runs: matches everywhere
    if kind in ("short", "padding"):
        assert int(got[0].sum()) == 0


def _segment_end_data(seed=4):
    """Three 4 KiB blocks of 512-byte segments, each a few random bytes and
    then a 23-byte period (which no stride divides), and a ragged fourth
    block: chains of matches whose last match is capped to end on its
    segment's end."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    period = b"abcdefghijklmnopqrstuvw"
    for s in range(8 * 3):
        head = rng.integers(0, 256, 2 + s % 5, dtype=np.uint8).tobytes()
        out += head + (period * 40)[: 512 - len(head)]
    return bytes(out) + period * 20


MATCHER_DATA = {"text": DATA, "segment_ends": _segment_end_data()}


@pytest.mark.parametrize("stride,lcp_words,data", [
    (2, 2, "text"), (4, 4, "text"),
    (2, 2, "segment_ends"), (4, 4, "segment_ends"),
], ids=["2-2", "4-4", "segment_ends-2-2", "segment_ends-4-4"])
def test_fused_matches_interpret_mode_pallas(monkeypatch, stride, lcp_words,
                                             data):
    """One interpret-mode run gives both references: the kernel's packed
    words (captured at ``_match_call``) and the wrapper's parse fields.
    The segment-end blocks hold matches ending on a segment's end, capped
    there, at strides 2 and 4."""
    captured = []
    real_call = jax_pallas_match._match_call

    def spy(*args, **kwargs):
        out = real_call(*args, **kwargs)
        captured.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax_pallas_match, "_match_call", spy)
    padded, lengths = jax_fast.pad_blocks_fast(MATCHER_DATA[data], block_log=12)
    want = jax_pallas_match.fast_match_blocks_pallas(
        jnp.asarray(padded), jnp.asarray(lengths), stride=stride,
        lcp_words=lcp_words, interpret=True,
    )
    blocks, lens = torch.from_numpy(padded.astype(np.uint8)), torch.from_numpy(lengths)
    packed = match_candidates_ref(blocks, lens, stride, lcp_words)
    assert np.array_equal(packed.numpy(), captured[0].reshape(packed.shape))
    got = fast_match_blocks_fused(blocks, lens, stride=stride,
                                  lcp_words=lcp_words)
    _assert_identical(got, want)
    assert int(got[0].sum()) > 300
    if data == "segment_ends":
        b, k = np.nonzero(got[0].numpy())
        ends = k + got[1].numpy()[b, k]
        assert int((ends % 512 == 0).sum()) >= 16


@pytest.mark.parametrize("p,stride,words", [
    (16384 * 2, 1, 4),   # 32 Ki anchors: keys overflow int32
    (3 * 4096, 1, 2),    # anchors not a power of two
    (4096, 3, 2),        # block not a multiple of the stride
    (4096, 1, 5),        # more lcp words than the kernel's pad
])
def test_matcher_gate_raises(p, stride, words):
    blocks = torch.zeros((1, p), dtype=torch.uint8)
    lengths = torch.tensor([p], dtype=torch.int32)
    with pytest.raises(ValueError):
        match_candidates(blocks, lengths, stride, words)


@pytest.mark.parametrize("bad", [
    (torch.zeros((1, 64), dtype=torch.int32), torch.tensor([64], dtype=torch.int32)),
    (torch.zeros((1, 64), dtype=torch.uint8), torch.tensor([64], dtype=torch.int64)),
    (torch.zeros((1, 64), dtype=torch.uint8), torch.tensor([64, 1], dtype=torch.int32)),
    (torch.zeros((1, 128), dtype=torch.uint8)[:, ::2], torch.tensor([64], dtype=torch.int32)),
    (torch.zeros((1, 64), dtype=torch.uint8, device="meta"),
     torch.zeros(1, dtype=torch.int32, device="meta")),
])
def test_match_wrapper_checks_its_input(bad):
    with pytest.raises((TypeError, ValueError)):
        match_candidates(*bad, 1, 2)


def test_cpu_tensors_never_count_match_launches():
    match_candidates.launches = 0
    padded, lengths = lz4_fast.pad_blocks_fast(DATA[:9000], block_log=12)
    blocks = torch.from_numpy(padded.astype(np.uint8))
    out = match_candidates(blocks, torch.from_numpy(lengths), 2, 2)
    assert out.shape == (3, 2048) and out.dtype == torch.int32
    assert match_candidates.launches == 0
