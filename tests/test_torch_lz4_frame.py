"""The LZ4T frame copies, the native bindings, the text generator and the
LZ4 config, held against the JAX package.

* Every function of ``formats/fast_frame.py`` gives bytes identical to its
  original in ``lz4jpeg_tpu/formats/fast_frame.py``.
* The six LZ4T bindings of ``native.py`` give bytes and arrays identical to
  ``lz4jpeg_tpu.native``'s on the same inputs (both compile
  ``lz4core.cpp``).
* Inputs: empty, 1 byte, exactly one 64 KiB block, and generated text with
  uniform noise and a ragged tail ("identical" means ``np.array_equal`` or
  byte equality).
"""

import dataclasses

import numpy as np
import pytest

from lz4jpeg_tpu.config import LZ4Config as JaxLZ4Config
from lz4jpeg_tpu.formats import fast_frame as jax_frame
from lz4jpeg_tpu.native import native_backend as jax_native_backend

from lz4jpeg_tpu_torch import LZ4Config
from lz4jpeg_tpu_torch.formats import fast_frame as frame
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.utils.inputs import generate_text


def _mixed(seed=0):
    rng = np.random.default_rng(seed)
    text = generate_text(150_000, rng)
    noise = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    return text + noise + text[:12_345]


INPUTS = {
    "empty": b"",
    "one_byte": b"x",
    "one_block": generate_text(1 << 16, np.random.default_rng(1)),
    "mixed_ragged": _mixed(),
}


@pytest.fixture(params=sorted(INPUTS))
def data(request):
    return INPUTS[request.param]


def test_encode_decode_fast_match_jax(data):
    got = frame.encode_fast(data)
    assert got == jax_frame.encode_fast(data)
    assert frame.decode_fast(got) == data == jax_frame.decode_fast(got)
    small = frame.encode_fast(data, block_log=10)
    assert small == jax_frame.encode_fast(data, block_log=10)
    assert frame.decode_fast(small) == data


def test_block_codec_and_assembly_match_jax(data):
    block = data[:5000]
    comp = frame.compress_block(block)
    assert comp == jax_frame.compress_block(block)
    assert frame.decompress_block(comp, len(block)) == block
    blocks = [data[i : i + 4096] for i in range(0, len(data), 4096)]
    payloads = [frame.compress_block(b) for b in blocks]
    assert frame.assemble_frame(payloads, blocks, len(data), 12) == (
        jax_frame.assemble_frame(payloads, blocks, len(data), 12)
    )


def test_checksums_and_detection_match_jax(data):
    assert frame.content_checksum16(data) == jax_frame.content_checksum16(data)
    f = frame.encode_fast(data)
    assert frame.is_fast_frame(f) and jax_frame.is_fast_frame(f)
    frame.verify_frame_checksum(f, data)
    with pytest.raises(frame.FastFormatError):
        frame.verify_frame_checksum(f, data + b"!")


def test_emit_block_from_parse_matches_jax_and_native():
    data = _mixed(3)[:16384]
    rng = np.random.default_rng(4)
    n = len(data)
    # A parse of real matches: every 4th-byte repeat of a 12-back copy.
    arr = np.frombuffer(data, np.uint8)
    is_match = np.zeros(n, np.uint8)
    emit_len = np.zeros(n, np.int32)
    emit_dist = np.zeros(n, np.int32)
    k = 16
    while k + 8 < n:
        d = int(rng.integers(1, k))
        if np.array_equal(arr[k : k + 4], arr[k - d : k - d + 4]):
            is_match[k], emit_len[k], emit_dist[k] = 1, 4, d
            k += 4
        k += 1
    got = frame.emit_block_from_parse(data, is_match, emit_len, emit_dist)
    assert got == jax_frame.emit_block_from_parse(
        data, is_match, emit_len, emit_dist)
    native = native_backend().emit_blocks(
        arr[None], np.array([n], np.int32), is_match[None], emit_len[None],
        emit_dist[None])
    assert native == [got]
    assert frame.decompress_block(got, n) == data


@pytest.mark.parametrize("bad", [
    b"", b"LZ4T", b"LZ4Tgarbage-garbage-garbage",
    b"XXXX" + bytes(30),
])
def test_malformed_frames_raise(bad):
    with pytest.raises(frame.FastFormatError):
        frame.decode_fast(bad)


def test_corrupt_payload_raises_typed_error():
    f = bytearray(frame.encode_fast(INPUTS["mixed_ragged"]))
    f[-100] ^= 0xFF  # a literal byte of the ragged tail
    with pytest.raises(frame.FastFormatError):
        frame.decode_fast(bytes(f))


def test_native_codec_matches_jax(data):
    ours, theirs = native_backend(), jax_native_backend()
    enc = ours.encode_fast(data)
    assert enc == theirs.encode_fast(data)
    assert ours.decode_fast(enc, len(data)) == data
    assert ours.decode_fast(enc, len(data)) == theirs.decode_fast(enc, len(data))


def test_native_chunk_codec_matches_jax(data):
    ours, theirs = native_backend(), jax_native_backend()
    body, recs = ours.encode_chunk(data, 14)
    jbody, jrecs = theirs.encode_chunk(data, 14)
    assert body == jbody and np.array_equal(recs, jrecs)
    assert ours.decode_chunk(body, recs, 14, len(data)) == data
    assert theirs.decode_chunk(body, recs, 14, len(data)) == data


@pytest.mark.parametrize("depth_cap", [1, 4])
def test_native_copy_program_matches_jax(data, depth_cap):
    f = frame.encode_fast(data, block_log=14)
    count = -(-len(data) // 16384)
    got = native_backend().build_copy_program(f, count, 16384, depth_cap)
    want = jax_native_backend().build_copy_program(f, count, 16384, depth_cap)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)
    assert got[3] == want[3]


def test_native_emit_blocks_matches_jax():
    from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast

    padded, lengths = pad_blocks_fast(_mixed(5))
    blocks = padded.astype(np.uint8)
    rng = np.random.default_rng(6)
    is_match = (rng.random(blocks.shape) < 0.05).astype(np.uint8)
    emit_len = np.full(blocks.shape, 4, np.int32)
    emit_dist = rng.integers(1, 9, blocks.shape).astype(np.int32)
    is_match[:, :16] = 0
    args = (blocks, lengths, is_match, emit_len, emit_dist)
    assert native_backend().emit_blocks(*args) == (
        jax_native_backend().emit_blocks(*args))


def test_generate_text_is_seeded_lowercase_words():
    a = generate_text(10_000, np.random.default_rng(11))
    assert a == generate_text(10_000, np.random.default_rng(11))
    assert a != generate_text(10_000, np.random.default_rng(12))
    assert len(a) == 10_000
    assert set(a) <= set(b"abcdefghijklmnopqrstuvwxyz ")
    assert generate_text(0, np.random.default_rng(0)) == b""
    assert len(generate_text(1, np.random.default_rng(0))) == 1
    # Text compresses well; uniform noise would not.
    assert len(native_backend().encode_fast(a)) < 0.7 * len(a)


@pytest.mark.parametrize("kwargs", [
    {}, {"mode": "fast"}, {"mode": "fast", "matcher": "sort"},
    {"mode": "fast", "match_stride": 4, "match_lcp_words": 2},
    {"block_length": 301, "log_path": "/nonexistent/log.txt"},
])
def test_lz4_config_carries_the_jax_fields(kwargs):
    assert dataclasses.asdict(LZ4Config(**kwargs)) == dataclasses.asdict(
        JaxLZ4Config(**kwargs))


@pytest.mark.parametrize("kwargs", [
    {"block_length": 500}, {"mode": "lz5"}, {"matcher": "bogus"},
    {"match_stride": 3}, {"match_lcp_words": 3},
])
def test_lz4_config_rejects_what_jax_rejects(kwargs):
    with pytest.raises(ValueError):
        JaxLZ4Config(**kwargs)
    with pytest.raises(ValueError):
        LZ4Config(**kwargs)
