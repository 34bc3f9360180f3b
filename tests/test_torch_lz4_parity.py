"""LZ4 parity mode, the encode log and the framework-free copies, held
against the JAX package on the CPU.

* ``ops/match.py``: ``pad_blocks`` (numpy), ``match_tables`` and
  ``greedy_parse`` (torch) identical to JAX's on seeded random blocks with
  ragged last blocks and on crafted blocks: runs whose best length is 256,
  260 or 512 (uint8-truncated to 0, 4, 0: a length ≡ 0 mod 256 becomes a
  literal), ties between distances (the largest distance wins), P = 300,
  1,024 and 4,096 (two blocks), all-equal bytes, a lowered ``max_match``
  at P = 300 and 1,024.  Tolerance: exact, dtypes included.
* ``LZ4Codec(LZ4Config(mode="parity"), device="cpu")`` frames
  byte-identical to the JAX codec's, to ``lz4_encode_oracle`` and to the
  native ``encode_parity`` (the port's binding and JAX's); the JAX codec's
  error types on noise and short input.
* Parity decode: ``engine="device"`` (pointer doubling on the CPU) equal
  to the input and to JAX's ``decode_frame_device``; the host decode equal
  to JAX's ``decode_frame_bytes``.
* ``log_path``: log files byte-equal to the JAX codec's, parity and fast.
* The copies (``oracle/lz4_oracle.py``, ``formats/lz4_frame.py``,
  ``models/lzw.py``, ``utils/metrics.py``, ``utils/visualize.py``) give
  the originals' outputs; ``native.emit_block`` equals JAX's binding.
"""

import numpy as np
import pytest
import torch

from lz4jpeg_tpu import LZ4Codec as JaxLZ4Codec
from lz4jpeg_tpu.config import LZ4Config as JaxLZ4Config
from lz4jpeg_tpu.formats import lz4_frame as jax_frame
from lz4jpeg_tpu.models import lzw as jax_lzw
from lz4jpeg_tpu.native import native_backend as jax_native_backend
from lz4jpeg_tpu.ops import lz4_decode as jax_decode
from lz4jpeg_tpu.ops import match as jax_match
from lz4jpeg_tpu.oracle import lz4_oracle as jax_oracle
from lz4jpeg_tpu.utils import metrics as jax_metrics
from lz4jpeg_tpu.utils import visualize as jax_visualize

from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.formats import lz4_frame
from lz4jpeg_tpu_torch.models import lzw
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops import lz4_decode, match
from lz4jpeg_tpu_torch.oracle import lz4_oracle
from lz4jpeg_tpu_torch.utils import metrics, visualize
from lz4jpeg_tpu_torch.utils.inputs import generate_text


def _text(n, seed=0):
    return generate_text(n, np.random.default_rng(seed))


def _binary(seed=0):
    # tests/test_lz4_codec.py::test_binary_bytes_roundtrip's input.
    base = bytes(np.random.default_rng(seed).integers(0, 256, size=128,
                                                      dtype=np.uint8))
    return (base + base[:64]) * 12


def _codec(**kw):
    return LZ4Codec(LZ4Config(mode="parity", **kw), device="cpu")


def _jax(**kw):
    return JaxLZ4Codec(JaxLZ4Config(mode="parity", **kw))


# ---------------------------------------------------------------------------
# ops/match.py
# ---------------------------------------------------------------------------


def _random_data(seed, n):
    """Bytes of a 6-letter alphabet with repeated phrases: many matches,
    ties, and a ragged last block."""
    rng = np.random.default_rng(seed)
    letters = rng.integers(ord("a"), ord("g"), n, dtype=np.uint8)
    for _ in range(n // 40):
        src, dst, ln = (int(v) for v in rng.integers(0, n - 40, 3) % (n - 40))
        letters[dst : dst + ln % 37] = letters[src : src + ln % 37]
    return letters.tobytes()


def _crafted_blocks(p):
    """Blocks of p bytes: runs of c equal bytes after 1 distinct byte for c
    in 256..513 (best lengths 256, 260, 512 at the run's second byte),
    ties between distances, and a periodic block."""
    rows = []
    for run in (256, 257, 260, 261, 512, 513):
        if run + 2 > p:
            continue
        row = bytearray(range(1, p + 1)) if p <= 255 else bytearray(
            (i * 7 + 3) % 251 for i in range(p))
        row[1 : 1 + run] = b"a" * run
        rows.append(bytes(row))
    tie = (b"abcdX" + b"abcdY" + b"abcdZ" + b"abcdabcd" + b"xyzw") * p
    rows.append(tie[:p])
    rows.append((b"0123456789" * p)[:p])
    return b"".join(rows)


MATCH_CASES = {
    "random_p300": (_random_data(1, 300 * 7 + 123), 300, 1024),
    "random_p1024": (_random_data(2, 1024 * 2 + 77), 1024, 1024),
    "crafted_p300": (_crafted_blocks(300), 300, 1024),
    "crafted_p1024": (_crafted_blocks(1024), 1024, 1024),
    "max_match_100": (_crafted_blocks(300), 300, 100),
    "text_p300": (_text(3000 + 17), 300, 1024),
    "random_p4096_two_blocks": (_random_data(3, 4096 + 1500), 4096, 1024),
    "all_equal_p300": (b"z" * (300 * 3 + 77), 300, 1024),
    "max_match_100_p1024": (_crafted_blocks(1024), 1024, 100),
}


@pytest.mark.parametrize("name", sorted(MATCH_CASES))
def test_match_tables_and_greedy_parse_match_jax(name):
    data, p, max_match = MATCH_CASES[name]
    padded, lengths = match.pad_blocks(data, p)
    jax_padded, jax_lengths = jax_match.pad_blocks(data, p)
    assert np.array_equal(padded, jax_padded) and padded.dtype == np.int32
    assert np.array_equal(lengths, jax_lengths)
    assert lengths[-1] < p or len(data) % p == 0

    best_len, best_dist = match.match_tables(torch.from_numpy(padded),
                                             max_match=max_match)
    want_len, want_dist = (np.asarray(a) for a in jax_match.match_tables(
        padded, max_match=max_match))
    assert best_len.dtype == best_dist.dtype == torch.int32
    assert np.array_equal(best_len.numpy(), want_len)
    assert np.array_equal(best_dist.numpy(), want_dist)

    got = match.greedy_parse(best_len, best_dist)
    want = jax_match.greedy_parse(want_len, want_dist)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        assert np.array_equal(g.numpy(), w)


def test_crafted_blocks_reach_the_truncation_and_the_tie_break():
    data = _crafted_blocks(1024)
    padded, _ = match.pad_blocks(data, 1024)
    best_len, best_dist = match.match_tables(torch.from_numpy(padded))
    lens = set(best_len[:, 2].tolist())  # second byte of each run
    assert {256, 260, 512} <= lens
    is_match, emit_len, _ = match.greedy_parse(best_len, best_dist)
    for row, true_len in enumerate(best_len[:, 2].tolist()):
        # ≡ 0 mod 256 → a literal at that position; else a match of len & 0xFF.
        if true_len in (256, 512):
            assert not is_match[row, 2]
        elif true_len == 260:
            assert is_match[row, 2] and emit_len[row, 2] == 4
    # The tie row: "abcd" recurs at distances 5 and 10 from position 10;
    # the largest distance wins, as in the reference's strict ">" scan.
    tie_row = len(best_len) - 2
    assert best_len[tie_row, 10] == 4 and best_dist[tie_row, 10] == 10


# ---------------------------------------------------------------------------
# The codec in parity mode
# ---------------------------------------------------------------------------

FRAME_INPUTS = {
    "text_350": _text(350, 1),
    "text_1000": _text(1000, 2),
    "text_5000": _text(5000, 3),
    "binary": _binary(),
}


@pytest.mark.parametrize("name", sorted(FRAME_INPUTS))
def test_parity_frames_match_jax_oracle_and_native(name):
    data = FRAME_INPUTS[name]
    frame = _codec().encode(data)
    assert frame == _jax().encode(data)
    assert frame == lz4_oracle.lz4_encode_oracle(data)
    assert frame == jax_oracle.lz4_encode_oracle(data)
    assert frame == native_backend().encode_parity(data)
    assert frame == jax_native_backend().encode_parity(data)
    # More than one match batch, and a ragged last batch.
    assert LZ4Codec(LZ4Config(mode="parity"), "cpu",
                    batch_blocks=2).encode(data) == frame


@pytest.mark.parametrize("block_length", [64, 1024])
def test_parity_frames_at_other_block_lengths(block_length):
    data = _text(6 * block_length + 5, 4)
    frame = _codec(block_length=block_length).encode(data)
    assert frame == _jax(block_length=block_length).encode(data)
    assert frame == lz4_oracle.lz4_encode_oracle(data, block_length)
    assert frame == native_backend().encode_parity(data, block_length)


def test_parity_mode_ignores_the_engine():
    data = FRAME_INPUTS["text_1000"]
    frames = {_codec().encode(data, engine=e)
              for e in ("auto", "device", "native", "python")}
    assert frames == {_jax().encode(data)}


def test_parity_errors_match_jax():
    noise = bytes(np.random.default_rng(0).integers(0, 256, 2048,
                                                    dtype=np.uint8))
    with pytest.raises(lz4_frame.FormatError):
        _codec().encode(noise)
    with pytest.raises(jax_frame.FormatError):
        _jax().encode(noise)
    for codec in (_codec(), _jax()):
        with pytest.raises(ValueError, match="block length is too high"):
            codec.encode(b"short")
    with pytest.raises(ValueError, match="requires fast mode"):
        _codec().encode_file("unused", "unused")


@pytest.mark.parametrize("name", sorted(FRAME_INPUTS))
def test_parity_decode_matches_jax(name):
    data = FRAME_INPUTS[name]
    frame = _jax().encode(data)
    codec = _codec()
    got = codec.decode(frame, engine="device")
    assert got == data
    assert got == jax_decode.decode_frame_device(frame)
    for engine in ("auto", "native", "python"):
        assert codec.decode(frame, engine=engine) == data
    assert lz4_frame.decode_frame_bytes(frame) == jax_frame.decode_frame_bytes(
        frame) == data
    assert codec.roundtrip(data) == data
    # A fast-mode codec takes parity frames too (format auto-detected).
    assert LZ4Codec(LZ4Config(mode="fast"), "cpu").decode(
        frame, engine="device") == data


def test_copy_program_and_resolve_match_jax():
    data = _text(20_000, 5)  # chains cross the 300-byte blocks
    blocks = lz4_frame.unpack_frame(_codec().encode(data))
    lit, src = lz4_decode.build_copy_program(blocks)
    jax_lit, jax_src = jax_decode.build_copy_program(
        jax_frame.unpack_frame(_jax().encode(data)))
    assert np.array_equal(lit, jax_lit) and np.array_equal(src, jax_src)
    steps = lz4_decode.doubling_steps(len(lit))
    assert steps == max(1, int(np.ceil(np.log2(len(lit)))) + 1)
    out = lz4_decode.resolve_copies(torch.from_numpy(lit),
                                    torch.from_numpy(src), steps)
    want = jax_decode.resolve_copies(lit, src.astype(np.int32), steps)
    assert np.array_equal(out.numpy(), np.asarray(want))
    assert out.numpy().tobytes() == data
    assert [lz4_decode.doubling_steps(n) for n in (1, 2, 3, 4, 5)] == [
        max(1, int(np.ceil(np.log2(n))) + 1) for n in (1, 2, 3, 4, 5)]


def test_largest_parity_frame_decodes_on_the_device_path():
    data = _text(255 * 300, 6)  # 255 blocks: the one-byte block count's limit
    frame = _codec().encode(data)
    assert frame[0] == 255
    assert _codec().decode(frame, engine="device") == data


# ---------------------------------------------------------------------------
# The encode log
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,engine", [("parity", "auto"), ("fast", "native"),
                                         ("fast", "python")])
def test_log_files_match_jax(tmp_path, mode, engine):
    data = _text(3000, 7)
    ours, theirs = tmp_path / "ours.log", tmp_path / "jax.log"
    for _ in range(2):  # appends
        LZ4Codec(LZ4Config(mode=mode, log_path=str(ours)), "cpu").encode(
            data, engine=engine)
        JaxLZ4Codec(JaxLZ4Config(mode=mode, log_path=str(theirs))).encode(
            data, engine=engine)
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.read_text().count(f"encode mode={mode}") == 2


def test_log_is_capped_at_1024_detail_lines(tmp_path):
    data = _text(100 * 300, 8)
    ours, theirs = tmp_path / "ours.log", tmp_path / "jax.log"
    _codec(log_path=str(ours)).encode(data)
    _jax(log_path=str(theirs)).encode(data)
    text = ours.read_text()
    assert text == theirs.read_text()
    assert "more lines)" in text and len(text.splitlines()) == 1 + 1024 + 1


# ---------------------------------------------------------------------------
# The copies
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    """``fn(*args)``, or the name and text of what it raised (the
    C-faithful decoder raises ``ParityError`` on binary frames)."""
    try:
        return fn(*args)
    except ValueError as e:
        return type(e).__name__, str(e)


def test_lz4_oracle_copy_matches_original():
    for data in (*FRAME_INPUTS.values(), b"abcd" * 500):
        frame = lz4_oracle.lz4_encode_oracle(data)
        assert frame == jax_oracle.lz4_encode_oracle(data)
        for fn in ("lz4_decode_oracle", "lz4_decode_to_text"):
            assert _outcome(getattr(lz4_oracle, fn), frame) == \
                _outcome(getattr(jax_oracle, fn), frame)
        block = data[:300]
        assert lz4_oracle.block_encode_oracle(block).__dict__.keys() == \
            jax_oracle.block_encode_oracle(block).__dict__.keys()
        got, want = (m.block_encode_oracle(block)
                     for m in (lz4_oracle, jax_oracle))
        assert (got.token, got.byte_size) == (want.token, want.byte_size)
        assert [vars(s) for s in got.sequences] == [vars(s)
                                                   for s in want.sequences]
        for k in (0, 7, 150, 299):
            assert lz4_oracle.find_longest_match_oracle(block, k) == \
                jax_oracle.find_longest_match_oracle(block, k)
    for bad in (b"x" * 10,):
        with pytest.raises(lz4_oracle.ParityError):
            lz4_oracle.lz4_encode_oracle(bad)
    with pytest.raises(lz4_oracle.ParityError, match="500"):
        lz4_oracle.lz4_encode_oracle(b"x" * 600, 500)
    with pytest.raises(lz4_oracle.ParityError, match="sign-extends"):
        lz4_oracle.lz4_decode_oracle(bytes([200]))


def test_lz4_frame_copy_matches_original():
    frames = [_codec().encode(d) for d in FRAME_INPUTS.values()]
    frames.append(LZ4Codec(LZ4Config(mode="fast"), "cpu").encode(
        _text(200_000, 9), engine="native"))
    frames.append(LZ4Codec(LZ4Config(mode="fast"), "cpu").encode(b""))
    for frame in frames:
        assert lz4_frame.describe_frame(frame) == jax_frame.describe_frame(frame)
    for frame in frames[:-2]:
        got, want = lz4_frame.unpack_frame(frame), jax_frame.unpack_frame(frame)
        assert [[vars(s) for s in b.sequences] for b in got] == \
            [[vars(s) for s in b.sequences] for b in want]
        assert lz4_frame.pack_frame(got) == jax_frame.pack_frame(want) == frame
        assert lz4_frame.apply_sequences(got) == jax_frame.apply_sequences(want)
    long_run = lz4_frame.Sequence(b"z" * 271, 0, 0)
    with pytest.raises(lz4_frame.FormatError, match="270-byte"):
        lz4_frame.pack_frame([lz4_frame.Block([long_run])])
    for bad in (b"", frames[0][:-3], frames[0] + b"!"):
        with pytest.raises(lz4_frame.FormatError):
            lz4_frame.unpack_frame(bad)
        with pytest.raises(jax_frame.FormatError):
            jax_frame.unpack_frame(bad)


@pytest.mark.parametrize("data", [
    b"", b"abab", b"aaaa", b"\x1b", b"ababa" * 3, _text(5000, 10),
    b"Lorem ipsum dolor sit amet, \x00\x7f\x10 consectetur" * 20,
])
def test_lzw_copy_matches_original(data):
    codes = lzw.lzw_encode(data)
    assert codes == jax_lzw.lzw_encode(data)
    if b"\x1b" not in data and b"\x10" not in data:
        assert lzw.lzw_decode(codes) == jax_lzw.lzw_decode(codes) == data
    with pytest.raises(ValueError):
        lzw.lzw_decode("999999")


def test_metrics_and_visualize_copies_match_originals():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    plane = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    assert metrics.mse(plane, b) == jax_metrics.mse(plane, b)
    assert metrics.mse_rgb(a, b) == jax_metrics.mse_rgb(a, b)
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == jax_metrics.psnr(a, a) == float("inf")
    for fn in ("luminance_image", "r_chrominance_image", "b_chrominance_image"):
        assert np.array_equal(getattr(visualize, fn)(plane),
                              getattr(jax_visualize, fn)(plane))
    tiles = rng.integers(0, 256, (6, 8, 4), dtype=np.uint8)
    for h, w in ((16, 24), (15, 23)):
        assert np.array_equal(
            visualize.reconstruct_chrominance_matrix(tiles, 2, 3, h, w),
            jax_visualize.reconstruct_chrominance_matrix(tiles, 2, 3, h, w))


def test_emit_block_binding_matches_jax():
    data = _text(16_384, 12)
    block = np.frombuffer(data, np.uint8)
    padded = np.zeros((1, 300), np.int32)
    padded[0] = block[:300]
    best_len, best_dist = match.match_tables(torch.from_numpy(padded))
    is_match, emit_len, emit_dist = (t[0].numpy() for t in match.greedy_parse(
        best_len, best_dist))
    raw = data[:300]
    got = native_backend().emit_block(raw, is_match, emit_len, emit_dist)
    assert got == jax_native_backend().emit_block(raw, is_match, emit_len,
                                                  emit_dist)
    from lz4jpeg_tpu_torch.formats.fast_frame import decompress_block
    assert decompress_block(got, len(raw)) == raw
    with pytest.raises(ValueError, match="one entry per byte"):
        native_backend().emit_block(raw, is_match[:10], emit_len, emit_dist)
