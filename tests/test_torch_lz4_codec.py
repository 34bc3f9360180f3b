"""The LZ4T codec's entry points, held against the JAX package on the CPU.

* ``LZ4Codec(LZ4Config(mode="fast"), device="cpu")`` with
  ``engine="device"``: with ``matcher="sort"`` the frame is byte-identical
  to the JAX codec's ``encode(…, engine="tpu")`` on the CPU (which runs the
  sort matcher for either matcher setting off a TPU); with ``"fused"`` it
  is byte-identical to the frame assembled from the interpret-mode Pallas
  matcher's fields.
* ``"native"`` and ``"python"`` frames are byte-identical to the JAX
  codec's, and every frame decodes to the input with every engine of both
  packages.
* ``encode_file`` / ``decode_file`` round-trip through a temp dir.
* Bad arguments raise: an unsupported device, an unknown engine,
  ``encode_file`` in parity mode, a malformed parity frame; so does
  ``device="cuda"`` without a card.  Parity mode and the encode log are
  held against JAX in ``tests/test_torch_lz4_parity.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu import LZ4Codec as JaxLZ4Codec
from lz4jpeg_tpu.config import LZ4Config as JaxLZ4Config
from lz4jpeg_tpu.formats.fast_frame import assemble_frame as jax_assemble
from lz4jpeg_tpu.native import native_backend as jax_native_backend
from lz4jpeg_tpu.ops.lz4_fast import pad_blocks_fast as jax_pad_blocks
from lz4jpeg_tpu.ops.pallas_match import fast_match_blocks_pallas

from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.ops.fused_match import match_candidates
from lz4jpeg_tpu_torch.utils.inputs import generate_text


def _mixed(seed):
    rng = np.random.default_rng(seed)
    return (generate_text(40_000, rng)
            + rng.integers(0, 256, 16_384, dtype=np.uint8).tobytes()
            + generate_text(11_111, rng))


INPUTS = {"empty": b"", "one_byte": b"q", "mixed": _mixed(0)}


def _codec(**kw):
    return LZ4Codec(LZ4Config(mode="fast", **kw), device="cpu")


def _jax(**kw):
    return JaxLZ4Codec(JaxLZ4Config(mode="fast", **kw))


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("lcp_words", [2, 4])
def test_sort_device_frame_matches_jax(name, lcp_words):
    data = INPUTS[name]
    got = _codec(matcher="sort", match_lcp_words=lcp_words).encode(
        data, engine="device")
    want = _jax(matcher="sort", match_lcp_words=lcp_words).encode(
        data, engine="tpu")
    assert got == want


def test_fused_device_frame_matches_interpret_mode_pallas():
    data = INPUTS["mixed"]
    match_candidates.launches = 0
    got = _codec(match_stride=4, match_lcp_words=4).encode(data, engine="device")
    assert match_candidates.launches == 0  # CPU: the plain version ran
    padded, lengths = jax_pad_blocks(data)
    fields = [np.asarray(f) for f in fast_match_blocks_pallas(
        jnp.asarray(padded), jnp.asarray(lengths), stride=4, lcp_words=4,
        interpret=True,
    )]
    blocks = padded.astype(np.uint8)
    payloads = jax_native_backend().emit_blocks(blocks, lengths, *fields)
    raws = [blocks[i, : int(n)].tobytes() for i, n in enumerate(lengths)]
    assert got == jax_assemble(payloads, raws, len(data), 14)


@pytest.mark.parametrize("engine", ["native", "python", "auto"])
def test_host_engines_match_jax(engine):
    data = INPUTS["mixed"]
    assert _codec().encode(data, engine=engine) == _jax().encode(
        data, engine=engine)


FRAMES = {
    "device_fused": lambda d: _codec().encode(d, engine="device"),
    "device_stride2": lambda d: _codec(match_stride=2, match_lcp_words=2)
    .encode(d, engine="device"),
    "native": lambda d: _codec().encode(d, engine="native"),
}


@pytest.mark.parametrize("frame_of", sorted(FRAMES))
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_every_engine_of_both_packages_decodes(frame_of, name):
    data = INPUTS[name]
    frame = FRAMES[frame_of](data)
    codec, jax_codec = _codec(), _jax()
    for engine in ("device", "native", "python", "auto"):
        assert codec.decode(frame, engine=engine) == data, engine
    for engine in ("tpu", "native", "python", "auto"):
        assert jax_codec.decode(frame, engine=engine) == data, engine
    assert codec.roundtrip(data) == data


@pytest.mark.parametrize("engine", ["device", "native", "python"])
def test_file_round_trip(tmp_path, engine):
    data = INPUTS["mixed"] + generate_text(70_000, np.random.default_rng(9))
    src, out, back = tmp_path / "in", tmp_path / "out.lz4t", tmp_path / "back"
    src.write_bytes(data)
    codec = _codec()
    size = codec.encode_file(str(src), str(out), chunk_blocks=2, engine=engine)
    assert size == out.stat().st_size
    frame = out.read_bytes()
    if engine == "device":
        assert frame == codec.encode(data, engine="device")
    else:
        jax_out = tmp_path / "jax.lz4t"
        _jax().encode_file(str(src), str(jax_out), chunk_blocks=2,
                           engine=engine)
        assert frame == jax_out.read_bytes()
    assert codec.decode_file(str(out), str(back), chunk_blocks=3) == len(data)
    assert back.read_bytes() == data
    assert codec.decode(frame) == data


def test_decode_file_rejects_corrupt_frames(tmp_path):
    from lz4jpeg_tpu_torch.formats.fast_frame import FastFormatError

    frame = bytearray(_codec().encode(INPUTS["mixed"], engine="device"))
    for path, blob in ((tmp_path / "trunc", bytes(frame[:-7])),
                       (tmp_path / "tail", bytes(frame) + b"!"),
                       (tmp_path / "magic", b"NOPE" + bytes(frame[4:]))):
        path.write_bytes(blob)
        with pytest.raises(FastFormatError):
            _codec().decode_file(str(path), str(tmp_path / "x"))


def test_unported_modes_and_bad_arguments_raise():
    from lz4jpeg_tpu_torch.formats.lz4_frame import FormatError

    parity = LZ4Codec(LZ4Config(), device="cpu")  # parity is the default mode
    with pytest.raises(ValueError, match="requires fast mode"):
        parity.encode_file("unused", "unused")
    with pytest.raises(ValueError, match="unsupported device"):
        LZ4Codec(LZ4Config(mode="fast"), device="meta")
    with pytest.raises(ValueError, match="unknown engine"):
        _codec().encode(b"abc", engine="tpu")
    with pytest.raises(ValueError, match="unknown engine"):
        parity.encode(b"abc" * 200, engine="tpu")
    bad_parity_frame = bytes([1, 3, 0, 0]) + b"abc"
    for engine in ("device", "auto"):
        with pytest.raises(FormatError):
            _codec().decode(bad_parity_frame, engine=engine)


def test_cuda_codec_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for CPU hosts")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LZ4Codec(LZ4Config(mode="fast"), device="cuda")
