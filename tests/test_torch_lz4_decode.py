"""LZ4T device decode, held against the JAX package on the CPU.

* ``build_copy_program_fast`` (native and the Python spec) is identical to
  ``lz4jpeg_tpu/ops/lz4t_decode.py``'s, at depth caps 1 and 4.
* K3's plain version: ``resolve_rooted_ref`` is identical to the
  interpret-mode Pallas ``resolve_blocks_mxu`` on a fully rooted program
  (the model of ``tests/test_lz4t_decode_device.py::TestMXUResolve``).
* ``resolve_blocks`` (pointer doubling) is identical to JAX's.
* ``decode_fast_device(frame, "cpu")`` returns the input; malformed frames
  raise ``FastFormatError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops import lz4t_decode as jax_decode

from lz4jpeg_tpu_torch.formats.fast_frame import FastFormatError, encode_fast
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.lz4t_decode import (
    build_copy_program_fast,
    decode_fast_device,
    depth_to_steps,
    resolve_blocks,
    resolve_rooted,
    resolve_rooted_ref,
    root_program,
)
from lz4jpeg_tpu_torch.utils.inputs import generate_text


def mixed_payload(seed=0) -> bytes:
    """Compressible text + incompressible noise (raw-stored) + ragged tail."""
    rng = np.random.default_rng(seed)
    text = generate_text(130_000, rng)
    noise = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    return text + noise + text[:12_345]


CHAINS = b"A" * 70000 + b"BC" * 40000 + b"xyz" * 11111  # deepest chains


@pytest.fixture(scope="module")
def frames():
    data = mixed_payload()
    return {
        "native64k": (native_backend().encode_fast(data), data),
        "spec16k": (encode_fast(data, block_log=14), data),
        "chains": (native_backend().encode_fast(CHAINS), CHAINS),
    }


@pytest.mark.parametrize("name", ["native64k", "spec16k", "chains"])
@pytest.mark.parametrize("depth_cap", [1, 4])
@pytest.mark.parametrize("engine", ["native", "python"])
def test_copy_program_matches_jax(frames, name, depth_cap, engine):
    frame, _ = frames[name]
    got = build_copy_program_fast(frame, depth_cap, engine=engine)
    want = jax_decode.build_copy_program_fast(frame, depth_cap)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w) and g.dtype == w.dtype
    assert got[3:] == want[3:]


def test_rooted_resolve_matches_interpret_mode_mxu(frames):
    frame, data = frames["spec16k"]
    lit, src, _, p, _ = build_copy_program_fast(frame, depth_cap=1)
    root = root_program(torch.from_numpy(src))
    got = resolve_rooted_ref(torch.from_numpy(lit), root).numpy()
    want = np.asarray(jax_decode.resolve_blocks_mxu(
        jnp.asarray(lit), jnp.asarray(root.numpy()), interpret=True))
    assert np.array_equal(got, want)
    resolve_rooted.launches = 0
    assert torch.equal(resolve_rooted(torch.from_numpy(lit), root),
                       torch.from_numpy(got))
    assert resolve_rooted.launches == 0  # CPU: the plain version ran


@pytest.mark.parametrize("name", ["native64k", "chains"])
def test_pointer_doubling_matches_jax(frames, name):
    frame, _ = frames[name]
    lit, src, _, _, depth = build_copy_program_fast(frame)
    steps = depth_to_steps(depth)
    got = resolve_blocks(torch.from_numpy(lit), torch.from_numpy(src), steps)
    want = jax_decode.resolve_blocks(jnp.asarray(lit), jnp.asarray(src), steps)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4, 5, 1000])
def test_depth_to_steps_matches_jax(depth):
    assert depth_to_steps(depth) == jax_decode.depth_to_steps(depth)


@pytest.mark.parametrize("name", ["native64k", "spec16k", "chains"])
def test_cpu_device_decode_returns_input(frames, name):
    frame, data = frames[name]
    assert decode_fast_device(frame, "cpu") == data


@pytest.mark.parametrize("data", [b"", b"hello hello hello hello hello!"])
def test_cpu_device_decode_small(data):
    assert decode_fast_device(encode_fast(data), torch.device("cpu")) == data


@pytest.mark.parametrize("engine", ["native", "python"])
def test_malformed_frames_raise(frames, engine):
    frame, _ = frames["native64k"]
    bad = [
        b"LZ4Tgarbage",
        b"NOPE" + frame[4:],
        frame[:4] + b"\x07" + frame[5:],  # version
        frame[:30],  # truncated size table / payload
    ]
    for blob in bad:
        with pytest.raises(FastFormatError):
            build_copy_program_fast(blob, engine=engine)
    with pytest.raises(FastFormatError):
        decode_fast_device(frame[:30], "cpu")


def test_corrupt_literal_fails_the_checksum(frames):
    frame, _ = frames["native64k"]
    blob = bytearray(frame)
    blob[-50] ^= 0x01  # a literal of the last (ragged) block
    with pytest.raises(FastFormatError, match="checksum"):
        decode_fast_device(bytes(blob), "cpu")


@pytest.mark.parametrize("bad", [
    (torch.zeros((1, 8), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int32)),
    (torch.zeros((1, 8), dtype=torch.uint8), torch.zeros((1, 8), dtype=torch.int64)),
    (torch.zeros((1, 8), dtype=torch.uint8), torch.zeros((1, 9), dtype=torch.int32)),
    (torch.zeros(8, dtype=torch.uint8), torch.zeros(8, dtype=torch.int32)),
    (torch.zeros((1, 16), dtype=torch.uint8)[:, ::2], torch.zeros((1, 8), dtype=torch.int32)),
    (torch.zeros((1, 8), dtype=torch.uint8, device="meta"),
     torch.zeros((1, 8), dtype=torch.int32, device="meta")),
])
def test_resolve_wrapper_checks_its_input(bad):
    with pytest.raises((TypeError, ValueError)):
        resolve_rooted(*bad)


def test_unsupported_decode_device_raises(frames):
    with pytest.raises(ValueError, match="unsupported device"):
        decode_fast_device(frames["chains"][0], "meta")
