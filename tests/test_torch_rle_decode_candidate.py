"""The membership packed16 decode's port (``lz4jpeg_tpu_torch/profiles/
rle_decode.py``) on the CPU, held against the TPU candidate and the JAX
package's decode.

``profiles/pallas_rle_decode.py`` is loaded by file path, as
``tests/test_torch_candidates.py`` loads probes, and
``rle_decode_packed16_pallas`` runs with ``interpret=True``; the JAX
package's ``ops/rle.py::rle_decode_packed16`` (a float32 membership einsum
at HIGHEST precision, exact for these values) is the second reference.  JAX
gets the words as uint16, the port as int16 holding the same bits.  On a
CPU tensor the wrapper runs its plain version,
``ops/pack16.py::pack16_decode_ref``.

Tolerance: none.  Every comparison is exact equality of int32 arrays.
"""

import importlib.util
import json
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops.rle import rle_decode_packed16 as jax_decode
from lz4jpeg_tpu.ops.rle import rle_encode_packed16 as jax_encode

from lz4jpeg_tpu_torch.ops.rle import rle_encode_packed16
from lz4jpeg_tpu_torch.profiles import rle_decode as rd
from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows

_PROFILES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "profiles")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PROFILES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_decode = _load("pallas_rle_decode")


def _both(words_u16, lengths, out_size):
    """(port, Pallas in interpret mode, JAX einsum) decodes of the words."""
    ours = rd.rle_decode_membership(
        torch.from_numpy(np.array(words_u16).view(np.int16)),
        torch.from_numpy(lengths.astype(np.int32)), out_size)
    w, l = jnp.asarray(words_u16), jnp.asarray(lengths.astype(np.int32))
    n = words_u16.shape[0]
    pallas = np.asarray(pallas_decode.rle_decode_packed16_pallas(
        w, l, out_size, interpret=True))[:n]
    return ours, pallas, np.asarray(jax_decode(w, l, out_size))


def _assert_all_equal(ours, pallas, einsum):
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), einsum)


def _encoded(sym):
    """JAX's packed16 encode of int16 symbols, as uint16 words and lengths;
    the port's encode gives the same bits."""
    w, l = jax_encode(jnp.asarray(sym, jnp.int16))
    pw, pl_ = rle_encode_packed16(torch.from_numpy(sym.astype(np.int16)))
    np.testing.assert_array_equal(pw.numpy().view(np.uint16), np.asarray(w))
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(l))
    return np.asarray(w), np.asarray(l)


def test_the_probes_structured_check():
    """``pallas_rle_decode.py:84-95``: 1,024 rows of runs of zeros and small
    values."""
    w, l = _encoded(rd.structured_symbols(1024, 64, seed=0))
    _assert_all_equal(*_both(w, l, 64))


@pytest.mark.parametrize("k,n", [(64, 300), (32, 5), (64, 1)])
def test_random_symbols_any_n(k, n):
    """Random symbols, N no multiple of 256 (the TPU wrapper padded to it;
    the port takes any N)."""
    rng = np.random.default_rng(k + n)
    sym = rng.integers(-511, 512, size=(n, k))
    sym = np.where(rng.random((n, k)) < 0.5, np.roll(sym, 1, axis=1), sym)
    w, l = _encoded(sym)
    _assert_all_equal(*_both(w, l, k))


@pytest.mark.parametrize("k,out_size", [(64, 40), (64, 1), (32, 20)])
def test_out_size_below_l(k, out_size):
    w, l = _encoded(rd.structured_symbols(260, k, seed=out_size))
    _assert_all_equal(*_both(w, l, out_size))


@pytest.mark.parametrize("k", [64, 32])
@pytest.mark.parametrize("out_size_of", [lambda k: k, lambda k: k // 2 + 3])
def test_non_canonical_words(k, out_size_of):
    """A valid word 0 (value -512, count 1), counts that overrun out_size,
    lengths shorter than the nonzero words, odd, negative and oversized
    lengths, no valid slot (``utils/inputs.py::crafted_packed16_rows``)."""
    words, lengths = crafted_packed16_rows(k, np.random.default_rng(k),
                                           n_random=40)
    _assert_all_equal(*_both(words.view(np.uint16), lengths, out_size_of(k)))


def test_plain_version_is_the_packed16_decode():
    from lz4jpeg_tpu_torch.ops import pack16

    words, lengths = crafted_packed16_rows(64, np.random.default_rng(3))
    w, l = torch.from_numpy(words), torch.from_numpy(lengths)
    assert torch.equal(rd.rle_decode_membership_ref(w, l, 64),
                       pack16.pack16_decode(w, l, 64))
    before = rd.rle_decode_membership.launches
    rd.rle_decode_membership(w, l, 64)
    assert rd.rle_decode_membership.launches == before


@pytest.mark.parametrize("shape", [(64,), (2, 3, 64)])
def test_refusals_of_both(shape):
    bad = np.zeros(shape, np.uint16)
    with pytest.raises(ValueError):
        pallas_decode.rle_decode_packed16_pallas(
            jnp.asarray(bad), jnp.zeros(2, jnp.int32), 64, interpret=True)
    with pytest.raises(ValueError):
        rd.rle_decode_membership(torch.from_numpy(bad.view(np.int16)),
                                 torch.zeros(2, dtype=torch.int32), 64)


@pytest.mark.parametrize("k,out_size", [(16, 16), (128, 64), (64, 65),
                                        (32, 0), (32, 33)])
def test_the_gate_refuses_on_the_cpu_too(k, out_size):
    """The port's gate (L 32 or 64, 1 ≤ out_size ≤ L) holds on every device,
    plain version included; the TPU candidate had none."""
    w = torch.zeros((3, k), dtype=torch.int16)
    lens = torch.zeros((3,), dtype=torch.int32)
    for fn in (rd.rle_decode_membership, rd.rle_decode_membership_ref):
        with pytest.raises(ValueError):
            fn(w, lens, out_size)


def test_membership_pairs_count_valid_runs():
    lens = torch.tensor([0, -3, 5, 200, 64], dtype=torch.int32)
    # runs: 0, 0 (floor(-3/2) clamps to 0), 2, 64 (capped at L), 32
    assert rd.membership_pairs(lens, 64, 10) == (2 + 64 + 32) * 10


def test_runner_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert rd.main(["--device", "cpu", "--frames", "1", "--side", "32",
                    "--runs", "1", "--reps", "1", "--output", "ab.json"]) == 0
    assert os.listdir(tmp_path) == ["ab.json"]
    art = json.loads((tmp_path / "ab.json").read_text())
    assert art["device"] == "cpu" and "card" not in art
    assert art["rows_decoded"] == 16 and art["segment"] == 64
    assert set(art["versions"]) == {"membership kernel", "K6 pack16_decode",
                                    "K8 pack16_decode_wide",
                                    "plain pack16_decode_ref"}
    assert all(v["host_ms"] > 0 for v in art["versions"].values())
    assert art["verdict"].startswith("on cpu:")


# ---------------------------------------------------------------------------
# The kernel's thread map and padded table, mirrored in numpy
# (``rd.emulate_membership``; csrc/rle_membership_kernel.cu)
# ---------------------------------------------------------------------------

_SOURCE = (Path(__file__).resolve().parents[1] / "lz4jpeg_tpu_torch" / "csrc"
           / "rle_membership_kernel.cu")


def test_membership_mirror_constants_are_the_sources():
    found = dict(re.findall(r"constexpr int k(Warps|Positions|Unroll) = (\d+);",
                            _SOURCE.read_text()))
    assert {k: int(v) for k, v in found.items()} == {
        "Warps": rd.WARPS, "Positions": rd.POSITIONS, "Unroll": rd.UNROLL}


@pytest.mark.parametrize("k", [32, 64])
def test_membership_thread_map_owns_each_position_once(k):
    rows, sub, positions = rd.membership_thread_map(k)
    assert rows * (k // rd.POSITIONS) == 32 and k % rd.UNROLL == 0
    for r in range(rows):
        assert sorted(positions[sub == r].ravel()) == list(range(k))


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("out_size_of", ["1", "L/2 + 3", "L"])
def test_membership_mirror_equals_the_plain_version(k, out_size_of):
    """Crafted rows (lengths 0, odd, negative and above 2L, a valid word 0,
    counts summing past L) and random ones, N off the rows a warp takes."""
    out_size = {"1": 1, "L/2 + 3": k // 2 + 3, "L": k}[out_size_of]
    words, lengths = crafted_packed16_rows(k, np.random.default_rng(k + 7),
                                           n_random=45)
    assert {0, 7, 2 * k + 10} <= set(lengths.tolist())
    got = rd.emulate_membership(words, lengths, out_size)
    want = rd.rle_decode_membership_ref(torch.from_numpy(words),
                                        torch.from_numpy(lengths), out_size)
    np.testing.assert_array_equal(got, want.numpy())


def test_membership_mirror_on_the_probes_check():
    w, l = _encoded(rd.structured_symbols(n=96))
    ours, pallas, einsum = _both(w, l, 64)
    got = rd.emulate_membership(w.view(np.int16), l, 64)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, einsum)


def test_the_floor_counts_packed_halves():
    # three instructions (HADD2, HSET2, HFMA2) test two pairs at once
    assert rd.MEMBERSHIP_INSTRUCTIONS == 1.5
    text = _SOURCE.read_text()
    assert "__hfma2(__hlt2(__habs2(__hsub2(" in text
    assert "const uint4 r = mine[e / 2 + u];" in text  # two entries a load


@pytest.mark.parametrize("k", [32, 64])
def test_membership_mirror_at_a_row_tile(k):
    """N at the rows a CTA takes in one pass of its grid-stride loop, and
    one off either side: the last row group full, or part empty."""
    tile = rd.WARPS * rd.membership_thread_map(k)[0]
    rng = np.random.default_rng(k + 11)
    for n in (tile - 1, tile, tile + 1):
        words, lengths = crafted_packed16_rows(k, rng, n_random=n)
        words, lengths = words[:n], lengths[:n]
        for out_size in (k, k // 2 + 3, 1):
            want = rd.rle_decode_membership_ref(torch.from_numpy(words),
                                                torch.from_numpy(lengths),
                                                out_size)
            np.testing.assert_array_equal(
                rd.emulate_membership(words, lengths, out_size), want.numpy())
