"""The matcher-sort probes' port (``lz4jpeg_tpu_torch/profiles/
bitonic_sort.py``, ``profiles/bucket_partition.py``) on the CPU, held
against the TPU probes.

``profiles/profile_pallas_sort.py`` is loaded by file path, as
``tests/test_torch_candidates.py`` loads probes, and its ``make_sort`` runs
with ``interpret=True`` (4-10 s a call here, so on one module-scoped pair of
blocks).  ``profiles/probe_bucket_partition.py``'s kernels are closures
inside its ``main()``, so nothing can import them: their expressions
(:48-57, :62-75) are restated below in jnp with ``jnp.roll`` and run through
``pl.pallas_call(..., interpret=True)``; a test pins ``pltpu.roll``'s
direction to ``jnp.roll``'s in interpret mode.  On a CPU tensor each wrapper
runs its plain torch version.

Tolerance: none.  Every comparison is exact equality of int32 arrays.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs
from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

_PROFILES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "profiles")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PROFILES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_sort = _load("profile_pallas_sort")


@pytest.fixture(scope="module")
def probe_pair():
    """Two blocks of the probe's data and the interpret-mode kernel's
    outputs, without and with the recorded-mask replay."""
    keys, pay = bs.probe_blocks(2, seed=5)
    k = jnp.asarray(keys.reshape(2, bs.ROWS, bs.LANES))
    p = jnp.asarray(pay.reshape(2, bs.ROWS, bs.LANES))
    plain = pallas_sort.make_sort(1, interpret=True)(k, p)
    replay = pallas_sort.make_sort(1, record_masks=True, interpret=True)(k, p)
    return keys, pay, [np.asarray(a) for a in plain], \
        [np.asarray(a) for a in replay]


def _tiles(a):
    return torch.from_numpy(np.ascontiguousarray(a)).view(-1, bs.ROWS, bs.LANES)


# ---------------------------------------------------------------------------
# The sort and its replay
# ---------------------------------------------------------------------------


def test_sort_matches_the_pallas_probe(probe_pair):
    keys, pay, (want_k, want_p), _ = probe_pair
    got_k, got_p = bs.bitonic_sort_blocks(_tiles(keys), _tiles(pay))
    assert got_k.shape == (2, bs.ROWS, bs.LANES) and got_k.dtype == torch.int32
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)


def test_replay_matches_the_pallas_probe(probe_pair):
    keys, pay, (sorted_k, _), (want_k, want_p) = probe_pair
    got_k, got_p = bs.bitonic_sort_blocks(_tiles(keys), _tiles(pay),
                                          record_masks=True)
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    # What the probe asserts of both: sorted keys, the input payload back.
    np.testing.assert_array_equal(want_k, sorted_k)
    np.testing.assert_array_equal(want_p, pay.reshape(want_p.shape))


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("tiled", [True, False])
def test_sort_matches_a_stable_argsort(seed, tiled):
    keys, pay = bs.probe_blocks(2, seed)
    k, p = torch.from_numpy(keys), torch.from_numpy(pay)
    if tiled:
        k, p = k.view(-1, bs.ROWS, bs.LANES), p.view(-1, bs.ROWS, bs.LANES)
    got_k, got_p = bs.bitonic_sort_blocks(k, p)
    assert got_k.shape == k.shape and got_p.shape == p.shape
    order = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(got_k.reshape(2, -1).numpy(),
                                  np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(got_p.reshape(2, -1).numpy(),
                                  np.take_along_axis(pay, order, 1))
    rk, rp = bs.bitonic_sort_blocks(k, p, record_masks=True)
    assert torch.equal(rk, got_k) and torch.equal(rp, p)


def test_sort_gather_is_the_library_answer():
    keys, pay = bs.probe_blocks(1, seed=9)
    want = bs.bitonic_sort_blocks_ref(torch.from_numpy(keys),
                                      torch.from_numpy(pay))
    got = bs.sort_gather(torch.from_numpy(keys), torch.from_numpy(pay))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("record", [False, True])
def test_duplicate_keys_keep_the_multiset(record):
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 5, size=(2, bs.SLOTS)).astype(np.int32)
    pay = rng.integers(-(2**31), 2**31, size=(2, bs.SLOTS)).astype(np.int32)
    got_k, got_p = bs.bitonic_sort_blocks(torch.from_numpy(keys),
                                          torch.from_numpy(pay), record)
    np.testing.assert_array_equal(got_k.numpy(), np.sort(keys, axis=1))
    if record:
        np.testing.assert_array_equal(got_p.numpy(), pay)
        return
    for b in range(2):
        assert sorted(zip(got_k[b].tolist(), got_p[b].tolist())) == \
            sorted(zip(keys[b].tolist(), pay[b].tolist()))


def test_crafted_blocks():
    pos = np.arange(bs.SLOTS, dtype=np.int64)
    blocks = np.stack([
        (pos << bs.LOG_SLOTS) | pos,                 # sorted
        (pos[::-1] << bs.LOG_SLOTS) | pos,           # reversed buckets
        (np.int64(77) << bs.LOG_SLOTS) | pos[::-1],  # one bucket, reversed
    ]).astype(np.int32)
    pay = np.arange(3 * bs.SLOTS, dtype=np.int32).reshape(3, bs.SLOTS)
    got_k, got_p = bs.bitonic_sort_blocks(torch.from_numpy(blocks),
                                          torch.from_numpy(pay))
    order = np.argsort(blocks, axis=1, kind="stable")
    np.testing.assert_array_equal(got_k.numpy(), np.sort(blocks, axis=1))
    np.testing.assert_array_equal(got_p.numpy(),
                                  np.take_along_axis(pay, order, 1))


def test_sort_refuses_what_the_probe_refuses():
    flat = np.zeros((bs.SLOTS,), np.int32)
    with pytest.raises(ValueError):
        pallas_sort.make_sort(1, interpret=True)(jnp.asarray(flat),
                                                 jnp.asarray(flat))
    with pytest.raises(ValueError):
        bs.bitonic_sort_blocks(torch.from_numpy(flat), torch.from_numpy(flat))


def test_sort_refusals_of_the_port():
    """Shapes and types the wrapper refuses on every device (the probe's
    BlockSpec would also take a (B, 128, 64) array)."""
    x = torch.zeros((1, bs.ROWS, bs.LANES), dtype=torch.int32)
    with pytest.raises(ValueError, match="expected"):
        bs.bitonic_sort_blocks(x[:, :, :64], x[:, :, :64])
    with pytest.raises(ValueError, match="differ"):
        bs.bitonic_sort_blocks(x, torch.zeros((2, bs.SLOTS), dtype=torch.int32))
    with pytest.raises(TypeError):
        bs.bitonic_sort_blocks(x.long(), x.long())


def test_sort_wrapper_counts_no_cpu_launch():
    before = bs.bitonic_sort_blocks.launches
    keys, pay = bs.probe_blocks(1)
    bs.bitonic_sort_blocks(torch.from_numpy(keys), torch.from_numpy(pay))
    assert bs.bitonic_sort_blocks.launches == before
    assert bs.sort_attributes(False, "cpu")["registers"] is None


# ---------------------------------------------------------------------------
# The two stage kernels
# ---------------------------------------------------------------------------

LANES = 128


def _conc_kernel(x_ref, o_ref):
    """``probe_bucket_partition.py:45-57`` with ``jnp.roll``."""
    w = x_ref[0]
    col = jax.lax.broadcasted_iota(jnp.int32, w.shape, 1)
    for b in range(32):
        step = 1 << (b % 7)
        incoming = jnp.roll(w, LANES - step, axis=1)
        ok = col < (LANES - step)
        arrive = ok & ((incoming & 1) != 0) & ((incoming & step) != 0)
        depart = ((w & 1) != 0) & ((w & step) != 0)
        w = jnp.where(arrive, incoming - step, jnp.where(depart, 0, w))
    o_ref[0] = w


def _bitonic_kernel(x_ref, o_ref):
    """``probe_bucket_partition.py:59-75`` with ``jnp.roll``."""
    w = x_ref[0]
    col = jax.lax.broadcasted_iota(jnp.int32, w.shape, 1)
    for b in range(32):
        d = 1 << (b % 7)
        sel = (col & d) == 0
        partner = jnp.where(sel, jnp.roll(w, LANES - d, axis=1),
                            jnp.roll(w, d, axis=1))
        keep_min = sel == ((col & (2 * d)) == 0)
        w = jnp.where(keep_min, jnp.minimum(w, partner),
                      jnp.maximum(w, partner))
    o_ref[0] = w


def _pallas(kernel, x):
    spec = pl.BlockSpec((1, 128, LANES), lambda i: (i, 0, 0))
    return np.asarray(pl.pallas_call(
        kernel, grid=(x.shape[0],), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32), interpret=True,
    )(jnp.asarray(x)))


def test_pltpu_roll_is_jnp_roll_in_interpret_mode():
    def kernel(x_ref, o_ref):
        o_ref[0] = pltpu.roll(x_ref[0], shift=LANES - 3, axis=1)

    x = np.arange(2 * 128 * LANES, dtype=np.int32).reshape(2, 128, LANES)
    np.testing.assert_array_equal(_pallas(kernel, x),
                                  np.roll(x, LANES - 3, axis=2))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("name,kernel", [
    ("concentration_stages", _conc_kernel),
    ("compare_exchange_stages", _bitonic_kernel),
])
def test_stage_kernels_match_the_probe(n, name, kernel):
    x = bp.probe_tiles(n, seed=n).numpy()
    want = _pallas(kernel, x)
    _, fn, ref, _ = bp.KERNELS[name]
    got = fn(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", list(bp.KERNELS))
def test_stage_kernels_on_crafted_rows(name):
    """Rows of all bits set, of zeros, of the concentration's arrive and
    depart bits in every lane, and the int32 limits below 2^30."""
    x = np.zeros((1, 128, LANES), np.int32)
    x[0, 0] = (1 << 30) - 1
    x[0, 2] = 1 + 2 + 4 + 8 + 16 + 32 + 64
    x[0, 3] = np.arange(LANES) * 3 + 1
    x[0, 4] = np.arange(LANES)[::-1]
    _, fn, _, _ = bp.KERNELS[name]
    kernel = _conc_kernel if name == "concentration_stages" else _bitonic_kernel
    np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(),
                                  _pallas(kernel, x))


def test_stage_kernels_refuse_other_shapes():
    for name in bp.KERNELS:
        fn = bp.KERNELS[name][1]
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 64, LANES), dtype=torch.int32))
        with pytest.raises(TypeError):
            fn(torch.zeros((2, 128, LANES), dtype=torch.int64))
    assert bp.stage_attributes(bp.CONCENTRATION, "cpu")["ctas_per_sm"] is None


def test_stage_count_arithmetic_is_the_probes():
    counts = bp.stage_counts()
    assert (counts["pa"], counts["bitonic_stages"], counts["radix_stages"]) \
        == (16384, 105, 448)
    assert bs.STAGES == counts["bitonic_stages"]


# ---------------------------------------------------------------------------
# The runners, at a tiny size, write only their --output
# ---------------------------------------------------------------------------


def test_sort_runner_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = bs.run_bitonic_sort("cpu", blocks=2, check_blocks=1, runs=1, reps=1,
                              output="sort.json")
    assert os.listdir(tmp_path) == ["sort.json"]
    art = json.loads((tmp_path / "sort.json").read_text())
    assert art["device"] == "cpu" and art["timer"] == "host clock"
    assert "card" not in art and art["issue_bound_ms"] is None
    assert [r["row"] for r in res["rows"]] == [
        "bitonic sort 2-op", "bitonic sort 2-op + reverse replay",
        "torch.sort keys only", "torch.sort + torch.gather",
        "plain version (torch ops)"]
    assert all("ms" not in r and r["host_ms"] > 0 for r in res["rows"])
    assert res["bytes_bound_ms"] == pytest.approx(2 * 16 * bs.SLOTS / 3.35e9)


def test_stage_runner_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert bp.main(["--device", "cpu", "--blocks", "1", "2", "--runs", "1",
                    "--reps", "1", "--output", "stages.json"]) == 0
    assert os.listdir(tmp_path) == ["stages.json"]
    art = json.loads((tmp_path / "stages.json").read_text())
    assert [s["blocks"] for s in art["sizes"]] == [1, 2]
    for size in art["sizes"]:
        assert set(size["kernels"]) == set(bp.KERNELS)
        assert size["concentration_over_compare_exchange"] > 0
        for rec in size["kernels"].values():
            assert rec["host_ms"] > 0 and rec["plain_host_ms"] > 0
