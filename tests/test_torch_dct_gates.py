"""The fused-DCT gates (``lz4jpeg_tpu_torch/profiles/dct_gates.py``) on the
CPU, held against the TPU probe's own kernel bodies.

``profiles/profile_fused_dct_gates.py`` defines its three kernels inside
``main``; they are restated verbatim below and run with
``pl.pallas_call(..., interpret=True)``:

* the basis product (``dot_kernel``) on the probe's (512, 64) integer
  pixels and the luma basis, and at other row counts: the port's plain
  version against the interpret-mode body and ``jnp.matmul(...,
  precision="highest")``, every output of all three within ``64 · 2⁻²⁴ ·
  Σ_k |x_k · m_jk|`` of a float64 product (the count that is not
  bit-equal is printed);
* the minor-dims transpose (``tr_kernel``) at the probe's (8, 256, 8) and
  (8, 128, 4) and ragged shapes: exact;
* the lane split (``split_kernel``) at the probe's (8, 2048) → (8, 256, 8):
  exact; other widths against numpy's reshape.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lz4jpeg_tpu.ops.fused import _table_key as jax_table_key
from lz4jpeg_tpu.ops.fused import forward_basis as jax_forward_basis
from lz4jpeg_tpu.oracle.jpeg_oracle import LUMINANCE_QUANTIZATION_TABLE

from lz4jpeg_tpu_torch.ops.stream import stream_copy
from lz4jpeg_tpu_torch.profiles import dct_gates as dg
from lz4jpeg_tpu_torch.profiles import timing


# -- the probe's kernel bodies, verbatim ------------------------------------------


def dot_kernel(x_ref, m_ref, o_ref):
    """``profile_fused_dct_gates.py:26-32``."""
    o_ref[:] = jax.lax.dot_general(
        x_ref[:], m_ref[:],
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def tr_kernel(x_ref, o_ref):
    """``profile_fused_dct_gates.py:50-51``."""
    o_ref[:] = jnp.transpose(x_ref[:], (0, 2, 1))


def split_kernel(x_ref, o_ref):
    """``profile_fused_dct_gates.py:70-71``."""
    o_ref[:] = x_ref[:].reshape(8, 256, 8)


def _interpret(kernel, out_shape, *args):
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(*(jnp.asarray(a) for a in args)))


# -- the basis product ----------------------------------------------------------------


def test_luma_basis_is_the_probes():
    m, _ = jax_forward_basis(8, 8, jax_table_key(LUMINANCE_QUANTIZATION_TABLE))
    np.testing.assert_array_equal(dg.luma_basis().numpy(),
                                  m.astype(np.float32))


@pytest.mark.parametrize("rows", [512, 1, 65, 1000])
def test_basis_dot_within_the_bound_of_float64(rows, capsys):
    rng = np.random.default_rng(rows)
    x = dg.probe_pixels(rows, rng)
    m = dg.luma_basis()
    ours = dg.basis_dot(x, m)
    assert ours.dtype == torch.float32 and ours.shape == (rows, 64)
    assert torch.equal(ours, dg.basis_dot_ref(x, m))
    body = torch.from_numpy(_interpret(dot_kernel, (rows, 64), x.numpy(),
                                       m.numpy()).copy())
    highest = torch.from_numpy(np.array(jnp.matmul(
        jnp.asarray(x.numpy()), jnp.asarray(m.numpy()).T, precision="highest")))
    for name, got in (("port", ours), ("interpret body", body),
                      ("jnp highest", highest)):
        err = dg.dot_error(got, x, m)
        assert err["within"], (name, err)
    for name, other in (("interpret body", body), ("jnp highest", highest)):
        cmp = dg.ulp_compare(ours, other)
        with capsys.disabled():
            print(f"\nbasis product at {rows} rows: port vs {name}: "
                  f"{cmp['differ']}/{cmp['outputs']} not bit-equal (max "
                  f"{cmp['max_ulp']} ulp)")


def test_dot_error_and_ulps_see_a_one_ulp_change():
    x = dg.probe_pixels(8, np.random.default_rng(0))
    m = dg.luma_basis()
    good = dg.basis_dot(x, m)
    bad = good.clone()
    bad[3, 5] = torch.nextafter(bad[3, 5], torch.tensor(np.inf))
    assert dg.ulp_compare(good, bad) == {"differ": 1, "outputs": 512,
                                         "max_ulp": 1}
    assert dg.dot_error(good, x, m)["within"]
    worse = good.clone()
    worse[0, 0] += 0.5
    assert not dg.dot_error(worse, x, m)["within"]
    signs = torch.tensor([-0.0, 0.0, 1.0, -1.0])
    assert dg.ulp_compare(signs, torch.tensor([0.0, -0.0, 1.0, -1.0]))[
        "differ"] == 0
    below = torch.nextafter(torch.tensor(0.0), torch.tensor(-1.0))
    assert dg.ulp_compare(torch.tensor([below]), torch.tensor([0.0]))[
        "max_ulp"] == 1


def test_dot_bounds():
    bound, by, bytes_ms, flops_ms = dg.dot_bound_ms(2_097_152)
    assert (round(bound, 4), by) == (0.3205, "bytes")
    assert round(flops_ms, 4) == 0.2564 and bytes_ms == bound
    assert round(timing.bytes_bound_ms(1_073_758_208), 4) == 0.3205


@pytest.mark.parametrize("x_shape,m_shape,dtype,error", [
    ((16, 32), (64, 64), torch.float32, ValueError),
    ((16, 64), (64, 32), torch.float32, ValueError),
    ((16, 64), (32, 64), torch.float32, ValueError),
    ((2, 16, 64), (64, 64), torch.float32, ValueError),
    ((16, 64), (64, 64), torch.float64, TypeError)])
def test_basis_dot_refusals(x_shape, m_shape, dtype, error):
    x = torch.zeros(x_shape, dtype=dtype)
    m = torch.zeros(m_shape, dtype=dtype)
    for fn in (dg.basis_dot, dg.basis_dot_ref):
        with pytest.raises(error):
            fn(x, m)


# -- the transpose and the split --------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 256, 8), (8, 128, 4), (3, 7, 5),
                                   (2, 130, 64), (1, 1, 1), (0, 4, 4)])
def test_minor_transpose_equals_the_probe_body(shape):
    xs = np.random.default_rng(sum(shape)).integers(
        0, 256, size=shape).astype(np.float32)
    got = dg.minor_transpose(torch.from_numpy(xs))
    assert got.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_array_equal(got.numpy(), xs.transpose(0, 2, 1))
    if shape[0]:
        np.testing.assert_array_equal(
            got.numpy(), _interpret(tr_kernel, got.shape, xs))


@pytest.mark.parametrize("shape", [(8, 256, 0), (8, 0, 8), (8, 4, 65),
                                   (8, 256), (2, 8, 256, 8)])
def test_minor_transpose_refusals(shape):
    x = torch.zeros(shape)
    for fn in (dg.minor_transpose, dg.minor_transpose_ref):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(TypeError):
        dg.minor_transpose(torch.zeros((2, 3, 4), dtype=torch.int32))


def test_lane_split_equals_the_probe_body():
    xs = np.random.default_rng(0).integers(0, 256, size=(8, 2048)).astype(
        np.float32)
    before = stream_copy.launches
    got = dg.lane_split(torch.from_numpy(xs), 8)
    assert stream_copy.launches == before  # the CPU runs the plain version
    assert got.shape == (8, 256, 8)
    np.testing.assert_array_equal(got.numpy(),
                                  _interpret(split_kernel, (8, 256, 8), xs))
    assert got.data_ptr() != torch.from_numpy(xs).data_ptr()


@pytest.mark.parametrize("shape,tw", [((3, 24), 4), ((5, 7), 7), ((2, 3, 16), 8),
                                      ((12,), 3)])
def test_lane_split_other_widths(shape, tw):
    xs = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = dg.lane_split(torch.from_numpy(xs), tw)
    np.testing.assert_array_equal(
        got.numpy(), xs.reshape(*shape[:-1], shape[-1] // tw, tw))
    assert torch.equal(got, dg.lane_split_ref(torch.from_numpy(xs), tw))


@pytest.mark.parametrize("tw", [0, 5, -1])
def test_lane_split_refusals(tw):
    for fn in (dg.lane_split, dg.lane_split_ref):
        with pytest.raises(ValueError):
            fn(torch.zeros((8, 2048)), tw)


def test_moved_bounds_and_no_cpu_launch():
    lum = torch.zeros((32_768, 256, 8))
    assert round(dg.moved_bound_ms(lum), 4) == 0.1603
    assert round(dg.moved_bound_ms(torch.zeros((32_768, 128, 4))), 4) == 0.0401
    assert round(dg.moved_bound_ms(torch.zeros((32_768, 2048))), 4) == 0.1603
    counts = (dg.basis_dot.launches, dg.minor_transpose.launches)
    dg.minor_transpose(torch.zeros((2, 3, 4)))
    dg.basis_dot(torch.zeros((2, 64)), torch.zeros((64, 64)))
    assert counts == (dg.basis_dot.launches, dg.minor_transpose.launches)
    assert dg.attributes(dg.TRANSPOSE, 8, "cpu")["shared_bytes"] is None


# -- the run --------------------------------------------------------------------------------


def test_run_on_the_cpu_writes_only_its_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert dg.main(["--device", "cpu", "--rows", "600", "--bands", "3",
                    "--runs", "1", "--reps", "1", "--output", "a.json"]) == 0
    assert os.listdir(tmp_path) == ["a.json"]
    art = json.loads((tmp_path / "a.json").read_text())
    assert art["device"] == "cpu" and "card" not in art
    assert art["timer"] == "host clock" and art["verdict"].startswith("on cpu:")
    assert art["checks"]["dot"]["kernel"]["within"]
    assert [r["site"] for r in art["timed"]] == [
        f"profile_fused_dct_gates.py:{line}" for line in (35, 56, 56, 75)]
    assert [r["shape"] for r in art["timed"]] == [
        [600, 64], [3, 256, 8], [3, 128, 4], [3, 2048]]
    assert all(r["host_ms"] > 0 and r["share"] is None for r in art["timed"])
    assert art["timed"][0]["bound_by"] == "bytes"


# -- the transpose's two routes ------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 128, 4), (2, 256, 8), (5, 132, 2),
                                   (2, 132, 8), (1, 4, 4), (3, 12, 2),
                                   (4, 8, 8)])
def test_vector_route_lanes_give_the_transpose(shape):
    """The vector route's lane swaps, mirrored in numpy, give the probe
    body's transpose."""
    xs = np.random.default_rng(sum(shape)).integers(
        0, 1 << 20, size=shape).astype(np.float32)
    got = dg.emulate_vector_route(torch.from_numpy(xs))
    np.testing.assert_array_equal(got.numpy(), xs.transpose(0, 2, 1))
    if shape in ((3, 128, 4), (2, 256, 8)):
        np.testing.assert_array_equal(
            got.numpy(), _interpret(tr_kernel, got.shape, xs))


@pytest.mark.parametrize("shape", [(2, 130, 4), (2, 128, 3), (2, 128, 16)])
def test_vector_route_mirror_refuses_what_the_route_does_not_take(shape):
    with pytest.raises(ValueError):
        dg.emulate_vector_route(torch.zeros(shape))


@pytest.mark.parametrize("b,bw,tw,in_ptr,out_ptr,route", [
    (32_768, 128, 4, 0, 1 << 20, "vector"),   # the timed chroma bands
    (32_768, 256, 8, 256, 512, "vector"),     # the timed luma bands
    (5, 132, 2, 16, 32, "vector"),
    (2, 130, 8, 0, 0, "tile"),                # ragged bw
    (2, 128, 3, 0, 0, "tile"),                # tw outside 2, 4, 8
    (2, 128, 16, 0, 0, "tile"),
    (2, 128, 64, 0, 0, "tile"),
    (2, 128, 4, 4, 0, "tile"),                # a base off 16 bytes
    (2, 128, 4, 0, 8, "tile"),
    ((1 << 32) // 32, 128, 4, 0, 0, "tile"),  # 2³² four-column groups
])
def test_transpose_route_is_chosen_by_shape_and_alignment(b, bw, tw, in_ptr,
                                                          out_ptr, route):
    assert dg.transpose_route(b, bw, tw, in_ptr, out_ptr) == route


def test_route_counts_start_at_zero_and_the_cpu_counts_none():
    assert set(dg.minor_transpose.routes) == set(dg.ROUTES)
    before = dict(dg.minor_transpose.routes)
    dg.minor_transpose(torch.zeros((2, 128, 4)))
    assert dg.minor_transpose.routes == before
    assert dg.attributes(dg.TRANSPOSE_VEC, 4, "cpu")["registers"] is None


# -- the basis product's ring and thread map ------------------------------------------
# ``csrc/dct_gate_kernel.cu::basis_dot_kernel`` runs on the card only; its
# schedule (tile → CTA, ring slot, the parities its producer and consumers
# wait on) and its thread → (row, output) map are mirrored in
# ``profiles/dct_gates.py`` and held here: every row computed once, every
# slot filled before it is read and released before it is filled again
# (the mbarriers modelled by their completed phases), the map a bijection
# over a tile whose shared loads are one wavefront each.

import re
from pathlib import Path

DOT_SOURCE = (Path(dg.__file__).resolve().parent.parent / "csrc"
              / "dct_gate_kernel.cu")
DOT_ROWS = (0, 1, 63, 64, 65, 4099, 2_097_152)


def _ring_ok(sched: np.ndarray, stages: int, warps: int, seed: int) -> bool:
    """Run one CTA's producer and ``warps`` consumer warps on ``sched`` in a
    seeded random interleaving, with each mbarrier as its count of completed
    phases (a wait on parity p passes while the count's parity is not p):
    "full" completes on the producer's fill, "empty" on the consumer warps'
    ``warps`` arrivals.  Asserts that a fill finds its slot released and a
    read finds the tile it expects; returns True once every warp has read
    every tile (a deadlock raises)."""
    rng = np.random.default_rng(seed)
    full, empty = [0] * stages, [0] * stages
    arrived = [0] * stages
    holds = [None] * stages  # the tile a slot holds, None once released
    fills, reads = 0, [0] * warps
    t = len(sched)
    while fills < t or min(reads) < t:
        ready = []
        if fills < t:
            _, s, p, _ = sched[fills]
            if (empty[s] & 1) != p:
                ready.append(-1)
        for w in range(warps):
            if reads[w] < t:
                _, s, _, p = sched[reads[w]]
                if (full[s] & 1) != p:
                    ready.append(w)
        assert ready, "deadlock"
        who = ready[rng.integers(len(ready))]
        if who < 0:
            tile, s, _, _ = sched[fills]
            assert holds[s] is None, "a slot refilled before its release"
            holds[s] = tile
            full[s] += 1
            fills += 1
        else:
            tile, s, _, _ = sched[reads[who]]
            assert holds[s] == tile, "a read found another tile"
            arrived[s] += 1
            if arrived[s] == warps:
                arrived[s] = 0
                empty[s] += 1
                holds[s] = None
            reads[who] += 1
    return True


@pytest.mark.parametrize("n", DOT_ROWS)
@pytest.mark.parametrize("resident", [1, 3, 264])
def test_dot_schedule_computes_every_row_once(n, resident):
    plan = dg.dot_plan(n, resident)
    assert plan.ctas == min(plan.tiles, resident)
    sched = dg.dot_schedule(plan)
    tiles = np.concatenate([c[:, 0] for c in sched]) if sched else np.array([])
    assert np.array_equal(np.sort(tiles), np.arange(plan.tiles))
    rows = np.concatenate([np.arange(t * plan.tile_rows, min(
        (t + 1) * plan.tile_rows, n)) for t in tiles]) if n else np.array([])
    assert np.array_equal(np.sort(rows), np.arange(n))
    counts = [len(c) for c in sched]
    assert max(counts, default=0) - min(counts, default=0) <= 1
    warps = (plan.threads - 32) // 32
    for b in {0, plan.ctas - 1} if plan.ctas else ():
        if len(sched[b]) <= 200:
            assert _ring_ok(sched[b], plan.stages, warps, seed=n + b)


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("tiles_a_cta", [1, 2, 3, 5, 9])
def test_dot_ring_ends_mid_ring(stages, tiles_a_cta):
    """Tile counts a CTA that end before, on and past a wrap of the ring,
    for three CTAs whose last takes one tile fewer."""
    tile = dg.DOT_TILE_ROWS
    n = (3 * tiles_a_cta - 1) * tile - 7
    plan = dg.dot_plan(n, 3, stages=stages)
    sched = dg.dot_schedule(plan)
    want = [tiles_a_cta] * 2 + ([tiles_a_cta - 1] if tiles_a_cta > 1 else [])
    assert [len(c) for c in sched] == want
    for b, cta in enumerate(sched):
        assert np.array_equal(cta[:, 1], np.arange(len(cta)) % stages)
        for seed in range(3):
            assert _ring_ok(cta, stages, 2, seed)


def test_a_wrong_parity_is_caught():
    """The ring model fails a producer that waits on the consumers' parity
    (it refills a slot before its release) and consumers that wait on the
    producer's (they deadlock or read a stale slot)."""
    plan = dg.dot_plan(20 * dg.DOT_TILE_ROWS, 1, stages=2)
    good = dg.dot_schedule(plan)[0]
    for bad in (good[:, [0, 1, 3, 3]], good[:, [0, 1, 2, 2]]):
        with pytest.raises(AssertionError):
            for seed in range(20):
                _ring_ok(bad, 2, 2, seed)


def _wavefronts(byte_addrs, width=16):
    """Shared-memory wavefronts of one warp load of ``width``-byte vectors at
    these addresses: the most distinct 4-byte words any bank serves."""
    words = {a // 4 + i for a in set(byte_addrs) for i in range(width // 4)}
    per_bank = {}
    for w in words:
        per_bank[w % 32] = per_bank.get(w % 32, 0) + 1
    return max(per_bank.values())


@pytest.mark.parametrize("k", range(0, 64, 4))
def test_dot_thread_map_is_a_bijection_with_cheap_loads(k):
    """The map covers a tile once; at each k each warp's x load (row r of
    its two row groups, the float4 at k) is one wavefront and its basis
    load (16 contiguous float4 of mt[k + e]) two, the fewest 512 bytes can
    take."""
    consumers, rows, cols = dg.dot_thread_map()
    br = dg.DOT_BLOCK_ROWS
    assert consumers % 32 == 0 and rows.shape == (consumers, br)
    assert cols.shape == (consumers, 4)
    cells = (rows[:, :, None] * dg.DEPTH + cols[:, None, :]).ravel()
    assert np.array_equal(np.sort(cells), np.arange(dg.DOT_TILE_ROWS * dg.DEPTH))
    group_stride = br * dg.DEPTH * 4 + 16
    for w in range(consumers // 32):
        lanes = np.arange(32 * w, 32 * w + 32)
        rg = rows[lanes, 0] // br
        assert len(set(rg)) == 2
        for r in range(br):
            x = rg * group_stride + r * dg.DEPTH * 4 + 4 * k
            assert _wavefronts(x) == 1
        for e in range(4):
            m = ((k + e) * dg.DEPTH + cols[lanes, 0]) * 4
            assert _wavefronts(m) == 2


def test_a_bank_conflict_is_caught():
    """Row groups a whole number of 128-byte lines apart (no 16-byte pad)
    put a warp's two x loads in the same banks: two wavefronts."""
    _, rows, _ = dg.dot_thread_map()
    rg = rows[:32, 0] // dg.DOT_BLOCK_ROWS
    assert _wavefronts(rg * dg.DOT_BLOCK_ROWS * dg.DEPTH * 4) == 2


def test_dot_mirror_matches_the_source():
    text = DOT_SOURCE.read_text()
    body = text[text.index("namespace dot {"):text.index("}  // namespace dot")]
    found = dict(re.findall(r"constexpr int k(TileRows|Stages|CtasPerSm|BlockRows)"
                            r" = (\d+);", body))
    assert {k: int(v) for k, v in found.items()} == {
        "TileRows": dg.DOT_TILE_ROWS, "Stages": dg.DOT_STAGES,
        "CtasPerSm": dg.DOT_CTAS_PER_SM, "BlockRows": dg.DOT_BLOCK_ROWS}
    plan = dg.dot_plan(2_097_152, 264)
    assert (plan.threads, plan.smem) == (160, 16_384 + 2 * 8 * 2_064 + 32)
