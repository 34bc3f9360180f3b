"""The forward megakernel's layout variants (``profiles/megakernel.py``'s KT
variants) on the CPU, held against the JAX package and against the TPU
probes' own chain restated in jnp.

On a CPU tensor each KT variant runs its plain torch version.  The probes'
kernels are closures inside their ``main()`` (``profiles/
probe_megakernel.py:108``, ``probe_megakernel_t.py:50``,
``probe_megakernel_v2.py:85``), so nothing can import them: the references
are the JAX package's ``ops/pallas_fwd.py::rgb_to_kt`` and
``forward_megakernel`` (interpret mode; it pads N to 2,048 blocks a call,
so the cases are few and each reference is computed once), ``ops/fused.py``,
``ops/color.py`` and the probe's XLA chain (``probe_megakernel.py:180-197``)
from those functions.

Tolerances: none.  The KT layout, the K1-arithmetic rows and the copy rows
are identical to their references; the split stage's words are identical
to the probe's chain and its run counts equal.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops.color import (
    chroma_subsample_422 as jax_subsample,
    rgb_to_ycbcr as jax_ycbcr,
)
from lz4jpeg_tpu.ops.fused import fused_forward_jnp, fused_forward_plane_jnp
from lz4jpeg_tpu.ops.pallas_fwd import forward_megakernel, rgb_to_kt as jax_kt

from lz4jpeg_tpu_torch.ops.fwd_megakernel import kt_tiles, rgb_to_kt
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.profiles import megakernel as mk
from lz4jpeg_tpu_torch.profiles.megakernel_kt import (
    ROWS as KT_ROWS,
    main as kt_main,
    run_megakernel_kt,
)
from lz4jpeg_tpu_torch.profiles.megakernel_t import (
    ROWS as T_ROWS,
    main as t_main,
    run_megakernel_t,
)
from lz4jpeg_tpu_torch.profiles.megakernel_v2 import (
    ROWS as V2_ROWS,
    main as v2_main,
    run_megakernel_v2,
)

KT_N = (256, 1040)  # blocks: one short of and past a multiple of 128
BIAS = 1024


def _kt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(3, 64, n),
                                                dtype=np.uint8)


def _port(kt, name):
    return mk.megakernel_variant(torch.from_numpy(kt), name, LUM, CHR)


@functools.lru_cache(maxsize=None)
def _jax_megakernel(n):
    """JAX's production megakernel on ``_kt(n)``, as int16."""
    out = forward_megakernel(jnp.asarray(_kt(n)), LUM, CHR, interpret=True)
    return np.asarray(out).view(np.int16)


# ---------------------------------------------------------------------------
# Stage A
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 8), (16, 32), (1, 24, 40), (3, 16, 8),
                                   (2, 2, 16, 24)])
def test_rgb_to_kt_matches_jax(shape):
    rgb = np.random.default_rng(sum(shape)).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)
    got = rgb_to_kt(torch.from_numpy(rgb))
    assert got.is_contiguous()
    assert np.array_equal(got.numpy(), np.asarray(jax_kt(jnp.asarray(rgb))))
    r, g, b = kt_tiles(got)
    assert np.array_equal(b.numpy(), got.numpy()[2].T)


@pytest.mark.parametrize("shape", [(12, 16, 3), (16, 12, 3), (16, 16, 4)])
def test_rgb_to_kt_refuses_partial_blocks(shape):
    with pytest.raises(ValueError):
        rgb_to_kt(torch.zeros(shape, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# The variants' plain versions against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["kt_full", "kt_full_32", "kt_full_128",
                                  "kt_basis_a", "kt_split_runs"])
@pytest.mark.parametrize("n", KT_N)
def test_k1_rows_match_jax_megakernel(n, name):
    got = mk.combined(_port(_kt(n), name)).numpy()
    assert np.array_equal(got, _jax_megakernel(n))


@pytest.mark.parametrize("n", KT_N)
def test_kt_dct_matches_jax_fused_forward(n):
    kt = _kt(n, seed=1)
    pixels = np.stack([kt[c].T for c in range(3)], axis=-1).reshape(n, 8, 8, 3)
    y, cr, cb = jax_ycbcr(jnp.asarray(pixels))
    want = np.concatenate([
        np.asarray(fused_forward_jnp(t, table, width, 8)).astype(np.int16)
        for t, table, width in ((y, LUM, 8), (cr[..., 1::2], CHR, 4),
                                (cb[..., 1::2], CHR, 4))], axis=1)
    assert np.array_equal(_port(kt, "kt_dct").numpy(), want)


@pytest.mark.parametrize("name", ["kt_copy_32", "kt_copy", "kt_copy_128"])
@pytest.mark.parametrize("n", KT_N)
def test_copy_rows_are_the_slices_of_kt(n, name):
    kt = _kt(n, seed=2)
    want = np.concatenate([kt[0], kt[1][:32], kt[2][:32]]).T.astype(np.int16)
    got = _port(kt, name).numpy()
    assert got.dtype == np.int16 and np.array_equal(got, want)


def _probe_chain(rgb):
    """``probe_megakernel.py:180-197`` in jnp: per frame, colour, 4:2:2,
    ``fused_forward_plane_jnp`` per channel and the KT sparse epilogue with
    its starts count; returned as block-major (N, K) uint16 words and (N,)
    run counts per channel, frames outermost."""
    words, runs = [[], [], []], [[], [], []]
    for frame in rgb:
        y, cr, cb = jax_ycbcr(jnp.asarray(frame), jnp.float32)
        planes = ((y, LUM, 8), (jax_subsample(cr), CHR, 4),
                  (jax_subsample(cb), CHR, 4))
        for i, (plane, table, width) in enumerate(planes):
            x = fused_forward_plane_jnp(plane, table, width).astype(jnp.int32)
            prev = jnp.pad(x, ((0, 0), (1, 0), (0, 0)))[:, :-1, :]
            first = jnp.arange(x.shape[1])[None, :, None] == 0
            starts = first | (x != prev)
            w = jnp.where(starts, x - jnp.where(first, 0, prev) + BIAS, 0)
            k = x.shape[1]
            words[i].append(np.transpose(np.asarray(w.astype(jnp.uint16)),
                                         (0, 2, 1)).reshape(-1, k))
            runs[i].append(np.asarray(jnp.sum(starts, axis=1)).reshape(-1))
    return ([np.concatenate(w) for w in words],
            [np.concatenate(r) for r in runs])


@pytest.mark.parametrize("shape", [(2, 32, 64), (1, 16, 2064)])
def test_split_runs_matches_the_probe_chain(shape):
    rgb = mk.noise_batch(*shape, seed=3, runs=True).numpy()
    got = mk.megakernel_variant(rgb_to_kt(torch.from_numpy(rgb)),
                                "kt_split_runs", LUM, CHR)
    words, runs = _probe_chain(rgb)
    for i in range(3):
        assert got[i].shape == (len(words[i]), mk.SPLIT_WIDTHS[i])
        assert np.array_equal(got[i].numpy().view(np.uint16), words[i])
        assert got[3 + i].dtype == torch.int32
        assert np.array_equal(got[3 + i].numpy(), runs[i])


def test_split_chain_ref_is_the_split_variant_from_rgb():
    x = mk.noise_batch(1, 16, 32, seed=4, runs=True)
    want = mk.megakernel_variant(rgb_to_kt(x), "kt_split_runs", LUM, CHR)
    got = mk.split_chain_ref(x)
    assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# The rule, the wrapper, the table, the bound, the runs
# ---------------------------------------------------------------------------


def test_variant_flips_checks_the_run_counts():
    kt = torch.from_numpy(_kt(32, seed=5))
    got = mk.megakernel_variant(kt, "kt_split_runs", LUM, CHR)
    assert mk.variant_flips(kt, got, got, "kt_split_runs", LUM, CHR) == 0
    bad = (*got[:4], got[4] + 1, got[5])
    with pytest.raises(AssertionError, match="run counts"):
        mk.variant_flips(kt, bad, got, "kt_split_runs", LUM, CHR)
    copy = mk.megakernel_variant(kt, "kt_copy", LUM, CHR)
    changed = copy.clone()
    changed[3, 100] += 1
    with pytest.raises(AssertionError, match="bare rung differs"):
        mk.variant_flips(kt, changed, copy, "kt_copy", LUM, CHR)


@pytest.mark.parametrize("bad,error", [
    (torch.zeros((3, 64, 32), dtype=torch.int16), TypeError),       # dtype
    (torch.zeros((3, 32, 32), dtype=torch.uint8), ValueError),      # shape
    (torch.zeros((64, 32), dtype=torch.uint8), ValueError),         # rank
    (torch.zeros((3, 64, 64), dtype=torch.uint8)[:, :, ::2], ValueError),
    (torch.zeros((3, 64, 32), dtype=torch.uint8, device="meta"), ValueError),
    (torch.zeros((1, 16, 32, 3), dtype=torch.uint8), ValueError),   # RGB
])
def test_kt_wrapper_checks_its_input(bad, error):
    with pytest.raises(error):
        mk.megakernel_variant(bad, "kt_full", LUM, CHR)


def test_kt_wrapper_refuses_an_unknown_variant_and_counts_no_cpu_launch():
    kt = torch.from_numpy(_kt(48, seed=6))
    with pytest.raises(ValueError, match="unknown variant"):
        mk.megakernel_variant(kt, "kt_fast", LUM, CHR)
    mk.megakernel_variant.launches = 0
    for v in mk.KT_VARIANTS:
        out = mk.megakernel_variant(kt, v.name, LUM, CHR)
        outs = out if isinstance(out, tuple) else (out,)
        assert [(tuple(o.shape), o.dtype) for o in outs] == [
            (tuple(shape), dtype) for shape, dtype in v.outputs(48)]
    assert mk.megakernel_variant.launches == 0


def test_variant_table_names_every_layout_probe_row():
    rows = [r for v in mk.KT_VARIANTS for r in v.rows]
    assert len(rows) == len(set(rows)) == 11
    assert {r.split()[0] for r in rows} == {
        "profiles/probe_megakernel.py:204", "profiles/probe_megakernel.py:205",
        "profiles/probe_megakernel_t.py:129", "profiles/probe_megakernel_t.py:132",
        "profiles/probe_megakernel_v2.py:146", "profiles/probe_megakernel_v2.py:148",
        "profiles/probe_megakernel_v2.py:149"}
    steps = {n.split("+")[-1] for _, n in KT_ROWS + T_ROWS + V2_ROWS}
    assert {v.name for v in mk.KT_VARIANTS} <= steps
    assert [v.name for v in mk.VARIANTS[:17]] == [v.name for v in mk.RGB_VARIANTS]
    assert [v.tiles for v in mk.KT_VARIANTS] == [64, 64, 32, 128, 64, 64, 32,
                                                 64, 128]


def test_bounds_at_the_probes_size():
    n = 32 * 256 * 256
    for name in ("kt_full", "kt_full_32", "kt_basis_a", "kt_dct"):
        ms, by = mk.variant_bound(name, n)
        assert by == "bytes"
        assert ms == pytest.approx(939_524_096 / 3.35e12 * 1e3)
        assert round(ms, 4) == 0.2805
    # A KT copy reads only R[0:64], G[0:32] and B[0:32]: 128 + 256 B a tile.
    for name in ("kt_copy_32", "kt_copy", "kt_copy_128"):
        ms, by = mk.variant_bound(name, n)
        assert by == "bytes"
        assert ms == pytest.approx(805_306_368 / 3.35e12 * 1e3)
        assert round(ms, 4) == 0.2404
    # An RGB copy reads every byte: its channels interleave.
    assert mk.variant_bound("cast_i16", n)[0] == pytest.approx(
        939_524_096 / 3.35e12 * 1e3)
    ms, by = mk.variant_bound("kt_split_runs", n)
    assert ms == pytest.approx(964_689_920 / 3.35e12 * 1e3) and by == "bytes"
    assert round(ms, 4) == 0.2880
    stage_a = mk.step_bound(mk.STAGE_A, n)[0]
    assert stage_a == pytest.approx(805_306_368 / 3.35e12 * 1e3)
    assert mk.step_bound(f"{mk.STAGE_A}+kt_split_runs", n)[0] == pytest.approx(
        stage_a + ms)
    assert mk.step_bound(mk.K1_STEP, n) == mk.variant_bound("full", n)
    assert mk.step_bound(mk.PLAIN_CHAIN, n) == (ms, by)


@pytest.mark.parametrize("run,rows,baseline", [
    (run_megakernel_kt, KT_ROWS, "megakernel alone (pre-transposed input)"),
    (run_megakernel_t, T_ROWS, "production megakernel (transpose out)"),
    (run_megakernel_v2, V2_ROWS, "copy+transpose only, C=1024"),
])
def test_runs_at_small_scale_on_the_cpu(run, rows, baseline, tmp_path):
    out = tmp_path / "run.json"
    res = run("cpu", frames=1, side=32, runs=1, chain=2, output=str(out))
    assert [r["row"] for r in res["rows"]] == [label for label, _ in rows]
    assert res["baseline"] == baseline and res["device"] == "cpu"
    assert res["plain_ms"] is None and res["rows"][0]["ms"] is None
    assert all(f == 0 for f in res["gates"]["flips"].values())
    assert json.loads(out.read_text())["n_blocks"] == 16


def test_layout_gates_report_k1_identity():
    kt_res = run_megakernel_kt("cpu", frames=1, side=16, runs=1, chain=1)
    assert kt_res["gates"]["identical_to_k1"] == {"kt_split_runs": True}
    t_res = run_megakernel_t("cpu", frames=1, side=16, runs=1, chain=1)
    assert t_res["gates"]["identical_to_k1"] == {"kt_basis_a": True,
                                                 "kt_full": True}
    v2 = run_megakernel_v2("cpu", frames=1, side=16, runs=1, chain=1)
    assert v2["gates"]["small_case"]["identical_to_k1"] == {"kt_full_32": True}


@pytest.mark.parametrize("main", [kt_main, t_main, v2_main])
def test_main_writes_only_its_output(main, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert main(["--device", "cpu", "--frames", "1", "--side", "16",
                 "--runs", "1", "--chain", "1", "--output", "a.json"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["a.json"]
    assert json.loads((tmp_path / "a.json").read_text())["backend"] == "cpu"
