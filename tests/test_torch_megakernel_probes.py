"""The forward megakernel's attribution variants (``profiles/megakernel.py``)
on the CPU, held against the JAX package and against the TPU probes' own
arithmetic restated in jnp.

On a CPU tensor each variant runs its plain torch version.  The TPU probes'
kernels are closures inside their ``main()`` (``profiles/
probe_megakernel_ablate.py:77``, ``profiles/probe_megakernel_dma.py:78``),
so nothing can import them: the references below are the JAX package's
production functions (``ops/pallas_fwd.py::forward_megakernel`` in
interpret mode, ``ops/fused.py::fused_forward_jnp``, ``ops/color.py``,
``ops/rle.py``) and the probes' expressions, cited by line, on JAX's
``rgb_to_kt`` layout.

Tolerances.  The full row and the band rows: bit-identical to
``forward_megakernel`` (viewed as int16).  Luma only and the
coefficient-major row: slices and transposes of the full row, exactly.
The bare rungs (copy, cast, f32): identical.  Every other product row: at
most a one-step truncation flip where the float64 value of the variant's own
product lies at a tie (``utils/parity.py::transform_flips`` with the
variant's basis and offset, through ``variant_flips``), at most 1e-5 of the
outputs, or 1e-3 for the ladder's raw, unsnapped dots, whose rational basis
rows put exact integers under the truncation
(``profiles/megakernel.py::flip_limit``).  XLA's CPU dot and torch's sum
the same exact products in other orders.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops.color import (
    chroma_subsample_422 as jax_subsample,
    rgb_to_ycbcr as jax_ycbcr,
    split_mcus as jax_split_mcus,
)
from lz4jpeg_tpu.ops.fused import fused_forward_jnp
from lz4jpeg_tpu.ops.pallas_fwd import _kt_bases, forward_megakernel, rgb_to_kt
from lz4jpeg_tpu.ops.rle import rle_encode_sparse16 as jax_sparse16

from lz4jpeg_tpu_torch.kernels import build
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis
from lz4jpeg_tpu_torch.ops.fwd_megakernel import split_basis
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.profiles import megakernel as mk
from lz4jpeg_tpu_torch.profiles.megakernel_ablate import (
    ROWS as ABLATE_ROWS,
    main as ablate_main,
    run_megakernel_ablation,
)
from lz4jpeg_tpu_torch.profiles.megakernel_dma import (
    ROWS as LADDER_ROWS,
    run_megakernel_ladder,
)
from lz4jpeg_tpu_torch.utils.parity import transform_flips

SHAPES = [(2, 64, 128), (1, 16, 32)]


def _rgb(shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(*shape, 3), dtype=np.uint8)


def _port(rgb, name):
    return mk.megakernel_variant(torch.from_numpy(rgb), name, LUM, CHR)


def _held(rgb, name, want):
    """The port's variant against ``want`` by the one-step rule."""
    got = _port(rgb, name)
    want = torch.from_numpy(np.array(want))
    flips = mk.variant_flips(torch.from_numpy(rgb), got, want, name, LUM, CHR)
    assert flips <= mk.flip_limit(name) * got.numel(), flips


def _jax_tiles(rgb, colour):
    """JAX's (luma, Cr, Cb) operand tiles of every frame, frames outermost."""
    per = []
    for frame in rgb:
        f = jnp.asarray(frame)
        if colour == "ycbcr":
            y, cr, cb = jax_ycbcr(f)
        elif colour == "r":
            y = cr = cb = f[..., 0]
        else:
            y, cr, cb = f[..., 0], f[..., 1], f[..., 2]
        per.append(jax_split_mcus(y, jax_subsample(cr), jax_subsample(cb)))
    return [jnp.concatenate([p[i] for p in per]) for i in range(3)]


def _jax_product(tiles, width, table, parts, centred):
    """The JAX reference of one channel's coefficients (N, 8·width): K1's
    HIGHEST product (``fused_forward_jnp``), the HIGHEST product of the
    centred samples with the basis cast to bfloat16 (the TPU's one-pass
    bf16 basis: round to nearest even, as ``split_basis``'s hi part), or a
    raw product truncated toward zero."""
    if centred and parts == 3:
        return fused_forward_jnp(tiles, table, width, 8)
    m, _ = forward_basis(width, 8, _table_key(table))
    basis = jnp.asarray(m, jnp.float32)
    if parts == 1:
        basis = basis.astype(jnp.bfloat16).astype(jnp.float32)
    x = tiles.reshape(tiles.shape[0], -1).astype(jnp.float32)
    if not centred:
        return jnp.trunc(jnp.matmul(x, basis.T, precision="highest"))
    ratio = jnp.matmul(x - 128.0, basis.T, precision="highest")
    nearest = jnp.round(ratio)
    return jnp.trunc(jnp.where(jnp.abs(ratio - nearest) <= 1e-5, nearest, ratio))


def _jax_variant(rgb, name):
    """A product variant's block-major (N, lanes) int16 output from JAX."""
    v = mk.BY_NAME[name]
    lanes = []
    for tiles, table, width in zip(_jax_tiles(rgb, v.colour)[: v.channels],
                                   (LUM, CHR, CHR), (8, 4, 4)):
        zz = _jax_product(tiles, width, table, v.parts, v.centred)
        zz = zz.astype(jnp.int16)
        if v.stage == "sparse":
            zz = np.asarray(jax_sparse16(zz)[0]).view(np.int16)
        lanes.append(np.asarray(zz))
    out = np.concatenate(lanes, axis=1)
    return out if v.block_major else out.T


# ---------------------------------------------------------------------------
# The ablation's rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", mk.SAME_AS_K1)
@pytest.mark.parametrize("shape", SHAPES)
def test_k1_rows_match_jax_megakernel(shape, name):
    rgb = _rgb(shape, seed=sum(shape))
    want = np.asarray(forward_megakernel(rgb_to_kt(jnp.asarray(rgb)), LUM, CHR,
                                         interpret=True)).view(np.int16)
    assert np.array_equal(_port(rgb, name).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_no_sparse_matches_jax_fused_forward(shape):
    rgb = _rgb(shape, seed=1)
    _held(rgb, "no_sparse", _jax_variant(rgb, "no_sparse"))


@pytest.mark.parametrize("shape", SHAPES)
def test_no_colour_matches_jax_on_r_tiles(shape):
    rgb = _rgb(shape, seed=2)
    _held(rgb, "no_colour", _jax_variant(rgb, "no_colour"))


@pytest.mark.parametrize("shape", SHAPES)
def test_luma_only_and_coefficient_major_are_views_of_full(shape):
    x = torch.from_numpy(_rgb(shape, seed=3))
    full = mk.megakernel_variant(x, "full", LUM, CHR)
    assert torch.equal(mk.megakernel_variant(x, "luma_only", LUM, CHR),
                       full[:, :64])
    assert torch.equal(mk.megakernel_variant(x, "coefficient_major", LUM, CHR),
                       full.T)
    no_colour = mk.megakernel_variant(x, "no_colour", LUM, CHR)
    assert not torch.equal(no_colour, full)


@pytest.mark.parametrize("name", ["one_part", "bare", "dots_one_part",
                                  "dots_one_part_block"])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_part_rows_match_bf16_basis_product(shape, name):
    rgb = _rgb(shape, seed=4)
    _held(rgb, name, _jax_variant(rgb, name))


def test_one_part_basis_is_the_bf16_rounding():
    """``split_basis``'s hi part is the basis rounded to bfloat16 (nearest
    even), what the TPU's one-pass product multiplies."""
    for width, table in ((8, LUM), (4, CHR)):
        m, _ = forward_basis(width, 8, _table_key(table))
        bf16 = np.asarray(jnp.asarray(m, jnp.float32).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        assert np.array_equal(split_basis(m)[0], bf16)


# ---------------------------------------------------------------------------
# The ladder's rungs, against the probe's expressions
# ---------------------------------------------------------------------------


def _probe_rung(rgb, mode, precision="highest", transpose_out=False):
    """``probe_megakernel_dma.py:78-126`` on one (3, 64, N) KT block: the
    rung's (o1, o2, o3) concatenated on the coefficient axis, (128, N), or
    transposed (N, 128)."""
    x = rgb_to_kt(jnp.asarray(rgb))
    my, mc64, _ = _kt_bases(_table_key(LUM), _table_key(CHR))
    my, mc64 = jnp.asarray(my), jnp.asarray(mc64)  # mc64 is zero past row 32
    if mode == "u8copy":  # :80-83
        o = (x[0], x[1][:32], x[2][:32])
    elif mode == "i16":  # :84-87
        o = (x[0].astype(jnp.int16), x[1][:32].astype(jnp.int16),
             x[2][:32].astype(jnp.int16))
    elif mode == "f32":  # :88-92
        f = [c.astype(jnp.int32).astype(jnp.float32) for c in x]
        o = (f[0], f[1][:32] + f[2][:32], f[2][:32])
    elif mode == "dot":  # :93-105
        r, g, b = (c.astype(jnp.int32).astype(jnp.float32) for c in x)
        o = (jnp.matmul(my, r, precision=precision),
             jnp.matmul(mc64, g, precision=precision)[:32],
             jnp.matmul(mc64, b, precision=precision)[:32])
    else:  # "dot_bf16", :106-118
        r, g, b = (c.astype(jnp.int16).astype(jnp.bfloat16) for c in x)

        def d(m_, v):
            return jnp.matmul(m_.astype(jnp.bfloat16), v,
                              preferred_element_type=jnp.float32)

        o = (d(my, r), d(mc64, g)[:32], d(mc64, b)[:32])
    dt = jnp.uint8 if mode == "u8copy" else jnp.int16  # :128
    out = np.asarray(jnp.concatenate([c.astype(dt) for c in o]))  # :119-126
    return out.T if transpose_out else out


@pytest.mark.parametrize("mode,name", [("u8copy", "copy_u8"),
                                       ("i16", "cast_i16"),
                                       ("f32", "sum_f32")])
@pytest.mark.parametrize("shape", SHAPES)
def test_bare_rungs_equal_the_probe(shape, mode, name):
    rgb = _rgb(shape, seed=5)
    got = _port(rgb, name).numpy()
    want = _probe_rung(rgb, mode)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("mode,precision,transpose_out,name", [
    ("dot", "highest", False, "dots_three_parts"),
    ("dot", "highest", True, "dots_three_parts_block"),
    ("dot_bf16", None, False, "dots_one_part"),
    ("dot_bf16", None, True, "dots_one_part_block"),
])
@pytest.mark.parametrize("shape", SHAPES)
def test_dot_rungs_match_the_probe(shape, mode, precision, transpose_out, name):
    rgb = _rgb(shape, seed=6)
    _held(rgb, name, _probe_rung(rgb, mode, precision, transpose_out))


# ---------------------------------------------------------------------------
# The rule, the wrapper, the bound, the runs
# ---------------------------------------------------------------------------


def test_transform_flips_takes_an_explicit_basis():
    """A coefficient one step off at a tie of the hi part's centred product
    is admissible against that basis and offset; the same difference away
    from a tie raises; an explicit copy of ``forward_basis``'s basis and
    offset counts as the default does."""
    m, off = forward_basis(8, 8, _table_key(LUM))
    hi = split_basis(m)[0].astype(np.float64)
    hi_off = 128.0 * hi.sum(axis=1)
    tiles = torch.full((2, 8, 8), 128, dtype=torch.uint8)  # centred: all 0
    tiles[1, 0, 0] = 200
    want = torch.zeros((2, 64), dtype=torch.int32)
    got = want.clone()
    got[0, 5] = 1  # value 0 exactly: a tie
    assert transform_flips("forward", tiles, got, want, LUM, 8, 8,
                           basis=hi, offset=hi_off) == 1
    assert transform_flips("forward", tiles, got, want, LUM, 8, 8,
                           basis=m, offset=off) == transform_flips(
        "forward", tiles, got, want, LUM, 8, 8)
    away = (72.0 * hi[:, 0]) - np.round(72.0 * hi[:, 0])
    k = int(np.argmax(np.abs(away)))  # the lane furthest from a tie
    got = want.clone()
    got[1, k] = 1
    with pytest.raises(AssertionError, match="not a sum-order flip"):
        transform_flips("forward", tiles, got, want, LUM, 8, 8,
                        basis=hi, offset=hi_off)


def test_variant_flips_refuses_a_changed_bare_rung():
    x = torch.from_numpy(_rgb((1, 16, 32)))
    got = mk.megakernel_variant(x, "copy_u8", LUM, CHR)
    want = got.clone()
    want[3, 1] ^= 1
    with pytest.raises(AssertionError, match="bare rung differs"):
        mk.variant_flips(x, got, want, "copy_u8", LUM, CHR)


@pytest.mark.parametrize("bad,error", [
    (torch.zeros((1, 12, 16, 3), dtype=torch.uint8), ValueError),  # H % 8
    (torch.zeros((1, 8, 12, 3), dtype=torch.uint8), ValueError),   # W·3 % 16
    (torch.zeros((1, 8, 16, 3), dtype=torch.int16), TypeError),    # dtype
    (torch.zeros((8, 16, 3), dtype=torch.uint8), ValueError),      # rank
    (torch.zeros((1, 8, 32, 3), dtype=torch.uint8)[:, :, ::2], ValueError),
    (torch.zeros((1, 8, 16, 3), dtype=torch.uint8, device="meta"), ValueError),
])
def test_wrapper_checks_its_input(bad, error):
    with pytest.raises(error):
        mk.megakernel_variant(bad, "full", LUM, CHR)


def test_wrapper_refuses_an_unknown_variant_and_counts_no_cpu_launch():
    x = torch.from_numpy(_rgb((1, 16, 32)))
    with pytest.raises(ValueError, match="unknown variant"):
        mk.megakernel_variant(x, "fast", LUM, CHR)
    mk.megakernel_variant.launches = 0
    for v in mk.RGB_VARIANTS:
        out = mk.megakernel_variant(x, v.name, LUM, CHR)
        assert tuple(out.shape) == v.shape(8) and out.dtype == v.dtype
    assert mk.megakernel_variant.launches == 0


def test_variant_table_maps_every_probe_row():
    assert [n for _, n in ABLATE_ROWS] == [
        "full", "one_part", "coefficient_major", "no_sparse", "no_colour",
        "luma_only", "band_128", "band_16", "band_32", "bare"]
    assert len(LADDER_ROWS) == 8
    rows = [r for v in mk.RGB_VARIANTS for r in v.rows]
    assert len(rows) == len(set(rows)) == 18
    assert {n for _, n in ABLATE_ROWS + LADDER_ROWS} == {
        v.name for v in mk.RGB_VARIANTS}


def test_bound_of_the_full_row_at_the_probes_size():
    n = 32 * 256 * 256
    ms, by = mk.variant_bound("full", n)
    assert by == "bytes"
    assert ms == pytest.approx(939_524_096 / 3.35e12 * 1e3)
    assert mk.variant_bound("copy_u8", n)[0] < ms
    assert mk.variant_bound("luma_only", n)[0] < ms


@pytest.mark.parametrize("run,rows", [(run_megakernel_ablation, ABLATE_ROWS),
                                      (run_megakernel_ladder, LADDER_ROWS)])
def test_runs_at_small_scale_on_the_cpu(run, rows, tmp_path):
    out = tmp_path / "run.json"
    res = run("cpu", frames=1, side=32, runs=1, chain=2, output=str(out))
    assert [r["row"] for r in res["rows"]] == [label for label, _ in rows]
    assert set(res["gates"]) == {n for _, n in rows}
    assert res["device"] == "cpu" and res["rows"][0]["vs_baseline_ms"] == 0
    assert json.loads(out.read_text())["n_blocks"] == 16


def test_ablation_main_writes_only_its_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ablate_main(["--device", "cpu", "--frames", "1", "--side", "16",
                        "--runs", "1", "--chain", "1", "--output", "a.json"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == ["a.json"]
    assert json.loads((tmp_path / "a.json").read_text())["backend"] == "cpu"


# ---------------------------------------------------------------------------
# The build key
# ---------------------------------------------------------------------------


def test_header_edit_changes_the_library_name(tmp_path):
    """A library's name hashes the ``.cuh`` headers beside its source, so an
    edit to a header that the source includes is never served a stale
    build (no compiler runs here)."""
    src = tmp_path / "kernel.cu"
    head = tmp_path / "body.cuh"
    src.write_text('#include "body.cuh"\n')
    head.write_text("constexpr int kTiles = 64;\n")
    cmd = ["nvcc", "-O3"]
    first = build.library_path("kernel", src, cmd)
    assert first == build.library_path("kernel", src, cmd)
    head.write_text("constexpr int kTiles = 32;\n")
    second = build.library_path("kernel", src, cmd)
    assert second != first and second.parent == build.BUILD_DIR
    (tmp_path / "notes.txt").write_text("not a header")
    assert build.library_path("kernel", src, cmd) == second
    assert build.library_path("kernel", src, [*cmd, "-g"]) != second
