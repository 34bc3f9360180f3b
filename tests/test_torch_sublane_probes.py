"""The sublane RLE and the casts (``lz4jpeg_tpu_torch/profiles/
sublane_rle.py``, ``casts.py`` and the runners ``sublane_butterfly.py``,
``plane_exact.py``) on the CPU, held against the TPU probes' own kernel
bodies and the JAX package.

* The sublane RLE against the bodies of
  ``profiles/profile_sublane_butterfly.py::kernel`` and
  ``profiles/profile_plane_exact.py::make_kernel(SEG)``, restated verbatim
  below (the probes define them inside ``main``) and run with
  ``pl.pallas_call(..., interpret=True)`` on the probes' run-structured
  values at SEG 32 and 64 and B 1, 131, 256 and 512 (a ragged B is padded to
  the probes' 128-lane grid with zero columns, which are cut off again:
  columns are independent), and against ``lz4jpeg_tpu.ops.rle.
  rle_encode_packed16`` on the transposed blocks (words transposed, runs =
  lengths // 2).
* The seven casts against the body of ``profiles/profile_mosaic_casts.py::
  kern`` in interpret mode on the probe's (64, 256) tile of 0-126, and
  against ``jnp.asarray(x, src).astype(dst)`` there and over each source
  type's whole range (NaN compared as NaN).
* The plane einsum of ``profile_plane_exact.py``'s part (a) on the probe's
  256² frame: the port's against its ``forward_channel`` tiles and against
  the probe's ``plane_einsum`` restated in jnp.

Tolerance: none (exact equality), except the plane einsum: one-step
sum-order flips admitted by ``utils/parity.py::transform_flips``, at most
1e-5 of the coefficients.
"""

import ast
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lz4jpeg_tpu.models.jpeg import _CHANNEL_SHAPES as JAX_SHAPES
from lz4jpeg_tpu.models.jpeg import scaled_tables as jax_scaled_tables
from lz4jpeg_tpu.ops.color import chroma_subsample_422 as jax_subsample
from lz4jpeg_tpu.ops.color import rgb_to_ycbcr as jax_rgb_to_ycbcr
from lz4jpeg_tpu.ops.fused import _table_key as jax_table_key
from lz4jpeg_tpu.ops.fused import forward_basis as jax_forward_basis
from lz4jpeg_tpu.ops.rle import rle_encode_packed16 as jax_encode

from lz4jpeg_tpu_torch.models.jpeg import (
    _CHANNEL_SHAPES,
    forward_channel,
    scaled_tables,
)
from lz4jpeg_tpu_torch.profiles import casts, plane_exact, sublane_butterfly
from lz4jpeg_tpu_torch.profiles import sublane_rle as sr
from lz4jpeg_tpu_torch.profiles import timing
from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image
from lz4jpeg_tpu_torch.utils.parity import transform_flips

REPO = Path(__file__).resolve().parent.parent
LANES = 128


# -- the probes' kernel bodies, verbatim ----------------------------------------


def butterfly_kernel_64():
    """``profile_sublane_butterfly.py:24-51`` (SEG = 64)."""
    SEG = 64     # compaction axis length (sublanes)
    POS_SH, VAL_SH, VALID = 6, 13, 1 << 23

    def kernel(x_ref, lt_ref, packed_ref, runs_ref):
        x = x_ref[:].astype(jnp.int32)           # (SEG, LANES)
        m = jax.lax.broadcasted_iota(jnp.int32, x.shape, dimension=0)
        prev = pltpu.roll(x, shift=1, axis=0)
        starts = (m == 0) | (x != prev)
        # rank via sublane-contraction matmul: c[s,b] = sum_{j<=s} starts[j,b]
        c = jnp.dot(lt_ref[:], starts.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32).astype(jnp.int32)
        rank = c - 1
        word = jnp.where(
            starts, (m - rank) | (m << POS_SH) | ((x + 511) << VAL_SH) | VALID, 0
        )
        nbits = 6
        for b in range(nbits):
            step = 1 << b
            incoming = pltpu.roll(word, shift=SEG - step, axis=0)
            ok = m < (SEG - step)
            arrive = ok & ((incoming & VALID) != 0) & ((incoming & step) != 0)
            depart = ((word & VALID) != 0) & ((word & step) != 0)
            word = jnp.where(arrive, incoming - step, jnp.where(depart, 0, word))
        valid = (word & VALID) != 0
        key = jnp.where(valid, (word >> POS_SH) & 127, SEG)
        val = ((word >> VAL_SH) & 0x3FF) - 511
        nxt = jnp.where(m == SEG - 1, SEG, pltpu.roll(key, shift=SEG - 1, axis=0))
        counts = jnp.where(valid, nxt - key, 0)
        packed = (jnp.maximum(counts - 1, 0) << 10) | (val + 512)
        packed_ref[:] = jnp.where(counts > 0, packed, 0).astype(jnp.int16)
        runs_ref[:] = jnp.sum(starts.astype(jnp.int32), axis=0, keepdims=True)

    return kernel


def make_kernel(SEG):
    """``profile_plane_exact.py:59-92``."""
    POS_SH, VAL_SH, VALID = 6, 13, 1 << 23
    nbits = SEG.bit_length() - 1

    def kernel(x_ref, lt_ref, packed_ref, runs_ref):
        x = x_ref[:].astype(jnp.int32)
        m = jax.lax.broadcasted_iota(jnp.int32, x.shape, dimension=0)
        prev = pltpu.roll(x, shift=1, axis=0)
        starts = (m == 0) | (x != prev)
        c = jnp.dot(lt_ref[:], starts.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32).astype(jnp.int32)
        rank = c - 1
        word = jnp.where(
            starts,
            (m - rank) | (m << POS_SH) | ((x + 511) << VAL_SH) | VALID, 0)
        for b in range(nbits):
            step = 1 << b
            incoming = pltpu.roll(word, shift=SEG - step, axis=0)
            ok = m < (SEG - step)
            arrive = ok & ((incoming & VALID) != 0) & ((incoming & step) != 0)
            depart = ((word & VALID) != 0) & ((word & step) != 0)
            word = jnp.where(arrive, incoming - step,
                             jnp.where(depart, 0, word))
        valid = (word & VALID) != 0
        key = jnp.where(valid, (word >> POS_SH) & 127, SEG)
        val = ((word >> VAL_SH) & 0x3FF) - 511
        nxt = jnp.where(m == SEG - 1, SEG,
                        pltpu.roll(key, shift=SEG - 1, axis=0))
        counts = jnp.where(valid, nxt - key, 0)
        packed = (jnp.maximum(counts - 1, 0) << 10) | (val + 512)
        packed_ref[:] = jnp.where(counts > 0, packed, 0).astype(jnp.int16)
        runs_ref[:] = jnp.sum(starts.astype(jnp.int32),axis=0,
                              keepdims=True)
    return kernel


def run_sublane_body(kern, seg: int, xs: np.ndarray):
    """The probes' ``run`` (``profile_plane_exact.py:101-111``) in interpret
    mode; B is padded with zero columns to the 128-lane grid and cut back."""
    cols = xs.shape[1]
    padded = np.zeros((seg, -(-cols // LANES) * LANES), xs.dtype)
    padded[:, :cols] = xs
    jj = jnp.arange(seg)[:, None]
    ss = jnp.arange(seg)[None, :]
    lt = (ss <= jj).astype(jnp.bfloat16)
    x = jnp.asarray(padded)
    grid = (x.shape[1] // LANES,)
    spec = pl.BlockSpec((seg, LANES), lambda i: (0, i), memory_space=pltpu.VMEM)
    lt_spec = pl.BlockSpec((seg, seg), lambda i: (0, 0), memory_space=pltpu.VMEM)
    runs_spec = pl.BlockSpec((1, LANES), lambda i: (0, i), memory_space=pltpu.VMEM)
    packed, runs = pl.pallas_call(
        kern, grid=grid, in_specs=[spec, lt_spec], out_specs=(spec, runs_spec),
        out_shape=(jax.ShapeDtypeStruct((seg, x.shape[1]), jnp.int16),
                   jax.ShapeDtypeStruct((1, x.shape[1]), jnp.int32)),
        interpret=True,
    )(x, lt)
    return np.asarray(packed)[:, :cols], np.asarray(runs)[:, :cols]


def cast_body(src, dst, x):
    """``profile_mosaic_casts.py:15-24`` in interpret mode."""
    def kern(x_ref, o_ref, dst=dst):
        o_ref[:] = x_ref[:].astype(dst)
    return np.array(pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((64, 256), dst),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x, src)))


# -- the sublane RLE -------------------------------------------------------------


@pytest.mark.parametrize("seg", [32, 64])
@pytest.mark.parametrize("cols", [1, 131, 256])
def test_sublane_rle_equals_the_probe_body_and_jax(seg, cols):
    xs = sr.probe_values(seg, cols, np.random.default_rng(seg * 1000 + cols))
    packed, runs = sr.sublane_rle(torch.from_numpy(xs))
    assert packed.dtype == torch.int16 and packed.shape == (seg, cols)
    assert runs.dtype == torch.int32 and runs.shape == (1, cols)
    body_p, body_r = run_sublane_body(make_kernel(seg), seg, xs)
    np.testing.assert_array_equal(packed.numpy(), body_p)
    np.testing.assert_array_equal(runs.numpy(), body_r)
    ref_p, ref_l = jax_encode(jnp.asarray(xs.T.astype(np.int16)))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(ref_p).T.astype(np.int16))
    np.testing.assert_array_equal(runs.numpy()[0], np.asarray(ref_l) // 2)
    p16, r16 = sr.sublane_rle(torch.from_numpy(xs.astype(np.int16)))
    assert torch.equal(p16, packed) and torch.equal(r16, runs)


def test_sublane_rle_equals_the_butterfly_probe_body():
    """The butterfly probe's own check: (64, 512) values from its seed."""
    rng = np.random.default_rng(0)
    xs = rng.integers(-511, 512, size=(64, 4 * LANES)).astype(np.int32)
    xs[:, ::2] = np.repeat(xs[::8, ::2], 8, axis=0)  # runs
    np.testing.assert_array_equal(
        xs, sr.probe_values(64, 4 * LANES, np.random.default_rng(0)))
    packed, runs = sr.sublane_rle(torch.from_numpy(xs))
    body_p, body_r = run_sublane_body(butterfly_kernel_64(), 64, xs)
    np.testing.assert_array_equal(packed.numpy(), body_p)
    np.testing.assert_array_equal(runs.numpy(), body_r)


def test_sublane_rle_on_crafted_columns():
    """All-equal, all-distinct and ±511 columns, against the plain
    version's definition and the probe body."""
    seg = 32
    cols = np.stack([np.full(seg, 7), np.arange(seg) - 16,
                     np.where(np.arange(seg) % 2, 511, -511),
                     np.repeat([3, -3], seg // 2)], axis=1).astype(np.int32)
    packed, runs = sr.sublane_rle(torch.from_numpy(cols))
    assert runs.tolist() == [[1, seg, seg, 2]]
    assert int(packed[0, 0]) & 0xFFFF == (seg - 1) << 10 | (7 + 512)
    assert (packed[1:, 0] == 0).all()
    body_p, body_r = run_sublane_body(make_kernel(seg), seg, cols)
    np.testing.assert_array_equal(packed.numpy(), body_p)
    np.testing.assert_array_equal(runs.numpy(), body_r)


@pytest.mark.parametrize("shape,dtype,error", [
    ((16, 128), torch.int32, ValueError), ((128, 128), torch.int32, ValueError),
    ((2, 64, 128), torch.int32, ValueError), ((64,), torch.int32, ValueError),
    ((64, 128), torch.float32, TypeError), ((64, 128), torch.int64, TypeError)])
def test_sublane_rle_refusals(shape, dtype, error):
    x = torch.zeros(shape, dtype=dtype)
    for fn in (sr.sublane_rle, sr.sublane_rle_ref):
        with pytest.raises(error):
            fn(x)


def test_sublane_rle_views_empty_and_no_cpu_launch():
    base = torch.from_numpy(sr.probe_values(64, 300, np.random.default_rng(5)))
    before = sr.sublane_rle.launches
    view = base[:, 1:200]  # not contiguous: made row-major
    packed, runs = sr.sublane_rle(view)
    want = sr.sublane_rle_ref(view.contiguous())
    assert torch.equal(packed, want[0]) and torch.equal(runs, want[1])
    packed, runs = sr.sublane_rle(torch.zeros((32, 0), dtype=torch.int16))
    assert packed.shape == (32, 0) and runs.shape == (1, 0)
    assert sr.sublane_rle.launches == before


def test_sublane_bounds():
    assert sr.rle_bytes(64, 2_097_152) == 813_694_976
    assert sr.rle_bytes(32, 2_097_152) == 411_041_792
    assert round(timing.bytes_bound_ms(sr.rle_bytes(64, 2_097_152)), 4) == 0.2429
    assert round(timing.bytes_bound_ms(sr.rle_bytes(32, 2_097_152)), 4) == 0.1227
    assert sr.attributes(64, 4, "cpu")["registers"] is None


# -- the casts ---------------------------------------------------------------------


JAX_PAIRS = ((jnp.int16, jnp.float32), (jnp.int32, jnp.float32),
             (jnp.uint8, jnp.int32), (jnp.int8, jnp.int32),
             (jnp.int16, jnp.int32), (jnp.uint8, jnp.int16),
             (jnp.bfloat16, jnp.float32))


def _jnp_astype(x: torch.Tensor, src, dst) -> torch.Tensor:
    """``jnp.asarray(x, src).astype(dst)`` back as a torch tensor (bfloat16
    crosses as its bits)."""
    if x.dtype == torch.bfloat16:
        bits = x.view(torch.int16).numpy().view(np.uint16)
        arr = jnp.asarray(bits).view(jnp.bfloat16)
    else:
        arr = jnp.asarray(x.numpy(), src)
    return torch.from_numpy(np.array(arr.astype(dst)))


@pytest.mark.parametrize("pair", range(7))
def test_casts_equal_the_probe_body_and_jnp(pair):
    src, dst = casts.PAIRS[pair]
    jsrc, jdst = JAX_PAIRS[pair]
    rng = np.random.default_rng(pair)
    x = casts.probe_values(src, rng)
    assert x.shape == (64, 256) and int(x.float().max()) <= 126
    got = casts.cast(x, dst)
    assert got.dtype == dst and got.shape == x.shape
    raw = x.float().numpy().astype(np.int64)  # 0..126: exact in every type
    body = torch.from_numpy(cast_body(jsrc, jdst, raw))
    assert casts.same(got, body)
    assert casts.same(got, _jnp_astype(x, jsrc, jdst))
    full = casts.full_range(src, rng)
    assert casts.same(casts.cast(full, dst), _jnp_astype(full, jsrc, jdst))
    assert casts.same(casts.cast(full, dst), casts.cast_ref(full, dst))


def test_cast_full_ranges_cover_the_edges():
    bf = casts.cast(casts.full_range(torch.bfloat16, None), torch.float32)
    assert bf.numel() == 65536
    assert torch.isnan(bf).sum() == 2 * 127  # 2 signs × (2^7 - 1) mantissas
    assert torch.isinf(bf).sum() == 2
    tiny = bf[(bf != 0) & (bf.abs() < torch.finfo(torch.float32).tiny)]
    assert tiny.numel() == 2 * 127  # the subnormals
    i32 = casts.full_range(torch.int32, np.random.default_rng(0))
    assert {-(1 << 31), (1 << 31) - 1, (1 << 24) + 1} <= set(i32.tolist())
    f = casts.cast(i32, torch.float32)
    at = i32.tolist().index((1 << 24) + 1)
    assert f[at].item() == float(1 << 24)  # the tie rounds to even
    assert casts.full_range(torch.int8, None).numel() == 256
    assert casts.full_range(torch.int16, None).numel() == 65536


def test_same_compares_nan_as_nan_and_bits_otherwise():
    a = torch.tensor([float("nan"), 0.0, 1.0])
    b = torch.tensor([float("nan"), -0.0, 1.0])
    assert casts.same(a, a.clone())
    assert not casts.same(a, b)
    assert not casts.same(a, a.double())
    assert casts.same(torch.arange(4), torch.arange(4))


@pytest.mark.parametrize("src,dst", [(torch.int16, torch.float64),
                                     (torch.float32, torch.int32),
                                     (torch.int32, torch.int16),
                                     (torch.uint8, torch.uint8)])
def test_casts_refuse_other_pairs(src, dst):
    x = torch.zeros(8, dtype=src)
    for fn in (casts.cast, casts.cast_ref):
        with pytest.raises(ValueError):
            fn(x, dst)


def test_cast_bytes_and_no_cpu_launch():
    n = 134_217_728
    bounds = [round(timing.bytes_bound_ms(casts.cast_bytes(p, n)), 4)
              for p in range(7)]
    assert bounds == [0.2404, 0.3205, 0.2003, 0.2003, 0.2404, 0.1202, 0.2404]
    before = casts.cast.launches
    casts.cast(torch.zeros((3, 5), dtype=torch.uint8), torch.int16)
    assert casts.cast.launches == before
    assert [casts.pair_name(p) for p in (0, 6)] == ["int16->float32",
                                                    "bfloat16->float32"]


# -- the plane einsum (part (a) of profile_plane_exact.py) ---------------------


def jnp_plane_einsum(plane, name, tables, snap_eps=1e-5):
    """``profile_plane_exact.py:22-34``, with the JAX package's tables."""
    h_, w_ = JAX_SHAPES[name]   # (8, tw)
    tw = w_
    hp, wp = plane.shape
    bh, bw = hp // 8, wp // tw
    m, off = jax_forward_basis(tw, 8, jax_table_key(tables[name]))
    x = plane.reshape(bh, 8, bw, tw).astype(jnp.float32)
    mt = jnp.asarray(m.reshape(8 * tw, 8, tw), jnp.float32)
    ratio = jnp.einsum("krc,arbc->akb", mt, x, precision="highest") \
        - jnp.asarray(off, jnp.float32)[None, :, None]
    nearest = jnp.round(ratio)
    ratio = jnp.where(jnp.abs(ratio - nearest) <= snap_eps, nearest, ratio)
    return jnp.trunc(ratio)  # (bh, 8*tw, bw)


def test_plane_einsum_equals_forward_channel_and_the_jnp_probe():
    rng = np.random.default_rng(0)
    img = generate_noise_image(256, 256, rng)  # the probe's first frame
    tables = scaled_tables(None)
    jax_tables = jax_scaled_tables(None)
    jy, jcr, jcb = jax_rgb_to_ycbcr(jnp.asarray(img), jnp.float32)
    jplanes = {"lum": jy, "r": jax_subsample(jcr), "b": jax_subsample(jcb)}
    total = 0
    for name, tiles, plane in plane_exact.plane_channels(torch.from_numpy(img)):
        np.testing.assert_array_equal(plane.numpy(), np.asarray(jplanes[name]))
        tw = _CHANNEL_SHAPES[name][1]
        zz = plane_exact.plane_einsum(plane, name, tables)
        k = zz.shape[1]
        nk = zz.transpose(1, 2).reshape(-1, k)
        tile_zz = forward_channel(tiles, name, tables, torch.float32, True)
        flips = transform_flips("forward", tiles, nk, tile_zz, tables[name],
                                tw, 8)
        jz = torch.from_numpy(np.asarray(
            jnp_plane_einsum(jplanes[name], name, jax_tables)))
        flips += transform_flips("forward", tiles,
                                 nk, jz.transpose(1, 2).reshape(-1, k),
                                 tables[name], tw, 8)
        total += nk.numel()
        assert flips <= 1e-5 * nk.numel()
    found = plane_exact.plane_mismatches(torch.from_numpy(img), tables)
    assert set(found) == {"lum", "r", "b"}
    assert sum(r["coefficients"] for r in found.values()) == total
    assert all(r["mismatches"] == r["flips"] for r in found.values())


# -- the runners and the port's imports -------------------------------------------


@pytest.mark.parametrize("module,args", [
    (sublane_butterfly, ["--cols", "384"]),
    (plane_exact, ["--sizes", "64", "--cols", "256"]),
    (casts, ["--elements", "4099"]),
])
def test_runners_on_the_cpu_write_only_their_output(module, args, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert module.main(["--device", "cpu", *args, "--runs", "1", "--reps",
                        "1", "--output", "a.json"]) == 0
    assert os.listdir(tmp_path) == ["a.json"]
    art = json.loads((tmp_path / "a.json").read_text())
    assert art["device"] == "cpu" and "card" not in art
    assert art["timer"] == "host clock" and art["verdict"].startswith("on cpu:")
    if module is sublane_butterfly:
        assert [w["way"] for w in art["ways"]] == [
            "sublane", "k5_kt_view", "transpose_k4"]
        assert art["check"]["shape"] == [64, 512] and art["share"] is None
        assert art["site"] == "profile_sublane_butterfly.py:64"
    elif module is plane_exact:
        assert [c["seg"] for c in art["checks"]] == [32, 64]
        assert [c["shape"] for c in art["checks"]] == [[32, 256], [64, 256]]
        assert art["seg"] == 32 and art["launches"] == 0
        assert art["total_mismatches"] == 0
        assert set(art["einsum"]["64"]) == {"lum", "r", "b"}
    else:
        assert [r["pair"] for r in art["pairs"]] == [
            casts.pair_name(p) for p in range(7)]
        assert all(r["host_ms"] > 0 and r["checked"] > 0 for r in art["pairs"])


def test_new_modules_import_no_jax():
    for name in ("sublane_rle", "sublane_butterfly", "plane_exact", "casts",
                 "dct_gates"):
        path = REPO / "lz4jpeg_tpu_torch" / "profiles" / f"{name}.py"
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "lz4jpeg_tpu", "profiles")
