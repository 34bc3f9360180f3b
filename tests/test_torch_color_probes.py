"""The colour probe and the MCU relayout (``lz4jpeg_tpu_torch/profiles/
pallas_color.py``, ``mcu_relayout.py`` and the runner ``colorsplit3.py``)
on the CPU, held against the TPU probes' own kernel bodies and the JAX
package.

* The colour probe against the body of ``profiles/profile_pallas_color.py::
  color_kernel``, restated verbatim below (the probe defines it inside
  ``main``) and run with ``pl.pallas_call(..., interpret=True)`` on the
  probe's (16, 2048, 3) case and over the whole 2²⁴ colour cube in both
  column phases.  The body truncates without the 1e-4 snap of
  ``ops/color.py::rgb_to_ycbcr``, so against JAX's ``rgb_to_ycbcr`` +
  ``chroma_subsample_422`` it differs in 717 colours of Y, 204 of Cr and
  490 of Cb: the counts the runner reports (its ``mismatches`` reads the
  port's transform, which equals JAX's over the cube).
* The relayout against the body of ``profiles/profile_colorsplit3.py::
  _relayout_kernel`` on the probe's grid (``pallas_tile``, restated: the
  probe runs its timings at import), and against JAX's ``split_mcus``.

Tolerance: none (exact equality).
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

from lz4jpeg_tpu.ops.color import chroma_subsample_422 as jax_subsample
from lz4jpeg_tpu.ops.color import rgb_to_ycbcr as jax_rgb_to_ycbcr
from lz4jpeg_tpu.ops.color import split_mcus as jax_split_mcus

from lz4jpeg_tpu_torch.profiles import colorsplit3
from lz4jpeg_tpu_torch.profiles import mcu_relayout as mr
from lz4jpeg_tpu_torch.profiles import pallas_color as pc

CHUNK = 1024  # cube rows an interpret-mode call takes


# -- the probes' kernel bodies, verbatim ------------------------------------------


def make_color_kernel(R, W):
    """``profile_pallas_color.py:21-39`` (R and W are ``main``'s)."""

    def color_kernel(x_ref, y_ref, cr_ref, cb_ref):
        x = x_ref[:].astype(jnp.int32).astype(jnp.float32)  # (R, W, 3); no direct u8->f32 in Mosaic
        xt = jnp.transpose(x, (0, 2, 1))          # (R, 3, W)
        r = xt[:, 0, :]
        g = xt[:, 1, :]
        b = xt[:, 2, :]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cr = 0.439 * r - 0.368 * g - 0.071 * b + 128.0
        cb = -0.148 * r - 0.291 * g + 0.439 * b + 128.0
        # i16 outputs: Mosaic has no f32->u8 store; trunc semantics via
        # f32->i32 match the reference's trunc-on-u8-assign for [0,256).
        y_ref[:] = y.astype(jnp.int32).astype(jnp.int16)
        crc = jnp.clip(cr, 0.0, 255.0)
        cbc = jnp.clip(cb, 0.0, 255.0)
        # 4:2:2 keeping ODD columns: lane split (W) -> (W//2, 2), take [1]
        cr2 = crc.reshape(R, W // 2, 2)[:, :, 1]
        cb2 = cbc.reshape(R, W // 2, 2)[:, :, 1]
        cr_ref[:] = cr2.astype(jnp.int32).astype(jnp.int16)
        cb_ref[:] = cb2.astype(jnp.int32).astype(jnp.int16)

    return color_kernel


def _relayout_kernel(tw):
    """``profile_colorsplit3.py:115-126``."""
    tiles_per = 128 // tw

    def kernel(in_ref, out_ref):
        x = in_ref[:]  # (64, 128) u8: 8 tile-rows x tiles_per tiles
        out_ref[:] = (
            x.reshape(8, 8, tiles_per, tw)
            .transpose(0, 2, 1, 3)
            .reshape(8, tiles_per * 8 * tw)
        )

    return kernel


def pallas_tile(plane, tw):
    """``profile_colorsplit3.py:129-147``, with ``interpret=True``."""
    h, wp = plane.shape
    bh, bw = h // 8, wp // tw
    grid = (h // 64, wp // 128)
    out = pl.pallas_call(
        _relayout_kernel(tw),
        out_shape=jax.ShapeDtypeStruct((bh, bw * 8 * tw), jnp.uint8),
        grid=grid,
        in_specs=[
            pl.BlockSpec(
                (64, 128), lambda i, j: (i, j), memory_space=pltpu.VMEM
            )
        ],
        out_specs=pl.BlockSpec(
            (8, 1024), lambda i, j: (i, j), memory_space=pltpu.VMEM
        ),
        interpret=True,
    )(plane)
    return out.reshape(bh * bw, 8 * tw)


@pytest.fixture(scope="module")
def color_body():
    """The probe's pallas_call in interpret mode, jitted, for (R, W, 3)."""
    calls = {}

    def run(x: np.ndarray):
        r, w, _ = x.shape
        if (r, w) not in calls:
            calls[(r, w)] = jax.jit(lambda v: pl.pallas_call(
                make_color_kernel(r, w),
                out_shape=(
                    jax.ShapeDtypeStruct((r, w), jnp.int16),
                    jax.ShapeDtypeStruct((r, w // 2), jnp.int16),
                    jax.ShapeDtypeStruct((r, w // 2), jnp.int16),
                ),
                in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
                out_specs=tuple(
                    pl.BlockSpec(memory_space=pltpu.VMEM) for _ in range(3)
                ),
                interpret=True,
            )(v))
        return tuple(np.asarray(o) for o in calls[(r, w)](jnp.asarray(x)))

    return run


def _jax_chain(x: np.ndarray):
    """JAX's rgb_to_ycbcr + chroma_subsample_422 of an (R, W, 3) image, as
    the probe checks its kernel (:59-62)."""
    y, cr, cb = jax_rgb_to_ycbcr(jnp.asarray(x), jnp.float32)
    return tuple(np.asarray(p).astype(np.int16)
                 for p in (y, jax_subsample(cr), jax_subsample(cb)))


# -- the colour probe -------------------------------------------------------------


def test_plain_version_is_the_probe_body_on_the_probes_case(color_body):
    x = pc.probe_case(0)
    body = color_body(x.numpy())
    plain = pc.color_probe_ref(x)
    port = pc.color_probe(x)
    for b, p, q in zip(body, plain, port):
        assert np.array_equal(b, p.numpy()) and torch.equal(p, q)
    assert [p.shape for p in plain] == [(16, 2048), (16, 1024), (16, 1024)]
    # the probe's own check prints MISMATCH on its case
    assert pc.mismatches(plain, x) == {"y": 1, "cr": 0, "cb": 3}


@pytest.mark.parametrize("shift", [0, 1])
def test_plain_version_is_the_probe_body_over_the_colour_cube(shift,
                                                              color_body):
    cube = pc.colour_cube(shift, torch.device("cpu"))
    assert cube.shape == (pc.CUBE_ROWS, pc.CUBE_WIDTH, 3)
    differ = [0, 0, 0]
    for r0 in range(0, pc.CUBE_ROWS, CHUNK):
        x = cube[r0:r0 + CHUNK]
        body = color_body(x.numpy())
        plain = pc.color_probe_ref(x)
        for k in range(3):
            differ[k] += int((body[k] != plain[k].numpy()).sum())
    assert differ == [0, 0, 0]


def test_cube_mismatches_against_jax_are_the_runners():
    """Y, Cr and Cb colours that differ from JAX's snapped transform over
    the cube: Y once, each chroma over both column phases (every colour at
    an odd column once)."""
    jax_counts = {"y": 0, "cr": 0, "cb": 0}
    port_counts = dict(jax_counts)
    for shift in (0, 1):
        cube = pc.colour_cube(shift, torch.device("cpu"))
        for r0 in range(0, pc.CUBE_ROWS, CHUNK):
            x = cube[r0:r0 + CHUNK]
            plain = pc.color_probe_ref(x)
            want = _jax_chain(x.numpy())
            ours = pc.snapped_chain(x)
            for k, name in enumerate(("y", "cr", "cb")):
                assert np.array_equal(ours[k].numpy(), want[k])
                if name == "y" and shift:
                    continue
                jax_counts[name] += int((plain[k].numpy() != want[k]).sum())
            found = pc.mismatches(plain, x)
            for name in ("y", "cr", "cb") if not shift else ("cr", "cb"):
                port_counts[name] += found[name]
    assert jax_counts == port_counts == {"y": 717, "cr": 204, "cb": 490}


def test_plain_version_rounds_as_float32_fmas():
    """One colour by hand: float32 fma order, no snap, clip, truncation."""
    r, g, b = np.float32(255), np.float32(0), np.float32(255)
    x = torch.tensor([[[0, 0, 0], [255, 0, 255]]], dtype=torch.uint8)
    y, cr, cb = pc.color_probe_ref(x)
    f32 = np.float32

    def fma(a, u, c):
        return f32(float(f32(a)) * float(u) + float(c))

    assert y[0, 1] == int(fma(0.114, b, fma(0.299, r, f32(f32(0.587) * g))))
    assert cr[0, 0] == int(min(max(f32(fma(-0.071, b, fma(0.439, r, -f32(
        f32(0.368) * g))) + f32(128)), 0), 255))
    assert cb[0, 0] == int(min(max(f32(fma(0.439, b, fma(-0.148, r, -f32(
        f32(0.291) * g))) + f32(128)), 0), 255))
    assert y.dtype == cr.dtype == cb.dtype == torch.int16


@pytest.mark.parametrize("shape,dtype,error", [
    ((4, 3, 3), torch.uint8, ValueError),   # W odd
    ((4, 6, 4), torch.uint8, ValueError),   # not RGB
    ((3,), torch.uint8, ValueError),
    ((4, 6, 3), torch.int16, TypeError)])
def test_colour_refusals(shape, dtype, error):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        pc.color_probe(x)
    with pytest.raises(error):
        pc.color_probe_ref(x)


# -- the relayout ----------------------------------------------------------------


@pytest.mark.parametrize("shape,tw", [((128, 256), 8), ((128, 128), 4),
                                      ((64, 384), 8), ((192, 128), 4)])
def test_relayout_is_the_probe_body_and_split_mcus(shape, tw):
    plane = np.random.default_rng(tw).integers(0, 256, size=shape,
                                               dtype=np.uint8)
    body = np.asarray(pallas_tile(jnp.asarray(plane), tw))
    if tw == 8:  # the luma plane beside chroma planes of half its width
        jax_tiles = jax_split_mcus(jnp.asarray(plane),
                                   jnp.asarray(plane[:, ::2]),
                                   jnp.asarray(plane[:, ::2]))[0]
    else:
        jax_tiles = jax_split_mcus(jnp.asarray(np.repeat(plane, 2, axis=1)),
                                   jnp.asarray(plane), jnp.asarray(plane))[1]
    ours = mr.mcu_relayout(torch.from_numpy(plane), tw)
    assert ours.shape == (shape[0] // 8 * shape[1] // tw, 8 * tw)
    assert np.array_equal(ours.numpy(), body)
    assert np.array_equal(ours.numpy(), np.asarray(jax_tiles).reshape(body.shape))
    assert torch.equal(ours, mr.mcu_relayout_ref(torch.from_numpy(plane), tw))


@pytest.mark.parametrize("shape,tw", [((2, 16, 24), 8), ((8, 12), 4),
                                      ((3, 8, 4), 4), ((1, 24, 8), 8)])
def test_relayout_stacks_frames_outermost(shape, tw):
    planes = np.random.default_rng(7).integers(0, 256, size=shape,
                                               dtype=np.uint8)
    ours = mr.mcu_relayout(torch.from_numpy(planes), tw).numpy()
    frames = planes.reshape(-1, *shape[-2:])
    want = []
    for f in frames:
        if tw == 8:
            t = jax_split_mcus(jnp.asarray(f), jnp.asarray(f[:, ::2]),
                               jnp.asarray(f[:, ::2]))[0]
        else:
            t = jax_split_mcus(jnp.asarray(np.repeat(f, 2, axis=1)),
                               jnp.asarray(f), jnp.asarray(f))[1]
        want.append(np.asarray(t).reshape(-1, 8 * tw))
    assert np.array_equal(ours, np.concatenate(want))


@pytest.mark.parametrize("shape,tw,dtype,error", [
    ((12, 16), 8, torch.uint8, ValueError),   # H % 8
    ((8, 18), 8, torch.uint8, ValueError),    # Wp % tw
    ((8, 0), 4, torch.uint8, ValueError),
    ((8, 16), 5, torch.uint8, ValueError),    # tw
    ((16,), 8, torch.uint8, ValueError),
    ((8, 16), 8, torch.int16, TypeError)])
def test_relayout_refusals(shape, tw, dtype, error):
    x = torch.zeros(shape, dtype=dtype)
    with pytest.raises(error):
        mr.mcu_relayout(x, tw)
    with pytest.raises(error):
        mr.mcu_relayout_ref(x, tw)


def test_wrappers_count_no_launch_on_the_cpu():
    counts = (pc.color_probe.launches, mr.mcu_relayout.launches)
    pc.color_probe(torch.zeros((2, 4, 3), dtype=torch.uint8))
    mr.mcu_relayout(torch.zeros((8, 8), dtype=torch.uint8), 8)
    assert counts == (pc.color_probe.launches, mr.mcu_relayout.launches)
    assert pc.attributes("cpu")["registers"] is None
    assert mr.attributes(4, "cpu")["ctas_per_sm"] is None


# -- the runners ---------------------------------------------------------------------


@pytest.mark.parametrize("module,args", [
    (pc, ["--frames", "1", "--side", "32", "--cube-rows", "8"]),
    (colorsplit3, ["--frames", "1", "--side", "64"]),
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
    if module is pc:
        assert art["probe_mismatches"] == {"y": 1, "cr": 0, "cb": 3}
        assert art["timed"]["shape"] == [1, 32, 32, 3]
        assert art["timed"]["host_ms"] > 0 and art["timed"]["share"] is None
        assert art["timed"]["bytes"] == 7 * 32 * 32
    else:
        assert [r["row"] for r in art["rows"]][0] == "A baseline split+matmul"
        assert len(art["rows"]) == 6
        assert art["checks"]["C"]["mismatches"] == 0
        assert [r["tw"] for r in art["relayout"]] == [8, 4]
        assert [r["shape"] for r in art["relayout"]] == [[1, 64, 64],
                                                         [1, 64, 32]]

