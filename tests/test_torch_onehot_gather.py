"""The one-hot gather template (``lz4jpeg_tpu_torch/profiles/
onehot_gather.py`` and the runner ``lz4t_mxu_gather.py``) on the CPU, held
against the four TPU probes' own kernels.

``profiles/probe_lz4t_mxu_gather{,2,3,4}.py`` define their kernels and
``pallas_call`` wrappers inside ``main`` (and read the absent reference
corpus first), so they are restated verbatim below, their closure
variables (B, P, C, T, G, SUB, ...) made parameters, and run with
``interpret=True``.  Each of the ten rows of ``ROWS`` (g1; g2 full,
nomask, hbuild; g3 T = 512, 1024, 2048; g4 (32, bf16), (32, i8), (16, i8))
is compared, before the probes' final uint8 cast, with the port's plain
version through ``row_output``:

* on synthetic roots (B = 2, P = 4,096, some roots outside [0, P), which
  pin down what the dense product gives there: 0, or 128 for the int8
  route);
* on the roots of a small ``generate_text`` frame (16 KiB blocks) built by
  both packages' ``build_copy_program_fast(depth_cap=1)``, where every full
  row also equals ``torch.gather`` and the text.

Tolerance: none (exact equality).
"""

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

from lz4jpeg_tpu.ops.lz4t_decode import (
    build_copy_program_fast as jax_build_copy_program_fast,
)

from lz4jpeg_tpu_torch import LZ4Codec, LZ4Config
from lz4jpeg_tpu_torch.ops.lz4t_decode import _trim_rows
from lz4jpeg_tpu_torch.profiles import lz4t_mxu_gather
from lz4jpeg_tpu_torch.profiles import onehot_gather as og
from lz4jpeg_tpu_torch.utils.inputs import generate_text

REPO = Path(__file__).resolve().parent.parent
CHUNK = 128


# -- the probes' kernels, verbatim (closure variables as parameters) ----------------


def g1_run(B, p):
    """``probe_lz4t_mxu_gather.py:61-109``: kernel3 and mxu_gather."""
    T = 2048           # outputs per grid step
    CHUNK = 128        # lo range == lane width
    C = p // CHUNK     # hi range (512)
    G = p // T

    def kernel3(root_ref, lit2_ref, out_ref):
        r2 = root_ref[0]                    # (T//128, 128) int32
        rt = r2.T                           # (128, T//128) outputs on sublanes
        sub = rt.shape[1]
        outs = []
        for g in range(sub):                # T//128 sub-chunks
            rcol = rt[:, g:g + 1]           # (128, 1) roots of chunk g
            hi = rcol >> 7                  # (128, 1)
            lo = rcol & 127
            # H (128, C) one-hot over hi
            cio = jax.lax.broadcasted_iota(jnp.int32, (128, C), 1)
            h = (cio == hi).astype(jnp.bfloat16)
            rows = jax.lax.dot_general(
                h, lit2_ref[0], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )                               # (128, 128) gathered chunk rows
            lio = jax.lax.broadcasted_iota(jnp.int32, (128, CHUNK), 1)
            lsel = (lio == lo)
            byte = jnp.sum(
                jnp.where(lsel, rows.astype(jnp.int32), 0), axis=1,
                keepdims=True,
            )                               # (128, 1)
            outs.append(byte)
        out = jnp.concatenate(outs, axis=1)  # (128, T//128)
        out_ref[0] = out.T.astype(jnp.uint8)

    @jax.jit
    def mxu_gather(root_in, lit_in):
        root3 = root_in.reshape(B * G, T // 128, 128)
        lit2 = lit_in.reshape(B, C, CHUNK).astype(jnp.bfloat16)
        # grid step i handles block i // G, out-chunk i % G
        return pl.pallas_call(
            kernel3,
            grid=(B * G,),
            in_specs=[
                pl.BlockSpec((1, T // 128, 128), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, C, CHUNK), lambda i: (i // G, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, T // 128, 128), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((B * G, T // 128, 128), jnp.uint8),
            interpret=True,
        )(root3, lit2)

    return lambda r, l: np.asarray(mxu_gather(r, l)).reshape(B, p)


def g2_run(B, p, mode):
    """``probe_lz4t_mxu_gather2.py:40-102``: make(mode), the (B, P) int32
    output before the run's final uint8 cast."""
    T = 2048
    CHUNK = 128
    C = p // CHUNK
    G = p // T
    SUB = T // 128

    def kernel(root_ref, lit2_ref, out_ref):
        rt = root_ref[0]                 # (128, SUB) pre-transposed
        outs = []
        for g in range(SUB):
            rcol = rt[:, g:g + 1]
            hi = rcol >> 7
            lo = rcol & 127
            if mode == "hbuild":
                cio = jax.lax.broadcasted_iota(jnp.int32, (128, C), 1)
                h = (cio == hi).astype(jnp.bfloat16)
                outs.append(
                    jnp.sum(h.astype(jnp.int32), axis=1, keepdims=True)
                    + lo
                )
                continue
            cio = jax.lax.broadcasted_iota(jnp.int32, (128, C), 1)
            h = (cio == hi).astype(jnp.bfloat16)
            rows = jax.lax.dot_general(
                h, lit2_ref[0], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            if mode == "nomask":
                outs.append(
                    jnp.sum(rows.astype(jnp.int32), axis=1, keepdims=True)
                )
                continue
            lio = jax.lax.broadcasted_iota(jnp.int32, (128, CHUNK), 1)
            byte = jnp.sum(
                jnp.where(lio == lo, rows.astype(jnp.int32), 0),
                axis=1, keepdims=True,
            )
            outs.append(byte)
        out_ref[0] = jnp.concatenate(outs, axis=1).astype(jnp.int32)

    @jax.jit
    def run(root_in, lit_in):
        # XLA pre-transpose: outputs on sublanes, SUB chunk cols
        root_t = root_in.reshape(B * G, SUB, 128).transpose(0, 2, 1)
        lit2 = lit_in.reshape(B, C, CHUNK).astype(jnp.bfloat16)
        out_t = pl.pallas_call(
            kernel,
            grid=(B * G,),
            in_specs=[
                pl.BlockSpec((1, 128, SUB), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, C, CHUNK), lambda i: (i // G, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, 128, SUB), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(
                (B * G, 128, SUB), jnp.int32),
            interpret=True,
        )(root_t, lit2)
        # XLA transposes back
        return out_t.transpose(0, 2, 1).reshape(B, p)

    return lambda r, l: np.asarray(run(r, l))


def g3_run(B, p, T):
    """``probe_lz4t_mxu_gather3.py:41-86``: make(T, True), the (B, P) int32
    output before the run's final uint8 cast."""
    CHUNK = 128
    C = p // CHUNK
    G = p // T

    def kernel(root_ref, lit2_ref, out_ref):
        r = root_ref[0]                   # (T, 1) i32, outputs on sublanes
        hi = r >> 7
        lo = r & 127
        cio = jax.lax.broadcasted_iota(jnp.int32, (T, C), 1)
        h = (cio == hi).astype(jnp.bfloat16)    # one big vector compare
        rows = jax.lax.dot_general(
            h, lit2_ref[0], (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )                                  # (T, 128)
        lio = jax.lax.broadcasted_iota(jnp.int32, (T, CHUNK), 1)
        byte = jnp.sum(
            jnp.where(lio == lo, rows.astype(jnp.int32), 0),
            axis=1, keepdims=True,
        )                                  # (T, 1)
        out_ref[0] = byte

    @jax.jit
    def run(root_in, lit_in):
        root_t = root_in.reshape(B * G, T, 1)
        lit2 = lit_in.reshape(B, C, CHUNK).astype(jnp.bfloat16)
        out_t = pl.pallas_call(
            kernel,
            grid=(B * G,),
            in_specs=[
                pl.BlockSpec((1, T, 1), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, C, CHUNK), lambda i, G=G: (i // G, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, T, 1), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((B * G, T, 1), jnp.int32),
            interpret=True,
        )(root_t, lit2)
        return out_t.reshape(B, p)

    return lambda r, l: np.asarray(run(r, l))


def g4_run(B, p, rows_per_step, dtype_mode):
    """``probe_lz4t_mxu_gather4.py:45-107``: make(rows_per_step,
    dtype_mode), the (B, P) int32 output before the run's final uint8
    cast."""
    CHUNK = 128
    C = p // CHUNK
    use_i8 = dtype_mode == "i8"
    R = rows_per_step            # 128-output rows per grid step
    G = p // (128 * R)

    def kernel(root_ref, lit2t_ref, out_ref):
        r2 = root_ref[0]          # (R, 128) i32 — outputs dense
        hi = r2 >> 7
        lo = r2 & 127
        sio = jax.lax.broadcasted_iota(jnp.int32, (C, 128), 0)
        bio = jax.lax.broadcasted_iota(jnp.int32, (CHUNK, 128), 0)
        outs = []
        for r in range(R):
            hrow = hi[r:r + 1, :]              # (1, 128)
            if use_i8:
                # int8 MXU at 2x the bf16 rate: bytes ride as v-128
                # (one 1 per one-hot column keeps sums exact in i32)
                ht = (sio == hrow).astype(jnp.int8)
                rows_t = jax.lax.dot_general(
                    lit2t_ref[0], ht, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.int32,
                ) + 128
            else:
                ht = (sio == hrow).astype(jnp.bfloat16)   # (C, 128)
                rows_t = jax.lax.dot_general(
                    lit2t_ref[0], ht, (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )                              # (128, 128): byte x output
            lrow = lo[r:r + 1, :]
            sel = bio == lrow                  # (128, 128)
            outs.append(jnp.sum(
                jnp.where(sel, rows_t.astype(jnp.int32), 0),
                axis=0, keepdims=True,
            ))                                 # (1, 128)
        out_ref[0] = jnp.concatenate(outs, axis=0)  # (R, 128)

    @jax.jit
    def run(root_in, lit_in):
        root3 = root_in.reshape(B * G, R, 128)
        # lit2t: (B, 128 bytes-in-chunk, C chunks)
        l3 = jnp.transpose(lit_in.reshape(B, C, CHUNK), (0, 2, 1))
        lit2t = (
            (l3.astype(jnp.int32) - 128).astype(jnp.int8)
            if use_i8 else l3.astype(jnp.bfloat16)
        )
        out = pl.pallas_call(
            kernel,
            grid=(B * G,),
            in_specs=[
                pl.BlockSpec((1, R, 128), lambda i: (i, 0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, CHUNK, C), lambda i, G=G: (i // G, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, R, 128), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((B * G, R, 128), jnp.int32),
            interpret=True,
        )(root3, lit2t)
        return out.reshape(B, p)

    return lambda r, l: np.asarray(run(r, l))


def probe_row(name, B, p):
    """The probe's function for a row of ``ROWS``."""
    if name == "g1":
        return g1_run(B, p)
    probe, rest = name.split(" ", 1)
    if probe == "g2":
        return g2_run(B, p, rest)
    if probe == "g3":
        return g3_run(B, p, int(rest.split("=")[1]))
    rows, dtype = rest.split()
    return g4_run(B, p, int(rows.split("=")[1]), dtype)


ROW_NAMES = [row.name for row in og.ROWS]


@pytest.fixture(scope="module")
def synthetic():
    rng = np.random.default_rng(16)
    b, p = 2, 4096
    root = rng.integers(0, p, size=(b, p)).astype(np.int32)
    root[0, :5] = [-1, -129, p, p + 300, 2 * p]   # outside [0, P)
    lit = rng.integers(0, 256, size=(b, p)).astype(np.uint8)
    return root, lit


@pytest.fixture(scope="module")
def frame_program():
    """A generated-text frame in 16 KiB blocks, rooted by both packages."""
    text = generate_text(20_000, np.random.default_rng(3))
    frame = LZ4Codec(LZ4Config(mode="fast"), device="cpu").encode(
        text, engine="device")
    lit, root, sizes, p, depth = lz4t_mxu_gather.rooted_program(frame)
    jlit, jsrc, jsizes, jp, _ = jax_build_copy_program_fast(frame, depth_cap=1)
    jroot = np.where(jsrc < 0, np.arange(jp, dtype=np.int32)[None, :], jsrc)
    assert np.array_equal(jlit, lit) and np.array_equal(jroot, root)
    assert np.array_equal(np.asarray(jsizes), np.asarray(sizes)) and jp == p
    assert depth <= 1 and p == 16_384 and lit.shape[0] == 2
    return text, lit, root.astype(np.int32), sizes


@pytest.mark.parametrize("name", ROW_NAMES)
def test_rows_are_the_probe_bodies_on_synthetic_roots(name, synthetic):
    root, lit = synthetic
    row = next(r for r in og.ROWS if r.name == name)
    body = probe_row(name, *root.shape)(jnp.asarray(root), jnp.asarray(lit))
    ours = og.row_output(row, torch.from_numpy(root), torch.from_numpy(lit))
    assert ours.dtype == og.BY_NAME[row.kernel].out
    assert np.array_equal(ours.numpy().astype(np.int64),
                          body.astype(np.int64))
    if og.BY_NAME[row.kernel].cut == og.FULL:
        want = np.take_along_axis(lit, np.clip(root, 0, root.shape[1] - 1),
                                  axis=1)
        inside = (root >= 0) & (root < root.shape[1])
        assert np.array_equal(ours.numpy()[inside].astype(np.uint8),
                              want[inside])
        # outside [0, P) the dense product has no 1: 0, or 0 + 128 in int8
        assert set(ours.numpy()[~inside].tolist()) == {
            og.BY_NAME[row.kernel].bias}


@pytest.mark.parametrize("name", ROW_NAMES)
def test_rows_are_the_probe_bodies_on_a_text_frame(name, frame_program):
    text, lit, root, sizes = frame_program
    row = next(r for r in og.ROWS if r.name == name)
    body = probe_row(name, *root.shape)(jnp.asarray(root), jnp.asarray(lit))
    ours = og.row_output(row, torch.from_numpy(root), torch.from_numpy(lit))
    assert np.array_equal(ours.numpy().astype(np.int64),
                          body.astype(np.int64))
    if og.BY_NAME[row.kernel].cut == og.FULL:
        gathered = torch.gather(torch.from_numpy(lit), 1,
                                torch.from_numpy(root).long())
        assert torch.equal(ours.to(torch.uint8), gathered)
        assert _trim_rows(og.row_bytes(row, torch.from_numpy(root),
                                       torch.from_numpy(lit)).numpy(),
                          sizes) == text


def test_kernels_and_rows_name_the_probes():
    lines = {f: (REPO / "profiles" / f).read_text().splitlines()
             for f in {r.site.split(":")[0] for r in og.ROWS}}
    for row in og.ROWS:
        f, line = row.site.split(":")
        assert "def kernel" in lines[f][int(line) - 1], row.site
    assert sorted({r.kernel for r in og.ROWS}) == sorted(og.BY_NAME)
    shared = [r.name for r in og.ROWS if r.kernel == "hl_bf16_full_2048"]
    assert shared == ["g2 full", "g3 T=2048"]
    assert len(og.KERNELS) == 9 and og.KERNELS[0].out == torch.uint8


@pytest.mark.parametrize("kernel,orient,dtype", [
    ("hl_bf16_full_2048", og.HL, torch.bfloat16),
    ("lt_bf16_full_4096", og.LT_HT, torch.bfloat16),
    ("lt_i8_full_2048", og.LT_HT, torch.int8)])
def test_literal_operand_is_the_probes_xla_preparation(kernel, orient, dtype):
    lit = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(2, 4096)).astype(np.uint8))
    op = og.literal_operand(lit, og.BY_NAME[kernel])
    l3 = lit.numpy().reshape(2, 32, 128)
    want = l3 if orient == og.HL else l3.transpose(0, 2, 1)
    assert op.dtype == dtype and op.is_contiguous()
    if dtype == torch.int8:
        want = (want.astype(np.int32) - 128).astype(np.int8)
        assert np.array_equal(op.numpy(), want)
    else:
        assert np.array_equal(op.float().numpy(), want.astype(np.float32))


def test_row_bounds():
    outputs, chunks = 64 * 65_536, 512
    by = {r.name: og.row_bound(r, outputs, chunks) for r in og.ROWS}
    assert round(by["g1"]["bound_ms"], 4) == 0.5559
    assert by["g1"]["bound_by"] == "operations"
    assert by["g1"]["operations"] == 2 * outputs * chunks * 128
    assert round(by["g4 R=32 i8"]["bound_ms"], 4) == 0.2778
    assert round(by["g2 hbuild"]["bound_ms"], 4) == 0.0100
    assert by["g2 hbuild"]["bytes"] == outputs * 8
    assert by["g2 hbuild"]["issue_bound_ms"] is None  # no card


@pytest.mark.parametrize("shape,kernel,root_dtype,error", [
    ((1, 3072), "hl_bf16_full_2048", torch.int32, ValueError),  # P % 2048
    ((1, 2048), "lt_bf16_full_4096", torch.int32, ValueError),  # P % step
    ((1, 131_072), "hl_bf16_full_512", torch.int32, ValueError),  # P > 65,536
    ((2048,), "hl_bf16_full_512", torch.int32, ValueError),
    ((1, 2048), "g5", torch.int32, ValueError),
    ((1, 2048), "hl_bf16_full_512", torch.int64, TypeError)])
def test_refusals(shape, kernel, root_dtype, error):
    root = torch.zeros(shape, dtype=root_dtype)
    lit = torch.zeros(shape, dtype=torch.uint8)
    with pytest.raises(error):
        og.onehot_gather(root, lit, kernel)
    with pytest.raises(error):
        og.onehot_gather_ref(root, lit, kernel)


def test_no_launch_counted_on_the_cpu():
    before = og.onehot_gather.launches
    og.onehot_gather(torch.zeros((1, 2048), dtype=torch.int32),
                     torch.zeros((1, 2048), dtype=torch.uint8),
                     "hl_bf16_full_512")
    assert og.onehot_gather.launches == before
    assert og.attributes("lt_i8_full_2048", "cpu")["registers"] is None


def test_runner_on_the_cpu_writes_only_its_output(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    text = generate_text(20_000, np.random.default_rng(0))
    frame = LZ4Codec(LZ4Config(mode="fast"), device="cpu").encode(
        text, engine="device")  # 16 KiB blocks: the native 64 KiB take long
    lz4t_mxu_gather.run_lz4t_mxu_gather(
        "cpu", corpus=text, frame=frame, runs=1, reps=1, output="a.json")
    assert os.listdir(tmp_path) == ["a.json"]
    art = json.loads((tmp_path / "a.json").read_text())
    assert art["device"] == "cpu" and "card" not in art
    assert art["timer"] == "host clock" and art["verdict"].startswith("on cpu:")
    assert [r["row"] for r in art["rows"]] == ROW_NAMES
    assert (art["blocks"], art["p"], art["text_bytes"]) == (2, 16_384, 20_000)
    assert all(r["host_ms"] > 0 and r["share"] is None for r in art["rows"])
    assert set(art["comparisons"]) >= {"k3_host_ms", "gather_host_ms",
                                       "doubling_host_ms"}
    with pytest.raises(ValueError):
        lz4t_mxu_gather.run_lz4t_mxu_gather("cpu", frame=frame)
    seen = {}
    monkeypatch.setattr(lz4t_mxu_gather, "run_lz4t_mxu_gather",
                        lambda *a, **k: seen.update(args=a, **k))
    assert lz4t_mxu_gather.main(["--device", "cpu", "--text-bytes", "20000",
                                 "--runs", "1", "--output", "b.json"]) == 0
    assert seen["args"] == ("cpu",) and seen["text_bytes"] == 20_000
    assert (seen["runs"], seen["output"]) == (1, "b.json")



# -- the kernel's register maps (onehot_gather.py's numpy mirror) -------------
# The mirror composes the kernel's fragments as the tensor cores read them
# (PTX ISA layouts of m16n8k16 bf16 and m16n8k32 s8), so a layout error in
# the kernel's one-hot registers, slab swizzle, ldmatrix addresses or
# epilogue shows here, before the card.  Tolerance: none.

MIRRORED = [(k.name, p) for k in og.KERNELS for p in (2048, 4096)
            if p % k.step == 0]
KINDS = ["hl_bf16_full_2048", "lt_bf16_full_4096", "lt_i8_full_4096"]


@pytest.mark.parametrize("kernel,p", MIRRORED)
def test_emulated_fragments_compose_the_plain_version(kernel, p):
    rng = np.random.default_rng(p + len(kernel))
    root = rng.integers(-300, p + 300, size=(2, p)).astype(np.int32)
    root[0, :4] = [-1, p, -129, 2 * p]  # outside [0, P)
    lit = rng.integers(0, 256, size=(2, p)).astype(np.uint8)
    r, lt = torch.from_numpy(root), torch.from_numpy(lit)
    got = og.emulate(r, lt, kernel, grid=3)  # runs that cross blocks
    assert got.dtype == og.BY_NAME[kernel].out
    assert torch.equal(got, og.onehot_gather_ref(r, lt, kernel))


@pytest.mark.parametrize("elem", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("role", ["a", "b", "c"])
def test_fragment_maps_cover_each_tile_element_once(role, elem):
    spec = og.Kernel("x", og.LT_HT, elem, og.FULL, 4096, torch.int32)
    k = 256 // og.element_format(spec)[0]
    rows, cols = {"a": (16, k), "b": (k, 8), "c": (16, 8)}[role]
    fm = og.fragment_map(role, spec).reshape(-1, 2)
    assert len(fm) == rows * cols
    assert {tuple(x) for x in fm} == {(i, j) for i in range(rows)
                                      for j in range(cols)}


@pytest.mark.parametrize("kernel", KINDS)
def test_one_hot_registers_hold_each_output_and_k_once(kernel):
    """Every one-hot register element stands for one k of the slice: with
    every root's hi at k it is 1 for that k only, and the tiles the PTX
    layout reads are the one-hot of every output."""
    spec = og.BY_NAME[kernel]
    k = 256 // og.element_format(spec)[0]
    role = "a" if spec.orient == og.HL else "b"
    lit_up = 0
    for s in (0, 1):
        for kk in range(k):
            roots = (np.full((1, 64), (s * k + kk) << 7)
                     + np.arange(64) % 128).astype(np.int32)
            regs = og.hot_registers(spec, roots, s)
            lit_up = lit_up + og._elements(spec, regs)[0]
            tiles = og._tiles(spec, regs, role)[0]
            want = np.zeros_like(tiles)
            if spec.orient == og.HL:
                want[:, :, kk] = 1  # (m-tile, output row, k)
            else:
                want[:, kk, :] = 1  # (n-tile, k, output column)
            assert np.array_equal(tiles, want), (s, kk)
    assert (lit_up == 2).all()  # once a slice, two slices


@pytest.mark.parametrize("kernel", KINDS)
def test_ldmatrix_reads_each_slab_byte_once_and_conflict_free(kernel):
    spec = og.BY_NAME[kernel]
    lane = np.arange(64)
    for h in (0, 1):
        for s in (0, 1):
            rows = og.ldsm_rows(spec, h, s)
            got = np.stack([og.ldsm_bytes(rows[i], spec.orient == og.HL)
                            for i in range(4)]).reshape(-1)
            if spec.orient == og.HL:  # k rows 16s.., lanes 64h..
                k = 16 * s + np.arange(16)[:, None]
                ln = 64 * h + lane[None, :]
                first = og.chunk_offset(og.HL, k, ln // 8) + 2 * (ln % 8)
                want = np.stack([first, first + 1], -1)
            else:  # lane rows 64h.., chunks 2s, 2s + 1
                c = 2 * s + np.arange(2)[:, None, None]
                first = og.chunk_offset(og.LT_HT, 64 * h + lane[None, :, None],
                                        c)
                want = first + np.arange(16)
            assert len(got) == len(set(got.tolist())) == 64 * 32
            assert set(got.tolist()) == set(want.reshape(-1).tolist())
            for call in rows:  # each matrix's 8 rows in 8 bank groups
                for m in range(4):
                    assert len({(a // 16) % 8 for a in call[8 * m:8 * m + 8]}) == 8


@pytest.mark.parametrize("kernel,p", [("hl_bf16_full_2048", 4096),
                                      ("lt_bf16_full_4096", 4096),
                                      ("lt_i8_full_4096", 4096),
                                      ("lt_i8_full_2048", 2048)])
def test_staged_slab_places_every_chunk_once(kernel, p):
    spec = og.BY_NAME[kernel]
    n = p * spec.elem.itemsize
    raw = (np.arange(n) % 200).astype(np.uint8)[None, :]  # never 0xEE
    slab = og.stage_slab(spec, raw)[0]
    assert not (slab == 0xEE).any()
    assert np.sort(slab[slab != 0]).tolist() == np.sort(raw[0][raw[0] != 0]).tolist()
    if kernel == "lt_i8_full_2048":  # C = 16: the k-slice's other half is 0
        assert slab.size == 4096 and (slab == 0).sum() == 2048 + (raw == 0).sum()


@pytest.mark.parametrize("kernel", KINDS)
def test_accumulators_cover_the_pass_tile_and_the_holder_finds_each(kernel):
    spec = og.BY_NAME[kernel]
    am = og.accumulator_map(spec)  # (lane, m-tile, n-tile, c) → (o, lane)
    flat = am.reshape(-1, 2)
    assert len({tuple(x) for x in flat}) == len(flat) == 64 * 64
    o, ln = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    at = og.holder(spec, o, ln)
    assert np.array_equal(am[at], np.stack([o, ln], -1))


@pytest.mark.parametrize("steps,grid", [(2048, 132), (8192, 132), (64, 3),
                                        (7, 7), (1024, 132)])
def test_cta_runs_cover_every_step_once(steps, grid):
    runs = og.cta_runs(steps, grid)
    assert [s for b, e in runs for s in range(b, e)] == list(range(steps))
    assert max(e - b for b, e in runs) == -(-steps // grid)


def test_prepared_gather_refuses_cpu_and_foreign_operands():
    root = torch.zeros((1, 4096), dtype=torch.int32)
    lit = torch.zeros((1, 4096), dtype=torch.uint8)
    op = og.literal_operand(lit, og.BY_NAME["lt_i8_full_2048"])
    with pytest.raises(ValueError):  # the kernel runs on a card only
        og.onehot_gather_prepared(root, op, "lt_i8_full_2048")
    with pytest.raises(ValueError):  # an int8 operand for a bf16 kernel
        og.onehot_gather_prepared(root, op, "hl_bf16_full_2048")
    with pytest.raises(ValueError):  # P 3,072
        og.onehot_gather_prepared(root[:, :3072], op, "lt_i8_full_2048")
    with pytest.raises(TypeError):
        og.onehot_gather_prepared(root.long(), op, "lt_i8_full_2048")


def test_sass_loops_finds_the_innermost_loop_and_counts_it():
    from lz4jpeg_tpu_torch.profiles import sass_loops

    ins = ["MOV R1, c[0x0][0x28]", "LDSM.16.MT88.4 R8, [R2]",
           "HMMA.16816.F32.BF16 R4, R8, R12, R4", "@P0 BRA 0x10",
           "STS.128 [R0], R4", "LD.E R3, [R6.64]", "@!P1 BRA 0x0", "EXIT",
           "BRA 0x80"]
    assert sass_loops.opcode("@!P0 LDSM.16.MT88.4 R4, [R2]") == "LDSM"
    inner = sass_loops.loops(ins)
    assert len(inner) == 1
    assert {k: inner[0][k] for k in ("first", "last", "length", "HMMA",
                                     "LDSM", "STS", "LD")} == {
        "first": 1, "last": 3, "length": 3, "HMMA": 1, "LDSM": 1, "STS": 0,
        "LD": 0}
    assert sass_loops.loops(ins[4:7] + ["BRA 0x0"])[0]["LD"] == 1
    padded = sass_loops.loops(["@!PT LDS RZ, [RZ]", "LDGSTS.E.BYPASS.128 [R1], "
                               "desc[UR4][R2.64]", "@P0 BRA 0x0"])[0]
    assert (padded["LDS"], padded["length"]) == (0, 2)
