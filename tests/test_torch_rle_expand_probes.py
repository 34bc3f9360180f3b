"""K7's phase split (``lz4jpeg_tpu_torch/profiles/rle_expand.py`` and its
runners ``rle_expand_rm.py``, ``rle_expand_ablate.py``) on the CPU, held
against the JAX package and the probes' semantics.

* The three copies against ``profiles/profile_rle_expand_rm.py``'s kernels
  restated in jnp (the probe defines them inside its ``main``): the
  identity on the (rows, 64) and (rows/2, 128) views, ``.T``, and
  ``jnp.transpose(p.reshape(bh, bw, K), (0, 2, 1))``.
* The full phase against the JAX plane decode
  ``ops/pallas_rle.py::rle_decode_packed16_pallas_plane`` in interpret
  mode, the XLA spec ``ops/rle.py::rle_decode_packed16`` moved into the
  plane, and the port's ``pack16_decode_plane_ref``, on words that JAX's
  ``rle_encode_packed16`` made from the ablation probe's values (canonical
  streams: the Pallas kernel reads word 0 as padding and ignores lengths,
  which K7 and the port honour).
* Each ablated phase against a numpy restatement of the formula in
  ``csrc/expand16_plane.cuh``, slot by slot as the kernel runs, also on
  non-canonical rows (``utils/inputs.py::crafted_packed16_rows``).
* The einsum orientations against each other and against ``jnp.einsum``
  at HIGHEST precision with the probe's rounding.

Tolerance: none (exact equality), except the einsum A/B: max |Δ| ≤ 1 on at
most 1e-4 of the pixels (float32 sums in another order may round a pixel
that lies within rounding noise of .5 the other way).
"""

import ast
import json
import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops.fused import _table_key as jax_table_key
from lz4jpeg_tpu.ops.fused import inverse_basis as jax_inverse_basis
from lz4jpeg_tpu.ops.pallas_rle import rle_decode_packed16_pallas_plane
from lz4jpeg_tpu.ops.rle import rle_decode_packed16 as jax_decode
from lz4jpeg_tpu.ops.rle import rle_encode_packed16 as jax_encode
from lz4jpeg_tpu.oracle.jpeg_oracle import LUMINANCE_QUANTIZATION_TABLE

from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.ops.rle import rle_encode_packed16
from lz4jpeg_tpu_torch.profiles import rle_expand as rx
from lz4jpeg_tpu_torch.profiles import rle_expand_ablate, rle_expand_rm, timing
from lz4jpeg_tpu_torch.utils.inputs import crafted_packed16_rows

REPO = Path(__file__).resolve().parent.parent


def _words(k: int, rows: int, seed: int):
    """JAX's packed16 words (int16 bits) and lengths of the ablation probe's
    values; the port's encode gives the same bits."""
    vals = rx.ablate_symbols(rows, k, np.random.default_rng(seed))
    w, l = jax_encode(jnp.asarray(vals))
    words = np.array(w).view(np.int16)
    pw, pl_ = rle_encode_packed16(torch.from_numpy(vals))
    np.testing.assert_array_equal(pw.numpy(), words)
    np.testing.assert_array_equal(pl_.numpy(), np.asarray(l))
    return words, np.array(l).astype(np.int32)


def _int16(x):
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000


def _numpy_phase(words: np.ndarray, lengths: np.ndarray, phase: str):
    """(N, K) values of ``phase``, slot by slot as K7's body runs
    (``csrc/expand16_plane.cuh``)."""
    n, k = words.shape
    out = np.zeros((n, k), np.int64)
    for row in range(n):
        w = words[row].astype(np.int64) & 0xFFFF
        n_valid = lengths[row] // 2 if lengths[row] > 0 else 0
        start, marks = 0, np.zeros(k, np.int64)
        for s in range(k):
            valid = s < n_valid
            count = (w[s] >> 10) + 1 if valid else 0
            biased = w[s] & 0x3FF
            if phase == "copyT":
                out[row, s] = _int16(w[s])
            elif phase == "unpack":
                out[row, s] = count + biased - 512 if valid else 0
            elif phase == "matmul":
                out[row, s] = _int16((start << 6) ^ biased) if valid else 0
            if start < k:
                marks[start] = biased + 1 if valid else 513
            start += count
        if phase == "dist":
            out[row] = marks
        elif phase == "full":
            pos = 0
            for s in range(min(n_valid, k)):
                for _ in range((w[s] >> 10) + 1):
                    if pos < k:
                        out[row, pos] = (w[s] & 0x3FF) - 512
                    pos += 1
    return out


def _plane(x: np.ndarray, bw: int) -> np.ndarray:
    n, k = x.shape
    return x.reshape(n // bw, bw, k).transpose(0, 2, 1)


# -- the copies ----------------------------------------------------------------


@pytest.mark.parametrize("rows,k,bw", [(1024, 64, 256), (96, 32, 8),
                                       (30, 24, 5), (7, 8, 7), (3, 136, 1)])
def test_copies_equal_the_probes_jnp_semantics(rows, k, bw):
    p_np = rx.stream_values(rows, k, np.random.default_rng(rows))
    p = torch.from_numpy(p_np)
    pj = jnp.asarray(p_np)
    bh = rows // bw
    np.testing.assert_array_equal(rx.copy_rm(p).numpy(), np.asarray(pj))
    if rows * k % 128 == 0:  # the probe's wide view
        wide = p.view(rows * k // 128, 128)
        np.testing.assert_array_equal(
            rx.copy_rm(wide).numpy(), np.asarray(pj.reshape(-1, 128)))
    np.testing.assert_array_equal(rx.copy_t_contig(p).numpy(),
                                  np.asarray(pj.T))
    np.testing.assert_array_equal(
        rx.copy_t_slab(p, bw).numpy(),
        np.asarray(jnp.transpose(pj.reshape(bh, bw, k), (0, 2, 1))))
    for fn, ref in ((rx.copy_rm, rx.copy_rm_ref),
                    (rx.copy_t_contig, rx.copy_t_contig_ref)):
        assert torch.equal(fn(p), ref(p))
    assert torch.equal(rx.copy_t_slab(p, bw), rx.copy_t_slab_ref(p, bw))


def test_copies_take_views_and_count_no_cpu_launch():
    base = torch.from_numpy(rx.stream_values(65, 16, np.random.default_rng(1)))
    view = base.flatten()[8:8 + 64 * 16].view(64, 16)  # starts mid-row
    counts = [f.launches for f in (rx.copy_rm, rx.copy_t_contig, rx.copy_t_slab)]
    assert torch.equal(rx.copy_rm(view), view)
    assert torch.equal(rx.copy_t_contig(view), view.t())
    assert torch.equal(rx.copy_t_slab(view, 16), view.view(4, 16, 16).transpose(1, 2))
    assert counts == [f.launches for f in
                      (rx.copy_rm, rx.copy_t_contig, rx.copy_t_slab)]


@pytest.mark.parametrize("shape,dtype", [((64,), torch.int16),
                                         ((2, 8, 8), torch.int16),
                                         ((16, 4), torch.int16),
                                         ((16, 12), torch.int16),
                                         ((16, 0), torch.int16),
                                         ((16, 64), torch.int32)])
def test_copies_refuse_other_shapes(shape, dtype):
    p = torch.zeros(shape, dtype=dtype)
    for fn in (rx.copy_rm, rx.copy_rm_ref, rx.copy_t_contig,
               rx.copy_t_contig_ref, lambda x: rx.copy_t_slab(x, 1),
               lambda x: rx.copy_t_slab_ref(x, 1)):
        with pytest.raises(ValueError):
            fn(p)


@pytest.mark.parametrize("bw", [0, 3, 17])
def test_slab_refuses_rows_off_bw(bw):
    p = torch.zeros((16, 8), dtype=torch.int16)
    for fn in (rx.copy_t_slab, rx.copy_t_slab_ref):
        with pytest.raises(ValueError):
            fn(p, bw)


# -- the phases -----------------------------------------------------------------


@pytest.mark.parametrize("k", [64, 32])
def test_full_phase_equals_the_jax_plane_decode(k):
    bw, bh = 128, 2  # the JAX plane kernel takes bw % 128 == 0
    words, lengths = _words(k, bh * bw, seed=k)
    ours = rx.expand_plane_phase(torch.from_numpy(words),
                                 torch.from_numpy(lengths), bw, "full")
    assert ours.dtype == torch.int16 and ours.shape == (bh, k, bw)
    pallas = np.asarray(rle_decode_packed16_pallas_plane(
        jnp.asarray(words.view(np.uint16)), bw, interpret=True))
    np.testing.assert_array_equal(ours.numpy(), pallas)
    spec = np.asarray(jax_decode(jnp.asarray(words.view(np.uint16)),
                                 jnp.asarray(lengths), k))
    np.testing.assert_array_equal(ours.numpy(), _plane(spec, bw))
    assert torch.equal(ours, pack16.pack16_decode_plane_ref(
        torch.from_numpy(words), torch.from_numpy(lengths), bw))


def _cases():
    """(label, words, lengths, bw): the probe's canonical words and crafted
    non-canonical rows (a valid word 0, lengths 0, odd, negative and
    oversized lengths, runs past K)."""
    for k in rx.PHASE_SEGMENTS:
        w, l = _words(k, 48, seed=3 * k)
        yield f"probe K {k}", w, l, 16
        w, l = crafted_packed16_rows(k, np.random.default_rng(k), n_random=52)
        yield f"crafted K {k}", w, l, 8


@pytest.mark.parametrize("phase", rx.PHASES)
def test_each_phase_equals_its_formula(phase):
    for label, w, l, bw in _cases():
        got = rx.expand_plane_phase(torch.from_numpy(w), torch.from_numpy(l),
                                    bw, phase)
        want = _plane(_numpy_phase(w, l, phase), bw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
        assert torch.equal(got, rx.expand_plane_phase_ref(
            torch.from_numpy(w), torch.from_numpy(l), bw, phase))


def test_full_phase_equals_k7_on_crafted_rows():
    for label, w, l, bw in _cases():
        wt, lt = torch.from_numpy(w), torch.from_numpy(l)
        got = rx.expand_plane_phase(wt, lt, bw, "full")
        assert torch.equal(got, pack16.pack16_decode_plane(wt, lt, bw)), label
        assert torch.equal(got, pack16.pack16_decode_plane_ref(wt, lt, bw)), label


@pytest.mark.parametrize("change", ["value", "count"])
def test_one_word_changes_every_phase_in_its_block(change):
    """The anti-elimination property: each phase's output depends on the
    words it unpacks, so a changed word shows in every phase's block."""
    words, lengths = _words(64, 32, seed=9)
    bw, block = 8, 13
    assert lengths[block] // 2 >= 2
    changed = words.copy()
    w = int(changed[block, 0]) & 0xFFFF
    w = w ^ 1 if change == "value" else (w + (1 << 10) if w >> 10 < 63
                                         else w - (1 << 10))
    changed[block, 0] = np.uint16(w).view(np.int16)
    for phase in rx.PHASES:
        a = rx.expand_plane_phase_ref(torch.from_numpy(words),
                                      torch.from_numpy(lengths), bw, phase)
        b = rx.expand_plane_phase_ref(torch.from_numpy(changed),
                                      torch.from_numpy(lengths), bw, phase)
        diff = (a != b).any(dim=1)  # (bh, bw): which blocks changed
        assert diff.nonzero().tolist() == [[block // bw, block % bw]], phase


@pytest.mark.parametrize("k,bw,phase", [(16, 8, "full"), (128, 8, "full"),
                                        (64, 7, "dist"), (64, 0, "copyT"),
                                        (32, 8, "decode")])
def test_phases_refuse_other_shapes(k, bw, phase):
    w = torch.zeros((16, k), dtype=torch.int16)
    lens = torch.zeros((16,), dtype=torch.int32)
    for fn in (rx.expand_plane_phase, rx.expand_plane_phase_ref):
        with pytest.raises(ValueError):
            fn(w, lens, bw, phase)


def test_phase_bytes_and_stream_bytes():
    n, k = 1_048_576, 64
    assert rx.phase_bytes(n, k) == 134_217_728 * 2 + 4_194_304
    assert round(timing.bytes_bound_ms(rx.phase_bytes(n, k)), 4) == 0.0814
    assert round(timing.bytes_bound_ms(rx.phase_bytes(524_288, 32)), 4) == 0.0207
    p = torch.zeros((n, k), dtype=torch.int16)
    assert round(timing.bytes_bound_ms(rx.stream_bytes(p)), 4) == 0.0801


def test_phase_ids_follow_the_probe_librarys_switch():
    """``ABLATED.index(phase)`` is the id ``expand16_probe_launch`` takes;
    the full phase is K7, not built in the probe library."""
    src = (REPO / "lz4jpeg_tpu_torch" / "csrc" /
           "expand16_probe_kernel.cu").read_text()
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<Phase, "
                       r"Phase::k(\w+)>", src)
    assert [(int(i), name.lower()) for i, name in cases] == [
        (i, p.lower()) for i, p in enumerate(rx.ABLATED)]
    assert rx.ABLATED == rx.PHASES[:-1] and rx.PHASES[-1] == "full"


def test_attributes_are_none_on_the_cpu():
    assert rx.phase_attributes("dist", 64, "cpu") == {
        "registers": None, "shared_bytes": None, "ctas_per_sm": None}
    assert rx.copy_attributes(rx.COPY_T, "cpu")["registers"] is None


# -- the einsum orientations ------------------------------------------------------


def test_einsum_orientations_agree_with_each_other_and_jnp():
    bh, bw = 64, 32
    rng = np.random.default_rng(0)
    z = rng.integers(-40, 40, size=(bh, 64, bw)).astype(np.float32)
    mi = rx.luma_inverse_basis()
    minv = jax_inverse_basis(
        8, 8, jax_table_key(np.asarray(LUMINANCE_QUANTIZATION_TABLE)))
    np.testing.assert_array_equal(
        mi.numpy(), np.asarray(minv.T.reshape(64, 8, 8), np.float32))
    kt = rx.inverse_einsum(torch.from_numpy(z), mi, "kt").numpy()
    rm = rx.inverse_einsum(torch.from_numpy(z.transpose(0, 2, 1).copy()), mi,
                           "rm").numpy()
    assert kt.shape == (8 * bh, 8 * bw) and kt.dtype == np.uint8
    pix = jnp.einsum("akb,kuv->aubv", jnp.asarray(z), jnp.asarray(mi.numpy()),
                     precision="highest") + 128.0
    r = jnp.sign(pix) * jnp.floor(jnp.abs(pix) + 0.5)
    want = np.asarray(jnp.clip(r, 0, 255).astype(jnp.uint8)
                      .reshape(8 * bh, 8 * bw))
    for a, b in ((kt, rm), (kt, want), (rm, want)):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 1 and (d != 0).mean() <= 1e-4


def test_einsum_turns_tf32_off_and_restores_it():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with timing.no_tf32():
            assert torch.backends.cuda.matmul.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- the runners and the port's imports ------------------------------------------


@pytest.mark.parametrize("module", [rle_expand_rm, rle_expand_ablate])
def test_runners_on_the_cpu_write_only_their_output(module, tmp_path,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert module.main(["--device", "cpu", "--frames", "1", "--side", "64",
                        "--runs", "1", "--reps", "1", "--output", "a.json"]) == 0
    assert os.listdir(tmp_path) == ["a.json"]
    art = json.loads((tmp_path / "a.json").read_text())
    assert art["device"] == "cpu" and "card" not in art
    assert art["timer"] == "host clock" and art["verdict"].startswith("on cpu:")
    if module is rle_expand_rm:
        assert [r["site"] for r in art["copies"]] == [
            f"profile_rle_expand_rm.py:{line}" for line in (64, 95, 67, 72)]
        assert all(r["host_ms"] > 0 and r["share"] is None
                   for r in art["copies"])
        assert art["einsum"]["agree"] and art["einsum"]["shape"] == [8, 64, 8]
    else:
        assert set(art["channels"]) == {"lum", "chr"}
        lum, chr_ = art["channels"]["lum"], art["channels"]["chr"]
        assert (lum["rows"], lum["K"], lum["bw"]) == (64, 64, 8)
        assert (chr_["rows"], chr_["K"], chr_["bw"]) == (32, 32, 4)
        assert [p["phase"] for p in lum["phases"]] == list(rx.PHASES)
        assert "copy_t_slab_host_ms" in lum["phases"][0]
        assert all("copy_t_slab_host_ms" not in p for p in lum["phases"][1:])


def test_new_modules_import_no_jax():
    for name in ("rle_expand", "rle_expand_rm", "rle_expand_ablate"):
        path = REPO / "lz4jpeg_tpu_torch" / "profiles" / f"{name}.py"
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "lz4jpeg_tpu", "profiles")
