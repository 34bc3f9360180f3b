"""The port's kernel candidates (``lz4jpeg_tpu_torch/profiles/``) on the CPU,
held against the JAX package's Pallas candidates in interpret mode.

``profiles/pallas_mcu.py`` and ``profiles/pallas_rle.py`` are loaded by file
path, as ``tests/test_pallas_candidates.py`` loads them, and run with
``interpret=True``; the plane colour merge is held against
``lz4jpeg_tpu.ops.color.ycbcr_planes_to_rgb`` with ``chroma_upsampled=False``
(the 4:2:2 repeat inside), as the TPU probe checked itself.  On a CPU tensor
each wrapper runs its plain torch version.

Tolerances.  Forward MCU transform, RLE and colour merge: none (the forward
snaps ratios within 1e-5 of an integer before truncating, so the two float32
products agree).  Inverse MCU transform: XLA's CPU dot and torch's sum the
64 (or 32) products in other orders, so a pixel may land one step apart at a
round-half tie; ``utils/parity.py::transform_flips`` admits exactly those
and the count must stay at most 1e-5 of the pixels (0 on these inputs).
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.ops.color import ycbcr_planes_to_rgb as jax_planes_to_rgb
from lz4jpeg_tpu.ops.fused import fused_forward_jnp

from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    forward_basis,
    fused_forward,
    fused_inverse,
    inverse_basis,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.profiles import mcu, plane_color, rle
from lz4jpeg_tpu_torch.profiles.candidates_ab import run_candidates_ab
from lz4jpeg_tpu_torch.utils.inputs import crafted_rle_rows
from lz4jpeg_tpu_torch.utils.parity import transform_flips

_PROFILES = os.path.join(os.path.dirname(os.path.dirname(__file__)), "profiles")
MAX_FLIP_SHARE = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_PROFILES, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


pallas_mcu = _load("pallas_mcu")
pallas_rle = _load("pallas_rle")


def _table(w):
    return LUM if w == 8 else CHR


def _tiles(rng, n, w):
    return rng.integers(0, 256, size=(n, 8, w), dtype=np.uint8)


# ---------------------------------------------------------------------------
# MCU transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(8, 8), (4, 8)])
@pytest.mark.parametrize("n", [700, 5])
def test_mcu_forward_matches_pallas(rng, w, h, n):
    tiles = _tiles(rng, n, w)
    ours = mcu.fused_forward_candidate(torch.from_numpy(tiles), _table(w), w, h)
    theirs = pallas_mcu.fused_forward_pallas(
        jnp.asarray(tiles), _table(w), w, h, interpret=True)
    assert ours.dtype == torch.float32 and ours.shape == (n, w * h)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("w,h", [(8, 8), (4, 8)])
@pytest.mark.parametrize("n", [700, 5])
def test_mcu_inverse_matches_pallas(rng, w, h, n):
    tiles = _tiles(rng, n, w)
    zz = np.array(fused_forward_jnp(jnp.asarray(tiles), _table(w), w, h,
                                    jnp.float32))
    ours = mcu.fused_inverse_candidate(torch.from_numpy(zz), _table(w), w, h)
    theirs = torch.from_numpy(np.asarray(pallas_mcu.fused_inverse_pallas(
        jnp.asarray(zz), _table(w), w, h, interpret=True)))
    assert ours.dtype == torch.uint8 and ours.shape == (n, h, w)
    flips = transform_flips("inverse", torch.from_numpy(zz), ours, theirs,
                            _table(w), w, h)
    assert flips <= MAX_FLIP_SHARE * ours.numel()


@pytest.mark.parametrize("w", [8, 4])
def test_mcu_plain_versions_are_the_shipped_ops(rng, w):
    """The plain versions compute ``ops/fused.py``'s float32 transforms; the
    snap threshold is the forward's one knob."""
    x = torch.from_numpy(_tiles(rng, 300, w))
    zz = fused_forward(x, _table(w), w, 8)
    assert torch.equal(mcu.fused_forward_candidate_ref(x, _table(w), w, 8), zz)
    assert torch.equal(mcu.fused_inverse_candidate(zz, _table(w), w, 8),
                       fused_inverse(zz, _table(w), w, 8))
    assert torch.equal(mcu.fused_inverse_candidate(zz.to(torch.int16),
                                                   _table(w), w, 8),
                       fused_inverse(zz, _table(w), w, 8))
    loose = mcu.fused_forward_candidate(x, _table(w), w, 8, snap_eps=0.5)
    assert torch.equal(loose, torch.round(loose))


@pytest.mark.parametrize("w", [8, 4])
def test_mcu_kernel_operands_are_row_major_bases(w):
    """The kernels read their basis as raw row-major memory: row k of the
    forward's M, row p of the inverse's Minv (``inverse_basis`` itself is
    Fortran-ordered in numpy)."""
    key = _table_key(_table(w))
    _, m, off = mcu._forward_basis_on(w, 8, key, torch.device("cpu"))
    _, minv = mcu._inverse_basis_on(w, 8, key, torch.device("cpu"))
    fwd, fwd_off = forward_basis(w, 8, key)
    for got, want in ((m, fwd), (minv, inverse_basis(w, 8, key)),
                      (off, fwd_off)):
        assert got.is_contiguous() and got.dtype == torch.float32
        flat = np.frombuffer(got.numpy().tobytes(), np.float32)
        np.testing.assert_array_equal(flat, want.astype(np.float32).ravel())


@pytest.mark.parametrize("call,bad", [
    ("forward", torch.zeros((3, 8, 8), dtype=torch.int32)),    # dtype
    ("forward", torch.zeros((3, 8, 4), dtype=torch.uint8)),    # shape
    ("forward", torch.zeros((3, 64), dtype=torch.uint8)),      # rank
    ("forward", torch.zeros((3, 8, 8), dtype=torch.uint8, device="meta")),
    ("inverse", torch.zeros((3, 32))),                          # width
    ("inverse", torch.zeros((3, 8, 8))),                        # rank
    ("inverse", torch.zeros((3, 64), device="meta")),           # device
])
def test_mcu_wrappers_check_their_input(call, bad):
    fn = (mcu.fused_forward_candidate if call == "forward"
          else mcu.fused_inverse_candidate)
    with pytest.raises((TypeError, ValueError)):
        fn(bad, LUM, 8, 8)
    with pytest.raises(ValueError):
        fn(bad, LUM, 8, 4)  # no such tile


# ---------------------------------------------------------------------------
# RLE compaction
# ---------------------------------------------------------------------------


def _assert_rle_equal(x):
    ours_p, ours_l = rle.rle_encode_candidate(torch.from_numpy(x))
    ref_p, ref_l = pallas_rle.rle_encode_pallas(jnp.asarray(x), interpret=True)
    assert ours_p.dtype == torch.int16 and ours_l.dtype == torch.int32
    np.testing.assert_array_equal(ours_p.numpy().astype(np.int32),
                                  np.asarray(ref_p, np.int32))
    np.testing.assert_array_equal(ours_l.numpy(), np.asarray(ref_l))


@pytest.mark.parametrize("length", [32, 64])
def test_rle_matches_pallas(rng, length):
    # Run-heavy rows plus the all-equal and all-distinct extremes.
    x = rng.integers(-3, 4, size=(300, length)).astype(np.int16)
    x[0] = 0
    x[1] = np.arange(length) - length // 2
    _assert_rle_equal(x)


@pytest.mark.parametrize("length", [32, 64])
def test_rle_matches_pallas_on_crafted_rows(rng, length):
    """All equal, all distinct, the int16 limits alternating, all -32768,
    then runny rows with any int16 value."""
    _assert_rle_equal(crafted_rle_rows(200, length, rng))


def test_rle_pad_tail_matches_pallas(rng):
    # 5 rows of 32: the Pallas candidate pads to whole 128-lane rows.
    _assert_rle_equal(rng.integers(-2, 3, size=(5, 32)).astype(np.int16))


@pytest.mark.parametrize("length", [1, 2, 8, 128])
def test_rle_other_segments_match_pallas(rng, length):
    _assert_rle_equal(crafted_rle_rows(37, length, rng))


@pytest.mark.parametrize("length", [48, 256])
def test_rle_rejects_other_lengths_on_both_sides(length):
    x = np.zeros((4, length), np.int16)
    with pytest.raises(ValueError):
        rle.rle_encode_candidate(torch.from_numpy(x))
    with pytest.raises(ValueError):
        pallas_rle.rle_encode_pallas(jnp.asarray(x), interpret=True)


def test_rle_takes_int32_and_checks_its_input(rng):
    x = crafted_rle_rows(50, 64, rng)
    a = rle.rle_encode_candidate(torch.from_numpy(x))
    b = rle.rle_encode_candidate(torch.from_numpy(x.astype(np.int32)))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(TypeError):
        rle.rle_encode_candidate(torch.zeros((2, 64), dtype=torch.float32))
    with pytest.raises(ValueError):
        rle.rle_encode_candidate(torch.zeros((64,), dtype=torch.int16))


# ---------------------------------------------------------------------------
# Plane colour merge
# ---------------------------------------------------------------------------


def _assert_color_equal(y, cr, cb):
    n, w = y.shape
    ours = plane_color.plane_color(*(torch.from_numpy(a) for a in (y, cr, cb)))
    theirs = np.asarray(jax_planes_to_rgb(
        jnp.asarray(y), jnp.asarray(cr), jnp.asarray(cb), n, w))
    assert len(ours) == 3
    for c, plane in enumerate(ours):
        assert plane.dtype == torch.uint8 and plane.shape == (n, w)
        np.testing.assert_array_equal(plane.numpy(), theirs[..., c])


@pytest.mark.parametrize("n,w", [(64, 128), (7, 2), (3, 130)])
def test_plane_color_matches_jax(rng, n, w):
    y = rng.integers(0, 256, size=(n, w), dtype=np.uint8)
    cr, cb = (rng.integers(0, 256, size=(n, w // 2), dtype=np.uint8)
              for _ in range(2))
    _assert_color_equal(y, cr, cb)


@pytest.mark.parametrize("luma", [0, 255, "random"])
def test_plane_color_every_chroma_pair_matches_jax(rng, luma):
    """Every (Cr, Cb) pair once, under luma 0, 255 and random: the fp32
    products and truncations agree on all of them, and the clamps meet
    both ends."""
    cr = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 256, axis=1)
    cb = cr.T.copy()
    if luma == "random":
        y = rng.integers(0, 256, size=(256, 512), dtype=np.uint8)
    else:
        y = np.full((256, 512), luma, np.uint8)
    _assert_color_equal(y, cr, cb)


@pytest.mark.parametrize("shapes", [
    ((4, 7), (4, 3), (4, 3)),     # odd width
    ((4, 8), (4, 3), (4, 4)),     # chroma too narrow
    ((4, 8), (3, 4), (4, 4)),     # rows differ
    ((8,), (4,), (4,)),           # rank
])
def test_plane_color_checks_its_input(shapes):
    planes = [torch.zeros(s, dtype=torch.uint8) for s in shapes]
    with pytest.raises(ValueError):
        plane_color.plane_color(*planes)
    with pytest.raises(TypeError):
        plane_color.plane_color(torch.zeros((4, 8), dtype=torch.int16),
                                torch.zeros((4, 4), dtype=torch.uint8),
                                torch.zeros((4, 4), dtype=torch.uint8))


# ---------------------------------------------------------------------------
# The flip rule
# ---------------------------------------------------------------------------


def test_transform_flips_admits_only_ties(rng):
    tiles = torch.from_numpy(_tiles(rng, 50, 8))
    zz = fused_forward(tiles, LUM, 8, 8)
    assert transform_flips("forward", tiles, zz, zz.clone(), LUM, 8, 8) == 0
    bumped = zz.clone()
    bumped[3, 10] += 1  # a ratio of noise pixels is no integer
    with pytest.raises(AssertionError, match="not at a tie"):
        transform_flips("forward", tiles, bumped, zz, LUM, 8, 8)
    flat = torch.full((1, 8, 8), 128, dtype=torch.uint8)  # every AC ratio 0
    zf = fused_forward(flat, LUM, 8, 8)
    tie = zf.clone()
    tie[0, 5] = 1.0
    assert transform_flips("forward", flat, tie, zf, LUM, 8, 8) == 1
    tie[0, 6] = 2.0
    with pytest.raises(AssertionError, match="differs by 2"):
        transform_flips("forward", flat, tie, zf, LUM, 8, 8)
    pix = fused_inverse(zz, LUM, 8, 8)
    off = pix.clone()
    off[0, 0, 0] ^= 1
    with pytest.raises(AssertionError):
        transform_flips("inverse", zz, off, pix, LUM, 8, 8)
    with pytest.raises(ValueError):
        transform_flips("sideways", zz, pix, pix, LUM, 8, 8)


# ---------------------------------------------------------------------------
# The A/Bs
# ---------------------------------------------------------------------------


def test_candidates_ab_on_the_cpu(tmp_path):
    out = tmp_path / "ab.json"
    res = run_candidates_ab(n_blocks=4096, chain=2, runs=1, device="cpu",
                            output=str(out))
    assert json.loads(out.read_text()) == res
    assert res["device"] == "cpu" and res["backend"] == "cpu"
    assert "card" not in res
    assert res["gates"] == {"fused_forward_flips": 0, "fused_inverse_flips": 0,
                            "rle_encode": "identical"}
    assert set(res["ops"]) == {"fused_forward", "fused_inverse", "rle_encode"}
    assert set(res["ops"]["rle_encode"]) == {"torch_sort_s", "kernel_s",
                                             "fence_floor_s", "speedup"}
    for op in res["ops"].values():
        assert all(v > 0 for v in op.values())
    assert res["verdict"].startswith("on cpu:")


def test_plane_color_ab_on_the_cpu(tmp_path):
    out = tmp_path / "pc.json"
    res = plane_color.run_plane_color_ab(size=64, batch=2, runs=1,
                                         device="cpu", output=str(out))
    assert json.loads(out.read_text()) == res
    assert res["device"] == "cpu" and "card" not in res
    assert res["exact_rows"] == 128
    op = res["ops"]["plane_color"]
    assert op["kernel_planar_s"] > 0 and op["torch_interleaved_s"] > 0
    assert op["bytes"] == 5 * 128 * 64


def test_abs_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_candidates_ab(n_blocks=64, chain=1, runs=1, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        plane_color.run_plane_color_ab(size=16, batch=1, runs=1, device="cuda")


def test_ab_modules_run_as_main(tmp_path):
    """``python -m lz4jpeg_tpu_torch.profiles.…`` on the CPU, in-process."""
    from lz4jpeg_tpu_torch.profiles import candidates_ab

    a, b = tmp_path / "a.json", tmp_path / "b.json"
    assert candidates_ab.main(["--n-blocks", "256", "--chain", "1", "--runs",
                               "1", "--device", "cpu", "--output", str(a)]) == 0
    assert plane_color.main(["--size", "16", "--batch", "1", "--runs", "1",
                             "--device", "cpu", "--output", str(b)]) == 0
    assert json.loads(a.read_text())["n_blocks"] == 256
    assert json.loads(b.read_text())["size"] == 16
