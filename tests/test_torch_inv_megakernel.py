"""The inverse megakernel's module (K9, ``ops/inv_megakernel.py``) on the CPU.

``inverse_combined`` on a CPU tensor runs its plain version, the torch chain
the sparse16 decode ran before K9 existed: it must equal that chain (un-bias,
``fused_inverse_plane_sparse`` per channel, ``ycbcr_planes_to_rgb``) bit for
bit, and stay within the fast path's envelope (max |Δ| ≤ 3 on ≤ 2e-3 of
pixels) of the JAX pipeline's ``_inverse_sparse_impl`` on JAX's own combined
buffers.  The kernel's basis operand must be exactly the float32 basis the
chain casts; its work map (``inverse_plan``, ``inverse_stores``) must write
every output byte once and nothing past the image.  The flip rule of
``utils/parity.py::decode_flips`` admits a pixel whose plane value lies
within the float32 error of two summation orders of a half-integer, one
step the other way, and refuses a two-step or an off-tie difference.  Words
no container can hold (-32768, 32767) are held to a float64 decode under
that rule (the JAX package narrows such deltas to int16 and wraps; the port
does not).  Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.models import jpeg as jpeg_model
from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    fused_inverse_plane_sparse,
    inverse_suffix_basis,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES
from lz4jpeg_tpu_torch.parallel import jpeg as pjpeg
from lz4jpeg_tpu_torch.parallel.mesh import CodecMesh
from lz4jpeg_tpu_torch.utils.parity import (
    decode_flips,
    merge_rgb,
    transform_flips,
)

SHAPES = [(64, 64), (37, 53), (40, 24), (8, 8), (1, 1)]
BATCH = 3
CRAFTED_WORDS = (0, 1024, -512, -32768, 32767)


def _frames(b, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3),
                                                dtype=np.uint8)


def _combined(rgb, quality=None):
    """The port's (B, N, 128) int16 combined buffer of a batch (the plain
    forward on the CPU)."""
    pipe = JPEGPipeline(JPEGConfig(quality=quality), "cpu")
    x = torch.from_numpy(rgb)
    comb = pipe._forward_rle(x)
    return comb.reshape(rgb.shape[0], -1, 128), pipe


def _blocks(h, w):
    return -(-h // 8), -(-w // 8)


def _old_chain(combined, tables, bpc, bpr, h, w):
    """The sparse16 decode as ``JPEGPipeline._inverse_sparse`` ran it before
    K9: un-bias to int32, per channel the folded einsum, the merge."""
    b = combined.shape[0]
    d = combined.to(torch.int32)
    d = torch.where(d != 0, d - 1024, 0)
    planes = {}
    for name, tw in (("lum", 8), ("r", 4), ("b", 4)):
        d_kt = d[..., CHANNEL_SLICES[name]].reshape(b * bpc, bpr, 8 * tw)
        planes[name] = fused_inverse_plane_sparse(
            d_kt.transpose(1, 2), tables[name], tw,
            upsample_cols=(name != "lum")).reshape(b, 8 * bpc, 8 * bpr)
    return ycbcr_planes_to_rgb(planes["lum"], planes["r"], planes["b"], h, w)


def _envelope(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()), float((diff != 0).mean())


@pytest.mark.parametrize("quality", [None, 75])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_the_old_chain(shape, quality):
    h, w = shape
    rgb = _frames(BATCH, h, w, seed=h * w + 1)
    comb, pipe = _combined(rgb, quality)
    bpc, bpr = _blocks(h, w)
    got = inv.inverse_combined(comb, pipe._tables, bpc, bpr, h, w)
    want = _old_chain(comb, pipe._tables, bpc, bpr, h, w)
    assert got.shape == (BATCH, h, w, 3) and got.dtype == torch.uint8
    assert torch.equal(got, want)
    # and the pipeline's decode entry is that function
    assert torch.equal(pipe._inverse_sparse(comb, bpc, bpr, h, w), want)


@pytest.mark.parametrize("quality", [50, 75])
@pytest.mark.parametrize("shape", SHAPES)
def test_within_the_envelope_of_jax(shape, quality):
    """JAX's own combined buffers through JAX's ``_inverse_sparse_impl`` and
    through the port: max |Δ| ≤ 3 on ≤ 2e-3 of pixels."""
    h, w = shape
    rgb = _frames(BATCH, h, w, seed=3 * h + w)
    jpipe = JaxJPEGPipeline(JaxJPEGConfig(quality=quality))
    comb = np.stack([np.asarray(jpipe._forward_rle(jnp.asarray(f)))
                     for f in rgb]).view(np.int16)
    bpc, bpr = _blocks(h, w)
    want = np.asarray(jpipe._batch_inverse_sparse(jnp.asarray(comb), bpc, bpr,
                                                  h, w))
    got = inv.inverse_combined(torch.from_numpy(comb),
                               scaled_tables(quality), bpc, bpr, h, w).numpy()
    assert got.shape == want.shape == (BATCH, h, w, 3)
    worst, share = _envelope(got, want)
    assert worst <= 3 and share <= 2e-3, (worst, share)


@pytest.mark.parametrize("quality", [None, 75])
def test_device_bases_are_the_chains_float32_basis(quality):
    """``_device_bases`` holds exactly the float32 values ``_plane_product``
    casts, de-duplicated (its chroma basis repeats each column)."""
    tables = scaled_tables(quality)
    keys = inv.table_keys(tables)
    flat = inv._device_bases(keys, torch.device("cpu")).numpy()
    assert flat.dtype == np.float32 and flat.shape == (64 * 64 + 2 * 32 * 32,)
    at = 0
    for name, width in (("lum", 8), ("r", 4), ("b", 4)):
        m2 = inverse_suffix_basis(width, 8, _table_key(tables[name]))
        mi = m2.T.reshape(-1, 8, width)  # _plane_product's (K, 8, width)
        if name != "lum":
            mi = np.repeat(mi, 2, axis=2)[:, :, ::2]
        cast = mi.astype(np.float32)  # what _plane_product uploads
        k = 8 * width
        got = flat[at:at + k * k].reshape(k, k)  # [pixel][term]
        assert np.array_equal(got, cast.reshape(k, k).T)
        assert np.array_equal(got, inv.basis_arrays(keys)[name])
        at += k * k
    assert inv._device_bases(keys, torch.device("cpu")) is inv._device_bases(
        keys, torch.device("cpu"))


PLAN_CASES = [(BATCH, h, w, 0) for h, w in SHAPES] + [
    (2, 512, 1040, 0), (4, 48, 528, 0), (BATCH, 64, 64, 5), (1, 16, 2048, 0),
    (2, 37, 1040, 3),
]


@pytest.mark.parametrize("b, h, w, out_offset", PLAN_CASES)
def test_plan_writes_every_byte_once(b, h, w, out_offset):
    bpc, bpr = _blocks(h, w)
    plan = inv.inverse_plan(b, bpc, bpr, h, w, out_offset=out_offset,
                            resident=264)
    assert plan.units == b * bpc * -(-bpr // inv.UNIT_TILES)
    assert plan.chunks == -(-plan.units // inv.WARPS)
    assert plan.ctas == min(plan.chunks, 264) and plan.tiles == inv.UNIT_TILES
    assert plan.vec_out == (out_offset == 0 and (3 * w) % 16 == 0)
    stores = inv.inverse_stores(plan, bpc, bpr, h, w)
    hits = np.zeros(b * h * w * 3, np.int64)
    for start, n_vec, n_bytes in zip(stores["start"], stores["n_vec"],
                                     stores["n_bytes"]):
        if n_vec:
            assert (out_offset + start) % 16 == 0  # whole aligned vectors
        end = start + 16 * n_vec + n_bytes
        assert 0 <= start < end <= hits.size
        hits[start:end] += 1
    assert (hits == 1).all()
    # a store covers the tiles its unit holds, and no more than its row
    assert (stores["tiles"] >= 1).all() and (stores["tiles"] <= 16).all()
    assert (16 * stores["n_vec"] + stores["n_bytes"]
            <= 24 * stores["tiles"]).all()
    if not plan.vec_out:
        assert not stores["n_vec"].any()


def test_plan_refuses_a_shape_outside_its_blocks():
    with pytest.raises(ValueError):
        inv.inverse_plan(1, 2, 2, 17, 16)
    with pytest.raises(ValueError):
        inv.inverse_plan(1, 2, 2, 16, 17)


def test_refusals_on_the_cpu():
    comb = torch.zeros((1, 4, 128), dtype=torch.int16)
    tables = scaled_tables(None)
    with pytest.raises(TypeError):
        inv.inverse_combined(comb.to(torch.int32), tables, 2, 2, 16, 16)
    with pytest.raises(ValueError):  # N is not bpc · bpr
        inv.inverse_combined(comb, tables, 2, 3, 16, 16)
    with pytest.raises(ValueError):  # the image is larger than the blocks
        inv.inverse_combined(comb, tables, 2, 2, 17, 16)
    with pytest.raises(ValueError):
        inv.inverse_combined(comb[:, :, :64], tables, 2, 2, 16, 16)
    with pytest.raises(ValueError):  # not contiguous
        inv.inverse_combined(comb.transpose(0, 1), tables, 2, 2, 16, 16)
    assert inv.inverse_combined(comb[:0], tables, 2, 2, 16, 16).shape == (
        0, 16, 16, 3)


def _counted(monkeypatch):
    calls = []
    real = jpeg_model.inverse_combined

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(jpeg_model, "inverse_combined", counted)
    return calls


def test_decode_batch_goes_through_inverse_combined(monkeypatch):
    rgb = _frames(2, 40, 24, seed=11)
    pipe = JPEGPipeline(JPEGConfig(), "cpu")
    encs = pipe.encode_batch(rgb)
    calls = _counted(monkeypatch)
    out = pipe.decode_batch(encs)
    assert calls == [(2, 15, 128)]
    comb = torch.from_numpy(np.stack([e.rle_combined for e in encs])
                            .view(np.int16))
    want = _old_chain(comb, pipe._tables, 5, 3, 40, 24).numpy()
    assert np.array_equal(np.stack(out), want)


def test_sharded_inverse_goes_through_inverse_combined(monkeypatch):
    shards = 2
    mesh = CodecMesh((torch.device("cpu"),) * shards)
    sharded = pjpeg.ShardedSparseJPEG(mesh)
    img = _frames(1, 64, 48, seed=12)[0]
    comb = sharded.forward(img)
    calls = _counted(monkeypatch)
    got = sharded.inverse(comb, 8, 6, 64, 48)
    assert len(calls) == shards and all(c == (1, 24, 128) for c in calls)
    want = _old_chain(torch.from_numpy(comb.view(np.int16)[None]),
                      sharded.pipeline._tables, 8, 6, 64, 48)[0].numpy()
    assert np.array_equal(got, want)


def test_merge_rgb_is_the_torch_merge_on_every_pair():
    cr, cb = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 77, 128, 255):
        yy = np.full_like(cr, y)
        want = ycbcr_planes_to_rgb(
            torch.from_numpy(yy.astype(np.uint8)),
            torch.from_numpy(cr.astype(np.uint8)),
            torch.from_numpy(cb.astype(np.uint8)), 256, 256).numpy()
        assert np.array_equal(merge_rgb(yy, cr, cb), want)


def _plane_values(comb, tables, frame, row, col, bpr):
    """Float64 Y, Cr, Cb (before the round) of one pixel, on the float32
    bases, and the chroma windows' terms."""
    words = comb[frame, (row // 8) * bpr + col // 8].astype(np.int64)
    delta = np.where(words != 0, words - 1024, 0).astype(np.float64)
    bases = inv.basis_arrays(inv.table_keys(tables))
    u, v = row % 8, col % 8
    out = {}
    for name, p in (("lum", 8 * u + v), ("r", 4 * u + v // 2),
                    ("b", 4 * u + v // 2)):
        terms = delta[CHANNEL_SLICES[name]] * bases[name][p].astype(np.float64)
        x = terms.sum() + 128.0
        window = 2.0**-24 * (2 * terms.size * np.abs(terms).sum()
                             + 2 * abs(x))
        out[name] = (x, window)
    return out


def _round(x):
    return float(np.clip(np.sign(x) * np.floor(abs(x) + 0.5), 0, 255))


def _tie_pixel(comb, tables, bpc, bpr, h, w, near_tie):
    """A pixel whose luma value is (or, with ``near_tie`` False, is not)
    within its window of a half-integer while its chroma values are not, and
    whose RGB moves when its luma moves one step."""
    for frame in range(comb.shape[0]):
        for row in range(h):
            for col in range(w):
                vals = _plane_values(comb, tables, frame, row, col, bpr)
                near = {k: abs(x - np.floor(x) - 0.5) <= win
                        for k, (x, win) in vals.items()}
                x = vals["lum"][0]
                if near["lum"] != near_tie or near["r"] or near["b"]:
                    continue
                if not 2 <= x <= 253:
                    continue
                y = _round(x)
                other = np.floor(x) if y == np.floor(x) + 1 else np.floor(x) + 1
                cr, cb = _round(vals["r"][0]), _round(vals["b"][0])
                if not np.array_equal(merge_rgb(y, cr, cb),
                                      merge_rgb(other, cr, cb)):
                    return frame, row, col, y, other, cr, cb
    raise AssertionError("no such pixel in the input")


@pytest.fixture(scope="module")
def tie_input():
    """Deltas drawn so that the products' sums are large: their float32
    windows (~1e-3 wide) catch a few plane values near a half-integer."""
    rng = np.random.default_rng(21)
    h, w = 64, 64
    bpc, bpr = _blocks(h, w)
    words = rng.integers(-400, 400, size=(1, bpc * bpr, 128)) + 1024
    words[rng.random(words.shape) < 0.3] = 0
    comb = words.astype(np.int16)
    tables = scaled_tables(None)
    want = inv.inverse_combined(torch.from_numpy(comb), tables, bpc, bpr, h,
                                w).numpy()
    return comb, tables, bpc, bpr, h, w, want


def test_decode_flips_admits_a_one_step_tie(tie_input):
    comb, tables, bpc, bpr, h, w, want = tie_input
    frame, row, col, y, other, cr, cb = _tie_pixel(comb, tables, bpc, bpr, h,
                                                   w, near_tie=True)
    assert np.array_equal(want[frame, row, col], merge_rgb(y, cr, cb))
    got = want.copy()
    got[frame, row, col] = merge_rgb(other, cr, cb)
    assert decode_flips(comb, got, want, tables, bpc, bpr) == 1
    assert decode_flips(torch.from_numpy(comb), torch.from_numpy(want),
                        torch.from_numpy(got), tables, bpc, bpr) == 1
    assert decode_flips(comb, want, want, tables, bpc, bpr) == 0


def test_decode_flips_refuses_two_steps_and_off_ties(tie_input):
    comb, tables, bpc, bpr, h, w, want = tie_input
    frame, row, col, y, other, cr, cb = _tie_pixel(comb, tables, bpc, bpr, h,
                                                   w, near_tie=True)
    got = want.copy()
    got[frame, row, col] = merge_rgb(2 * other - y, cr, cb)  # two steps
    if not np.array_equal(got[frame, row, col], want[frame, row, col]):
        with pytest.raises(AssertionError, match="no admissible plane flip"):
            decode_flips(comb, got, want, tables, bpc, bpr)
    frame, row, col, y, other, cr, cb = _tie_pixel(comb, tables, bpc, bpr, h,
                                                   w, near_tie=False)
    got = want.copy()
    got[frame, row, col] = merge_rgb(other, cr, cb)  # one step, off a tie
    with pytest.raises(AssertionError, match="no admissible plane flip"):
        decode_flips(comb, got, want, tables, bpc, bpr)
    got = want.copy()
    got[0, 0, 0] = (got[0, 0, 0].astype(np.int32) + 7) % 256  # no flip at all
    with pytest.raises(AssertionError):
        decode_flips(comb, got, want, tables, bpc, bpr)


def test_transform_flips_takes_the_suffix_basis(tie_input):
    """``transform_flips("inverse", basis=S)`` on the deltas of one luma
    plane: the same tie admitted, a two-step difference refused."""
    comb, tables, bpc, bpr, h, w, want = tie_input
    frame, row, col, y, other, _, _ = _tie_pixel(comb, tables, bpc, bpr, h,
                                                 w, near_tie=True)
    words = comb[frame].astype(np.int64)[:, :64]
    delta = torch.from_numpy(np.where(words != 0, words - 1024, 0))
    basis = inv.basis_arrays(inv.table_keys(tables))["lum"]
    # the luma plane as (tiles, 8, 8) pixels, from the plain product
    d_kt = delta.to(torch.int32).reshape(bpc, bpr, 64).transpose(1, 2)
    plane = fused_inverse_plane_sparse(d_kt, tables["lum"], 8).reshape(
        bpc, 8, bpr, 8).transpose(1, 2).reshape(-1, 8, 8)
    tile, u, v = (row // 8) * bpr + col // 8, row % 8, col % 8
    assert plane[tile, u, v] == y
    got = plane.clone()
    got[tile, u, v] = int(other)
    assert transform_flips("inverse", delta, got, plane, tables["lum"], 8, 8,
                           basis=basis) == 1
    got[tile, u, v] = int(2 * other - y)
    with pytest.raises(AssertionError, match="not a sum-order flip"):
        transform_flips("inverse", delta, got, plane, tables["lum"], 8, 8,
                        basis=basis)


def _decode64(comb, tables, bpc, bpr, h, w):
    """The decode in float64 (no float32 rounding), round and merge as the
    plain version: the yardstick of the crafted words."""
    b = comb.shape[0]
    words = comb.astype(np.int64).reshape(b, bpc, bpr, 128)
    delta = np.where(words != 0, words - 1024, 0).astype(np.float64)
    bases = inv.basis_arrays(inv.table_keys(tables))
    planes = {}
    for name, width in (("lum", 8), ("r", 4), ("b", 4)):
        s = bases[name].astype(np.float64)  # [8u + c][m]
        x = np.einsum("abtm,pm->abtp", delta[..., CHANNEL_SLICES[name]], s)
        x = np.clip(np.sign(x + 128) * np.floor(np.abs(x + 128) + 0.5), 0, 255)
        x = x.reshape(b, bpc, bpr, 8, width)
        if width == 4:
            x = np.repeat(x, 2, axis=-1)
        planes[name] = x.transpose(0, 1, 3, 2, 4).reshape(b, 8 * bpc, 8 * bpr)
    rgb = merge_rgb(planes["lum"], planes["r"], planes["b"])
    return rgb[:, :h, :w]


@pytest.mark.parametrize("word", CRAFTED_WORDS)
def test_crafted_words_against_a_float64_decode(word):
    """Every lane of every tile set to ``word`` (and a mix of all five):
    the plain version within the flip rule of the float64 decode."""
    tables = scaled_tables(None)
    h, w = 24, 40
    bpc, bpr = _blocks(h, w)
    comb = np.full((2, bpc * bpr, 128), word, np.int16)
    rng = np.random.default_rng(5)
    comb[1] = rng.choice(np.array(CRAFTED_WORDS, np.int16),
                         size=comb[1].shape)
    got = inv.inverse_combined(torch.from_numpy(comb), tables, bpc, bpr, h,
                               w).numpy()
    want = _decode64(comb, tables, bpc, bpr, h, w)
    decode_flips(comb, got, want, tables, bpc, bpr)
