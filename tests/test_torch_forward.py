"""The port's forward path on the CPU, held against the JAX package.

``forward_combined`` on a CPU tensor runs the plain torch version of the
Hopper kernel.  Its (N, 128) buffer must be bit-identical to the JAX
pipeline's ``_forward_rle_impl`` (the XLA tile chain) for aligned and
ragged shapes, and to the Pallas megakernel run in interpret mode on the
8-aligned ones.  Tolerance: none.  On this CPU both packages sum the basis
product in the same order, so no sum-order flip is admitted here; the
flip rule (``utils/parity.py``) applies only between the kernel and
cuBLAS on the card.

The Hopper kernel's split product is emulated here too: centred samples
(v - 128, exact in bf16) times the three bf16 parts of ``split_basis``, in
the kernel's two float32 chains (lo then mid in one, hi in the other,
added once at the end), chroma at depth 32 (the odd-column samples against
the plain chroma basis).  That sums in another order than the reference,
so it is held to the card's rule: only admissible sum-order flips, at most
1e-5 of the coefficients.  It checks the split, the centring and the two
chains; the order in which the tensor cores sum inside a chain shows only
in the CUDA tests and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.ops import color as jax_color
from lz4jpeg_tpu.ops import rle as jax_rle
from lz4jpeg_tpu.ops.fused import fused_forward_jnp
from lz4jpeg_tpu.ops.pallas_fwd import (
    forward_megakernel,
    rgb_to_kt,
    sparse_lengths as jax_sparse_lengths,
)

from lz4jpeg_tpu_torch.ops import color, rle
from lz4jpeg_tpu_torch.ops.color import _snap_trunc
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, fused_forward
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    CHANNEL_SLICES,
    forward_combined,
    forward_combined_ref,
    sparse_lengths,
    split_basis,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
    scale_table,
)
from lz4jpeg_tpu_torch.utils.parity import sum_order_flips

ALIGNED = [(2, 64, 64), (1, 40, 24), (1, 8, 8)]
RAGGED = [(1, 37, 53), (1, 1, 1), (2, 13, 7)]


def _batch(b, h, w, seed, runs=True):
    rgb = np.random.default_rng(seed).integers(0, 256, size=(b, h, w, 3),
                                               dtype=np.uint8)
    if runs:  # duplicated columns make runs of equal coefficients
        rgb[:, :, 0 : 2 * (w // 2) : 2] = rgb[:, :, 1::2]
    return rgb


def _jax_forward(rgb, quality=None):
    """The JAX pipeline's ``_forward_rle_impl`` (jitted, as ``encode`` runs
    it), frame by frame."""
    pipe = JaxJPEGPipeline(JaxJPEGConfig(quality=quality))
    return np.concatenate(
        [np.asarray(pipe._forward_rle(jnp.asarray(f))) for f in rgb]
    )


def _port_forward(rgb, quality=None):
    out = forward_combined(
        torch.from_numpy(rgb), scale_table(LUM, quality),
        scale_table(CHR, quality),
    )
    assert out.dtype == torch.int16 and out.shape[1] == 128
    return out.numpy().view(np.uint16)


@pytest.mark.parametrize("shape", ALIGNED + RAGGED)
def test_forward_matches_jax_pipeline(shape):
    rgb = _batch(*shape, seed=sum(shape))
    ref = _jax_forward(rgb)
    got = _port_forward(rgb)
    assert got.shape == ref.shape
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("quality", [50, 75])
def test_forward_matches_jax_pipeline_scaled(quality):
    rgb = _batch(1, 32, 48, seed=quality)
    assert np.array_equal(_port_forward(rgb, quality), _jax_forward(rgb, quality))


@pytest.mark.parametrize("shape", ALIGNED)
def test_forward_matches_interpret_megakernel(shape):
    rgb = _batch(*shape, seed=7 + sum(shape))
    ref = np.asarray(
        forward_megakernel(rgb_to_kt(jnp.asarray(rgb)), LUM, CHR, interpret=True)
    )
    assert np.array_equal(_port_forward(rgb), ref)


@pytest.mark.parametrize("shape", ALIGNED + RAGGED)
def test_sparse_lengths_match(shape):
    rgb = _batch(*shape, seed=3)
    comb = _port_forward(rgb)
    ours = sparse_lengths(torch.from_numpy(comb.view(np.int16)))
    theirs = jax_sparse_lengths(jnp.asarray(comb))
    for c in CHANNEL_SLICES:
        assert np.array_equal(ours[c].numpy(), np.asarray(theirs[c]))


@pytest.mark.parametrize("shape", [(37, 53), (16, 8), (1, 1)])
def test_color_ops_match(shape):
    rgb = _batch(1, *shape, seed=11)[0]
    ours = color.rgb_to_ycbcr(torch.from_numpy(rgb))
    theirs = jax_color.rgb_to_ycbcr(jnp.asarray(rgb), jnp.float32)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    subs = [color.chroma_subsample_422(p) for p in ours[1:]]
    jsubs = [jax_color.chroma_subsample_422(p) for p in theirs[1:]]
    for a, b in zip(color.split_mcus(ours[0], *subs),
                    jax_color.split_mcus(theirs[0], *jsubs)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_color_merge_matches():
    rng = np.random.default_rng(5)
    y, cr, cb = (rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
                 for _ in range(3))
    ours = color.ycbcr_planes_to_rgb(
        torch.from_numpy(y), torch.from_numpy(cr), torch.from_numpy(cb),
        21, 30,
    )
    theirs = jax_color.ycbcr_planes_to_rgb(
        jnp.asarray(y), jnp.asarray(cr), jnp.asarray(cb), 21, 30,
        jnp.float32, chroma_upsampled=True,
    )
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("width,table", [(8, LUM), (4, CHR)])
def test_fused_forward_matches(width, table):
    tiles = np.random.default_rng(width).integers(0, 256, size=(200, 8, width),
                                                  dtype=np.uint8)
    ours = fused_forward(torch.from_numpy(tiles), table, width, 8)
    theirs = fused_forward_jnp(jnp.asarray(tiles), table, width, 8)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))


def test_rle_sparse16_matches():
    rng = np.random.default_rng(9)
    vals = rng.integers(-511, 512, size=(300, 64))
    vals[:, 20:] = np.repeat(vals[:, 19:20], 44, axis=1)  # long trailing runs
    vals[::3, 5:9] = 0
    ours, ours_len = rle.rle_encode_sparse16(torch.from_numpy(vals))
    theirs, theirs_len = jax_rle.rle_encode_sparse16(jnp.asarray(vals))
    assert np.array_equal(ours.numpy().view(np.uint16), np.asarray(theirs))
    assert np.array_equal(ours_len.numpy(), np.asarray(theirs_len))
    back = rle.rle_decode_sparse16(ours)
    assert np.array_equal(back.numpy(), vals)
    assert np.array_equal(back.numpy(), np.asarray(jax_rle.rle_decode_sparse16(theirs)))


def test_ref_is_what_the_cpu_wrapper_runs():
    rgb = torch.from_numpy(_batch(2, 24, 40, seed=2))
    assert torch.equal(forward_combined(rgb, LUM, CHR),
                       forward_combined_ref(rgb, LUM, CHR))


def test_flip_rule_accepts_identity_and_rejects_other_differences():
    rgb = _batch(1, 16, 16, seed=4)
    comb = _port_forward(rgb)
    assert sum_order_flips(rgb, comb, comb, LUM, CHR) == 0
    # A DC coefficient moved by 2: never a sum-order flip.
    bad = comb.copy()
    bad[0, 0] += 2
    with pytest.raises(AssertionError, match="not a sum-order flip"):
        sum_order_flips(rgb, bad, comb, LUM, CHR)


def _split_product_forward(rgb, lum, chroma):
    """The kernel's split product, emulated: (N, 128) combined sparse
    streams."""
    y, cr, cb = color.rgb_to_ycbcr(torch.from_numpy(rgb))
    tiles = color.split_mcus(y, color.chroma_subsample_422(cr),
                             color.chroma_subsample_422(cb))
    parts = []
    for t, table, width in zip(tiles, (lum, chroma, chroma), (8, 4, 4)):
        m, _ = forward_basis(width, 8, _table_key(table))
        x = t.reshape(t.shape[0], -1).to(torch.float32) - 128
        assert torch.equal(x, x.to(torch.bfloat16).to(torch.float32))
        hi, mid, lo = torch.from_numpy(split_basis(m))
        for part in (hi, mid, lo):
            assert torch.equal(part, part.to(torch.bfloat16).to(torch.float32))
        small = x @ lo.T + x @ mid.T  # one chain: lo, then mid
        large = x @ hi.T              # the other chain
        zz = _snap_trunc(small + large, 1e-5).to(torch.int16)
        parts.append(rle.rle_encode_sparse16(zz)[0])
    return torch.cat(parts, dim=1).numpy()


@pytest.mark.parametrize("shape", [(2, 64, 64), (1, 37, 53), (1, 9, 17)])
@pytest.mark.parametrize("quality", [None, 75])
def test_split_bf16_product_within_flip_rule(shape, quality):
    rgb = _batch(*shape, seed=31 + sum(shape), runs=False)
    lum, chroma = scale_table(LUM, quality), scale_table(CHR, quality)
    got = _split_product_forward(rgb, lum, chroma)
    want = forward_combined_ref(torch.from_numpy(rgb), lum, chroma).numpy()
    flips = sum_order_flips(rgb, got, want, lum, chroma)
    assert flips <= 1e-5 * got.size


def test_integer_colour_matches_on_every_rgb():
    """K1's colour, exact integer arithmetic (floor(1000·Y) / 1000 etc., as
    dp4a byte dot products), equals ``rgb_to_ycbcr`` on all 2^24 colours."""
    v = np.arange(1 << 24, dtype=np.int32)
    r, g, b = v >> 16, (v >> 8) & 255, v & 255
    rgb = np.stack([r, g, b], axis=-1).astype(np.uint8).reshape(4096, 4096, 3)
    y, cr, cb = color.rgb_to_ycbcr(torch.from_numpy(rgb))
    assert np.array_equal(y.numpy().ravel(), (299 * r + 587 * g + 114 * b) // 1000)
    assert np.array_equal(cr.numpy().ravel(),
                          (128000 + 439 * r - 368 * g - 71 * b) // 1000)
    assert np.array_equal(cb.numpy().ravel(),
                          (128000 - 148 * r - 291 * g + 439 * b) // 1000)
