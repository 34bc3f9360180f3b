"""Exact precision (float64), its staged ops and the oracle copy, held
against the JAX package and the JAX package's oracle.

Tolerance: identity, on integers or on float64 values with snapped
quantization ties, with one stated exception: a float32 IDCT rounds half
away from zero after a sum whose order differs between XLA and torch, so a
pixel may land one step apart where the float64 value lies within 1e-3 of a
half (measured: 2 of 192,000 luma pixels).  Inputs are made from a seed
with numpy and fed to both packages; the JAX conftest enables x64.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.formats.jpeg_container import pack_container as jax_pack
from lz4jpeg_tpu.formats.jpeg_container import unpack_container as jax_unpack
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.oracle import jpeg_oracle as jax_oracle

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.oracle import jpeg_oracle
from lz4jpeg_tpu_torch.ops import dct, quantize, zigzag

# ``lz4jpeg_tpu.ops`` re-exports functions under its modules' names.
jax_dct = importlib.import_module("lz4jpeg_tpu.ops.dct")
jax_quantize = importlib.import_module("lz4jpeg_tpu.ops.quantize")
jax_zigzag = importlib.import_module("lz4jpeg_tpu.ops.zigzag")

SHAPES = [(8, 8), (16, 16), (32, 32), (16, 32), (37, 53)]
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
CHANNELS = ("lum", "r", "b")


def _noise(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def pipes():
    return (JaxJPEGPipeline(JaxJPEGConfig(precision="exact")),
            JPEGPipeline(JPEGConfig(precision="exact"), device="cpu"))


@pytest.mark.parametrize("snap", [True, False])
@pytest.mark.parametrize("shape", [(16, 24), (37, 53)])
def test_oracle_copy_equals_original(shape, snap):
    img = _noise(sum(shape), *shape)
    rec, ours = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=snap)
    jax_rec, theirs = jax_oracle.jpeg_roundtrip_oracle(img, snap_ties=snap)
    assert np.array_equal(rec, jax_rec)
    for key in ("y", "cr", "cb", "lum_q", "r_q", "b_q", "zz_lum", "zz_r",
                "zz_b"):
        assert np.array_equal(ours[key], theirs[key]), key
    for key in ("rle_lum", "rle_r", "rle_b", "huff_bits"):
        assert ours[key] == theirs[key], key
    for h, w in ((8, 8), (8, 4)):
        assert np.array_equal(jpeg_oracle.reverse_zigzag_indices(w, h),
                              jax_oracle.reverse_zigzag_indices(w, h))


@pytest.mark.parametrize("torch_dtype,jax_dtype", DTYPES)
@pytest.mark.parametrize("h,w", [(8, 8), (8, 4)])
def test_staged_ops_equal_jax(torch_dtype, jax_dtype, h, w):
    """dct2 → quantize → zigzag → reverse_zigzag → dequantize → idct2, each
    stage fed the JAX stage's own output.  The raw DCT coefficients differ
    in the last ulps (sum order), so they are compared through quantize,
    whose snapping makes both exact."""
    rng = np.random.default_rng(h * w)
    tiles = rng.integers(0, 256, size=(3000, h, w), dtype=np.uint8)
    table = (np.arange(h * w).reshape(h, w) * 7 % 37 + 2).astype(np.int64)
    coef = np.array(jax_dct.dct2_batched(jnp.asarray(tiles), jax_dtype))
    ours = dct.dct2_batched(torch.from_numpy(tiles), torch_dtype)
    assert ours.dtype == torch_dtype
    q = np.array(jax_quantize.quantize(jnp.asarray(coef), table))
    assert np.array_equal(quantize.quantize(ours, table).numpy(), q)
    assert np.array_equal(
        quantize.quantize(torch.from_numpy(coef), table).numpy(), q)
    zz = np.array(jax_zigzag.zigzag(jnp.asarray(q), w, h))
    assert np.array_equal(zigzag.zigzag(torch.from_numpy(q), w, h).numpy(), zz)
    back = np.asarray(jax_zigzag.reverse_zigzag(jnp.asarray(zz), w, h))
    assert np.array_equal(
        zigzag.reverse_zigzag(torch.from_numpy(zz), w, h).numpy(), back)
    deq = np.array(jax_quantize.dequantize(jnp.asarray(q), table))
    assert np.array_equal(
        quantize.dequantize(torch.from_numpy(q), table).numpy(), deq)
    pix = np.asarray(jax_dct.idct2_batched(jnp.asarray(deq), jax_dtype))
    got = dct.idct2_batched(torch.from_numpy(deq), torch_dtype).numpy()
    assert got.dtype == np.uint8
    apart = got != pix
    if torch_dtype == torch.float64:
        assert not apart.any()
        return
    # float32: one step apart, and only at a round-half tie.
    assert apart.mean() < 1e-4
    assert (np.abs(got.astype(int) - pix)[apart] == 1).all()
    a = torch.from_numpy(deq.astype(np.float64))
    ah, alpha_h = dct.dct_basis(h)
    aw, alpha_w = dct.dct_basis(w)
    x = torch.einsum("ux,nuv,vy->nxy", torch.from_numpy(ah),
                     a * torch.from_numpy(np.outer(alpha_h, alpha_w)),
                     torch.from_numpy(aw)).numpy() + 128.0
    frac = np.abs(x - np.floor(x) - 0.5)
    assert (frac[apart] < 1e-3).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_exact_pipeline_equals_jax_and_oracle(pipes, shape):
    """forward_stages (float64 zz, int32 pairs, lengths), the RLE of
    ``encode``, ``encode_batch``, the container and ``roundtrip``."""
    jax_pipe, pipe = pipes
    img = _noise(sum(shape) + 1, *shape)
    theirs = jax_pipe.forward_stages(img)
    ours = pipe.forward_stages(img)
    ref = jpeg_oracle.jpeg_forward_oracle(img, snap_ties=True)
    for c in CHANNELS:
        for key in ("zz", "rle", "rle_lengths"):
            assert ours[c][key].dtype == np.asarray(theirs[c][key]).dtype
            assert np.array_equal(ours[c][key], np.asarray(theirs[c][key]))
        assert ours[c]["zz"].dtype == np.float64
        assert np.array_equal(ours[c]["zz"], ref[f"zz_{c}"])
    enc = pipe.encode(img)
    (batch,) = pipe.encode_batch(img[None])
    jax_enc = jax_pipe.encode(img)
    for c in CHANNELS:
        for i, row in enumerate(ref[f"rle_{c}"]):
            n = int(enc.rle_lengths[c][i])
            assert list(enc.rle[c][i, :n]) == row
        assert np.array_equal(batch.rle[c], enc.rle[c])
        assert np.array_equal(enc.rle[c], np.asarray(jax_enc.rle[c]))
    assert pack_container(enc) == pack_container(batch) == jax_pack(jax_enc)
    rec, _ = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
    got = pipe.roundtrip(img)
    assert np.array_equal(got, rec)
    assert np.array_equal(got, jax_pipe.roundtrip(img))


def test_exact_solid_colour(pipes):
    jax_pipe, pipe = pipes
    img = np.full((8, 8, 3), 77, dtype=np.uint8)
    rec, _ = jpeg_oracle.jpeg_roundtrip_oracle(img, snap_ties=True)
    assert np.array_equal(pipe.roundtrip(img), rec)
    assert np.array_equal(pipe.roundtrip(img), jax_pipe.roundtrip(img))


def test_exact_quality75_container_round_trip():
    """Quality 75 fits the sparse16 tier: the container comes back sparse16
    and the exact pipeline decodes it in float64 through the staged inverse
    (``rle_decode_sparse16``), as the JAX pipeline does."""
    cfg = dict(precision="exact", quality=75)
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(**cfg))
    img = _noise(75, 16, 16)
    enc, jax_enc = pipe.encode(img), jax_pipe.encode(img)
    data = pack_container(enc)
    assert data == jax_pack(jax_enc)
    dec, jax_dec = unpack_container(data), jax_unpack(data)
    assert dec.quality == 75 and dec.rle_sparse16 and jax_dec.rle_sparse16
    got = pipe.decode(dec)
    assert np.array_equal(got, np.asarray(jax_pipe.decode(jax_dec)))
    assert np.array_equal(got, pipe.decode(enc))


@pytest.mark.parametrize("cfg", [
    {"precision": "exact"},
    {"entropy": "per_block"},
    {"precision": "exact", "entropy": "per_block"},
    {"precision": "exact", "quality": 50},
])
def test_layout_gate_keeps_exact_and_per_block_off_sparse16(cfg):
    """Exact or per-block pipelines encode int32 pairs, never sparse16
    through the float32 kernel, even with sparse16-eligible tables."""
    pipe = JPEGPipeline(JPEGConfig(**cfg), device="cpu")
    jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(**cfg))
    assert not pipe.sparse16 and not jax_pipe._sparse16
    enc = pipe.encode(_noise(3, 16, 24), entropy=False)
    assert not enc.rle_sparse16 and not enc.rle_packed16
    assert enc.rle["lum"].dtype == np.int32
    assert JPEGConfig(**cfg).dtype == (
        torch.float64 if cfg.get("precision") == "exact" else torch.float32)
