"""The port's numpy copies and parameters, held equal to the JAX package.

Tables, quality scaling, the zigzag permutation and every basis the two
packages build must be exactly equal (``np.array_equal``), for the
reference tables (quality None) and scaled settings (75; 80, 90 and 100,
which take the int16 pair layout).  The quant tables are the codec's
parameters: ``tables_from_numpy`` carries the JAX pipeline's ``_tables``
into the port, whose bases must then equal the JAX package's.
"""

import numpy as np
import pytest

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.models.jpeg import JPEGPipeline as JaxJPEGPipeline
from lz4jpeg_tpu.ops import fused as jax_fused
from lz4jpeg_tpu.ops.pallas_fwd import _kt_bases as jax_kt_bases
from lz4jpeg_tpu.ops.quantize import scale_table as jax_scale_table
from lz4jpeg_tpu.oracle import jpeg_oracle

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline, tables_from_numpy
from lz4jpeg_tpu_torch.ops import fused, quantize
from lz4jpeg_tpu_torch.ops.fwd_megakernel import kt_bases, split_basis

QUALITIES = (None, 75)
SHAPES = ((8, 8), (4, 8))  # (width, height) of the luma and chroma blocks


def _jax_tables(quality):
    return {
        c: np.asarray(t)
        for c, t in JaxJPEGPipeline(JaxJPEGConfig(quality=quality))._tables.items()
    }


def test_reference_tables_equal():
    assert np.array_equal(
        quantize.LUMINANCE_QUANTIZATION_TABLE,
        jpeg_oracle.LUMINANCE_QUANTIZATION_TABLE,
    )
    assert np.array_equal(
        quantize.CHROMINANCE_QUANTIZATION_TABLE,
        jpeg_oracle.CHROMINANCE_QUANTIZATION_TABLE,
    )


@pytest.mark.parametrize("quality", [None, 1, 25, 50, 75, 90, 100])
def test_scale_table_equal(quality):
    for table in (
        jpeg_oracle.LUMINANCE_QUANTIZATION_TABLE,
        jpeg_oracle.CHROMINANCE_QUANTIZATION_TABLE,
    ):
        assert np.array_equal(
            quantize.scale_table(table, quality),
            jax_scale_table(table, quality),
        )


@pytest.mark.parametrize("width,height", [(8, 8), (4, 8), (3, 5), (8, 4)])
def test_zigzag_indices_equal(width, height):
    assert np.array_equal(
        quantize.zigzag_indices(width, height),
        jpeg_oracle.zigzag_indices(width, height),
    )


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("name", ["forward_basis", "inverse_basis",
                                  "inverse_suffix_basis"])
def test_bases_equal(quality, name):
    tables = _jax_tables(quality)
    for (width, height), table in zip(SHAPES, (tables["lum"], tables["r"])):
        key = jax_fused._table_key(table)
        assert key == fused._table_key(table)
        ours = getattr(fused, name)(width, height, key)
        theirs = getattr(jax_fused, name)(width, height, key)
        if name == "forward_basis":  # (M, offset)
            assert all(map(np.array_equal, ours, theirs))
        else:
            assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("quality", QUALITIES)
def test_kt_bases_equal(quality):
    tables = _jax_tables(quality)
    keys = (fused._table_key(tables["lum"]), fused._table_key(tables["r"]))
    for ours, theirs in zip(kt_bases(*keys), jax_kt_bases(*keys)):
        assert ours.dtype == theirs.dtype == np.float32
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("quality", QUALITIES)
def test_tables_from_numpy_carries_jax_parameters(quality):
    jax_tables = _jax_tables(quality)
    tables = tables_from_numpy(jax_tables)
    for c in ("lum", "r", "b"):
        assert tables[c].dtype == np.int64
        assert np.array_equal(tables[c], jax_tables[c])
    pipe = JPEGPipeline(JPEGConfig(quality=quality), device="cpu", tables=tables)
    bases = pipe.bases()
    keys = {c: jax_fused._table_key(jax_tables[c]) for c in ("lum", "r", "b")}
    for ours, theirs in zip(bases["forward"], jax_kt_bases(keys["lum"], keys["r"])):
        assert np.array_equal(ours, theirs)
    for c, width in (("lum", 8), ("r", 4), ("b", 4)):
        assert np.array_equal(
            bases["inverse"][c],
            jax_fused.inverse_suffix_basis(width, 8, keys[c]),
        )


def test_tables_from_numpy_rejects_bad_tables():
    good = _jax_tables(None)
    with pytest.raises(ValueError):
        tables_from_numpy({**good, "lum": good["lum"][:32]})
    with pytest.raises(ValueError):
        tables_from_numpy({**good, "r": good["r"] + 0.5})
    with pytest.raises(KeyError):
        tables_from_numpy({"lum": good["lum"], "r": good["r"]})
    # Tables that do not belong to the config's quality would write
    # containers that decode with other tables.
    with pytest.raises(ValueError):
        JPEGPipeline(JPEGConfig(quality=None), device="cpu",
                     tables=_jax_tables(75))


@pytest.mark.parametrize("quality", [80, 90, 100])
def test_tables_from_numpy_pair_layout(quality):
    """Quality 80–100 tables (an entry below 3) carry across too; the
    pipeline then runs the per-channel forward and inverse bases of the
    pair layout, equal to the JAX package's."""
    jax_tables = _jax_tables(quality)
    assert min(int(t.min()) for t in jax_tables.values()) < 3
    pipe = JPEGPipeline(JPEGConfig(quality=quality), device="cpu",
                        tables=tables_from_numpy(jax_tables))
    assert not pipe.sparse16
    bases = pipe.bases()
    for c, width in (("lum", 8), ("r", 4), ("b", 4)):
        key = jax_fused._table_key(jax_tables[c])
        assert all(map(np.array_equal, bases["forward"][c],
                       jax_fused.forward_basis(width, 8, key)))
        assert np.array_equal(bases["inverse"][c],
                              jax_fused.inverse_basis(width, 8, key))


@pytest.mark.parametrize("kwargs", [
    {"precision": "exact"},
    {"entropy": "per_block"},
    {"quality": 100},
    {"quality": 95},
])
def test_every_mode_encodes_like_jax(kwargs):
    """Every mode builds and encodes as the JAX pipeline does: exact
    precision gives the JAX exact pipeline's int32 RLE (and container),
    per-block entropy its bitstrings, quality 100 and 95 the int16 pair
    layout with the JAX package's container bytes."""
    from lz4jpeg_tpu.formats.jpeg_container import pack_container as jax_pack

    from lz4jpeg_tpu_torch.formats.jpeg_container import pack_container

    rgb = np.random.default_rng(kwargs.get("quality", len(str(kwargs)))).integers(
        0, 256, size=(24, 40, 3), dtype=np.uint8)
    enc = JPEGPipeline(JPEGConfig(**kwargs), device="cpu").encode(rgb)
    jax_enc = JaxJPEGPipeline(JaxJPEGConfig(**kwargs)).encode(rgb)
    assert not enc.rle_sparse16 and not enc.rle_packed16
    assert not jax_enc.rle_sparse16 and not jax_enc.rle_packed16
    for c in ("lum", "r", "b"):
        assert np.array_equal(enc.rle[c], np.asarray(jax_enc.rle[c]))
        assert np.array_equal(enc.rle_lengths[c], np.asarray(jax_enc.rle_lengths[c]))
    if kwargs.get("entropy") == "per_block":
        assert enc.entropy_mode == jax_enc.entropy_mode == "per_block"
        assert enc.per_block_bits == jax_enc.per_block_bits
    else:
        assert pack_container(enc) == jax_pack(jax_enc)


@pytest.mark.parametrize("quality", [1, 50, 75, 85, 90, 95, 100])
def test_sparse16_eligibility_matches_jax(quality):
    """The port picks the JAX pipeline's layout at every quality and in
    every mode: sparse16 where the JAX pipeline does (fast, shared, every
    table entry ≥ 3), int16 pairs elsewhere; an exact or per-block
    pipeline never encodes sparse16."""
    rgb = np.zeros((8, 8, 3), np.uint8)
    for mode in ({}, {"precision": "exact"}, {"entropy": "per_block"}):
        pipe = JPEGPipeline(JPEGConfig(quality=quality, **mode), device="cpu")
        jax_pipe = JaxJPEGPipeline(JaxJPEGConfig(quality=quality, **mode))
        assert pipe.sparse16 == jax_pipe._sparse16
        assert not (mode and pipe.sparse16)
        enc = pipe.encode(rgb, entropy=False)
        jax_enc = jax_pipe.encode(rgb, entropy=False)
        assert (enc.rle_sparse16, enc.rle_packed16) == (
            jax_enc.rle_sparse16, jax_enc.rle_packed16)


@pytest.mark.parametrize("quality", [10, 50, 75])
@pytest.mark.parametrize("name", ["lum", "chr"])
def test_split_basis_sums_to_the_f32_basis(quality, name):
    """The K1 operand: three parts, each of bf16 values (low 16 bits of the
    float32 zero), whose float64 sum is exactly the float32 basis."""
    table = quantize.scale_table(
        quantize.LUMINANCE_QUANTIZATION_TABLE if name == "lum"
        else quantize.CHROMINANCE_QUANTIZATION_TABLE, quality)
    m, _ = fused.forward_basis(8 if name == "lum" else 4, 8,
                               fused._table_key(table))
    parts = split_basis(m)
    assert parts.shape == (3, *m.shape) and parts.dtype == np.float32
    assert not np.any(parts.view(np.uint32) & 0xFFFF)
    total = parts.astype(np.float64).sum(axis=0)
    assert np.array_equal(total, m.astype(np.float32).astype(np.float64))
    # hi carries the magnitude; the parts shrink by at least 2^8 each.
    assert np.all(np.abs(parts[1]) <= np.abs(parts[0]) * 2.0 ** -8)
    assert np.all(np.abs(parts[2]) <= np.abs(parts[1]) * 2.0 ** -8)
