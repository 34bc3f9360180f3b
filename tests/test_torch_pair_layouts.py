"""The pair layouts (int16 pairs and packed16) of the JPEG pipeline and the
TJPG container, held against the JAX package.

* Containers are byte-identical to the JAX package's at quality 80, 90, 95
  and 100 (the int16 pair layout), and a packed16 encode (``to_packed16``)
  writes the same bytes as the sparse16 encode of the same image.
* Containers cross-decode both ways; decoded RGB stays within the JAX
  fast-path envelope: max |Δ| ≤ 3 on at most 2e-3 of pixels (the inverse
  matmuls sum in another order than XLA's, which moves a few pixels by ±1
  at the round-half boundary, up to ±3 after the color merge).
* Every fallback tier of ``unpack_container`` gives the JAX container's
  layout flags and arrays on crafted containers, and decodes within the
  envelope.
* The staged inverse ops, the plane ops, ``merge_mcus``,
  ``ycbcr_to_rgb_mcus``, ``unpack_symbols``, the host helpers and the six
  pair-layout native bindings equal the JAX package's (equality, except the
  inverse einsums: the envelope).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4jpeg_tpu.config import JPEGConfig as JaxJPEGConfig
from lz4jpeg_tpu.formats import jpeg_container as jax_container
from lz4jpeg_tpu.models import jpeg as jax_jpeg
from lz4jpeg_tpu.native import native_backend as jax_native_backend
from lz4jpeg_tpu.ops import color as jax_color
from lz4jpeg_tpu.ops import fused as jax_fused
from lz4jpeg_tpu.ops.huffman import unpack_symbols as jax_unpack_symbols

from lz4jpeg_tpu_torch import JPEGConfig, JPEGPipeline
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.models import jpeg
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops import color, fused
from lz4jpeg_tpu_torch.ops.huffman import (
    build_canonical_codebook_from_counts,
    unpack_symbols,
)
from lz4jpeg_tpu_torch.ops.pack16 import (
    pack16_decode_plane,
    pack16_encode_kt,
)

CHANNELS = ("lum", "r", "b")
PAIR_QUALITIES = (80, 90, 95, 100)


def _image(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3),
                                                dtype=np.uint8)


def _pipes(quality=None):
    return (
        jax_jpeg.JPEGPipeline(JaxJPEGConfig(quality=quality)),
        JPEGPipeline(JPEGConfig(quality=quality), device="cpu"),
    )


def _assert_envelope(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 3
    assert (diff != 0).mean() <= 2e-3


def _assert_same_encode(ours, theirs):
    """Layout flags, per-channel arrays and lengths equal."""
    assert (ours.rle_sparse16, ours.rle_packed16) == (
        theirs.rle_sparse16, theirs.rle_packed16)
    for c in CHANNELS:
        assert np.array_equal(ours.rle[c], np.asarray(theirs.rle[c])), c
        assert np.array_equal(ours.rle_lengths[c],
                              np.asarray(theirs.rle_lengths[c])), c


# ---- quality 80–100: the int16 pair layout ----------------------------------


@pytest.mark.parametrize("quality", PAIR_QUALITIES)
@pytest.mark.parametrize("shape", [(32, 48), (37, 53)])
def test_pair_containers_bytes_equal(quality, shape):
    jax_pipe, pipe = _pipes(quality)
    rgb = _image(*shape, seed=quality + shape[1])
    enc = pipe.encode(rgb)
    ours = pack_container(enc)
    assert not enc.rle_sparse16 and not enc.rle_packed16
    assert ours == jax_container.pack_container(jax_pipe.encode(rgb))
    assert ours[5] == quality


def test_pair_encode_batch_equals_single_encodes():
    _, pipe = _pipes(90)
    rgbs = np.stack([_image(24, 40, seed=s) for s in range(3)])
    batch = [pack_container(e) for e in pipe.encode_batch(rgbs)]
    assert batch == [pack_container(pipe.encode(f)) for f in rgbs]


@pytest.mark.parametrize("quality", PAIR_QUALITIES)
def test_pair_cross_decode(quality):
    jax_pipe, pipe = _pipes(quality)
    rgb = _image(40, 56, seed=quality)
    ours = pack_container(pipe.encode(rgb))
    theirs = jax_container.pack_container(jax_pipe.encode(rgb))
    jax_enc = jax_container.unpack_container(theirs)
    enc = unpack_container(theirs)
    _assert_same_encode(enc, jax_enc)
    ref = jax_pipe.decode(jax_enc)
    _assert_envelope(pipe.decode(enc), ref)
    _assert_envelope(jax_pipe.decode(jax_container.unpack_container(ours)), ref)
    # Decoding straight from the encode (no container) agrees as well.
    _assert_envelope(pipe.decode(pipe.encode(rgb)), ref)


def test_pair_decode_batch_matches_jax():
    jax_pipe, pipe = _pipes(95)
    rgbs = np.stack([_image(32, 24, seed=s) for s in (4, 5)])
    ours = pipe.decode_batch(pipe.encode_batch(rgbs))
    theirs = jax_pipe.decode_batch(jax_pipe.encode_batch(rgbs))
    for a, b in zip(ours, theirs):
        _assert_envelope(a, b)


# ---- packed16 encodes -------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_packed16_container_equals_sparse16(shape):
    """The packed16 encode of an image writes the sparse16 encode's bytes
    (same symbol streams, same native code), which are the JAX package's;
    its words are JAX ``sparse16_to_packed16`` of the combined buffer."""
    from lz4jpeg_tpu.ops.rle import sparse16_to_packed16 as jax_to_packed16

    jax_pipe, pipe = _pipes()
    rgb = _image(*shape, seed=shape[0])
    sparse = pipe.encode(rgb)
    (packed,) = pipe.to_packed16([sparse])
    assert packed.rle_packed16 and packed.entropy_mode is None
    for c, sl in zip(CHANNELS, (slice(0, 64), slice(64, 96), slice(96, 128))):
        words, lengths = jax_to_packed16(jnp.asarray(sparse.rle_combined[:, sl]))
        assert np.array_equal(packed.rle[c], np.asarray(words))
        assert np.array_equal(packed.rle_lengths[c], np.asarray(lengths))
        assert np.array_equal(packed.rle_lengths[c], sparse.rle_lengths[c])
    pipe.entropy_encode(packed)
    data = pack_container(packed)
    assert data == pack_container(sparse)
    assert data == jax_container.pack_container(jax_pipe.encode(rgb))


def test_packed16_decode_matches_jax_and_sparse16():
    jax_pipe, pipe = _pipes()
    rgbs = np.stack([_image(40, 48, seed=s) for s in (6, 7)])
    sparse = pipe.encode_batch(rgbs)
    packed = [pipe.entropy_encode(e) for e in pipe.to_packed16(sparse)]
    ours = pipe.decode_batch(packed)
    sparse_rgb = pipe.decode_batch(sparse)
    for i, rgb in enumerate(rgbs):
        jax_enc = jax_pipe.encode(rgb)
        j_packed = jax_jpeg.JPEGEncoded(
            height=40, width=48, blocks_per_col=5, blocks_per_row=6,
            rle=packed[i].rle, rle_lengths=packed[i].rle_lengths,
            entropy_mode="shared", rle_packed16=True,
            shared_streams=jax_enc.shared_streams,
        )
        theirs = jax_pipe.decode(j_packed)
        _assert_envelope(ours[i], theirs)
        _assert_envelope(ours[i], sparse_rgb[i])


# ---- fallback tiers of unpack_container -------------------------------------


def _stream(symbols):
    """A canonical Huffman stream of ``symbols``: (codebook, bytes, bits)."""
    values, counts = np.unique(np.asarray(symbols), return_counts=True)
    cb = build_canonical_codebook_from_counts(values, counts)
    code = {int(s): (int(c), int(l)) for s, c, l in
            zip(cb.symbols, cb.codes, cb.lengths)}
    bits = []
    for s in symbols:
        c, l = code[int(s)]
        bits.extend((c >> (l - 1 - i)) & 1 for i in range(l))
    return cb, np.packbits(np.array(bits, np.uint8)).tobytes(), len(bits)


CRAFTED = {
    # sparse16 refuses a stream that stops early; packed16 takes it.
    "ends_early": ([64, 5], "packed16"),
    # A run crossing into block 1 belongs to block 1, where it ends.
    "crossing_run": ([60, 5, 8, 7, 60, 2], "packed16"),
    # A count of 65 passes no 16-bit walker; the native int32 one takes it.
    "count_65": ([65, 0, 63, 5], "pairs"),
    # A zero count passes no native walker; the Python path re-blocks it.
    "zero_count": ([10, 1, 0, 2, 54, 3, 64, 9], "pairs"),
}


def _crafted_container(symbols, quality=None):
    """A 2-block (8×16) image's container with its luma stream replaced."""
    _, pipe = _pipes(quality)
    enc = pipe.encode(_image(8, 16, seed=len(symbols)))
    enc.shared_streams["lum"] = _stream(symbols)
    return pack_container(enc)


@pytest.mark.parametrize("name", sorted(CRAFTED))
def test_unpack_container_tiers_match_jax(name):
    symbols, layout = CRAFTED[name]
    data = _crafted_container(symbols)
    ours = unpack_container(data)
    theirs = jax_container.unpack_container(data)
    _assert_same_encode(ours, theirs)
    assert jpeg._layout_of(ours) == layout
    jax_pipe, pipe = _pipes()
    # The JAX decode starts from the container's arrays: its entropy_decode
    # cannot reach the Python tier (``unpack_symbols`` is bound only in its
    # sparse16 branch, so the pair branch raises UnboundLocalError).  The
    # port decodes from the bitstreams again.
    _assert_envelope(pipe.decode(ours),
                     jax_pipe.decode(theirs, from_entropy=False))


def test_python_tier_runs_unpack_symbols(monkeypatch):
    """The zero-count luma stream reaches the Python ``unpack_symbols``
    walk; the chroma streams stay on the native int32 walker."""
    from lz4jpeg_tpu_torch.formats import jpeg_container

    calls = []
    monkeypatch.setattr(jpeg_container, "unpack_symbols",
                        lambda *a: calls.append(1) or unpack_symbols(*a))
    unpack_container(_crafted_container(CRAFTED["zero_count"][0]))
    assert calls == [1]


def test_entropy_decode_sparse16_fallback_matches_jax():
    """A sparse16 encode whose luma stream the strict walker refuses goes
    through ``unpack_symbols`` and ``_pairs_to_sparse_host``, as in JAX."""
    jax_pipe, pipe = _pipes()
    rgb = _image(8, 16, seed=2)
    enc, jax_enc = pipe.encode(rgb), jax_pipe.encode(rgb)
    stream = _stream(CRAFTED["crossing_run"][0])
    enc.shared_streams["lum"] = jax_enc.shared_streams["lum"] = stream
    rle, lengths = pipe.entropy_decode(enc)
    j_rle, j_lengths = jax_pipe.entropy_decode(jax_enc)
    assert np.array_equal(enc.rle_combined, jax_enc.rle_combined)
    for c in CHANNELS:
        assert np.array_equal(lengths[c], np.asarray(j_lengths[c]))
    # A run that starts past its block: JAX's IndexError, the port's
    # typed error.
    enc.shared_streams["lum"] = jax_enc.shared_streams["lum"] = _stream(
        [100, 3, 28, 4])
    with pytest.raises(IndexError):
        jax_pipe.entropy_decode(jax_enc)
    with pytest.raises(ValueError, match="starts at 100"):
        pipe.entropy_decode(enc)


# ---- host helpers, native bindings, unpack_symbols --------------------------


def _pair_encode(quality=90, seed=0):
    _, pipe = _pipes(quality)
    return pipe.encode(_image(40, 48, seed=seed), entropy=False)


def test_host_helpers_match_jax():
    enc = _pair_encode()
    _, pipe = _pipes()
    (packed,) = pipe.to_packed16([pipe.encode(_image(40, 48, seed=1))])
    for c in CHANNELS:
        pairs, lengths = enc.rle[c], enc.rle_lengths[c]
        assert np.array_equal(jpeg._valid_symbols(pairs, lengths),
                              jax_jpeg._valid_symbols(pairs, lengths))
        words = packed.rle[c]
        assert np.array_equal(jpeg._unpack16_host(words),
                              jax_jpeg._unpack16_host(words))
        as_pairs = jax_jpeg._unpack16_host(words)
        assert np.array_equal(jpeg._pack16_host(as_pairs),
                              jax_jpeg._pack16_host(as_pairs))
        symbols = jax_jpeg._valid_symbols(pairs, lengths)
        block = 64 if c == "lum" else 32
        for ours, theirs in zip(
            jpeg._split_symbols(symbols, enc.num_blocks, 2 * block, block),
            jax_jpeg._split_symbols(symbols, enc.num_blocks, 2 * block, block),
        ):
            assert np.array_equal(ours, theirs)
        sym16 = jax_jpeg._valid_symbols(as_pairs, packed.rle_lengths[c])
        split = jax_jpeg._split_symbols(sym16, packed.num_blocks, 2 * block, block)
        for ours, theirs in zip(jpeg._pairs_to_sparse_host(*split, block),
                                jax_jpeg._pairs_to_sparse_host(*split, block)):
            assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("layout", ["pairs", "packed16"])
def test_pair_native_bindings_match_jax(layout):
    ours, theirs = native_backend(), jax_native_backend()
    if layout == "pairs":
        enc = _pair_encode(quality=100, seed=3)
        names = ("rle_symbol_hist", "huff_pack_pairs", "huff_unpack_pairs")
    else:
        _, pipe = _pipes()
        (enc,) = pipe.to_packed16([pipe.encode(_image(40, 48, seed=3))])
        names = ("rle_symbol_hist16", "huff_pack_pairs16", "huff_unpack_pairs16")
    hist, pack, unpack = names
    for c in CHANNELS:
        rows, lengths = enc.rle[c], enc.rle_lengths[c]
        counts, total = getattr(ours, hist)(rows, lengths, 2048, 4096)
        j_counts, j_total = getattr(theirs, hist)(rows, lengths, 2048, 4096)
        assert np.array_equal(counts, j_counts) and total == j_total
        (bins,) = np.nonzero(counts)
        cb = build_canonical_codebook_from_counts(bins - 2048, counts[bins])
        packed = getattr(ours, pack)(rows, lengths, cb)
        assert packed == getattr(theirs, pack)(rows, lengths, cb)
        block = 64 if c == "lum" else 32
        got = getattr(ours, unpack)(*packed, cb, block, rows.shape[0],
                                    rows.shape[1])
        want = getattr(theirs, unpack)(*packed, cb, block, rows.shape[0],
                                       rows.shape[1])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(got[0], rows) and np.array_equal(got[1], lengths)
        assert np.array_equal(unpack_symbols(*packed, cb),
                              jax_unpack_symbols(*packed, cb))


def test_unpack_symbols_rejects_what_jax_rejects():
    cb, data, nbits = _stream([3, 3, 5, 7])
    with pytest.raises(ValueError):
        unpack_symbols(data, nbits + 64, cb)
    assert unpack_symbols(data, 0, cb).size == 0
    assert unpack_symbols(data, nbits, cb).tolist() == [3, 3, 5, 7]


# ---- staged and plane ops ---------------------------------------------------


@pytest.mark.parametrize("quality", [None, 90])
def test_fused_inverse_and_color_match_jax(quality):
    tables = jax_jpeg.scaled_tables(quality)
    rng = np.random.default_rng(5)
    bpc, bpr = 3, 5
    n = bpc * bpr
    zz = {c: rng.integers(-200, 200, size=(n, 64 if c == "lum" else 32))
          .astype(np.int32) for c in CHANNELS}
    tiles, j_tiles = {}, {}
    for c, tw in (("lum", 8), ("r", 4), ("b", 4)):
        tiles[c] = fused.fused_inverse(torch.from_numpy(zz[c]), tables[c], tw, 8)
        j_tiles[c] = jax_fused.fused_inverse_jnp(jnp.asarray(zz[c]), tables[c], tw, 8)
        _assert_envelope(tiles[c].numpy(), j_tiles[c])
        assert np.array_equal(
            color.merge_mcus(tiles[c], bpc, bpr).numpy(),
            np.asarray(jax_color.merge_mcus(jnp.asarray(tiles[c].numpy()), bpc, bpr)))
    args = (bpc, bpr, 8 * bpc - 3, 8 * bpr - 5)
    ours = color.ycbcr_to_rgb_mcus(tiles["lum"], tiles["r"], tiles["b"], *args)
    theirs = jax_color.ycbcr_to_rgb_mcus(
        *(jnp.asarray(tiles[c].numpy()) for c in CHANNELS), *args)
    assert np.array_equal(ours.numpy(), np.asarray(theirs))
    # Leading batch dimensions merge frame by frame.
    batched = color.ycbcr_to_rgb_mcus(
        *(torch.stack([tiles[c], tiles[c]]) for c in CHANNELS), *args)
    assert np.array_equal(batched[1].numpy(), ours.numpy())


@pytest.mark.parametrize("quality", [None, 90])
def test_plane_ops_match_jax(quality):
    tables = jax_jpeg.scaled_tables(quality)
    rng = np.random.default_rng(9)
    for c, tw in (("lum", 8), ("r", 4)):
        plane = rng.integers(0, 256, size=(24, 10 * tw), dtype=np.uint8)
        ours = fused.fused_forward_plane(torch.from_numpy(plane), tables[c], tw)
        theirs = jax_fused.fused_forward_plane_jnp(jnp.asarray(plane), tables[c], tw)
        assert np.array_equal(ours.numpy(), np.asarray(theirs))
        zz_kt = rng.integers(-200, 200, size=(3, 8 * tw, 10)).astype(np.int16)
        for up in (False, True):
            ours = fused.fused_inverse_plane(torch.from_numpy(zz_kt), tables[c],
                                             tw, upsample_cols=up)
            theirs = jax_fused.fused_inverse_plane_jnp(
                jnp.asarray(zz_kt), tables[c], tw, upsample_cols=up)
            _assert_envelope(ours.numpy(), theirs)


def test_plane_chain_matches_tile_path():
    """fused_forward_plane → K5's plain version gives the packed16 words of
    the sparse16 encode; K7's plain version → fused_inverse_plane →
    ycbcr_planes_to_rgb decodes within the envelope of the pipeline."""
    _, pipe = _pipes()
    rgbs = np.stack([_image(32, 48, seed=s) for s in (8, 9)])
    (p0, p1) = pipe.to_packed16(pipe.encode_batch(rgbs, entropy=False))
    y, cr, cb = color.rgb_to_ycbcr(torch.from_numpy(rgbs))
    planes = {"lum": y, "r": color.chroma_subsample_422(cr),
              "b": color.chroma_subsample_422(cb)}
    out = {}
    for c, tw in (("lum", 8), ("r", 4), ("b", 4)):
        zz_kt = fused.fused_forward_plane(planes[c], pipe._tables[c], tw)
        words, lengths = pack16_encode_kt(zz_kt.to(torch.int16))
        assert np.array_equal(words.numpy().view(np.uint16),
                              np.concatenate([p0.rle[c], p1.rle[c]]))
        bw = zz_kt.shape[2]
        back = pack16_decode_plane(words, lengths, bw)
        assert np.array_equal(back.numpy(), zz_kt.numpy())
        out[c] = fused.fused_inverse_plane(back, pipe._tables[c], tw,
                                           upsample_cols=(c != "lum"))
        out[c] = out[c].reshape(2, 32, 48)
    rgb = color.ycbcr_planes_to_rgb(out["lum"], out["r"], out["b"], 32, 48)
    for a, b in zip(rgb.numpy(), pipe.decode_batch(pipe.encode_batch(rgbs))):
        _assert_envelope(a, b)
