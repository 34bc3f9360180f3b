"""The JPEG-style pipeline on PyTorch.

Port of ``lz4jpeg_tpu/models/jpeg.py`` for
``JPEGConfig(precision="fast", entropy="shared")``, in its three RLE layouts
(``ops/rle.py``):

* sparse16, for quant tables whose entries are all ≥ 3 (the reference tables
  and quality 1–79).  Encode: (B, H, W, 3) uint8 → ``forward_combined``
  (color, 4:2:2, DCT + quantize + zigzag as one basis product, sparse-delta
  RLE; the Hopper kernel K1 on a CUDA device) → one (N, 128) uint16 buffer
  per frame → native shared-codebook Huffman → ``pack_container``.  Decode:
  native ``huff_unpack_sparse16`` → the folded inverse einsum
  (``fused_inverse_plane_sparse``; the RLE prefix sum and the 4:2:2
  upsample live in the basis) → ``ycbcr_planes_to_rgb``.
* int16 pairs, for tables with an entry below 3 (quality 80–100).  Encode:
  ``split_mcus`` → ``fused_forward`` per channel → ``rle_encode_batched``
  (plain torch: the JAX package has no kernel there either) → native pair
  Huffman.  Decode: the staged tile inverse, below.
* packed16, one word per pair: what ``unpack_container`` gives for streams
  the sparse16 walker rejects, and what ``to_packed16`` makes of sparse16
  encodes (K4 on a CUDA device).  Decode: the staged tile inverse.

The staged tile inverse: ``rle_decode_packed16`` (K6 on a CUDA device) or
``rle_decode_batched`` → ``fused_inverse`` → ``ycbcr_to_rgb_mcus``.

The pipeline runs where its ``device`` says and nowhere else: a CUDA
pipeline launches its kernels or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import JPEGConfig, sparse16_eligible
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
    ycbcr_planes_to_rgb,
    ycbcr_to_rgb_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    forward_basis,
    fused_forward,
    fused_inverse,
    fused_inverse_plane_sparse,
    inverse_basis,
    inverse_suffix_basis,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    CHANNEL_SLICES,
    COMBINED_LANES,
    forward_combined,
    kt_bases,
)
from lz4jpeg_tpu_torch.ops.huffman import (
    CanonicalCodebook,
    build_canonical_codebook_from_counts,
    unpack_symbols,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    scale_table,
)
from lz4jpeg_tpu_torch.ops.rle import (
    PACK16_VALUE_BIAS,
    SPARSE16_DELTA_BIAS,
    rle_decode_batched,
    rle_decode_packed16,
    rle_decode_sparse16,
    rle_encode_batched,
    sparse16_to_packed16,
)

CHANNELS = ("lum", "r", "b")
_CHANNEL_SHAPES = {"lum": (8, 8), "r": (8, 4), "b": (8, 4)}
# Histogram offset of the native walks: symbols are run counts or
# coefficients, all inside [-2048, 2048).
_SYMBOL_OFFSET = 2048


def scaled_tables(quality):
    """Per-channel quant tables for a quality setting (None = reference)."""
    lum_t = scale_table(LUMINANCE_QUANTIZATION_TABLE, quality)
    chr_t = scale_table(CHROMINANCE_QUANTIZATION_TABLE, quality)
    return {"lum": lum_t, "r": chr_t, "b": chr_t}


def tables_from_numpy(tables: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The JAX pipeline's ``_tables`` (as numpy) → the port's tables.

    The quant tables are the codec's parameters; every basis derives from
    them.  Checks channel names, shapes and integer values."""
    out = {}
    for c in CHANNELS:
        h, w = _CHANNEL_SHAPES[c]
        t = np.asarray(tables[c])
        if t.shape != (h * w,):
            raise ValueError(f"table {c!r} has shape {t.shape}, want ({h * w},)")
        if not np.array_equal(t, np.round(t)) or t.min() < 1:
            raise ValueError(f"table {c!r} must hold positive integers")
        out[c] = t.astype(np.int64)
    return out


@dataclasses.dataclass
class JPEGEncoded:
    """Encoded image: per-channel RLE streams plus the shared-codebook
    bitstreams."""

    height: int
    width: int
    blocks_per_col: int
    blocks_per_row: int
    # Per channel: (N, 2L) int32 [count, value] pairs; or (N, L) uint16
    # packed16 words; or (N, K) uint16 sparse-delta views into
    # ``rle_combined``.
    rle: Dict[str, np.ndarray]
    # Per-channel (N,) symbol counts (2·runs); sparse16 leaves them None
    # until the entropy walk.
    rle_lengths: Optional[Dict[str, np.ndarray]]
    entropy_mode: Optional[str] = None
    # ``rle`` holds packed16 words ((count - 1) << 10 | value + 512).
    rle_packed16: bool = False
    # ``rle`` holds the sparse-delta layout (views into ``rle_combined``).
    rle_sparse16: bool = False
    # sparse16: the (N, 128) uint16 buffer the views slice (64 luma + 32 Cr
    # + 32 Cb).
    rle_combined: Optional[np.ndarray] = None
    # shared mode: per-channel (codebook, packed bytes, bit count).
    shared_streams: Optional[Dict[str, Tuple[CanonicalCodebook, bytes, int]]] = None
    # Quality the quant tables were scaled with (None = reference tables).
    quality: Optional[int] = None

    @property
    def num_blocks(self) -> int:
        return self.blocks_per_col * self.blocks_per_row

    def compressed_bytes(self) -> int:
        """Size of the entropy-coded representation in bytes."""
        if self.entropy_mode != "shared":
            raise ValueError("no entropy stage was run")
        return sum(
            len(cb.serialize()) + len(packed)
            for cb, packed, _ in self.shared_streams.values()
        )


def _layout_of(enc: JPEGEncoded) -> str:
    if enc.rle_sparse16:
        return "sparse16"
    return "packed16" if enc.rle_packed16 else "pairs"


class JPEGPipeline:
    """Batched encode/decode of the JPEG-style codec on one device."""

    def __init__(
        self,
        config: JPEGConfig,
        device,
        tables: Optional[Dict[str, np.ndarray]] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device} requested but CUDA is not available"
            )
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        # IEEE float32 for every product: TF32 flips quantized coefficients.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self._tables = scaled_tables(config.quality)
        if tables is not None:
            given = tables_from_numpy(tables)
            if any(not np.array_equal(given[c], self._tables[c]) for c in CHANNELS):
                # Containers record only the quality byte; decode rebuilds
                # the tables from it, so other tables would not round-trip.
                raise ValueError(
                    f"tables do not match quality={config.quality}"
                )
            self._tables = given
        # The layout encode writes: sparse16 when the tables bound every
        # quantized value to 10 bits, else int16 pairs.
        self.sparse16 = sparse16_eligible(self._tables.values())

    def bases(self) -> dict:
        """The numpy bases this pipeline's encode and decode run: sparse16,
        the forward kernel's ``kt_bases`` and each channel's
        ``inverse_suffix_basis``; pairs, each channel's ``forward_basis``
        (matrix, offset) and ``inverse_basis``."""
        keys = {c: _table_key(t) for c, t in self._tables.items()}
        widths = {c: _CHANNEL_SHAPES[c][1] for c in CHANNELS}
        if self.sparse16:
            return {
                "forward": kt_bases(keys["lum"], keys["r"]),
                "inverse": {
                    c: inverse_suffix_basis(widths[c], 8, keys[c])
                    for c in CHANNELS
                },
            }
        return {
            "forward": {c: forward_basis(widths[c], 8, keys[c]) for c in CHANNELS},
            "inverse": {c: inverse_basis(widths[c], 8, keys[c]) for c in CHANNELS},
        }

    # ------------------------------------------------------------------
    # Encode
    # ------------------------------------------------------------------

    def _wrap_sparse(
        self, combined: np.ndarray, h: int, w: int, bpc: int, bpr: int
    ) -> JPEGEncoded:
        """(N, 128) combined uint16 buffer → JPEGEncoded with per-channel
        views (no copies; lengths stay lazy until the entropy walk)."""
        return JPEGEncoded(
            height=h,
            width=w,
            blocks_per_col=bpc,
            blocks_per_row=bpr,
            rle={c: combined[:, CHANNEL_SLICES[c]] for c in CHANNELS},
            rle_lengths=None,
            rle_sparse16=True,
            rle_combined=combined,
            quality=self.config.quality,
        )

    def encode(self, rgb, entropy: bool = True) -> JPEGEncoded:
        """Encode one (H, W, 3) uint8 image (numpy or tensor)."""
        return self.encode_batch(torch.as_tensor(rgb)[None], entropy)[0]

    def encode_batch(self, rgbs, entropy: bool = True) -> List[JPEGEncoded]:
        """Encode a (B, H, W, 3) batch of same-size images in one pass on
        the device (one forward launch in the sparse16 layout)."""
        x = torch.as_tensor(rgbs)
        if x.dim() != 4:
            raise ValueError(f"expected a (B, H, W, 3) batch, got {tuple(x.shape)}")
        b, h, w = x.shape[:3]
        bpc, bpr = -(-h // 8), -(-w // 8)
        x = x.to(self.device).contiguous()
        if self.sparse16:
            combined = forward_combined(x, self._tables["lum"], self._tables["r"])
            host = (
                combined.cpu().numpy().view(np.uint16)
                .reshape(b, bpc * bpr, COMBINED_LANES)
            )
            encs = [self._wrap_sparse(host[i], h, w, bpc, bpr) for i in range(b)]
        else:
            encs = self._encode_pairs(x, bpc, bpr)
        if entropy:
            for enc in encs:
                self.entropy_encode(enc)
        return encs

    def _encode_pairs(self, x: torch.Tensor, bpc: int, bpr: int):
        """(B, H, W, 3) uint8 on the device → int16 pair encodes: color,
        4:2:2, ``split_mcus``, ``fused_forward`` per channel,
        ``rle_encode_batched`` (JAX ``_forward_impl`` + ``_forward_rle_impl``)."""
        b, h, w = x.shape[:3]
        y, cr, cb = rgb_to_ycbcr(x)
        tiles = split_mcus(y, chroma_subsample_422(cr), chroma_subsample_422(cb))
        rle, lengths = {}, {}
        for c, t in zip(CHANNELS, tiles):
            th, tw = _CHANNEL_SHAPES[c]
            zz = fused_forward(t, self._tables[c], tw, th)
            pairs, lens = rle_encode_batched(zz.to(torch.int16))
            rle[c] = pairs.cpu().numpy().reshape(b, bpc * bpr, -1)
            lengths[c] = lens.cpu().numpy().reshape(b, bpc * bpr)
        return [
            JPEGEncoded(
                height=h, width=w, blocks_per_col=bpc, blocks_per_row=bpr,
                rle={c: rle[c][i] for c in CHANNELS},
                rle_lengths={c: lengths[c][i] for c in CHANNELS},
                quality=self.config.quality,
            )
            for i in range(b)
        ]

    def to_packed16(self, encs: List[JPEGEncoded]) -> List[JPEGEncoded]:
        """Same-size sparse16 encodes → packed16 encodes of the same runs
        (no entropy stage yet): one upload of the combined buffers, then per
        channel ``sparse16_to_packed16`` on the device (K4 on a CUDA
        device).  Their containers equal the sparse16 ones byte for byte."""
        e0 = encs[0]
        for e in encs:
            if not e.rle_sparse16 or e.rle_combined is None:
                raise ValueError("to_packed16 takes sparse16 encodes")
            if (e.height, e.width) != (e0.height, e0.width):
                raise ValueError("to_packed16 takes same-size encodes")
        comb = np.stack([e.rle_combined for e in encs]).view(np.int16)
        comb = torch.from_numpy(comb).to(self.device)
        rle, lengths = {}, {}
        for c in CHANNELS:
            sl = CHANNEL_SLICES[c]
            packed, lens = sparse16_to_packed16(
                comb[..., sl].reshape(-1, sl.stop - sl.start)
            )
            rle[c] = packed.cpu().numpy().view(np.uint16).reshape(len(encs), -1,
                                                                 packed.shape[1])
            lengths[c] = lens.cpu().numpy().reshape(len(encs), -1)
        return [
            JPEGEncoded(
                height=e.height, width=e.width,
                blocks_per_col=e.blocks_per_col, blocks_per_row=e.blocks_per_row,
                rle={c: rle[c][i] for c in CHANNELS},
                rle_lengths={c: lengths[c][i] for c in CHANNELS},
                rle_packed16=True,
                quality=e.quality,
            )
            for i, e in enumerate(encs)
        ]

    def entropy_encode(self, enc: JPEGEncoded) -> JPEGEncoded:
        """Shared-codebook Huffman of each channel: one native histogram walk
        (which, in the sparse16 layout, also yields the per-block symbol
        lengths), the canonical codebook, one native pack."""
        native = native_backend()
        enc.entropy_mode = "shared"
        enc.shared_streams = {}
        if enc.rle_sparse16:
            enc.rle_lengths = {}
        for c in CHANNELS:
            if enc.rle_sparse16:
                row_len = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                if enc.rle_combined is not None:
                    buf, col = enc.rle_combined, CHANNEL_SLICES[c].start
                else:
                    buf, col = np.ascontiguousarray(enc.rle[c]), 0
                counts, lens_c, total = native.rle_symbol_hist_sparse16(
                    buf, col, row_len, _SYMBOL_OFFSET, 2 * _SYMBOL_OFFSET,
                )
                enc.rle_lengths[c] = lens_c
            elif enc.rle_packed16:
                counts, _ = native.rle_symbol_hist16(
                    enc.rle[c], enc.rle_lengths[c], _SYMBOL_OFFSET,
                    2 * _SYMBOL_OFFSET,
                )
            else:
                counts, _ = native.rle_symbol_hist(
                    enc.rle[c], enc.rle_lengths[c], _SYMBOL_OFFSET,
                    2 * _SYMBOL_OFFSET,
                )
            (bins,) = np.nonzero(counts)
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - _SYMBOL_OFFSET, counts[bins]
            )
            if enc.rle_sparse16:
                packed, nbits = native.huff_pack_sparse16(
                    buf, col, row_len, codebook, total
                )
            elif enc.rle_packed16:
                packed, nbits = native.huff_pack_pairs16(
                    enc.rle[c], enc.rle_lengths[c], codebook
                )
            else:
                packed, nbits = native.huff_pack_pairs(
                    enc.rle[c], enc.rle_lengths[c], codebook
                )
            enc.shared_streams[c] = (codebook, packed, nbits)
        return enc

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def entropy_decode(self, enc: JPEGEncoded):
        """Recover the RLE streams from the bitstreams, in the encode's own
        layout: returns (rle, lengths).  sparse16 rebuilds the combined
        buffer in place (refreshing ``enc.rle_combined``, ``enc.rle`` and
        ``enc.rle_lengths``); a channel the strict native walker rejects goes
        through ``unpack_symbols`` and the host re-blocking instead."""
        native = native_backend()
        if enc.rle_sparse16:
            combined = np.zeros((enc.num_blocks, COMBINED_LANES), np.uint16)
            lengths = {}
            for c in CHANNELS:
                codebook, packed, nbits = enc.shared_streams[c]
                block_size = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
                got = native.huff_unpack_sparse16(
                    packed, nbits, codebook, block_size, enc.num_blocks,
                    out_sparse=combined, col_off=CHANNEL_SLICES[c].start,
                )
                if got is None:
                    symbols = unpack_symbols(packed, nbits, codebook)
                    pairs, lens = _split_symbols(
                        symbols, enc.num_blocks, 2 * block_size, block_size
                    )
                    sp, lens = _pairs_to_sparse_host(pairs, lens, block_size)
                    combined[:, CHANNEL_SLICES[c]] = sp
                    lengths[c] = lens
                else:
                    lengths[c] = got[1]
            enc.rle_combined = combined
            enc.rle = {c: combined[:, CHANNEL_SLICES[c]] for c in CHANNELS}
            enc.rle_lengths = lengths
            return enc.rle, lengths
        rle, lengths = {}, {}
        for c in CHANNELS:
            codebook, packed, nbits = enc.shared_streams[c]
            pad_width = enc.rle[c].shape[1]
            block_size = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
            unpack = (native.huff_unpack_pairs16 if enc.rle_packed16
                      else native.huff_unpack_pairs)
            got = unpack(packed, nbits, codebook, block_size, enc.num_blocks,
                         pad_width)
            if got is None:
                # The Python spec path: the quirk-compatible handler of
                # streams the strict native walker rejects.
                symbols = unpack_symbols(packed, nbits, codebook)
                sym_pad = 2 * pad_width if enc.rle_packed16 else pad_width
                pairs, lens = _split_symbols(
                    symbols, enc.num_blocks, sym_pad, block_size
                )
                got = (_pack16_host(pairs), lens) if enc.rle_packed16 else (pairs, lens)
            rle[c], lengths[c] = got
        return rle, lengths

    def _inverse_sparse(
        self, combined: torch.Tensor, bpc: int, bpr: int,
        height: int, width: int,
    ) -> torch.Tensor:
        """(B, N, 128) sparse deltas → (B, height, width, 3) uint8 RGB: per
        channel one folded-basis einsum, then the color merge."""
        b = combined.shape[0]
        w16 = combined.to(torch.int32)
        d = torch.where(w16 != 0, w16 - SPARSE16_DELTA_BIAS, 0)
        planes = {}
        for name in CHANNELS:
            tw = _CHANNEL_SHAPES[name][1]
            d_kt = d[..., CHANNEL_SLICES[name]].reshape(b * bpc, bpr, 8 * tw)
            plane = fused_inverse_plane_sparse(
                d_kt.transpose(1, 2), self._tables[name], tw,
                upsample_cols=(name != "lum"),
            )
            planes[name] = plane.reshape(b, 8 * bpc, 8 * bpr)
        return ycbcr_planes_to_rgb(
            planes["lum"], planes["r"], planes["b"], height, width
        )

    def _inverse_staged(
        self, rle: Dict[str, torch.Tensor], lengths: Dict[str, torch.Tensor],
        layout: str, bpc: int, bpr: int, height: int, width: int,
    ) -> torch.Tensor:
        """(B, N, ·) RLE streams and (B, N) lengths on the device → (B,
        height, width, 3) uint8 RGB through the staged tile path: RLE
        expansion (K6 for packed16 on a CUDA device), ``fused_inverse``,
        ``ycbcr_to_rgb_mcus`` (JAX ``_inverse_impl`` :437-446)."""
        tiles = {}
        for c in CHANNELS:
            th, tw = _CHANNEL_SHAPES[c]
            b, n, k = rle[c].shape
            zz = _rle_decode_fn(
                rle[c].reshape(b * n, k), lengths[c].reshape(b * n),
                th * tw, layout,
            )
            tiles[c] = fused_inverse(zz, self._tables[c], tw, th).reshape(
                b, n, th, tw
            )
        return ycbcr_to_rgb_mcus(
            tiles["lum"], tiles["r"], tiles["b"], bpc, bpr, height, width
        )

    def decode(self, enc: JPEGEncoded, from_entropy: bool = True) -> np.ndarray:
        return self.decode_batch([enc], from_entropy)[0]

    def decode_batch(
        self, encs: List[JPEGEncoded], from_entropy: bool = True
    ) -> List[np.ndarray]:
        """Decode same-size encodes of one RLE layout with one inverse pass
        on the device."""
        if not encs:
            return []
        e0 = encs[0]
        key = (e0.height, e0.width, _layout_of(e0))
        for e in encs:
            if (e.height, e.width, _layout_of(e)) != key:
                raise ValueError(
                    "decode_batch requires same-size encodes with one RLE "
                    "layout; decode() them individually instead"
                )
            if e.quality != self.config.quality:
                raise ValueError(
                    f"encode has quality={e.quality}, pipeline has "
                    f"quality={self.config.quality}"
                )
        streams = [
            self.entropy_decode(e) if from_entropy and e.entropy_mode is not None
            else (e.rle, e.rle_lengths)
            for e in encs
        ]
        bpc, bpr = e0.blocks_per_col, e0.blocks_per_row
        if key[2] == "sparse16" and all(e.rle_combined is not None for e in encs):
            combined = np.stack([e.rle_combined for e in encs]).view(np.int16)
            rgb = self._inverse_sparse(
                torch.from_numpy(combined).to(self.device),
                bpc, bpr, e0.height, e0.width,
            )
        else:
            rle, lengths = {}, {}
            for c in CHANNELS:
                arr = np.stack([np.ascontiguousarray(s[0][c]) for s in streams])
                if arr.dtype == np.uint16:
                    arr = arr.view(np.int16)
                rle[c] = torch.from_numpy(arr).to(self.device)
                lengths[c] = torch.from_numpy(np.stack([
                    np.asarray(s[1][c], np.int32) if s[1] is not None
                    else np.zeros(arr.shape[1], np.int32)
                    for s in streams
                ])).to(self.device)
            rgb = self._inverse_staged(rle, lengths, key[2], bpc, bpr,
                                       e0.height, e0.width)
        rgb = rgb.cpu().numpy()
        return [rgb[i] for i in range(len(encs))]

    def roundtrip(self, rgb) -> np.ndarray:
        """Full encode → decode."""
        return self.decode(self.encode(rgb))


def _rle_decode_fn(rle: torch.Tensor, lengths: torch.Tensor, out_size: int,
                   layout: str) -> torch.Tensor:
    """Staged-path RLE expansion of one channel: (N, ·) streams → (N,
    out_size) int32 zigzag values."""
    if layout == "sparse16":
        return rle_decode_sparse16(rle)
    if layout == "packed16":
        return rle_decode_packed16(rle, lengths, out_size)
    return rle_decode_batched(rle, lengths, out_size)


# ---------------------------------------------------------------------------
# Host helpers (numpy), copies of the JAX package's
# ---------------------------------------------------------------------------


def _unpack16_host(packed: np.ndarray) -> np.ndarray:
    """(N, L) packed16 words → (N, 2L) interleaved int32 pairs."""
    p = packed.astype(np.int32)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (p >> 10) + 1
    out[:, 1::2] = (p & 0x3FF) - PACK16_VALUE_BIAS
    return out


def _pack16_host(pairs: np.ndarray) -> np.ndarray:
    """(N, 2L) interleaved int32 pairs → (N, L) uint16 packed16 words
    (padding slots stay 0, as ``ops/rle.py::pack16_pairs``)."""
    counts = pairs[:, 0::2].astype(np.int32)
    vals = pairs[:, 1::2].astype(np.int32)
    packed = (np.maximum(counts - 1, 0) << 10) | (vals + PACK16_VALUE_BIAS)
    return np.where(counts > 0, packed, 0).astype(np.uint16)


def _valid_symbols(pairs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Flatten padded (N, 2L) RLE pairs into one symbol stream."""
    mask = np.arange(pairs.shape[1])[None, :] < lengths[:, None]
    return pairs[mask].astype(np.int32)


def _split_symbols(
    symbols: np.ndarray, num_blocks: int, pad_width: int, block_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Re-block a flat [count, value, ...] symbol stream: pair j belongs to
    block ``(ends[j] - 1) // block_size`` where ``ends`` is the running count
    total, so a block's pairs end once their counts reach its size."""
    pairs = np.zeros((num_blocks, pad_width), np.int32)
    lengths = np.zeros(num_blocks, np.int32)
    counts = symbols[0::2].astype(np.int64)
    values = symbols[1::2].astype(np.int64)
    ends = np.cumsum(counts)
    block_of_pair = (ends - 1) // block_size
    starts = np.searchsorted(block_of_pair, np.arange(num_blocks), "left")
    stops = np.searchsorted(block_of_pair, np.arange(num_blocks), "right")
    lengths[:] = 2 * (stops - starts)
    slot = np.arange(len(counts)) - starts[block_of_pair]
    flat_idx = block_of_pair * pad_width + 2 * slot
    pairs.reshape(-1)[flat_idx] = counts
    pairs.reshape(-1)[flat_idx + 1] = values
    return pairs, lengths


def _pairs_to_sparse_host(
    pairs: np.ndarray, lengths: np.ndarray, block_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 2K) int pairs + lengths → ((N, block_size) uint16 sparse deltas,
    lengths).  Raises ``ValueError`` where a run's start is no index of its
    block (the JAX helper lets numpy's IndexError escape there; a start in
    [-block_size, 0) indexes from the end in both)."""
    pairs = np.asarray(pairs, np.int64)
    counts = pairs[:, 0::2]
    vals = pairs[:, 1::2]
    k = counts.shape[1]
    valid = np.arange(k)[None, :] < (np.asarray(lengths) // 2)[:, None]
    counts = np.where(valid, counts, 0)
    starts_pos = np.cumsum(counts, axis=1) - counts  # run start positions
    prev_vals = np.zeros_like(vals)
    prev_vals[:, 1:] = vals[:, :-1]
    deltas = np.where(valid, vals - prev_vals, 0)
    rows, slots = np.nonzero(valid)
    at = starts_pos[rows, slots]
    outside = (at < -block_size) | (at >= block_size)
    if outside.any():
        bad = int(np.argmax(outside))
        raise ValueError(
            f"block {int(rows[bad])}: run {int(slots[bad])} starts at "
            f"{int(at[bad])}, outside the {block_size}-slot block"
        )
    sp = np.zeros((pairs.shape[0], block_size), np.uint16)
    sp[rows, at] = (deltas[rows, slots] + SPARSE16_DELTA_BIAS).astype(np.uint16)
    return sp, np.asarray(lengths, np.int32)
