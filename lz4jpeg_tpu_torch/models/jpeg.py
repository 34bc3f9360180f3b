"""The JPEG-style pipeline on PyTorch: the sparse16 fast path.

Port of ``lz4jpeg_tpu/models/jpeg.py`` for
``JPEGConfig(precision="fast", entropy="shared")``:

* encode: (B, H, W, 3) uint8 → ``forward_combined`` (color, 4:2:2, DCT +
  quantize + zigzag as one basis product, sparse-delta RLE; the Hopper
  kernel on a CUDA device) → one (N, 128) uint16 buffer per frame → native
  shared-codebook Huffman (``native.py``) → ``pack_container``;
* decode: native ``huff_unpack_sparse16`` → the folded inverse einsum
  (``ops/fused.py::fused_inverse_plane_sparse``; the RLE prefix sum and the
  4:2:2 upsample live in the basis) → ``ycbcr_planes_to_rgb``, as torch ops
  on the pipeline's device.

The pipeline runs where its ``device`` says and nowhere else: a CUDA
pipeline launches the forward kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import JPEGConfig
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.color import ycbcr_planes_to_rgb
from lz4jpeg_tpu_torch.ops.fused import (
    _table_key,
    fused_inverse_plane_sparse,
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
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    scale_table,
)
from lz4jpeg_tpu_torch.ops.rle import SPARSE16_DELTA_BIAS

CHANNELS = ("lum", "r", "b")
_CHANNEL_SHAPES = {"lum": (8, 8), "r": (8, 4), "b": (8, 4)}
# Histogram offset of the native walk: symbols are run counts ≤ 64 or
# coefficients |v| ≤ 511, all inside [-2048, 2048).
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
    """Encoded image: sparse16 streams plus the shared-codebook bitstreams."""

    height: int
    width: int
    blocks_per_col: int
    blocks_per_row: int
    # Per-channel (N, K) uint16 sparse-delta views into ``rle_combined``.
    rle: Dict[str, np.ndarray]
    # Per-channel (N,) symbol counts (2·runs); None until the entropy walk.
    rle_lengths: Optional[Dict[str, np.ndarray]]
    entropy_mode: Optional[str] = None
    # The (N, 128) uint16 buffer the views slice (64 luma + 32 Cr + 32 Cb).
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


class JPEGPipeline:
    """Batched encode/decode of the sparse16 fast path on one device."""

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

    def bases(self) -> dict:
        """The numpy bases this pipeline runs: the forward kernel's
        ``kt_bases`` and each channel's ``inverse_suffix_basis``."""
        keys = {c: _table_key(t) for c, t in self._tables.items()}
        return {
            "forward": kt_bases(keys["lum"], keys["r"]),
            "inverse": {
                c: inverse_suffix_basis(_CHANNEL_SHAPES[c][1], 8, keys[c])
                for c in CHANNELS
            },
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
            rle_combined=combined,
            quality=self.config.quality,
        )

    def encode(self, rgb, entropy: bool = True) -> JPEGEncoded:
        """Encode one (H, W, 3) uint8 image (numpy or tensor)."""
        return self.encode_batch(torch.as_tensor(rgb)[None], entropy)[0]

    def encode_batch(self, rgbs, entropy: bool = True) -> List[JPEGEncoded]:
        """Encode a (B, H, W, 3) batch of same-size images with one
        forward launch."""
        x = torch.as_tensor(rgbs)
        if x.dim() != 4:
            raise ValueError(f"expected a (B, H, W, 3) batch, got {tuple(x.shape)}")
        b, h, w = x.shape[:3]
        bpc, bpr = -(-h // 8), -(-w // 8)
        combined = forward_combined(
            x.to(self.device).contiguous(), self._tables["lum"], self._tables["r"]
        )
        host = (
            combined.cpu().numpy().view(np.uint16)
            .reshape(b, bpc * bpr, COMBINED_LANES)
        )
        out = []
        for i in range(b):
            enc = self._wrap_sparse(host[i], h, w, bpc, bpr)
            if entropy:
                self.entropy_encode(enc)
            out.append(enc)
        return out

    def entropy_encode(self, enc: JPEGEncoded) -> JPEGEncoded:
        """Shared-codebook Huffman of each channel: one native histogram
        walk over the combined buffer in place (which also yields the
        per-block symbol lengths), the canonical codebook, one native pack."""
        native = native_backend()
        enc.entropy_mode = "shared"
        enc.shared_streams = {}
        enc.rle_lengths = {}
        for c in CHANNELS:
            row_len = _CHANNEL_SHAPES[c][0] * _CHANNEL_SHAPES[c][1]
            col = CHANNEL_SLICES[c].start
            counts, lens_c, total = native.rle_symbol_hist_sparse16(
                enc.rle_combined, col, row_len, _SYMBOL_OFFSET,
                2 * _SYMBOL_OFFSET,
            )
            (bins,) = np.nonzero(counts)
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - _SYMBOL_OFFSET, counts[bins]
            )
            packed, nbits = native.huff_pack_sparse16(
                enc.rle_combined, col, row_len, codebook, total
            )
            enc.shared_streams[c] = (codebook, packed, nbits)
            enc.rle_lengths[c] = lens_c
        return enc

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def entropy_decode(self, enc: JPEGEncoded):
        """Rebuild the combined sparse16 buffer from the bitstreams (in
        place: refreshes ``enc.rle_combined``, ``enc.rle`` and
        ``enc.rle_lengths``)."""
        native = native_backend()
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
                raise ValueError(
                    f"channel {c!r} is not a canonical sparse16 stream (the "
                    "pair-layout fallbacks are not ported)"
                )
            lengths[c] = got[1]
        enc.rle_combined = combined
        enc.rle = {c: combined[:, CHANNEL_SLICES[c]] for c in CHANNELS}
        enc.rle_lengths = lengths
        return enc.rle, lengths

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

    def decode(self, enc: JPEGEncoded, from_entropy: bool = True) -> np.ndarray:
        return self.decode_batch([enc], from_entropy)[0]

    def decode_batch(
        self, encs: List[JPEGEncoded], from_entropy: bool = True
    ) -> List[np.ndarray]:
        """Decode same-size encodes with one inverse pass on the device."""
        if not encs:
            return []
        e0 = encs[0]
        for e in encs:
            if (e.height, e.width) != (e0.height, e0.width):
                raise ValueError(
                    "decode_batch requires same-size encodes; decode() them "
                    "individually instead"
                )
            if e.quality != self.config.quality:
                raise ValueError(
                    f"encode has quality={e.quality}, pipeline has "
                    f"quality={self.config.quality}"
                )
            if from_entropy and e.entropy_mode is not None:
                self.entropy_decode(e)
        combined = np.stack([e.rle_combined for e in encs]).view(np.int16)
        rgb = self._inverse_sparse(
            torch.from_numpy(combined).to(self.device),
            e0.blocks_per_col, e0.blocks_per_row, e0.height, e0.width,
        )
        rgb = rgb.cpu().numpy()
        return [rgb[i] for i in range(len(encs))]

    def roundtrip(self, rgb) -> np.ndarray:
        """Full encode → decode."""
        return self.decode(self.encode(rgb))
