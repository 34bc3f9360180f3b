"""The JPEG-style pipeline on PyTorch.

Port of ``lz4jpeg_tpu/models/jpeg.py``: every ``JPEGConfig`` (precision
"fast" or "exact", entropy "shared" or "per_block", any quality), in three
RLE layouts (``ops/rle.py``):

* sparse16, for fast, shared pipelines whose quant tables have every entry
  ≥ 3 (the reference tables and quality 1–79).  Encode: (B, H, W, 3) uint8
  → ``forward_combined`` (color, 4:2:2, DCT + quantize + zigzag as one basis
  product, sparse-delta RLE; the Hopper kernel K1 on a CUDA device) → one
  (N, 128) uint16 buffer per frame → native shared-codebook Huffman →
  ``pack_container``.  ``encode`` of one frame of at least
  ``_OVERLAP_MIN_BLOCKS`` blocks overlaps the copy to the host, in bands,
  with the native histogram walk (``_encode_overlapped``).  Decode: native
  ``huff_unpack_sparse16`` → the folded inverse einsum
  (``fused_inverse_plane_sparse``; the RLE prefix sum and the 4:2:2
  upsample live in the basis) → ``ycbcr_planes_to_rgb``.
* int16 pairs, for every other pipeline: exact precision, per-block
  entropy, or a table entry below 3 (quality 80–100).  Encode: color,
  4:2:2, ``split_mcus``, ``forward_channel`` per channel (fused float32
  basis product, or in exact mode the staged float64 DCT → quantize →
  zigzag), ``rle_encode_batched``, then native pair Huffman (shared) or the
  reference's per-block trees (``huff_per_block``).  Decode: the staged tile
  inverse, below.
* packed16, one word per pair: what ``unpack_container`` gives for streams
  the sparse16 walker rejects, and what ``to_packed16`` makes of sparse16
  encodes (K4 on a CUDA device).  Decode: the staged tile inverse.

The staged tile inverse: ``rle_decode_packed16`` (K6 on a CUDA device),
``rle_decode_sparse16`` or ``rle_decode_batched`` → ``inverse_channel`` →
``ycbcr_to_rgb_mcus``.  An exact pipeline decodes every layout this way, in
float64, sparse16 included.

``encode_bucketed`` and ``decode_bucketed`` pad the MCU batch to a power of
two around the same chains (the JAX package bounds its compiles that way;
PyTorch compiles nothing, so they only keep the API and its results), and
``warmup`` builds the kernel libraries an encode reaches.

The pipeline runs where its ``device`` says and nowhere else: a CUDA
pipeline launches its kernels or raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lz4jpeg_tpu_torch.config import JPEGConfig, sparse16_eligible
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.oracle import jpeg_oracle
from lz4jpeg_tpu_torch.ops import fwd_megakernel
from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
    ycbcr_planes_to_rgb,
    ycbcr_to_rgb_mcus,
)
from lz4jpeg_tpu_torch.ops.dct import dct2_batched, idct2_batched
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
    concat_bitstreams,
    unpack_symbols,
)
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    dequantize,
    quantize,
    scale_table,
)
from lz4jpeg_tpu_torch.ops.rle import (
    PACK16_VALUE_BIAS,
    SPARSE16_DELTA_BIAS,
    rle_decode_batched,
    rle_decode_packed16,
    rle_decode_sparse16,
    rle_encode_batched,
    rle_encode_sparse16,
    sparse16_to_packed16,
)
from lz4jpeg_tpu_torch.ops.zigzag import reverse_zigzag, zigzag

CHANNELS = ("lum", "r", "b")
_CHANNEL_SHAPES = {"lum": (8, 8), "r": (8, 4), "b": (8, 4)}
# Histogram offset of the native walks: symbols are run counts or
# coefficients, all inside [-2048, 2048).
_SYMBOL_OFFSET = 2048


def _row_len(c: str) -> int:
    """Coefficients per block of channel ``c`` (64 luma, 32 chroma)."""
    h, w = _CHANNEL_SHAPES[c]
    return h * w


def scaled_tables(quality):
    """Per-channel quant tables for a quality setting (None = reference)."""
    lum_t = scale_table(LUMINANCE_QUANTIZATION_TABLE, quality)
    chr_t = scale_table(CHROMINANCE_QUANTIZATION_TABLE, quality)
    return {"lum": lum_t, "r": chr_t, "b": chr_t}


def forward_channel(tiles: torch.Tensor, name: str, tables, dtype,
                    fused: bool) -> torch.Tensor:
    """One channel's (N, h, w) uint8 MCU tiles → (N, h·w) quantized zigzag
    coefficients in ``dtype``: the fused basis product (fast precision), or
    the staged DCT → quantize → zigzag (exact precision).  The one
    fused-vs-staged dispatch of every forward variant."""
    h, w = _CHANNEL_SHAPES[name]
    if fused:
        return fused_forward(tiles, tables[name], w, h, dtype)
    coeff = dct2_batched(tiles, dtype)
    q = quantize(coeff, np.asarray(tables[name]).reshape(h, w))
    return zigzag(q, w, h)


def inverse_channel(zz: torch.Tensor, name: str, tables, dtype,
                    fused: bool) -> torch.Tensor:
    """One channel's (N, h·w) zigzag stream → (N, h, w) uint8 pixel tiles
    (the inverse of ``forward_channel``)."""
    h, w = _CHANNEL_SHAPES[name]
    if fused:
        return fused_inverse(zz, tables[name], w, h, dtype)
    blocks = reverse_zigzag(zz.to(dtype), w, h)
    deq = dequantize(blocks.reshape(-1, h, w),
                     np.asarray(tables[name]).reshape(h, w))
    return idct2_batched(deq, dtype)


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
    """Encoded image: per-channel RLE streams plus the entropy stage's
    output (shared-codebook bitstreams or per-block bitstrings)."""

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
    # per_block mode: per-channel list of '0'/'1' strings, one per block
    # (the reference's parity artifact; never serialized).
    per_block_bits: Optional[Dict[str, List[str]]] = None
    # Quality the quant tables were scaled with (None = reference tables).
    quality: Optional[int] = None

    @property
    def num_blocks(self) -> int:
        return self.blocks_per_col * self.blocks_per_row

    def compressed_bytes(self) -> int:
        """Size of the entropy-coded representation in bytes."""
        if self.entropy_mode == "shared":
            return sum(
                len(cb.serialize()) + len(packed)
                for cb, packed, _ in self.shared_streams.values()
            )
        if self.entropy_mode == "per_block":
            return sum(
                (len(bits) + 7) // 8
                for ch in self.per_block_bits.values()
                for bits in ch
            )
        raise ValueError("no entropy stage was run")


def _layout_of(enc: JPEGEncoded) -> str:
    if enc.rle_sparse16:
        return "sparse16"
    return "packed16" if enc.rle_packed16 else "pairs"


def _bucket(n: int) -> int:
    """The power-of-two MCU bucket of ``n`` blocks."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


class JPEGPipeline:
    """Batched encode/decode of the JPEG-style codec on one device."""

    # ``encode`` of one frame takes the overlapped path from this many
    # blocks on (below it the banding costs more than the overlap saves),
    # copying the combined buffer down in this many row bands.  Class
    # attributes, so a test can lower them.
    _OVERLAP_MIN_BLOCKS = 16384
    _OVERLAP_BANDS = 4

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
        self.dtype = config.dtype
        self._fused = config.precision == "fast"
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
        # The layout encode writes (JAX ``_pack16``): sparse16 for fast,
        # shared pipelines whose tables bound every quantized value to 10
        # bits; int16 pairs otherwise (exact mode keeps oracle-comparable
        # int pairs; per-block entropy reads pairs).
        self.sparse16 = (
            config.precision == "fast"
            and config.entropy == "shared"
            and sparse16_eligible(self._tables.values())
        )

    def bases(self) -> dict:
        """The numpy bases this pipeline's fast encode and decode run:
        sparse16, the forward kernel's ``kt_bases`` and each channel's
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

    def _wrap_pairs(self, pairs, lengths, h: int, w: int, bpc: int,
                    bpr: int) -> JPEGEncoded:
        """Per-channel (N, 2L) pairs and (N,) lengths (numpy) → JPEGEncoded."""
        return JPEGEncoded(
            height=h, width=w, blocks_per_col=bpc, blocks_per_row=bpr,
            rle={c: np.asarray(pairs[c], np.int32) for c in CHANNELS},
            rle_lengths={c: np.asarray(lengths[c], np.int32) for c in CHANNELS},
            quality=self.config.quality,
        )

    def _image(self, rgb) -> torch.Tensor:
        """One (H, W, 3) uint8 image → a (1, H, W, 3) batch on the device."""
        x = torch.as_tensor(rgb)
        if x.dim() != 3:
            raise ValueError(f"expected an (H, W, 3) image, got {tuple(x.shape)}")
        return x[None].to(self.device).contiguous()

    def encode(self, rgb, entropy: bool = True) -> JPEGEncoded:
        """Encode one (H, W, 3) uint8 image (numpy or tensor).  A sparse16,
        shared encode of at least ``_OVERLAP_MIN_BLOCKS`` blocks overlaps
        its copy to the host with the entropy walk; its container is
        byte-identical to ``encode_batch``'s."""
        x = self._image(rgb)
        h, w = x.shape[1:3]
        bpc, bpr = -(-h // 8), -(-w // 8)
        if (
            self.sparse16
            and entropy
            and self.config.entropy == "shared"
            and bpc * bpr >= self._OVERLAP_MIN_BLOCKS
        ):
            return self._encode_overlapped(x, bpc, bpr)
        return self.encode_batch(x, entropy)[0]

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
            combined = self._forward_rle(x)
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

    def _forward_rle(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device → the (B·N, 128) int16 combined
        buffer a sparse16 ``encode`` ships to the host (JAX
        ``_forward_rle_impl`` in that layout): ``forward_combined``, K1 on a
        CUDA device.  The pair layout's forward is ``_forward``."""
        if not self.sparse16:
            raise ValueError("_forward_rle is the sparse16 forward; use _forward")
        return forward_combined(x, self._tables["lum"], self._tables["r"])

    def _forward(self, x: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
        """(B, H, W, 3) uint8 on the device → per channel the quantized
        zigzag stream ``zz`` (the pipeline's dtype), the (B·N, 2L) int32
        ``rle`` pairs and (B·N,) ``rle_lengths``: color, 4:2:2,
        ``split_mcus``, ``forward_channel``, ``rle_encode_batched`` (JAX
        ``_forward_impl``)."""
        y, cr, cb = rgb_to_ycbcr(x, self.dtype)
        tiles = split_mcus(y, chroma_subsample_422(cr), chroma_subsample_422(cb))
        out = {}
        for c, t in zip(CHANNELS, tiles):
            zz = forward_channel(t, c, self._tables, self.dtype, self._fused)
            pairs, lens = rle_encode_batched(zz.to(torch.int16))
            out[c] = {"zz": zz, "rle": pairs, "rle_lengths": lens}
        return out

    def _encode_pairs(self, x: torch.Tensor, bpc: int, bpr: int):
        """(B, H, W, 3) uint8 on the device → int16 pair encodes."""
        b, h, w = x.shape[:3]
        out = self._forward(x)
        rle = {c: v["rle"].cpu().numpy().reshape(b, bpc * bpr, -1)
               for c, v in out.items()}
        lengths = {c: v["rle_lengths"].cpu().numpy().reshape(b, bpc * bpr)
                   for c, v in out.items()}
        return [
            self._wrap_pairs({c: rle[c][i] for c in CHANNELS},
                             {c: lengths[c][i] for c in CHANNELS},
                             h, w, bpc, bpr)
            for i in range(b)
        ]

    def forward_stages(self, rgb) -> Dict[str, Dict[str, np.ndarray]]:
        """One (H, W, 3) image's forward intermediates as numpy, per channel:
        ``zz`` (N, h·w) in the pipeline's float dtype, ``rle`` (N, 2·h·w)
        int32 pairs and ``rle_lengths`` (N,), for stage-by-stage parity
        against the oracle (JAX ``forward_stages``)."""
        return {
            c: {k: t.cpu().numpy() for k, t in v.items()}
            for c, v in self._forward(self._image(rgb)).items()
        }

    def _encode_overlapped(
        self, x: torch.Tensor, bpc: int, bpr: int,
        mark: Optional[Callable[[str], None]] = None,
    ) -> JPEGEncoded:
        """Shared-codebook sparse16 encode of one (1, H, W, 3) frame with
        its copy to the host overlapped by the native histogram walk.

        On a CUDA device the forward (K1) runs on the current stream; a
        side stream waits for it, then copies the combined buffer in
        ``_OVERLAP_BANDS`` row bands into a pinned host buffer, recording
        an event per band; the host walks band i once its event fires while
        later bands are still in flight (ctypes releases the GIL in the
        native call).  On the CPU the same banded walk runs without
        streams.  Then one codebook per channel, a native pack per band,
        and ``concat_bitstreams``: the container is byte-identical to the
        one-shot path's.  The host buffer is allocated per call (torch's
        pinned allocator recycles it once freed), because the returned
        encode keeps numpy views of it.  ``mark(name)``, if given, is
        called at the end of each stage (forward, wait, walk, codebook,
        pack, concat) without synchronising the device."""
        mark = mark or (lambda name: None)
        native = native_backend()
        h, w = x.shape[1:3]
        n = bpc * bpr
        k = self._OVERLAP_BANDS
        edges = [n * i // k for i in range(k + 1)]
        bands = list(zip(edges, edges[1:]))
        comb = self._forward_rle(x)
        if self.device.type == "cuda":
            host = torch.empty((n, COMBINED_LANES), dtype=torch.int16,
                               pin_memory=True)
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            side = torch.cuda.Stream(self.device)
            side.wait_event(ready)
            done = []
            with torch.cuda.stream(side):
                for a, b in bands:
                    host[a:b].copy_(comb[a:b], non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                    done.append(event)
            comb.record_stream(side)
        else:
            host, done = comb, [None] * k
        combined = host.numpy().view(np.uint16)
        mark("forward")
        hists = {c: np.zeros(2 * _SYMBOL_OFFSET, np.int64) for c in CHANNELS}
        lens = {c: [] for c in CHANNELS}
        totals = {c: [] for c in CHANNELS}
        for (a, b), event in zip(bands, done):
            if event is not None:
                event.synchronize()
            mark("wait")
            for c in CHANNELS:
                counts, lens_c, total = native.rle_symbol_hist_sparse16(
                    combined[a:b], CHANNEL_SLICES[c].start, _row_len(c),
                    _SYMBOL_OFFSET, 2 * _SYMBOL_OFFSET,
                )
                hists[c] += counts
                lens[c].append(lens_c)
                totals[c].append(total)
            mark("walk")
        enc = self._wrap_sparse(combined, h, w, bpc, bpr)
        enc.entropy_mode = "shared"
        enc.shared_streams = {}
        enc.rle_lengths = {}
        for c in CHANNELS:
            (bins,) = np.nonzero(hists[c])
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - _SYMBOL_OFFSET, hists[c][bins]
            )
            mark("codebook")
            pieces = [
                native.huff_pack_sparse16(
                    combined[a:b], CHANNEL_SLICES[c].start, _row_len(c),
                    codebook, total,
                )
                for (a, b), total in zip(bands, totals[c])
            ]
            mark("pack")
            enc.shared_streams[c] = (codebook, *concat_bitstreams(pieces))
            enc.rle_lengths[c] = np.concatenate(lens[c])
            mark("concat")
        return enc

    def encode_bucketed(self, rgb, entropy: bool = True) -> JPEGEncoded:
        """``encode`` with the MCU batch padded to the next power of two: the
        MCU-domain chain (``forward_channel``, then sparse16 or pair RLE) of
        JAX ``_mcu_forward_impl``, sliced back to N blocks.  Its encode
        equals ``encode``'s; in the sparse16 layout the forward runs
        ``fused_forward`` (cuBLAS on a card), not K1."""
        x = self._image(rgb)
        h, w = x.shape[1:3]
        bpc, bpr = -(-h // 8), -(-w // 8)
        n = bpc * bpr
        y, cr, cb = rgb_to_ycbcr(x, self.dtype)
        tiles = [
            F.pad(t, (0, 0, 0, 0, 0, _bucket(n) - n))  # zero tiles to the bucket
            for t in split_mcus(y, chroma_subsample_422(cr),
                                chroma_subsample_422(cb))
        ]
        if self.sparse16:
            parts = [
                rle_encode_sparse16(forward_channel(
                    t, c, self._tables, self.dtype, self._fused
                ).to(torch.int16))[0]
                for c, t in zip(CHANNELS, tiles)
            ]
            combined = torch.cat(parts, dim=1)[:n]
            enc = self._wrap_sparse(combined.cpu().numpy().view(np.uint16),
                                    h, w, bpc, bpr)
        else:
            pairs, lengths = {}, {}
            for c, t in zip(CHANNELS, tiles):
                zz = forward_channel(t, c, self._tables, self.dtype, self._fused)
                p, l = rle_encode_batched(zz.to(torch.int16))
                pairs[c], lengths[c] = p[:n].cpu().numpy(), l[:n].cpu().numpy()
            enc = self._wrap_pairs(pairs, lengths, h, w, bpc, bpr)
        if entropy:
            self.entropy_encode(enc)
        return enc

    def warmup(self, shapes: List[Tuple[int, int]]) -> None:
        """Build every library an encode of this pipeline reaches (the native
        runtime; K1 for a sparse16 pipeline on a card) and run one forward
        per (H, W) shape, so that a later encode of those shapes builds
        nothing.  PyTorch compiles no graph per shape: this is the serving
        cold start that is left."""
        native_backend()
        if self.sparse16 and self.device.type == "cuda":
            fwd_megakernel.load_kernel()
        for h, w in shapes:
            x = torch.zeros((1, h, w, 3), dtype=torch.uint8, device=self.device)
            if self.sparse16:
                forward_combined(x, self._tables["lum"], self._tables["r"])
            else:
                self._forward(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        """The entropy stage of ``config.entropy``.  shared: per channel one
        native histogram walk (which, in the sparse16 layout, also yields
        the per-block symbol lengths), the canonical codebook, one native
        pack.  per_block: the reference's quirk-exact tree per block per
        channel, in one native pass (``huff_per_block``); where that pass
        refuses the input, the oracle's ``encode_huffman_oracle`` per block,
        as in the JAX pipeline."""
        if self.config.entropy == "per_block":
            return self._entropy_encode_per_block(enc)
        native = native_backend()
        enc.entropy_mode = "shared"
        enc.shared_streams = {}
        if enc.rle_sparse16:
            enc.rle_lengths = {}
        for c in CHANNELS:
            if enc.rle_sparse16:
                if enc.rle_combined is not None:
                    buf, col = enc.rle_combined, CHANNEL_SLICES[c].start
                else:
                    buf, col = np.ascontiguousarray(enc.rle[c]), 0
                counts, lens_c, total = native.rle_symbol_hist_sparse16(
                    buf, col, _row_len(c), _SYMBOL_OFFSET, 2 * _SYMBOL_OFFSET,
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
                    buf, col, _row_len(c), codebook, total
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

    def _entropy_encode_per_block(self, enc: JPEGEncoded) -> JPEGEncoded:
        """Per-block parity bitstrings of an int32 pair encode."""
        if enc.rle_sparse16 or enc.rle_packed16:
            raise ValueError(
                f"per-block entropy takes int32 pair encodes, not {_layout_of(enc)}"
            )
        native = native_backend()
        enc.entropy_mode = "per_block"
        enc.per_block_bits = {}
        for c in CHANNELS:
            pairs = np.asarray(enc.rle[c], np.int32)
            lengths = np.asarray(enc.rle_lengths[c], np.int32)
            bits = native.huff_per_block(pairs, lengths)
            if bits is None:
                bits = [
                    jpeg_oracle.encode_huffman_oracle(
                        [int(v) for v in pairs[i, : int(lengths[i])]]
                    )[0]
                    for i in range(enc.num_blocks)
                ]
            enc.per_block_bits[c] = bits
        return enc

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------

    def entropy_decode(self, enc: JPEGEncoded):
        """Recover the RLE streams from the entropy stage, in the encode's
        own layout: returns (rle, lengths).  sparse16 rebuilds the combined
        buffer in place (refreshing ``enc.rle_combined``, ``enc.rle`` and
        ``enc.rle_lengths``); a channel the strict native walker rejects goes
        through ``unpack_symbols`` and the host re-blocking instead.
        Per-block trees are never serialized (as in the reference), so a
        per_block encode's RLE arrays are authoritative."""
        if enc.entropy_mode != "shared":
            return enc.rle, enc.rle_lengths
        native = native_backend()
        if enc.rle_sparse16:
            combined = np.zeros((enc.num_blocks, COMBINED_LANES), np.uint16)
            lengths = {}
            for c in CHANNELS:
                codebook, packed, nbits = enc.shared_streams[c]
                block_size = _row_len(c)
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
            block_size = _row_len(c)
            unpack = (native.huff_unpack_pairs16 if enc.rle_packed16
                      else native.huff_unpack_pairs)
            got = unpack(packed, nbits, codebook, block_size, enc.num_blocks,
                         pad_width)
            if got is None:
                # The quirk-compatible handler of streams the strict native
                # pair walker rejects: the symbol walker, then host re-blocking.
                symbols = unpack_symbols(packed, nbits, codebook)
                sym_pad = 2 * pad_width if enc.rle_packed16 else pad_width
                pairs, lens = _split_symbols(
                    symbols, enc.num_blocks, sym_pad, block_size
                )
                got = (_pack16_host(pairs), lens) if enc.rle_packed16 else (pairs, lens)
            rle[c], lengths[c] = got
        return rle, lengths

    def _streams(self, encs: List[JPEGEncoded], from_entropy: bool):
        """Each encode's (rle, lengths), from its entropy stage or as held."""
        return [
            self.entropy_decode(e) if from_entropy and e.entropy_mode is not None
            else (e.rle, e.rle_lengths)
            for e in encs
        ]

    def _upload(self, streams, pad: int = 0):
        """Per channel the stacked (B, N + pad, ·) RLE streams and (B, N +
        pad) lengths on the device (int16 for the 16-bit layouts), with
        ``pad`` zero blocks appended to each frame."""
        rle, lengths = {}, {}
        for c in CHANNELS:
            arr = np.stack([np.ascontiguousarray(s[0][c]) for s in streams])
            if arr.dtype == np.uint16:
                arr = arr.view(np.int16)
            lens = np.stack([
                np.asarray(s[1][c], np.int32) if s[1] is not None
                else np.zeros(arr.shape[1], np.int32)
                for s in streams
            ])
            rle[c] = F.pad(torch.from_numpy(arr).to(self.device),
                           (0, 0, 0, pad))
            lengths[c] = F.pad(torch.from_numpy(lens).to(self.device), (0, pad))
        return rle, lengths

    def _inverse_sparse(
        self, combined: torch.Tensor, bpc: int, bpr: int,
        height: int, width: int,
    ) -> torch.Tensor:
        """(B, N, 128) sparse deltas → (B, height, width, 3) uint8 RGB: per
        channel one folded-basis einsum, then the color merge."""
        b = combined.shape[0]
        # One name for both int32 buffers, and freed before the merge, so
        # that at most one 4-byte copy of the batch lives at a time (a
        # 1-GiPix batch holds 8 GiB in each).
        d = combined.to(torch.int32)
        d = torch.where(d != 0, d - SPARSE16_DELTA_BIAS, 0)
        planes = {}
        for name in CHANNELS:
            tw = _CHANNEL_SHAPES[name][1]
            d_kt = d[..., CHANNEL_SLICES[name]].reshape(b * bpc, bpr, 8 * tw)
            plane = fused_inverse_plane_sparse(
                d_kt.transpose(1, 2), self._tables[name], tw,
                upsample_cols=(name != "lum"),
            )
            planes[name] = plane.reshape(b, 8 * bpc, 8 * bpr)
        del d, d_kt
        return ycbcr_planes_to_rgb(
            planes["lum"], planes["r"], planes["b"], height, width
        )

    def _inverse_tiles(
        self, rle: Dict[str, torch.Tensor], lengths: Dict[str, torch.Tensor],
        layout: str,
    ) -> Dict[str, torch.Tensor]:
        """(B, N, ·) RLE streams and (B, N) lengths on the device → per
        channel (B, N, h, w) uint8 pixel tiles: RLE expansion (K6 for
        packed16 on a CUDA device), then ``inverse_channel`` (JAX
        ``_mcu_inverse_impl``)."""
        tiles = {}
        for c in CHANNELS:
            th, tw = _CHANNEL_SHAPES[c]
            b, n, k = rle[c].shape
            zz = _rle_decode_fn(
                rle[c].reshape(b * n, k), lengths[c].reshape(b * n),
                th * tw, layout,
            )
            tiles[c] = inverse_channel(
                zz, c, self._tables, self.dtype, self._fused
            ).reshape(b, n, th, tw)
        return tiles

    def decode(self, enc: JPEGEncoded, from_entropy: bool = True) -> np.ndarray:
        return self.decode_batch([enc], from_entropy)[0]

    def _check_quality(self, enc: JPEGEncoded) -> None:
        if enc.quality != self.config.quality:
            raise ValueError(
                f"encode has quality={enc.quality}, pipeline has "
                f"quality={self.config.quality}"
            )

    def decode_batch(
        self, encs: List[JPEGEncoded], from_entropy: bool = True
    ) -> List[np.ndarray]:
        """Decode same-size encodes of one RLE layout with one inverse pass
        on the device: the folded sparse16 inverse for a fast pipeline's
        combined buffers, the staged tile inverse otherwise (every layout
        of an exact pipeline, in float64)."""
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
            self._check_quality(e)
        streams = self._streams(encs, from_entropy)
        bpc, bpr = e0.blocks_per_col, e0.blocks_per_row
        if (self._fused and key[2] == "sparse16"
                and all(e.rle_combined is not None for e in encs)):
            combined = np.stack([e.rle_combined for e in encs]).view(np.int16)
            rgb = self._inverse_sparse(
                torch.from_numpy(combined).to(self.device),
                bpc, bpr, e0.height, e0.width,
            )
        else:
            tiles = self._inverse_tiles(*self._upload(streams), key[2])
            rgb = ycbcr_to_rgb_mcus(tiles["lum"], tiles["r"], tiles["b"],
                                    bpc, bpr, e0.height, e0.width, self.dtype)
        rgb = rgb.cpu().numpy()
        return [rgb[i] for i in range(len(encs))]

    def decode_bucketed(self, enc: JPEGEncoded,
                        from_entropy: bool = True) -> np.ndarray:
        """``decode`` through the staged tile inverse with the MCU batch
        padded to the next power of two (JAX ``decode_bucketed``): equal to
        ``decode`` in exact mode and in the staged layouts, within the
        fast-path envelope of the folded sparse16 decode."""
        self._check_quality(enc)
        n = enc.num_blocks
        rle, lengths = self._upload(self._streams([enc], from_entropy),
                                    _bucket(n) - n)
        tiles = self._inverse_tiles(rle, lengths, _layout_of(enc))
        rgb = ycbcr_to_rgb_mcus(
            tiles["lum"][0, :n], tiles["r"][0, :n], tiles["b"][0, :n],
            enc.blocks_per_col, enc.blocks_per_row, enc.height, enc.width,
            self.dtype,
        )
        return rgb.cpu().numpy()

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


@functools.lru_cache(maxsize=None)
def default_pipeline(precision: str = "fast", entropy: str = "shared", *,
                     device) -> JPEGPipeline:
    """One cached pipeline per (precision, entropy, device)."""
    return JPEGPipeline(JPEGConfig(precision=precision, entropy=entropy), device)


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
