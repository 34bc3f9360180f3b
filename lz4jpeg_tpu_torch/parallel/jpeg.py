"""Sharded JPEG: the MCU axis, or bands of block rows, split over the mesh.

Port of ``lz4jpeg_tpu/parallel/jpeg.py``.  The reference spawns one thread
per 8×8 MCU, each running the whole DCT→quant→zigzag→RLE chain
(``process``, ``Algorithms/parallel/JPEG/JPEG.c:1103-1252``), then gathers
by index — and loses the results to a pass-by-value bug (:1300).  Here each
shard runs on its device and the gather is the in-order concatenation of
the shards (``mesh.py``): order is positional, a bug of this class cannot
exist.

* ``ShardedJPEGForward``: colour and ``split_mcus`` once on the mesh's
  first device; per MCU shard ``forward_channel`` and ``rle_encode_batched``;
  its ``inverse`` decodes pairs, packed16 (the Hopper kernel K6 on a CUDA
  shard) or sparse16 per shard, then merges the tiles.
* ``ShardedSparseJPEG``: the sparse16 forward (the Hopper kernel K1, one
  launch per band) and the folded inverse, per band of block rows.
* ``multihost_jpeg_encode`` / ``multihost_jpeg_decode``: bands of block rows
  over the processes of a ``torch.distributed`` group, all-reduced symbol
  histograms and the ordered gather of bitstreams or RGB bands
  (``parallel/multihost.py``).

Quant tables come from ``scaled_tables(config.quality)``, as in the
single-device pipeline, and each mesh device has a ``JPEGPipeline``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.config import JPEGConfig
from lz4jpeg_tpu_torch.formats.jpeg_container import (
    pack_container,
    unpack_container,
)
from lz4jpeg_tpu_torch.models.jpeg import (
    _SYMBOL_OFFSET,
    CHANNELS,
    JPEGEncoded,
    JPEGPipeline,
    _row_len,
    forward_channel,
    scaled_tables,
)
from lz4jpeg_tpu_torch.native import native_backend
from lz4jpeg_tpu_torch.ops.color import (
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
    ycbcr_to_rgb_mcus,
)
from lz4jpeg_tpu_torch.ops.fwd_megakernel import CHANNEL_SLICES, forward_combined
from lz4jpeg_tpu_torch.ops.huffman import (
    build_canonical_codebook_from_counts,
    concat_bitstreams,
)
from lz4jpeg_tpu_torch.ops.rle import rle_encode_batched
from lz4jpeg_tpu_torch.parallel.mesh import (
    CodecMesh,
    gather_shards,
    pad_to_devices,
    shard_leading_axis,
)
from lz4jpeg_tpu_torch.parallel.multihost import (
    ordered_allgather_payloads,
    process_allgather,
    process_allreduce,
    process_count,
    process_index,
)


def _pipelines(mesh: CodecMesh, config: JPEGConfig) -> Dict[torch.device, JPEGPipeline]:
    """One pipeline per distinct mesh device."""
    return {dev: JPEGPipeline(config, dev) for dev in dict.fromkeys(mesh.devices)}


class ShardedJPEGForward:
    """Forward transform with the MCU axis sharded over a mesh.

    The colour transform and the MCU split run once, on the mesh's first
    device (cheap, and dependent on full image rows); the per-MCU compute —
    the basis product or the staged DCT, quantization, zigzag, RLE — runs
    per shard.  Every shard reads the same quant tables (the reference's
    shared in-memory tables, SURVEY.md §2.3)."""

    def __init__(self, mesh: CodecMesh, config: JPEGConfig = JPEGConfig()):
        self.mesh = mesh
        self.config = config
        self._tables = scaled_tables(config.quality)
        self._pipelines = _pipelines(mesh, config)

    def _tiles(self, rgb) -> Tuple[List[np.ndarray], int]:
        """(H, W, 3) uint8 → the (lum, r, b) MCU tiles as numpy, padded to
        the mesh size, and the MCU count."""
        x = torch.as_tensor(np.asarray(rgb)).to(self.mesh.devices[0])
        y, cr, cb = rgb_to_ycbcr(x, self.config.dtype)
        tiles = split_mcus(y, chroma_subsample_422(cr), chroma_subsample_422(cb))
        padded = [pad_to_devices(t.cpu().numpy(), self.mesh.size) for t in tiles]
        return [p for p, _ in padded], padded[0][1]

    def _mcu_stage(self, lum, r, b) -> List[Dict[str, Dict[str, torch.Tensor]]]:
        """Per-shard MCU tiles (lists from ``shard_leading_axis``) → per
        shard, per channel ``zz``, ``rle`` pairs and ``rle_lengths`` on the
        shard's device.  Every shard is launched before anything is read."""
        dtype = self.config.dtype
        fused = self.config.precision == "fast"
        out = []
        for shard in zip(lum, r, b):
            stages = {}
            for name, tiles in zip(CHANNELS, shard):
                zz = forward_channel(tiles, name, self._tables, dtype, fused)
                pairs, lengths = rle_encode_batched(zz.to(torch.int16))
                stages[name] = {"zz": zz, "rle": pairs, "rle_lengths": lengths}
            out.append(stages)
        return out

    def __call__(self, rgb) -> Tuple[Dict[str, Dict[str, np.ndarray]], int]:
        """RGB image → per-channel forward results, gathered in MCU order.

        Returns ``(stages, num_mcus)`` with padding rows (beyond
        ``num_mcus``) still present in the arrays."""
        tiles, n = self._tiles(rgb)
        shards = self._mcu_stage(*shard_leading_axis(tiles, self.mesh))
        stages = {
            c: {k: gather_shards([s[c][k] for s in shards])
                for k in ("zz", "rle", "rle_lengths")}
            for c in CHANNELS
        }
        return stages, n

    def inverse(
        self,
        rle: Dict[str, np.ndarray],
        rle_lengths: Optional[Dict[str, np.ndarray]],
        bpc: int,
        bpr: int,
        height: int,
        width: int,
        layout: Optional[str] = None,
    ) -> np.ndarray:
        """Sharded inverse chain: RLE → IDCT per MCU shard, then merge.

        ``layout`` is "pairs" (the default for int32 streams), "packed16"
        (K6 per CUDA shard) or "sparse16".  uint16 streams need it: packed16
        words and sparse16 deltas share the dtype, and decoding one as the
        other would silently corrupt the image, so their layout is never
        guessed (``ValueError``)."""
        if layout is None:
            if np.asarray(rle["lum"]).dtype == np.uint16:
                raise ValueError(
                    "uint16 RLE streams are ambiguous: pass "
                    'layout="packed16" or layout="sparse16"'
                )
            layout = "pairs"
        shards = {}
        for c in CHANNELS:
            stream = np.ascontiguousarray(rle[c])
            if stream.dtype == np.uint16:
                stream = stream.view(np.int16)
            lens = (np.asarray(rle_lengths[c], np.int32) if rle_lengths is not None
                    # sparse16 needs no lengths side channel
                    else np.zeros(stream.shape[0], np.int32))
            shards[c] = shard_leading_axis(
                [pad_to_devices(stream, self.mesh.size)[0],
                 pad_to_devices(lens, self.mesh.size)[0]], self.mesh)
        tiles = [
            self._pipelines[dev]._inverse_tiles(
                {c: shards[c][0][i][None] for c in CHANNELS},
                {c: shards[c][1][i][None] for c in CHANNELS},
                layout,
            )
            for i, dev in enumerate(self.mesh.devices)
        ]
        dev0 = self.mesh.devices[0]
        merged = {c: torch.cat([t[c][0].to(dev0) for t in tiles])[: bpc * bpr]
                  for c in CHANNELS}
        return ycbcr_to_rgb_mcus(
            merged["lum"], merged["r"], merged["b"], bpc, bpr, height, width,
            self.config.dtype,
        ).cpu().numpy()


class ShardedSparseJPEG:
    """The production multi-device JPEG: the sparse16 forward (K1 on a CUDA
    shard) and the folded inverse, band-sharded over the mesh.

    Every forward and inverse op is row-local at 8-pixel-band granularity
    (colour, 4:2:2, the per-block basis products, the plane merges), so a
    contiguous band of block rows per device needs no communication until
    the gather — the reference's thread-per-MCU fan-out (JPEG.c:1297-1304)
    with the gather done by position.  The forward is bit-identical to the
    single-device pipeline's."""

    def __init__(self, mesh: CodecMesh, config: Optional[JPEGConfig] = None):
        self.mesh = mesh
        self.config = config or JPEGConfig(precision="fast", entropy="shared")
        self._pipelines = _pipelines(mesh, self.config)
        self.pipeline = self._pipelines[mesh.devices[0]]
        if not self.pipeline.sparse16:
            raise ValueError(
                "ShardedSparseJPEG requires a sparse16-eligible config "
                "(precision='fast', entropy='shared', moderate quality)"
            )

    def forward(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 → (N, 128) uint16 combined sparse streams,
        computed band-parallel over the mesh: block rows padded to a mesh
        multiple with zero rows, one forward launch per band, the padding
        blocks cut after the gather.

        Requires H % 8 == 0 and W % 8 == 0; ragged shapes delegate to the
        single-device pipeline.  Zero-padding raggedness at the RGB level
        would run the colour transform over the padding (padded chroma
        becomes 128, not the plane-domain zeros ``split_mcus`` pads with)
        and break the bit-identity — whole padded block ROWS are safe
        (forward ops are block-local and the fake blocks are cut off),
        partial blocks are not."""
        rgb = np.asarray(rgb)
        h, w = rgb.shape[:2]
        if h % 8 or w % 8:
            return self.pipeline.encode(rgb, entropy=False).rle_combined
        bpc, bpr = h // 8, w // 8
        n_dev = self.mesh.size
        bpc_pad = -(-bpc // n_dev) * n_dev
        if bpc_pad != bpc:
            img = np.zeros((8 * bpc_pad, w, 3), np.uint8)
            img[:h] = rgb
        else:
            img = rgb
        band_h = 8 * (bpc_pad // n_dev)
        tables = self.pipeline._tables
        parts = [
            forward_combined(
                torch.from_numpy(np.ascontiguousarray(
                    img[i * band_h : (i + 1) * band_h]))[None].to(dev),
                tables["lum"], tables["r"],
            )
            for i, dev in enumerate(self.mesh.devices)
        ]
        return gather_shards(parts).view(np.uint16)[: bpc * bpr]

    def inverse(
        self, combined: np.ndarray, bpc: int, bpr: int,
        height: int, width: int,
    ) -> np.ndarray:
        """(N, 128) combined sparse streams → (height, width, 3) uint8, the
        folded inverse band-parallel over the mesh."""
        n_dev = self.mesh.size
        bpc_pad = -(-bpc // n_dev) * n_dev
        band_bpc = bpc_pad // n_dev
        comb = np.ascontiguousarray(combined, np.uint16)
        if bpc_pad != bpc:
            comb = np.zeros((bpc_pad * bpr, combined.shape[1]), np.uint16)
            comb[: bpc * bpr] = combined
        (bands,) = shard_leading_axis([comb.view(np.int16)], self.mesh)
        parts = [
            self._pipelines[dev]._inverse_sparse(
                band[None], band_bpc, bpr, 8 * band_bpc, 8 * bpr
            )[0]
            for band, dev in zip(bands, self.mesh.devices)
        ]
        return gather_shards(parts)[:height, :width]


def multihost_jpeg_encode(
    rgb: np.ndarray, config: JPEGConfig = None, device="cuda"
) -> bytes:
    """Cross-process JPEG encode → TJPG container bytes, identical on every
    process and byte-equal to a single-process encode.

    The multi-process shape of the reference's MCU fan-out
    (``Algorithms/parallel/JPEG/JPEG.c:1297-1304``) plus its shared
    in-memory Huffman tables (SURVEY.md §2.2.8), done the collective way:

    * each process transforms its contiguous band of 8-pixel MCU rows on
      ``device`` (colour transform and 4:2:2 subsampling are row-local, so
      bands are independent; K1 on a card for a sparse16 config);
    * per-channel symbol histograms (the native walks) all-reduce across
      processes, so every process builds the identical canonical codebook;
    * each process entropy-packs its own band natively and the bitstreams
      gather in band order (``ordered_allgather_payloads``), joined by
      ``concat_bitstreams``, since substreams end at arbitrary bit offsets.

    Without a process group it encodes locally."""
    config = config or JPEGConfig(precision="fast", entropy="shared")
    if config.entropy != "shared":
        raise ValueError("multihost encode requires the shared entropy mode")
    pid, nproc = process_index(), process_count()
    h, w = rgb.shape[:2]
    bpc = -(-h // 8)
    my_rows = np.array_split(np.arange(bpc), nproc)[pid]
    pipeline = JPEGPipeline(config, device)
    native = native_backend()
    nbins = 2 * _SYMBOL_OFFSET
    local = {}
    hists = np.zeros((len(CHANNELS), nbins), np.int64)
    if len(my_rows):
        band = rgb[my_rows[0] * 8 : min((my_rows[-1] + 1) * 8, h)]
        (benc,) = pipeline.encode_batch(np.ascontiguousarray(band)[None],
                                        entropy=False)
        for ci, c in enumerate(CHANNELS):
            if benc.rle_sparse16:
                col, row_len = CHANNEL_SLICES[c].start, _row_len(c)
                counts, _, total = native.rle_symbol_hist_sparse16(
                    benc.rle_combined, col, row_len, _SYMBOL_OFFSET, nbins
                )
                local[c] = ("sparse16", benc.rle_combined, col, row_len, total)
            else:
                pairs, lengths = benc.rle[c], benc.rle_lengths[c]
                counts, _ = native.rle_symbol_hist(
                    pairs, lengths, _SYMBOL_OFFSET, nbins
                )
                local[c] = ("pairs", pairs, lengths, None, None)
            hists[ci] = counts
    global_hists = process_allreduce(hists)

    shared = {}
    for ci, c in enumerate(CHANNELS):
        (bins,) = np.nonzero(global_hists[ci])
        codebook = build_canonical_codebook_from_counts(
            bins.astype(np.int64) - _SYMBOL_OFFSET, global_hists[ci][bins]
        )
        if c in local:
            kind, a, b_, row_len, total = local[c]
            if kind == "sparse16":
                packed, nbits = native.huff_pack_sparse16(
                    a, b_, row_len, codebook, total
                )
            else:
                packed, nbits = native.huff_pack_pairs(a, b_, codebook)
        else:
            packed, nbits = b"", 0
        pieces = ordered_allgather_payloads([packed], [pid], nproc)
        all_nbits = process_allgather(np.asarray([nbits], np.int64)).reshape(-1)
        merged, total_bits = concat_bitstreams(
            list(zip(pieces, all_nbits.tolist()))
        )
        shared[c] = (codebook, merged, total_bits)

    enc = JPEGEncoded(
        height=h,
        width=w,
        blocks_per_col=bpc,
        blocks_per_row=-(-w // 8),
        rle={c: np.zeros((0, 0), np.int32) for c in CHANNELS},
        rle_lengths={c: np.zeros(0, np.int32) for c in CHANNELS},
        entropy_mode="shared",
        shared_streams=shared,
        quality=config.quality,
    )
    return pack_container(enc)


def multihost_jpeg_decode(
    container: bytes, config: JPEGConfig = None, device="cuda"
) -> np.ndarray:
    """Cross-process TJPG decode → the full RGB image, identical on every
    process and equal to a single-process ``JPEGPipeline.decode``.

    Every process entropy-decodes the (replicated) container, takes its
    contiguous band of 8-pixel MCU rows — bands are independent because the
    4:2:2 subsampling is horizontal-only — runs the inverse chain on
    ``device`` (the folded sparse16 inverse of a fast pipeline, else the
    staged tile inverse, K6 for packed16 on a card), and the RGB bands
    gather in band order.  The reference's parallel decode ran per-MCU
    threads through the same chain and lost the results to its by-value bug
    (``Algorithms/parallel/JPEG/JPEG.c:1103-1252,1300``)."""
    pid, nproc = process_index(), process_count()
    enc = unpack_container(container)
    config = config or JPEGConfig(
        precision="fast", entropy="shared", quality=enc.quality
    )
    pipeline = JPEGPipeline(config, device)
    rle, lengths = pipeline.entropy_decode(enc)
    bpc, bpr = enc.blocks_per_col, enc.blocks_per_row
    splits = np.array_split(np.arange(bpc), nproc)
    my_rows = splits[pid]
    # Band ids are dense over the processes that actually got rows (tiny
    # images can leave trailing processes idle).
    band_count = sum(1 for s in splits if len(s))
    my_band = sum(1 for s in splits[:pid] if len(s))
    payload = b""
    if len(my_rows):
        r0, r1 = int(my_rows[0]), int(my_rows[-1])
        sl = slice(r0 * bpr, (r1 + 1) * bpr)
        # The band as an encode of its own: block rows are contiguous in
        # every layout, and ``decode`` picks the inverse of the full frame's
        # layout (the folded sparse16 inverse, or the staged tile inverse).
        band = dataclasses.replace(
            enc,
            height=min((r1 + 1) * 8, enc.height) - r0 * 8,
            blocks_per_col=r1 - r0 + 1,
            rle={c: np.asarray(rle[c])[sl] for c in CHANNELS},
            rle_lengths=({c: np.asarray(lengths[c])[sl] for c in CHANNELS}
                         if lengths is not None else None),
            rle_combined=(enc.rle_combined[sl]
                          if enc.rle_combined is not None else None),
            entropy_mode=None,
            shared_streams=None,
        )
        payload = pipeline.decode(band, from_entropy=False).tobytes()
    bands = ordered_allgather_payloads(
        [payload] if len(my_rows) else [],
        [my_band] if len(my_rows) else [],
        band_count,
    )
    rows = [np.frombuffer(b, np.uint8).reshape(-1, enc.width, 3) for b in bands]
    return np.concatenate(rows, axis=0)
