"""Entropy-stage placement A/B: host C++ pack vs on-device pack.

Port of ``lz4jpeg_tpu/bench/entropy_ab.py``.  It measures both placements
of the shared-codebook entropy stage on one ``image_size``² noise frame,
on an explicit torch ``device``:

* **host**: copy the padded int16 RLE pairs and their lengths to the host,
  then the single-pass C++ histogram + pack (``native.rle_symbol_hist`` /
  ``huff_pack_pairs``) around a canonical codebook built on the host;
* **device**: keep the valid symbols in device memory, histogram them by
  ``torch.sort`` + bin-edge ``torch.searchsorted``, build the (tiny)
  canonical codebook on the host, pack with
  ``ops/huffman.py::pack_symbols_device``, and copy only the packed bits.

The A/B measures the int16 PAIR layout at the default tables (the JAX
package flips its private layout flags to get it); the port takes the same
streams from ``JPEGPipeline._forward``, which is the pair forward of every
pipeline.  The device numbers are best-case: the flat valid-symbol stream
is staged to the device untimed.  Both paths must give the same bits.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import (
    bench_device,
    device_record,
    sync,
    trimmed_mean,
)

SYMBOL_OFFSET = 2048  # |RLE counts| ≤ 128, |quantized coeffs| < 2047


def _device_hist(symbols: torch.Tensor) -> torch.Tensor:
    """Sort-based histogram of int32 ``symbols`` over [-SYMBOL_OFFSET,
    SYMBOL_OFFSET): one sort plus 2·4096 searchsorted lookups."""
    s = torch.sort(symbols).values
    edges = torch.arange(-SYMBOL_OFFSET, SYMBOL_OFFSET + 1, dtype=symbols.dtype,
                         device=symbols.device)
    idx = torch.searchsorted(s, edges)
    return idx[1:] - idx[:-1]


def run_entropy_ab(
    image_size: int = 1024,
    runs: int = 5,
    output: Optional[str] = None,
    device="cuda",
) -> Dict:
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import CHANNELS, JPEGPipeline, _valid_symbols
    from lz4jpeg_tpu_torch.native import native_backend
    from lz4jpeg_tpu_torch.ops.huffman import (
        build_canonical_codebook_from_counts,
        pack_symbols_device,
    )
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image
    from lz4jpeg_tpu_torch.utils.profiling import time_device

    dev = bench_device(device)
    native = native_backend()
    rng = np.random.default_rng(0)
    img = generate_noise_image(image_size, image_size, rng)
    pipe = JPEGPipeline(JPEGConfig(), dev)
    slim = pipe._forward(pipe._image(img))
    sync(dev)

    artifact: Dict = {
        "image_size": image_size,
        "platform": dev.type,
        **device_record(dev),
        "runs": runs,
        "channels": {},
    }
    host_total = 0.0
    device_total = 0.0
    for c in CHANNELS:
        pairs_dev = slim[c]["rle"].to(torch.int16)
        lengths_dev = slim[c]["rle_lengths"]

        # -- host path: copy the pairs down, then C++ hist + codebook + pack.
        # Each run copies a fresh device tensor, as a real encode would.
        pairs_h, lengths_h = pairs_dev.cpu().numpy(), lengths_dev.cpu().numpy()
        d2h_times: List[float] = []
        for _ in range(runs):
            fresh = (torch.from_numpy(pairs_h).to(dev),
                     torch.from_numpy(lengths_h).to(dev))
            sync(dev)
            t0 = time.perf_counter()
            fresh[0].cpu(), fresh[1].cpu()
            d2h_times.append(time.perf_counter() - t0)
        pairs_h = np.asarray(pairs_h, np.int32)
        lengths_h = np.asarray(lengths_h)
        host_times: List[float] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            counts, _ = native.rle_symbol_hist(
                pairs_h, lengths_h, SYMBOL_OFFSET, 2 * SYMBOL_OFFSET
            )
            (bins,) = np.nonzero(counts)
            codebook = build_canonical_codebook_from_counts(
                bins.astype(np.int64) - SYMBOL_OFFSET, counts[bins]
            )
            packed, nbits = native.huff_pack_pairs(
                pairs_h, lengths_h, codebook
            )
            host_times.append(time.perf_counter() - t0)

        # -- device path: symbols staged untimed (best case), then fenced
        #    hist, host codebook build, fenced pack, copy of the packed bits.
        symbols = _valid_symbols(pairs_h, lengths_h)
        sym_dev = torch.from_numpy(symbols).to(dev)
        hist_times = time_device(_device_hist, sym_dev, runs=runs, warmup=1)
        if not np.array_equal(_device_hist(sym_dev).cpu().numpy(), counts):
            raise RuntimeError(f"{c}: device and host histograms differ")
        pad_bits = -(-int(nbits) // 64) * 64
        pack_times = time_device(
            lambda s: pack_symbols_device(s, codebook, pad_bits),
            sym_dev,
            runs=runs,
            warmup=1,
        )
        packed_dev, nbits_dev = pack_symbols_device(sym_dev, codebook, pad_bits)
        sync(dev)
        d2h_packed: List[float] = []
        for _ in range(runs):
            t0 = time.perf_counter()
            packed_bytes = packed_dev.cpu().numpy().tobytes()
            d2h_packed.append(time.perf_counter() - t0)
        nbytes = (int(nbits) + 7) // 8
        if int(nbits_dev) != int(nbits) or packed_bytes[:nbytes] != packed[:nbytes]:
            raise RuntimeError(f"{c}: device and host bit streams differ")

        entry = {
            "symbols": int(symbols.size),
            "pairs_bytes_d2h": int(pairs_h.size * 2 + lengths_h.size * 4),
            "packed_bytes_d2h": len(packed_bytes),
            "host_d2h_pairs_s": trimmed_mean(d2h_times),
            "host_hist_codebook_pack_s": trimmed_mean(host_times),
            "device_hist_s": trimmed_mean(hist_times),
            "device_pack_s": trimmed_mean(pack_times),
            "device_d2h_packed_s": trimmed_mean(d2h_packed),
        }
        entry["host_path_s"] = (
            entry["host_d2h_pairs_s"] + entry["host_hist_codebook_pack_s"]
        )
        entry["device_path_s"] = (
            entry["device_hist_s"]
            + entry["device_pack_s"]
            + entry["device_d2h_packed_s"]
        )
        artifact["channels"][c] = entry
        host_total += entry["host_path_s"]
        device_total += entry["device_path_s"]
        print(
            f"{c:>3}: host {entry['host_path_s']*1e3:8.2f} ms "
            f"(d2h {entry['host_d2h_pairs_s']*1e3:.2f} + pack "
            f"{entry['host_hist_codebook_pack_s']*1e3:.2f})  |  device "
            f"{entry['device_path_s']*1e3:8.2f} ms "
            f"(hist {entry['device_hist_s']*1e3:.2f} + pack "
            f"{entry['device_pack_s']*1e3:.2f} + d2h "
            f"{entry['device_d2h_packed_s']*1e3:.2f})"
        )

    artifact["host_total_s"] = host_total
    artifact["device_total_s"] = device_total
    artifact["decision"] = (
        "device" if device_total < host_total else "host"
    )
    print(
        f"total: host {host_total*1e3:.2f} ms, device {device_total*1e3:.2f} "
        f"ms -> production entropy stage: {artifact['decision']}"
    )
    if output:
        with open(output, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {output}")
    return artifact
