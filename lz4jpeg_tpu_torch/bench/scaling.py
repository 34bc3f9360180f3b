"""Scaling-efficiency sweep over mesh sizes.

Port of ``lz4jpeg_tpu/bench/scaling.py``.  The reference's scaling story
is a speedup table of thread-per-block wall times (BASELINE.md: 4.7×–18.7×
at 64–2048 px).  Here the same sharded program (``ShardedJPEGForward``'s
MCU stage) runs over meshes of 1, 2, 4, … devices and reports throughput
and parallel efficiency.  Where the shards share one device (the CPU, or a
mesh that repeats a card) the numbers validate the harness and the
sharding, not scaling; across distinct cards they measure it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import trimmed_mean
from lz4jpeg_tpu_torch.utils.profiling import time_device


def jpeg_scaling_sweep(
    image_size: int = 512,
    mesh_sizes: Optional[List[int]] = None,
    runs: int = 5,
    output: Optional[str] = None,
    device="cuda",
) -> List[Dict]:
    """Time the sharded MCU stage of one ``image_size``² noise frame (seed
    0) over meshes of ``mesh_sizes`` shards on ``device`` (default: 1, 2, 4,
    … up to ``codec_mesh``'s device count); print and return one entry per
    size, and write them as JSON to ``output`` if given."""
    from lz4jpeg_tpu_torch.config import JPEGConfig, MeshConfig
    from lz4jpeg_tpu_torch.parallel import ShardedJPEGForward, codec_mesh
    from lz4jpeg_tpu_torch.parallel.mesh import shard_leading_axis

    n_dev = codec_mesh(MeshConfig(), device).size
    sizes = mesh_sizes or [s for s in (1, 2, 4, 8, 16, 32) if s <= n_dev]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(image_size, image_size, 3), dtype=np.uint8)
    results = []
    base_mean = None
    shared = False
    for n in sizes:
        mesh = codec_mesh(MeshConfig(num_devices=n), device)
        shared |= len(set(mesh.devices)) < mesh.size
        fwd = ShardedJPEGForward(mesh, JPEGConfig(precision="fast"))
        tiles, _ = fwd._tiles(img)
        args = shard_leading_axis(tiles, mesh)
        times = time_device(fwd._mcu_stage, *args, runs=runs)
        mean = trimmed_mean(times)
        if base_mean is None:
            base_mean = mean
        speedup = base_mean / mean
        results.append(
            {
                "devices": n,
                "mean_s": mean,
                "speedup": speedup,
                "efficiency": speedup / (n / sizes[0]),
                "mpix_per_s": image_size * image_size / 1e6 / mean,
            }
        )
        print(
            f"{n} devices: {mean*1e3:.2f} ms  speedup {speedup:.2f}x  "
            f"efficiency {results[-1]['efficiency']:.2f}"
        )
    if output:
        import json

        payload = {
            "image_size": image_size,
            "platform": torch.device(device).type,
            "runs": runs,
            "entries": results,
        }
        if payload["platform"] == "cpu" or shared:
            payload["note"] = (
                "shards sharing one device: wall-clock speedup/efficiency "
                "are not meaningful here — this sweep validates sharded "
                "correctness and the per-shard overhead only; real scaling "
                "needs distinct cards"
            )
        with open(output, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {output}")
    return results
