"""Headline benchmark: JPEG forward throughput on one device.

Port of the repository root's ``bench.py::main`` (which stays the JAX
package's).  Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "MPix/s", "vs_baseline": N}

Metric: device-side MPix/s of the batched sparse16 forward (colour → 4:2:2
→ DCT + quantize + zigzag → sparse-delta RLE; K1 on a CUDA device) over
``batch`` noise frames of ``size``² (default 2048², the reference's
largest experiment size, batch 256).  Each timed run chains ``CHAIN``
forwards, folding each forward's checksum (over its whole output) into the
next on the device, and reads the last one back: 10 runs after 2 warm-up
runs, trimmed mean dropping min and max (``Experiment/
JPEG_parallel_experiment.c``).  The metric's name ends in the device type,
e.g. ``jpeg_forward_throughput_2048_b256_cuda``.

Baseline: the reference's parallel JPEG at 2048×2048 took a trimmed-mean
26.7048 s on its author's machine (BASELINE.md), forward and inverse;
``vs_baseline`` divides by that whole-pipeline rate.

    python -m lz4jpeg_tpu_torch bench headline [--device cuda]
"""

from __future__ import annotations

import json

import numpy as np
import torch

SIZE = 2048
BATCH = 256  # frames per forward
CHAIN = 4  # forwards per timed run
RUNS = 10
WARMUP = 2
BASELINE_S = 26.7048  # reference parallel JPEG, 2048², trimmed mean
BASELINE_MPIX_S = 2048 * 2048 / 1e6 / BASELINE_S


def main(size: int = SIZE, batch: int = BATCH, device="cuda") -> dict:
    """Time the forward, print the JSON line and return it as a dict."""
    from lz4jpeg_tpu_torch.bench.harness import bench_device, run_timed
    from lz4jpeg_tpu_torch.config import JPEGConfig
    from lz4jpeg_tpu_torch.models.jpeg import JPEGPipeline
    from lz4jpeg_tpu_torch.utils.inputs import generate_noise_image
    from lz4jpeg_tpu_torch.utils.profiling import device_checksum

    dev = bench_device(device)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(
        np.stack([generate_noise_image(size, size, rng) for _ in range(batch)])
    ).to(dev)
    pipeline = JPEGPipeline(JPEGConfig(precision="fast", entropy="shared"), dev)

    def forward_fenced(rgb_batch, carry):
        # Checksum exactly what encode ships (the combined sparse16
        # buffer), reading it once.
        return carry + device_checksum(pipeline._forward_rle(rgb_batch))

    def step():
        s = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(CHAIN):
            s = forward_fenced(imgs, s)
        float(s)

    result = run_timed(
        f"jpeg_forward_{size}_b{batch}",
        step,
        scale=size,
        runs=RUNS,
        warmup=WARMUP,
        work=CHAIN * batch * size * size / 1e6,
        work_unit="MPix",
    )
    line = {
        "metric": f"jpeg_forward_throughput_{size}_b{batch}_{dev.type}",
        "value": round(result.throughput, 2),
        "unit": "MPix/s",
        "vs_baseline": round(result.throughput / BASELINE_MPIX_S, 1),
    }
    print(json.dumps(line))
    return line
