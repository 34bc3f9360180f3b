"""Benchmark harness mirroring the reference's experiment methodology."""

from lz4jpeg_tpu_torch.bench.harness import (  # noqa: F401
    BenchResult,
    median,
    run_timed,
    trimmed_mean,
)
