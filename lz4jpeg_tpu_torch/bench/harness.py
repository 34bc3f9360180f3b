"""Timing methodology and result schema.

A copy of ``lz4jpeg_tpu/bench/harness.py``.  Mirrors the reference harness
(``Experiment/LZ4_sequential_experiment.c``): 10 runs per configuration,
the "mean" is a trimmed mean that drops the single min and max run
(``compute_mean`` :11-25), plus a median (``compute_median`` :27-54);
results serialize to the same JSON shape as ``Experiment/results/*.json``
with derived throughput fields added.  Each run is a host wall-clock
measurement around a fully materialized computation: ``fn`` must end on
the host (``utils/profiling.py::fenced`` for device work).

``bench_device`` and ``device_record`` are the port's own: every suite
runs on an explicit torch device and every artifact it writes names it.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from lz4jpeg_tpu_torch.utils.stats import median, trimmed_mean  # noqa: F401
# (single source of truth for the reference-mirroring statistics)


def bench_device(device) -> torch.device:
    """``device`` as a torch device; raises for ``"cuda"`` without a card
    (a measurement never falls back to the CPU) and for other types."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them, or
    ``torch.cuda.get_device_name`` where ``nvidia-smi`` is absent."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired):
        proc = None
    if proc is not None and proc.returncode == 0 and proc.stdout.strip():
        return proc.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(index)


def device_record(device) -> Dict[str, str]:
    """``{"device": "<torch device>"}``, plus ``"card"`` (``card_name``) on
    CUDA: what every artifact of the suites carries."""
    dev = torch.device(device)
    rec = {"device": str(dev)}
    if dev.type == "cuda":
        rec["card"] = card_name(dev)
    return rec


@dataclasses.dataclass
class BenchResult:
    name: str
    scale: int                 # text bytes or image side, like the reference
    times_s: List[float]
    mean_s: float
    median_s: float
    throughput: Optional[float] = None
    throughput_unit: Optional[str] = None

    def to_json(self) -> Dict:
        d = {
            "name": self.name,
            "scale": self.scale,
            "execution_times": self.times_s,
            "mean": self.mean_s,
            "median": self.median_s,
        }
        if self.throughput is not None:
            d["throughput"] = self.throughput
            d["throughput_unit"] = self.throughput_unit
        return d


def run_timed(
    name: str,
    fn: Callable[[], object],
    *,
    scale: int,
    runs: int = 10,
    warmup: int = 1,
    work: Optional[float] = None,
    work_unit: Optional[str] = None,
    retries: int = 3,
) -> BenchResult:
    """Time ``fn`` ``runs`` times after ``warmup`` untimed calls.

    ``work`` is the per-run work amount (bytes, pixels); throughput is
    ``work / mean`` in ``work_unit``/s.  A failing run is retried up to
    ``retries`` times — the harness-level failure handling the reference
    implements as its retry-until-exit-0 loop
    (``Experiment/LZ4_sequential_experiment.c:97-125``).
    """
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        for attempt in range(retries + 1):
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:
                if attempt == retries:
                    raise
                continue
            break
        times.append(time.perf_counter() - t0)
    m = trimmed_mean(times)
    return BenchResult(
        name=name,
        scale=scale,
        times_s=times,
        mean_s=m,
        median_s=median(times),
        throughput=(work / m) if work is not None else None,
        throughput_unit=f"{work_unit}/s" if work_unit else None,
    )


def write_results(path: str, results: List[BenchResult]) -> None:
    with open(path, "w") as f:
        json.dump([r.to_json() for r in results], f, indent=1)
