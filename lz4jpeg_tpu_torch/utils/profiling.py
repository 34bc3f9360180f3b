"""Profiling and honest device timing.

Port of ``lz4jpeg_tpu/utils/profiling.py``.  The reference's only
"profiler" is ``clock()`` around child processes
(``Experiment/LZ4_sequential_experiment.c:99-116``).  Here: ``torch.profiler``
traces for kernel-level inspection, and a fenced wall-clock timer for
end-to-end numbers.

``fenced`` exists because PyTorch returns before the device finishes.
Reducing every output to one float64 checksum and reading it back to the
host is the fence that cannot lie (a checksum over the full output, never
lengths alone: ``profiles/profile_fence_dce.py``); its cost (one
device→host read per device) is charged to the measurement.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, List

import numpy as np
import torch


def _leaves(out):
    """The tensors and numpy arrays of a nested output (dicts, lists,
    tuples), in order."""
    if isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            yield from _leaves(v)
    elif isinstance(out, (torch.Tensor, np.ndarray)):
        yield out


def checksum(out) -> float:
    """Float64 sum of every element of every tensor or array in ``out``,
    read back to the host: one per-device sum, then one read per device."""
    sums = {}
    total = 0.0
    for leaf in _leaves(out):
        if isinstance(leaf, np.ndarray):
            total += float(leaf.sum(dtype=np.float64))
        else:
            s = leaf.sum(dtype=torch.float64)
            sums.setdefault(leaf.device, []).append(s)
    for parts in sums.values():
        total += float(torch.stack(parts).sum())
    return total


def device_checksum(t: torch.Tensor) -> torch.Tensor:
    """A 0-d float32 tensor on ``t``'s device that depends on every byte of
    ``t``: the wrapping integer sum of its bytes read as the widest
    integers (8, 4, 2 or 1 bytes) that tile them.  It reads ``t`` once and
    writes nothing of its size, where ``t.sum(dtype=torch.float32)`` of an
    integer tensor first builds a widened copy: the fence of the chained
    benchmarks, whose carry stays on the device."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    if flat.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=t.device)
    for dtype in (torch.int64, torch.int32, torch.int16):
        width = torch.empty((), dtype=dtype).element_size()
        if flat.numel() % width == 0 and flat.storage_offset() % width == 0:
            flat = flat.view(dtype)
            break
    return flat.sum(dtype=flat.dtype).to(torch.float32)


def fenced(fn: Callable) -> Callable[..., float]:
    """Wrap ``fn`` so calling it executes fully and returns the checksum of
    its whole output."""
    return lambda *args: checksum(fn(*args))


def time_device(
    fn: Callable, *args, runs: int = 10, warmup: int = 2
) -> List[float]:
    """Fenced per-run wall times of a device computation, in seconds."""
    f = fenced(fn)
    for _ in range(warmup):
        f(*args)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        f(*args)
        times.append(time.perf_counter() - t0)
    return times


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[str]:
    """``torch.profiler`` scope over the host and, for a CUDA ``device``,
    the card; writes a Chrome trace to ``log_dir/trace.json`` (view it with
    Perfetto) and yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
