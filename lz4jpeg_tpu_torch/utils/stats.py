"""Benchmark statistics mirroring the reference harness.

A copy of ``lz4jpeg_tpu/utils/stats.py``.  ``compute_mean`` drops the min
and max of the runs before averaging
(``Experiment/LZ4_sequential_experiment.c:11-25``); ``compute_median`` is
the standard median (:27-54).
"""

from __future__ import annotations

from typing import Sequence


def trimmed_mean(values: Sequence[float]) -> float:
    """Mean excluding one min and one max (reference trimmed mean)."""
    vals = sorted(values)
    if len(vals) <= 2:
        return sum(vals) / len(vals)
    trimmed = vals[1:-1]
    return sum(trimmed) / len(trimmed)


def median(values: Sequence[float]) -> float:
    vals = sorted(values)
    n = len(vals)
    if n % 2 == 1:
        return vals[n // 2]
    return 0.5 * (vals[n // 2 - 1] + vals[n // 2])
