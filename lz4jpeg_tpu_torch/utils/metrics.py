"""Quality metrics.

A copy of ``lz4jpeg_tpu/utils/metrics.py`` (framework-free;
``tests/test_torch_lz4_parity.py`` holds its outputs equal to the
original's).

``mse`` mirrors the reference's (disabled) ``calculate_mse``
(JPEG.c:377-397): mean squared difference between a single original plane
and the *red* channel of the reconstruction.  ``mse_rgb`` / ``psnr`` are
the framework's useful generalizations.
"""

from __future__ import annotations

import numpy as np


def mse(original_plane: np.ndarray, reconstructed_rgb: np.ndarray) -> float:
    """Reference-faithful: plane vs reconstruction's R channel."""
    diff = original_plane.astype(np.float64) - reconstructed_rgb[
        ..., 0
    ].astype(np.float64)
    return float(np.mean(diff * diff))


def mse_rgb(a: np.ndarray, b: np.ndarray) -> float:
    diff = a.astype(np.float64) - b.astype(np.float64)
    return float(np.mean(diff * diff))


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    m = mse_rgb(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / m))
