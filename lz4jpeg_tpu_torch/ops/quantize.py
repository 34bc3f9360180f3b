"""Quantization ops, quant tables, quality scaling and the zigzag permutations.

Port of ``lz4jpeg_tpu/ops/quantize.py``.  The reference divides by the table
and truncates toward zero via an ``(int)`` cast; it does NOT round
(``Quantize``, JPEG.c:621-629).  The 64-entry luminance table (JPEG.c:12-20),
the 32-entry chrominance table of the 8×4 chroma block (JPEG.c:22-27) and
the two zigzag permutations are re-exported from the oracle copy
(``oracle/jpeg_oracle.py``), their one source in the port, as the JAX package
does.

**Tie snapping.**  For integer pixel inputs some DCT coefficients are exact
multiples of their table entry; there ``trunc(c / q)`` sits on a truncation
boundary and flips with ±1-ulp summation noise.  ``quantize`` snaps ratios
within ``eps`` of an integer to it before truncating, which makes the result
the same for every dtype and summation order (``utils/parity.py`` of the
JAX package holds the tie-aware comparison against the C oracle).
"""

from __future__ import annotations

import numpy as np
import torch

from lz4jpeg_tpu_torch.oracle.jpeg_oracle import (  # noqa: F401  (re-export)
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    reverse_zigzag_indices,
    zigzag_indices,
)

# Snap thresholds: generous against each dtype's DCT rounding noise (~1e-7
# relative for float32 over coefficients up to 2^10, ~1e-13 for float64),
# tight against any non-tie ratio.
SNAP_EPS = {torch.float32: 1e-4, torch.float64: 1e-9}


def scale_table(table, quality):
    """Standard libjpeg quality scaling.

    ``quality`` None returns the table unchanged; 1–100 applies
    ``S = 5000/q`` below 50 else ``200 - 2q``, then
    ``clip((t*S + 50)//100, 1, 255)``.
    """
    if quality is None:
        return table
    s = 5000 // quality if quality < 50 else 200 - 2 * quality
    t = np.asarray(table, np.int64)
    return np.clip((t * s + 50) // 100, 1, 255)


def quantize(coefficients: torch.Tensor, table, snap: bool = True) -> torch.Tensor:
    """Elementwise divide + truncate toward zero, in the coefficients' dtype.
    ``table`` broadcasts over the batch: flat for (N, L) inputs, shaped for
    (N, H, W)."""
    t = torch.as_tensor(np.asarray(table), dtype=coefficients.dtype,
                        device=coefficients.device)
    ratio = coefficients / t
    if snap:
        eps = SNAP_EPS.get(coefficients.dtype, 1e-4)
        nearest = torch.round(ratio)
        ratio = torch.where((ratio - nearest).abs() <= eps, nearest, ratio)
    return torch.trunc(ratio)


def dequantize(coefficients: torch.Tensor, table) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(table), dtype=coefficients.dtype,
                        device=coefficients.device)
    return coefficients * t
