"""Configuration of the PyTorch JPEG pipeline.

Mirrors ``lz4jpeg_tpu/config.py::JPEGConfig``.  The port carries the fast
sparse16 path only: ``precision="exact"``, ``entropy="per_block"`` and
quality settings whose tables force the int16 pair layout raise
``NotImplementedError`` naming the ROADMAP item that ports them.  They never
fall back to another path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE,
    LUMINANCE_QUANTIZATION_TABLE,
    scale_table,
)

# Smallest quant-table entry for which |quantized value| ≤ 511 holds, so the
# sparse-delta uint16 layout can carry every coefficient (models/jpeg.py of
# the JAX package, the ``_pack16`` gate).
SPARSE16_MIN_TABLE = 3

_REMAINING_MODES = "ROADMAP.md queue 1, item 'JPEG remaining modes'"


def sparse16_eligible(tables) -> bool:
    """True when every table's smallest entry keeps coefficients in 10 bits."""
    return all(int(np.min(t)) >= SPARSE16_MIN_TABLE for t in tables)


@dataclasses.dataclass(frozen=True)
class JPEGConfig:
    """Knobs of the JPEG-style pipeline (8×8 luma MCUs, 4:2:2 chroma)."""

    precision: str = "fast"
    entropy: str = "shared"
    # None = the reference's fixed tables; 1–100 scales them (libjpeg curve).
    quality: Optional[int] = None

    def __post_init__(self):
        if self.precision not in ("exact", "fast"):
            raise ValueError(f"unknown precision: {self.precision!r}")
        if self.entropy not in ("per_block", "shared"):
            raise ValueError(f"unknown entropy mode: {self.entropy!r}")
        if self.quality is not None and not 1 <= self.quality <= 100:
            raise ValueError(f"quality must be in [1, 100]: {self.quality}")
        if self.precision == "exact":
            raise NotImplementedError(
                f'precision="exact" is not ported yet ({_REMAINING_MODES})'
            )
        if self.entropy == "per_block":
            raise NotImplementedError(
                f'entropy="per_block" is not ported yet ({_REMAINING_MODES})'
            )
        tables = (
            scale_table(LUMINANCE_QUANTIZATION_TABLE, self.quality),
            scale_table(CHROMINANCE_QUANTIZATION_TABLE, self.quality),
        )
        if not sparse16_eligible(tables):
            raise NotImplementedError(
                f"quality={self.quality} gives a quant table below "
                f"{SPARSE16_MIN_TABLE}, which needs the int16 pair layout; "
                f"not ported yet ({_REMAINING_MODES})"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        """Compute dtype of the transforms: float32 (the fast path)."""
        return torch.float32
