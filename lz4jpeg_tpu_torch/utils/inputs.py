"""Random benchmark inputs (copy of ``lz4jpeg_tpu/utils/inputs.py``):
per-pixel uniform RGB noise, as the reference's generator makes
(``Experiment/random_image.c:58-77``)."""

from __future__ import annotations

import numpy as np


def generate_noise_image(
    height: int, width: int, rng: np.random.Generator
) -> np.ndarray:
    return rng.integers(0, 256, size=(height, width, 3), dtype=np.uint8)
