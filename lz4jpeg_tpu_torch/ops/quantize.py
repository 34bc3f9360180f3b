"""Quantization tables, quality scaling and the zigzag permutation.

numpy copies of the JAX package's framework-free code:
``lz4jpeg_tpu/oracle/jpeg_oracle.py`` (the two tables, ``zigzag_indices``)
and ``lz4jpeg_tpu/ops/quantize.py::scale_table``.  The reference divides by
the table and truncates toward zero (``Quantize``, JPEG.c:621-629); the
64-entry luminance table is JPEG.c:12-20 and the 32-entry chrominance table
(8×4 chroma block) JPEG.c:22-27.  ``tests/test_torch_basis.py`` holds every
copy equal to its original.
"""

from __future__ import annotations

from typing import List

import numpy as np

LUMINANCE_QUANTIZATION_TABLE = np.array(
    [
        8, 6, 6, 8, 10, 14, 18, 22,
        6, 6, 7, 9, 12, 20, 22, 20,
        6, 7, 8, 10, 14, 22, 25, 22,
        8, 9, 10, 14, 18, 28, 27, 22,
        10, 12, 14, 18, 22, 35, 33, 26,
        14, 18, 22, 22, 27, 33, 36, 30,
        18, 22, 26, 28, 33, 40, 40, 34,
        22, 26, 28, 30, 36, 34, 35, 33,
    ],
    dtype=np.int64,
)

CHROMINANCE_QUANTIZATION_TABLE = np.array(
    [
        17, 18, 24, 47, 18, 21, 26, 66,
        24, 26, 56, 99, 47, 66, 99, 99,
        66, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int64,
)


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


def zigzag_indices(width: int, height: int) -> np.ndarray:
    """Gather permutation of the reference's generalized zigzag
    (``zigzag_pattern``, JPEG.c:693-728): ``out[k] = flat_input[perm[k]]``."""
    perm: List[int] = []
    for s in range(width + height - 1):
        start_row = 0 if s < width else s - width + 1
        end_row = s if s < height else height - 1
        if s % 2 == 0:
            rows = range(end_row, start_row - 1, -1)
        else:
            rows = range(start_row, end_row + 1)
        for row in rows:
            col = s - row
            if 0 <= col < width:
                perm.append(row * width + col)
    return np.array(perm, dtype=np.int64)
