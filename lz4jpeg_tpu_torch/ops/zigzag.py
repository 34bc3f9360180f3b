"""Zigzag reordering as a batched gather.

Port of ``lz4jpeg_tpu/ops/zigzag.py``.  The reference walks anti-diagonals
with per-element control flow (``zigzag_pattern``, JPEG.c:693-728); here the
permutation is a constant from the oracle's literal transcription and the op
is one ``index_select`` along the last axis.  The inverse gathers with the
inverse of the reference's scatter (``reverse_zigzag_pattern``,
JPEG.c:729-764).
"""

from __future__ import annotations

import numpy as np
import torch

from lz4jpeg_tpu_torch.ops.quantize import reverse_zigzag_indices, zigzag_indices


def _inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return inv


def _take(x: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    return x.index_select(1, torch.from_numpy(perm).to(x.device))


def zigzag(blocks: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(N, H*W) or (N, H, W) blocks → (N, H*W) zigzag streams."""
    flat = blocks.reshape(blocks.shape[0], height * width)
    return _take(flat, zigzag_indices(width, height))


def reverse_zigzag(zz: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(N, H*W) zigzag streams → (N, H*W) row-major blocks."""
    return _take(zz, _inverse_permutation(reverse_zigzag_indices(width, height)))
