"""Configuration of the PyTorch codecs.

``JPEGConfig`` mirrors ``lz4jpeg_tpu/config.py::JPEGConfig``: precision
"fast" (float32, the fused basis products and the K1 kernel) or "exact"
(float64, the staged DCT → quantize → zigzag path, coefficient-exact against
the oracle), entropy "shared" (one canonical codebook per channel) or
"per_block" (the reference's quirk-exact tree per block per channel).
``dtype`` is the transforms' torch dtype.  ``sparse16_eligible`` is the
table half of the layout gate (sparse16 needs every entry at least 3); the
pipeline adds the mode half: sparse16 only for fast, shared pipelines, as
the JAX pipeline's ``_pack16`` does.

``LZ4Config`` is a copy of ``lz4jpeg_tpu/config.py::LZ4Config``: the same
fields, defaults and validation; ``models/lz4.py::LZ4Codec`` takes every
mode and the encode log.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Smallest quant-table entry for which |quantized value| ≤ 511 holds, so the
# sparse-delta uint16 layout can carry every coefficient (models/jpeg.py of
# the JAX package, the ``_pack16`` gate).
SPARSE16_MIN_TABLE = 3

def sparse16_eligible(tables) -> bool:
    """True when every table's smallest entry keeps coefficients in 10 bits."""
    return all(int(np.min(t)) >= SPARSE16_MIN_TABLE for t in tables)


@dataclasses.dataclass(frozen=True)
class JPEGConfig:
    """Knobs of the JPEG-style pipeline (8×8 luma MCUs, 4:2:2 chroma)."""

    # The JAX config's first field, kept so both configs carry the same
    # fields; the pipeline, like the JAX one, reads none of it (8 is fixed).
    mcu_size: int = 8
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

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype of the transforms: float64 for "exact" (real
        float64 on every device), float32 for "fast"."""
        return torch.float64 if self.precision == "exact" else torch.float32


@dataclasses.dataclass(frozen=True)
class LZ4Config:
    """Knobs of the LZ4-style block codec.

    Defaults reproduce the reference constants
    (``Algorithms/sequential/LZ4/LZ4.c:20-23``).
    """

    block_length: int = 300          # DEFAULT_BLOCK_LENGTH
    min_match_length: int = 4        # MIN_MATCH_LENGTH
    max_match_length: int = 1024     # MAX_MATCH_LENGTH
    window_size: int = 65535         # WINDOW_SIZE
    # "parity" replicates every reference quirk bit-for-bit; "fast" is the
    # LZ4T frame (64 KiB blocks on the host, 16 KiB on the device).
    mode: str = "parity"
    # Append-mode encode log (the reference's encoding_log.txt).  None
    # disables logging.
    log_path: Optional[str] = None
    # Device match finder for fast mode: "fused" is the single-kernel
    # matcher (ops/fused_match.py: the Hopper kernel on a CUDA device, its
    # plain torch version on the CPU); "sort" is the two-sort formulation
    # (ops/lz4_fast.py).
    matcher: str = "fused"
    # Anchor stride for the fused matcher: matches may start only every
    # N-th byte.  1 = full quality; 2/4 trade ratio for throughput.
    match_stride: int = 1
    # Suffix words carried through the matcher's lcp verification (the
    # in-parse match-length cap is 4·words bytes; emission extends past it).
    match_lcp_words: int = 4

    def __post_init__(self):
        # The reference rejects this exact value (LZ4.c:672-677, :1040-1045).
        if self.block_length == 500:
            raise ValueError("block length cannot have the value 500")
        if self.mode not in ("parity", "fast"):
            raise ValueError(f"unknown LZ4 mode: {self.mode!r}")
        if self.matcher not in ("sort", "fused"):
            raise ValueError(f"unknown matcher: {self.matcher!r}")
        if self.match_stride not in (1, 2, 4):
            raise ValueError(
                f"match_stride must be 1, 2 or 4: {self.match_stride}"
            )
        if self.match_lcp_words not in (1, 2, 4):
            raise ValueError(
                f"match_lcp_words must be 1, 2 or 4: {self.match_lcp_words}"
            )
