"""lz4jpeg_tpu_torch — the PyTorch + CUDA port of lz4jpeg_tpu.

The JPEG fast path (sparse16 layout, shared-codebook entropy) on one
device: the forward chain runs as a hand-written Hopper kernel
(``csrc/fwd_megakernel.cu``) on a CUDA device, the entropy stage in the
native C++ runtime, the inverse as torch ops.  ``lz4jpeg_tpu`` (JAX) is the
reference this package is tested against; this package imports neither JAX
nor it.
"""

from lz4jpeg_tpu_torch.config import JPEGConfig
from lz4jpeg_tpu_torch.models.jpeg import (
    JPEGEncoded,
    JPEGPipeline,
    tables_from_numpy,
)

__all__ = ["JPEGConfig", "JPEGEncoded", "JPEGPipeline", "tables_from_numpy"]
