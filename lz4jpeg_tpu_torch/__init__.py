"""lz4jpeg_tpu_torch — the PyTorch + CUDA port of lz4jpeg_tpu.

Two paths on one device:

* the JPEG codec in every mode (fast float32 or exact float64 precision,
  shared-codebook or per-block entropy, any quality) and its three RLE
  layouts: sparse16, whose forward chain runs as a hand-written Hopper
  kernel (``csrc/fwd_megakernel.cu``) on a CUDA device; int16 pairs for
  exact, per-block and quality 80–100 pipelines, as torch ops; packed16,
  whose run compaction and expansion are Hopper kernels
  (``csrc/pack16_kernel.cu``, ``csrc/expand16_kernel.cu``,
  ``csrc/expand16_wide_kernel.cu``).  The entropy stage runs in the native
  C++ runtime, the inverse transforms as torch ops; ``oracle/`` holds the
  numpy ground truth;
* the LZ4T fast codec: the fused matcher (``csrc/match_kernel.cu``) and the
  rooted resolve (``csrc/resolve_kernel.cu``) run as Hopper kernels on a
  CUDA device, framing and emission in the native runtime.

``lz4jpeg_tpu`` (JAX) is the reference this package is tested against;
this package imports neither JAX nor it.
"""

from lz4jpeg_tpu_torch.config import JPEGConfig, LZ4Config
from lz4jpeg_tpu_torch.models.jpeg import (
    JPEGEncoded,
    JPEGPipeline,
    tables_from_numpy,
)
from lz4jpeg_tpu_torch.models.lz4 import LZ4Codec

__all__ = [
    "JPEGConfig", "JPEGEncoded", "JPEGPipeline", "LZ4Codec", "LZ4Config",
    "tables_from_numpy",
]
