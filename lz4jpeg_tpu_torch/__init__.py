"""lz4jpeg_tpu_torch — the PyTorch + CUDA port of lz4jpeg_tpu.

Two paths on one device:

* the JPEG fast path (sparse16 layout, shared-codebook entropy): the
  forward chain runs as a hand-written Hopper kernel
  (``csrc/fwd_megakernel.cu``) on a CUDA device, the entropy stage in the
  native C++ runtime, the inverse as torch ops;
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
