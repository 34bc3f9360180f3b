"""Run-length compaction into [count, value] pairs as a hand-written kernel.

Port of ``profiles/pallas_rle.py``, the Pallas candidate (a concentrator
network of lane rolls) that the JAX package measured against its sort
formulation (``ops/rle.py``) and kept out of the package.
``rle_encode_candidate(values)`` takes (N, L) int16-range blocks and returns
((N, 2L) int16 interleaved [count, value] pairs, runs front-compacted and
zero-padded, (N,) int32 lengths = 2·runs), as ``rle_encode_pallas`` does.
L must be a power of two of at most 128, that function's own contract; its
padding of rows to 128 lanes was a TPU detail and is gone.

The plain version is ``ops/rle.py::rle_encode_batched`` with the pairs cast
to int16.  A CPU tensor runs it; a CUDA tensor launches
``csrc/rle_compact_kernel.cu`` (a warp ballot of the run starts, ``__popc``
ranks, a direct store of each run to its rank slot) or raises.  Both compare
the values as int32 and cast them to int16 on the way out, so they agree on
every int16 or int32 input.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch, _values
from lz4jpeg_tpu_torch.ops.rle import rle_encode_batched

MAX_SEG = 128


def _check_seg(length: int) -> None:
    if length < 1 or length & (length - 1) or length > MAX_SEG:
        raise ValueError(
            f"segment length {length} must be a power of two ≤ {MAX_SEG}"
        )


def rle_encode_candidate_ref(values: torch.Tensor):
    """Plain version of the kernel: ``rle_encode_batched`` with int16 pairs."""
    x = _values(values, 2)
    _check_seg(x.shape[1])
    pairs, lengths = rle_encode_batched(x)
    return pairs.to(torch.int16), lengths


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/rle_compact_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("rle_compact_kernel")
    lib.rle_compact_launch.restype = ctypes.c_int
    lib.rle_compact_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.rle_compact_error_string.restype = ctypes.c_char_p
    lib.rle_compact_error_string.argtypes = [ctypes.c_int]
    return lib


def rle_encode_candidate(values: torch.Tensor):
    """(N, L) int16 or int32 blocks → ((N, 2L) int16 [count, value] pairs,
    (N,) int32 lengths = 2·runs); L a power of two ≤ 128.

    A CPU tensor runs ``rle_encode_candidate_ref``.  A CUDA tensor launches
    the compaction kernel on the current stream and adds one to
    ``rle_encode_candidate.launches``."""
    x = _values(values, 2)
    _check_seg(x.shape[1])
    dev = _check_device(x)
    if dev.type == "cpu":
        return rle_encode_candidate_ref(x)
    if x.data_ptr() % 16:  # the kernel loads up to 16 bytes a lane
        x = x.clone()
    n, length = x.shape
    pairs = torch.empty((n, 2 * length), dtype=torch.int16, device=dev)
    lengths = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        _launch(load_kernel(), "rle_compact_launch", "rle_compact_error_string",
                dev, x.data_ptr(), x.element_size(), pairs.data_ptr(),
                lengths.data_ptr(), n, length)
        rle_encode_candidate.launches += 1
    return pairs, lengths


rle_encode_candidate.launches = 0
