"""A bare device copy: the stream ceiling of a hand-written kernel.

Port of ``profiles/probe_pallas_copy_ceiling.py::copy_kernel``, the probe
that asks what a kernel doing nothing but copying can stream.
``stream_copy(x)`` returns a new contiguous tensor holding ``x``'s bytes.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/stream_copy_kernel.cu`` (16-byte vectors where source and
destination share their offset modulo 16, bytes otherwise); on a CPU
tensor it runs ``stream_copy_ref``, the plain version.  There is no
fallback between the two: a CUDA call launches the kernel or raises.
``bench/roofline.py::measure_hbm_stream_ceiling`` times it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library


def _check(x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError("stream_copy takes a contiguous tensor")


def stream_copy_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``x.clone()``."""
    _check(x)
    return x.clone()


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/stream_copy_kernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("stream_copy_kernel")
    lib.stream_copy_launch.restype = ctypes.c_int
    lib.stream_copy_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.stream_copy_error_string.restype = ctypes.c_char_p
    lib.stream_copy_error_string.argtypes = [ctypes.c_int]
    return lib


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of the contiguous tensor ``x`` (any dtype and shape).

    A CPU tensor runs ``stream_copy_ref``.  A CUDA tensor launches the
    Hopper kernel on the current stream and adds one to
    ``stream_copy.launches``; a refused launch raises."""
    _check(x)
    if x.device.type == "cpu":
        return stream_copy_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel() * x.element_size()
    if n == 0:
        return out
    lib = load_kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.stream_copy_launch(x.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        msg = lib.stream_copy_error_string(rc).decode()
        raise RuntimeError(f"stream_copy_kernel launch failed: {msg} ({rc})")
    stream_copy.launches += 1
    return out


stream_copy.launches = 0
