"""A bare device copy: the stream ceiling of a hand-written kernel.

Port of ``profiles/probe_pallas_copy_ceiling.py::copy_kernel``, the probe
that asks what a kernel doing nothing but copying can stream.
``stream_copy(x)`` returns a new contiguous tensor holding ``x``'s bytes.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/stream_copy_kernel.cu``, the streaming template of
``csrc/stream_copy.cuh`` (16-byte vectors where source and destination
share their offset modulo 16, bytes otherwise, one CTA a chunk in index
order); on a CPU tensor it runs ``stream_copy_ref``, the plain version.
There is no fallback between the two: a CUDA call launches the kernel or
raises.  ``bench/roofline.py::measure_hbm_stream_ceiling`` times it.

``copy_plan`` mirrors the template's launch plan in Python and
``cta_ranges`` the bytes each CTA copies, so that the CPU tests hold the
plan's coverage; on the card ``launch_plan`` asks the C code for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library


THREADS = 1024  # csrc/stream_copy.cuh's kThreads
CHUNK_VECS = THREADS  # one 16-byte vector a thread
CHUNK_BYTES = 16 * CHUNK_VECS


class CopyPlan(NamedTuple):
    """The template's launch: ``head`` bytes, ``n_vec`` 16-byte vectors
    in ``chunks`` chunks, ``tail`` bytes, ``ctas`` CTAs."""

    head: int
    n_vec: int
    tail: int
    chunks: int
    ctas: int


def copy_plan(n: int, src_mod16: int, dst_mod16: int) -> CopyPlan:
    """``stream_copy::plan`` for ``n`` bytes from a source and to a
    destination at these offsets modulo 16: the vector body where the
    offsets agree (a byte-wise head up to the source's first 16-byte
    boundary, whole vectors, a byte-wise tail), every byte byte-wise where
    they differ; one CTA a chunk of the body or of the byte-wise list,
    whichever needs more."""
    head, n_vec, tail = n, 0, 0
    if src_mod16 % 16 == dst_mod16 % 16:
        head = min((16 - src_mod16 % 16) % 16, n)
        n_vec = (n - head) // 16
        tail = n - head - 16 * n_vec
    chunks = -(-n_vec // CHUNK_VECS)
    ctas = max(chunks, -(-(head + tail) // CHUNK_BYTES))
    return CopyPlan(head, n_vec, tail, chunks, ctas)


def cta_ranges(plan: CopyPlan) -> np.ndarray:
    """(R, 3) int64 rows ``(cta, start, stop)``: the byte ranges of the
    copy that each CTA of ``copy_kernel`` writes, from its index arithmetic
    (chunk ``cta`` of the body, then chunk ``cta`` of the byte-wise list:
    the head, then the tail)."""
    rows = []
    c = np.arange(plan.chunks, dtype=np.int64)
    lo = plan.head + 16 * c * CHUNK_VECS
    hi = plan.head + 16 * np.minimum((c + 1) * CHUNK_VECS, plan.n_vec)
    rows.append(np.stack([c, lo, hi], axis=1))
    rest = plan.head + plan.tail
    tail0 = plan.head + 16 * plan.n_vec
    c = np.arange(-(-rest // CHUNK_BYTES), dtype=np.int64)
    j0, j1 = c * CHUNK_BYTES, np.minimum((c + 1) * CHUNK_BYTES, rest)
    # the part of [j0, j1) in the head, then the part in the tail
    h0, h1 = np.minimum(j0, plan.head), np.minimum(j1, plan.head)
    t0 = tail0 + np.maximum(j0, plan.head) - plan.head
    t1 = tail0 + np.maximum(j1, plan.head) - plan.head
    rows.append(np.stack([c, h0, h1], axis=1))
    rows.append(np.stack([c, t0, t1], axis=1))
    out = np.concatenate(rows).reshape(-1, 3)
    return out[out[:, 2] > out[:, 1]]


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
    lib.stream_copy_plan.restype = None
    lib.stream_copy_plan.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.stream_copy_error_string.restype = ctypes.c_char_p
    lib.stream_copy_error_string.argtypes = [ctypes.c_int]
    return lib


def launch_plan(src: int, dst: int, n: int) -> CopyPlan:
    """The plan the C code launches for ``n`` > 0 bytes between these
    device addresses (``csrc/stream_copy_kernel.cu::stream_copy_plan``)."""
    out = (ctypes.c_int64 * 4)()
    load_kernel().stream_copy_plan(src, dst, n, out)
    head, n_vec, tail, ctas = out
    return CopyPlan(head, n_vec, tail, -(-n_vec // CHUNK_VECS), ctas)


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
