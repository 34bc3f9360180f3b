"""Packed16 run-length compaction along the sublane axis, as a hand-written
kernel.

Port of ``profiles/profile_sublane_butterfly.py::kernel`` (``pallas_call``
:64) and ``profiles/profile_plane_exact.py``'s ``make_kernel(SEG)`` kernel
(:63, ``pallas_call`` :107), which asked whether the RLE butterfly runs on
the transposed (SEG, B) tiles the plane-view einsum emits (block b in
column b), skipping the tile relayout.

``sublane_rle(x)``: (SEG, B) int16 or int32 values, SEG 32 or 64, any B ≥
0 → (packed (SEG, B) int16 holding the uint16 word bits, runs (1, B)
int32): column b's runs front-compacted down the column as ``(count - 1)
<< 10 | (value + 512)``, zeros past them, and its run count, exactly as the
probe writes them.  Values must satisfy |value| ≤ 511, the packed16
format's precondition.  A CPU tensor runs ``sublane_rle_ref`` (K4's plain
version on ``x.t()``, its words transposed back and its lengths halved); a
CUDA tensor launches ``csrc/sublane_rle_kernel.cu`` and adds one to
``sublane_rle.launches``, or raises.  Another SEG, rank or dtype raises on
both devices.

The runners are ``profiles/sublane_butterfly.py`` and
``profiles/plane_exact.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import (
    _check_device,
    _elem_code,
    _launch,
    _values,
    pack16_encode_ref,
)
from lz4jpeg_tpu_torch.profiles import timing

SEGMENTS = (32, 64)


def _columns(x: torch.Tensor) -> torch.Tensor:
    x = _values(x, 2)
    if x.shape[0] not in SEGMENTS:
        raise ValueError(f"the sublane kernel takes SEG in {SEGMENTS}, got "
                         f"{x.shape[0]}")
    return x


def sublane_rle_ref(x: torch.Tensor):
    """Plain version: ``pack16_encode_ref`` of the (B, SEG) blocks
    ``x.t()``, its words transposed back to (SEG, B) and its lengths
    (2 · runs) halved to (1, B) run counts."""
    x = _columns(x)
    words, lengths = pack16_encode_ref(x.t())
    return (words.t().contiguous(),
            torch.div(lengths, 2, rounding_mode="floor").view(1, -1))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/sublane_rle_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("sublane_rle_kernel")
    lib.sublane_rle_launch.restype = ctypes.c_int
    lib.sublane_rle_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
    ]
    timing.bind_attributes(lib, "sublane_rle_attributes", n_args=2)
    lib.sublane_rle_error_string.restype = ctypes.c_char_p
    lib.sublane_rle_error_string.argtypes = [ctypes.c_int]
    return lib


def sublane_rle(x: torch.Tensor):
    """(SEG, B) int16/int32 values → ((SEG, B) int16 packed words, (1, B)
    int32 run counts), SEG 32 or 64.  A CPU tensor runs
    ``sublane_rle_ref``; a CUDA tensor launches the sublane kernel on the
    current stream and adds one to ``sublane_rle.launches``."""
    x = _columns(x)
    dev = _check_device(x)
    if dev.type == "cpu":
        return sublane_rle_ref(x)
    seg, cols = x.shape
    packed = torch.empty((seg, cols), dtype=torch.int16, device=dev)
    runs = torch.empty((1, cols), dtype=torch.int32, device=dev)
    if cols:
        _launch(load_kernel(), "sublane_rle_launch", "sublane_rle_error_string",
                dev, x.data_ptr(), _elem_code(x), packed.data_ptr(),
                runs.data_ptr(), seg, cols)
        sublane_rle.launches += 1
    return packed, runs


sublane_rle.launches = 0


def attributes(seg: int, elem_bytes: int = 4, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of the kernel at ``seg`` on
    ``elem_bytes``-byte values; None on the CPU."""
    return timing.attributes(load_kernel, "sublane_rle_attributes",
                             "sublane_rle_error_string", (seg, elem_bytes),
                             torch.device(device))


def probe_values(seg: int, cols: int, rng: np.random.Generator) -> np.ndarray:
    """The probes' run-structured check input (``profile_plane_exact.py:
    113-114``; at SEG 64 also ``profile_sublane_butterfly.py:76-77``):
    (seg, cols) int32 in [-511, 511], the even columns repeating a value in
    groups of seg / 8 rows."""
    xs = rng.integers(-511, 512, size=(seg, cols)).astype(np.int32)
    g = seg // 8
    xs[:, ::2] = np.repeat(xs[::g, ::2], g, axis=0)[:seg]
    return xs


def uniform_values(seg: int, cols: int, dev: torch.device,
                   seed: int) -> torch.Tensor:
    """The probes' timing input: (seg, cols) int32 uniform in [-511, 511],
    made on ``dev`` from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-511, 512, (seg, cols), dtype=torch.int32,
                         device=dev, generator=gen)


def rle_bytes(seg: int, cols: int, elem_bytes: int = 4) -> int:
    """The bytes the function must move: the values read once, the words
    and the run counts written once."""
    return seg * cols * (elem_bytes + 2) + cols * 4
