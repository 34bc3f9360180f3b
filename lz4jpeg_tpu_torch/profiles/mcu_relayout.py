"""The MCU relayout of the TPU colour-split probe as a hand-written kernel.

Port of ``profiles/profile_colorsplit3.py::kernel`` (made by
``_relayout_kernel(tw)`` :115, ``pallas_tile`` :129, ``pallas_call`` :134),
which relaid a uint8 channel plane into 8 × tw MCU tiles block by block in
VMEM.  ``mcu_relayout(plane, tw)`` takes (..., H, Wp) uint8 planes with H
% 8 == 0 and Wp % tw == 0, tw 8 (luma) or 4 (4:2:2 chroma), and returns
(N, 8·tw) uint8 tiles, frames outermost, then block-row-major: exactly
the tiles of ``ops/color.py::split_mcus`` for such shapes (the zero-padding
of a ragged edge stays ``split_mcus``'s; other shapes raise
``ValueError``, another dtype ``TypeError``, on both devices).  A CPU tensor
runs ``mcu_relayout_ref`` (``split_mcus``'s reshape, transpose and copy); a
CUDA tensor launches ``csrc/mcu_relayout_kernel.cu`` (a CTA stages a band
of 8 rows in shared memory and writes whole tiles with 16-byte stores; a
plane off a 16-byte boundary is copied first) and adds one to
``mcu_relayout.launches``, or raises.  Its run is
``profiles/colorsplit3.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

WIDTHS = (8, 4)  # tw of luma and of 4:2:2 chroma


def _plane(plane: torch.Tensor, tw: int) -> torch.Tensor:
    if plane.dtype != torch.uint8:
        raise TypeError(f"expected a uint8 plane, got {plane.dtype}")
    if tw not in WIDTHS:
        raise ValueError(f"tile width {tw} is not one of {WIDTHS}")
    if (plane.dim() < 2 or plane.shape[-2] % 8 or plane.shape[-1] % tw
            or not plane.shape[-1]):
        raise ValueError(f"expected (..., H, Wp) planes with H % 8 == 0, Wp "
                         f"≥ 1 and Wp % {tw} == 0, got {tuple(plane.shape)}")
    return plane.contiguous()


def mcu_relayout_ref(plane: torch.Tensor, tw: int) -> torch.Tensor:
    """Plain version: ``split_mcus``'s reshape, transpose and copy."""
    plane = _plane(plane, tw)
    wp = plane.shape[-1]
    return (plane.reshape(-1, 8, wp // tw, tw).transpose(1, 2)
            .reshape(-1, 8 * tw))


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/mcu_relayout_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("mcu_relayout_kernel")
    lib.mcu_relayout_launch.restype = ctypes.c_int
    lib.mcu_relayout_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    timing.bind_attributes(lib, "mcu_relayout_attributes", n_args=1)
    lib.mcu_relayout_error_string.restype = ctypes.c_char_p
    lib.mcu_relayout_error_string.argtypes = [ctypes.c_int]
    return lib


def mcu_relayout(plane: torch.Tensor, tw: int) -> torch.Tensor:
    """(..., H, Wp) uint8 planes → (N, 8·tw) uint8 MCU tiles.  A CPU tensor
    runs ``mcu_relayout_ref``; a CUDA tensor launches the relayout kernel
    on the current stream and adds one to ``mcu_relayout.launches``."""
    plane = _plane(plane, tw)
    dev = _check_device(plane)
    if dev.type == "cpu":
        return mcu_relayout_ref(plane, tw)
    if plane.data_ptr() % 16:  # the kernel moves 16 bytes a lane
        plane = plane.clone()
    wp = plane.shape[-1]
    n_bands = plane.numel() // (8 * wp)
    out = torch.empty((n_bands * (wp // tw), 8 * tw), dtype=torch.uint8,
                      device=dev)
    if out.numel():
        _launch(load_kernel(), "mcu_relayout_launch",
                "mcu_relayout_error_string", dev, plane.data_ptr(),
                out.data_ptr(), n_bands, wp, tw)
        mcu_relayout.launches += 1
    return out


mcu_relayout.launches = 0


def attributes(tw: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of the tw kernel; None on
    the CPU."""
    return timing.attributes(load_kernel, "mcu_relayout_attributes",
                             "mcu_relayout_error_string", (tw,),
                             torch.device(device))
