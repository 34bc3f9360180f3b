"""The fused MCU transforms as hand-written kernels.

Port of ``profiles/pallas_mcu.py``, the Pallas candidate that the JAX
package measured against its XLA einsum (``ops/fused.py``) and kept out of
the package.  Two wrappers, each with a plain torch version of the same
function:

* ``fused_forward_candidate``: (N, H, W) uint8 tiles → (N, HW) float32
  quantized zigzag coefficients, ``trunc(snap(x @ M.T - off))`` with ``(M,
  off) = forward_basis(...)`` (``fused_forward_pallas``);
* ``fused_inverse_candidate``: (N, HW) zigzag coefficients → (N, H, W)
  uint8 pixels, ``clamp(c_round(zz @ Minv.T + 128))`` with ``Minv =
  inverse_basis(...)`` (``fused_inverse_pallas``).

HW is 64 (8×8 luma) or 32 (8 rows of 4: a 4:2:2 chroma block).  The plain
versions compute what ``ops/fused.py::fused_forward`` and ``fused_inverse``
compute in float32.  A CPU tensor runs the plain version; a CUDA tensor
launches ``csrc/mcu_transform_kernel.cu`` (an IEEE fp32 FMA chain per output
against the basis in shared memory, never TF32) or raises.  The bases are
built in float64 by ``ops/fused.py``, rounded to float32 and sent to each
device once per (table, shape).  The kernel sums in another order than
cuBLAS or a CPU BLAS, so the two may put a coefficient one step apart at a
truncation tie or a pixel one step apart at a round-half tie
(``utils/parity.py::transform_flips`` counts them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import _snap_trunc
from lz4jpeg_tpu_torch.ops.fused import (
    _round_clamp,
    _table_key,
    forward_basis,
    inverse_basis,
)
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch

TILE_SHAPES = ((8, 8), (4, 8))  # (width, height): luma, 4:2:2 chroma


def _check_shape(width: int, height: int) -> int:
    if (width, height) not in TILE_SHAPES:
        raise ValueError(
            f"tile {width}x{height} is not one of {TILE_SHAPES} (width, height)"
        )
    return width * height


def _tiles(tiles: torch.Tensor, width: int, height: int) -> torch.Tensor:
    _check_shape(width, height)
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (height, width):
        raise ValueError(
            f"expected (N, {height}, {width}) tiles, got {tuple(tiles.shape)}"
        )
    if tiles.dtype != torch.uint8:
        raise TypeError(f"expected uint8 tiles, got {tiles.dtype}")
    _check_device(tiles)
    return tiles.contiguous()


def _coefficients(zz: torch.Tensor, width: int, height: int) -> torch.Tensor:
    hw = _check_shape(width, height)
    if zz.dim() != 2 or zz.shape[1] != hw:
        raise ValueError(f"expected (N, {hw}) coefficients, got {tuple(zz.shape)}")
    _check_device(zz)
    return zz.to(torch.float32).contiguous()


@functools.lru_cache(maxsize=None)
def _forward_basis_on(width: int, height: int, table_key: bytes,
                      device: torch.device):
    """``forward_basis`` on ``device`` in float32: (M.T, the plain
    version's operand as ``fused_forward`` builds it; M row-major, the
    kernel's; the offset)."""
    m, off = forward_basis(width, height, table_key)
    mt = torch.from_numpy(m.T).to(device=device, dtype=torch.float32)
    offs = torch.from_numpy(off).to(device=device, dtype=torch.float32)
    return mt, mt.T.contiguous(), offs


@functools.lru_cache(maxsize=None)
def _inverse_basis_on(width: int, height: int, table_key: bytes,
                      device: torch.device):
    """``inverse_basis`` on ``device`` in float32: (Minv.T, the plain
    version's operand as ``fused_inverse`` builds it; Minv row-major, the
    kernel's).  ``inverse_basis`` is Fortran-ordered in numpy, so the
    kernel's copy must be made contiguous explicitly."""
    minv = inverse_basis(width, height, table_key)
    mt = torch.from_numpy(minv.T).to(device=device, dtype=torch.float32)
    return mt, mt.T.contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def fused_forward_candidate_ref(tiles: torch.Tensor, table: np.ndarray,
                                width: int, height: int,
                                snap_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of the forward kernel: ``ops/fused.py::fused_forward``
    in float32 with the snap threshold ``snap_eps``."""
    x = _tiles(tiles, width, height)
    mt, _, off = _forward_basis_on(width, height, _table_key(table), x.device)
    ratio = x.reshape(x.shape[0], -1).to(torch.float32) @ mt - off
    return _snap_trunc(ratio, snap_eps)


def fused_inverse_candidate_ref(zz: torch.Tensor, table: np.ndarray,
                                width: int, height: int) -> torch.Tensor:
    """Plain version of the inverse kernel: ``ops/fused.py::fused_inverse``
    in float32."""
    z = _coefficients(zz, width, height)
    mt, _ = _inverse_basis_on(width, height, _table_key(table), z.device)
    return _round_clamp(z @ mt + 128.0).reshape(z.shape[0], height, width)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/mcu_transform_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("mcu_transform_kernel")
    lib.mcu_forward_launch.restype = ctypes.c_int
    lib.mcu_forward_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.mcu_inverse_launch.restype = ctypes.c_int
    lib.mcu_inverse_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mcu_transform_error_string.restype = ctypes.c_char_p
    lib.mcu_transform_error_string.argtypes = [ctypes.c_int]
    return lib


def fused_forward_candidate(tiles: torch.Tensor, table: np.ndarray,
                            width: int, height: int,
                            snap_eps: float = 1e-5) -> torch.Tensor:
    """(N, height, width) uint8 tiles → (N, HW) float32 quantized zigzag
    coefficients; (width, height) is (8, 8) or (4, 8).

    A CPU tensor runs ``fused_forward_candidate_ref``.  A CUDA tensor
    launches the forward kernel on the current stream and adds one to
    ``fused_forward_candidate.launches``."""
    x = _tiles(tiles, width, height)
    if x.device.type == "cpu":
        return fused_forward_candidate_ref(x, table, width, height, snap_eps)
    if x.data_ptr() % 16:  # the kernel loads 16 bytes a step
        x = x.clone()
    _, m, off = _forward_basis_on(width, height, _table_key(table), x.device)
    n, hw = x.shape[0], width * height
    out = torch.empty((n, hw), dtype=torch.float32, device=x.device)
    if n:
        _launch(load_kernel(), "mcu_forward_launch",
                "mcu_transform_error_string", x.device, x.data_ptr(),
                m.data_ptr(), off.data_ptr(), out.data_ptr(), n, hw, snap_eps)
        fused_forward_candidate.launches += 1
    return out


def fused_inverse_candidate(zz: torch.Tensor, table: np.ndarray,
                            width: int, height: int) -> torch.Tensor:
    """(N, HW) zigzag quantized coefficients (any real dtype, computed in
    float32) → (N, height, width) uint8 pixels.

    A CPU tensor runs ``fused_inverse_candidate_ref``.  A CUDA tensor
    launches the inverse kernel and adds one to
    ``fused_inverse_candidate.launches``."""
    z = _coefficients(zz, width, height)
    if z.device.type == "cpu":
        return fused_inverse_candidate_ref(z, table, width, height)
    if z.data_ptr() % 16:
        z = z.clone()
    _, minv = _inverse_basis_on(width, height, _table_key(table), z.device)
    n = z.shape[0]
    out = torch.empty((n, height, width), dtype=torch.uint8, device=z.device)
    if n:
        _launch(load_kernel(), "mcu_inverse_launch",
                "mcu_transform_error_string", z.device, z.data_ptr(),
                minv.data_ptr(), out.data_ptr(), n, width * height)
        fused_inverse_candidate.launches += 1
    return out


fused_forward_candidate.launches = 0
fused_inverse_candidate.launches = 0
