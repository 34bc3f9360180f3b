"""The LZ4T resolve as a dense one-hot product on the tensor cores: one
hand-written kernel template for the four TPU probes of the formulation.

Port of the ``pallas_call`` sites of ``profiles/probe_lz4t_mxu_gather.py``
(``kernel3`` :66, :97), ``probe_lz4t_mxu_gather2.py`` (``kernel`` :47,
``make(mode)`` :46, :86), ``probe_lz4t_mxu_gather3.py`` (``kernel`` :51,
``make(T, ...)`` :44, :72) and ``probe_lz4t_mxu_gather4.py`` (``kernel``
:53, ``make(rows_per_step, dtype_mode)`` :48, :93).  The byte at root r of
a block of P bytes is row r >> 7, lane r & 127 of its literals viewed as
(C, 128), C = P / 128; the probes compute it as a one-hot H (outputs × C)
of r >> 7 times the literals, then select the lane r & 127.

``onehot_gather(root, lit, kernel)`` takes (B, P) int32 roots and (B, P)
uint8 literals (P a multiple of 2,048 and of the kernel's step, at most
65,536) and returns the kernel's (B, P) output.  It prepares the literal
operand with torch ops, as the probes' XLA code did around the call (bf16,
or the transposed (B, 128, C) slab as bf16 or as int8 v − 128), then on a
CUDA tensor launches ``csrc/onehot_gather_kernel.cu``'s instantiation
``kernel`` of ``KERNELS`` and adds one to ``onehot_gather.launches``; a CPU
tensor runs ``onehot_gather_ref``, the same dense product in float64 (exact
for these integers).  Other shapes raise ``ValueError``, other dtypes
``TypeError``, on both devices.

``ROWS`` are the probes' ten timed rows and ``row_output`` runs one with
the probe's torch code around the kernel (g2's transposes of the roots and
back); several rows share a kernel.  The run is
``profiles/lz4t_mxu_gather.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

LANES = 128  # r & 127
STEP_QUANTUM = 16 * LANES  # P must hold whole 16-deep k-slices
MAX_P = 65_536  # C ≤ 512: the literal slab must fit in shared memory
HL, LT_HT = 0, 1  # orientations: H · L (outputs as A rows), Lᵀ · Hᵀ (B columns)
FULL, NOMASK, HBUILD = 0, 1, 2  # the cuts


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One instantiation of the template (its id is its index in
    ``KERNELS``)."""

    name: str
    orient: int
    elem: torch.dtype  # torch.bfloat16 (f32 accumulate) or torch.int8 (s32)
    cut: int
    step: int  # outputs a CTA: the probe's grid step
    out: torch.dtype

    @property
    def bias(self) -> int:
        return 128 if self.elem == torch.int8 else 0

    @property
    def rate(self) -> float:
        return (timing.INT8_OP_PER_S if self.elem == torch.int8
                else timing.BF16_FLOP_PER_S)


KERNELS = (
    Kernel("hl_bf16_full_2048_u8", HL, torch.bfloat16, FULL, 2048, torch.uint8),
    Kernel("hl_bf16_full_2048", HL, torch.bfloat16, FULL, 2048, torch.int32),
    Kernel("hl_bf16_nomask_2048", HL, torch.bfloat16, NOMASK, 2048, torch.int32),
    Kernel("hl_bf16_hbuild_2048", HL, torch.bfloat16, HBUILD, 2048, torch.int32),
    Kernel("hl_bf16_full_512", HL, torch.bfloat16, FULL, 512, torch.int32),
    Kernel("hl_bf16_full_1024", HL, torch.bfloat16, FULL, 1024, torch.int32),
    Kernel("lt_bf16_full_4096", LT_HT, torch.bfloat16, FULL, 4096, torch.int32),
    Kernel("lt_i8_full_4096", LT_HT, torch.int8, FULL, 4096, torch.int32),
    Kernel("lt_i8_full_2048", LT_HT, torch.int8, FULL, 2048, torch.int32),
)
BY_NAME = {k.name: k for k in KERNELS}


@dataclasses.dataclass(frozen=True)
class Row:
    """A probe's timed row: its kernel, and whether the roots go in
    transposed per 2,048-output step and the output comes back (g2)."""

    name: str
    site: str
    kernel: str
    transposed: bool = False


_G1, _G2 = "probe_lz4t_mxu_gather.py:66", "probe_lz4t_mxu_gather2.py:47"
_G3, _G4 = "probe_lz4t_mxu_gather3.py:51", "probe_lz4t_mxu_gather4.py:53"
ROWS = (
    Row("g1", _G1, "hl_bf16_full_2048_u8"),
    Row("g2 full", _G2, "hl_bf16_full_2048", True),
    Row("g2 nomask", _G2, "hl_bf16_nomask_2048", True),
    Row("g2 hbuild", _G2, "hl_bf16_hbuild_2048", True),
    Row("g3 T=512", _G3, "hl_bf16_full_512"),
    Row("g3 T=1024", _G3, "hl_bf16_full_1024"),
    Row("g3 T=2048", _G3, "hl_bf16_full_2048"),
    Row("g4 R=32 bf16", _G4, "lt_bf16_full_4096"),
    Row("g4 R=32 i8", _G4, "lt_i8_full_4096"),
    Row("g4 R=16 i8", _G4, "lt_i8_full_2048"),
)
G2_SUB = 16  # g2's roots per step as (SUB, 128), transposed to (128, SUB)


# ---------------------------------------------------------------------------
# Operands and the plain version
# ---------------------------------------------------------------------------


def _operands(root: torch.Tensor, lit: torch.Tensor, kernel: str) -> Kernel:
    if kernel not in BY_NAME:
        raise ValueError(f"unknown kernel {kernel!r}; the kernels are "
                         f"{list(BY_NAME)}")
    spec = BY_NAME[kernel]
    if root.dtype != torch.int32 or lit.dtype != torch.uint8:
        raise TypeError(f"expected int32 roots and uint8 literals, got "
                        f"{root.dtype} and {lit.dtype}")
    if root.dim() != 2 or root.shape != lit.shape:
        raise ValueError(f"expected equal (B, P) roots and literals, got "
                         f"{tuple(root.shape)} and {tuple(lit.shape)}")
    p = root.shape[1]
    if p <= 0 or p % STEP_QUANTUM or p % spec.step or p > MAX_P:
        raise ValueError(f"P = {p} must be a positive multiple of "
                         f"{STEP_QUANTUM} and of {kernel}'s step {spec.step}, "
                         f"at most {MAX_P}")
    return spec


def literal_operand(lit: torch.Tensor, spec: Kernel) -> torch.Tensor:
    """The probes' XLA preparation of the literals: (B, C, 128) bf16 for H
    · L; the transposed (B, 128, C) as bf16, or as int8 v − 128, for Lᵀ ·
    Hᵀ."""
    b, p = lit.shape
    l3 = lit.reshape(b, p // LANES, LANES)
    if spec.orient == LT_HT:
        l3 = l3.transpose(1, 2)
    if spec.elem == torch.int8:
        return (l3.to(torch.int16) - 128).to(torch.int8).contiguous()
    return l3.to(torch.bfloat16).contiguous()


def onehot_gather_ref(root: torch.Tensor, lit: torch.Tensor,
                      kernel: str) -> torch.Tensor:
    """Plain version: the kernel's dense product and selection in float64
    (exact: every term is 0 or an integer below 2⁸, a sum at most 128 of
    them), a few blocks at a time."""
    spec = _operands(root, lit, kernel)
    b, p = root.shape
    chunks = p // LANES
    op = literal_operand(lit.contiguous(), spec)
    hi, lo = (root >> 7).long(), (root & (LANES - 1)).long()
    ks = torch.arange(chunks, device=root.device)
    out = torch.empty((b, p), dtype=torch.int64, device=root.device)
    per = max(1, (1 << 25) // (p * chunks))  # one-hot elements a pass
    for b0 in range(0, b, per):
        b1 = min(b, b0 + per)
        h = (hi[b0:b1, :, None] == ks).to(torch.float64)  # (b, P, C)
        if spec.cut == HBUILD:
            out[b0:b1] = h.sum(-1).long() + lo[b0:b1]
            continue
        lits = op[b0:b1].to(torch.float64)
        if spec.orient == HL:
            rows = h @ lits  # (b, P, 128): output × lane
        else:
            rows = (lits @ h.transpose(1, 2)).transpose(1, 2)  # from lane × output
        vals = rows.long() + spec.bias
        out[b0:b1] = (vals.gather(2, lo[b0:b1, :, None]).squeeze(2)
                      if spec.cut == FULL else vals.sum(-1))
    return out.to(spec.out)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/onehot_gather_kernel.cu`` at first use, bind it, and
    check its instantiations against ``KERNELS``."""
    lib = load_cuda_library("onehot_gather_kernel")
    lib.onehot_gather_launch.restype = ctypes.c_int
    lib.onehot_gather_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.onehot_gather_variant_count.restype = ctypes.c_int
    lib.onehot_gather_describe.restype = ctypes.c_int
    lib.onehot_gather_describe.argtypes = (
        [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5)
    timing.bind_attributes(lib, "onehot_gather_attributes")
    lib.onehot_gather_error_string.restype = ctypes.c_char_p
    lib.onehot_gather_error_string.argtypes = [ctypes.c_int]
    if lib.onehot_gather_variant_count() != len(KERNELS):
        raise RuntimeError("onehot_gather_kernel's instantiations are not "
                           "KERNELS")
    for i, k in enumerate(KERNELS):
        got = [ctypes.c_int() for _ in range(5)]
        if lib.onehot_gather_describe(i, *(ctypes.byref(g) for g in got)):
            raise RuntimeError(f"onehot_gather_describe({i}) failed")
        want = [k.orient, k.elem.itemsize, k.cut, k.step, k.out.itemsize]
        if [g.value for g in got] != want:
            raise RuntimeError(f"instantiation {i} is {[g.value for g in got]}"
                               f", KERNELS says {k.name} {want}")
    return lib


def onehot_gather(root: torch.Tensor, lit: torch.Tensor,
                  kernel: str) -> torch.Tensor:
    """(B, P) int32 roots and uint8 literals → the (B, P) output of
    ``kernel`` (a name in ``KERNELS``).  A CPU tensor runs
    ``onehot_gather_ref``; a CUDA tensor launches the instantiation on the
    current stream and adds one to ``onehot_gather.launches``."""
    spec = _operands(root, lit, kernel)
    root, lit = root.contiguous(), lit.contiguous()
    dev = _check_device(root, lit)
    if dev.type == "cpu":
        return onehot_gather_ref(root, lit, kernel)
    op = literal_operand(lit, spec)
    b, p = root.shape
    out = torch.empty((b, p), dtype=spec.out, device=dev)
    if b:
        _launch(load_kernel(), "onehot_gather_launch",
                "onehot_gather_error_string", dev, KERNELS.index(spec),
                root.data_ptr(), op.data_ptr(), out.data_ptr(), b, p)
        onehot_gather.launches += 1
    return out


onehot_gather.launches = 0


def attributes(kernel: str, device="cuda") -> Dict:
    """Registers, shared memory (with the 65,536-byte block's slab) and
    CTAs per SM of ``kernel``; None on the CPU."""
    return timing.attributes(load_kernel, "onehot_gather_attributes",
                             "onehot_gather_error_string",
                             KERNELS.index(BY_NAME[kernel]),
                             torch.device(device))


# ---------------------------------------------------------------------------
# The probes' rows
# ---------------------------------------------------------------------------


def row_output(row: Row, root: torch.Tensor, lit: torch.Tensor,
               fn: Callable = onehot_gather) -> torch.Tensor:
    """Row ``row`` through ``fn`` (``onehot_gather`` or its plain version):
    the kernel's (B, P) output in input order; for g2 the roots go in
    transposed per 2,048-output step, (SUB, 128) → (128, SUB), and the
    output is transposed back, as the probe's ``run`` does around its
    kernel."""
    if not row.transposed:
        return fn(root, lit, row.kernel)
    b, p = root.shape
    steps = b * p // (G2_SUB * LANES)
    r_t = root.reshape(steps, G2_SUB, LANES).transpose(1, 2).reshape(b, p)
    out_t = fn(r_t, lit, row.kernel)
    return out_t.reshape(steps, LANES, G2_SUB).transpose(1, 2).reshape(b, p)


def row_bytes(row: Row, root: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """What the probe's row returns: the output as uint8 (for g2's nomask
    and hbuild cuts, the low byte of each sum)."""
    return row_output(row, root, lit).to(torch.uint8)


def row_bound(row: Row, outputs: int, chunks: int,
              dev: Optional[torch.device] = None) -> Dict:
    """The row's least time: the product's 2 · outputs · C · 128 operations
    over the element type's dense tensor rate, or (hbuild) the larger of
    the roots and outputs over 3.35 TB/s and the one-hot's outputs · C
    compares as issued lane instructions (``timing.issue_bound_ms``, None
    on the CPU); the bytes bound counts roots, literals and outputs."""
    spec = BY_NAME[row.kernel]
    if spec.cut == HBUILD:
        n_bytes = outputs * (4 + spec.out.itemsize)
        bytes_ms = timing.bytes_bound_ms(n_bytes)
        issue = timing.issue_bound_ms(outputs * chunks, dev) if dev else None
        by_issue = issue is not None and issue > bytes_ms
        return {"bytes": n_bytes, "bytes_bound_ms": bytes_ms,
                "issue_bound_ms": issue, "operations": outputs * chunks,
                "bound_ms": issue if by_issue else bytes_ms,
                "bound_by": "operations" if by_issue else "bytes"}
    n_bytes = outputs * (4 + 1 + spec.out.itemsize)
    ops = 2 * outputs * chunks * LANES
    ops_ms = ops / spec.rate * 1e3
    bytes_ms = timing.bytes_bound_ms(n_bytes)
    return {"bytes": n_bytes, "bytes_bound_ms": bytes_ms, "operations": ops,
            "ops_bound_ms": ops_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
