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
back); several rows share a kernel.  ``onehot_gather_prepared`` launches
on a literal operand already prepared, so that a run can time the kernel
alone.  The run is ``profiles/lz4t_mxu_gather.py``.

The last section mirrors the kernel's register maps in numpy: which
(output, k) each lane's one-hot registers hold (``hot_registers``), which
slab bytes each ``ldmatrix`` fragment delivers (``chunk_offset``,
``ldsm_rows``, ``ldsm_bytes``), what the PTX ISA's m16n8k16 and m16n8k32
fragments stand for (``fragment_map``), which lane holds an output's lane
in the accumulators (``holder``), the runs of steps of the persistent CTAs
(``cta_runs``), and ``emulate``, which composes them into the kernel's
output, so that a layout error shows on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
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
    _check_p(root.shape[1], spec)
    return spec


def _check_p(p: int, spec: Kernel) -> None:
    if p <= 0 or p % STEP_QUANTUM or p % spec.step or p > MAX_P:
        raise ValueError(f"P = {p} must be a positive multiple of "
                         f"{STEP_QUANTUM} and of {spec.name}'s step "
                         f"{spec.step}, at most {MAX_P}")


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
    return onehot_gather_prepared(root, literal_operand(lit, spec), kernel)


onehot_gather.launches = 0


def onehot_gather_prepared(root: torch.Tensor, op: torch.Tensor,
                           kernel: str) -> torch.Tensor:
    """``onehot_gather`` on the CUDA literal operand ``op`` that
    ``literal_operand`` prepared: the kernel alone.  Adds one to
    ``onehot_gather.launches``."""
    spec = BY_NAME[kernel]
    if root.dtype != torch.int32 or root.dim() != 2:
        raise TypeError(f"expected (B, P) int32 roots, got {root.dtype} "
                        f"{tuple(root.shape)}")
    b, p = root.shape
    _check_p(p, spec)
    if op.dtype != spec.elem or op.shape[0] != b or op.numel() != b * p:
        raise ValueError(f"{kernel} takes the ({b}, {p}) operand of "
                         f"literal_operand, got {op.dtype} {tuple(op.shape)}")
    root, op = root.contiguous(), op.contiguous()
    dev = _check_device(root, op)
    if dev.type != "cuda":
        raise ValueError("onehot_gather_prepared launches the kernel: it "
                         "takes CUDA tensors")
    out = torch.empty((b, p), dtype=spec.out, device=dev)
    if b:
        _launch(load_kernel(), "onehot_gather_launch",
                "onehot_gather_error_string", dev, KERNELS.index(spec),
                root.data_ptr(), op.data_ptr(), out.data_ptr(), b, p)
        onehot_gather.launches += 1
    return out


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


def row_roots(row: Row, root: torch.Tensor) -> torch.Tensor:
    """The (B, P) roots as the row's kernel takes them: for g2 transposed
    per 2,048-output step, (SUB, 128) → (128, SUB), as the probe's ``run``
    does before its kernel."""
    if not row.transposed:
        return root
    b, p = root.shape
    steps = b * p // (G2_SUB * LANES)
    return root.reshape(steps, G2_SUB, LANES).transpose(1, 2).reshape(b, p)


def row_output(row: Row, root: torch.Tensor, lit: torch.Tensor,
               fn: Callable = onehot_gather) -> torch.Tensor:
    """Row ``row`` through ``fn`` (``onehot_gather`` or its plain version):
    the kernel's (B, P) output in input order; for g2 the roots go in
    transposed (``row_roots``) and the output is transposed back."""
    out = fn(row_roots(row, root), lit, row.kernel)
    if not row.transposed:
        return out
    b, p = root.shape
    steps = b * p // (G2_SUB * LANES)
    return out.reshape(steps, LANES, G2_SUB).transpose(1, 2).reshape(b, p)


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


# ---------------------------------------------------------------------------
# The kernel's register maps, mirrored in numpy
# ---------------------------------------------------------------------------
# Each function restates one piece of csrc/onehot_gather_kernel.cu (named
# in its docstring) for the 32 lanes of a warp, so that the CPU tests can
# compose the kernel's fragments as the tensor cores would and hold the
# result to ``onehot_gather_ref``.  Lane L is (g, t) = (L // 4, L % 4).

WARPS = 8  # warps a CTA
GROUP = 64  # outputs a warp
SLICE_BYTES = 32  # k bytes a slice: 16 bf16 or 32 s8
SLICE_SLAB = LANES * SLICE_BYTES  # slab bytes a slice
_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def element_format(spec: Kernel) -> Tuple[int, int, int]:
    """(bits an element, consecutive k a register holds, the bits of 1):
    ``Elem<T>``'s kBits, kPer, kOne."""
    return (8, 4, 1) if spec.elem == torch.int8 else (16, 2, 0x3F80)


def slices_of(spec: Kernel, chunks: int) -> int:
    """32-byte k-slices of a C-deep contraction (``slices_of``)."""
    return (chunks * spec.elem.itemsize + SLICE_BYTES - 1) // SLICE_BYTES


def chunk_offset(orient: int, row, c):
    """Slab byte of the 16-byte chunk ``c`` of literal row ``row``
    (``chunk_offset``): H · L rows of 256 bytes, chunks XOR-swizzled by the
    row's low 3 bits; Lᵀ · Hᵀ chunk c in k-slice c // 2 of 128 rows × 32
    bytes, the halves swapped by bit 2 of the row."""
    row, c = np.asarray(row), np.asarray(c)
    if orient == HL:
        return row * 256 + 16 * (c ^ (row & 7))
    return ((c >> 1) * SLICE_SLAB + row * SLICE_BYTES
            + 16 * ((c & 1) ^ ((row >> 2) & 1)))


def operand_bytes(op: torch.Tensor) -> np.ndarray:
    """(B, bytes) uint8: each block's literal operand as stored."""
    raw = op.contiguous().cpu()
    raw = raw.view(torch.int16) if raw.dtype == torch.bfloat16 else raw
    return raw.numpy().reshape(op.shape[0], -1).view(np.uint8)


def stage_slab(spec: Kernel, raw: np.ndarray) -> np.ndarray:
    """(B, slab bytes) uint8: the slab ``stage_slab`` builds from each
    block's operand bytes ``raw``; a byte no chunk writes stays 0xEE."""
    b, n = raw.shape
    chunks = n // spec.elem.itemsize // LANES
    rows = chunks if spec.orient == HL else LANES
    row_chunks = (LANES if spec.orient == HL else chunks) \
        * spec.elem.itemsize // 16
    padded = row_chunks if spec.orient == HL else 2 * slices_of(spec, chunks)
    q = np.arange(rows * padded)
    row, c = q // padded, q % padded
    dst = chunk_offset(spec.orient, row, c)[:, None] + np.arange(16)
    slab = np.full((b, slices_of(spec, chunks) * SLICE_SLAB), 0xEE, np.uint8)
    valid = c < row_chunks
    src = ((row * row_chunks + c)[:, None] * 16 + np.arange(16))[valid]
    slab[:, dst[valid]] = raw[:, src]
    slab[:, dst[~valid]] = 0
    return slab


def one_at(one: int, shift: np.ndarray) -> np.ndarray:
    """``one_at``: one << shift for 0 ≤ shift < 32, else 0 (PTX's clamp)."""
    inside = (shift >= 0) & (shift < 32)
    return np.where(inside, np.left_shift(np.uint64(one), np.where(
        inside, shift, 0).astype(np.uint64)), 0).astype(np.uint32)


def hot_registers(spec: Kernel, roots: np.ndarray, s: int) -> np.ndarray:
    """The one-hot registers of k-slice ``s`` for warp groups of 64 roots
    (N, 64): H · L (N, 32, 4 m-tiles, 4) A fragments; Lᵀ · Hᵀ (N, 32, 8
    n-tiles, 2) B fragments (``product``'s ``compute``, ``gather_group``'s
    d[j] of output 8j + g)."""
    bits, per, one = element_format(spec)
    idx = 8 * np.arange(8)[None, :] + _G[:, None]  # (32, 8): output 8j + g
    d = ((roots[:, idx].astype(np.int64) >> 7) - per * _T[:, None]) * bits
    sh = d - 256 * s
    if spec.orient == HL:
        return np.stack([one_at(one, sh[..., 0::2]), one_at(one, sh[..., 1::2]),
                         one_at(one, sh[..., 0::2] - 128),
                         one_at(one, sh[..., 1::2] - 128)], -1)
    return np.stack([one_at(one, sh), one_at(one, sh - 128)], -1)


def ldsm_rows(spec: Kernel, h: int, s: int) -> np.ndarray:
    """(4 calls, 32): the slab address each lane gives each ldmatrix.x4 of
    pass ``h``, k-slice ``s`` (H · L: n-tiles 2q, 2q + 1, .trans; Lᵀ · Hᵀ:
    m-tile mt)."""
    row = 8 * ((_LANE >> 3) & 1) + (_LANE & 7)
    if spec.orient == HL:
        return np.stack([chunk_offset(HL, row, 8 * h + 2 * q + (_LANE >> 4))
                         + s * SLICE_SLAB for q in range(4)])
    base = chunk_offset(LT_HT, 64 * h + row, _LANE >> 4) + s * SLICE_SLAB
    return np.stack([base + mt * 16 * SLICE_BYTES for mt in range(4)])


def ldsm_bytes(rows: np.ndarray, trans: bool) -> np.ndarray:
    """(32, 4 registers, 4) slab bytes an ldmatrix.x4 (.b16) delivers from
    the row addresses ``rows`` (32,), lane 8m + i giving row i of matrix m:
    lane l's register m holds row l // 4, elements 2 (l % 4) and + 1; with
    .trans, rows 2 (l % 4) and + 1, element l // 4."""
    m = np.arange(4)[None, :]
    if not trans:
        base = rows[8 * m + (_LANE >> 2)[:, None]] + 4 * (_LANE & 3)[:, None]
        return base[..., None] + np.arange(4)
    r0 = rows[8 * m + 2 * (_LANE & 3)[:, None]] + 2 * (_LANE >> 2)[:, None]
    r1 = rows[8 * m + 2 * (_LANE & 3)[:, None] + 1] + 2 * (_LANE >> 2)[:, None]
    return np.stack([r0, r0 + 1, r1, r1 + 1], -1)


def literal_registers(spec: Kernel, slab: np.ndarray, h: int,
                      s: int) -> np.ndarray:
    """The literal fragments of pass ``h``, k-slice ``s`` read from slabs
    (N, bytes): H · L (N, 32, 8 n-tiles, 2) B fragments; Lᵀ · Hᵀ (N, 32, 4
    m-tiles, 4) A fragments (``product``'s ``load``)."""
    rows = ldsm_rows(spec, h, s)
    got = np.stack([ldsm_bytes(rows[i], spec.orient == HL) for i in range(4)],
                   1)  # (32, 4 calls, 4 registers, 4 bytes)
    regs = (slab[:, got].astype(np.uint32)
            << (8 * np.arange(4, dtype=np.uint32))).sum(-1, dtype=np.uint32)
    if spec.orient == HL:  # call q: n-tile 2q (r0, r1), 2q + 1 (r2, r3)
        return regs.reshape(regs.shape[0], 32, 8, 2)
    return regs


def fragment_map(role: str, spec: Kernel) -> np.ndarray:
    """(32, registers, elements, 2): the (row, column) of the mma tile each
    lane's register element stands for, by the PTX ISA's m16n8k16 (bf16)
    and m16n8k32 (s8) layouts: "a" 16 × K, "b" K × 8, "c" the 16 × 8
    accumulator (one element a register)."""
    bits, per, _ = element_format(spec)
    half = 128 // bits  # K / 2
    g, t = _G[:, None, None], _T[:, None, None]
    if role == "c":
        reg = np.arange(4)[None, :, None]
        row, col = g + 8 * (reg >> 1), 2 * t + (reg & 1)
    elif role == "a":
        reg, e = np.arange(4)[None, :, None], np.arange(per)[None, None, :]
        row, col = g + 8 * (reg & 1), per * t + e + half * (reg >> 1)
    else:
        reg, e = np.arange(2)[None, :, None], np.arange(per)[None, None, :]
        row, col = per * t + e + half * reg, g + 0 * e
    return np.stack(np.broadcast_arrays(row, col), -1)


def _elements(spec: Kernel, regs: np.ndarray) -> np.ndarray:
    """Registers (...,) uint32 → (..., elements) int64 values."""
    if spec.elem == torch.int8:
        b = (regs[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
        return b.astype(np.uint8).view(np.int8).astype(np.int64)
    halves = (regs[..., None] >> np.array([0, 16], np.uint32)) & 0xFFFF
    return (halves << 16).astype(np.uint32).view(np.float32).astype(np.int64)


def _tiles(spec: Kernel, regs: np.ndarray, role: str) -> np.ndarray:
    """Fragments (N, 32, tiles, registers) → the tiles (N, tiles, rows,
    columns) they hold."""
    fm = fragment_map(role, spec)  # (32, regs, elems, 2)
    n, _, count = regs.shape[:3]
    k = 256 // element_format(spec)[0]
    tiles = np.zeros((n, count, *((16, k) if role == "a" else (k, 8))),
                     np.int64)
    vals = _elements(spec, regs)  # (N, 32, tiles, regs, elems)
    tiles[:, :, fm[..., 0].reshape(-1), fm[..., 1].reshape(-1)] = \
        vals.transpose(0, 2, 1, 3, 4).reshape(n, count, -1)
    return tiles


def accumulator_map(spec: Kernel) -> np.ndarray:
    """(32, 4 m-tiles, 8 n-tiles, 4, 2): the (output, lane of the pass) of
    each accumulator of a pass (``gather_group``'s acc)."""
    fm = fragment_map("c", spec)[:, :, 0]  # (32, 4, 2): (row, col)
    mt = np.arange(4)[None, :, None, None]
    nt = np.arange(8)[None, None, :, None]
    row = 16 * mt + fm[:, None, None, :, 0]
    col = 8 * nt + fm[:, None, None, :, 1]
    if spec.orient == HL:  # rows are outputs, columns lanes
        return np.stack(np.broadcast_arrays(row, col), -1)
    # Lᵀ · Hᵀ: rows are lanes (16 a m-tile), columns outputs (8 an n-tile)
    return np.stack(np.broadcast_arrays(col, row), -1)


def holder(spec: Kernel, o, lane_of_pass) -> Tuple:
    """(lane, m-tile, n-tile, c) of the accumulator that holds output ``o``
    (of the warp's 64) at lane ``lane_of_pass`` (< 64) of a pass: the
    epilogue's selection and shuffle sources."""
    o, l = np.asarray(o), np.asarray(lane_of_pass)
    if spec.orient == HL:
        return (4 * (o & 7) + ((l >> 1) & 3), o >> 4, l >> 3,
                2 * ((o >> 3) & 1) + (l & 1))
    return (4 * (l & 7) + ((o >> 1) & 3), l >> 4, o >> 3,
            2 * ((l >> 3) & 1) + (o & 1))


def _pick8(v: np.ndarray, i: np.ndarray) -> np.ndarray:
    """``pick8``: v[..., i] by the select tree."""
    a = np.where((i & 1)[..., None] == 1, v[..., 1::2], v[..., 0::2])
    b = np.where((i & 2)[..., None] == 2, a[..., 1::2], a[..., 0::2])
    return np.where((i & 4) == 4, b[..., 1], b[..., 0])


def _shfl(v: np.ndarray, src: np.ndarray) -> np.ndarray:
    """__shfl_sync over the lane axis 1 of ``v`` (N, 32)."""
    return np.take_along_axis(v, np.broadcast_to(src, v.shape), 1)


def emulate_group(spec: Kernel, roots: np.ndarray, slab: np.ndarray,
                  slices: int) -> np.ndarray:
    """``gather_group`` for warp groups: roots (N, 64) int32 and each
    group's slab (N, bytes) → the (N, 64) int64 outputs, composed from the
    emulated fragments through the PTX layouts."""
    n = roots.shape[0]
    r = roots.astype(np.int64)
    lo_out = np.stack([r[:, 32 * u + _LANE] & 127 for u in range(2)], -1)
    res = np.zeros((n, 32, 2), np.int64)
    bias = spec.bias
    if spec.cut == HBUILD:
        count = np.zeros((n, 32, 8), np.int64)
        for s in range(slices):
            a = hot_registers(spec, roots, s)  # (N, 32, 4, 4)
            e = _elements(spec, a).sum(-1)  # (N, 32, 4 mt, 4 regs)
            # row 8j + g, j = 2 mt + (reg & 1): registers r and r + 2
            count += np.stack([e[..., 0] + e[..., 2], e[..., 1] + e[..., 3]],
                              -1).reshape(n, 32, 8)
        count += np.take(count, _LANE ^ 1, axis=1)
        count += np.take(count, _LANE ^ 2, axis=1)
        for j in range(8):
            v = _shfl(count[:, :, j], 4 * (_LANE & 7))
            mine = (j & 3) == (_LANE >> 3)
            res[:, :, j >> 2] = np.where(mine, v, res[:, :, j >> 2])
        vals = res + lo_out
        return np.concatenate([vals[:, :, 0], vals[:, :, 1]], 1)
    rowsum = np.zeros((n, 32, 8), np.int64)
    cm = fragment_map("c", spec)[:, :, 0]  # (32, 4, 2)
    for h in range(2):
        d = np.zeros((n, 4, 8, 16, 8), np.int64)  # the pass's mma tiles
        for s in range(slices):
            hot = hot_registers(spec, roots, s)
            lit = literal_registers(spec, slab, h, s)
            if spec.orient == HL:
                a, b = _tiles(spec, hot, "a"), _tiles(spec, lit, "b")
            else:
                a, b = _tiles(spec, lit, "a"), _tiles(spec, hot, "b")
            d += np.einsum("nmrk,nbkc->nmbrc", a, b)
        acc = d[:, :, :, cm[..., 0], cm[..., 1]]  # (N, 4, 8, 32, 4)
        acc = acc.transpose(0, 3, 1, 2, 4)  # (N, 32, 4 mt, 8 nt, 4 c)
        if spec.cut == NOMASK:
            for j in range(8):
                rowsum[:, :, j] += acc[:, :, j >> 1, :, 2 * (j & 1)].sum(-1) \
                    + acc[:, :, j >> 1, :, 2 * (j & 1) + 1].sum(-1)
            continue
        if spec.orient == HL:
            for j in range(8):
                ll = _shfl(lo_out[:, :, j >> 2], 8 * (j & 3) + _G) & 63
                v = np.where((ll & 1)[..., None] == 1,
                             acc[:, :, j >> 1, :, 2 * (j & 1) + 1],
                             acc[:, :, j >> 1, :, 2 * (j & 1)])
                cand = _pick8(v, ll >> 3)
                u = j >> 2
                src = 4 * (_LANE & 7) + ((lo_out[:, :, u] >> 1) & 3)
                got = _shfl(cand, src)
                take = ((j & 3) == (_LANE >> 3)) & ((lo_out[:, :, u] >> 6) == h)
                res[:, :, u] = np.where(take, got, res[:, :, u])
        else:
            for nt in range(8):
                for p in range(2):
                    ll = _shfl(lo_out[:, :, nt >> 2],
                               8 * (nt & 3) + 2 * _T + p) & 63
                    v = acc[:, :, np.arange(8) >> 1, nt, 2 * (np.arange(8) & 1) + p]
                    cand = _pick8(v, ll >> 3)
                    u = nt >> 2
                    src = 4 * (lo_out[:, :, u] & 7) + ((_LANE >> 1) & 3)
                    got = _shfl(cand, src)
                    take = (((nt & 3) == (_LANE >> 3)) & (p == (_LANE & 1))
                            & ((lo_out[:, :, u] >> 6) == h))
                    res[:, :, u] = np.where(take, got, res[:, :, u])
    if spec.cut == NOMASK:
        rowsum += np.take(rowsum, _LANE ^ 1, axis=1)
        rowsum += np.take(rowsum, _LANE ^ 2, axis=1)
        for j in range(8):
            v = _shfl(rowsum[:, :, j], 4 * (_LANE & 7))
            mine = (j & 3) == (_LANE >> 3)
            res[:, :, j >> 2] = np.where(mine, v, res[:, :, j >> 2])
        bias *= LANES
    vals = res + bias
    return np.concatenate([vals[:, :, 0], vals[:, :, 1]], 1)


def cta_runs(steps: int, grid: int) -> List[Tuple[int, int]]:
    """The contiguous run [begin, end) of steps each of ``grid`` persistent
    CTAs takes (``onehot_gather_kernel``)."""
    return [(steps * c // grid, steps * (c + 1) // grid) for c in range(grid)]


def emulate(root: torch.Tensor, lit: torch.Tensor, kernel: str,
            grid: int = 3) -> torch.Tensor:
    """The kernel's output composed from the emulated fragments: the CPU
    mirror of ``onehot_gather`` on a card, as ``grid`` persistent CTAs that
    stage a block's slab when their run of steps enters it."""
    spec = _operands(root, lit, kernel)
    b, p = root.shape
    chunks = p // LANES
    roots = root.contiguous().numpy()
    out = np.full((b, p), -1, np.int64)
    slabs = (stage_slab(spec, operand_bytes(literal_operand(lit.contiguous(),
                                                              spec)))
             if spec.cut != HBUILD else np.zeros((b, 0), np.uint8))
    per_block = p // spec.step
    for begin, end in cta_runs(b * per_block, grid):
        for st in range(begin, end):
            blk = st // per_block
            first = (st % per_block) * spec.step
            grp = roots[blk, first:first + spec.step].reshape(-1, GROUP)
            slab = np.broadcast_to(slabs[blk], (grp.shape[0], slabs.shape[1]))
            out[blk, first:first + spec.step] = emulate_group(
                spec, grp, slab, slices_of(spec, chunks)).reshape(-1)
    return torch.from_numpy(out).to(spec.out)
