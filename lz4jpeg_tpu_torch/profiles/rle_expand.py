"""K7's phase split: three copies of the packed16 stream and the cumulative
phase variants of the plane decode, as hand-written kernels.

Port of ``profiles/profile_rle_expand_rm.py`` and
``profiles/profile_rle_expand_ablate.py``, which asked where the TPU's
plane decode (``ops/pallas_rle.py::_rle_decode_kt_plane_kernel``, K7 in
the port) spent its time.  Four kernels:

* ``copy_rm(p)``: (rows, K) → (rows, K), the identity, row by row (the
  probe's ``copy_rm_kernel``, also on the (rows/2, 128) view of the same
  bytes);
* ``copy_t_contig(p)``: (rows, K) → (K, rows) (``copy_t_contig_kernel``);
* ``copy_t_slab(p, bw)``: (bh·bw, K) → (bh, K, bw), K7's plane layout with
  no decode (``copy_t_slab_kernel``);
* ``expand_plane_phase(packed, lengths, bw, phase)``: K7's own body cut
  after one of its phases (``csrc/expand16_plane.cuh`` states what each
  writes): ``copyT``, ``unpack``, ``matmul``, ``dist``; and ``full``, which
  is K7 itself (``ops/pack16.py::pack16_decode_plane``).

The copies take 2-D int16 with K ≥ 8 and a multiple of 8 (the slab also
``rows % bw == 0``); the phases take packed16 words (int16 holding the
uint16 bits, or uint16) with K 32 or 64, (N,) lengths and ``N % bw == 0``.
Anything else raises ``ValueError`` on both devices.  Each function has a
plain torch version (``*_ref``); a CPU tensor runs it, a CUDA tensor
launches ``csrc/rle_expand_copy_kernel.cu`` or
``csrc/expand16_probe_kernel.cu`` and adds one to the wrapper's
``launches`` (the full phase: K7, counted by ``pack16_decode_plane``), or
raises.  The phases honour ``lengths`` as K7 does; the TPU
probe read word 0 as padding instead, and the two agree on canonical
streams.

``inverse_einsum`` is the probe's other question (its einsum orientation
A/B, no Pallas kernel): the plane inverse as ``torch.einsum`` on the
zigzag operand in KT (``akb``) or row-major (``abk``) orientation.

The runners are ``profiles/rle_expand_rm.py`` and
``profiles/rle_expand_ablate.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.ops.fused import _table_key, inverse_basis
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch, _packed
from lz4jpeg_tpu_torch.oracle.jpeg_oracle import LUMINANCE_QUANTIZATION_TABLE
from lz4jpeg_tpu_torch.profiles import timing

PHASES = ("copyT", "unpack", "matmul", "dist", "full")
ABLATED = PHASES[:-1]  # csrc/expand16_probe_kernel.cu's phase ids, in order
PHASE_SEGMENTS = (32, 64)
COPY_RM, COPY_T = 0, 1  # csrc/rle_expand_copy_kernel.cu's attribute ids
EINSUMS = {"kt": "akb,kuv->aubv", "rm": "abk,kuv->aubv"}


# ---------------------------------------------------------------------------
# Gates and plain versions
# ---------------------------------------------------------------------------


def _stream(p: torch.Tensor) -> torch.Tensor:
    if p.dim() != 2 or p.dtype != torch.int16:
        raise ValueError(f"expected a 2-D int16 stream, got {tuple(p.shape)} "
                         f"{p.dtype}")
    if p.shape[1] < 8 or p.shape[1] % 8:
        raise ValueError(f"K must be a multiple of 8 of at least 8, got "
                         f"{p.shape[1]}")
    return p.contiguous()


def _slab_rows(p: torch.Tensor, bw: int) -> int:
    if bw < 1 or p.shape[0] % bw:
        raise ValueError(f"bad plane shape: rows={p.shape[0]}, bw={bw}")
    return p.shape[0] // bw


def copy_rm_ref(p: torch.Tensor) -> torch.Tensor:
    return _stream(p).clone()


def copy_t_contig_ref(p: torch.Tensor) -> torch.Tensor:
    return _stream(p).t().contiguous()


def copy_t_slab_ref(p: torch.Tensor, bw: int) -> torch.Tensor:
    p = _stream(p)
    bh = _slab_rows(p, bw)
    return p.view(bh, bw, p.shape[1]).transpose(1, 2).contiguous()


def _phase_inputs(packed, lengths, bw: int, phase: str):
    packed, lengths = _packed(packed, lengths)
    n, k = packed.shape
    if k not in PHASE_SEGMENTS:
        raise ValueError(f"phase variants take K in {PHASE_SEGMENTS}, got {k}")
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; phases are {PHASES}")
    if bw < 1 or n % bw:
        raise ValueError(f"bad plane shape: N={n}, bw={bw}")
    return packed, lengths


def _int16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 → int16 keeping the low 16 bits (C's truncating cast)."""
    return (((x & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)


def phase_values(packed: torch.Tensor, lengths: torch.Tensor,
                 phase: str) -> torch.Tensor:
    """(N, K) words + (N,) lengths → (N, K) int16: what ``phase`` writes
    for slot (or position) k of each block, before the plane transpose
    (``csrc/expand16_plane.cuh``'s table)."""
    n, k = packed.shape
    if phase == "copyT":
        return packed.clone()
    if phase == "full":
        return pack16.pack16_decode_ref(packed, lengths, k).to(torch.int16)
    w = packed.to(torch.int32) & 0xFFFF
    n_valid = torch.div(lengths.to(torch.int64), 2,
                        rounding_mode="floor").clamp(min=0)
    valid = torch.arange(k, device=w.device)[None, :] < n_valid[:, None]
    counts = torch.where(valid, (w >> 10) + 1, 0)
    biased = w & 0x3FF  # value + 512
    if phase == "unpack":
        return torch.where(valid, counts + biased - 512, 0).to(torch.int16)
    starts = torch.cumsum(counts, dim=1, dtype=torch.int32) - counts
    if phase == "matmul":
        return _int16_bits(torch.where(valid, (starts << 6) ^ biased, 0))
    # dist: value + 513 at each valid run's start below K (a spare column
    # K takes the rest), 513 at the covered total where a slot is invalid.
    marks = torch.zeros((n, k + 1), dtype=torch.int32, device=w.device)
    at = torch.where(valid & (starts < k), starts, k).to(torch.int64)
    marks.scatter_(1, at, biased + 1)
    total = counts.sum(dim=1)
    ends = torch.nonzero((n_valid < k) & (total < k)).flatten()
    marks[ends, total[ends].to(torch.int64)] = 513
    return marks[:, :k].to(torch.int16)


def expand_plane_phase_ref(packed: torch.Tensor, lengths: torch.Tensor,
                           bw: int, phase: str) -> torch.Tensor:
    """Plain version: ``phase_values`` in the plane layout (bh, K, bw)."""
    packed, lengths = _phase_inputs(packed, lengths, bw, phase)
    n, k = packed.shape
    vals = phase_values(packed, lengths, phase)
    return vals.view(n // bw, bw, k).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_copy_kernels() -> ctypes.CDLL:
    """Build ``csrc/rle_expand_copy_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("rle_expand_copy_kernel")
    for name, extra in (("rle_expand_copy_rm_launch", []),
                        ("rle_expand_copy_t_contig_launch", []),
                        ("rle_expand_copy_t_slab_launch", [ctypes.c_int64])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, *extra, ctypes.c_void_p]
    timing.bind_attributes(lib, "rle_expand_copy_attributes")
    lib.rle_expand_copy_error_string.restype = ctypes.c_char_p
    lib.rle_expand_copy_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.lru_cache(maxsize=None)
def load_phase_kernels() -> ctypes.CDLL:
    """Build ``csrc/expand16_probe_kernel.cu`` (the ablated phases of K7's
    template ``csrc/expand16_plane.cuh``) at first use and bind it."""
    lib = load_cuda_library("expand16_probe_kernel")
    lib.expand16_probe_launch.restype = ctypes.c_int
    lib.expand16_probe_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    timing.bind_attributes(lib, "expand16_probe_attributes", n_args=2)
    lib.expand16_probe_error_string.restype = ctypes.c_char_p
    lib.expand16_probe_error_string.argtypes = [ctypes.c_int]
    return lib


def _copy(fn_name: str, p: torch.Tensor, out: torch.Tensor, *extra) -> None:
    _launch(load_copy_kernels(), fn_name, "rle_expand_copy_error_string",
            p.device, p.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1],
            *extra)


def copy_rm(p: torch.Tensor) -> torch.Tensor:
    """(rows, K) int16 → a copy, row by row.  A CPU tensor runs
    ``copy_rm_ref``; a CUDA tensor launches the row-major copy kernel and
    adds one to ``copy_rm.launches``."""
    p = _stream(p)
    if _check_device(p).type == "cpu":
        return copy_rm_ref(p)
    out = torch.empty_like(p)
    if p.numel():
        _copy("rle_expand_copy_rm_launch", p, out)
        copy_rm.launches += 1
    return out


def copy_t_contig(p: torch.Tensor) -> torch.Tensor:
    """(rows, K) int16 → (K, rows).  A CPU tensor runs
    ``copy_t_contig_ref``; a CUDA tensor launches the transpose kernel and
    adds one to ``copy_t_contig.launches``."""
    p = _stream(p)
    if _check_device(p).type == "cpu":
        return copy_t_contig_ref(p)
    out = torch.empty((p.shape[1], p.shape[0]), dtype=p.dtype, device=p.device)
    if p.numel():
        _copy("rle_expand_copy_t_contig_launch", p, out)
        copy_t_contig.launches += 1
    return out


def copy_t_slab(p: torch.Tensor, bw: int) -> torch.Tensor:
    """(bh·bw, K) int16 → (bh, K, bw).  A CPU tensor runs
    ``copy_t_slab_ref``; a CUDA tensor launches the transpose kernel and
    adds one to ``copy_t_slab.launches``."""
    p = _stream(p)
    bh = _slab_rows(p, bw)
    if _check_device(p).type == "cpu":
        return copy_t_slab_ref(p, bw)
    out = torch.empty((bh, p.shape[1], bw), dtype=p.dtype, device=p.device)
    if p.numel():
        _copy("rle_expand_copy_t_slab_launch", p, out, bw)
        copy_t_slab.launches += 1
    return out


def expand_plane_phase(packed: torch.Tensor, lengths: torch.Tensor, bw: int,
                       phase: str) -> torch.Tensor:
    """(bh·bw, K) packed16 words + (bh·bw,) lengths → (bh, K, bw) int16:
    K7 cut after ``phase``.  A CPU tensor runs ``expand_plane_phase_ref``;
    on a CUDA tensor the full phase is K7 (``pack16_decode_plane``, which
    counts its launch), and an ablated phase launches its instantiation of
    K7's template and adds one to ``expand_plane_phase.launches``."""
    packed, lengths = _phase_inputs(packed, lengths, bw, phase)
    dev = _check_device(packed, lengths)
    if dev.type == "cpu":
        return expand_plane_phase_ref(packed, lengths, bw, phase)
    if phase == "full":
        return pack16.pack16_decode_plane(packed, lengths, bw)
    if packed.data_ptr() % 16:  # K7's loads: 16 bytes a lane
        packed = packed.clone()
    n, k = packed.shape
    out = torch.empty((n // bw, k, bw), dtype=torch.int16, device=dev)
    if n:
        _launch(load_phase_kernels(), "expand16_probe_launch",
                "expand16_probe_error_string", dev, ABLATED.index(phase),
                packed.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                n // bw, bw, k)
        expand_plane_phase.launches += 1
    return out


for _wrapper in (copy_rm, copy_t_contig, copy_t_slab, expand_plane_phase):
    _wrapper.launches = 0


def copy_attributes(kernel: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of ``COPY_RM`` or
    ``COPY_T`` (both transposes)."""
    return timing.attributes(load_copy_kernels, "rle_expand_copy_attributes",
                             "rle_expand_copy_error_string", kernel,
                             torch.device(device))


def phase_attributes(phase: str, seg: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of ``phase`` at K = seg
    (the full phase's are K7's)."""
    if phase == "full":
        return timing.attributes(pack16.load_expand_kernels,
                                 "expand16_plane_attributes",
                                 "expand16_kernel_error_string", seg,
                                 torch.device(device))
    return timing.attributes(load_phase_kernels, "expand16_probe_attributes",
                             "expand16_probe_error_string",
                             (ABLATED.index(phase), seg), torch.device(device))


# ---------------------------------------------------------------------------
# The einsum orientation A/B and the probes' data
# ---------------------------------------------------------------------------


def luma_inverse_basis(device="cpu") -> torch.Tensor:
    """(64, 8, 8) float32: ``inverse_basis`` of the luminance table, zigzag
    index first, as the probe's ``mi``."""
    minv = inverse_basis(8, 8, _table_key(np.asarray(LUMINANCE_QUANTIZATION_TABLE)))
    mi = np.ascontiguousarray(minv.T.reshape(64, 8, 8), dtype=np.float32)
    return torch.from_numpy(mi).to(device)


def inverse_einsum(z: torch.Tensor, mi: torch.Tensor,
                   orientation: str) -> torch.Tensor:
    """Zigzag coefficients (bh, 64, bw) (``"kt"``) or (bh, bw, 64)
    (``"rm"``) float32 → (8·bh, 8·bw) uint8 pixels: the einsum in IEEE
    float32 with TF32 off, + 128, rounded half away from zero, clamped."""
    with timing.no_tf32():
        pix = torch.einsum(EINSUMS[orientation], z, mi) + 128.0
    r = torch.sign(pix) * torch.floor(torch.abs(pix) + 0.5)
    bh, _, bw, _ = pix.shape
    return r.clamp(0, 255).to(torch.uint8).reshape(8 * bh, 8 * bw)


def stream_values(rows: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """The copy probe's stream (``profile_rle_expand_rm.py:44-45``)."""
    return rng.integers(1, 1 << 15, size=(rows, k)).astype(np.int16)


def ablate_symbols(rows: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """The ablation probe's values (``profile_rle_expand_ablate.py:
    122-126``): uniform in [-511, 511], the even rows repeating a value in
    groups of 8."""
    vals = rng.integers(-511, 512, size=(rows, k)).astype(np.int16)
    rep = np.repeat(rng.integers(-511, 512, size=(rows, (k + 7) // 8)), 8,
                    axis=1)[:, :k]
    vals[::2] = rep[::2].astype(np.int16)
    return vals


def stream_bytes(p: torch.Tensor) -> int:
    """A copy's bytes: the stream read once and written once."""
    return 2 * p.numel() * p.element_size()


def phase_bytes(n: int, k: int) -> int:
    """A phase's bytes: words and lengths in, int16 values out."""
    return n * k * 2 + n * 4 + n * k * 2
