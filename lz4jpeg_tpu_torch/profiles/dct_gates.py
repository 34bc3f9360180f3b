"""The fused-DCT gates: an IEEE float32 basis product, a minor-dims
transpose and a lane split, as hand-written kernels, and their run.

Port of ``profiles/profile_fused_dct_gates.py``, whose three kernels
asked whether Mosaic could build a fused plane → packed16 forward:

* ``basis_dot(x, m)``: (N, 64) × (64, 64) float32 → (N, 64), ``x · mᵀ``
  in fp32 FFMA with k in order (``dot_kernel``, ``pallas_call`` :35; the
  probe's basis is the luma ``forward_basis(8, 8, ...)``); plain version
  and library call: ``torch.matmul(x, m.T)`` with TF32 off (cuBLAS);
* ``minor_transpose(x)``: (B, bw, tw) → (B, tw, bw) float32, any bw ≥ 1
  and 1 ≤ tw ≤ 64 (``tr_kernel``, :56); plain version and library call:
  ``x.transpose(1, 2).contiguous()``.  Two routes, chosen by shape and
  alignment alone (``transpose_route``): the barrier-free vector route for
  tw 2, 4 and 8 with bw % 4 == 0 and both bases 16-byte aligned (float4
  loads, lane swaps by shuffle, float4 stores; ``emulate_vector_route``
  mirrors its lanes in numpy), the shared-tile route otherwise;
  ``minor_transpose.routes`` counts the launches of each;
* ``lane_split(x, tw)``: (..., W) → (..., W / tw, tw) float32
  (``split_kernel``, :75).  Row-major, the split moves no byte, so it is a
  copy of the bytes into the split view on P-copy's kernel
  (``ops/stream.py::stream_copy``, ``csrc/stream_copy_kernel.cu``, which
  counts the launch); plain version ``x.reshape(...).clone()``, library
  call ``Tensor.copy_`` into the view.

The first two launch ``csrc/dct_gate_kernel.cu`` on a CUDA tensor and add
one to their wrapper's ``launches``; a CPU tensor runs the plain version.
Shapes outside these raise ``ValueError`` (a dtype other than float32
``TypeError``) on both devices.  ``dot_plan``, ``dot_schedule`` and
``dot_thread_map`` mirror the product's launch, its ring (each CTA's tiles,
their slots and the parities its producer and consumers wait on) and its
thread → (row, output) map in Python for the CPU tests; on the card
``dot_launch_plan`` asks the C code for its plan.  The product is held, on
both devices, to ``64 · 2⁻²⁴ · Σ_k |x_k · m_jk|`` of a float64 product
(``dot_error``);
``ulp_compare`` counts the outputs that differ from cuBLAS's and the
largest difference in units in the last place, as the probe printed the
count against XLA.

The run (``python -m lz4jpeg_tpu_torch.profiles.dct_gates``): each kernel
on the probe's shapes ((512, 64) integer pixels 0-255 and the luma basis;
(8, 256, 8) and (8, 128, 4); (8, 2048) → (8, 256, 8)), then timed beside
its plain version and library call: the product at ``rows`` × 64 (P-mcu-f's
2,097,152 luma tiles), the transposes on ``bands`` rows of (256, 8) (the
8-row luma bands of 16 frames of 2048²) and of the probe's chroma (128, 4),
the split at ``bands`` × 2048.  Times: ``profiles/timing.py`` (best of
``runs`` runs of ``reps`` calls, queued behind a spin on the card; each
kernel run guarded by its launch count).  Bound: bytes (inputs read once,
outputs written once) over 3.35 TB/s, or the product's FFMA work over the
data sheet's 67 TFLOP/s fp32 where that is larger.  Run on the card from
the repository root (on the CPU add ``--device cpu --rows 4096 --bands
64``)::

    python -m lz4jpeg_tpu_torch.profiles.dct_gates --output g.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.ops.quantize import LUMINANCE_QUANTIZATION_TABLE
from lz4jpeg_tpu_torch.ops.stream import stream_copy
from lz4jpeg_tpu_torch.profiles import timing

DEPTH = 64  # the basis product's k and j
MAX_TW = 64
FP32_FLOP_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
DOT, TRANSPOSE, TRANSPOSE_VEC = 0, 1, 2  # csrc/dct_gate_kernel.cu's ids
ROUTES = ("tile", "vector")  # minor_transpose_route's answers 0 and 1
VECTOR_TW = (2, 4, 8)
BANDS = {"lum": (256, 8), "chr": (128, 4)}  # (bw, tw) of the probe's bands
# basis_dot's shape, csrc/dct_gate_kernel.cu's dot:: constants: rows a
# tile, ring slots, CTAs an SM, a thread's rows (× 4 outputs).
DOT_TILE_ROWS = 64
DOT_STAGES = 2
DOT_CTAS_PER_SM = 3
DOT_BLOCK_ROWS = 8


# ---------------------------------------------------------------------------
# Gates and plain versions
# ---------------------------------------------------------------------------


def _float32(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")


def _dot_operands(x: torch.Tensor, m: torch.Tensor):
    _float32(x)
    _float32(m)
    if x.dim() != 2 or x.shape[1] != DEPTH or tuple(m.shape) != (DEPTH, DEPTH):
        raise ValueError(f"the basis product takes (N, {DEPTH}) × ({DEPTH}, "
                         f"{DEPTH}), got {tuple(x.shape)} × {tuple(m.shape)}")
    return x.contiguous(), m.contiguous()


def _bands(x: torch.Tensor) -> torch.Tensor:
    _float32(x)
    if x.dim() != 3 or x.shape[1] < 1 or not 1 <= x.shape[2] <= MAX_TW:
        raise ValueError(f"the transpose takes (B, bw ≥ 1, 1 ≤ tw ≤ {MAX_TW})"
                         f", got {tuple(x.shape)}")
    return x.contiguous()


def _split_shape(x: torch.Tensor, tw: int):
    _float32(x)
    if x.dim() < 1 or tw < 1 or x.shape[-1] % tw:
        raise ValueError(f"cannot split the last axis of {tuple(x.shape)} "
                         f"into rows of {tw}")
    return (*x.shape[:-1], x.shape[-1] // tw, tw)


def basis_dot_ref(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x @ m.T`` in IEEE float32 (TF32 off)."""
    x, m = _dot_operands(x, m)
    with timing.no_tf32():
        return x @ m.t()


def minor_transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``x.transpose(1, 2).contiguous()``."""
    return _bands(x).transpose(1, 2).contiguous()


def lane_split_ref(x: torch.Tensor, tw: int) -> torch.Tensor:
    """Plain version: ``x.reshape(..., W / tw, tw).clone()``."""
    shape = _split_shape(x, tw)
    return x.reshape(shape).clone()


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


class DotPlan(NamedTuple):
    """The product's launch for ``n`` rows: ``tiles`` tiles of
    ``tile_rows`` rows over ``ctas`` persistent CTAs (``resident`` fit on
    the card), each with a ring of ``stages`` slots, ``threads`` threads
    (the last warp the producer) and ``smem`` bytes of dynamic shared
    memory."""

    tiles: int
    resident: int
    ctas: int
    tile_rows: int
    stages: int
    threads: int
    smem: int


def dot_plan(n: int, resident: int, stages: int = DOT_STAGES) -> DotPlan:
    """``csrc/dct_gate_kernel.cu::dot_plan`` and ``dot::`` for ``n`` rows on
    a card where ``resident`` CTAs fit; another ``stages`` models the ring
    at that depth (the kernel's is ``DOT_STAGES``)."""
    groups = DOT_TILE_ROWS // DOT_BLOCK_ROWS
    consumers = groups * (DEPTH // 4)
    tile_bytes = groups * (DOT_BLOCK_ROWS * DEPTH * 4 + 16)
    tiles = -(-n // DOT_TILE_ROWS)
    return DotPlan(tiles, resident, min(tiles, resident), DOT_TILE_ROWS,
                   stages, consumers + 32,
                   DEPTH * DEPTH * 4 + stages * tile_bytes + 16 * stages)


def dot_schedule(plan: DotPlan):
    """Each CTA's walk, as the kernel's loops make it: a list with one
    (T, 4) int64 array a CTA of rows ``(tile, slot, producer parity,
    consumer parity)``: tile b, b + ctas, ... of CTA b, its i-th in slot
    i % stages; the producer waits on the slot's "empty" barrier with
    parity ((i // stages) & 1) ^ 1, the consumers on "full" with
    (i // stages) & 1."""
    out = []
    for b in range(plan.ctas):
        tile = np.arange(b, plan.tiles, plan.ctas, dtype=np.int64)
        i = np.arange(tile.size, dtype=np.int64)
        rnd = i // plan.stages
        out.append(np.stack([tile, i % plan.stages, (rnd & 1) ^ 1, rnd & 1], 1))
    return out


def dot_thread_map():
    """(consumers, rows, outputs) of the consumer threads' register blocks:
    ``rows[t]`` the tile rows of thread t (its row group ``rg``: rows
    ``rg · DOT_BLOCK_ROWS ..``), ``outputs[t]`` its columns 4 cg .. 4 cg +
    3, with cg = lane % 16 and rg = 2 · warp + lane / 16."""
    col_groups = DEPTH // 4
    consumers = DOT_TILE_ROWS // DOT_BLOCK_ROWS * col_groups
    t = np.arange(consumers)
    lane, warp = t % 32, t // 32
    cg = lane % col_groups
    rg = warp * (32 // col_groups) + lane // col_groups
    rows = rg[:, None] * DOT_BLOCK_ROWS + np.arange(DOT_BLOCK_ROWS)
    cols = 4 * cg[:, None] + np.arange(4)
    return consumers, rows, cols


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/dct_gate_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("dct_gate_kernel")
    lib.basis_dot_launch.restype = ctypes.c_int
    lib.basis_dot_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.basis_dot_plan.restype = ctypes.c_int
    lib.basis_dot_plan.argtypes = [ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.minor_transpose_launch.restype = ctypes.c_int
    lib.minor_transpose_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.minor_transpose_route.restype = ctypes.c_int
    lib.minor_transpose_route.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int,
    ]
    timing.bind_attributes(lib, "dct_gate_attributes", n_args=2)
    lib.dct_gate_error_string.restype = ctypes.c_char_p
    lib.dct_gate_error_string.argtypes = [ctypes.c_int]
    return lib


def dot_launch_plan(n: int, device="cuda") -> DotPlan:
    """The plan the C code launches for ``n`` rows on ``device``
    (``csrc/dct_gate_kernel.cu::basis_dot_plan``)."""
    out = (ctypes.c_int64 * 7)()
    lib = load_kernel()
    with torch.cuda.device(torch.device(device)):
        rc = lib.basis_dot_plan(n, out)
    if rc != 0:
        raise RuntimeError(f"basis_dot_plan failed: "
                           f"{lib.dct_gate_error_string(rc).decode()} ({rc})")
    return DotPlan(*out)


def basis_dot(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, 64) float32 · (64, 64)ᵀ → (N, 64) float32.  A CPU tensor runs
    ``basis_dot_ref``; a CUDA tensor launches the FFMA kernel and adds one
    to ``basis_dot.launches``."""
    x, m = _dot_operands(x, m)
    dev = _check_device(x, m)
    if dev.type == "cpu":
        return basis_dot_ref(x, m)
    if x.data_ptr() % 16:  # the kernel loads 16 bytes a lane
        x = x.clone()
    out = torch.empty((x.shape[0], DEPTH), dtype=torch.float32, device=dev)
    if x.shape[0]:
        _launch(load_kernel(), "basis_dot_launch", "dct_gate_error_string",
                dev, x.data_ptr(), m.data_ptr(), out.data_ptr(), x.shape[0],
                DEPTH, DEPTH)
        basis_dot.launches += 1
    return out


def minor_transpose(x: torch.Tensor) -> torch.Tensor:
    """(B, bw, tw) float32 → (B, tw, bw).  A CPU tensor runs
    ``minor_transpose_ref``; a CUDA tensor launches the transpose kernel on
    the route the entry point takes (``minor_transpose_route``), adds one
    to ``minor_transpose.launches`` and to that route's count in
    ``minor_transpose.routes``."""
    x = _bands(x)
    dev = _check_device(x)
    if dev.type == "cpu":
        return minor_transpose_ref(x)
    b, bw, tw = x.shape
    out = torch.empty((b, tw, bw), dtype=torch.float32, device=dev)
    if b:
        lib = load_kernel()
        route = ROUTES[lib.minor_transpose_route(x.data_ptr(), out.data_ptr(),
                                                 b, bw, tw)]
        _launch(lib, "minor_transpose_launch", "dct_gate_error_string", dev,
                x.data_ptr(), out.data_ptr(), b, bw, tw)
        minor_transpose.launches += 1
        minor_transpose.routes[route] += 1
    return out


for _wrapper in (basis_dot, minor_transpose):
    _wrapper.launches = 0
minor_transpose.routes = dict.fromkeys(ROUTES, 0)


def transpose_route(b: int, bw: int, tw: int, in_ptr: int,
                    out_ptr: int) -> str:
    """The route ``csrc/dct_gate_kernel.cu::vector_route`` picks: "vector"
    for tw 2, 4 or 8, bw % 4 == 0, both addresses 16-byte aligned and
    fewer than 2³² four-column groups; "tile" otherwise."""
    vector = (tw in VECTOR_TW and bw % 4 == 0 and in_ptr % 16 == 0
              and out_ptr % 16 == 0 and b * (bw // 4) < 1 << 32)
    return ROUTES[vector]


def emulate_vector_route(x: torch.Tensor) -> torch.Tensor:
    """The vector route's lanes in numpy: each float4 of ``x`` (B, bw, tw)
    in lane f % 32, the bit swaps of ``swap_bits`` as exchanges between
    lanes, each lane's float4 stored at its row and group; returns the
    (B, tw, bw) output."""
    b, bw, tw = _bands(x).shape
    if tw not in VECTOR_TW or bw % 4:
        raise ValueError(f"the vector route takes tw in {VECTOR_TW} and bw % "
                         f"4 == 0, got {tuple(x.shape)}")
    v = x.contiguous().numpy().reshape(-1, 4).copy()  # float4 f, lane f % 32
    lane = np.arange(v.shape[0]) % 32

    def swap(lane_bit, elem_bit):
        mine = ((lane >> lane_bit) & 1).astype(bool)[:, None]
        partner = np.arange(v.shape[0]) ^ (1 << lane_bit)
        for e in range(4):
            if e & (1 << elem_bit):
                continue
            lo, hi = v[:, e].copy(), v[:, e | 1 << elem_bit].copy()
            got = np.where(mine[:, 0], lo, hi)[partner]
            v[:, e] = np.where(mine[:, 0], got, lo)
            v[:, e | 1 << elem_bit] = np.where(mine[:, 0], hi, got)

    swaps = {2: ((0, 0),), 4: ((0, 0), (1, 1)), 8: ((1, 0), (2, 1))}[tw]
    for lane_bit, elem_bit in swaps:
        swap(lane_bit, elem_bit)
    if tw == 2:
        row, v = lane & 1, v[:, [0, 2, 1, 3]]
    elif tw == 4:
        row = lane & 3
    else:
        row = 4 * (lane & 1) + 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1)
    u = np.arange(v.shape[0]) // tw
    batch, group = u // (bw // 4), u % (bw // 4)
    out = np.empty((b, tw, bw), np.float32)
    out[batch[:, None], row[:, None], 4 * group[:, None] + np.arange(4)] = v
    return torch.from_numpy(out)


def lane_split(x: torch.Tensor, tw: int) -> torch.Tensor:
    """(..., W) float32 → (..., W / tw, tw), a new tensor.  A CPU tensor
    runs ``lane_split_ref``; a CUDA tensor is copied by the stream-copy
    kernel (``stream_copy.launches`` counts it) into the split view."""
    shape = _split_shape(x, tw)
    x = x.contiguous()
    if _check_device(x).type == "cpu":
        return lane_split_ref(x, tw)
    return stream_copy(x).view(shape)


def attributes(kernel: int, tw: int = 8, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of ``DOT``, ``TRANSPOSE``
    (the tile route, its shared tile at ``tw``) or ``TRANSPOSE_VEC`` (the
    vector route at ``tw``); None on the CPU."""
    return timing.attributes(load_kernel, "dct_gate_attributes",
                             "dct_gate_error_string", (kernel, tw),
                             torch.device(device))


# ---------------------------------------------------------------------------
# The product's error and the probes' data
# ---------------------------------------------------------------------------


def luma_basis(device="cpu") -> torch.Tensor:
    """(64, 64) float32: ``forward_basis(8, 8, ...)`` of the luminance
    table, as the probe's ``m32``."""
    m, _ = forward_basis(8, 8, _table_key(np.asarray(LUMINANCE_QUANTIZATION_TABLE)))
    return torch.from_numpy(m.astype(np.float32)).to(device)


def dot_error(got: torch.Tensor, x: torch.Tensor, m: torch.Tensor) -> Dict:
    """``got`` against the float64 product of ``x`` and ``m``: the largest
    |error|, the largest error over its bound ``64 · 2⁻²⁴ · Σ_k |x_k ·
    m_jk|`` (0 where the bound is 0 and the error too), and whether every
    output lies within its bound."""
    x64, m64 = x.double(), m.double()
    err = (got.double() - x64 @ m64.t()).abs()
    bound = DEPTH * 2.0 ** -24 * (x64.abs() @ m64.abs().t())
    ratio = torch.where(bound > 0, err / bound.clamp(min=1e-300),
                        torch.where(err > 0, torch.inf, 0.0))
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_err_over_bound": float(ratio.max()) if err.numel() else 0.0,
            "within": bool((err <= bound).all())}


def _ordered(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits → int64 keys in the order of the values (±0 both 0)."""
    b = bits.to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF), b)


def ulp_compare(a: torch.Tensor, b: torch.Tensor) -> Dict:
    """How many float32 outputs of ``a`` and ``b`` differ, and the largest
    difference in units in the last place."""
    d = (_ordered(a.contiguous().view(torch.int32))
         - _ordered(b.contiguous().view(torch.int32))).abs()
    return {"differ": int((d != 0).sum()), "outputs": d.numel(),
            "max_ulp": int(d.max()) if d.numel() else 0}


def probe_pixels(rows: int, rng: np.random.Generator) -> torch.Tensor:
    """The probe's x: (rows, 64) integers in [0, 256) as float32."""
    return torch.from_numpy(rng.integers(0, 256, size=(rows, DEPTH))
                            .astype(np.float32))


def device_pixels(shape, dev: torch.device, seed: int) -> torch.Tensor:
    """Integers in [0, 256) as float32 of ``shape``, made on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, device=dev,
                         generator=gen).to(torch.float32)


def dot_bound_ms(rows: int):
    """(bound_ms, bound_by, bytes_ms, flops_ms) of ``rows`` × 64 × 64."""
    n_bytes = (2 * rows * DEPTH + DEPTH * DEPTH) * 4
    bytes_ms = timing.bytes_bound_ms(n_bytes)
    flops_ms = 2 * rows * DEPTH * DEPTH / FP32_FLOP_PER_S * 1e3
    return (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms
            else "operations", bytes_ms, flops_ms)


def moved_bound_ms(x: torch.Tensor) -> float:
    """A transpose's or a copy's bound: ``x`` read once and written once."""
    return timing.bytes_bound_ms(2 * x.numel() * x.element_size())


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def _row(label, site, fn, counter, plain, library, library_name, x, bound,
         bound_by, attrs, dev, runs, reps) -> Dict:
    """``fn`` (a call adding to ``counter``'s launches), its plain version
    and the library call (None: the plain version is that call) timed on
    ``x``."""
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    before = counter.launches
    ms = timing.time_ms(fn, x, dev, reps=reps, runs=runs,
                        kernel=counter if cuda else None)
    plain_ms = timing.time_ms(plain, x, dev, reps=reps, runs=runs)
    return {"row": label, "site": site, "shape": list(x.shape), key: ms,
            f"plain_{key}": plain_ms, "library": library_name,
            f"library_{key}": plain_ms if library is None else
            timing.time_ms(library, x, dev, reps=reps, runs=runs),
            "launches": counter.launches - before, "bound_ms": bound,
            "bound_by": bound_by, "share": bound / ms if cuda else None,
            **attrs}


def run_dct_gates(device="cuda", rows: int = 2_097_152, bands: int = 32_768,
                  runs: int = 4, reps: int = 8, output: Optional[str] = None,
                  seed: int = 0) -> Dict:
    """The three gates on the probe's shapes, then timed; returns the
    result and writes it to ``output`` if given."""
    dev = bench_device(device)
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    m = luma_basis(dev)

    # -- the probe's shapes -------------------------------------------------
    x = probe_pixels(512, rng).to(dev)
    got = basis_dot(x, m)
    plain = basis_dot_ref(x, m)
    dot = {"shape": [512, DEPTH], **ulp_compare(got, plain),
           "kernel": dot_error(got, x, m), "plain": dot_error(plain, x, m)}
    if not (dot["kernel"]["within"] and dot["plain"]["within"]):
        raise AssertionError(f"basis product outside its error bound: {dot}")
    print(f"basis_dot vs torch.matmul fp32: {dot['differ']}/"
          f"{dot['outputs']} differ (max {dot['max_ulp']} ulp); both within "
          f"64·2^-24·Σ|x·m| of float64 (kernel {dot['kernel']['max_err_over_bound']:.3g}"
          f" of it)", flush=True)
    checks = {"dot": dot}
    for bw, tw in ((256, 8), (128, 4)):
        xs = torch.from_numpy(rng.integers(0, 256, size=(8, bw, tw))
                              .astype(np.float32)).to(dev)
        if not torch.equal(minor_transpose(xs), minor_transpose_ref(xs)):
            raise AssertionError(f"transpose (8, {bw}, {tw}) differs")
        checks[f"transpose_8_{bw}_{tw}"] = "identical"
        print(f"minor-dims transpose (8,{bw},{tw}) correct", flush=True)
    xs = torch.from_numpy(rng.integers(0, 256, size=(8, 2048))
                          .astype(np.float32)).to(dev)
    if not torch.equal(lane_split(xs, 8), lane_split_ref(xs, 8)):
        raise AssertionError("lane split (8, 2048) -> (8, 256, 8) differs")
    checks["split_8_2048"] = "identical"
    print("lane-split (8,2048)->(8,256,8) correct", flush=True)

    # -- times ----------------------------------------------------------------
    timed = []
    x = device_pixels((rows, DEPTH), dev, seed)
    got = basis_dot(x, m)
    big = {**ulp_compare(got, basis_dot_ref(x, m)), **dot_error(got, x, m)}
    if not big["within"]:
        raise AssertionError(f"basis product at {rows} rows outside its "
                             f"error bound: {big}")
    del got
    bound, by, bytes_ms, flops_ms = dot_bound_ms(rows)
    row = _row(f"basis product ({rows}, 64) x (64, 64)",
               "profile_fused_dct_gates.py:35", lambda v: basis_dot(v, m),
               basis_dot, lambda v: basis_dot_ref(v, m), None,
               "torch.matmul(x, m.T), TF32 off", x, bound, by,
               attributes(DOT, device=dev), dev, runs, reps)
    row.update(bytes_bound_ms=bytes_ms, flops_bound_ms=flops_ms, check=big)
    timed.append(row)
    del x
    for tag, (bw, tw) in BANDS.items():
        x = device_pixels((bands, bw, tw), dev, seed + tw)
        got = minor_transpose(x)
        if not torch.equal(got, minor_transpose_ref(x)):
            raise AssertionError(f"transpose {tuple(x.shape)} differs")
        route = (transpose_route(bands, bw, tw, x.data_ptr(), got.data_ptr())
                 if dev.type == "cuda" else None)
        del got
        timed.append(_row(
            f"transpose {tag} ({bands}, {bw}, {tw})",
            "profile_fused_dct_gates.py:56", minor_transpose, minor_transpose,
            minor_transpose_ref, None, "x.transpose(1, 2).contiguous()", x,
            moved_bound_ms(x), "bytes",
            attributes(TRANSPOSE_VEC if route == "vector" else TRANSPOSE, tw,
                       dev), dev, runs, reps))
        timed[-1]["route"] = route
        del x
    x = device_pixels((bands, 2048), dev, seed + 1)
    if not torch.equal(lane_split(x, 8), lane_split_ref(x, 8)):
        raise AssertionError(f"lane split {tuple(x.shape)} differs")
    sink = torch.empty((bands, 256, 8), dtype=torch.float32, device=dev)
    timed.append(_row(
        f"lane split ({bands}, 2048) -> ({bands}, 256, 8)",
        "profile_fused_dct_gates.py:75", lambda v: lane_split(v, 8),
        stream_copy, lambda v: lane_split_ref(v, 8),
        lambda v: sink.copy_(v.view(sink.shape)), "Tensor.copy_", x,
        moved_bound_ms(x), "bytes", {}, dev, runs, reps))
    del x, sink

    where = device_record(dev)
    t = [r[key] for r in timed]
    verdict = (f"on {where.get('card', dev)}: the fp32 FFMA product differs "
               f"from cuBLAS in {dot['differ']}/{dot['outputs']} probe "
               f"outputs (max {dot['max_ulp']} ulp), all within the bound; "
               f"at scale it takes {t[0] / timed[0][f'plain_{key}']:.2f}x "
               f"cuBLAS; the transposes {t[1] / timed[1][f'plain_{key}']:.2f}x"
               f" and {t[2] / timed[2][f'plain_{key}']:.2f}x their torch "
               f"call; the split {t[3] / timed[3][f'library_{key}']:.2f}x "
               "Tensor.copy_")
    for r in timed:
        print(f"{r['row']:52s} {r[key]:9.4f} ms  plain {r[f'plain_{key}']:9.4f}"
              f"  library {r[f'library_{key}']:9.4f}"
              + ("" if r["share"] is None else
                 f"  {r['share']:.1%} of {r['bound_ms']:.4f} ({r['bound_by']})"
                 f"  regs {r.get('registers')}  smem {r.get('shared_bytes')}"
                 f"  ctas/SM {r.get('ctas_per_sm')}"), flush=True)
    print(f"verdict: {verdict}")
    result = {"rows": rows, "bands": bands, "runs": runs, "reps": reps,
              "seed": seed, "backend": dev.type,
              "timer": "cuda events" if dev.type == "cuda" else "host clock",
              **where, "checks": checks, "timed": timed, "verdict": verdict}
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.dct_gates",
        description="The fused-DCT gates: the fp32 basis product, the "
                    "minor-dims transpose and the lane split.")
    ap.add_argument("--rows", type=int, default=2_097_152)
    ap.add_argument("--bands", type=int, default=32_768)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_dct_gates(args.device, args.rows, args.bands, args.runs, args.reps,
                  args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
