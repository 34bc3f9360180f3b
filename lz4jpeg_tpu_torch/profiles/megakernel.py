"""The forward megakernel's attribution variants as hand-written kernels.

Port of the Pallas kernels of two TPU probes that took the TPU's K1 apart:
``profiles/probe_megakernel_ablate.py:77`` (``pallas_call`` :139), the
megakernel with one part switched off at a time, and
``profiles/probe_megakernel_dma.py:78`` (:154), the ladder of bare costs
from a u8 copy up to the basis dots.  Their question is asked of the port's
own K1: each row here is a compile-time variant of K1's template
(``csrc/fwd_megakernel.cuh``), instantiated in ``csrc/fwd_probe_kernel.cu``,
so two rows differ by exactly one part of K1.  The input is K1's, a (B, H,
W, 3) uint8 batch (the probes fed their kernels ``rgb_to_kt``'s (3, 64, N)
layout), with H % 8 == 0 and W·3 % 16 == 0, contiguous and, on a card,
16-byte aligned: the staged ``cp.async`` route, the only one the probes
run.  Anything else raises.

``VARIANTS`` holds each variant's switches:

* ``tiles``: T, the band in tiles.  T = 64 is K1's band and plays the
  probes' chunk of C = 2048 blocks; the ablation's chunk sweep C = 4096,
  8192, 1024 runs at T = 128, 16, 32.  T = 256 (C = 8192) would need
  294,912 B of shared memory in three stages against the SM's 232,448, so
  the sweep extends downward instead;
* ``parts``: 3 bf16 basis parts (K1's exact split, the TPU's HIGHEST) or 1,
  the hi part (``ops/fwd_megakernel.py::split_basis``): the TPU's DEFAULT
  precision and its "bf16 one-pass" dots, one instantiation here;
* ``colour``: "ycbcr" (K1), "r" (the ablation's y = cr = cb = R, chroma
  from R's odd columns) or "rgb" (the ladder's dots: R feeds the luma
  product, G and B the chroma products, through their odd columns);
* ``channels``: 3, or 1 (luma only, 64 lanes);
* ``stage``: "sparse" (K1's sparse-delta epilogue), "trunc" (the
  coefficients themselves), or the ladder's bare rungs with no product,
  R[0:64], G[0:32] and B[0:32] of each tile as "copy_u8", "cast_i16" or
  "sum_f32" (through float32, lanes 64-95 holding G + B, as the probe's
  ``o2``);
* ``centred``: samples v - 128 with the offsets folded in and snap-trunc
  (eps 1e-5), as K1; or raw v with no offset, truncated toward zero (the
  ladder's uncentred dots);
* ``block_major``: (N, lanes) output (K1, the TPU's "transposed" output)
  or coefficient-major (lanes, N), the TPU's KT layout out.

Lanes are 64 luma then 32 Cr and 32 Cb coefficients (K1's combined
layout), or the copy rungs' R, G, B selection.  A one-part centred variant
computes ``Σ (v-128)·hi``, the centred product of its own basis, whose
offset is 128·Σ hi; the TPU subtracted the float32 offsets from its bf16
product instead.

``megakernel_variant`` is the wrapper (a CPU tensor runs
``megakernel_variant_ref``, the plain torch version built on
``forward_combined_ref``'s chain, ``split_basis`` and ``ops/color.py``; a
CUDA tensor launches the variant or raises), with a ``launches`` count.
``variant_flips`` holds two results of a variant to one another: identical
but for one-step truncation flips admitted by
``utils/parity.py::transform_flips`` against the variant's own basis and
offset.  ``run_variants`` is the runner of ``profiles/megakernel_ablate.py``
and ``profiles/megakernel_dma.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.bench.roofline import (
    HBM_PEAK_GBS,
    TENSOR_PEAK_TFLOPS,
    _chain_bench,
)
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.color import (
    _snap_trunc,
    chroma_subsample_422,
    rgb_to_ycbcr,
    split_mcus,
)
from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, fused_forward
from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
    _device_bases,
    forward_combined,
    split_basis,
)
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16, rle_encode_sparse16
from lz4jpeg_tpu_torch.profiles.candidates_ab import _body
from lz4jpeg_tpu_torch.utils.parity import transform_flips

BARE_STAGES = ("copy_u8", "cast_i16", "sum_f32")
# The share of a variant's outputs that may flip one step at a tie.  Raw
# samples are truncated with no snap, and where a basis row is rational
# (the luma rows (0,4), (4,0), (4,4), zigzag lanes 10, 14 and 39, are
# ±1/(8q)), Σ ±v/(8q) is an exact integer for about one tile in 8q: two
# float32 sums of the float32 basis then land on either side of it.  Two
# summation orders on 200,000 random tiles part on 2.0e-4 of the luma
# outputs, nearly all in those lanes; centred samples snap such values.
MAX_FLIP_SHARE = 1e-5
RAW_FLIP_SHARE = 1e-3
GATE_SHAPE = (2, 64, 128)  # (frames, H, W) of the runs' gates


@dataclasses.dataclass(frozen=True)
class Variant:
    name: str
    tiles: int
    parts: int
    colour: str
    channels: int
    stage: str
    centred: bool
    block_major: bool
    rows: Tuple[str, ...]  # the probe rows it stands for

    @property
    def lanes(self) -> int:
        return 128 if self.channels == 3 else 64

    @property
    def dtype(self) -> torch.dtype:
        return torch.uint8 if self.stage == "copy_u8" else torch.int16

    @property
    def product(self) -> bool:
        return self.stage not in BARE_STAGES

    def shape(self, n_blocks: int) -> Tuple[int, int]:
        return (n_blocks, self.lanes) if self.block_major else (self.lanes, n_blocks)


_A = "profiles/probe_megakernel_ablate.py"
_D = "profiles/probe_megakernel_dma.py"
# In the id order of csrc/fwd_probe_kernel.cu (checked when it loads).
VARIANTS = (
    Variant("full", 64, 3, "ycbcr", 3, "sparse", True, True, (f"{_A}:148",)),
    Variant("one_part", 64, 1, "ycbcr", 3, "sparse", True, True, (f"{_A}:150",)),
    Variant("coefficient_major", 64, 3, "ycbcr", 3, "sparse", True, False,
            (f"{_A}:152",)),
    Variant("no_sparse", 64, 3, "ycbcr", 3, "trunc", True, True, (f"{_A}:154",)),
    Variant("no_colour", 64, 3, "r", 3, "sparse", True, True, (f"{_A}:156",)),
    Variant("luma_only", 64, 3, "ycbcr", 1, "sparse", True, True, (f"{_A}:158",)),
    Variant("band_128", 128, 3, "ycbcr", 3, "sparse", True, True, (f"{_A}:160",)),
    Variant("band_16", 16, 3, "ycbcr", 3, "sparse", True, True, (f"{_A}:162",)),
    Variant("band_32", 32, 3, "ycbcr", 3, "sparse", True, True, (f"{_A}:164",)),
    Variant("bare", 64, 1, "r", 3, "trunc", True, False, (f"{_A}:166",)),
    Variant("copy_u8", 64, 1, "rgb", 3, "copy_u8", False, False, (f"{_D}:167",)),
    Variant("cast_i16", 64, 1, "rgb", 3, "cast_i16", False, False, (f"{_D}:168",)),
    Variant("sum_f32", 64, 1, "rgb", 3, "sum_f32", False, False, (f"{_D}:169",)),
    Variant("dots_one_part", 64, 1, "rgb", 3, "trunc", False, False,
            (f"{_D}:170", f"{_D}:172")),
    Variant("dots_three_parts", 64, 3, "rgb", 3, "trunc", False, False,
            (f"{_D}:171",)),
    Variant("dots_three_parts_block", 64, 3, "rgb", 3, "trunc", False, True,
            (f"{_D}:173",)),
    Variant("dots_one_part_block", 64, 1, "rgb", 3, "trunc", False, True,
            (f"{_D}:174",)),
)
BY_NAME = {v.name: v for v in VARIANTS}
# The variants whose arithmetic per tile is K1's: identical to
# ``forward_combined``'s output.
SAME_AS_K1 = ("full", "band_128", "band_16", "band_32")


def _variant(name: str) -> Variant:
    if name not in BY_NAME:
        raise ValueError(f"unknown variant {name!r}; one of {sorted(BY_NAME)}")
    return BY_NAME[name]


def _batch(rgb: torch.Tensor) -> Tuple[int, int, int, int]:
    """Validate the probes' input; return (B, H, W, N)."""
    if rgb.dtype != torch.uint8:
        raise TypeError(f"expected uint8 RGB, got {rgb.dtype}")
    if rgb.dim() != 4 or rgb.shape[-1] != 3:
        raise ValueError(f"expected a (B, H, W, 3) batch, got {tuple(rgb.shape)}")
    if not rgb.is_contiguous():
        raise ValueError("RGB batch must be contiguous")
    b, h, w, _ = rgb.shape
    if h % 8 or (w * 3) % 16:
        raise ValueError(f"the probes take H % 8 == 0 and W·3 % 16 == 0, "
                         f"got {h}x{w}")
    _check_device(rgb)
    return b, h, w, b * (h // 8) * (w // 8)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _block_tiles(plane: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (N, 64): each 8x8 block's samples, row-major, blocks in
    ``split_mcus``' order (the positions of ``rgb_to_kt``'s KT layout)."""
    b, h, w = plane.shape
    return (plane.reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3)
            .reshape(-1, 64))


def _channel_tiles(rgb: torch.Tensor, v: Variant):
    """The (N, 8, 8) and two (N, 8, 4) uint8 operand tiles of the variant's
    luma, Cr and Cb products."""
    if v.colour == "ycbcr":
        y, cr, cb = rgb_to_ycbcr(rgb)
    elif v.colour == "r":
        y = cr = cb = rgb[..., 0]
    else:
        y, cr, cb = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return split_mcus(y, chroma_subsample_422(cr), chroma_subsample_422(cb))


def _rule_basis(v: Variant, width: int, table: np.ndarray):
    """(basis, offset) of the variant's product for ``transform_flips``:
    None for K1's (the exact basis and its offsets), else the float64 hi
    part with its centring offset 128·Σ hi, or the raw product's basis with
    no offset."""
    if v.centred and v.parts == 3:
        return None, None
    m, _ = forward_basis(width, 8, _table_key(table))
    basis = split_basis(m)[0].astype(np.float64) if v.parts == 1 else m
    offset = 128.0 * basis.sum(axis=1) if v.centred else np.zeros(len(basis))
    return basis, offset


def megakernel_variant_ref(rgb: torch.Tensor, name: str,
                           lum_table: np.ndarray,
                           chr_table: np.ndarray) -> torch.Tensor:
    """Plain torch version of variant ``name``: K1's chain (colour → 4:2:2
    → ``split_mcus`` → basis product → ``rle_encode_sparse16``, as
    ``forward_combined_ref``) with the variant's switches, or the ladder's
    copy of R[0:64], G[0:32] and B[0:32] per tile."""
    v = _variant(name)
    _batch(rgb)
    if not v.product:
        r, g, b = (_block_tiles(rgb[..., i]) for i in range(3))
        g, b = g[:, :32], b[:, :32]
        if v.stage == "sum_f32":
            f = [t.to(torch.float32) for t in (r, g, b)]
            out = torch.cat([f[0], f[1] + f[2], f[2]], dim=1).to(torch.int16)
        else:
            out = torch.cat([r, g, b], dim=1).to(v.dtype)
    else:
        lanes = []
        for tiles, table, width in zip(_channel_tiles(rgb, v)[: v.channels],
                                       (lum_table, chr_table, chr_table),
                                       (8, 4, 4)):
            if v.centred and v.parts == 3:
                zz = fused_forward(tiles, table, width, 8)
            else:
                basis, _ = _rule_basis(v, width, table)
                bt = torch.from_numpy(basis.T.astype(np.float32)).to(tiles.device)
                x = tiles.reshape(tiles.shape[0], -1).to(torch.float32)
                if v.centred:
                    zz = _snap_trunc((x - 128.0) @ bt, 1e-5)
                else:
                    zz = torch.trunc(x @ bt)
            zz = zz.to(torch.int16)
            lanes.append(rle_encode_sparse16(zz)[0] if v.stage == "sparse" else zz)
        out = torch.cat(lanes, dim=1)
    return out if v.block_major else out.T.contiguous()


def variant_flips(rgb: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
                  name: str, lum_table: np.ndarray,
                  chr_table: np.ndarray) -> int:
    """Count the one-step truncation flips between two results of variant
    ``name`` on ``rgb``; raise AssertionError on any other difference.  The
    bare rungs must be identical; a product variant's coefficients (decoded
    from the sparse deltas where it has them) may differ by 1 where the
    float64 value of its own product lies at a truncation tie
    (``transform_flips`` with ``_rule_basis``)."""
    v = _variant(name)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = (got, want) if v.block_major else (got.T, want.T)
    if torch.equal(g, w):
        return 0
    if not v.product:
        raise AssertionError(f"{name}: the bare rung differs")
    flips = 0
    offsets = (0, 64, 96)
    for i, (tiles, table, width) in enumerate(zip(
            _channel_tiles(rgb, v)[: v.channels],
            (lum_table, chr_table, chr_table), (8, 4, 4))):
        sl = slice(offsets[i], offsets[i] + 8 * width)
        a, b = g[:, sl], w[:, sl]
        if v.stage == "sparse":
            a, b = rle_decode_sparse16(a), rle_decode_sparse16(b)
        basis, offset = _rule_basis(v, width, table)
        flips += transform_flips(
            "forward", tiles, a, b, table, width, 8,
            name=f"{name} {('luma', 'Cr', 'Cb')[i]}", basis=basis,
            offset=offset)
    return flips


def flip_limit(name: str) -> float:
    """The share of variant ``name``'s outputs that may differ from another
    evaluation by one-step flips: ``RAW_FLIP_SHARE`` for raw samples,
    ``MAX_FLIP_SHARE`` otherwise."""
    return MAX_FLIP_SHARE if _variant(name).centred else RAW_FLIP_SHARE


def variant_bound(name: str, n_blocks: int) -> Tuple[float, str]:
    """(bound_ms, bound_by) of variant ``name`` on ``n_blocks`` tiles: the
    larger of its bytes (the 192 input bytes of each tile read once, its
    lanes written once) over 3.35 TB/s and its bf16 tensor work (``parts``
    passes of the 64-deep luma and two 32-deep chroma products) over 989
    TFLOP/s, as ``chip_smoke.py::bound``."""
    v = _variant(name)
    itemsize = 1 if v.dtype == torch.uint8 else 2
    n_bytes = n_blocks * (192 + v.lanes * itemsize)
    flops = 0.0
    if v.product:
        depth = 64 * 64 + (2 * 32 * 32 if v.channels == 3 else 0)
        flops = float(n_blocks) * v.parts * 2 * depth
    by_bytes = n_bytes / (HBM_PEAK_GBS * 1e9) * 1e3
    by_ops = flops / (TENSOR_PEAK_TFLOPS * 1e12) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/fwd_probe_kernel.cu`` at first use, bind it, and check
    that its variant ids name ``VARIANTS`` in order."""
    lib = load_cuda_library("fwd_probe_kernel")
    lib.fwd_probe_launch.restype = ctypes.c_int
    lib.fwd_probe_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.fwd_probe_attributes.restype = ctypes.c_int
    lib.fwd_probe_attributes.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.fwd_probe_variant_count.restype = ctypes.c_int
    lib.fwd_probe_variant_name.restype = ctypes.c_char_p
    lib.fwd_probe_variant_name.argtypes = [ctypes.c_int]
    lib.fwd_probe_error_string.restype = ctypes.c_char_p
    lib.fwd_probe_error_string.argtypes = [ctypes.c_int]
    names = tuple(lib.fwd_probe_variant_name(i).decode()
                  for i in range(lib.fwd_probe_variant_count()))
    if names != tuple(v.name for v in VARIANTS):
        raise RuntimeError(f"fwd_probe_kernel's variants {names} are not "
                           "VARIANTS")
    return lib


def megakernel_variant(rgb: torch.Tensor, name: str, lum_table: np.ndarray,
                       chr_table: np.ndarray) -> torch.Tensor:
    """(B, H, W, 3) uint8 → variant ``name``'s (N, lanes) or (lanes, N)
    output (int16, or uint8 for "copy_u8").

    A CPU tensor runs ``megakernel_variant_ref``.  A CUDA tensor launches
    the variant on the current stream and adds one to
    ``megakernel_variant.launches``; a refused launch raises."""
    v = _variant(name)
    b, h, w, n = _batch(rgb)
    if rgb.device.type == "cpu":
        return megakernel_variant_ref(rgb, name, lum_table, chr_table)
    if rgb.data_ptr() % 16:
        raise ValueError("the probes' staged route needs a 16-byte aligned batch")
    out = torch.empty(v.shape(n), dtype=v.dtype, device=rgb.device)
    if n == 0:
        return out
    parts = _device_bases(_table_key(lum_table), _table_key(chr_table),
                          rgb.device)
    _launch(load_kernel(), "fwd_probe_launch", "fwd_probe_error_string",
            rgb.device, VARIANTS.index(v), rgb.data_ptr(), out.data_ptr(),
            parts.data_ptr(), b, h, w)
    megakernel_variant.launches += 1
    return out


megakernel_variant.launches = 0


def variant_attributes(name: str, device="cuda") -> Dict[str, int]:
    """Variant ``name``'s registers per thread, shared memory per CTA and
    resident CTAs per SM on ``device`` (``cudaFuncGetAttributes`` and the
    occupancy query)."""
    v = _variant(name)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"attributes need a CUDA device, not {dev}")
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = load_kernel()
    with torch.cuda.device(dev):
        rc = lib.fwd_probe_attributes(VARIANTS.index(v), ctypes.byref(regs),
                                      ctypes.byref(smem), ctypes.byref(ctas))
    if rc != 0:
        msg = lib.fwd_probe_error_string(rc).decode()
        raise RuntimeError(f"fwd_probe_attributes failed: {msg} ({rc})")
    return {"registers": regs.value, "shared_bytes": smem.value,
            "ctas_per_sm": ctas.value}


# ---------------------------------------------------------------------------
# The runner of the two probes
# ---------------------------------------------------------------------------


def noise_batch(frames: int, h: int, w: int, seed: int) -> torch.Tensor:
    """(frames, h, w, 3) uniform uint8 noise from numpy's generator."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, size=(frames, h, w, 3), dtype=np.uint8))


def _event_ms(fn, x, reps: int, runs: int, kernel=None) -> float:
    """Best of ``runs`` CUDA-event times of ``reps`` calls of ``fn(x)`` in a
    row, per call, after two warm calls.  ``kernel``, a wrapper with a
    ``launches`` count, guards the timing: each run must launch it ``reps``
    times."""
    fn(x)
    fn(x)
    best = float("inf")
    for _ in range(runs):
        before = kernel.launches if kernel is not None else 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(x)
        end.record()
        end.synchronize()
        del out
        if kernel is not None and kernel.launches - before != reps:
            raise RuntimeError(f"launch guard: {kernel.__name__} launched "
                               f"{kernel.launches - before} times in {reps} "
                               "timed calls")
        best = min(best, start.elapsed_time(end) / reps)
    return best


def run_variants(title: str, rows: Sequence[Tuple[str, str]], device="cuda",
                 frames: int = 32, side: int = 2048, runs: int = 4,
                 chain: int = 8, output: Optional[str] = None,
                 seed: int = 0) -> Dict:
    """Gate, then time the variants of ``rows`` ((probe label, variant
    name), the first the baseline) on ``frames`` noise frames of side²
    (seed ``seed``); returns the result and writes it to ``output`` if
    given.

    Gates, on the device, at ``GATE_SHAPE``: each variant against its plain
    version by ``variant_flips`` (every difference a one-step flip at a
    truncation tie), and the variants of ``SAME_AS_K1`` identical to
    ``forward_combined``.  Times, per variant: on CUDA the best of ``runs``
    CUDA-event times of ``chain`` launches (``ms``), and on any device the
    best of ``runs`` fenced chains of ``chain`` steps (``chain_ms``,
    ``bench/roofline.py::_chain_bench``: each step perturbs the input by
    the carry, runs the variant and checksums its whole output with
    ``utils/profiling.py::device_checksum``; on CUDA each chain must launch
    the variant ``chain`` times).  A CPU run's times are host times of the
    plain versions, no device metric."""
    dev = bench_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 is IEEE fp32
    cuda = dev.type == "cuda"
    if side % 16:
        raise ValueError(f"side {side} is not a multiple of 16")
    names = list(dict.fromkeys(name for _, name in rows))

    # -- gates: a faster but wrong variant must not be timed ---------------
    small = noise_batch(*GATE_SHAPE, seed=seed + 1).to(dev)
    k1 = forward_combined(small, LUM, CHR)
    gates = {}
    for name in names:
        got = megakernel_variant(small, name, LUM, CHR)
        gates[name] = variant_flips(small, got,
                                    megakernel_variant_ref(small, name, LUM, CHR),
                                    name, LUM, CHR)
        if name in SAME_AS_K1 and not torch.equal(got, k1):
            raise AssertionError(f"{name} differs from forward_combined")
    same = [n for n in names if n in SAME_AS_K1]
    print(f"{title}: gates at {GATE_SHAPE}: every variant held to its plain "
          f"version (flips {gates})"
          + (f"; {', '.join(same)} identical to forward_combined" if same
             else ""), flush=True)

    x = noise_batch(frames, side, side, seed).to(dev)
    n_blocks = frames * (side // 8) ** 2
    variants = {}
    for name in names:
        fn = functools.partial(megakernel_variant, name=name, lum_table=LUM,
                               chr_table=CHR)
        rec = {"ms": _event_ms(fn, x, chain, runs, megakernel_variant)
               if cuda else None,
               "chain_ms": _chain_bench(
                   _body(fn), x, chain, torch.int16, runs=runs,
                   kernel=megakernel_variant if cuda else None) * 1e3}
        rec.update(variant_attributes(name, dev) if cuda else
                   {"registers": None, "shared_bytes": None, "ctas_per_sm": None})
        rec["bound_ms"], rec["bound_by"] = variant_bound(name, n_blocks)
        variants[name] = rec
    base_name = rows[0][1]
    plain = functools.partial(megakernel_variant_ref, name=base_name,
                              lum_table=LUM, chr_table=CHR)
    plain_ms = _event_ms(plain, x, 1, runs) if cuda else None

    key = "ms" if cuda else "chain_ms"
    base = variants[base_name][key]
    table, seen = [], {}
    for label, name in rows:
        rec = variants[name]
        row = {"row": label, "variant": name, **rec,
               "vs_baseline_ms": rec[key] - base,
               "share": rec["bound_ms"] / rec["ms"] if cuda else None,
               "same_as": seen.get(name)}
        seen.setdefault(name, label)
        table.append(row)
        share = f"{row['share']:.1%}" if cuda else "n/a"
        ms = f"{rec['ms']:9.4f}" if cuda else "      n/a"
        print(f"{label[:58]:58s} {ms} ms  chain {rec['chain_ms']:9.4f} ms  "
              f"{row['vs_baseline_ms']:+9.4f}  regs {rec['registers']}  smem "
              f"{rec['shared_bytes']}  ctas/SM {rec['ctas_per_sm']}  bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) {share}"
              + (f"  [same kernel as {row['same_as']!r}]" if row["same_as"]
                 else ""), flush=True)
    result = {
        "title": title,
        "frames": frames,
        "side": side,
        "n_blocks": n_blocks,
        "runs": runs,
        "chain": chain,
        "seed": seed,
        "backend": dev.type,
        **device_record(dev),
        "gates": gates,
        "baseline": rows[0][0],
        "plain_ms": plain_ms,
        "variants": variants,
        "rows": table,
    }
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def main_of(run, prog: str, description: str, argv=None) -> int:
    """The command line of ``profiles/megakernel_ablate.py`` and
    ``profiles/megakernel_dma.py``: ``run(device, frames, side, runs,
    chain, output, seed)``."""
    import argparse

    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--side", type=int, default=2048)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)
    run(args.device, frames=args.frames, side=args.side, runs=args.runs,
        chain=args.chain, output=args.output, seed=args.seed)
    return 0
