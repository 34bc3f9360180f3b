"""The forward megakernel's probe variants as hand-written kernels.

Port of the Pallas kernels of five TPU probes that took the TPU's K1 apart:
``profiles/probe_megakernel_ablate.py:77`` (``pallas_call`` :139), the
megakernel with one part switched off at a time;
``profiles/probe_megakernel_dma.py:78`` (:154), the ladder of bare costs
from a u8 copy up to the basis dots; and the three layout probes,
``profiles/probe_megakernel.py:108`` (:174), ``probe_megakernel_t.py:50``
(:89) and ``probe_megakernel_v2.py:85`` (:126), which fed the kernel the
(3, 64, N) KT block layout of ``rgb_to_kt``.  Their question is asked of the
port's own K1: each row here is a compile-time variant of K1's template
(``csrc/fwd_megakernel.cuh``), instantiated in ``csrc/fwd_probe_kernel.cu``,
so two rows differ by exactly one part of K1.  An "rgb" variant reads K1's
(B, H, W, 3) uint8 batch, with H % 8 == 0 and W·3 % 16 == 0, contiguous
and, on a card, 16-byte aligned (the staged ``cp.async`` route, the only
one the probes run).  A "kt" variant reads a contiguous (3, 64, N) uint8
KT array with, on a card, N % 16 == 0 and a 16-byte aligned base.
Anything else raises.

``VARIANTS`` holds each variant's switches:

* ``tiles``: T, the band in tiles.  T = 64 is K1's band and plays the
  probes' chunk of C = 2048 blocks; the ablation's chunk sweep C = 4096,
  8192, 1024 runs at T = 128, 16, 32.  T = 256 (C = 8192) would need
  294,912 B of shared memory in three stages against the SM's 232,448, so
  the sweep extends downward instead; v2's C = 1024, 2048, 4096 are T = 32,
  64, 128;
* ``parts``: 3 bf16 basis parts (K1's exact split, the TPU's HIGHEST) or 1,
  the hi part (``ops/fwd_megakernel.py::split_basis``): the TPU's DEFAULT
  precision and its "bf16 one-pass" dots, one instantiation here;
* ``colour``: "ycbcr" (K1), "r" (the ablation's y = cr = cb = R, chroma
  from R's odd columns) or "rgb" (the ladder's dots: R feeds the luma
  product, G and B the chroma products, through their odd columns);
* ``channels``: 3, or 1 (luma only, 64 lanes);
* ``stage``: "sparse" (K1's sparse-delta epilogue), "split" (the same
  deltas as three outputs, (N, 64), (N, 32) and (N, 32) int16, plus each
  block's three (N,) int32 run counts: ``probe_megakernel.py``'s outputs),
  "trunc" (the coefficients themselves), or the ladder's bare rungs with no
  product, R[0:64], G[0:32] and B[0:32] of each tile as "copy_u8",
  "cast_i16" or "sum_f32" (through float32, lanes 64-95 holding G + B, as
  the probe's ``o2``);
* ``centred``: samples v - 128 with the offsets folded in and snap-trunc
  (eps 1e-5), as K1; or raw v with no offset, truncated toward zero (the
  ladder's uncentred dots);
* ``block_major``: (N, lanes) output (K1, the TPU's "transposed" output)
  or coefficient-major (lanes, N), the TPU's KT layout out;
* ``input``: "rgb" (K1's image bands) or "kt" (slabs of T blocks of the KT
  layout);
* ``basis_a``: the basis as the mma's A operand, the product coming out
  (lane, tile) and written transposed into K1's staging: the TPU
  production kernel's orientation (basis × samples, then transpose out),
  where K1 already runs ``probe_megakernel_t.py``'s (samples as A).

Lanes are 64 luma then 32 Cr and 32 Cb coefficients (K1's combined
layout), or the copy rungs' R, G, B selection.  A one-part centred variant
computes ``Σ (v-128)·hi``, the centred product of its own basis, whose
offset is 128·Σ hi; the TPU subtracted the float32 offsets from its bf16
product instead.  The probes' float32 colour with snap-trunc is K1's exact
integer colour here (identical on every colour).

``megakernel_variant`` is the wrapper (a CPU tensor runs
``megakernel_variant_ref``, the plain torch version built on
``forward_combined_ref``'s chain, ``split_basis`` and ``ops/color.py``; a
CUDA tensor launches the variant or raises), with a ``launches`` count.
``variant_flips`` holds two results of a variant to one another: identical
but for one-step truncation flips admitted by
``utils/parity.py::transform_flips`` against the variant's own basis and
offset.  ``run_variants`` is the runner of ``profiles/megakernel_ablate.py``
and ``profiles/megakernel_dma.py``; ``run_rows`` is the runner under it and
under the layout probes' ``profiles/megakernel_{kt,t,v2}.py``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import re
import tempfile
from pathlib import Path
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
    forward_combined_ref,
    kt_tiles,
    load_kernel as load_k1,
    rgb_to_kt,
    split_basis,
)
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16, rle_encode_sparse16
from lz4jpeg_tpu_torch.profiles import sass_loops
from lz4jpeg_tpu_torch.profiles.candidates_ab import _body
from lz4jpeg_tpu_torch.profiles.timing import time_ms
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
SPLIT_WIDTHS = (64, 32, 32)  # the split stage's luma, Cr and Cb outputs


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
    input: str = "rgb"
    basis_a: bool = False

    @property
    def lanes(self) -> int:
        return 128 if self.channels == 3 else 64

    @property
    def dtype(self) -> torch.dtype:
        return torch.uint8 if self.stage == "copy_u8" else torch.int16

    @property
    def product(self) -> bool:
        return self.stage not in BARE_STAGES

    @property
    def deltas(self) -> bool:  # the sparse-delta epilogue, split or not
        return self.stage in ("sparse", "split")

    def shape(self, n_blocks: int) -> Tuple[int, int]:
        return (n_blocks, self.lanes) if self.block_major else (self.lanes, n_blocks)

    def outputs(self, n_blocks: int):
        """((shape, dtype), ...) of the variant's outputs: one, or the split
        stage's three segments and three run counts."""
        if self.stage != "split":
            return ((self.shape(n_blocks), self.dtype),)
        return (tuple(((n_blocks, w), torch.int16) for w in SPLIT_WIDTHS)
                + (((n_blocks,), torch.int32),) * 3)


_A = "profiles/probe_megakernel_ablate.py"
_D = "profiles/probe_megakernel_dma.py"
_K = "profiles/probe_megakernel.py"
_T = "profiles/probe_megakernel_t.py"
_V = "profiles/probe_megakernel_v2.py"
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
    # The layout variants: K1's arithmetic, or v2's i16 copy, from KT slabs.
    Variant("kt_split_runs", 64, 3, "ycbcr", 3, "split", True, True,
            (f"{_K}:204", f"{_K}:205"), "kt"),
    Variant("kt_full", 64, 3, "ycbcr", 3, "sparse", True, True,
            (f"{_T}:132", f"{_V}:148 (C=2048)"), "kt"),
    Variant("kt_full_32", 32, 3, "ycbcr", 3, "sparse", True, True,
            (f"{_V}:148 (C=1024)",), "kt"),
    Variant("kt_full_128", 128, 3, "ycbcr", 3, "sparse", True, True,
            (f"{_V}:148 (C=4096)",), "kt"),
    Variant("kt_basis_a", 64, 3, "ycbcr", 3, "sparse", True, True,
            (f"{_T}:129",), "kt", True),
    Variant("kt_dct", 64, 3, "ycbcr", 3, "trunc", True, True, (f"{_V}:149",),
            "kt"),
    Variant("kt_copy_32", 32, 1, "rgb", 3, "cast_i16", False, True,
            (f"{_V}:146 (C=1024)",), "kt"),
    Variant("kt_copy", 64, 1, "rgb", 3, "cast_i16", False, True,
            (f"{_V}:146 (C=2048)",), "kt"),
    Variant("kt_copy_128", 128, 1, "rgb", 3, "cast_i16", False, True,
            (f"{_V}:146 (C=4096)",), "kt"),
)
BY_NAME = {v.name: v for v in VARIANTS}
RGB_VARIANTS = tuple(v for v in VARIANTS if v.input == "rgb")
KT_VARIANTS = tuple(v for v in VARIANTS if v.input == "kt")
# The variants whose arithmetic per tile is K1's: identical to
# ``forward_combined``'s output (the KT ones fed ``rgb_to_kt`` of the same
# frames; the split stage's three outputs side by side, ``combined``).
SAME_AS_K1 = ("full", "band_128", "band_16", "band_32")
KT_SAME_AS_K1 = ("kt_split_runs", "kt_full", "kt_full_32", "kt_full_128")


def _variant(name: str) -> Variant:
    if name not in BY_NAME:
        raise ValueError(f"unknown variant {name!r}; one of {sorted(BY_NAME)}")
    return BY_NAME[name]


def _kt(kt: torch.Tensor) -> int:
    """Validate a KT variant's input; return N."""
    if kt.dtype != torch.uint8:
        raise TypeError(f"expected uint8 KT, got {kt.dtype}")
    if kt.dim() != 3 or tuple(kt.shape[:2]) != (3, 64):
        raise ValueError(f"expected a (3, 64, N) KT array, got "
                         f"{tuple(kt.shape)}")
    if not kt.is_contiguous():
        raise ValueError("KT array must be contiguous")
    _check_device(kt)
    return kt.shape[2]


def _input(x: torch.Tensor, v: "Variant") -> int:
    """Validate variant ``v``'s input; return N."""
    return _kt(x) if v.input == "kt" else _batch(x)[3]


def combined(out) -> torch.Tensor:
    """A variant's (N, lanes) output; the split stage's three segments side
    by side, K1's (N, 128) buffer."""
    return torch.cat(out[:3], dim=1) if isinstance(out, tuple) else out


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
    luma, Cr and Cb products (from a KT array: colour per pixel of its
    blocks, chroma from their odd columns)."""
    if v.input == "kt":
        r, g, b = kt_tiles(rgb)
        pixels = torch.stack([r, g, b], dim=-1).reshape(-1, 8, 8, 3)
        y, cr, cb = rgb_to_ycbcr(pixels)
        return y, cr[..., 1::2], cb[..., 1::2]
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
    copy of R[0:64], G[0:32] and B[0:32] per tile.  A KT variant takes the
    blocks of ``kt_tiles``; the split stage returns its three segments and
    their run counts, ``rle_encode_sparse16``'s lengths / 2."""
    v = _variant(name)
    _input(rgb, v)
    if not v.product:
        if v.input == "kt":
            r, g, b = kt_tiles(rgb)
        else:
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
            lanes.append(rle_encode_sparse16(zz) if v.deltas else (zz, None))
        if v.stage == "split":  # run counts: lengths / 2
            return (tuple(w for w, _ in lanes)
                    + tuple(n // 2 for _, n in lanes))
        out = torch.cat([w for w, _ in lanes], dim=1)
    return out if v.block_major else out.T.contiguous()


def variant_flips(rgb: torch.Tensor, got: torch.Tensor, want: torch.Tensor,
                  name: str, lum_table: np.ndarray,
                  chr_table: np.ndarray) -> int:
    """Count the one-step truncation flips between two results of variant
    ``name`` on ``rgb``; raise AssertionError on any other difference.  The
    bare rungs must be identical; a product variant's coefficients (decoded
    from the sparse deltas where it has them) may differ by 1 where the
    float64 value of its own product lies at a truncation tie
    (``transform_flips`` with ``_rule_basis``).  The split stage's run
    counts must each equal the nonzero words of its segment."""
    v = _variant(name)
    if v.stage == "split":  # each count is its segment's nonzero words
        for out in (got, want):
            for words, runs in zip(out[:3], out[3:]):
                counts = (words != 0).sum(dim=1, dtype=torch.int32)
                if runs.dtype != torch.int32 or not torch.equal(runs, counts):
                    raise AssertionError(f"{name}: run counts differ from the "
                                         "nonzero words")
        got, want = combined(got), combined(want)
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
        if v.deltas:
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


def variant_bytes(name: str, n_blocks: int) -> int:
    """The bytes variant ``name`` must move on ``n_blocks`` tiles: the input
    bytes of each tile it needs read once, its lanes written once.  A
    tile's input is its 192 bytes, but 128 for a KT copy: R[0:64], G[0:32]
    and B[0:32] lie apart in the KT layout, where RGB interleaves the
    channels.  The split stage writes three int32 run counts per tile
    more."""
    v = _variant(name)
    itemsize = 1 if v.dtype == torch.uint8 else 2
    read = 128 if v.input == "kt" and not v.product else 192
    return n_blocks * (read + v.lanes * itemsize
                       + (12 if v.stage == "split" else 0))


def variant_bound(name: str, n_blocks: int) -> Tuple[float, str]:
    """(bound_ms, bound_by) of variant ``name`` on ``n_blocks`` tiles: the
    larger of its bytes (``variant_bytes``) over 3.35 TB/s and its bf16
    tensor work (``parts`` passes of the 64-deep luma and two 32-deep
    chroma products) over 989 TFLOP/s, as ``chip_smoke.py::bound``."""
    v = _variant(name)
    flops = 0.0
    if v.product:
        depth = 64 * 64 + (2 * 32 * 32 if v.channels == 3 else 0)
        flops = float(n_blocks) * v.parts * 2 * depth
    by_bytes = variant_bytes(name, n_blocks) / (HBM_PEAK_GBS * 1e9) * 1e3
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
    lib.fwd_probe_kt_launch.restype = ctypes.c_int
    lib.fwd_probe_kt_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
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
                       chr_table: np.ndarray):
    """Variant ``name`` of a (B, H, W, 3) uint8 batch ("rgb" variants) or a
    (3, 64, N) uint8 KT array ("kt" variants) → its (N, lanes) or (lanes,
    N) output (int16, or uint8 for "copy_u8"); the split stage returns its
    (N, 64), (N, 32), (N, 32) int16 segments and their three (N,) int32 run
    counts.

    A CPU tensor runs ``megakernel_variant_ref``.  A CUDA tensor launches
    the variant on the current stream and adds one to
    ``megakernel_variant.launches``; a refused launch raises."""
    v = _variant(name)
    n = _input(rgb, v)
    if rgb.device.type == "cpu":
        return megakernel_variant_ref(rgb, name, lum_table, chr_table)
    if rgb.data_ptr() % 16:
        raise ValueError("the probes' staged route needs a 16-byte aligned "
                         "input")
    if v.input == "kt" and n % 16:
        raise ValueError(f"the KT route copies 16 blocks at a time: N % 16 "
                         f"== 0, got N = {n}")
    outs = tuple(torch.empty(shape, dtype=dtype, device=rgb.device)
                 for shape, dtype in v.outputs(n))
    if n == 0:
        return outs if v.stage == "split" else outs[0]
    parts = _device_bases(_table_key(lum_table), _table_key(chr_table),
                          rgb.device)
    lib = load_kernel()
    if v.input == "kt":
        ptrs = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
        _launch(lib, "fwd_probe_kt_launch", "fwd_probe_error_string",
                rgb.device, VARIANTS.index(v), rgb.data_ptr(), ptrs,
                parts.data_ptr(), n)
    else:
        b, h, w, _ = rgb.shape
        _launch(lib, "fwd_probe_launch", "fwd_probe_error_string",
                rgb.device, VARIANTS.index(v), rgb.data_ptr(),
                outs[0].data_ptr(), parts.data_ptr(), b, h, w)
    megakernel_variant.launches += 1
    return outs if v.stage == "split" else outs[0]


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
# K1's launch plan and arithmetic, mirrored in numpy
# ---------------------------------------------------------------------------
#
# ``csrc/fwd_megakernel.cuh``'s band loop: persistent CTAs of one producer
# warp and ``K1_GROUPS`` consumer groups of 8 warps; CTA c takes bands c,
# c + grid, ...; its i-th band goes to ring slot i % ``K1_SLOTS`` and group
# i % ``K1_GROUPS``.  The producer waits on the slot's "empty" mbarrier with
# parity ((i // slots) & 1) ^ 1, the group on its "full" one with (i //
# slots) & 1 once the band number beside the slot is its band's (slots are
# no multiple of groups, so a group can reach a slot whose previous fill,
# another group's band, has not landed: the parity alone would pass).  On
# the staged route each band row inside the frame comes in by one 1-D bulk
# copy; each band leaves by one bulk store of its rows.

K1_TILES = 64  # T, tiles a band
K1_GROUPS = 3
K1_SLOTS = 5
K1_THREADS = K1_GROUPS * 256 + 32  # the consumer groups and the producer warp
K1_SLOT_BYTES = 8 * K1_TILES * 24  # 8 image rows of T·8 pixels
# A group: its unpadded output rows, the geometry of the band it stores
# (32 B), the bf16 operands (rows + 16 B) and the staged int16 rows (+ 16 B).
K1_GROUP_BYTES = (K1_TILES * 128 * 2 + 32 + K1_TILES * 72 * 2
                  + 2 * K1_TILES * 40 * 2 + K1_TILES * 136 * 2)
# The ring, the groups, each slot's band geometry (32 B) and two mbarriers.
K1_SMEM = K1_SLOTS * K1_SLOT_BYTES + K1_GROUPS * K1_GROUP_BYTES + K1_SLOTS * 48
K1_ROW_BYTES = 128 * 2  # one output row, 128 int16 lanes


@dataclasses.dataclass(frozen=True)
class K1Plan:
    n_bands: int
    resident: int
    ctas: int
    groups: int
    slots: int
    threads: int
    smem: int
    slot_bytes: int
    tiles: int
    producers: int = 1  # producer warps taking the CTA's bands in turn


def _blocks_of(batch: int, h: int, w: int,
               tiles: int = K1_TILES) -> Tuple[int, int, int]:
    """(bpc, bpr, bands a block row) of a (batch, h, w) image batch in
    bands of ``tiles`` tiles."""
    bpc, bpr = -(-h // 8), -(-w // 8)
    return bpc, bpr, -(-bpr // tiles)


def k1_plan(batch: int, h: int, w: int, resident: int) -> K1Plan:
    """``fwd_megakernel_plan`` for a (batch, h, w) batch on a card where
    ``resident`` CTAs fit: every band, at most one CTA a band."""
    bpc, _, per_row = _blocks_of(batch, h, w)
    n_bands = batch * bpc * per_row
    return K1Plan(n_bands, resident, min(n_bands, resident), K1_GROUPS,
                  K1_SLOTS, K1_THREADS, K1_SMEM, K1_SLOT_BYTES, K1_TILES)


def band_plan(name: str, batch: int, h: int, w: int, resident: int) -> K1Plan:
    """The plan of RGB variant ``name`` (its frame, ``rgb_frame``) for a
    (batch, h, w) batch on a card where ``resident`` CTAs fit, as
    ``persistent_grid`` reports it."""
    v, f = _variant(name), rgb_frame(name)
    bpc, _, per_row = _blocks_of(batch, h, w, v.tiles)
    n_bands = batch * bpc * per_row
    return K1Plan(n_bands, resident, min(n_bands, resident), f["groups"],
                  f["slots"], f["threads"], f["smem"], 8 * v.tiles * 24,
                  v.tiles, f["producers"])


def band_schedule(plan: K1Plan) -> np.ndarray:
    """(n_bands, 6) int64 rows (band, cta, i, group, slot, full parity): the
    i-th band of CTA ``cta`` in the kernel's loops; the producer's "empty"
    parity is full parity ^ 1."""
    rows = []
    for cta in range(plan.ctas):
        band = np.arange(cta, plan.n_bands, plan.ctas, dtype=np.int64)
        i = np.arange(band.size, dtype=np.int64)
        rows.append(np.stack([band, np.full_like(band, cta), i, i % plan.groups,
                              i % plan.slots, (i // plan.slots) & 1], 1))
    return np.concatenate(rows) if rows else np.zeros((0, 6), np.int64)


def band_geometry(batch: int, h: int, w: int,
                  tiles: int = K1_TILES) -> np.ndarray:
    """(n_bands, 5) int64 rows (source byte offset, out_row, rows, cols,
    tiles) of ``band_at`` for bands of ``tiles`` tiles: the band's first
    pixel in the batch, the output row of its first tile, its image rows
    and pixel columns inside the frame, its tiles."""
    bpc, bpr, per_row = _blocks_of(batch, h, w, tiles)
    band = np.arange(batch * bpc * per_row, dtype=np.int64)
    row_id, bx0 = band // per_row, (band % per_row) * tiles
    f, by = row_id // bpc, row_id % bpc
    src = (f * h + by * 8) * (w * 3) + bx0 * 24
    return np.stack([src, row_id * bpr + bx0, np.minimum(8, h - by * 8),
                     w - bx0 * 8, np.minimum(tiles, bpr - bx0)], 1)


def bulk_copies(batch: int, h: int, w: int,
                tiles: int = K1_TILES) -> np.ndarray:
    """(copies, 4) int64 rows (band, slot byte offset, source byte offset,
    bytes) of the staged route: one copy a band row inside the frame, of
    min(T·8, cols)·3 bytes at stride W·3, into row r of the slot."""
    geo = band_geometry(batch, h, w, tiles)
    out = []
    for r in range(8):
        sel = np.nonzero(geo[:, 2] > r)[0]
        g = geo[sel]
        out.append(np.stack([sel, np.full_like(sel, r * tiles * 24),
                             g[:, 0] + r * w * 3,
                             np.minimum(tiles * 8, g[:, 3]) * 3], 1))
    rows = np.concatenate(out)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def bulk_stores(batch: int, h: int, w: int,
                tiles: int = K1_TILES) -> np.ndarray:
    """(n_bands, 2) int64 rows (output byte offset, bytes): each band's
    b.tiles rows of 256 bytes at out_row · 256."""
    geo = band_geometry(batch, h, w, tiles)
    return np.stack([geo[:, 1] * K1_ROW_BYTES, geo[:, 4] * K1_ROW_BYTES], 1)


def ring_events(plan: K1Plan, seed: int = 0) -> Dict[str, list]:
    """Run the CTAs' producers and groups in a random interleaving on a model
    of the ring's mbarriers, each wait passing only when the barrier's
    completed phases have the other parity (``mbarrier.try_wait.parity``).
    Producer p of ``plan.producers`` fills the CTA's bands i ≡ p in order.
    A fill writes the band's number beside the slot when it starts (the
    producer's header) and completes the slot's "full" phase when it lands;
    a group waits for the number to be its band's, then for the parity.
    Returns per CTA the order of fills and reads ((cta, band,
    slot), (cta, group, band, slot)) and the count of parity waits that
    passed on a slot whose last fill had not landed (``stale``); raises
    AssertionError where a group reads a slot that holds another band or
    the producer refills a slot its group has not released."""
    rng = np.random.default_rng(seed)
    sched = band_schedule(plan)
    log = {"fills": [], "reads": [], "stale": 0}
    for cta in range(plan.ctas):
        mine = sched[sched[:, 1] == cta]
        full = [0] * plan.slots    # completed phases of each "full" barrier
        empty = [0] * plan.slots   # of each "empty" barrier
        tag = [None] * plan.slots  # the band number beside each slot
        holds = [None] * plan.slots  # the band whose bytes a slot holds
        landing = {}               # slot: band started, not landed
        producers = [("p", p) for p in range(plan.producers)]
        nxt = {**{p: p[1] for p in producers},
               **{g: g for g in range(plan.groups)}}
        while True:
            ready = []
            for p in producers:
                ip = nxt[p]
                if ip < len(mine):
                    s, par = int(mine[ip, 4]), int(mine[ip, 5]) ^ 1
                    if empty[s] & 1 != par and s not in landing:
                        ready.append(p)
            ready += [("land", s) for s in landing]
            for g in range(plan.groups):
                i = nxt[g]
                if i < len(mine):
                    band, s, par = int(mine[i, 0]), int(mine[i, 4]), int(mine[i, 5])
                    passes = full[s] & 1 != par
                    if tag[s] == band:  # then the parity wait is exact
                        assert not (passes and s in landing), (
                            f"CTA {cta}: band {band} read before it landed")
                        if passes:
                            ready.append(g)
                    elif passes:  # the parity alone would take a stale fill
                        log["stale"] += 1
            if not ready:
                left = [k for k, v in nxt.items() if v < len(mine)]
                assert not left, f"CTA {cta}: deadlock, {left} waiting"
                break
            who = ready[rng.integers(len(ready))]
            if isinstance(who, tuple) and who[0] == "land":  # a fill lands
                s = who[1]
                holds[s] = landing.pop(s)
                full[s] += 1
                continue
            i = nxt[who]
            band, s = int(mine[i, 0]), int(mine[i, 4])
            if isinstance(who, tuple):  # a producer's fill starts
                assert holds[s] is None, (
                    f"CTA {cta}: slot {s} refilled with band {band} while "
                    f"band {holds[s]} is unread")
                tag[s] = band
                landing[s] = band
                log["fills"].append((cta, band, s))
                nxt[who] += plan.producers
            else:
                assert holds[s] == band, (
                    f"CTA {cta}: group {who} read band {holds[s]} for {band}")
                holds[s] = None
                empty[s] += 1
                log["reads"].append((cta, who, band, s))
                nxt[who] += plan.groups
    return log


def launch_plan(batch: int, h: int, w: int, device="cuda") -> K1Plan:
    """The plan K1's C entry ``fwd_megakernel_plan`` reports for a (batch,
    h, w) batch on ``device`` (the card's resident CTAs from the occupancy
    query)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the launch plan needs a CUDA device, not {dev}")
    out = (ctypes.c_int64 * 9)()
    lib = load_k1()
    with torch.cuda.device(dev):
        rc = lib.fwd_megakernel_plan(batch, h, w, -(-h // 8), -(-w // 8), out)
    if rc != 0:
        msg = lib.fwd_megakernel_error_string(rc).decode()
        raise RuntimeError(f"fwd_megakernel_plan failed: {msg} ({rc})")
    return K1Plan(*out)


def k1_attributes(device="cuda") -> Dict[str, int]:
    """K1's registers per thread, shared memory per CTA and resident CTAs
    per SM (``fwd_megakernel_attributes``)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"attributes need a CUDA device, not {dev}")
    regs, smem, ctas = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = load_k1()
    with torch.cuda.device(dev):
        rc = lib.fwd_megakernel_attributes(ctypes.byref(regs),
                                           ctypes.byref(smem),
                                           ctypes.byref(ctas))
    if rc != 0:
        msg = lib.fwd_megakernel_error_string(rc).decode()
        raise RuntimeError(f"fwd_megakernel_attributes failed: {msg} ({rc})")
    return {"registers": regs.value, "shared_bytes": smem.value,
            "ctas_per_sm": ctas.value}


STAGES = ("sparse", "trunc", "copy_u8", "cast_i16", "sum_f32", "split")  # Stage
KT_PRODUCTS = tuple(v.name for v in VARIANTS if v.input == "kt" and v.product)
H100_ISSUE_RATE = 132 * 4 * 1.98e9  # SMs × schedulers × the top SM clock


def variant_args(demangled: str) -> Optional[Tuple[int, ...]]:
    """The ten template arguments of the ``Variant`` of a demangled
    megakernel (T, parts, colour, channels, stage, centred, block-major,
    groups, input, basis-A) as ints, or None for another kernel."""
    key = sass_loops._sass_diff().kernel_key(demangled)
    if len(key[1]) != 1 or not key[1][0].startswith("Variant<"):
        return None
    args = sass_loops._sass_diff()._top_level_split(key[1][0][8:-1])
    vals = []
    for a in args:
        a = re.sub(r"^\(\w+\)", "", a.strip())  # (int)64, (Stage)5
        vals.append(1 if a == "true" else 0 if a == "false" else int(a))
    return tuple(vals)


def _kt_key(v: Variant) -> Tuple[int, int, int]:
    return v.tiles, STAGES.index(v.stage), int(v.basis_a)


# P-abl's chunk sweep: K1's arithmetic in bands of T = 16, 32 and 128 tiles.
BAND_ROWS = ("band_16", "band_32", "band_128")
_K1_ARITHMETIC = (3, 0, 3, 0, 1, 1)  # parts, YCbCr, channels, sparse, ...


def _rgb_path(ins, tiles: int, groups: int) -> Dict:
    """``sass_loops.band_path`` of an RGB build over T = ``tiles`` (T/16
    m-tiles a band): the consumer warps that take a band (8, or 24 / groups
    past 4 groups) and a producer warp's pass, a tile."""
    path = sass_loops.band_path(ins, tiles // 16)
    path["groups"] = groups
    path["warps"] = 24 // groups if groups > 4 else 8
    path["per_tile"] = (path["warps"] * path["consumer"]
                        + path["producer"]) / tiles
    return path


def band_sass_counts(root=None,
                     keys: Sequence[str] = ("k1", *KT_PRODUCTS, *BAND_ROWS)
                     ) -> Dict[str, Dict]:
    """Warp instructions a tile of K1 (``csrc/fwd_megakernel.cu``), of the
    KT variants and of the chunk sweep's band rows (``BAND_ROWS``,
    ``csrc/fwd_probe_kernel.cu``) in the checkout at ``root`` (this one by
    default), from their SASS; ``keys`` picks which ("k1", KT variant or
    band row names; the KT products and the band rows by default).  K1
    and a band row: ``sass_loops.band_path``, the band loop's path on the
    aligned route for each of the warps that take a band (8; 2 in the
    16-tile band's groups) and a producer's pass, over the band's T tiles (T/16
    m-tiles), with the per-warp counts and the stretches between barriers,
    and the build's ``groups``.  A KT variant: ``sass_loops.kt_band_path``,
    split by warp role (the basis-A variant's luma and chroma warps; the
    producer warps), with the consumer groups the build has (``groups``).
    Needs the CUDA toolkit, not a card."""
    sd = sass_loops._sass_diff()
    root = Path(root) if root else sass_loops.REPO
    counts = {}
    kt = {_kt_key(BY_NAME[k]): k for k in keys
          if k in BY_NAME and BY_NAME[k].input == "kt"}
    rgb = {BY_NAME[k].tiles: k for k in keys if k in BAND_ROWS}
    with tempfile.TemporaryDirectory() as tmp:
        if "k1" in keys:  # the file's one kernel
            ins = next(iter(sd.sass(root, "fwd_megakernel", Path(tmp)).values()))
            counts["k1"] = _rgb_path(ins, 64, 3)
        if kt or rgb:
            functions = sd.sass(root, "fwd_probe_kernel", Path(tmp))
            for name, ins in zip(sd.demangle(list(functions)),
                                 functions.values()):
                args = variant_args(name)
                if args is None:
                    continue
                if args[8] == 0:  # an RGB build: a band row or no key
                    key = (rgb.get(args[0])
                           if args[1:7] == _K1_ARITHMETIC else None)
                    if key is not None:
                        counts[key] = _rgb_path(ins, args[0], args[7])
                    continue
                key = kt.get((args[0], args[4], args[9]))
                if key is not None:  # chunks: 192 or 128 pieces × T/16
                    chunks = (12 if BY_NAME[key].product else 8) * args[0]
                    path = sass_loops.kt_band_path(ins, args[0], chunks)
                    path["groups"] = args[7]
                    counts[key] = path
    return counts


def probe_ptxas(root=None, usage=None) -> Dict[str, Dict[str, int]]:
    """{KT variant or band row: ptxas's registers and spill bytes, the
    build's groups} of the checkout at ``root`` (``sass_loops.ptxas_usage``
    of its probe library, or ``usage``, that call's result); needs the
    toolkit."""
    root = Path(root) if root else sass_loops.REPO
    kt = {_kt_key(v): v.name for v in KT_VARIANTS}
    rgb = {BY_NAME[k].tiles: k for k in BAND_ROWS}
    if usage is None:
        usage = sass_loops.ptxas_usage("fwd_probe_kernel", root)
    out = {}
    for name, use in usage.items():
        args = variant_args(name)
        if args is None:
            continue
        if args[8] == 1:
            key = kt.get((args[0], args[4], args[9]))
        else:
            key = rgb.get(args[0]) if args[1:7] == _K1_ARITHMETIC else None
        if key is not None:
            out[key] = {**use, "groups": args[7]}
    return out


def issue_floor_ms(per_tile: float, n_blocks: int,
                   rate: float = H100_ISSUE_RATE) -> float:
    """``per_tile`` warp instructions a tile over ``n_blocks`` tiles at one
    warp instruction a clock on every scheduler (``rate`` a second, the
    H100's 132 SMs × 4 at 1,980 MHz by default; ``timing.issue_bound_ms``
    asks the card)."""
    return per_tile * n_blocks / rate * 1e3


# ---------------------------------------------------------------------------
# The frames of the variants, mirrored in numpy
# ---------------------------------------------------------------------------
#
# ``csrc/fwd_megakernel.cuh``'s KT products (``KT_PRODUCTS``): at three
# groups a producer warpgroup (4 warps, 896 threads, launched at 72
# registers) drops to ``KT_PRODUCER_REGS`` and the consumers rise to
# ``KT_CONSUMER_REGS`` (setmaxnreg); a product group's output rows alias its
# bf16 operands; the basis-A product stages the basis once a CTA and splits
# its 72 mma per 8 tiles over the 8 warps, 9 each.  The RGB variants keep
# K1's frame (one producer warp, groups of 8 warps), but at T = 128 their
# product's rows alias its operands too (two groups fit), and the 16-tile
# band runs 12 groups of 2 warps (``kWide``) on a staged basis under four
# producer warps that take its bands in turn, its rows over its operands,
# its ring sized by K1's bytes (``RING_BYTES``) instead of a count of 5.
# ``KT_GROUPS`` and ``RGB_GROUPS`` hold each variant's groups
# (``csrc/fwd_probe_kernel.cu``'s instantiations).

KT_GROUPS = {"kt_split_runs": 2, "kt_full": 3, "kt_full_32": 3,
             "kt_full_128": 2, "kt_basis_a": 3, "kt_dct": 3, "kt_copy_32": 3,
             "kt_copy": 3, "kt_copy_128": 1}
RGB_GROUPS = {**{v.name: 3 for v in RGB_VARIANTS}, "coefficient_major": 2,
              "dots_three_parts": 2, "band_128": 2, "band_16": 12}
KT_CONSUMER_REGS = 80
KT_PRODUCER_REGS = 24
SMEM_LIMIT = 232_448
LUM_STRIDE, CHR_STRIDE, Q_STRIDE = 64 + 8, 32 + 8, 128 + 8  # padded rows
BAND_BYTES = 32  # sizeof(Band)
STAGED_BASIS_BYTES = (3 * 64 * LUM_STRIDE + 3 * 32 * CHR_STRIDE) * 2
RING_BYTES = 5 * K1_SLOT_BYTES  # kRingBytes: K1's 5 slots of T = 64
NAMED_BARRIERS = 16  # bar.sync ids 0-15; 0 is __syncthreads'


def _frame(v: Variant, groups: int) -> Dict[str, int]:
    """Variant ``v``'s frame at ``groups`` consumer groups (``kt_frame``)."""
    t, wide = v.tiles, groups > 4
    split_regs = v.input == "kt" and v.product and groups == 3
    producer_warps = 4 if split_regs or wide else 1
    group_warps = 24 // groups if wide else 8
    threads = groups * 32 * group_warps + 32 * producer_warps
    operands = t * LUM_STRIDE * 2 + 2 * t * CHR_STRIDE * 2
    if v.block_major:
        staging = t * Q_STRIDE * 2
    else:  # a row of T outputs (+ 16 B) a lane, as int16 elements
        item = 1 if v.stage == "copy_u8" else 2
        staging = (v.lanes * (t + 16 // item) * item + 1) // 2 * 2
    bulk_out = v.block_major and v.stage != "split"
    alias = (v.product and bulk_out
             and (v.input == "kt" or t == 128 or wide))  # AliasGroup
    rows = 0 if alias else (t * v.lanes * 2 if bulk_out else 16)
    group = -(-(rows + BAND_BYTES + operands + staging) // 16) * 16
    staged = (STAGED_BASIS_BYTES
              if (v.input == "kt" and v.product and v.basis_a) or wide else 0)
    slot_bytes = 8 * t * 24
    per_slot = slot_bytes + BAND_BYTES + 16  # bytes, geometry, 2 mbarriers
    cap = RING_BYTES // slot_bytes if wide else 5
    slots = min(cap, (SMEM_LIMIT - groups * group - staged - 64) // per_slot)
    per_scheduler = -(-threads // 32 // 4)  # warps on the fullest of 4
    return {"groups": groups, "group_warps": group_warps,
            "producer_warps": producer_warps,
            "producers": producer_warps if wide else 1, "threads": threads,
            "launch_registers": 16384 // (32 * per_scheduler) // 8 * 8,
            "slots": slots, "group_bytes": group, "aliased": int(alias),
            "staged_bytes": staged,
            "smem": slots * per_slot + groups * group + staged}


def kt_frame(name: str) -> Dict[str, int]:
    """The frame of KT variant ``name``: consumer groups, warps a group,
    producer warps, threads a CTA, the registers it launches at (what a
    scheduler's 16,384 leave each thread of its warps, in steps of 8), ring
    slots, bytes a group, whether its output rows lie over its operands,
    the staged basis and the dynamic shared memory a CTA (``Smem<V>`` and
    the staged basis), as ``ring_slots``, ``Group`` and ``dynamic_smem``
    lay them out."""
    v = _variant(name)
    if v.input != "kt":
        raise ValueError(f"{name} is no KT variant")
    return _frame(v, KT_GROUPS[name])


def rgb_frame(name: str) -> Dict[str, int]:
    """The frame of RGB variant ``name``, as ``kt_frame``'s: K1's
    ``(3, 25 warps, 5 slots, 221,520 B)`` for most; two groups with their
    rows over their operands at T = 128; 12 groups of 2 warps on the staged
    basis, 4 producer warps, rows over the operands and K1's bytes of ring
    at T = 16."""
    v = _variant(name)
    if v.input != "rgb":
        raise ValueError(f"{name} is no RGB variant")
    return _frame(v, RGB_GROUPS[name])


def basis_a_plan(tiles: int) -> np.ndarray:
    """(units, 4) int64 rows (warp, channel, m-tile, n-tile) of the basis-A
    product of one band of ``tiles`` tiles (``basis_a_band``): channel 0
    luma (4 m-tiles of 16 lanes, 12 mma an n-tile of 8 tiles), 1 Cr and 2
    Cb (2 m-tiles, 6 mma).  Warp w < 4: luma m-tile w over the first 3T/32
    n-tiles; warp w ≥ 4: m-tile w & 1 of channel 1 + ((w >> 1) & 1) over
    all T/8 n-tiles, then luma m-tile w - 4 over the last T/32."""
    split, n_tiles = 3 * tiles // 32, tiles // 8
    rows = []
    for w in range(8):
        if w >= 4:
            rows += [(w, 1 + ((w >> 1) & 1), w & 1, nt) for nt in range(n_tiles)]
        first, last = (0, split) if w < 4 else (split, n_tiles)
        rows += [(w, 0, w & 3, nt) for nt in range(first, last)]
    return np.array(rows, dtype=np.int64)


def plan_mma(plan: np.ndarray) -> np.ndarray:
    """The mma each of the 8 warps issues in ``plan`` (``basis_a_plan``):
    3 parts × 4 k-steps a luma unit, 3 × 2 a chroma one."""
    per_unit = np.where(plan[:, 1] == 0, 12, 6)
    return np.bincount(plan[:, 0], weights=per_unit, minlength=8).astype(np.int64)


def _f32(x: np.ndarray) -> np.ndarray:
    """float64 values rounded to nearest float32, back as float64."""
    return x.astype(np.float32).astype(np.float64)


def basis_a_coefficients(kt: np.ndarray, lum_table: np.ndarray,
                         chr_table: np.ndarray) -> np.ndarray:
    """(N, 128) int32 coefficients of ``kt_basis_a`` on a (3, 64, N) uint8
    KT array in the kernel's order: the colour of each block (K1's),
    centred samples v - 128, and for every output the mma chains of
    ``product_basis_a``: each k-step adds its 16 exact products to a float32
    chain in one rounding, lo then mid into one chain and hi into the
    other, in k order; one float32 add of the two; ``snap_trunc_fast``.
    Each band's (16 lanes × 8 tiles) blocks are placed by the units of
    ``basis_a_plan``; raises AssertionError unless every output is placed
    once."""
    v = BY_NAME["kt_basis_a"]
    y, cr, cb = _channel_tiles(torch.from_numpy(kt), v)
    chains = []
    for tiles, table, width in ((y, lum_table, 8), (cr, chr_table, 4),
                                (cb, chr_table, 4)):
        x = tiles.reshape(tiles.shape[0], -1).numpy().astype(np.float64) - 128
        m, _ = forward_basis(width, 8, _table_key(table))
        hi, mid, lo = split_basis(m).astype(np.float64)
        small = np.zeros((x.shape[0], len(m)))
        large = np.zeros_like(small)
        steps = range(x.shape[1] // 16)

        def dot(part, ks):
            return x[:, 16 * ks:16 * ks + 16] @ part[:, 16 * ks:16 * ks + 16].T

        for ks in steps:
            small = _f32(small + dot(lo, ks))
            large = _f32(large + dot(hi, ks))
        for ks in steps:
            small = _f32(small + dot(mid, ks))
        chains.append(snap_trunc_fast(_f32(small + large).astype(np.float32)))
    n, t = kt.shape[2], v.tiles
    out = np.zeros((n, 128), dtype=np.int32)
    placed = np.zeros((n, 128), dtype=np.int32)
    for band in range(-(-n // t)):
        for _, ch, mt, nt in basis_a_plan(t):
            rows = slice(band * t + 8 * nt, min(n, band * t + 8 * nt + 8))
            lanes = slice((0, 64, 96)[ch] + 16 * mt, (0, 64, 96)[ch] + 16 * mt + 16)
            out[rows, lanes] = chains[ch][rows, 16 * mt:16 * mt + 16]
            placed[rows, lanes] += 1
    assert (placed == 1).all(), "the plan places an output twice or never"
    return out


def kt_slot(band: np.ndarray) -> np.ndarray:
    """The ring slot of one KT band ((3, 64, T) uint8: pieces 64c + p of T
    bytes), as ``load_kt`` fills it: chunk j of piece ρ at
    ``kt_chunk_offset``, ((ρ·T/16 + j) ^ (ρ & 7))·16."""
    t = band.shape[2]
    per = t // 16
    slot = np.zeros(192 * t, dtype=np.uint8)
    pieces = band.reshape(192, t)
    for rho in range(192):
        for j in range(per):
            at = ((rho * per + j) ^ (rho & 7)) * 16
            slot[at:at + 16] = pieces[rho, 16 * j:16 * j + 16]
    return slot


def emulate_convert_kt(band: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``convert_kt`` of one KT band, thread by thread: each of a group's 256
    threads reads its six words a unit from the slot (``kt_slot``) at the
    source's addresses, turns them by its rot, and writes the centred
    samples of byte i through its staging pointers.  Returns the (T, 64)
    luma and (2, T, 32) chroma operands as ints; raises AssertionError
    unless every operand is written once."""
    t = band.shape[2]
    per = t // 16
    channel = 64 * per * 16
    slot = kt_slot(band)
    word = lambda at: int.from_bytes(slot[at:at + 4].tobytes(), "little")
    lum = np.zeros((t, 64), dtype=np.int64)
    chr_ = np.zeros((2, t, 32), dtype=np.int64)
    wrote_l = np.zeros_like(lum)
    wrote_c = np.zeros_like(chr_)

    def colour(px, ch):
        r, g, b, add = COLOUR_COEFS[ch]
        s = r * (px & 0xFF) + g * ((px >> 8) & 0xFF) + b * ((px >> 16) & 0xFF)
        return int(per_mille(s + add)) - 128

    for tid in range(256):
        lane, gw = tid & 31, tid >> 5
        qq, w = lane & 7, lane >> 3
        h, rot = (qq >> 2) & 1, w & 2
        q = 8 * (gw & 3) + qq
        first, second = 2 * q + h, 2 * q + 1 - h
        t0 = 16 * (gw >> 2) + 4 * w
        for m in range(t // 32):
            j = (gw >> 2) + 2 * m
            a = ((first * per + j) ^ (first & 7)) * 16 + 4 * w
            b = ((second * per + j) ^ (second & 7)) * 16 + 4 * w
            turn = (lambda x: ((x >> 16) | (x << 16)) & 0xFFFFFFFF) if rot \
                else (lambda x: x)
            x = [turn(word(a + c * channel)) for c in range(3)]
            y = [turn(word(b + c * channel)) for c in range(3)]
            e, o = (y, x) if h else (x, y)
            for i in range(4):
                tile = (t0 + rot if i < 2 else t0 - rot) + 32 * m + i
                pe = sum(((e[c] >> (8 * i)) & 0xFF) << (8 * c) for c in range(3))
                po = sum(((o[c] >> (8 * i)) & 0xFF) << (8 * c) for c in range(3))
                lum[tile, 2 * q:2 * q + 2] = colour(pe, "y"), colour(po, "y")
                wrote_l[tile, 2 * q:2 * q + 2] += 1
                chr_[:, tile, q] = colour(po, "cr"), colour(po, "cb")
                wrote_c[:, tile, q] += 1
    assert (wrote_l == 1).all() and (wrote_c == 1).all(), \
        "an operand written twice or never"
    return lum, chr_


def kt_copy_plan(tiles: int, producer_warps: int) -> np.ndarray:
    """(chunks, 4) int64 rows (producer lane, slot byte offset, piece,
    chunk) of a KT product band's 16-byte copies (``load_kt``): one warp's
    lane i copies chunks i, i + 32, ... at ``kt_chunk_offset``; a producer
    warpgroup's lane copies chunk lane % (T/16) of pieces lane / (T/16) +
    j·128/(T/16) at one swizzle, (lane ^ (lane / (T/16) & 7) + 128 j)·16."""
    per = tiles // 16
    lanes = 32 * producer_warps
    rows = []
    for lane in range(lanes):
        for j in range(192 * per // lanes):
            if producer_warps == 1:
                i = lane + 32 * j
                piece, c = i // per, i % per
                offset = ((piece * per + c) ^ (piece & 7)) * 16
            else:
                piece, c = lane // per + j * (lanes // per), lane % per
                offset = ((lane ^ ((lane // per) & 7)) + j * lanes) * 16
            rows.append((lane, offset, piece, c))
    return np.array(rows, dtype=np.int64)


def alias_events(bands: int, seed: int, threads: int = 3,
                 barrier: bool = True, groups: int = 1) -> Dict[str, int]:
    """``groups`` product groups whose output rows alias their operands
    (``AliasGroup``), ``bands`` bands each, on a model of their rows
    (``band_loop``): each thread converts (writes the operand bytes, which
    are the rows), passes the product's barrier, writes the rows in the
    store pass and passes the store's barrier; thread 0 then issues the
    bulk store, whose read of the rows lands at a random later step.  At
    the next band thread 0 first waits for its reads (``bulk_wait_read``),
    then with ``barrier`` every thread passes the group's barrier before it
    converts.  Each group has its own rows, its own named barrier and its
    storing thread's bulk groups.  Random interleavings of every group's
    threads and the landings; returns the count of writes made while a
    read of the same group's rows was in flight (``violations``) and of
    bulk stores issued."""
    rng = np.random.default_rng(seed)
    head = (["wait", "bar"] if barrier else ["wait"])
    prog = [[op for _ in range(bands) for op in
             ((head if k == 0 else (["bar"] if barrier else []))
              + ["write", "bar", "write", "bar"]
              + (["store"] if k == 0 else []))] for k in range(threads)]
    live = [(g, k) for g in range(groups) for k in range(threads)]
    pc = {t: 0 for t in live}
    arrived = [set() for _ in range(groups)]  # threads at a group's barrier
    flight = [0] * groups  # a group's bulk reads not landed
    out = {"violations": 0, "stores": 0}
    while any(pc[g, k] < len(prog[k]) for g, k in live) or any(flight):
        ready = [("land", g) for g in range(groups) if flight[g]]
        for g in range(groups):  # every live thread at the barrier: it opens
            if arrived[g] and all(k in arrived[g] or pc[g, k] >= len(prog[k])
                                  for k in range(threads)):
                ready.append(("open", g))
        for g, k in live:
            if pc[g, k] >= len(prog[k]) or k in arrived[g]:
                continue
            if prog[k][pc[g, k]] != "wait" or flight[g] == 0:
                ready.append(("run", g, k))
        assert ready, "deadlock"
        who = ready[rng.integers(len(ready))]
        if who[0] == "land":
            flight[who[1]] -= 1
            continue
        if who[0] == "open":
            for k in arrived[who[1]]:
                pc[who[1], k] += 1
            arrived[who[1]].clear()
            continue
        _, g, k = who
        op = prog[k][pc[g, k]]
        if op == "bar":
            arrived[g].add(k)
            continue
        if op == "write" and flight[g]:
            out["violations"] += 1
        if op == "store":
            flight[g] += 1
            out["stores"] += 1
        pc[g, k] += 1
    return out


F32_EPS = np.float32(1e-5)


def _rz32(exact: np.ndarray) -> np.ndarray:
    """float64 values (exact sums) rounded toward zero to float32."""
    f = exact.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(exact)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def snap_trunc_int_ref(x: np.ndarray) -> np.ndarray:
    """The earlier ``snap_trunc_int`` (float32 x, |x| < 2^13, where each
    float64 sum below is exact): floor(|x|) by |x| + 2^23 rounded toward
    zero, frac = |x| - floor(|x|), plus one where 1 - frac (rounded to
    nearest) ≤ 1e-5f; negated for x < 0.  int32."""
    x = np.asarray(x, dtype=np.float32)
    ax = np.abs(x)
    k23 = np.float32(8388608.0)
    shifted = _rz32(ax.astype(np.float64) + 8388608.0)
    frac = ax - (shifted - k23)
    up = (np.float32(1.0) - frac) <= F32_EPS
    mag = (shifted.view(np.int32) - k23.view(np.int32)) + up.astype(np.int32)
    return np.where(x < 0, -mag, mag).astype(np.int32)


def snap_trunc_fast(x: np.ndarray) -> np.ndarray:
    """``snap_trunc_int`` as the kernel computes it now: x + copysign(1e-5f,
    x) rounded toward zero, truncated toward zero.  int32."""
    x = np.asarray(x, dtype=np.float32)
    eps = np.where(np.signbit(x), -F32_EPS, F32_EPS).astype(np.float64)
    return np.trunc(_rz32(x.astype(np.float64) + eps)).astype(np.int32)


def sparse_deltas_ref(words: np.ndarray, prev: np.ndarray,
                      seg_first: np.ndarray) -> np.ndarray:
    """The earlier ``sparse_deltas`` on (n, 4) uint32 words (8 int16 lanes,
    low half first) with each row's lane before the first (``prev``, the
    low 16 bits of it) and whether the row starts a segment: each lane x
    minus the one before, + 1024, where it differs from it (always at a
    segment's first lane, against 0), else 0, modulo 2^16."""
    w = words.astype(np.int64)
    lanes = np.stack([w & 0xFFFF, w >> 16], 2).reshape(len(w), 8)
    before = np.concatenate([np.where(seg_first, 0, prev & 0xFFFF)[:, None],
                             lanes[:, :-1]], 1)
    run = lanes != before
    run[:, 0] |= seg_first
    d = np.where(run, (lanes - before + 1024) & 0xFFFF, 0)
    return (d[:, 0::2] | (d[:, 1::2] << 16)).astype(np.uint32)


def sparse_deltas_fast(words: np.ndarray, prev: np.ndarray,
                       seg_first: np.ndarray) -> np.ndarray:
    """``sparse_deltas`` as the kernel computes it: per word w = x1:x0, the
    low 16 bits of w - prev + 1024 and x1 - w + 1024, kept where the low
    half of w ^ prev (x1 ^ w) is not zero; prev is then x1."""
    w = words.astype(np.uint32)
    p = np.where(seg_first, 0, prev & 0xFFFF).astype(np.uint32)
    out = np.zeros_like(w)
    for e in range(4):
        x1 = w[:, e] >> np.uint32(16)
        run0 = ((w[:, e] ^ p) & np.uint32(0xFFFF)) != 0
        if e == 0:
            run0 |= seg_first
        run1 = ((x1 ^ w[:, e]) & np.uint32(0xFFFF)) != 0
        d0 = np.where(run0, (w[:, e] - p + np.uint32(1024)) & np.uint32(0xFFFF), 0)
        d1 = np.where(run1, (x1 - w[:, e] + np.uint32(1024)) & np.uint32(0xFFFF), 0)
        out[:, e] = d0.astype(np.uint32) | (d1.astype(np.uint32) << np.uint32(16))
        p = x1
    return out


COLOUR_COEFS = {  # 1000·v = r·R + g·G + b·B + add (csrc CoefOf)
    "y": (299, 587, 114, 0),
    "cr": (439, -368, -71, 128000),
    "cb": (-148, -291, 439, 128000),
}


def _dp2a(coef: Tuple[int, int], word: np.ndarray, hi: bool,
          acc: np.ndarray) -> np.ndarray:
    """PTX dp2a.{lo,hi}.s32.u32: acc + coef[0]·byte(2h) + coef[1]·byte(2h + 1)
    of ``word`` (h = 1 for .hi)."""
    sh = 16 if hi else 0
    b0 = (word >> sh) & 0xFF
    b1 = (word >> (sh + 8)) & 0xFF
    return acc + coef[0] * b0 + coef[1] * b1


def quad_sums(words: np.ndarray, channel: str) -> np.ndarray:
    """(n, 4) int64 sums S = 1000·v of the four pixels of each quad of
    ``words`` ((n, 3) uint32: 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3
    B3) by the kernel's dp2a placements (``colour<K>``: pixel 0 at byte 0
    of w0, pixel 1 at byte 3 of w0, pixel 2 at byte 2 of w1, pixel 3 at
    byte 1 of w2)."""
    r, g, b, add = COLOUR_COEFS[channel]
    w = words.astype(np.int64)
    acc = np.full(len(w), add, dtype=np.int64)
    w0, w1, w2 = w[:, 0], w[:, 1], w[:, 2]
    s0 = _dp2a((r, g), w0, False, _dp2a((b, 0), w0, True, acc))
    s1 = _dp2a((0, r), w0, True, _dp2a((g, b), w1, False, acc))
    s2 = _dp2a((r, g), w1, True, _dp2a((b, 0), w2, False, acc))
    s3 = _dp2a((0, r), w2, False, _dp2a((g, b), w2, True, acc))
    return np.stack([s0, s1, s2, s3], 1)


def per_mille(s: np.ndarray) -> np.ndarray:
    """The kernel's floor(S / 1000): the high word of S · ceil(2^32 / 1000)
    (``per_mille`` without its 2^23 bits)."""
    return (np.asarray(s, dtype=np.int64) * 4294968) >> 32


# ---------------------------------------------------------------------------
# The runner of the two probes
# ---------------------------------------------------------------------------


def noise_batch(frames: int, h: int, w: int, seed: int,
                runs: bool = False) -> torch.Tensor:
    """(frames, h, w, 3) uniform uint8 noise from numpy's generator; with
    ``runs`` each even column repeats the odd one after it (the layout
    probes' "blocky content so runs exist")."""
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, size=(frames, h, w, 3), dtype=np.uint8)
    if runs:
        rgb[:, :, ::2] = rgb[:, :, 1::2]
    return torch.from_numpy(rgb)


def noise_kt(n_blocks: int, seed: int) -> torch.Tensor:
    """(3, 64, n_blocks) uniform uint8 noise in the KT layout, from numpy's
    generator (``probe_megakernel_v2.py:74``)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, size=(3, 64, n_blocks), dtype=np.uint8))


STAGE_A = "rgb_to_kt"
K1_STEP = "k1"
PLAIN_CHAIN = "plain_chain"


def split_chain_ref(rgb: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain chain of ``probe_megakernel.py``'s comparison (:188-197),
    from RGB: ``forward_combined_ref`` (colour, 4:2:2, the three basis
    products, the sparse epilogues), cut into the luma, Cr and Cb segments,
    with each block's run counts: ``kt_split_runs``'s function."""
    out = forward_combined_ref(rgb, LUM, CHR)
    segs, start = [], 0
    for width in SPLIT_WIDTHS:
        segs.append(out[:, start:start + width].contiguous())
        start += width
    return (*segs, *((w != 0).sum(dim=1, dtype=torch.int32) for w in segs))


def _step(name: str):
    """(fn, kernel, input) of a runner's row ``name``: a variant on its own
    input; "k1", ``forward_combined`` on RGB; "rgb_to_kt", stage A alone;
    "rgb_to_kt+<variant>", stage A then a KT variant, on RGB; or
    "plain_chain", ``split_chain_ref`` on RGB.  ``kernel`` is the wrapper
    whose ``launches`` each call adds one to (None for torch ops alone)."""
    if name == K1_STEP:
        return (functools.partial(forward_combined, lum_table=LUM,
                                  chr_table=CHR), forward_combined, "rgb")
    if name == STAGE_A:
        return rgb_to_kt, None, "rgb"
    if name == PLAIN_CHAIN:
        return split_chain_ref, None, "rgb"
    if name.startswith(STAGE_A + "+"):
        fn, kernel, _ = _step(name[len(STAGE_A) + 1:])
        return (lambda x: fn(rgb_to_kt(x))), kernel, "rgb"
    fn = functools.partial(megakernel_variant, name=name, lum_table=LUM,
                           chr_table=CHR)
    return fn, megakernel_variant, _variant(name).input


def step_bound(name: str, n_blocks: int) -> Tuple[float, str]:
    """(bound_ms, bound_by) of row ``name`` on ``n_blocks`` tiles: a
    variant's ``variant_bound``; K1's is the "full" variant's; stage A reads
    and writes the 192 input bytes of each tile; stage A then a variant is
    the sum of the two passes' bounds; the plain chain computes
    ``kt_split_runs``'s function from RGB, so its bound is that one's."""
    if name == K1_STEP:
        return variant_bound("full", n_blocks)
    if name == PLAIN_CHAIN:
        return variant_bound("kt_split_runs", n_blocks)
    stage_a = n_blocks * 2 * 192 / (HBM_PEAK_GBS * 1e9) * 1e3
    if name == STAGE_A:
        return stage_a, "bytes"
    if name.startswith(STAGE_A + "+"):
        ms, by = variant_bound(name[len(STAGE_A) + 1:], n_blocks)
        return stage_a + ms, by
    return variant_bound(name, n_blocks)


def _attributes(name: str, dev: torch.device) -> Dict[str, Optional[int]]:
    """The kernel's registers, shared memory and CTAs per SM of row
    ``name`` on a card (K1's are the "full" variant's: the same
    instantiation); None where the row runs no variant, or on the CPU."""
    variant = name.split("+")[-1]
    variant = "full" if variant == K1_STEP else variant
    if dev.type == "cuda" and variant in BY_NAME:
        return variant_attributes(variant, dev)
    return {"registers": None, "shared_bytes": None, "ctas_per_sm": None}


def run_rows(title: str, rows: Sequence[Tuple[str, str]],
             inputs: Dict[str, torch.Tensor], gates: Dict,
             dev: torch.device, baseline: Optional[str] = None,
             runs: int = 4, chain: int = 8, output: Optional[str] = None,
             seed: int = 0, **record) -> Dict:
    """Time the rows ((probe label, step name), see ``_step``) on
    ``inputs`` ({"rgb": batch, "kt": KT array}, the ones the rows read, on
    ``dev``, ``bench_device``'s result) after the caller's gates; returns
    the result and writes it to ``output`` if given.

    Per step: on CUDA the best of ``runs`` CUDA-event times of ``chain``
    calls (``ms``), and on any device the best of ``runs`` fenced chains of
    ``chain`` steps (``chain_ms``, ``bench/roofline.py::_chain_bench``:
    each step perturbs the input by the carry, runs the step and checksums
    its whole output with ``utils/profiling.py::device_checksum``); on CUDA
    each timed run must launch the step's kernel once per call (launch
    guard).  ``plain_ms``: the plain version of the baseline row's variant
    (``baseline``, a step name; default the first row's), one call.  A CPU
    run's times are host times of the plain versions, no device metric.
    ``record`` goes into the result as it is."""
    cuda = dev.type == "cuda"
    n_blocks = next(x.shape[-1] if k == "kt" else
                    x.shape[0] * (x.shape[1] // 8) * (x.shape[2] // 8)
                    for k, x in inputs.items())
    names = list(dict.fromkeys(name for _, name in rows))
    steps = {}
    for name in names:
        fn, kernel, kind = _step(name)
        x = inputs[kind]
        guard = kernel if cuda else None
        rec = {"ms": time_ms(fn, x, dev, chain, runs, guard) if cuda else None,
               "chain_ms": _chain_bench(_body(fn), x, chain, torch.int16,
                                        runs=runs, kernel=guard) * 1e3}
        rec.update(_attributes(name, dev))
        rec["bound_ms"], rec["bound_by"] = step_bound(name, n_blocks)
        steps[name] = rec
    base_name = baseline or rows[0][1]
    base_variant = base_name.split("+")[-1]
    plain_ms = None
    if cuda and base_variant in BY_NAME:
        plain = functools.partial(megakernel_variant_ref, name=base_variant,
                                  lum_table=LUM, chr_table=CHR)
        plain_ms = time_ms(plain, inputs[_variant(base_variant).input], dev, 1,
                           runs)

    key = "ms" if cuda else "chain_ms"
    base = steps[base_name][key]
    table, seen = [], {}
    for label, name in rows:
        rec = steps[name]
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
        **record,
        "n_blocks": n_blocks,
        "runs": runs,
        "chain": chain,
        "seed": seed,
        "backend": dev.type,
        **device_record(dev),
        "gates": gates,
        "baseline": next(label for label, name in rows if name == base_name),
        "plain_ms": plain_ms,
        "variants": steps,
        "rows": table,
    }
    if output:
        with open(output, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {output}")
    return result


def _run_device(device, side: int) -> torch.device:
    """The runners' device (``bench_device``), with TF32 off (fp32 is IEEE
    fp32) and ``side`` checked."""
    dev = bench_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if side % 16:
        raise ValueError(f"side {side} is not a multiple of 16")
    return dev


def run_variants(title: str, rows: Sequence[Tuple[str, str]], device="cuda",
                 frames: int = 32, side: int = 2048, runs: int = 4,
                 chain: int = 8, output: Optional[str] = None,
                 seed: int = 0) -> Dict:
    """Gate, then time the RGB variants of ``rows`` ((probe label, variant
    name), the first the baseline) on ``frames`` noise frames of side²
    (seed ``seed``) with ``run_rows``.

    Gates, on the device, at ``GATE_SHAPE``: each variant against its plain
    version by ``variant_flips`` (every difference a one-step flip at a
    truncation tie), and the variants of ``SAME_AS_K1`` identical to
    ``forward_combined``."""
    dev = _run_device(device, side)
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
    return run_rows(title, rows, {"rgb": x}, gates, dev, runs=runs,
                    chain=chain, output=output, seed=seed, frames=frames,
                    side=side)


def gate_kt(title: str, names: Sequence[str], kt: torch.Tensor,
            rgb: Optional[torch.Tensor] = None) -> Dict:
    """The layout runners' gate: each KT variant of ``names`` on ``kt``
    against its plain version by ``variant_flips``; where ``rgb`` is given
    (``kt`` = ``rgb_to_kt(rgb)``), the rows of ``KT_SAME_AS_K1`` identical
    to ``forward_combined(rgb)`` and whether every other product row came
    out identical to it too.  Raises on any failure; returns {"flips":
    {name: flips}, "identical_to_k1": {name: bool}}."""
    k1 = forward_combined(rgb, LUM, CHR) if rgb is not None else None
    flips, same = {}, {}
    for name in names:
        got = megakernel_variant(kt, name, LUM, CHR)
        flips[name] = variant_flips(kt, got,
                                    megakernel_variant_ref(kt, name, LUM, CHR),
                                    name, LUM, CHR)
        if flips[name] > max(1, flip_limit(name) * combined(got).numel()):
            raise AssertionError(f"{name}: {flips[name]} flips")
        if k1 is not None and _variant(name).deltas:
            same[name] = torch.equal(combined(got), k1)
            if name in KT_SAME_AS_K1 and not same[name]:
                raise AssertionError(f"{name} differs from forward_combined")
    print(f"{title}: gates on {kt.shape[-1]} blocks: every variant held to "
          f"its plain version (flips {flips})"
          + (f"; identical to forward_combined {same}" if same else ""),
          flush=True)
    return {"flips": flips, "identical_to_k1": same}


def run_layout(title: str, rows: Sequence[Tuple[str, str]],
               gate_names: Sequence[str], device="cuda", frames: int = 32,
               side: int = 2048, runs: int = 4, chain: int = 8,
               output: Optional[str] = None, seed: int = 0,
               baseline: Optional[str] = None, random_kt: bool = False,
               small_case: Optional[Tuple[Tuple[int, int, int],
                                          Sequence[str]]] = None) -> Dict:
    """The run of a layout probe (``profiles/megakernel_kt.py``,
    ``megakernel_t.py``, ``megakernel_v2.py``): ``gate_kt`` of
    ``gate_names`` at ``GATE_SHAPE``, then ``run_rows`` of ``rows`` on
    ``frames`` frames of side² (seed ``seed``), ``baseline`` as there.
    The frames are noise whose even columns repeat the odd ones
    (``noise_batch(runs=True)``), fed as RGB and as their ``rgb_to_kt``;
    with ``random_kt``, random KT blocks, as many as the frames hold.
    ``small_case`` ((frames, H, W), names) adds a gate of those names on
    ``rgb_to_kt`` of noise frames of that shape (``gates["small_case"]``)."""
    dev = _run_device(device, side)
    frames_g, h, w = GATE_SHAPE
    if random_kt:
        small = noise_kt(frames_g * (h // 8) * (w // 8), seed + 1).to(dev)
        gates = gate_kt(title, gate_names, small)
    else:
        small = noise_batch(*GATE_SHAPE, seed=seed + 1, runs=True).to(dev)
        gates = gate_kt(title, gate_names, rgb_to_kt(small), small)
    if small_case is not None:
        shape, names = small_case
        rgb = noise_batch(*shape, seed=seed + 2).to(dev)
        gates["small_case"] = gate_kt(title, names, rgb_to_kt(rgb), rgb)
    if random_kt:
        inputs = {"kt": noise_kt(frames * (side // 8) ** 2, seed).to(dev)}
    else:
        x = noise_batch(frames, side, side, seed, runs=True).to(dev)
        inputs = {"rgb": x, "kt": rgb_to_kt(x)}
    return run_rows(title, rows, inputs, gates, dev, baseline=baseline,
                    runs=runs, chain=chain, output=output, seed=seed,
                    frames=frames, side=side)


def main_of(run, prog: str, description: str, argv=None) -> int:
    """The command line of the runners (``profiles/megakernel_ablate.py``,
    ``megakernel_dma.py``, ``megakernel_kt.py``, ``megakernel_t.py``,
    ``megakernel_v2.py``): ``run(device, frames, side, runs, chain,
    output, seed)``."""
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
