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
    rgb_to_kt,
    split_basis,
)
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16, rle_encode_sparse16
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


def variant_bound(name: str, n_blocks: int) -> Tuple[float, str]:
    """(bound_ms, bound_by) of variant ``name`` on ``n_blocks`` tiles: the
    larger of its bytes (the input bytes of each tile it needs read once,
    its lanes written once) over 3.35 TB/s and its bf16 tensor work
    (``parts`` passes of the 64-deep luma and two 32-deep chroma products)
    over 989 TFLOP/s, as ``chip_smoke.py::bound``.  A tile's input is its
    192 bytes, but 128 for a KT copy: R[0:64], G[0:32] and B[0:32] lie
    apart in the KT layout, where RGB interleaves the channels.  The split
    stage writes three int32 run counts per tile more."""
    v = _variant(name)
    itemsize = 1 if v.dtype == torch.uint8 else 2
    read = 128 if v.input == "kt" and not v.product else 192
    n_bytes = n_blocks * (read + v.lanes * itemsize
                          + (12 if v.stage == "split" else 0))
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
