"""LZ4's greedy parses: K10 (the LZ4T segment parse) and K11 (parity mode's
match tables fused with their parse).

Both replace XLA stages of the JAX package that have no Pallas kernel, a
``lax.scan`` over positions each:

* ``parse_candidates`` — the post-pass of
  ``lz4jpeg_tpu/ops/pallas_match.py:217 fast_match_blocks_pallas``
  (:285-338: unpacking, the ``max_dist``, segment-end and block-end caps,
  the ≥ 4 re-check, the greedy walk on the anchor grid at :320, the
  expansion to the byte grid) on K2's packed candidates;
* ``greedy_parse`` — the sort matcher's segment walk
  (``lz4jpeg_tpu/ops/lz4_fast.py:223``) on capped lengths;
* ``parity_parse`` — ``greedy_parse(*match_tables(blocks, max_match))`` of
  ``lz4jpeg_tpu/ops/match.py:56`` and :93 (the vmapped scan at :121).

On a CUDA tensor each wrapper launches ``csrc/lz4_parse_kernel.cu`` once
and adds one to its ``launches``; on a CPU tensor it runs its plain
version (``*_ref``: the torch loops the port ran before).  There is no
fallback between the two: a CUDA call launches the kernel or raises.

The kernels' plans are mirrored in numpy: ``segment_plan`` and
``emulate_parse_candidates``/``emulate_greedy_parse`` (K10's units, tiles,
padded slots and walkers), ``emulate_parity`` (K11's tiles of positions,
warps of 32 distances, packed keys ``parity_key``, the warp maximum and the
per-position maximum, the four-byte walk).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.match import greedy_parse as parity_greedy_ref
from lz4jpeg_tpu_torch.ops.match import match_tables

# Mirrors of csrc/lz4_parse_kernel.cu's constants (held to the source by
# tests/test_torch_lz4_parse.py).
PARSE_THREADS = 128    # kParseThreads
TILE_ANCHORS = 2048    # kTileAnchors
PARITY_THREADS = 512   # kParityThreads
TILE_K = 8192          # kTileK
MAX_POSITIONS = 1 << 16  # kMaxPositions: run and distance fit 16 bits each
KEY_SHIFT = 16

_MAX_GRID = (1 << 31) - 1


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/lz4_parse_kernel.cu`` (at first use), load and bind it."""
    lib = load_cuda_library("lz4_parse_kernel")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.segment_parse_candidates_launch.restype = i32
    lib.segment_parse_candidates_launch.argtypes = [
        vp, vp, vp, vp, vp, i64, i64, i32, i64, i32, i32, i64, vp]
    lib.segment_parse_fields_launch.restype = i32
    lib.segment_parse_fields_launch.argtypes = [
        vp, vp, vp, vp, vp, i64, i32, i32, i32, vp]
    lib.segment_parse_units.restype = i64
    lib.segment_parse_units.argtypes = [i64, i32]
    lib.parity_parse_launch.restype = i32
    lib.parity_parse_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, vp]
    lib.parity_parse_carry_words.restype = i64
    lib.parity_parse_carry_words.argtypes = [i32]
    lib.lz4_parse_error_string.restype = ctypes.c_char_p
    lib.lz4_parse_error_string.argtypes = [i32]
    return lib


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lz4_parse_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_or_cpu(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


# ---------------------------------------------------------------------------
# K10: the segment parse
# ---------------------------------------------------------------------------


def greedy_parse_ref(match_len, match_dist, seg: int, stride: int = 1):
    """Plain version: ``seg`` lockstep steps over every (row, segment) at
    once.  A taken match of L bytes frees the next start ``ceil(L /
    stride)`` slots ahead.  Returns ``(is_match, emit_len, emit_dist)``
    int32 in the input's shape."""
    shape = match_len.shape
    if shape[-1] % seg:
        raise ValueError(f"rows of {shape[-1]} do not split into {seg}-segments")
    nseg = match_len.numel() // seg
    seg_len = match_len.reshape(nseg, seg)
    seg_dist = match_dist.reshape(nseg, seg)
    skip = torch.zeros(nseg, dtype=torch.int32, device=match_len.device)
    is_match = torch.zeros((nseg, seg), dtype=torch.int32, device=match_len.device)
    for k in range(seg):
        ml = seg_len[:, k]
        is_m = (skip <= k) & (ml > 0)
        consumed = (ml + stride - 1) // stride
        skip = torch.where(is_m, k + consumed, skip)
        is_match[:, k] = is_m
    taken = is_match > 0
    return (
        is_match.reshape(shape),
        torch.where(taken, seg_len, 0).to(torch.int32).reshape(shape),
        torch.where(taken, seg_dist, 0).to(torch.int32).reshape(shape),
    )


def greedy_parse(match_len, match_dist, seg: int, stride: int = 1):
    """Segment-anchored greedy parse (K10's field entry): capped lengths and
    distances, int32 or int64 of one dtype and shape, rows a multiple of
    ``seg`` → ``(is_match, emit_len, emit_dist)`` int32 in that shape.

    A CPU tensor runs ``greedy_parse_ref``.  A CUDA tensor launches K10 on
    the current stream and adds one to ``greedy_parse.launches``."""
    if not _cuda_or_cpu(match_len):
        return greedy_parse_ref(match_len, match_dist, seg, stride)
    if (match_len.shape != match_dist.shape
            or match_len.dtype != match_dist.dtype
            or match_len.dtype not in (torch.int32, torch.int64)
            or match_dist.device != match_len.device):
        raise TypeError("match_len and match_dist must be int32 or int64 "
                        "tensors of one dtype, shape and device")
    if not 1 <= seg < 1 << 31 or not 1 <= stride <= 1 << 30:
        raise ValueError(f"seg {seg} or stride {stride} out of range")
    shape = match_len.shape
    if match_len.dim() == 0 or shape[-1] % seg:
        raise ValueError(f"rows of {shape[-1] if shape else 0} do not split "
                         f"into {seg}-segments")
    outs = [torch.empty(shape, dtype=torch.int32, device=match_len.device)
            for _ in range(3)]
    n = match_len.numel()
    if n == 0:
        return tuple(outs)
    ml, md = match_len.contiguous(), match_dist.contiguous()
    lib = load_kernel()
    with torch.cuda.device(match_len.device):
        rc = lib.segment_parse_fields_launch(
            ml.data_ptr(), md.data_ptr(), *(o.data_ptr() for o in outs), n,
            seg, stride, ml.element_size(), _stream(ml))
    _raise_on(lib, rc, "segment_parse_fields")
    greedy_parse.launches += 1
    return tuple(outs)


greedy_parse.launches = 0


def parse_candidates_ref(packed, lengths, p: int, max_dist: int = 65535,
                         stride: int = 1, seg: int = 512):
    """Plain version of the Pallas wrapper's post-pass
    (``pallas_match.py:285-338``): (B, Pa) packed candidates → distance,
    segment and block-end caps → greedy parse on the anchor grid → (B, P)
    byte-grid ``(is_match, emit_len, emit_dist)`` int32."""
    b, pa = packed.shape
    pos_bits = (pa - 1).bit_length()
    packed = packed.to(torch.int64)
    match_len = packed >> pos_bits
    match_dist = (packed & ((1 << pos_bits) - 1)) * stride  # bytes
    match_dist = torch.where(match_dist <= max_dist, match_dist, 0)
    match_len = torch.where(match_dist > 0, match_len, 0)

    # Segment/block-end caps on the byte grid (anchors at byte a·stride).
    byte_pos = torch.arange(pa, dtype=torch.int64, device=packed.device) * stride
    seg_left = seg - (byte_pos & (seg - 1))
    limit = torch.minimum(lengths.to(torch.int64)[:, None] - byte_pos[None, :],
                          seg_left[None, :])
    match_len = torch.minimum(match_len, limit.clamp(min=0))
    match_len = torch.where(match_len >= 4, match_len, 0)
    match_dist = torch.where(match_len > 0, match_dist, 0)

    # Greedy parse over the anchor grid: seg/stride lockstep steps; a match
    # of L bytes frees the next anchor ceil(L/stride) steps ahead.
    fields = greedy_parse_ref(match_len, match_dist, seg // stride, stride)
    if stride == 1:
        return fields
    # Expand anchor-grid fields to the byte grid (zeros between anchors).
    out = []
    for v in fields:
        wide = torch.zeros((b, pa, stride), dtype=v.dtype, device=v.device)
        wide[:, :, 0] = v
        out.append(wide.reshape(b, p))
    return tuple(out)


def parse_candidates(packed, lengths, p: int, max_dist: int = 65535,
                     stride: int = 1, seg: int = 512):
    """K2's (B, Pa) int32 packed candidates + (B,) lengths → (B, Pa ·
    stride) byte-grid ``(is_match, emit_len, emit_dist)`` int32 (K10's
    candidate entry: caps, walk and expansion in one launch).

    A CPU tensor runs ``parse_candidates_ref``.  A CUDA tensor launches K10
    on the current stream and adds one to ``parse_candidates.launches``."""
    if not _cuda_or_cpu(packed):
        return parse_candidates_ref(packed, lengths, p, max_dist, stride, seg)
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise TypeError(f"expected (B, Pa) int32 candidates, got "
                        f"{packed.dtype} {tuple(packed.shape)}")
    b, pa = packed.shape
    if lengths.shape != (b,):
        raise TypeError(f"expected ({b},) lengths, got {tuple(lengths.shape)}")
    if stride < 1 or seg < 1 or seg // stride < 1 or seg >= 1 << 30:
        raise ValueError(f"seg {seg} and stride {stride} give no segment")
    seg_a = seg // stride
    if pa % seg_a:
        raise ValueError(f"rows of {pa} do not split into {seg_a}-segments")
    if stride > 1 and p != pa * stride:
        raise ValueError(f"{pa} anchors at stride {stride} are not {p} bytes")
    if pa * stride >= 1 << 30:
        raise ValueError(f"rows of {pa * stride} bytes exceed the kernel's")
    outs = [torch.empty((b, pa * stride), dtype=torch.int32, device=packed.device)
            for _ in range(3)]
    if b == 0 or pa == 0:
        return tuple(outs)
    x = packed.contiguous()
    lens = lengths.to(device=packed.device, dtype=torch.int32).contiguous()
    max_dist = max(min(int(max_dist), 1 << 62), -1)
    lib = load_kernel()
    with torch.cuda.device(packed.device):
        rc = lib.segment_parse_candidates_launch(
            x.data_ptr(), lens.data_ptr(), *(o.data_ptr() for o in outs), b,
            pa, stride, seg, seg_a, (pa - 1).bit_length(), max_dist,
            _stream(x))
    _raise_on(lib, rc, "segment_parse_candidates")
    parse_candidates.launches += 1
    return tuple(outs)


parse_candidates.launches = 0


def segment_plan(n_anchors: int, seg_a: int, tile: int = TILE_ANCHORS):
    """K10's work map: one entry a CTA, ``(unit_base, unit_end, long_seg)``.
    A unit holds whole segments up to ``tile`` anchors, or one segment
    longer than a tile (``long_seg``: walked in tiles of ``tile`` by one
    thread carrying its pointer)."""
    if seg_a > tile:
        return [(u * seg_a, (u + 1) * seg_a, True)
                for u in range(n_anchors // seg_a)]
    tile_n = (tile // seg_a) * seg_a
    return [(u, min(n_anchors, u + tile_n), False)
            for u in range(0, n_anchors, tile_n)]


def slot_of(i: np.ndarray, seg_a: int, long_seg: bool) -> np.ndarray:
    """Shared-memory slots of tile anchors ``i``: each segment's row at the
    odd pitch ``seg_a | 1`` (a long segment fills the tile in order)."""
    if long_seg:
        return i
    s = i // seg_a
    return s * (seg_a | 1) + (i - s * seg_a)


def _emulate_walk(lens, n, seg_a, long_seg, k0, skip, stride):
    """The walkers of one tile on the slot array ``lens`` (in place):
    ``skip`` holds each walker's pointer; returns it."""
    dt = lens.dtype.type
    if long_seg:
        walkers = np.zeros(1, np.int64)
        steps = n
    else:
        walkers = np.arange(n // seg_a) * (seg_a | 1)
        steps = seg_a
        skip = np.zeros(len(walkers), lens.dtype)
    with np.errstate(over="ignore"):
        for j in range(steps):
            ml = lens[walkers + j]
            k = dt(k0 + j)
            # The kernel's step: a reached empty slot moves the pointer to k.
            nxt = np.where(ml > 0, k + (ml + dt(stride - 1)) // dt(stride), k)
            reach = skip <= k
            lens[(walkers + j)[~reach & (ml > 0)]] = 0
            skip = np.where(reach, nxt, skip).astype(lens.dtype)
    return skip


def _emulate_segments(n_anchors, seg_a, stride, dtype, load, store,
                      tile=TILE_ANCHORS):
    """Runs ``segment_plan``: per unit and tile, ``load(base, n, slots)``
    fills the slot arrays, the walkers run, ``store(base, n, slots)``
    writes."""
    for base0, end, long_seg in segment_plan(n_anchors, seg_a, tile):
        skip = np.zeros(1, dtype)
        for base in range(base0, end, tile):
            n = min(tile if long_seg else (tile // seg_a) * seg_a, end - base)
            slots = slot_of(np.arange(n), seg_a, long_seg)
            lens = np.zeros(tile + tile // 2, dtype)
            load(base, n, slots, lens)
            skip = _emulate_walk(lens, n, seg_a, long_seg, base - base0,
                                 skip, stride)
            store(base, n, slots, lens)


def emulate_greedy_parse(match_len, match_dist, seg: int, stride: int = 1,
                         tile: int = TILE_ANCHORS):
    """Numpy mirror of K10's field entry (``greedy_parse`` on the card)."""
    ml = np.ascontiguousarray(match_len).reshape(-1)
    md = np.ascontiguousarray(match_dist).reshape(-1)
    outs = [np.zeros(ml.shape, np.int32) for _ in range(3)]

    def load(base, n, slots, lens):
        lens[slots] = ml[base : base + n]

    def store(base, n, slots, lens):
        taken = lens[slots] > 0
        outs[0][base : base + n] = taken
        outs[1][base : base + n] = np.where(taken, lens[slots], 0).astype(np.int32)
        outs[2][base : base + n] = np.where(taken, md[base : base + n], 0).astype(
            np.int32)

    _emulate_segments(ml.size, seg, stride, ml.dtype, load, store, tile)
    return tuple(o.reshape(np.shape(match_len)) for o in outs)


def emulate_parse_candidates(packed, lengths, p: int, max_dist: int = 65535,
                             stride: int = 1, seg: int = 512,
                             tile: int = TILE_ANCHORS):
    """Numpy mirror of K10's candidate entry (``parse_candidates`` on the
    card): the load step's caps, the walk and the byte-grid store."""
    packed = np.ascontiguousarray(packed, np.int32)
    b, pa = packed.shape
    pos_bits = (pa - 1).bit_length()
    flat = packed.reshape(-1)
    lens_row = np.asarray(lengths, np.int64)
    seg_a = seg // stride
    outs = [np.zeros(b * pa * stride, np.int32) for _ in range(3)]
    dist_slots = np.zeros(tile + tile // 2, np.int64)

    def load(base, n, slots, lens):
        f = base + np.arange(n)
        row, a = f // pa, f % pa
        v = flat[f].astype(np.int64)
        ln = v >> pos_bits
        dist = (v & ((1 << pos_bits) - 1)) * stride
        dist = np.where(dist > max_dist, 0, dist)
        ln = np.where(dist <= 0, 0, ln)
        bp = a * stride
        limit = np.minimum(lens_row[row] - bp, seg - (bp & (seg - 1)))
        ln = np.minimum(ln, np.maximum(limit, 0))
        ln = np.where(ln < 4, 0, ln)
        lens[slots] = ln
        dist_slots[slots] = np.where(ln > 0, dist, 0)

    def store(base, n, slots, lens):
        e = (base + np.arange(n)) * stride
        taken = lens[slots] > 0
        outs[0][e] = taken
        outs[1][e] = np.where(taken, lens[slots], 0)
        outs[2][e] = np.where(taken, dist_slots[slots], 0)

    _emulate_segments(b * pa, seg_a, stride, np.int32, load, store, tile)
    return tuple(o.reshape(b, pa * stride) for o in outs)


# ---------------------------------------------------------------------------
# K11: parity mode's match tables and parse
# ---------------------------------------------------------------------------


def parity_key(run: int, d: int) -> int:
    """K11's key of a clamped run at distance d: the larger run wins, ties
    go to the larger d; 0 below the 4-byte minimum."""
    return (run << KEY_SHIFT) | d if run >= 4 else 0


def clamp_max_match(max_match: int) -> int:
    """The kernel's max_match: runs are below 2^16 (P ≤ 65,536) and a value
    under 4 finds nothing, so [0, 65535] gives every result."""
    return max(0, min(int(max_match), (1 << KEY_SHIFT) - 1))


def parity_tables_ref(blocks: torch.Tensor, max_match: int = 1024):
    """Plain version: ``(best_len, best_dist, is_match, emit_len,
    emit_dist)`` of ``ops/match.py``'s torch ops."""
    best_len, best_dist = match_tables(blocks, max_match=max_match)
    return (best_len, best_dist, *parity_greedy_ref(best_len, best_dist))


def parity_parse_ref(blocks: torch.Tensor, max_match: int = 1024):
    """Plain version: ``greedy_parse(*match_tables(blocks, max_match))``."""
    return parity_tables_ref(blocks, max_match)[2:]


def _parity_launch(blocks: torch.Tensor, max_match: int):
    if blocks.dtype != torch.int32 or blocks.dim() != 2:
        raise TypeError(f"blocks must be (B, P) int32, not {blocks.dtype} "
                        f"{tuple(blocks.shape)}")
    b, p = blocks.shape
    if p > MAX_POSITIONS:
        raise ValueError(f"blocks of {p} positions exceed the kernel's "
                         f"{MAX_POSITIONS} (16-bit block sizes)")
    if b > _MAX_GRID:
        raise ValueError(f"{b} blocks exceed one grid")
    dev = blocks.device
    best_len, best_dist, emit_len, emit_dist = (
        torch.empty((b, p), dtype=torch.int32, device=dev) for _ in range(4))
    is_match = torch.empty((b, p), dtype=torch.bool, device=dev)
    outs = (best_len, best_dist, is_match, emit_len, emit_dist)
    if b == 0 or p == 0:
        return outs
    x = blocks.contiguous()
    lib = load_kernel()
    words = lib.parity_parse_carry_words(p)
    carry = torch.empty(b * words, dtype=torch.int32, device=dev) if words else None
    with torch.cuda.device(dev):
        rc = lib.parity_parse_launch(
            x.data_ptr(), *(o.data_ptr() for o in outs),
            carry.data_ptr() if carry is not None else None, b, p,
            clamp_max_match(max_match), _stream(x))
    _raise_on(lib, rc, "parity_parse")
    parity_parse.launches += 1
    return outs


def parity_tables(blocks: torch.Tensor, max_match: int = 1024):
    """K11 with its tables: ``(best_len, best_dist, is_match, emit_len,
    emit_dist)``, equal to ``match_tables`` and ``greedy_parse`` of
    ``ops/match.py``.  A CPU tensor runs ``parity_tables_ref``; a CUDA
    tensor launches K11 (counted in ``parity_parse.launches``)."""
    if not _cuda_or_cpu(blocks):
        return parity_tables_ref(blocks, max_match)
    return _parity_launch(blocks, max_match)


def parity_parse(blocks: torch.Tensor, max_match: int = 1024):
    """(B, P) int32 padded blocks → ``(is_match bool, emit_len int32,
    emit_dist int32)``, equal to ``greedy_parse(*match_tables(blocks,
    max_match))``.

    A CPU tensor runs ``parity_parse_ref``.  A CUDA tensor launches K11 on
    the current stream and adds one to ``parity_parse.launches``."""
    if not _cuda_or_cpu(blocks):
        return parity_parse_ref(blocks, max_match)
    return _parity_launch(blocks, max_match)[2:]


parity_parse.launches = 0


def emulate_parity(blocks, max_match: int = 1024, tile: int = TILE_K):
    """Numpy mirror of K11: tiles of ``tile`` positions from the last to
    the first, each d's clamped run carried across tiles; in a tile, the
    warps of 32 distances whose first d ≤ k raise the position's key by
    their warp maximum of ``parity_key``; then best_len & 0xFF walked four
    bytes at a time.  Returns ``parity_tables``'s five arrays."""
    x = np.asarray(blocks, np.int32)
    b, p = x.shape
    mm = clamp_max_match(max_match)
    keys = np.zeros((b, p), np.int64)
    n_tiles = -(-p // tile) if p else 0
    d_all = np.arange(32 * (-(-p // 32)) + 32, dtype=np.int64)
    carry = np.zeros((b, d_all.size), np.int64)
    for t in reversed(range(n_tiles)):
        k0, k1 = t * tile, min(p, (t + 1) * tile)
        groups = (k1 - 1) // 32 + 1
        d = d_all[: 32 * groups]
        r = carry[:, : d.size].copy() if t < n_tiles - 1 else np.zeros(
            (b, d.size), np.int64)
        for k in range(k1 - 1, k0 - 1, -1):
            live = d // 32 * 32 <= k  # the warps still in their loop
            j = k - d
            ok = (d >= 1) & (j >= 0)
            eq = ok[None, :] & (x[:, np.clip(j, 0, p - 1)] == x[:, k : k + 1])
            r = np.where(live[None, :], np.where(eq, np.minimum(r + 1, mm), 0), r)
            key = np.where(live[None, :] & (r >= 4), (r << KEY_SHIFT) | d, 0)
            warp_max = key.reshape(b, groups, 32).max(axis=2)
            keys[:, k] = np.maximum(keys[:, k], warp_max.max(axis=1))
        carry[:, : d.size] = r
    best_len = (keys >> KEY_SHIFT).astype(np.int32)
    best_dist = (keys & 0xFFFF).astype(np.int32)
    lens8 = (best_len & 0xFF).astype(np.uint8)
    p4 = -(-p // 4) * 4
    for row in range(b):
        words = np.zeros(p4, np.uint8)
        words[:p] = lens8[row]
        skip = 0
        for w in range(p4 // 4):
            for byte in range(4):
                k = 4 * w + byte
                ln = int(words[k])
                reach = skip <= k
                if not reach and ln:
                    words[k] = 0
                skip = k + ln if reach else skip
        lens8[row] = words[:p]
    taken = lens8 > 0
    return (best_len, best_dist, taken, lens8.astype(np.int32),
            np.where(taken, best_dist, 0).astype(np.int32))
