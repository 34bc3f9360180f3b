"""The packed16 run-length decode by interval membership, as a hand-written
kernel, and its A/B against K6 and K8.

Port of ``profiles/pallas_rle_decode.py``, the TPU candidate that built
each row's disjoint-interval membership in fast memory and reduced it there
instead of materialising the (N, L, L) membership for an einsum
(``ops/rle.py::rle_decode_packed16`` of the JAX package).

``rle_decode_membership(packed, lengths, out_size)`` takes (N, L) packed16
words ``(count - 1) << 10 | (value + 512)`` (int16 holding the uint16 bits,
or uint16), as the port's ``ops/rle.py::rle_encode_packed16`` returns them,
and (N,) symbol lengths, and returns (N, out_size) int32: slots at or past
``lengths // 2`` count 0, run k covers [begin_k, end_k) by a prefix sum of
the counts, and position q takes the value of the run that covers it, else
0.  Its plain version is the port's plain packed16 decode,
``ops/pack16.py::pack16_decode_ref``.  A CPU tensor runs it; a CUDA tensor
launches ``csrc/rle_membership_kernel.cu`` or raises.

The gate, on both devices: L is 32 or 64 (the codec's chroma and luma
segments) and 1 ≤ out_size ≤ L; anything else raises ``ValueError``.  Any N
is taken: the Pallas wrapper's padding of N to 256 rows was a TPU detail.

``run_rle_decode_ab`` asks the probe's question on Hopper: the probe's check
on 1,024 structured rows, then the membership kernel timed against K6
(``pack16_decode``), K8 (``pack16_decode_wide``, int16 out) and the plain
version on the luma words of 64 noise frames of 2048² (4,194,304 × 64), and
the verdict from this run's times.  Run on the card from the repository
root (on the CPU add ``--device cpu --frames 1 --side 64``)::

    python -m lz4jpeg_tpu_torch.profiles.rle_decode --output rle_decode.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops import pack16
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch, _packed
from lz4jpeg_tpu_torch.profiles import timing

SEGMENTS = (32, 64)
# Lane instructions per (output position, valid run) pair at the least: the
# offset from the run's middle, a compare with its count and a masked add,
# each on two pairs at once as packed halves: 3 instructions for 2 pairs.
MEMBERSHIP_INSTRUCTIONS = 1.5
# The kernel's thread map and table (csrc/rle_membership_kernel.cu's k*
# constants): a lane holds POSITIONS slots and output positions, so a row
# takes L / POSITIONS lanes; the reduction steps UNROLL table entries, two
# a load.
POSITIONS = 4
UNROLL = 4
WARPS = 8


def _check_gate(seg: int, out_size: int) -> None:
    if seg not in SEGMENTS or not 1 <= out_size <= seg:
        raise ValueError(
            f"membership decode takes L in {SEGMENTS} and 1 <= out_size <= L, "
            f"got L={seg}, out_size={out_size}")


def rle_decode_membership_ref(packed: torch.Tensor, lengths: torch.Tensor,
                              out_size: int) -> torch.Tensor:
    """Plain version: ``pack16_decode_ref`` behind the same gate."""
    packed, lengths = _packed(packed, lengths)
    _check_gate(packed.shape[1], out_size)
    return pack16.pack16_decode_ref(packed, lengths, out_size)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/rle_membership_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("rle_membership_kernel")
    lib.rle_membership_launch.restype = ctypes.c_int
    lib.rle_membership_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    timing.bind_attributes(lib, "rle_membership_attributes")
    lib.rle_membership_error_string.restype = ctypes.c_char_p
    lib.rle_membership_error_string.argtypes = [ctypes.c_int]
    return lib


def rle_decode_membership(packed: torch.Tensor, lengths: torch.Tensor,
                          out_size: int) -> torch.Tensor:
    """(N, L) packed16 words + (N,) lengths → (N, out_size) int32 values; L
    32 or 64, 1 ≤ out_size ≤ L.

    A CPU tensor runs ``rle_decode_membership_ref``.  A CUDA tensor launches
    the membership kernel on the current stream and adds one to
    ``rle_decode_membership.launches``."""
    packed, lengths = _packed(packed, lengths)
    n, seg = packed.shape
    _check_gate(seg, out_size)
    dev = _check_device(packed, lengths)
    if dev.type == "cpu":
        return pack16.pack16_decode_ref(packed, lengths, out_size)
    if packed.data_ptr() % (seg // 16):  # one 4-byte word a lane at L = 64
        packed = packed.clone()
    out = torch.empty((n, out_size), dtype=torch.int32, device=dev)
    if n:
        _launch(load_kernel(), "rle_membership_launch",
                "rle_membership_error_string", dev, packed.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), n, seg, out_size)
        rle_decode_membership.launches += 1
    return out


rle_decode_membership.launches = 0


def membership_thread_map(seg: int):
    """The kernel's lane map: for each of a warp's 32 lanes, the row of the
    warp it works on (``sub``) and its slots and output positions
    (``4h .. 4h + 3``, h its lane within the row); returns (rows a warp,
    sub (32,), positions (32, POSITIONS))."""
    lanes = seg // POSITIONS
    lane = np.arange(32)
    h = lane % lanes
    return 32 // lanes, lane // lanes, \
        POSITIONS * h[:, None] + np.arange(POSITIONS)[None, :]


def emulate_membership(words: np.ndarray, lengths: np.ndarray,
                       out_size: int) -> np.ndarray:
    """The kernel's decode in numpy: rows taken a warp's row group at a
    time through ``membership_thread_map``, each row's float16 table
    {lo + hi, hi - lo, value} of the runs cut to [0, L] (two entries a
    16-byte load, so ``UNROLL`` is even), padded with empty
    intervals to L, every lane's positions tested against the warp's
    largest valid count rounded up to ``UNROLL`` entries by
    |2q + 1 - (lo + hi)| < hi - lo and summed as value · the test, in
    float16; (N, L) words (int16 or uint16 bits), (N,) lengths → (N,
    out_size) int32."""
    n, seg = words.shape
    _check_gate(seg, out_size)
    rows, sub, positions = membership_thread_map(seg)
    groups = -(-n // rows)
    w = np.zeros((groups * rows, seg), dtype=np.int64)
    w[:n] = words.astype(np.int64) & 0xFFFF
    npairs = np.zeros(groups * rows, dtype=np.int64)
    npairs[:n] = np.floor_divide(lengths.astype(np.int64), 2)
    slot = np.arange(seg)
    count = np.where(slot[None, :] < npairs[:, None], (w >> 10) + 1, 0)
    value = (w & 0x3FF) - 512
    end = np.cumsum(count, axis=1)
    lo, hi = np.minimum(end - count, seg), np.minimum(end, seg)
    table = np.stack([lo + hi, hi - lo, value], -1)
    assert np.abs(table).max() <= 2048  # integers exact in float16
    table = table.astype(np.float16)
    valid = np.clip(npairs, 0, seg).reshape(groups, rows)
    entries = -(-valid.max(axis=1) // UNROLL) * UNROLL  # a warp's trip
    assert (entries <= seg).all() and UNROLL % 2 == 0  # inside the table
    out = np.zeros((groups * rows, seg), dtype=np.float16)
    at = (2 * positions + 1).astype(np.float16)  # (32, POSITIONS)
    for g in range(groups):
        t = table[g * rows + sub][:, :entries[g]]  # (32, entries, 3)
        hit = np.abs(at[:, :, None] - t[:, None, :, 0]) < t[:, None, :, 1]
        acc = np.zeros(at.shape, dtype=np.float16)
        for e in range(entries[g]):  # in the kernel's order, in float16
            acc = acc + hit[:, :, e].astype(np.float16) * t[:, None, e, 2]
        out[g * rows + sub[:, None], positions] = acc
    return out[:n, :out_size].astype(np.int32)


def membership_attributes(seg: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of the L-slot kernel."""
    return timing.attributes(load_kernel, "rle_membership_attributes",
                             "rle_membership_error_string", seg,
                             torch.device(device))


def membership_pairs(lengths: torch.Tensor, seg: int, out_size: int) -> int:
    """The (output position, valid run) pairs the kernel reduces over on
    these lengths: min(L, lengths // 2) runs a row, out_size positions."""
    runs = torch.clamp(torch.div(lengths.to(torch.int64), 2,
                                 rounding_mode="floor"), 0, seg)
    return int(runs.sum()) * out_size


def structured_symbols(n: int = 1024, k: int = 64, seed: int = 0) -> np.ndarray:
    """The probe's check data (``pallas_rle_decode.py:86-89``): runs of
    zeros and small values, like zigzag streams."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 40, (n, k))
            * (rng.random((n, k)) < 0.25)).astype(np.int16)


def luma_words(frames: int, side: int, dev: torch.device, seed: int = 0):
    """The packed16 words and lengths of the luma of ``frames`` uniform noise
    frames of side² through the port's forward (K1 on a card), as
    ``chip_smoke.py``'s phases 12 and 13 make them."""
    from lz4jpeg_tpu_torch.ops.fwd_megakernel import (
        CHANNEL_SLICES,
        forward_combined,
    )
    from lz4jpeg_tpu_torch.ops.quantize import (
        CHROMINANCE_QUANTIZATION_TABLE as CHR,
        LUMINANCE_QUANTIZATION_TABLE as LUM,
    )
    from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16

    gen = torch.Generator(device=dev).manual_seed(seed)
    rgb = torch.randint(0, 256, (frames, side, side, 3), dtype=torch.uint8,
                        device=dev, generator=gen)
    comb = forward_combined(rgb, LUM, CHR)
    del rgb
    vals = rle_decode_sparse16(comb[:, CHANNEL_SLICES["lum"]]).to(torch.int16)
    del comb
    return pack16.pack16_encode(vals)


def run_rle_decode_ab(device="cuda", frames: int = 64, side: int = 2048,
                      runs: int = 4, reps: int = 8,
                      output: Optional[str] = None, seed: int = 0) -> Dict:
    """The probe's check, then the membership kernel against K6, K8 and the
    plain version on the luma words of ``frames`` noise frames of side²;
    returns the result and writes it to ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    sym = torch.from_numpy(structured_symbols(seed=seed)).to(dev)
    words, lens = pack16.pack16_encode(sym)
    want = pack16.pack16_decode(words, lens, 64)
    got = rle_decode_membership(words, lens, 64)
    if not (torch.equal(got, want)
            and torch.equal(got, rle_decode_membership_ref(words, lens, 64))):
        raise AssertionError("membership decode differs from the packed16 "
                             "decode on the probe's check")
    print("membership rle decode: identical to K6 and the plain version "
          f"({sym.shape[0]} structured rows)", flush=True)
    del sym, words, lens, want, got

    words, lens = luma_words(frames, side, dev, seed)
    n, k = words.shape
    got = rle_decode_membership(words, lens, k)
    for name, other in (("K6", pack16.pack16_decode(words, lens, k)),
                        ("K8", pack16.pack16_decode_wide(words, lens).to(torch.int32)),
                        ("plain", rle_decode_membership_ref(words, lens, k))):
        if not torch.equal(got, other):
            raise AssertionError(f"membership decode differs from {name} on "
                                 f"{n} x {k} luma words")
    del got, other
    x = (words, lens)
    versions = {
        "membership kernel": (lambda a: rle_decode_membership(*a, k),
                              rle_decode_membership),
        "K6 pack16_decode": (lambda a: pack16.pack16_decode(*a, k),
                             pack16.pack16_decode),
        "K8 pack16_decode_wide": (lambda a: pack16.pack16_decode_wide(*a),
                                  pack16.pack16_decode_wide),
        "plain pack16_decode_ref": (
            lambda a: rle_decode_membership_ref(*a, k), None),
    }
    key = timing.timer_key(dev)
    rows = {}
    for label, (fn, kernel) in versions.items():
        plain = kernel is None
        rows[label] = {key: timing.time_ms(
            fn, x, dev, reps=1 if plain else reps, runs=runs,
            kernel=kernel if cuda else None)}
    pairs = membership_pairs(lens, k, k)
    bounds = {
        "bytes_bound_ms": timing.bytes_bound_ms(n * k * 2 + n * 4 + n * k * 4),
        "issue_bound_ms": timing.issue_bound_ms(
            MEMBERSHIP_INSTRUCTIONS * pairs, dev),
        "issue_counts": f"{MEMBERSHIP_INSTRUCTIONS} lane instructions per "
                        f"(position, valid run) pair, {pairs} pairs",
    }
    rows["membership kernel"].update(membership_attributes(k, dev))
    t = {label: r[key] for label, r in rows.items()}
    for label, r in rows.items():
        print(f"{label:26s} {r[key]:9.4f} ms"
              + ("" if r.get("registers") is None else
                 f"  regs {r['registers']}  smem {r['shared_bytes']}  "
                 f"ctas/SM {r['ctas_per_sm']}"), flush=True)
    fastest = min(("K6 pack16_decode", "K8 pack16_decode_wide"), key=t.get)
    m = t["membership kernel"]
    where = device_record(dev)
    verdict = (f"on {where.get('card', dev)}: the membership kernel "
               f"{'beats' if m < t[fastest] else 'loses to'} {fastest} "
               f"({t[fastest] / m:.2f}x; K6 {t['K6 pack16_decode'] / m:.2f}x)"
               f" on {n} x {k} luma words")
    print(f"bounds: bytes {bounds['bytes_bound_ms']:.4f} ms"
          + ("" if bounds["issue_bound_ms"] is None else
             f", issue {bounds['issue_bound_ms']:.4f} ms "
             f"({bounds['issue_counts']})"))
    print(f"verdict: {verdict}")
    result = {
        "frames": frames,
        "side": side,
        "rows_decoded": n,
        "segment": k,
        "runs": runs,
        "reps": reps,
        "seed": seed,
        "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock",
        **where,
        **bounds,
        "mean_runs_per_row": float(torch.clamp(lens // 2, 0, k).float().mean()),
        "versions": rows,
        "verdict": verdict,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.rle_decode",
        description="A/B of the membership packed16 decode against K6 and K8.")
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--side", type=int, default=2048)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_rle_decode_ab(args.device, args.frames, args.side, args.runs,
                      args.reps, args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
