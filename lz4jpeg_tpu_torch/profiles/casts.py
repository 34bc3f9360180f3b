"""The seven dtype casts of the TPU cast probe, as one hand-written kernel,
and their run.

Port of ``profiles/profile_mosaic_casts.py::kern`` (``pallas_call`` :19),
which asked which casts Mosaic lowers and whether each is exact on a (64,
256) tile of values 0-126.  ``cast(x, dst)`` converts ``x`` (any shape) to
``dst`` for the seven pairs of ``PAIRS`` (int16 → float32, int32 →
float32, uint8 → int32, int8 → int32, int16 → int32, uint8 → int16,
bfloat16 → float32), bit-identical to ``x.to(dst)``; another pair raises
``ValueError`` on both devices.  A CPU tensor runs ``cast_ref`` (which is
``x.to(dst)``); a CUDA tensor launches ``csrc/cast_kernel.cu`` (one template
<Src, Dst>, seven instantiations; a source off a 16-byte boundary is copied
first) and adds one to ``cast.launches``, or raises.

``cast_plan`` mirrors the kernel's launch in Python (a vector of 16 /
the destination's item size elements a lane, one CTA a chunk of
``THREADS`` vectors in index order, the last ``n % elements a vector`` one
by one) and ``cta_ranges`` the elements each CTA converts, so that the CPU
tests hold their coverage; on the card ``launch_plan`` asks the C code
for its plan.

The run (``python -m lz4jpeg_tpu_torch.profiles.casts``) holds every pair
to ``x.to(dst)`` on the probe's tile and over the source type's whole range
(every uint8, int8 and int16 value; int32 extremes and round-to-even ties
above 2^24 with random words; every bfloat16 bit pattern: subnormals, ±inf
and NaNs, NaN compared as NaN), then times the kernel and ``x.to(dst)``
(the plain version and the library call are that one call) at ``elements``
elements of random source words (the probe's tile grown to 64 ×
2,097,152).  Times: ``profiles/timing.py`` (best of ``runs`` runs of
``reps`` calls, queued behind a spin on the card; the kernel's runs
guarded by its launch count); bound: the source read once and the result
written once over 3.35 TB/s.  Run on the card from the repository root (on
the CPU add ``--device cpu --elements 65536``)::

    python -m lz4jpeg_tpu_torch.profiles.casts --output c.json
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
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

# csrc/cast_kernel.cu's pair ids, in the probe's order (:11-14).
PAIRS = (
    (torch.int16, torch.float32),
    (torch.int32, torch.float32),
    (torch.uint8, torch.int32),
    (torch.int8, torch.int32),
    (torch.int16, torch.int32),
    (torch.uint8, torch.int16),
    (torch.bfloat16, torch.float32),
)


THREADS = 512  # csrc/cast_kernel.cu's kThreads


class CastPlan(NamedTuple):
    """The kernel's launch for one pair and ``n`` elements: ``n_vec``
    vectors of ``vec_elems`` elements, then ``tail`` elements one by one;
    ``ctas`` CTAs of ``threads`` threads, each a chunk of ``threads``
    vectors (and of the tail list)."""

    n_vec: int
    tail: int
    ctas: int
    vec_elems: int
    threads: int


def cast_plan(pair: int, n: int) -> CastPlan:
    """``csrc/cast_kernel.cu::plan_of`` and ``Layout`` for ``n`` ≥ 0
    elements of the pair."""
    k_in = 16 // PAIRS[pair][1].itemsize
    n_vec, tail = divmod(n, k_in)
    ctas = max(-(-n_vec // THREADS), -(-tail // (THREADS * k_in)))
    return CastPlan(n_vec, tail, ctas, k_in, THREADS)


def cta_ranges(plan: CastPlan) -> np.ndarray:
    """(R, 3) int64 rows ``(cta, start, stop)``: the element ranges each CTA
    of ``cast_kernel`` converts, from its index arithmetic (chunk ``cta`` of
    the vectors, then chunk ``cta`` of the tail list)."""
    chunk = plan.threads * plan.vec_elems
    body = plan.n_vec * plan.vec_elems
    c = np.arange(-(-plan.n_vec // plan.threads), dtype=np.int64)
    rows = [np.stack([c, c * chunk, np.minimum((c + 1) * chunk, body)], 1)]
    c = np.arange(-(-plan.tail // chunk), dtype=np.int64)
    rows.append(np.stack([c, body + c * chunk,
                          body + np.minimum((c + 1) * chunk, plan.tail)], 1))
    out = np.concatenate(rows).reshape(-1, 3)
    return out[out[:, 2] > out[:, 1]]


def pair_name(pair: int) -> str:
    src, dst = PAIRS[pair]
    return f"{str(src).split('.')[-1]}->{str(dst).split('.')[-1]}"


def pair_id(src: torch.dtype, dst: torch.dtype) -> int:
    """The index of (src, dst) in ``PAIRS``; ``ValueError`` for another."""
    try:
        return PAIRS.index((src, dst))
    except ValueError:
        raise ValueError(f"no cast kernel for {src} -> {dst}; the pairs are "
                         f"{[pair_name(i) for i in range(len(PAIRS))]}") from None


def cast_ref(x: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """Plain version: ``x.to(dst)`` (a new contiguous tensor)."""
    pair_id(x.dtype, dst)
    return x.contiguous().to(dst)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/cast_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("cast_kernel")
    lib.cast_launch.restype = ctypes.c_int
    lib.cast_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int64, ctypes.c_void_p]
    lib.cast_plan.restype = ctypes.c_int
    lib.cast_plan.argtypes = [ctypes.c_int, ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int64)]
    timing.bind_attributes(lib, "cast_attributes")
    lib.cast_error_string.restype = ctypes.c_char_p
    lib.cast_error_string.argtypes = [ctypes.c_int]
    return lib


def launch_plan(pair: int, n: int) -> CastPlan:
    """The plan the C code launches for ``n`` elements of the pair
    (``csrc/cast_kernel.cu::cast_plan``)."""
    out = (ctypes.c_int64 * 5)()
    lib = load_kernel()
    rc = lib.cast_plan(pair, n, out)
    if rc != 0:
        raise RuntimeError(f"cast_plan failed: "
                           f"{lib.cast_error_string(rc).decode()} ({rc})")
    return CastPlan(*out)


def cast(x: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """``x`` (any shape) converted to ``dst``, one of the seven ``PAIRS``.
    A CPU tensor runs ``cast_ref``; a CUDA tensor launches the cast kernel
    on the current stream and adds one to ``cast.launches``."""
    pair = pair_id(x.dtype, dst)
    x = x.contiguous()
    dev = _check_device(x)
    if dev.type == "cpu":
        return cast_ref(x, dst)
    if x.data_ptr() % 16:  # the kernel moves 16 bytes a lane
        x = x.clone()
    out = torch.empty(x.shape, dtype=dst, device=dev)
    if x.numel():
        _launch(load_kernel(), "cast_launch", "cast_error_string", dev, pair,
                x.data_ptr(), out.data_ptr(), x.numel())
        cast.launches += 1
    return out


cast.launches = 0


def attributes(pair: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of the pair's kernel; None
    on the CPU."""
    return timing.attributes(load_kernel, "cast_attributes",
                             "cast_error_string", pair, torch.device(device))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-identical, except that any NaN equals any NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int32 if a.element_size() == 4 else torch.int16
    return torch.equal(a[~nan].view(bits), b[~nan].view(bits))


def probe_values(src: torch.dtype, rng: np.random.Generator) -> torch.Tensor:
    """The probe's (64, 256) tile: integers in [0, 127) as ``src``."""
    x = torch.from_numpy(rng.integers(0, 127, size=(64, 256)))
    return x.to(src)


def full_range(src: torch.dtype, rng: np.random.Generator) -> torch.Tensor:
    """The source type's whole range: every value of a type of 16 bits or
    fewer (for bfloat16 every bit pattern); for int32 its extremes, the
    neighbours of 2^24 to 2^31 (round-to-even ties among them) and 65,536
    random words."""
    if src == torch.bfloat16:
        return torch.arange(-32768, 32768, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16)
    if src != torch.int32:
        info = torch.iinfo(src)
        return torch.arange(info.min, info.max + 1, dtype=torch.int32).to(src)
    edges = [v * s + d for e in range(24, 32) for v in (1 << e,)
             for s in (1, -1) for d in range(-3, 4)]
    edges += [-(1 << 31), (1 << 31) - 1, 0, 1, -1]
    words = rng.integers(-(1 << 31), 1 << 31, size=65536, dtype=np.int64)
    vals = np.concatenate([np.asarray(edges, np.int64), words])
    vals = vals[(vals >= -(1 << 31)) & (vals < (1 << 31))]
    return torch.from_numpy(vals.astype(np.int32))


def random_values(src: torch.dtype, n: int, dev: torch.device,
                  seed: int) -> torch.Tensor:
    """``n`` random source words on ``dev`` from ``seed``, over the whole
    range (bfloat16: random bit patterns)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if src == torch.bfloat16:
        return torch.randint(-32768, 32768, (n,), dtype=torch.int16,
                             device=dev, generator=gen).view(torch.bfloat16)
    info = torch.iinfo(src)
    return torch.randint(info.min, info.max, (n,), dtype=src, device=dev,
                         generator=gen)


def cast_bytes(pair: int, n: int) -> int:
    src, dst = PAIRS[pair]
    return n * (src.itemsize + dst.itemsize)


def run_casts(device="cuda", elements: int = 64 * 2_097_152, runs: int = 4,
              reps: int = 8, output: Optional[str] = None,
              seed: int = 0) -> Dict:
    """Every pair checked on the probe's tile and the source's range, then
    timed at ``elements``; returns the result and writes it to ``output``
    if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    rng = np.random.default_rng(seed)
    rows = []
    for pair, (src, dst) in enumerate(PAIRS):
        name = pair_name(pair)
        before = cast.launches
        checked = 0
        for x in (probe_values(src, rng), full_range(src, rng)):
            x = x.to(dev)
            if not same(cast(x, dst), cast_ref(x, dst)):
                raise AssertionError(f"{name}: the kernel differs from "
                                     f"x.to({dst}) on {tuple(x.shape)}")
            checked += x.numel()
        x = random_values(src, elements, dev, seed + pair)
        if not same(cast(x, dst), cast_ref(x, dst)):
            raise AssertionError(f"{name}: the kernel differs from x.to({dst})"
                                 f" at {elements} elements")
        check_launches = cast.launches - before
        ms = timing.time_ms(lambda v: cast(v, dst), x, dev, reps=reps,
                            runs=runs, kernel=cast if cuda else None)
        plain_ms = timing.time_ms(lambda v: v.to(dst), x, dev, reps=reps,
                                  runs=runs)
        del x
        n_bytes = cast_bytes(pair, elements)
        bound = timing.bytes_bound_ms(n_bytes)
        row = {"pair": name, "elements": elements, "checked": checked,
               "site": "profile_mosaic_casts.py:19", key: ms,
               f"plain_{key}": plain_ms, f"library_{key}": plain_ms,
               "library": "x.to(dst)",
               "launches": cast.launches - before - check_launches,
               "bytes": n_bytes, "bytes_bound_ms": bound,
               "share": bound / ms if cuda else None,
               **attributes(pair, dev)}
        rows.append(row)
        print(f"{name:18s} OK identical=True  {ms:9.4f} ms  x.to "
              f"{plain_ms:9.4f}"
              + ("" if row["share"] is None else
                 f"  {row['share']:.1%} of {bound:.4f}  regs "
                 f"{row['registers']}  smem {row['shared_bytes']}  ctas/SM "
                 f"{row['ctas_per_sm']}"), flush=True)
    where = device_record(dev)
    ratio = [r[key] / r[f"plain_{key}"] for r in rows]
    verdict = (f"on {where.get('card', dev)}: all seven casts exact; the "
               f"kernel takes {min(ratio):.2f}-{max(ratio):.2f}x the time of "
               "x.to(dst)")
    print(f"verdict: {verdict}")
    result = {"elements": elements, "runs": runs, "reps": reps, "seed": seed,
              "backend": dev.type,
              "timer": "cuda events" if cuda else "host clock", **where,
              "pairs": rows, "verdict": verdict}
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.casts",
        description="The seven casts of the TPU cast probe: exactness, and "
                    "times against x.to(dst).")
    ap.add_argument("--elements", type=int, default=64 * 2_097_152)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_casts(args.device, args.elements, args.runs, args.reps, args.output,
              args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
