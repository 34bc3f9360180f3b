"""The per-stage rate of a radix partition's and a bitonic sort's primitive,
as two hand-written kernels of one source.

Port of ``profiles/probe_bucket_partition.py``, which asked whether the
LZ4 matcher could radix-partition its anchors by bucket instead of sorting
them.  On the TPU both primitives were lane-roll stages of the same cost, so
the answer reduced to stage counts: a stable split on one bucket bit is two
monotone concentrations, 2·log2(Pa) stages, so 16 bucket bits take at least
32·14 = 448 stages at Pa = 16,384 against the bitonic sort's 105.  This
module measures the two stage rates on Hopper and prints the same
arithmetic with the measured per-stage cost ratio.

* ``concentration_stages(x)``: 32 monotone-concentration butterfly stages
  on each 128-lane row (``probe_bucket_partition.py:45-57``);
* ``compare_exchange_stages(x)``: 32 bitonic compare-exchange stages
  (``:59-75``).

Both take (B, 128, 128) int32 (the matcher's tile; values below 2^30 in the
probe) and return the same shape.  Their plain versions restate the probe's
expressions with ``torch.roll`` (``torch.roll(w, 128 - s)[c] = w[(c + s) %
128]``, as ``jnp.roll`` and the TPU's ``pltpu.roll``).  A CPU tensor runs
the plain version; a CUDA tensor launches ``csrc/stage_rate_kernel.cu`` or
raises.  The concentration kernel's plan is mirrored in numpy for the CPU
tests (``tests/test_torch_stage_plan.py``): a thread's in-place update of
its row (``concentration_update``, ``emulate_concentration``), its shared
loads (``row_chunks``), its bulk copies (``bulk_copies``) and the
persistent grid (``concentration_plan``).

Run on the card from the repository root (on the CPU add ``--device cpu``
and small sizes)::

    python -m lz4jpeg_tpu_torch.profiles.bucket_partition --output stages.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

LANES = 128
ROWS = 128
STAGES = 32  # the probe's stage count, the same for both primitives
PA = ROWS * LANES  # anchors of a 16 KiB block at stride 1
CONCENTRATION, COMPARE_EXCHANGE = 0, 1
# Lane instructions per stage-element at the least: the value from another
# lane (a shuffle or a register move) and, for a concentration, two bit tests
# and a select; for a compare-exchange, one min-or-max.
INSTRUCTIONS = {CONCENTRATION: 4, COMPARE_EXCHANGE: 2}
# The loop of each stage kernel whose SASS ``stage_sass_counts`` counts:
# kernel (sass_diff.py's name and template arguments) -> (kind, the
# stage-elements a thread takes in one pass of the loop).  The
# concentration's loop runs the 7-step cycle on a thread's 128 values; the
# compare-exchange's, and that of the earlier warp-a-row concentration
# (stage_rate_kernel<0>, found only in a checkout from before the
# concentration's own kernel, as ``ab_kernels.py --other`` reads one), run
# the 32 stages on a lane's 4 values.
SASS_LOOPS = {
    "concentration_kernel<(bool)1>": (CONCENTRATION, 7 * LANES),
    "stage_rate_kernel<(int)0>": (CONCENTRATION, STAGES * LANES // 32),
    "stage_rate_kernel<(int)1>": (COMPARE_EXCHANGE, STAGES * LANES // 32),
}
# The concentration kernel's plan (csrc/stage_rate_kernel.cu, namespace
# conc): persistent CTAs of CONC_WARPS warps, CONC_CTAS_PER_SM an SM; a warp
# takes TILE_ROWS rows at once, a row a lane, each row copied into shared
# memory at a PITCH-byte stride and read back as 16-byte loads.
CONC_WARPS = 4
CONC_CTAS_PER_SM = 3
TILE_ROWS = 32
ROW_BYTES = LANES * 4
PITCH = ROW_BYTES + 16
H100_SMS = 132


def _tiles(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 3 or tuple(x.shape[1:]) != (ROWS, LANES):
        raise ValueError(f"expected (B, {ROWS}, {LANES}) tiles, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"expected int32, got {x.dtype}")
    return x.contiguous()


def concentration_stages_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``probe_bucket_partition.py:48-57`` in torch ops."""
    w = _tiles(x)
    col = torch.arange(LANES, device=w.device, dtype=torch.int32)
    for b in range(STAGES):
        step = 1 << (b % 7)
        incoming = torch.roll(w, LANES - step, dims=2)
        ok = col < (LANES - step)
        arrive = ok & ((incoming & 1) != 0) & ((incoming & step) != 0)
        depart = ((w & 1) != 0) & ((w & step) != 0)
        w = torch.where(arrive, incoming - step,
                        torch.where(depart, torch.zeros_like(w), w))
    return w


def compare_exchange_stages_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``probe_bucket_partition.py:62-75`` in torch ops."""
    w = _tiles(x)
    col = torch.arange(LANES, device=w.device, dtype=torch.int32)
    for b in range(STAGES):
        d = 1 << (b % 7)
        sel = (col & d) == 0
        partner = torch.where(sel, torch.roll(w, LANES - d, dims=2),
                              torch.roll(w, d, dims=2))
        keep_min = sel == ((col & (2 * d)) == 0)
        w = torch.where(keep_min, torch.minimum(w, partner),
                        torch.maximum(w, partner))
    return w


def moves(v: np.ndarray, step: int) -> np.ndarray:
    """The kernel's test p(v) = (v & m) == m, m = 1 | step: v leaves its
    column at this stage and arrives ``step`` columns lower."""
    m = 1 | step
    return (v & m) == m


def concentration_update(w: np.ndarray, step: int) -> None:
    """One stage on the rows of ``w`` (..., 128) in place, as a thread of
    the kernel updates its registers: in chains c = r, r + step, ... in
    ascending order, where column c takes w[c + step] - step if that value
    moves, else 0 if its own moves; w[c + step] is still the old value
    when column c is written, and its test is column c + step's own."""
    for r in range(step):
        leaves = moves(w[..., r], step)
        for c in range(r, LANES, step):
            if c + step < LANES:
                arrives = moves(w[..., c + step], step)
                w[..., c] = np.where(arrives, w[..., c + step] - step,
                                     np.where(leaves, 0, w[..., c]))
                leaves = arrives
            else:
                w[..., c] = np.where(leaves, 0, w[..., c])


def stage_steps() -> list:
    """The step of each of the 32 stages in the kernel's order: the cycle
    1..64 run five times, left after the fourth stage of the fifth."""
    steps = []
    for i in range(STAGES // 7 + 1):
        steps += [1 << b for b in range(STAGES % 7)]
        if i == STAGES // 7:
            break
        steps += [1 << b for b in range(STAGES % 7, 7)]
    return steps


def emulate_concentration(x: np.ndarray) -> np.ndarray:
    """The 32 stages of ``concentration_update`` on (..., 128) int32 rows,
    in the kernel's step order."""
    w = np.array(x, dtype=np.int32)
    for step in stage_steps():
        concentration_update(w, step)
    return w


def row_chunks(lane: int) -> np.ndarray:
    """Byte offsets in a warp's shared tile of lane ``lane``'s 32 16-byte
    loads of its row (and of its stores of the result)."""
    return lane * PITCH + 16 * np.arange(ROW_BYTES // 16)


def bulk_copies(tile: int, n_rows: int) -> list:
    """(source byte offset in the array, byte offset in the warp's shared
    tile, bytes) of each lane's copy of tile ``tile`` of ``n_rows`` rows;
    the stores back out are the same copies reversed."""
    rows = range(tile * TILE_ROWS, min((tile + 1) * TILE_ROWS, n_rows))
    return [(row * ROW_BYTES, (row - tile * TILE_ROWS) * PITCH, ROW_BYTES)
            for row in rows]


def concentration_plan(n_blocks: int) -> Dict:
    """The launch of ``n_blocks`` (B, 128, 128) blocks on an H100: its
    tiles, CTAs (the resident ones, no more than the rows need) and, per
    (CTA, warp, lane),
    the rows the thread takes in turn (-1 past the last row).  CTA b takes
    the groups of CONC_WARPS tiles b, b + CTAs, ..., a tile a warp, a row a
    lane."""
    n_rows = n_blocks * ROWS
    tiles = -(-n_rows // TILE_ROWS)
    ctas = min(-(-n_rows // (CONC_WARPS * TILE_ROWS)),
               H100_SMS * CONC_CTAS_PER_SM)
    warps = ctas * CONC_WARPS
    passes = -(-tiles // warps)
    warp = np.arange(warps).reshape(ctas, CONC_WARPS, 1, 1)
    tile = warp + warps * np.arange(passes).reshape(1, 1, 1, passes)
    row = tile * TILE_ROWS + np.arange(TILE_ROWS).reshape(1, 1, TILE_ROWS, 1)
    return {"rows": n_rows, "tiles": tiles, "ctas": ctas, "passes": passes,
            "thread_rows": np.where((tile < tiles) & (row < n_rows), row, -1)}


def stage_sass_counts(root=None) -> Dict[int, float]:
    """{kind: lane instructions per stage-element} of the stage kernels of
    ``csrc/stage_rate_kernel.cu`` in the checkout at ``root`` (this one by
    default), counted in their SASS: the longest innermost loop of each
    kernel of ``SASS_LOOPS`` over the stage-elements a thread takes in one
    pass of it.  ptxas also emits a copy of a shuffle loop for a warp that
    is not converged (each shuffle in WARPSYNC and ENDCOLLECTIVE), which
    never runs here; that copy is left out.  Needs the CUDA toolkit."""
    from lz4jpeg_tpu_torch.profiles import sass_loops

    sd = sass_loops._sass_diff()
    found = sass_loops.source_loops("stage_rate_kernel",
                                    root or sass_loops.REPO)
    counts = {}
    for name, inner in found.items():
        base, args = sd.kernel_key(name)
        kernel = f"{base}<{', '.join(args)}>"
        if kernel not in SASS_LOOPS:
            continue
        kind, elements = SASS_LOOPS[kernel]
        loop = max((lp for lp in inner if "ENDCOLLECTIVE" not in lp["mix"]),
                   key=lambda lp: lp["length"])
        counts[kind] = loop["length"] / elements
    return counts


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/stage_rate_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("stage_rate_kernel")
    lib.stage_rate_launch.restype = ctypes.c_int
    lib.stage_rate_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    timing.bind_attributes(lib, "stage_rate_attributes")
    lib.stage_rate_error_string.restype = ctypes.c_char_p
    lib.stage_rate_error_string.argtypes = [ctypes.c_int]
    return lib


def _stages(x: torch.Tensor, kind: int, wrapper, ref) -> torch.Tensor:
    w = _tiles(x)
    dev = _check_device(w)
    if dev.type == "cpu":
        return ref(w)
    out = torch.empty_like(w)
    rows = w.shape[0] * ROWS
    if rows:
        _launch(load_kernel(), "stage_rate_launch", "stage_rate_error_string",
                dev, kind, w.data_ptr(), out.data_ptr(), rows)
        wrapper.launches += 1
    return out


def concentration_stages(x: torch.Tensor) -> torch.Tensor:
    """32 monotone-concentration stages on each row of (B, 128, 128) int32.

    A CPU tensor runs ``concentration_stages_ref``.  A CUDA tensor launches
    the kernel on the current stream and adds one to
    ``concentration_stages.launches``."""
    return _stages(x, CONCENTRATION, concentration_stages,
                   concentration_stages_ref)


def compare_exchange_stages(x: torch.Tensor) -> torch.Tensor:
    """32 bitonic compare-exchange stages on each row of (B, 128, 128)
    int32.

    A CPU tensor runs ``compare_exchange_stages_ref``.  A CUDA tensor
    launches the kernel on the current stream and adds one to
    ``compare_exchange_stages.launches``."""
    return _stages(x, COMPARE_EXCHANGE, compare_exchange_stages,
                   compare_exchange_stages_ref)


concentration_stages.launches = 0
compare_exchange_stages.launches = 0

KERNELS = {  # record name: (kind, wrapper, plain version, probe label)
    "concentration_stages": (CONCENTRATION, concentration_stages,
                             concentration_stages_ref,
                             "concentration stages (radix primitive)"),
    "compare_exchange_stages": (COMPARE_EXCHANGE, compare_exchange_stages,
                                compare_exchange_stages_ref,
                                "compare-exchange stages (bitonic)"),
}


def stage_attributes(kind: int, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of one kind."""
    return timing.attributes(load_kernel, "stage_rate_attributes",
                             "stage_rate_error_string", kind,
                             torch.device(device))


def probe_tiles(n: int, seed: int = 0) -> torch.Tensor:
    """The probe's data (``probe_bucket_partition.py:39-42``): (n, 128,
    128) int32 uniform below 2^30."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 1 << 30, size=(n, ROWS, LANES)).astype(np.int32))


def crafted_rows(seed: int = 0) -> Dict[str, np.ndarray]:
    """Rows of 128 int32 that the probe's data never holds, by kind: all
    zeros; all ones; all bits set; for each step, every other column moving
    at that stage (arrive and depart bits alternating, both phases) and
    every column moving; values near 2^30 and 2^31 - 1; negative values
    (INT32_MIN with and without the moving bits); and mixed rows drawn from
    all of those values."""
    rng = np.random.default_rng(seed)
    steps = [1 << b for b in range(7)]
    alternating = []
    for step in steps:
        for phase in (0, 1):
            alternating.append(np.where(np.arange(LANES) % 2 == phase,
                                        1 | step, 0))
        alternating.append(np.full(LANES, 1 | step))
    top = (1 << 30) - 1
    near = [top - np.arange(LANES), top + np.arange(LANES),
            np.full(LANES, (1 << 31) - 1), (1 << 31) - 1 - np.arange(LANES),
            top - rng.integers(0, 256, LANES)]
    low = -(1 << 31)
    negative = [np.full(LANES, low), np.full(LANES, -1) - np.arange(LANES),
                low + rng.integers(0, 1 << 20, LANES),
                -rng.integers(1, 1 << 31, LANES)]
    negative += [np.full(LANES, low | 1 | step) for step in steps]
    palette = np.array([0, 1, -1, top, (1 << 31) - 1, low, low | 1]
                       + [1 | s for s in steps] + [low | 1 | s for s in steps]
                       + [top & ~s for s in steps], dtype=np.int64)
    kinds = {
        "zeros": [np.zeros(LANES)],
        "ones": [np.ones(LANES)],
        "all bits": [np.full(LANES, -1)],
        "alternating": alternating,
        "near 2^30": near,
        "negative": negative,
        "mixed": list(rng.choice(palette, size=(48, LANES))),
    }
    return {k: np.stack(v).astype(np.int64).astype(np.int32)
            for k, v in kinds.items()}


def crafted_tiles(seed: int = 0) -> torch.Tensor:
    """Every row of ``crafted_rows``, then mixed rows up to a whole block:
    (1, 128, 128) int32."""
    rows = np.concatenate(list(crafted_rows(seed).values()))
    fill = crafted_rows(seed + 1)["mixed"]
    rows = np.concatenate([rows, np.resize(fill, (ROWS - len(rows), LANES))])
    return torch.from_numpy(rows.reshape(1, ROWS, LANES))


def stage_counts(pa: int = PA) -> Dict:
    """The probe's stage-count arithmetic (:109-117): the bitonic sort's
    log2(Pa)·(log2(Pa)+1)/2 stages against a 16-bit radix partition's at
    least 2·16·log2(Pa)."""
    log2pa = int(math.log2(pa))
    return {"pa": pa, "bitonic_stages": log2pa * (log2pa + 1) // 2,
            "radix_stages": 2 * 16 * log2pa}


def run_bucket_partition(device="cuda", blocks: Sequence[int] = (256, 2048),
                         runs: int = 4, reps: int = 8,
                         output: Optional[str] = None, seed: int = 0,
                         sass_counts: Optional[Dict[int, float]] = None
                         ) -> Dict:
    """Both stage kernels against their plain versions, then timed, at each
    of ``blocks`` (B, 128, 128) arrays of the probe's data: ms and ps per
    stage-element, their ratio, and the probe's stage-count arithmetic at
    the measured ratio.  On the card each record also carries the issue
    floor at its loop's lane instructions per stage-element in this build's
    SASS: ``sass_counts`` where given (``stage_sass_counts``' result), else
    counted here.  Returns the result and writes it to ``output`` if
    given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key = timing.timer_key(dev)
    if cuda and sass_counts is None:
        sass_counts = stage_sass_counts()
    sizes = []
    for n in blocks:
        x = probe_tiles(n, seed).to(dev)
        elems = n * ROWS * LANES
        kernels = {}
        print(f"== partition-vs-bitonic stage rate, {STAGES} stages on "
              f"({n},{ROWS},{LANES}) ==", flush=True)
        for name, (kind, fn, ref, label) in KERNELS.items():
            if not torch.equal(fn(x), ref(x)):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {n} blocks")
            ms = timing.time_ms(fn, x, dev, reps=reps, runs=runs,
                                kernel=fn if cuda else None)
            plain = timing.time_ms(ref, x, dev, reps=1, runs=runs)
            rec = {
                "label": label, key: ms, "plain_" + key: plain,
                "ps_per_stage_elem": ms / (STAGES * elems) * 1e9,
                "bytes_bound_ms": timing.bytes_bound_ms(2 * 4 * elems),
                "issue_bound_ms": timing.issue_bound_ms(
                    INSTRUCTIONS[kind] * STAGES * elems, dev),
                "issue_counts": f"{INSTRUCTIONS[kind]} lane instructions per "
                                f"stage-element, {STAGES * elems} "
                                "stage-elements",
                **stage_attributes(kind, dev),
            }
            sass = None
            if rec["issue_bound_ms"] is not None and sass_counts:
                sass = timing.issue_bound_ms(
                    sass_counts[kind] * STAGES * elems, dev)
                rec["sass_issue_bound_ms"] = sass
                rec["sass_counts"] = (f"{sass_counts[kind]:.4f} lane "
                                      "instructions per stage-element in "
                                      "this build's SASS loop")
            kernels[name] = rec
            issue = rec["issue_bound_ms"]
            print(f"{label:40s} {ms:8.4f} ms  {rec['ps_per_stage_elem']:6.3f} "
                  f"ps/stage-elem  plain {plain:9.4f} ms  bound "
                  f"{rec['bytes_bound_ms']:.4f} ms (bytes)"
                  + ("" if issue is None else
                     f", {issue:.4f} ms (issue, {issue / ms:.1%})")
                  + ("" if sass is None else
                     f", {sass:.4f} ms (its SASS, {sass / ms:.1%})")
                  + ("" if rec["registers"] is None else
                     f"  regs {rec['registers']}  smem {rec['shared_bytes']}"
                     f"  ctas/SM {rec['ctas_per_sm']}"), flush=True)
        ratio = (kernels["concentration_stages"]["ps_per_stage_elem"]
                 / kernels["compare_exchange_stages"]["ps_per_stage_elem"])
        counts = stage_counts()
        print(f"stage-count arithmetic at Pa={counts['pa']}: bitonic "
              f"{counts['bitonic_stages']}, 16-bit radix >= "
              f"{counts['radix_stages']} (x"
              f"{counts['radix_stages'] / counts['bitonic_stages']:.1f} more "
              f"stages at {ratio:.2f}x the per-stage cost)", flush=True)
        sizes.append({"blocks": n, "kernels": kernels,
                      "concentration_over_compare_exchange": ratio,
                      "radix_over_bitonic_time": ratio * counts["radix_stages"]
                      / counts["bitonic_stages"]})
        del x
    result = {
        "stages": STAGES,
        "runs": runs,
        "reps": reps,
        "seed": seed,
        "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock",
        **device_record(dev),
        "stage_counts": stage_counts(),
        "sizes": sizes,
    }
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.bucket_partition",
        description="Per-stage rate of the radix partition's concentration "
                    "stage against the bitonic compare-exchange stage.")
    ap.add_argument("--blocks", type=int, nargs="+", default=[256, 2048])
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_bucket_partition(args.device, args.blocks, args.runs, args.reps,
                         args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
