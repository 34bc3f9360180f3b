"""The matcher's block sort with a payload, as a hand-written kernel.

Port of ``profiles/profile_pallas_sort.py``, the probe that asked whether a
bitonic network over one 16 KiB block's keys, run in fast memory with the
payload routed along, beats the library sort the TPU matcher was built on,
and what its un-sort by reverse replay of the recorded swap masks costs.

``bitonic_sort_blocks(keys, payload, record_masks=False)`` takes (B, 128,
128) or (B, 16384) int32 keys and payload and returns them in the same
shapes: each block's keys ascending with the payload routed along, or, with
``record_masks``, the keys ascending and the payload back at its input
position after the swaps are replayed in reverse.  The contract is the
probe's: keys unique within a block (``(bucket << 14) | position``).  With
duplicate keys the output keys are still sorted and the (key, payload)
multiset is kept, but the order among equal keys is the network's, not a
stable sort's.

The plain version ``bitonic_sort_blocks_ref`` restates the probe's network
(:35-126) as torch ops: 105 stages of ``torch.roll``/``torch.where`` over
the (128, 128) tile, the swap masks folded into four int32 bit-planes and
replayed in reverse, so the replay is exercised and not short-cut.  A CPU
tensor runs it; a CUDA tensor launches ``csrc/bitonic_sort_kernel.cu`` (one
launch sorts every block: the probe's ``batch_r`` grid divisor was a TPU
detail) or raises.

Run on the card from the repository root (on the CPU add ``--device cpu``
and small sizes)::

    python -m lz4jpeg_tpu_torch.profiles.bitonic_sort --output sort.json
"""

from __future__ import annotations

import argparse
import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lz4jpeg_tpu_torch.bench.harness import bench_device, device_record
from lz4jpeg_tpu_torch.kernels.build import load_cuda_library
from lz4jpeg_tpu_torch.ops.pack16 import _check_device, _launch
from lz4jpeg_tpu_torch.profiles import timing

LANES = 128
ROWS = 128
SLOTS = LANES * ROWS  # 16,384
LOG_SLOTS = 14
STAGES = LOG_SLOTS * (LOG_SLOTS + 1) // 2  # 105
# Lane instructions of a compare-exchange with its payload at the least: one
# compare and four selects; a replayed swap: two selects.
SORT_INSTRUCTIONS = 5
REPLAY_INSTRUCTIONS = 2


def _blocks(keys: torch.Tensor, payload: torch.Tensor):
    """(B, 128, 128) or (B, 16384) int32 keys and payload → both as
    contiguous (B, 16384)."""
    if keys.shape != payload.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and payload "
                         f"{tuple(payload.shape)} differ")
    if tuple(keys.shape[1:]) not in ((ROWS, LANES), (SLOTS,)):
        raise ValueError(f"expected (B, {ROWS}, {LANES}) or (B, {SLOTS}) "
                         f"blocks, got {tuple(keys.shape)}")
    for t in (keys, payload):
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32, got {t.dtype}")
    n = keys.shape[0]
    return (keys.reshape(n, SLOTS).contiguous(),
            payload.reshape(n, SLOTS).contiguous())


def bitonic_sort_blocks_ref(keys: torch.Tensor, payload: torch.Tensor,
                            record_masks: bool = False):
    """Plain version: the probe's network (``profile_pallas_sort.py:40-126``)
    in torch ops on each block's (128, 128) tile."""
    shape = keys.shape
    k, p = _blocks(keys, payload)
    n = k.shape[0]
    k = k.view(n, ROWS, LANES)
    p = p.view(n, ROWS, LANES)
    dev = k.device
    row = torch.arange(ROWS, device=dev, dtype=torch.int32).view(1, ROWS, 1)
    col = torch.arange(LANES, device=dev, dtype=torch.int32).view(1, 1, LANES)
    lin = row * LANES + col

    def partner(x, d):
        if d < LANES:
            return torch.where((col & d) != 0, torch.roll(x, d, dims=2),
                               torch.roll(x, LANES - d, dims=2))
        r = d // LANES
        return torch.where((row & r) != 0, torch.roll(x, r, dims=1),
                           torch.roll(x, ROWS - r, dims=1))

    planes = [None] * 4  # the swap masks, one bit a stage
    stage = 0
    for kk in range(1, LOG_SLOTS + 1):
        up = (lin & (1 << kk)) == 0
        for j in range(kk - 1, -1, -1):
            d = 1 << j
            k_part = partner(k, d)
            take_min = ((lin & d) == 0) == up
            k_new = torch.where(take_min, torch.minimum(k, k_part),
                                torch.maximum(k, k_part))
            swap = k_new != k
            p = torch.where(swap, partner(p, d), p)
            k = k_new
            if record_masks:
                w, b = divmod(stage, 32)
                bit = swap.to(torch.int32) << b
                planes[w] = bit if planes[w] is None else planes[w] | bit
            stage += 1
    if record_masks:
        for kk in range(LOG_SLOTS, 0, -1):  # the swaps in reverse
            for j in range(kk):
                stage -= 1
                w, b = divmod(stage, 32)
                swap = ((planes[w] >> b) & 1) != 0
                p = torch.where(swap, partner(p, 1 << j), p)
    return k.reshape(shape), p.reshape(shape)


@functools.lru_cache(maxsize=None)
def load_kernel() -> ctypes.CDLL:
    """Build ``csrc/bitonic_sort_kernel.cu`` at first use and bind it."""
    lib = load_cuda_library("bitonic_sort_kernel")
    lib.bitonic_sort_launch.restype = ctypes.c_int
    lib.bitonic_sort_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    timing.bind_attributes(lib, "bitonic_sort_attributes")
    lib.bitonic_sort_error_string.restype = ctypes.c_char_p
    lib.bitonic_sort_error_string.argtypes = [ctypes.c_int]
    return lib


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.data_ptr() % 16 else t  # 16-byte loads


def bitonic_sort_blocks(keys: torch.Tensor, payload: torch.Tensor,
                        record_masks: bool = False):
    """Sort each block's keys ascending with the payload routed along, or
    with ``record_masks`` replay the swaps so the payload returns to its
    input position; (B, 128, 128) or (B, 16384) int32 in, the same shapes
    out.  Keys unique within a block (see the module's docstring).

    A CPU tensor runs ``bitonic_sort_blocks_ref``.  A CUDA tensor launches
    the kernel once on the current stream and adds one to
    ``bitonic_sort_blocks.launches``."""
    shape = keys.shape
    k, p = _blocks(keys, payload)
    dev = _check_device(k, p)
    if dev.type == "cpu":
        return bitonic_sort_blocks_ref(keys, payload, record_masks)
    k, p = _aligned(k), _aligned(p)
    n = k.shape[0]
    ok, op = torch.empty_like(k), torch.empty_like(p)
    if n:
        _launch(load_kernel(), "bitonic_sort_launch", "bitonic_sort_error_string",
                dev, k.data_ptr(), p.data_ptr(), ok.data_ptr(), op.data_ptr(),
                n, int(record_masks))
        bitonic_sort_blocks.launches += 1
    return ok.reshape(shape), op.reshape(shape)


bitonic_sort_blocks.launches = 0


def sort_attributes(record_masks: bool, device="cuda") -> Dict:
    """Registers, shared memory and CTAs per SM of one variant."""
    return timing.attributes(load_kernel, "bitonic_sort_attributes",
                             "bitonic_sort_error_string", int(record_masks),
                             torch.device(device))


def probe_blocks(n: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The probe's data (``profile_pallas_sort.py:167-172``): (n, 16384)
    int32 keys ``(bucket << 14) | position`` with 16-bit buckets, and
    uniform int32 payload."""
    rng = np.random.default_rng(seed)
    pos = np.tile(np.arange(SLOTS, dtype=np.int64), (n, 1))
    bucket = rng.integers(0, 1 << 16, size=(n, SLOTS), dtype=np.int64)
    keys = ((bucket << LOG_SLOTS) | pos).astype(np.int32)
    payload = rng.integers(-(2**31), 2**31, size=(n, SLOTS)).astype(np.int32)
    return keys, payload


def sort_gather(keys: torch.Tensor, payload: torch.Tensor):
    """The library's answer: a stable ``torch.sort`` of each block's keys and
    ``torch.gather`` of the payload."""
    sk, order = torch.sort(keys, dim=1, stable=True)
    return sk, torch.gather(payload, 1, order)


def sort_bounds(n_blocks: int, dev: torch.device) -> Dict:
    """Bytes bound of a sort (keys and payload in, both out) and the issue
    bounds of the sort and of sort + replay."""
    pairs = STAGES * (SLOTS // 2) * n_blocks
    return {
        "bytes_bound_ms": timing.bytes_bound_ms(4 * 4 * SLOTS * n_blocks),
        "issue_bound_ms": timing.issue_bound_ms(SORT_INSTRUCTIONS * pairs, dev),
        "replay_issue_bound_ms": timing.issue_bound_ms(
            (SORT_INSTRUCTIONS + REPLAY_INSTRUCTIONS) * pairs, dev),
        "issue_counts": (f"{SORT_INSTRUCTIONS} lane instructions per "
                         f"compare-exchange (1 compare, 4 selects), "
                         f"{REPLAY_INSTRUCTIONS} per replayed swap; "
                         f"{pairs} compare-exchanges"),
    }


def run_bitonic_sort(device="cuda", blocks: int = 2048, check_blocks: int = 8,
                     runs: int = 4, reps: int = 8, output: Optional[str] = None,
                     seed: int = 0) -> Dict:
    """The probe's rows on ``blocks`` blocks of its data (seed ``seed``):
    the sort and the sort + replay held to ``torch.sort`` + ``torch.gather``
    and the input payload on the first ``check_blocks``, then timed with
    ``torch.sort`` keys-only and sort + gather as the library rows, and the
    plain version (one call a run).  Returns the result and writes it to
    ``output`` if given."""
    dev = bench_device(device)
    cuda = dev.type == "cuda"
    key_np, pay_np = probe_blocks(blocks, seed)
    keys = torch.from_numpy(key_np).to(dev)
    pay = torch.from_numpy(pay_np).to(dev)
    del key_np, pay_np

    # -- correctness on a small batch, then the replay --------------------
    ck, cp = keys[:check_blocks], pay[:check_blocks]
    want_k, want_p = sort_gather(ck, cp)
    got_k, got_p = bitonic_sort_blocks(ck, cp)
    if not (torch.equal(got_k, want_k) and torch.equal(got_p, want_p)):
        raise AssertionError("sort differs from torch.sort + torch.gather")
    rk, rp = bitonic_sort_blocks(ck, cp, record_masks=True)
    if not (torch.equal(rk, want_k) and torch.equal(rp, cp)):
        raise AssertionError("replay: the payload did not return to its input")
    print(f"correctness OK (vs torch.sort + torch.gather, {check_blocks} "
          "blocks); sort+replay: keys sorted, payload returned to its input",
          flush=True)
    del want_k, want_p, got_k, got_p, rk, rp

    guard = bitonic_sort_blocks if cuda else None
    x = (keys, pay)
    steps = {
        "bitonic sort 2-op": (lambda a: bitonic_sort_blocks(*a), reps, guard),
        "bitonic sort 2-op + reverse replay": (
            lambda a: bitonic_sort_blocks(*a, record_masks=True), reps, guard),
        "torch.sort keys only": (
            lambda a: torch.sort(a[0], dim=1, stable=True), reps, None),
        "torch.sort + torch.gather": (lambda a: sort_gather(*a), reps, None),
        "plain version (torch ops)": (
            lambda a: bitonic_sort_blocks_ref(*a), 1, None),
    }
    key = timing.timer_key(dev)
    bounds = sort_bounds(blocks, dev)
    elems = blocks * SLOTS
    rows = []
    for label, (fn, n_reps, kernel) in steps.items():
        ms = timing.time_ms(fn, x, dev, reps=n_reps, runs=runs, kernel=kernel)
        row = {"row": label, key: ms, "melem_s": elems / ms / 1e3}
        if "bitonic" in label:
            row.update(sort_attributes("replay" in label, dev))
        rows.append(row)
        extra = "" if row.get("registers") is None else (
            f"  regs {row['registers']}  smem {row['shared_bytes']}  "
            f"ctas/SM {row['ctas_per_sm']}")
        print(f"{label:36s} {ms:9.4f} ms ({row['melem_s']:9.1f} M elem/s)"
              + extra, flush=True)
    t = {r["row"]: r[key] for r in rows}
    result = {
        "blocks": blocks,
        "slots": SLOTS,
        "check_blocks": check_blocks,
        "runs": runs,
        "reps": reps,
        "seed": seed,
        "backend": dev.type,
        "timer": "cuda events" if cuda else "host clock",
        **device_record(dev),
        **bounds,
        "rows": rows,
        "replay_over_sort": t["bitonic sort 2-op + reverse replay"]
        / t["bitonic sort 2-op"],
        "sort_over_torch_sort_gather": t["bitonic sort 2-op"]
        / t["torch.sort + torch.gather"],
    }
    issue = bounds["issue_bound_ms"]
    print(f"bounds: bytes {bounds['bytes_bound_ms']:.4f} ms"
          + ("" if issue is None else
             f", issue {issue:.4f} ms, with replay "
             f"{bounds['replay_issue_bound_ms']:.4f} ms "
             f"({bounds['issue_counts']})")
          + f"; replay / sort {result['replay_over_sort']:.3f}, sort / "
          f"(torch.sort + gather) {result['sort_over_torch_sort_gather']:.3f}")
    return timing.write_result(result, output)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m lz4jpeg_tpu_torch.profiles.bitonic_sort",
        description="The matcher's block sort with payload and its reverse "
                    "replay against torch.sort.")
    ap.add_argument("--blocks", type=int, default=2048)
    ap.add_argument("--check-blocks", type=int, default=8)
    timing.add_arguments(ap)
    args = ap.parse_args(argv)
    run_bitonic_sort(args.device, args.blocks, args.check_blocks, args.runs,
                     args.reps, args.output, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
