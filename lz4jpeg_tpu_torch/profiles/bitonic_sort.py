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


# ---------------------------------------------------------------------------
# The kernel's compile-time schedule, mirrored in numpy
# (csrc/bitonic_sort_kernel.cu; the constants are the source's k* ones)
# ---------------------------------------------------------------------------

THREADS = 1024
PER_THREAD = SLOTS // THREADS  # 16
FIRST_EXCHANGE_MERGE = 10  # merges 2^10 and up leave layout B
SMEM_LIMIT = 227 * 1024  # the most dynamic shared memory a CTA may take


def smem_bytes(record: bool) -> int:
    """The kernel's dynamic shared memory: two 64 KiB exchange buffers, or
    with the replay one and a byte a thread a stage."""
    return SLOTS * 4 + STAGES * THREADS if record else SLOTS * 8


def stage_index(kk: int, j: int) -> int:
    """Stage number of stride 2^j in merge kk (stages run from j = kk-1
    down to 0)."""
    return kk * (kk - 1) // 2 + (kk - 1 - j)


def swizzle(slot):
    """The word a slot takes in an exchange buffer."""
    return slot ^ (((slot >> 5) & 3) << 2) ^ (((slot >> 13) & 1) << 4)


def layout_slots(layout: str, kk: int = 0) -> np.ndarray:
    """(THREADS, PER_THREAD) slot of each (thread, register) in layout
    ``"B"``, ``"T"`` or ``"X"`` (merge ``kk``'s)."""
    tid = np.arange(THREADS)[:, None]
    r = np.arange(PER_THREAD)[None, :]
    lane, warp = tid & 31, tid >> 5
    if layout == "B":
        return 16 * tid + r
    if layout == "T":
        return 512 * warp + 32 * r + lane
    if kk == LOG_SLOTS:
        return (lane & 15) | ((lane >> 4) << 13) | (warp << 4) | (r << 9)
    xs = kk - 4
    return (tid & ((1 << xs) - 1)) | ((tid >> xs) << (xs + 4)) | (r << xs)


def layout_words(layout: str, kk: int = 0) -> np.ndarray:
    """The word each (thread, register) reads and writes, by the kernel's own
    address arithmetic (``store_b``/``load_b``, ``move_t``, ``move_x``)."""
    tid = np.arange(THREADS)[:, None]
    r = np.arange(PER_THREAD)[None, :]
    if layout == "B":
        return 4 * ((swizzle(16 * tid) >> 2) ^ (r >> 2)) + (r & 3)
    if layout == "T":
        base = swizzle((tid >> 5) * 512 + (tid & 31))
        return (base ^ ((r & 3) << 2)) + 32 * r
    xs = 9 if kk == LOG_SLOTS else kk - 4
    part = layout_slots("X", kk)[:, :1]  # register 0 holds the thread's bits
    return (swizzle(part) ^ (((r & 1) << 3) if xs == 6 else 0)) + (r << xs)


def register_bit(layout: str, kk: int, j: int) -> Optional[int]:
    """The register bit that holds slot bit j in a layout, else None."""
    slots = layout_slots(layout, kk)
    for q in range(4):
        if (slots[0, 1 << q] ^ slots[0, 0]) == 1 << j:
            return q
    return None


def lane_mask(layout: str, kk: int, j: int) -> Optional[int]:
    """The lane bit that holds slot bit j in a layout, else None."""
    slots = layout_slots(layout, kk)
    for m in (1, 2, 4, 8, 16):
        if (slots[m, 0] ^ slots[0, 0]) == 1 << j:
            return m
    return None


def sync_scope(kk: int):
    """(name, threads a group, first barrier id) of the wait between the
    cross-warp exchanges of merge kk: the CTA (barrier 0) at merge 14, else
    a named barrier per aligned group."""
    if kk == LOG_SLOTS:
        return ("cta", THREADS, 0)
    log = 7 if kk <= 11 else kk - 4
    first = 1 if kk <= 11 else (9 if kk == 12 else 13)
    return ("group", 1 << log, first)


def sort_schedule():
    """The forward network as the kernel runs it: a list of steps, each a
    dict with ``kind`` "flip" (complement the keys for merge ``merge``),
    "stage" (``stage``, ``merge``, ``j``, ``layout``, ``route`` "register"
    with ``reg_bit`` or "shuffle" with ``lane_mask``) or "exchange"
    (``from``/``to`` layouts and ``sync``: ("warp", 32, None) or
    ``sync_scope``)."""
    steps = []

    def stage(kk, j, layout):
        q = register_bit(layout, kk, j)
        step = {"kind": "stage", "stage": stage_index(kk, j), "merge": kk,
                "j": j, "layout": (layout, kk)}
        if q is not None:
            step.update(route="register", reg_bit=q)
        else:
            step.update(route="shuffle", lane_mask=lane_mask(layout, kk, j))
        steps.append(step)

    def exchange(kk, src, dst, sync):
        steps.append({"kind": "exchange", "merge": kk, "from": src, "to": dst,
                      "sync": sync})

    for kk in range(1, LOG_SLOTS + 1):
        if kk >= 4:
            steps.append({"kind": "flip", "merge": kk})
        if kk < FIRST_EXCHANGE_MERGE:
            for j in range(kk - 1, -1, -1):
                stage(kk, j, "B")
            continue
        exchange(kk, ("B", kk), ("X", kk), sync_scope(kk))
        for j in range(kk - 1, 8, -1):
            stage(kk, j, "X")
        exchange(kk, ("X", kk), ("T", kk), sync_scope(kk))
        for j in range(8, 4, -1):
            stage(kk, j, "T")
        exchange(kk, ("T", kk), ("B", kk), ("warp", 32, None))
        for j in range(4, -1, -1):
            stage(kk, j, "B")
    return steps


def _pairs(q: int):
    """The register pairs (r, r | 2^q) of a register stage, in the kernel's
    bit order."""
    lo = [r for r in range(PER_THREAD) if not r & (1 << q)]
    return np.array(lo), np.array(lo) | (1 << q)


def emulate_sort(keys: np.ndarray, payload: np.ndarray,
                 record_masks: bool = False):
    """Run ``sort_schedule`` on (n, 16384) int32 blocks as the kernel's
    threads would: registers per (thread, register) of the current layout,
    exchanges as relayouts, masks a byte per (stage, thread) with the
    shuffle stages' lower/upper split, and with ``record_masks`` the replay
    in reverse.  Returns (keys, payload) like the kernel's outputs."""
    n = keys.shape[0]
    layout = layout_slots("B")
    k = keys.reshape(n, SLOTS)[:, layout].astype(np.int64)
    p = payload.reshape(n, SLOTS)[:, layout].astype(np.int64)
    masks = np.zeros((n, STAGES, THREADS), dtype=np.uint32)
    tid = np.arange(THREADS)
    steps = sort_schedule()

    def relayout(v, src, dst):
        full = np.empty((n, SLOTS), dtype=v.dtype)
        full[:, layout_slots(*src)] = v
        return full[:, layout_slots(*dst)]

    for step in steps:
        if step["kind"] == "flip":
            kk = step["merge"]
            s = layout_slots("B")
            flip = -((s >> kk) & 1) ^ (-((s >> (kk - 1)) & 1) if kk > 4 else 0)
            k = k ^ flip
        elif step["kind"] == "exchange":
            k = relayout(k, step["from"], step["to"])
            p = relayout(p, step["from"], step["to"])
        elif step["route"] == "register":
            lo, hi = _pairs(step["reg_bit"])
            a, b = k[:, :, lo], k[:, :, hi]
            if step["merge"] <= 3:  # plain keys: direction by register bit
                desc = (lo & (1 << step["merge"])) != 0
                swap = np.where(desc, a < b, a > b)
            else:
                swap = a > b
            k[:, :, lo], k[:, :, hi] = np.where(swap, b, a), np.where(swap, a, b)
            pa, pb = p[:, :, lo], p[:, :, hi]
            p[:, :, lo], p[:, :, hi] = (np.where(swap, pb, pa),
                                        np.where(swap, pa, pb))
            masks[:, step["stage"]] = (swap << np.arange(8)).sum(axis=2)
        else:
            m = step["lane_mask"]
            partner = tid ^ m
            lower = ((tid & m) == 0)[None, :, None]
            yk, yp = k[:, partner], p[:, partner]
            nk = np.where(lower, np.minimum(k, yk), np.maximum(k, yk))
            swap = nk != k
            p = np.where(swap, yp, p)
            k = nk
            bits = (swap << np.arange(PER_THREAD)).sum(axis=2)
            masks[:, step["stage"]] = np.where(lower[..., 0], bits & 0xFF,
                                               bits >> 8)
    out_k = np.empty((n, SLOTS), dtype=np.int32)
    out_k[:, layout_slots("B")] = k
    if record_masks:
        for step in reversed(steps):
            if step["kind"] == "exchange":
                p = relayout(p, step["to"], step["from"])
            elif step["kind"] == "stage" and step["route"] == "register":
                lo, hi = _pairs(step["reg_bit"])
                byte = masks[:, step["stage"]][..., None]
                swap = ((byte >> np.arange(8)) & 1) != 0
                pa, pb = p[:, :, lo], p[:, :, hi]
                p[:, :, lo], p[:, :, hi] = (np.where(swap, pb, pa),
                                            np.where(swap, pa, pb))
            elif step["kind"] == "stage":
                m = step["lane_mask"]
                byte = masks[:, step["stage"]]
                other = byte[:, tid ^ m]
                lower = (tid & m) == 0
                bits = np.where(lower, byte | (other << 8), other | (byte << 8))
                swap = ((bits[..., None] >> np.arange(PER_THREAD)) & 1) != 0
                p = np.where(swap, p[:, tid ^ m], p)
    out_p = np.empty((n, SLOTS), dtype=np.int32)
    out_p[:, layout_slots("B")] = p
    return out_k, out_p


def buffer_program(record_masks: bool = False):
    """Every thread's exchange-buffer accesses and waits in program order:
    a list of ("store" | "load", buffer, layout) and ("sync", scope, kk).
    The sort moves keys and payload through two buffers at once; with
    ``record_masks`` through one buffer in turn (a wait after the keys are
    read, and one after the payload is stored), then the replay moves the
    payload alone through it."""
    prog = []
    for step in sort_schedule():
        if step["kind"] != "exchange":
            continue
        sync = ("sync", step["sync"], step["merge"])
        if record_masks:
            prog += [("store", "keys", step["from"]), sync,
                     ("load", "keys", step["to"]), sync,
                     ("store", "keys", step["from"]), sync,
                     ("load", "keys", step["to"])]
        else:
            prog += [("store", "keys", step["from"]),
                     ("store", "payload", step["from"]), sync,
                     ("load", "keys", step["to"]),
                     ("load", "payload", step["to"])]
    if record_masks:
        for step in reversed(sort_schedule()):
            if step["kind"] != "exchange":
                continue
            prog += [("store", "keys", step["to"]),
                     ("sync", step["sync"], step["merge"]),
                     ("load", "keys", step["from"])]
    return prog


def _group_of(scope, tid):
    """The barrier a thread waits at under a sync scope, or its warp."""
    name, threads, first = scope
    if name == "warp":
        return tid >> 5
    return first + tid // threads


def buffer_races(prog):
    """Pairs of conflicting accesses to one word by two threads (a store
    and any access) with no wait both threads take between them, over a
    ``buffer_program``; [] when every exchange's flow stays inside the
    group its wait covers.  Each entry: (buffer, word, first access index,
    second access index)."""
    tid = np.arange(THREADS)
    syncs = [(i, ev[1]) for i, ev in enumerate(prog) if ev[0] == "sync"]
    races = []
    for buf in ("keys", "payload"):
        accesses = [(i, ev[0], layout_words(*ev[2])) for i, ev in
                    enumerate(prog) if ev[0] != "sync" and ev[1] == buf]
        # per word: the thread of each access (a layout is a bijection)
        owner = []
        for i, op, words in accesses:
            t = np.empty(SLOTS, dtype=np.int64)
            t[words.ravel()] = np.repeat(tid, PER_THREAD)
            owner.append((i, op, t))

        def ordered(a, ta, b, tb):
            ok = ta == tb
            for i, scope in syncs:
                if a < i < b:
                    ok |= _group_of(scope, ta) == _group_of(scope, tb)
            return ok

        last_store = None
        loads = []
        for i, op, t in owner:
            if op == "load":
                if last_store is not None:
                    bad = ~ordered(last_store[0], last_store[1], i, t)
                    races += [(buf, int(w), last_store[0], i)
                              for w in np.flatnonzero(bad)]
                loads.append((i, t))
            else:
                prior = loads + ([last_store] if last_store is not None else [])
                for j, tj in prior:
                    bad = ~ordered(j, tj, i, t)
                    races += [(buf, int(w), j, i) for w in np.flatnonzero(bad)]
                last_store, loads = (i, t), []
    return races


def barrier_ids():
    """{barrier id: the set of thread groups that wait at it} over the
    schedule (each group a frozenset of thread ids)."""
    ids = {}
    tid = np.arange(THREADS)
    for step in sort_schedule():
        if step["kind"] != "exchange" or step["sync"][0] == "warp":
            continue
        g = _group_of(step["sync"], tid)
        for b in np.unique(g):
            ids.setdefault(int(b), set()).add(frozenset(tid[g == b].tolist()))
    return ids


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
