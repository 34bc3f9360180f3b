"""The matcher sort's compile-time schedule (``lz4jpeg_tpu_torch/csrc/
bitonic_sort_kernel.cu``), mirrored in numpy by ``profiles/bitonic_sort.py``
and checked on the CPU.

The mirror gives each layout's (thread, register) → slot map and the
kernel's own shared-memory address arithmetic, each stage's route (between
registers or by shuffle) and each exchange's wait (a warp, a named barrier
for an aligned group, or the CTA).  ``emulate_sort`` runs that schedule as
the kernel's threads would, masks a byte a (stage, thread) with the shuffle
stages' lower/upper split, and the replay in reverse; it must equal the
plain version ``bitonic_sort_blocks_ref`` (the TPU probe's network, held to
the Pallas kernel by ``tests/test_torch_matcher_sorts.py``).  A race check
over every thread's buffer accesses and waits proves each exchange's flow
stays inside the group its wait covers.

Tolerance: none.  Every comparison is exact equality of int32 arrays.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.profiles import bitonic_sort as bs

SOURCE = (Path(__file__).resolve().parents[1] / "lz4jpeg_tpu_torch" / "csrc"
          / "bitonic_sort_kernel.cu")
LAYOUTS = [("B", 0), ("T", 0)] + [("X", kk) for kk in range(10, 15)]


def test_mirror_constants_are_the_sources():
    text = SOURCE.read_text()
    found = {k: int(v) for k, v in re.findall(
        r"constexpr int k(Threads|FirstExchangeMerge) = (\d+);", text)}
    assert found == {"Threads": bs.THREADS,
                     "FirstExchangeMerge": bs.FIRST_EXCHANGE_MERGE}
    assert "return record ? static_cast<size_t>(kSlots) * 4 +" in text
    assert "return slot ^ (((slot >> 5) & 3) << 2) ^ (((slot >> 13) & 1) << 4);" \
        in text
    assert "constexpr int log_threads = KK <= 11 ? 7 : KK - 4;" in text
    assert "constexpr int first = KK <= 11 ? 1 : (KK == 12 ? 9 : 13);" in text


@pytest.mark.parametrize("layout,kk", LAYOUTS)
def test_layouts_are_bijections_at_the_swizzled_words(layout, kk):
    slots = bs.layout_slots(layout, kk)
    assert slots.shape == (bs.THREADS, bs.PER_THREAD)
    assert np.array_equal(np.sort(slots.ravel()), np.arange(bs.SLOTS))
    words = bs.layout_words(layout, kk)
    assert np.array_equal(words, bs.swizzle(slots))
    assert np.array_equal(np.sort(words.ravel()), np.arange(bs.SLOTS))


@pytest.mark.parametrize("layout,kk", LAYOUTS)
def test_layout_accesses_touch_each_bank_once_a_wavefront(layout, kk):
    words = bs.layout_words(layout, kk).reshape(32, 32, bs.PER_THREAD)
    if layout == "B":  # 16-byte accesses: 8 lanes a wavefront, 8 units
        units = words[:, :, ::4] >> 2  # (warp, lane, quad)
        for phase in range(4):
            u = units[:, 8 * phase:8 * phase + 8] % 8
            assert all(len(set(u[w, :, q])) == 8
                       for w in range(32) for q in range(4))
    else:  # 4-byte accesses: 32 lanes, 32 banks
        banks = words % 32
        assert all(len(set(banks[w, :, r])) == 32
                   for w in range(32) for r in range(bs.PER_THREAD))


def test_schedule_routes_and_waits():
    steps = bs.sort_schedule()
    stages = [s for s in steps if s["kind"] == "stage"]
    assert sorted(s["stage"] for s in stages) == list(range(bs.STAGES))
    assert [s["stage"] for s in stages] == list(range(bs.STAGES))
    routes = [s["route"] for s in stages]
    assert routes.count("register") == 84 and routes.count("shuffle") == 21
    # merges up to 2^9 stay in B, strides 16-256 by shuffles
    for s in stages:
        if s["merge"] < bs.FIRST_EXCHANGE_MERGE:
            assert s["layout"][0] == "B"
            assert (s["route"] == "shuffle") == (s["j"] >= 4)
        if s["route"] == "shuffle":
            assert (s["layout"][0], s["j"]) in (("B", 4), ("B", 5), ("B", 6),
                                                ("B", 7), ("B", 8), ("X", 13))
    ex = [s for s in steps if s["kind"] == "exchange"]
    assert [(e["from"][0], e["to"][0]) for e in ex] == [("B", "X"), ("X", "T"),
                                                        ("T", "B")] * 5
    scopes = [e["sync"][0] for e in ex]
    assert scopes.count("cta") == 2 and scopes.count("group") == 8
    assert scopes.count("warp") == 5
    assert scopes.count("cta") <= 11  # K2's CTA-wide barriers


@pytest.mark.parametrize("kk", range(10, 15))
def test_each_exchange_flows_inside_its_group(kk):
    tid = np.arange(bs.THREADS)
    for e in (s for s in bs.sort_schedule()
              if s["kind"] == "exchange" and s["merge"] == kk):
        holder = np.empty(bs.SLOTS, dtype=np.int64)
        holder[bs.layout_slots(*e["from"]).ravel()] = np.repeat(
            tid, bs.PER_THREAD)
        dst = bs.layout_slots(*e["to"])
        src_thread = holder[dst]  # (thread, register) ← the thread it came from
        group = bs._group_of(e["sync"], tid)
        assert np.array_equal(group[src_thread], np.repeat(
            group[:, None], bs.PER_THREAD, axis=1)), e
        # and the data of merge kk only flows inside its 2^(kk-4) threads
        assert np.array_equal(src_thread >> (kk - 4),
                              np.repeat((tid >> (kk - 4))[:, None],
                                        bs.PER_THREAD, axis=1))


@pytest.mark.parametrize("record", [False, True])
def test_no_exchange_buffer_races(record):
    assert bs.buffer_races(bs.buffer_program(record)) == []


@pytest.mark.parametrize("narrowed", ["group to warp", "warp dropped"])
def test_the_race_check_sees_a_missing_wait(narrowed):
    prog = bs.buffer_program(True)
    if narrowed == "group to warp":
        prog = [("sync", ("warp", 32, None), ev[2])
                if ev[0] == "sync" and ev[2] == 12 else ev for ev in prog]
    else:
        half = len(prog) // 2
        prog = [ev for i, ev in enumerate(prog)
                if not (i > half and ev[0] == "sync" and ev[1][0] == "warp")]
    assert bs.buffer_races(prog)


def test_named_barriers_are_distinct_per_group():
    ids = bs.barrier_ids()
    assert set(ids) == set(range(15))
    assert all(len(groups) == 1 for groups in ids.values())
    assert len(ids[0].pop()) == bs.THREADS


def test_replay_masks_and_buffers_fit():
    assert bs.smem_bytes(False) == 131_072 <= bs.SMEM_LIMIT
    # a byte a thread for each of the 105 stages beside one buffer
    assert bs.smem_bytes(True) == 65_536 + 105 * 1024 == 173_056
    assert bs.smem_bytes(True) <= bs.SMEM_LIMIT
    # beside both buffers they would not fit: the reason for one
    assert bs.SLOTS * 8 + bs.STAGES * bs.THREADS > bs.SMEM_LIMIT


@pytest.mark.parametrize("record", [False, True])
def test_buffer_program_waits(record):
    syncs = [ev[1][0] for ev in bs.buffer_program(record) if ev[0] == "sync"]
    # each exchange waits once, or three times when keys and payload share
    # the buffer; the replay once an exchange
    forward = 3 if record else 1
    assert syncs.count("cta") == 2 * forward + (2 if record else 0)
    assert syncs.count("group") == 8 * forward + (8 if record else 0)
    assert syncs.count("warp") == 5 * forward + (5 if record else 0)


def _crafted():
    pos = np.arange(bs.SLOTS, dtype=np.int64)
    return {
        "sorted": (pos << bs.LOG_SLOTS) | pos,
        "reversed": (pos[::-1] << bs.LOG_SLOTS) | pos,
        "all-same-bucket": (np.full(bs.SLOTS, 12345, np.int64)
                            << bs.LOG_SLOTS) | pos[::-1],
    }


@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("case", ["probe", "duplicates", "crafted"])
def test_mirror_equals_the_plain_version(case, record):
    keys, pay = bs.probe_blocks(2, seed=11)
    if case == "duplicates":
        keys = np.random.default_rng(4).integers(0, 7, keys.shape,
                                                 dtype=np.int64).astype(np.int32)
    elif case == "crafted":
        keys = np.stack(list(_crafted().values())).astype(np.int32)
        pay = np.concatenate([pay, pay[:1]])
    got_k, got_p = bs.emulate_sort(keys, pay, record)
    want_k, want_p = bs.bitonic_sort_blocks_ref(torch.from_numpy(keys),
                                                torch.from_numpy(pay), record)
    np.testing.assert_array_equal(got_k, want_k.numpy())
    np.testing.assert_array_equal(got_p, want_p.numpy())
    np.testing.assert_array_equal(got_k, np.sort(keys, axis=1))
    if record:
        np.testing.assert_array_equal(got_p, pay)


# ---------------------------------------------------------------------------
# The compute-sanitizer runner (profiles/sanitize.py): its verdicts, and
# checkers that call the sources' own entry points
# ---------------------------------------------------------------------------


def test_sanitizer_verdicts():
    from lz4jpeg_tpu_torch.profiles import sanitize

    assert sanitize.verdict("racecheck", "setup failed: unknown error at 74", 2) \
        == "unavailable"
    assert sanitize.verdict("racecheck", "========= 1 hazard displayed", 3) \
        == "hazard"  # no set-up failure of the checker's own: the tool's
    assert sanitize.verdict("synccheck", "launch failed: unspecified launch "
                            "failure at 81\n========= ERROR SUMMARY: 1 "
                            "error", 3) == "hazard"
    unsupported = ("========= Error: Device not supported. Please refer to "
                   "the \"Supported Devices\" section\n========= Error: "
                   "process didn't terminate successfully")
    assert sanitize.verdict("racecheck", unsupported, 3) == "unavailable"
    assert sanitize.verdict("racecheck", "launch failed: unknown error at 81\n"
                            + unsupported, 3) == "hazard"
    assert sanitize.verdict(None, unsupported, 3) == "hazard"
    assert sanitize.verdict(None, "setup failed: out of memory at 74", 2) \
        == "hazard"
    assert sanitize.verdict("synccheck", "launched\nsort blocks 1 record 0: "
                            "checked\n========= ERROR SUMMARY: 0 errors", 0) \
        == "clean"
    assert sanitize.verdict("racecheck", "launched\nsort blocks 1 record 0: "
                            "checked\n========= ERROR SUMMARY: 2 errors", 3) \
        == "hazard"
    assert sanitize.verdict(None, "launched\nunsorted at 17", 1) == "hazard"
    out = ("========= COMPUTE-SANITIZER\n========= Program hit cudaErrorUnknown"
           " on CUDA API call to cudaMalloc.\n=========     Saved host "
           "backtrace\nsetup failed: unknown error at 74\n========= Target "
           "application returned an error\n========= ERROR SUMMARY: 1 error")
    assert sanitize.evidence(out, tool_lines=2) == [
        "setup failed: unknown error at 74", "========= COMPUTE-SANITIZER",
        "========= Program hit cudaErrorUnknown on CUDA API call to cudaMalloc."]
    assert "bitonic_sort_launch(dk, dp, dok, dop, blocks, record, nullptr)" \
        in sanitize.SORT_CHECKER
    assert "rle_membership_launch(dw, dl, dout, rows, seg, seg, nullptr)" \
        in sanitize.MEMBERSHIP_CHECKER
    assert set(sanitize.CASES) == {"bitonic_sort_kernel", "rle_membership_kernel"}
