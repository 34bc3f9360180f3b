"""The concentration kernel's plan (``lz4jpeg_tpu_torch/csrc/
stage_rate_kernel.cu``), mirrored in numpy by ``profiles/bucket_partition.py``
and checked on the CPU.

The mirror gives a thread's in-place register update of one stage (the
columns in chains c = r, r + step, ..., ascending), the kernel's step order
(the seven steps as one body run five times, left after the fourth stage of
the fifth), each lane's 16-byte shared loads of its row padded to 528 bytes,
each lane's bulk copy, and the persistent grid's thread-to-row map.  The
update must equal the plain version ``concentration_stages_ref`` (the TPU
probe's roll expressions, held to the Pallas kernel by
``tests/test_torch_matcher_sorts.py``) stage by stage and over all 32
stages, on the probe's data and on crafted rows; the loads must be free of
bank conflicts; every copy a multiple of 16 bytes; every row taken by
exactly one thread.

Tolerance: none.  Every comparison is exact equality of int32 arrays.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.profiles import bucket_partition as bp

SOURCE = (Path(__file__).resolve().parents[1] / "lz4jpeg_tpu_torch" / "csrc"
          / "stage_rate_kernel.cu")
STEPS = [1 << b for b in range(7)]
CRAFTED = list(bp.crafted_rows())
RESIDENT_BLOCKS = bp.H100_SMS * bp.CONC_CTAS_PER_SM * bp.CONC_WARPS \
    * bp.TILE_ROWS // bp.ROWS  # one pass of every resident warp: 396


def plain_stage(w: torch.Tensor, step: int) -> torch.Tensor:
    """One stage of ``probe_bucket_partition.py:48-56`` in torch ops."""
    col = torch.arange(bp.LANES, dtype=torch.int32)
    incoming = torch.roll(w, bp.LANES - step, dims=-1)
    arrive = (col < bp.LANES - step) & ((incoming & 1) != 0) \
        & ((incoming & step) != 0)
    depart = ((w & 1) != 0) & ((w & step) != 0)
    return torch.where(arrive, incoming - step,
                       torch.where(depart, torch.zeros_like(w), w))


def test_mirror_constants_are_the_sources():
    text = SOURCE.read_text()
    plan = text[text.index("namespace conc {"):]
    plan = plan[:plan.index("}  // namespace conc")]
    found = {k: int(v) for k, v in re.findall(
        r"constexpr int k(Warps|CtasPerSm|TileRows) = (\d+);", plan)}
    assert found == {"Warps": bp.CONC_WARPS, "CtasPerSm": bp.CONC_CTAS_PER_SM,
                     "TileRows": bp.TILE_ROWS}
    assert "constexpr int kRowBytes = kLanes * 4;" in plan
    assert "constexpr int kPitch = kRowBytes + 16;" in plan
    # moves: lop3 with the table of ~a & b (a = 0xF0, b = 0xCC), then == 0,
    # which is the mirror's (v & m) == m.
    assert 'asm("lop3.b32 %0, %1, %2, 0, 0x0c;" : "=r"(rest) : "r"(v), ' \
           '"n"(1 | S));\n  return rest == 0;' in text
    assert ~0xF0 & 0xCC & 0xFF == 0x0C
    assert "w[c] = arrives ? w[c + S] - S : (leaves ? 0 : w[c]);" in text
    assert "for (int c = r; c < kLanes; c += S) {" in text
    assert "concentration_stages<0, kStages % 7>(w);\n" \
           "      if (i == kStages / 7) break;\n" \
           "      __syncthreads();\n" \
           "      concentration_stages<kStages % 7, 7>(w);" in text
    # Warp w of CTA b takes tiles 4 b + w, 4 (b + grid) + w, ...
    assert "const int first = blockIdx.x * conc::kWarps;\n" \
           "  for (int t = first + warp; first < tiles; " \
           "t += gridDim.x * conc::kWarps) {" in text


def test_step_order_is_the_probes():
    assert bp.stage_steps() == [1 << (b % 7) for b in range(bp.STAGES)]


@pytest.mark.parametrize("step", STEPS)
def test_in_place_update_is_one_plain_stage(step):
    x = bp.probe_tiles(1, seed=step).numpy()
    rows = np.concatenate([x[0], *bp.crafted_rows().values()])
    w = rows.copy()
    bp.concentration_update(w, step)
    want = plain_stage(torch.from_numpy(rows), step).numpy()
    assert np.array_equal(w, want)
    assert not np.array_equal(w, rows)


@pytest.mark.parametrize("blocks,seed", [(1, 0), (2, 3)])
def test_emulation_equals_the_plain_version(blocks, seed):
    x = bp.probe_tiles(blocks, seed)
    want = bp.concentration_stages_ref(x).numpy()
    assert np.array_equal(bp.emulate_concentration(x.numpy()), want)


@pytest.mark.parametrize("kind", CRAFTED)
def test_emulation_on_crafted_rows(kind):
    rows = bp.crafted_rows()[kind]
    want = bp.concentration_stages_ref(
        torch.from_numpy(np.resize(rows, (bp.ROWS, bp.LANES))[None]))
    got = bp.emulate_concentration(rows)
    assert np.array_equal(got, want.numpy()[0, :len(rows)])


def test_crafted_tiles_hold_every_crafted_row():
    tiles = bp.crafted_tiles().numpy()
    assert tiles.shape == (1, bp.ROWS, bp.LANES) and tiles.dtype == np.int32
    rows = np.concatenate(list(bp.crafted_rows().values()))
    assert np.array_equal(tiles[0, :len(rows)], rows)
    assert tiles.min() == -(1 << 31) and tiles.max() == (1 << 31) - 1


def test_shared_accesses_are_free_of_bank_conflicts():
    """A 16-byte access serves a quarter-warp a wavefront: its 8 lanes must
    hit 8 distinct 16-byte groups of the 32 banks."""
    chunks = np.stack([bp.row_chunks(lane) for lane in range(32)])
    assert chunks.shape == (32, bp.ROW_BYTES // 16)
    assert (chunks % 16 == 0).all()
    for k in range(chunks.shape[1]):
        for q in range(4):
            groups = (chunks[8 * q:8 * q + 8, k] // 16) % 8
            assert len(set(groups.tolist())) == 8, (k, q)


def test_padded_rows_do_not_overlap():
    spans = [(bp.row_chunks(lane)[0], bp.row_chunks(lane)[-1] + 16)
             for lane in range(32)]
    for (a, b), (c, _) in zip(spans, spans[1:]):
        assert b - a == bp.ROW_BYTES and b <= c
    assert spans[-1][1] <= bp.TILE_ROWS * bp.PITCH


@pytest.mark.parametrize("n_rows", [1, 31, 33, 128, 4096 + 17])
def test_bulk_copies_are_16_byte_multiples(n_rows):
    tiles = -(-n_rows // bp.TILE_ROWS)
    seen = []
    for tile in range(tiles):
        copies = bp.bulk_copies(tile, n_rows)
        assert 1 <= len(copies) <= bp.TILE_ROWS
        for src, dst, size in copies:
            assert src % 16 == 0 and dst % 16 == 0 and size % 16 == 0
            assert size == bp.ROW_BYTES
            assert dst + size <= bp.TILE_ROWS * bp.PITCH
            seen.append(src // bp.ROW_BYTES)
    assert seen == list(range(n_rows))


@pytest.mark.parametrize("blocks", [1, 255, 256, 257, 2048,
                                    RESIDENT_BLOCKS - 1, RESIDENT_BLOCKS,
                                    RESIDENT_BLOCKS + 1])
def test_grid_takes_each_row_once(blocks):
    plan = bp.concentration_plan(blocks)
    rows = plan["thread_rows"]
    taken = np.sort(rows[rows >= 0])
    assert np.array_equal(taken, np.arange(blocks * bp.ROWS))
    assert plan["ctas"] <= bp.H100_SMS * bp.CONC_CTAS_PER_SM
    assert plan["ctas"] * bp.CONC_WARPS * bp.TILE_ROWS >= min(
        blocks * bp.ROWS, RESIDENT_BLOCKS * bp.ROWS)
    # At each pass a warp's lanes take the consecutive rows of one tile.
    first = rows[:, :, :1, :]
    live = np.broadcast_to(first >= 0, rows.shape)
    lanes = np.arange(bp.TILE_ROWS).reshape(1, 1, -1, 1)
    assert (first[first >= 0] % bp.TILE_ROWS == 0).all()
    assert np.array_equal(rows[live], (first + lanes)[live])
    assert (rows[~live] == -1).all()


def test_one_resident_wave_is_396_blocks():
    assert RESIDENT_BLOCKS == 396
    assert bp.concentration_plan(RESIDENT_BLOCKS)["passes"] == 1
    assert bp.concentration_plan(RESIDENT_BLOCKS + 1)["passes"] == 2
    assert bp.concentration_plan(2048)["passes"] == -(-2048 // 396)


def test_sass_counts_take_each_kernels_converged_loop(monkeypatch):
    """``stage_sass_counts`` on a stand-in for the SASS loop parser: the
    longest innermost loop of each kernel of ``SASS_LOOPS`` that is not the
    copy for a diverged warp, over the stage-elements of one pass; other
    kernels (the direct-load concentration) are left out."""
    from lz4jpeg_tpu_torch.profiles import sass_loops

    def loop(length, *ops):
        return {"length": length, "mix": {op: 1 for op in ops}}

    found = {
        "void <unnamed>::concentration_kernel<(bool)1>(const int *, int *, "
        "long long)": [loop(3, "SYNCS"), loop(2568, "LOP3")],
        "void <unnamed>::concentration_kernel<(bool)0>(const int *, int *, "
        "long long)": [loop(9999, "LOP3")],
        "void <unnamed>::stage_rate_kernel<(int)1>(const int *, int *, "
        "long long)": [loop(345, "SHFL"), loop(746, "SHFL", "ENDCOLLECTIVE")],
    }
    seen = []

    def fake(source, root):
        seen.append((source, root))
        return found

    monkeypatch.setattr(sass_loops, "source_loops", fake)
    counts = bp.stage_sass_counts("elsewhere")
    assert seen == [("stage_rate_kernel", "elsewhere")]
    assert counts == {bp.CONCENTRATION: 2568 / 896,
                      bp.COMPARE_EXCHANGE: 345 / 128}


@pytest.mark.parametrize("given", [False, True])
def test_stage_runner_takes_the_sass_floor_from_the_counts(monkeypatch, given):
    """The runner's SASS floor is the issue floor at the counts it is given
    (or counts itself on the card); with no issue rate it carries none."""
    from lz4jpeg_tpu_torch.profiles import timing

    counted = {bp.CONCENTRATION: 2.5, bp.COMPARE_EXCHANGE: 2.25}
    monkeypatch.setattr(bp, "stage_sass_counts", lambda root=None: counted)
    res = bp.run_bucket_partition("cpu", blocks=(1,), runs=1, reps=1,
                                  sass_counts=counted if given else None)
    for rec in res["sizes"][0]["kernels"].values():
        assert "sass_issue_bound_ms" not in rec and "sass_counts" not in rec
    # a stand-in issue rate of one lane instruction a millisecond
    monkeypatch.setattr(timing, "issue_bound_ms", lambda n, dev: float(n))
    res = bp.run_bucket_partition("cpu", blocks=(1,), runs=1, reps=1,
                                  sass_counts=counted if given else None)
    elements = bp.STAGES * bp.ROWS * bp.LANES
    for name, rec in res["sizes"][0]["kernels"].items():
        kind = bp.KERNELS[name][0]
        assert rec["issue_bound_ms"] == bp.INSTRUCTIONS[kind] * elements
        if given:
            assert rec["sass_issue_bound_ms"] == counted[kind] * elements
            assert rec["sass_counts"].startswith(f"{counted[kind]:.4f} ")
        else:  # on the CPU nothing is counted
            assert "sass_issue_bound_ms" not in rec


def test_sass_loops_count_every_opcode():
    from lz4jpeg_tpu_torch.profiles import sass_loops

    ins = ["LOP3.LUT P0, RZ, R3, 0x5, RZ, 0xc, !PT", "@!P0 VIADD R4, R5, -0x4",
           "SEL R3, R3, RZ, P0", "LOP3.LUT P1, RZ, R5, 0x5, RZ, 0xc, !PT",
           "@!PT LDS RZ, [RZ]", "@P2 BRA 0x0", "EXIT"]
    (loop,) = sass_loops.loops(ins)
    assert loop["length"] == 5
    assert loop["mix"] == {"LOP3": 2, "VIADD": 1, "SEL": 1, "BRA": 1}
