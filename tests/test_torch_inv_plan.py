"""The inverse megakernel's maps (K9, ``csrc/inv_megakernel.cu``), mirrored
in numpy by ``lz4jpeg_tpu_torch/ops/inv_megakernel.py``, on the CPU.

The kernel runs on the card only.  What it computes is held here through
its mirror, each test naming the inputs it covers:

* the delta split (``split_deltas``) and the kernel's conversion of a word:
  every int16 word rebuilds exactly from bf16 parts hi and mid, and |Δ| <
  2⁸ needs hi alone;
* the vote (``products_issued``): which part products a warp's fragment
  issues, smallest first, and that they sum to the exact product;
* the maps: the k slots and output columns permutations, the operand
  fragments at the PTX A fragment's slots, every lane's accumulators
  holding the Y pair and the chroma samples its merge needs, the staged
  rows covering each output byte once, the shared accesses' wavefronts;
* the epilogue (``pixel_fast``): the parent's byte off the window; the
  merge (``merge``) equal to the torch merge;
* ``emulate`` (the maps composed with exact part products, a truncated
  k-step accumulation and the tie pass) equal to the parent chain's bytes
  (``parent_decode``) on noise buffers at quality 50, 75, 90 and 100, on
  ragged shapes and on crafted words; the tie window needed (without it
  some bytes differ) and enough (every such value inside it, the largest
  distance under a quarter of it; printed with ``-s``);
* the ring (``inverse_plan``, ``chunk_tiles``, ``chunk_schedule``): every
  unit once, each chunk's copy its units' tiles, every slot filled before
  it is read and released before it is refilled;
* the mirror's constants against the source.

Inputs come from numpy seeds; each test states its tolerance.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.models.jpeg import scaled_tables
from lz4jpeg_tpu_torch.ops import inv_megakernel as inv
from lz4jpeg_tpu_torch.ops.fwd_megakernel import forward_combined_ref
from lz4jpeg_tpu_torch.utils.parity import merge_rgb

SOURCE = (Path(inv.__file__).resolve().parent.parent / "csrc"
          / "inv_megakernel.cu")
CRAFTED_WORDS = (0, 1024, -512, -32768, 32767)


def _combined(b, h, w, quality, seed):
    """The (B, N, 128) combined buffer of seeded noise frames at
    ``quality`` (the plain forward; sparse16 at any quality), its tables
    and blocks."""
    rgb = np.random.default_rng(seed).integers(0, 256, (b, h, w, 3),
                                               dtype=np.uint8)
    tables = scaled_tables(quality)
    comb = forward_combined_ref(torch.from_numpy(rgb), tables["lum"],
                                tables["r"]).reshape(b, -1, 128)
    return comb.numpy(), tables, -(-h // 8), -(-w // 8)


def _is_bf16(x: np.ndarray) -> bool:
    return not (np.asarray(x, np.float32).view(np.uint32) & 0xFFFF).any()


# -- the split and the vote -----------------------------------------------------------


def test_every_word_rebuilds_from_hi_and_mid():
    """All 65,536 int16 words: Δ = hi + mid exactly, both bf16 values;
    |Δ| < 2⁸ has mid = 0; the kernel's conversion ((w ^ 0x8000) under 2²³'s
    exponent, less 2²³ + 33,792, −1024 selected to 0) gives Δ exactly."""
    w = np.arange(-2**15, 2**15, dtype=np.int64)
    d = inv.unbias(w)
    hi, mid = inv.split_deltas(d)
    assert _is_bf16(hi) and _is_bf16(mid)
    assert np.array_equal(hi.astype(np.int64) + mid.astype(np.int64), d)
    assert not mid[np.abs(d) < 2**8].any()
    assert mid[np.abs(d) >= 2**9].any()
    bits = (((w & 0xFFFF) ^ 0x8000) | 0x4B000000).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8_422_400.0)
    f = np.where(f == np.float32(-1024.0), np.float32(0.0), f)
    assert np.array_equal(f.astype(np.int64), d)


@pytest.mark.parametrize("live", [False, True])
def test_the_vote_issues_the_parts_a_fragment_needs(live):
    """Without a mid part: (hi, lo), (hi, mid), (hi, hi); with one, the mid
    part's three as well, each level (pa + pb) from 3 down, the mid part
    first within a level.  The issued products of the split deltas against
    the basis parts sum exactly (float64 holds each) to Δ · S."""
    order = inv.products_issued(live)
    levels = [pa + pb for pa, pb in order]
    assert levels == sorted(levels, reverse=True)
    assert order == ([(1, 2), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)] if live
                     else [(0, 2), (0, 1), (0, 0)])
    rng = np.random.default_rng(5)
    top = 2**15 if live else 2**8
    d = rng.integers(-top + 1, top, size=(40, 64))
    parts_d = inv.split_deltas(d)
    assert bool((parts_d[1] != 0).any()) == live
    s = inv.basis_arrays(inv.table_keys(scaled_tables(75)))["lum"]
    parts_s = inv.split_basis(s).astype(np.float64)
    total = sum(parts_d[pa].astype(np.float64) @ parts_s[pb].T
                for pa, pb in order)
    exact = [[sum(Fraction(int(x)) * Fraction(float(y))
                  for x, y in zip(row, srow)) for srow in s[:3]]
             for row in d[:3]]
    assert np.array_equal(total[:3, :3], np.array(exact, dtype=np.float64))


# -- the maps -------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [64, 32])
def test_slots_and_columns_fill_the_ptx_fragments(hw):
    """σ and the column map are permutations; the term a lane puts in each
    A register half sits at the slot the PTX A fragment gives that half,
    each (row, term) once; the basis parts in operand order rebuild the
    float32 basis."""
    sigma = inv.slot_map(hw)
    assert np.array_equal(np.sort(sigma), np.arange(hw))
    assert np.array_equal(np.sort(inv.column_map(hw)), np.arange(hw))
    fill, frag = inv.operand_map(hw), inv.a_fragment_slot(hw)
    assert np.array_equal(fill[..., 0], frag[..., 0])
    assert np.array_equal(sigma[fill[..., 1]], frag[..., 1])
    cells = (fill[..., 0] * hw + fill[..., 1]).ravel()
    assert np.array_equal(np.sort(cells), np.arange(16 * hw))
    keys = inv.table_keys(scaled_tables(90))
    name = "lum" if hw == 64 else "r"
    staged = inv.basis_parts(keys)[name]
    rebuilt = staged.sum(axis=0)[:, sigma]  # [column][term]
    want = inv.basis_arrays(keys)[name][inv.column_map(hw)]
    assert np.array_equal(rebuilt, want)


def test_every_lane_holds_what_its_merge_needs():
    """Each lane's 64 values (``value_map``) are its accumulators' (row,
    basis row); for every pixel of its merge (``merge_map``) the Y value
    is that pixel's own, and the Cr and Cb values that of its sample, of
    the same tile; the lanes' pixels cover each (tile, u, v) of the unit
    once, and their staged bytes each byte of the 8 staged rows' 384."""
    vmap, mm = inv.value_map(), inv.merge_map()
    seen = np.zeros((16, 8, 8), np.int64)
    for lane in range(32):
        for y, cr, cb, row, u, v in mm[lane].reshape(-1, 6):
            assert tuple(vmap[lane, y]) == (0, row, 8 * u + v)
            assert tuple(vmap[lane, cr]) == (1, row, 4 * u + v // 2)
            assert tuple(vmap[lane, cb]) == (2, row, 4 * u + v // 2)
            seen[row, u, v] += 1
    assert (seen == 1).all()
    for ch, hw in ((0, 64), (1, 32), (2, 32)):
        at = vmap[:, :, 0] == ch
        cells = vmap[:, :, 1][at] * hw + vmap[:, :, 2][at]
        assert np.array_equal(np.sort(cells), np.arange(16 * hw))
    written = np.concatenate([offs[:, None] + np.arange(4)
                              for offs in inv.stage_stores()]).ravel()
    want = (np.arange(8)[:, None] * inv.STAGE_ROW
            + np.arange(24 * inv.UNIT_TILES)[None, :]).ravel()
    assert np.array_equal(np.sort(written), want)


def _wavefronts(byte_addrs: np.ndarray, width: int) -> int:
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane
    at these byte addresses: phases of 128 bytes' worth of lanes, each
    taking as many wavefronts as the most distinct 4-byte words one of its
    banks holds."""
    lanes = max(1, min(32, 128 // width))
    total = 0
    for p in range(0, len(byte_addrs), lanes):
        words = {a // 4 + i for a in byte_addrs[p:p + lanes]
                 for i in range(max(1, width // 4))}
        banks = {}
        for w in words:
            banks[w % 32] = banks.get(w % 32, 0) + 1
        total += max(banks.values())
    return total


@pytest.mark.parametrize("hw", [64, 32])
def test_shared_accesses_take_their_wavefronts(hw):
    """Every ldmatrix of the basis and the staging stores at their fewest
    wavefronts, the 16-byte reads of the staged rows too; the A loads from
    the slot at twice their fewest (tiles 256 bytes apart put rows g and g
    + 1 on the same banks: the source's stated cost)."""
    for addrs in inv.basis_loads(hw):
        for m in range(4):  # each 8×8 matrix: 8 rows of 16 bytes
            assert _wavefronts(addrs[8 * m:8 * m + 8], 16) == 1
        assert (addrs % 16 == 0).all()
    for offs in inv.stage_stores():
        assert _wavefronts(offs, 4) == 1
    lane = np.arange(32)
    for i in range(6):  # the store loop's reads: q = lane + 32 i
        q = lane + 32 * i
        assert _wavefronts((q // 24) * inv.STAGE_ROW + 16 * (q % 24), 16) == 4
    for size, offs in inv.operand_loads():
        assert _wavefronts(offs, size) == 2 * 32 * size // 128


# -- the arithmetic ---------------------------------------------------------------------


def test_fma32_rounds_once():
    """``fma32`` against exact rationals, on integer-valued a and float32
    b, c chosen so that the float64 sum often lies half-way between two
    float32 values."""
    rng = np.random.default_rng(3)
    a = rng.integers(-2**15, 2**15, 2000).astype(np.float32)
    b = (rng.standard_normal(2000) * 8).astype(np.float32)
    c = (rng.standard_normal(2000) * 2.0 ** rng.integers(-30, 20, 2000)
         ).astype(np.float32)
    half = np.float32(2.0 ** -25)  # tiny tails make the float64 sum a tie
    c[::3] = (a[::3].astype(np.float64) * b[::3] + half).astype(np.float32)
    got = inv.fma32(a, b, c)
    for x, y, z, r in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(f.view(np.uint32)) & 1))
        assert r == best


def test_pixel_fast_is_the_parent_round_off_ties():
    """On 200,000 float32 sums in [−200, 460] and the points where the byte
    steps ± a few ulps: wherever ``pixel_fast`` does not flag a value, its
    byte is the parent's ``pixel`` of it; every flagged value lies within
    the window of an integer v = acc + 128.5 whose byte steps."""
    rng = np.random.default_rng(11)
    acc = rng.uniform(-200, 460, 200_000).astype(np.float32)
    steps = np.arange(-129, 129).astype(np.float32) + np.float32(0.5)
    near_steps = (steps[:, None].astype(np.float64)
                  + np.arange(-4, 5) * 2.0 ** -16).astype(np.float32).ravel()
    acc = np.concatenate([acc, near_steps])
    for window in (inv.TIE_WINDOW, 2 * inv.TIE_WINDOW):
        fast, near = inv.pixel_fast(acc, window)
        want = inv.pixel(acc)
        assert np.array_equal(fast[~near], want[~near])
        v = acc.astype(np.float64) + 128.5
        assert (np.abs(v - np.round(v))[near] <= window).all()
        assert ((v[near] >= 0) & (v[near] < 256)).all()


def test_merge_is_the_torch_merge():
    """``merge`` (color_merge.cuh's arithmetic) against ``merge_rgb`` (the
    torch merge) on every (Cr, Cb) pair, at Y 0, 77, 128, 200 and 255."""
    cr, cb = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for y in (0, 77, 128, 200, 255):
        yy = np.full_like(cr, y)
        assert np.array_equal(inv.merge(yy, cr, cb), merge_rgb(yy, cr, cb))


def test_accumulate_cuts_toward_zero_below_the_largest_term():
    """The k-step model: terms within 24 bits of the largest are summed
    exactly; a term below that keeps only its bits above the largest's
    24th, cut toward zero; the sum is cut toward zero to float32."""
    acc = np.zeros((1, 1))
    small = np.array([[[3.0], [5.0], [-2.0]]])
    assert inv.accumulate(acc, small)[0, 0] == 6.0
    big = np.array([[[2.0 ** 20], [2.0 ** -5 + 2.0 ** -4], [-(2.0 ** -5)]]])
    # 2^20's 24th bit is 2^-3: both small terms cut to 0 toward zero
    assert inv.accumulate(acc, big)[0, 0] == 2.0 ** 20
    third = np.array([[[1.0 / 3.0]]])
    got = inv.accumulate(acc, third)[0, 0]
    assert got <= 1.0 / 3.0 and np.float32(got) == got


# -- emulate against the parent ----------------------------------------------------------


NOISE_CASES = [(q, shape) for q in (None, 75, 90, 100)
               for shape in ((1, 37, 53), (4, 48, 528))] + [
    (75, (2, 512, 1040)), (90, (2, 64, 1040))]


@pytest.mark.parametrize("quality,shape", NOISE_CASES)
def test_emulate_gives_the_parent_bytes(quality, shape):
    """The maps composed equal the parent chain's bytes exactly (no
    tolerance) on seeded noise buffers: quality 50 (the reference tables),
    75, 90 and 100, ragged shapes (37×53; 48×528, 66 tiles a block row,
    last unit 2 tiles; 512×1040 and 64×1040, 130 tiles a block row)."""
    b, h, w = shape
    comb, tables, bpc, bpr = _combined(b, h, w, quality, seed=sum(shape))
    got = inv.emulate(comb, tables, bpc, bpr, h, w)
    assert got.shape == (b, h, w, 3)
    assert np.array_equal(got, inv.parent_decode(comb, tables, bpc, bpr, h, w))


@pytest.mark.parametrize("word", CRAFTED_WORDS)
def test_emulate_on_crafted_words(word):
    """A word at every lane (rows past EVERY_WINDOW chain every value),
    and a seeded mix of the five words: the parent's bytes exactly."""
    tables = scaled_tables(None)
    comb = np.full((2, 5 * 7, 128), word, dtype=np.int16)
    assert np.array_equal(inv.emulate(comb, tables, 5, 7, 37, 53),
                          inv.parent_decode(comb, tables, 5, 7, 37, 53))
    words = np.array(CRAFTED_WORDS, dtype=np.int16)
    mix = words[np.random.default_rng(word & 0xFF).integers(0, 5, (2, 35, 128))]
    assert np.array_equal(inv.emulate(mix, tables, 5, 7, 37, 53),
                          inv.parent_decode(mix, tables, 5, 7, 37, 53))


def test_plain_version_is_the_parent_on_noise():
    """The plain torch chain (cuBLAS's order on the card, torch's here) and
    the parent's fp32 chain agree on seeded noise, every differing pixel
    admissible under ``decode_flips`` (none expected at this size)."""
    from lz4jpeg_tpu_torch.utils.parity import decode_flips

    comb, tables, bpc, bpr = _combined(2, 64, 96, 75, seed=4)
    parent = inv.parent_decode(comb, tables, bpc, bpr, 64, 96)
    plain = inv.inverse_combined_ref(torch.from_numpy(comb), tables, bpc,
                                     bpr, 64, 96).numpy()
    assert decode_flips(torch.from_numpy(comb), parent, plain, tables, bpc,
                        bpr) <= 1e-5 * parent.size


def test_the_tie_window_is_needed_and_enough(capsys):
    """Over seeded noise at quality 50, 75, 90 and 100: some tensor-core
    bytes differ from the chain's (the window is needed); every one of
    them lies inside the window (it is enough), and the largest distance
    |sum − chain| stays under a quarter of the unit's window.  Printed
    with ``-s``: the counts, the tie share and the largest distance."""
    stats = {}
    for q in (None, 75, 90, 100):
        for shape in ((2, 128, 256), (1, 37, 53), (2, 48, 528)):
            comb, tables, bpc, bpr = _combined(*shape, q, seed=q or 50)
            got = inv.emulate(comb, tables, bpc, bpr, *shape[1:],
                              stats=stats)
            bare = inv.emulate(comb, tables, bpc, bpr, *shape[1:],
                               ties=False)
            parent = inv.parent_decode(comb, tables, bpc, bpr, *shape[1:])
            assert np.array_equal(got, parent)
            stats["pixels_off"] = stats.get("pixels_off", 0) + int(
                (bare != parent).any(axis=-1).sum())
    with capsys.disabled():
        print(f"\nK9 mirror: {stats['values']} values, {stats['ties']} to the "
              f"tie pass ({stats['ties'] / stats['values']:.4%}), "
              f"{stats['wrong']} whose tensor-core byte is not the chain's "
              f"({stats['pixels_off']} pixels off without the tie pass), "
              f"{stats['missed']} outside the window; largest distance "
              f"{stats['distance']:.4f} windows")
    assert stats["wrong"] > 0 and stats["pixels_off"] > 0
    assert stats["missed"] == 0
    assert stats["distance"] < 0.25


# -- the ring ----------------------------------------------------------------------------


def _ring_ok(sched: np.ndarray, stages: int, warps: int, seed: int) -> bool:
    """One CTA's warps on ``sched`` in a seeded random interleaving, each
    slot's "full" mbarrier as its count of completed phases (a wait on
    parity p passes while the count's parity is not p) and its release
    counter as the kernel keeps it: the first ``stages`` chunks are filled
    at the start; a warp reads its chunk, then releases it, and the last
    warp to release fills the slot with the row's ``refill`` chunk.
    Asserts that a read finds the chunk it expects, that a fill finds its
    slot released by every warp, and that every chunk is read by every
    warp; a deadlock raises."""
    rng = np.random.default_rng(seed)
    t = len(sched)
    full, released = [0] * stages, [0] * stages
    holds = [None] * stages
    for r in range(min(stages, t)):
        holds[sched[r][1]], full[sched[r][1]] = sched[r][0], 1
    reads = [0] * warps
    while min(reads) < t:
        ready = [w for w in range(warps) if reads[w] < t
                 and (full[sched[reads[w]][1]] & 1) != sched[reads[w]][2]]
        assert ready, "deadlock"
        w = ready[rng.integers(len(ready))]
        chunk, s, _, refill = sched[reads[w]]
        assert holds[s] == chunk, "a read found another chunk"
        released[s] += 1
        if released[s] == warps:  # the last warp to release refills
            released[s], holds[s] = 0, None
            if refill >= 0:
                assert sched[refill][1] == s
                holds[s], full[s] = sched[refill][0], full[s] + 1
        reads[w] += 1
    return True


RING_CASES = [(1, 1, 8), (1, 1, 16), (1, 3, 40), (2, 5, 130), (3, 37, 66),
              (64, 256, 256)]


@pytest.mark.parametrize("b,bpc,bpr", RING_CASES)
@pytest.mark.parametrize("resident", [1, 3, 264])
def test_the_chunks_cover_every_unit_once(b, bpc, bpr, resident):
    """Chunk → CTA and slot, chunk → its copy and warps: every unit once,
    each chunk's copy one contiguous run of exactly its units' tiles
    (every tile of the buffer once), each warp's unit at its place in the
    slot; CTAs within one chunk of each other; the first and last CTA's
    rings (up to 200 chunks) run in the mbarrier model."""
    plan = inv.inverse_plan(b, bpc, bpr, 8 * bpc, 8 * bpr, resident=resident)
    assert plan.chunks == -(-plan.units // inv.WARPS)
    sched = inv.chunk_schedule(plan)
    chunks = np.concatenate([s[:, 0] for s in sched])
    assert np.array_equal(np.sort(chunks), np.arange(plan.chunks))
    counts = [len(s) for s in sched]
    assert max(counts) - min(counts) <= 1
    if plan.units <= 20_000:
        covered = np.zeros(b * bpc * bpr, np.int64)
        g = inv.unit_of(np.arange(plan.units), bpc, bpr)
        for chunk in range(plan.chunks):
            first, tiles, offsets = inv.chunk_tiles(plan, bpc, bpr, chunk)
            assert 0 < tiles <= inv.WARPS * inv.UNIT_TILES
            covered[first:first + tiles] += 1
            units = chunk * inv.WARPS + np.arange(inv.WARPS)
            for w, u in enumerate(units):
                if u < plan.units:
                    assert offsets[w] == g.tile0[u] - first
                    assert offsets[w] + g.tiles[u] <= tiles
                else:
                    assert offsets[w] == -1
        assert (covered == 1).all()
    for cta in {0, plan.ctas - 1}:
        if len(sched[cta]) <= 200:
            assert _ring_ok(sched[cta], plan.stages, inv.WARPS, seed=cta + bpr)


def test_a_wrong_parity_or_refill_is_caught():
    plan = inv.inverse_plan(1, 64, 256, 512, 2048, resident=1)
    good = inv.chunk_schedule(plan)[0][:40].copy()
    wrong_parity = good.copy()
    wrong_parity[:, 2] ^= 1
    early_refill = good.copy()
    early_refill[:-plan.stages, 3] = np.arange(1, 41 - plan.stages)
    for bad in (wrong_parity, early_refill):
        with pytest.raises(AssertionError):
            for seed in range(20):
                _ring_ok(bad, plan.stages, inv.WARPS, seed)


@pytest.mark.parametrize("in_offset,out_offset,width", [
    (0, 0, 2048), (2, 0, 2048), (0, 4, 2048), (0, 0, 1531)])
def test_the_routes_follow_the_alignment(in_offset, out_offset, width):
    """Bulk copies only from a 16-byte aligned input base (a view off 16
    bytes takes the word route); 16-byte stores only where the output base
    and the row stride W·3 are 16-byte aligned; the plan is refused past a
    32-bit unit index."""
    plan = inv.inverse_plan(2, 32, 256, 256, width, in_offset, out_offset)
    assert plan.vec_in == (in_offset % 16 == 0)
    assert plan.vec_out == (out_offset % 16 == 0 and 3 * width % 16 == 0)
    with pytest.raises(ValueError):
        inv.inverse_plan(2**20, 2**10, 2**10, 8, 8)


# -- the source -------------------------------------------------------------------------


def test_the_mirror_matches_the_source():
    """The mirror's constants are the source's (the measuring switches
    off), its shared memory the source's sum, and the wrapper takes no
    window."""
    text = SOURCE.read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", text)[1]

    assert const("kUnit") == str(inv.UNIT_TILES)
    assert const("kWarps") == str(inv.WARPS)
    assert const("kStages") == str(inv.STAGES)
    assert const("kCtasPerSm") == str(inv.CTAS_PER_SM)
    assert const("kStageRow") == str(inv.STAGE_ROW)
    assert const("kLumStride") == str(inv._STRIDES[64])
    assert const("kChrStride") == str(inv._STRIDES[32])
    assert const("kTieWindow") == "1.0f / 512.0f" and inv.TIE_WINDOW == 2**-9
    assert const("kRowScale") == "1.0f / 2097152.0f" and inv.ROW_SCALE == 2**-21
    assert const("kFixedWindow") == "false" and const("kDistance") == "false"
    assert const("kEveryWindow") == "1.0f / 16.0f" and inv.EVERY_WINDOW == 1 / 16
    assert const("kDeltaMagic") == "k23 + 32768.0f + kBias"
    assert const("k23") == "8388608.0f" and inv.K23 == 2**23
    assert const("kBias") == str(inv.SPARSE16_DELTA_BIAS) == "1024"
    assert int(const("kBits23"), 16) == inv.BITS23
    assert "min(max(bits, kBits23), kBits23 + 255)" in text
    assert const("kDeltaRow") == "kLanes + 4" and inv.DELTA_ROW == 132
    assert inv.smem_bytes() == (43_008 + 26_624 + 512 + 2 * 8 * 4096
                                + 8 * 16 * 132 * 4 + 24)
    assert 8 * inv.STAGE_ROW <= 16 * inv.DELTA_ROW * 4  # RGB over the deltas
    assert inv.THREADS == 256
    assert inv.inverse_combined.__defaults__ == (None,)


@pytest.mark.parametrize("shape,quality", [((2, 48, 528), 75),
                                           ((1, 37, 53), 100)])
def test_part_products_count_the_vote(shape, quality):
    """``part_products`` against the mirror's vote: per unit and channel 3
    products of the hi part and 3 of the mid part where the unit's
    fragment has one, each 2 · 16 · K² operations."""
    b, h, w = shape
    comb, _, bpc, bpr = _combined(b, h, w, quality, seed=9)
    d = inv._unit_deltas(comb, bpc, bpr)
    want = 0
    for name in inv.CHANNELS:
        delta = d[:, :, inv.CHANNEL_SLICES[name]]
        k = delta.shape[2]
        live = (inv.split_deltas(delta)[1] != 0).any(axis=(1, 2))
        want += int(sum(len(inv.products_issued(bool(v))) for v in live)
                    ) * 2 * 16 * k * k
    assert inv.part_products(torch.from_numpy(comb), bpc, bpr) == want
    if quality == 100:
        assert want > 3 * d.shape[0] * 2 * 16 * (64**2 + 2 * 32**2)


def test_the_probe_shapes_the_source():
    """``profiles/inv_probe.py`` builds K9's variants by setting the
    source's constants (each defined once): other warps and slots, the
    source's own shape first, a fixed window (2⁻¹¹ is 1/2048 exactly), the
    chain's bytes, the distance record; without a card its run raises."""
    from lz4jpeg_tpu_torch.profiles import inv_probe

    text = SOURCE.read_text()
    out = inv_probe.shaped_source(text, kWarps="12", kStages="1")
    assert "constexpr int kWarps = 12;" in out
    assert "constexpr int kStages = 1;" in out
    assert out.replace("kWarps = 12;", f"kWarps = {inv.WARPS};").replace(
        "kStages = 1;", f"kStages = {inv.STAGES};") == text
    assert inv_probe.SHAPES[0] == (inv.WARPS, inv.STAGES)
    fixed = inv_probe.shaped_source(text, **inv_probe.BUILDS["fixed 0.000488281"])
    assert "constexpr float kTieWindow = 0.00048828125f;" in fixed
    assert float(0.00048828125) == 2.0**-11
    assert "constexpr bool kFixedWindow = true;" in fixed
    assert inv_probe.BUILDS["chain"]["kTieWindow"] == "0.5f"
    assert 0.5 > inv.EVERY_WINDOW  # every row of the chain build chains
    assert "constexpr bool kDistance = true;" in inv_probe.shaped_source(
        text, **inv_probe.BUILDS["distance"])
    assert len(inv_probe.BUILDS) == 4 + len(inv_probe.WINDOWS) + len(
        inv_probe.SHAPES)
    with pytest.raises(ValueError):
        inv_probe.shaped_source("no constants here", kWarps="8")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            inv_probe.main([])
