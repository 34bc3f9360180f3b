"""The forward megakernel's launch plan and arithmetic
(``csrc/fwd_megakernel.cuh``), mirrored in numpy by
``lz4jpeg_tpu_torch/profiles/megakernel.py``, on the CPU.

The kernel runs on the card only.  What it computes is held here through
its mirrors:

* the plan (``k1_plan``, ``band_schedule``, ``band_geometry``,
  ``bulk_copies``, ``bulk_stores``) at 1×64×128, 2×1023×512, 1×61×1040,
  3×2048×2048 and 5×2048×2048 (5,120 bands, no multiple of the 132-CTA
  grid): every band loaded once and stored once, every output row written
  by exactly one store, every copy and store 16-byte aligned and a
  multiple of 16 bytes on the bulk route, each band's copies inside its
  frame and its ring slot;
* the ring (``ring_events``): the producer and the groups in random
  interleavings on a model of the mbarriers' parity waits and the band
  number beside each slot, no slot refilled before its group released
  it, every group reading its own band, and the parity alone not enough
  (5 slots, 3 groups: a group's wait passes on another group's fill that
  has not landed);
* the snap-trunc (``snap_trunc_fast``, the kernel's LOP3 + FADD.RZ +
  F2I) against the earlier formulation (``snap_trunc_int_ref``) on sums
  near every integer up to ±4096, within 1e-5 of them, and at random;
* the deltas (``sparse_deltas_fast``, without the low halves extracted)
  against the earlier formulation (``sparse_deltas_ref``): every int16
  value against crafted neighbours (equal, ±1, ±1024, the extremes, a
  wrap), at a segment's start and inside one;
* the colour (``quad_sums``, ``per_mille``): the dp2a placements give
  1000·v of each channel for random quads, and floor(S / 1000) by one
  multiply is exact for every S of every colour;
* the mirror's constants against the source.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from lz4jpeg_tpu_torch.profiles import megakernel as mk

SOURCE = (Path(mk.__file__).resolve().parent.parent / "csrc"
          / "fwd_megakernel.cuh")
RESIDENT = 132  # an H100's SMs, one CTA each
SHAPES = [(1, 64, 128), (2, 1023, 512), (1, 61, 1040), (3, 2048, 2048),
          (5, 2048, 2048)]


@pytest.mark.parametrize("shape", SHAPES)
def test_every_band_is_loaded_once_and_stored_once(shape):
    """The CTAs' bands partition the bands; each band's rows inside the
    frame are copied once each, and each band is stored once."""
    plan = mk.k1_plan(*shape, RESIDENT)
    sched = mk.band_schedule(plan)
    assert np.array_equal(np.sort(sched[:, 0]), np.arange(plan.n_bands))
    geo = mk.band_geometry(*shape)
    copies = mk.bulk_copies(*shape)
    per_band = np.bincount(copies[:, 0], minlength=plan.n_bands)
    assert np.array_equal(per_band, geo[:, 2])
    assert len(mk.bulk_stores(*shape)) == plan.n_bands
    if shape == (5, 2048, 2048):
        assert plan.n_bands % plan.ctas != 0


@pytest.mark.parametrize("shape", SHAPES)
def test_every_output_row_is_written_by_exactly_one_store(shape):
    b, h, w = shape
    n_rows = b * -(-h // 8) * -(-w // 8)
    stores = mk.bulk_stores(*shape)
    order = np.argsort(stores[:, 0])
    start, size = stores[order, 0], stores[order, 1]
    assert start[0] == 0
    assert np.array_equal(start[1:], start[:-1] + size[:-1])
    assert start[-1] + size[-1] == n_rows * mk.K1_ROW_BYTES
    assert (size > 0).all() and (size <= mk.K1_TILES * mk.K1_ROW_BYTES).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_bulk_copies_and_stores_are_aligned_and_inside(shape):
    """Every byte count a multiple of 16 and every address 16-byte aligned
    (W % 16 == 0 on the bulk route); each copy reads inside the batch and
    lands inside its slot; each band's copies are its rows inside H."""
    b, h, w = shape
    assert w % 16 == 0
    copies = mk.bulk_copies(*shape)
    band, slot_off, src, n = copies.T
    assert (n % 16 == 0).all() and (n % 48 == 0).all() and (n > 0).all()
    assert (src % 16 == 0).all() and (slot_off % 16 == 0).all()
    assert (src + n <= b * h * w * 3).all()
    assert (slot_off + n <= mk.K1_SLOT_BYTES).all()
    stores = mk.bulk_stores(*shape)
    assert (stores % 16 == 0).all()
    geo = mk.band_geometry(*shape)
    # a copy's row r reads image row by·8 + r of the band's frame
    frame, inside = geo[band, 0] // (h * w * 3), geo[band, 2]
    assert ((src + n - 1) // (h * w * 3) == frame).all()
    assert (slot_off // (mk.K1_TILES * 24) < inside).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_the_ring_never_refills_an_unread_slot(shape):
    """In random interleavings (three seeds) the parity waits let the
    producer fill a slot only after its group has read the band it held,
    and let each group read exactly the band its schedule names; every
    band is filled and read once, in each CTA's order."""
    plan = mk.k1_plan(*shape, RESIDENT)
    stale = 0
    for seed in range(3):
        log = mk.ring_events(plan, seed)
        stale += log["stale"]
        fills = np.array(log["fills"])
        reads = np.array(log["reads"])
        assert len(fills) == len(reads) == plan.n_bands
        assert np.array_equal(np.sort(fills[:, 1]), np.arange(plan.n_bands))
        assert np.array_equal(np.sort(reads[:, 2]), np.arange(plan.n_bands))
        for cta in range(plan.ctas):
            mine = fills[fills[:, 0] == cta, 1]
            assert np.array_equal(mine, np.arange(cta, plan.n_bands, plan.ctas))
    if plan.n_bands >= plan.ctas * (plan.slots + 1):
        assert stale > 0  # the band number is needed, not the parity alone


def test_the_parity_sequences_are_what_the_barriers_see():
    """Slot s of a CTA holds bands i ≡ s (mod slots) in turn: the k-th fill
    (k = i // slots) completes phase k of "full", so its group's wait on
    parity k & 1 passes once k + 1 phases have completed and not before;
    the producer's k-th fill waits on "empty" with parity (k & 1) ^ 1,
    which passes once the k earlier reads have completed k phases and not
    at k - 1; the groups alternate."""
    plan = mk.k1_plan(5, 2048, 2048, RESIDENT)
    sched = mk.band_schedule(plan)
    for cta in (0, 1, plan.ctas - 1):
        mine = sched[sched[:, 1] == cta]
        i = mine[:, 2]
        assert np.array_equal(mine[:, 3], i % mk.K1_GROUPS)
        assert np.array_equal(mine[:, 4], i % mk.K1_SLOTS)
        for s in range(mk.K1_SLOTS):
            fills = mine[mine[:, 4] == s]
            k = np.arange(len(fills))
            full_parity, empty_parity = fills[:, 5], fills[:, 5] ^ 1
            assert np.array_equal(full_parity, k & 1)
            # try_wait.parity(P) passes when the completed phases c have
            # c & 1 != P
            assert ((k + 1) & 1 != full_parity).all()
            assert (k & 1 == full_parity).all()
            assert (k & 1 != empty_parity).all()
            assert ((k[1:] - 1) & 1 == empty_parity[1:]).all()


def test_band_geometry_at_the_edges():
    """A band past W (130 tiles: 64 + 64 + 2) and past H (61 rows)."""
    geo = mk.band_geometry(1, 61, 1040)
    assert geo.shape == (24, 5)
    assert list(geo[2]) == [2 * 64 * 24, 128, 8, 1040 - 1024, 2]
    assert list(geo[-1]) == [7 * 8 * 1040 * 3 + 2 * 64 * 24, 7 * 130 + 128, 5,
                             16, 2]
    copies = mk.bulk_copies(1, 61, 1040)
    last = copies[copies[:, 0] == 23]
    assert len(last) == 5 and (last[:, 3] == 48).all()


def test_the_mirror_constants_are_the_source_constants():
    src = SOURCE.read_text()
    assert re.search(r"constexpr int kThreads = 256;", src)
    # K1_SLOTS: at most 5 slots outside the 16-tile band's frame
    assert re.search(r"constexpr int kCap = V::kWide \? kRingBytes / "
                     r"V::kBandBytes : 5;", src)
    assert re.search(r"return kFit < kCap \? kFit : kCap;", src)
    assert mk.rgb_frame("full")["slots"] == mk.K1_SLOTS
    assert re.search(r"using K1Variant = Variant<64, 3, Colour::kYCbCr, 3, "
                     r"Stage::kSparse, true, true>;", src)
    assert re.search(r"int Groups = 3,", src)
    assert re.search(r"constexpr int kLumStride = 64 \+ 8;", src)
    assert re.search(r"constexpr int kChrStride = 32 \+ 8;", src)
    assert re.search(r"constexpr int kQStride = 128 \+ 8;", src)
    assert mk.K1_SMEM == 221_520
    assert mk.K1_THREADS == 800


# -- the snap-trunc --------------------------------------------------------------


def _near_integers(span: int, ulps: int) -> np.ndarray:
    """float32 values n + k ulps for every integer |n| ≤ span and |k| ≤ ulps."""
    n = np.arange(-span, span + 1, dtype=np.float32)
    out = [n]
    up, down = n.copy(), n.copy()
    for _ in range(ulps):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return np.concatenate(out)


@pytest.mark.parametrize("case", ["near integers", "at eps", "random",
                                  "small"])
def test_the_snap_trunc_is_the_earlier_one(case):
    """The kernel's snap-trunc equals the earlier formulation bit for bit:
    sums within 64 ulps of every integer |n| ≤ 4096; sums whose distance
    below an integer is 1e-5f ± 256 ulps of the sum (where the snap
    decides); 1,000,000 random sums in ±8192; sums below 1 in magnitude,
    ±0 included."""
    rng = np.random.default_rng(len(case))
    if case == "near integers":
        x = _near_integers(4096, 64)
    elif case == "at eps":
        n = np.arange(-4096, 4097, dtype=np.float64)
        x = np.concatenate([
            (n - sign * float(mk.F32_EPS)).astype(np.float32)
            for sign in (1, -1)])
        steps = [x]
        up, down = x.copy(), x.copy()
        for _ in range(256):
            up = np.nextafter(up, np.float32(np.inf))
            down = np.nextafter(down, np.float32(-np.inf))
            steps += [up, down]
        x = np.concatenate(steps)
    elif case == "random":
        x = rng.uniform(-8192, 8192, 1_000_000).astype(np.float32)
    else:
        x = np.concatenate([rng.uniform(-1, 1, 100_000),
                            [0.0, -0.0, 1e-30, -1e-30, 1 - 1e-5, -(1 - 1e-5)]]
                           ).astype(np.float32)
    want = mk.snap_trunc_int_ref(x)
    got = mk.snap_trunc_fast(x)
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (x[bad[:5]], got[bad[:5]], want[bad[:5]])
    if case == "at eps":  # the snap both takes and declines here
        frac = np.abs(x) - np.floor(np.abs(x))
        assert (frac > 0.5).any()
        assert (want != np.trunc(x).astype(np.int32)).any()
        assert (want == np.trunc(x).astype(np.int32)).any()


# -- the deltas ------------------------------------------------------------------


@pytest.mark.parametrize("seg_first", [False, True])
def test_the_deltas_are_the_earlier_ones(seg_first):
    """Every 16-bit value x in each of the 8 lanes, its neighbours (the lane
    before, and the lane before the first) set to x, x ± 1, x ± 1024, 0,
    0x7FFF, 0x8000, 0xFFFF, 0x0400 and 0xFC00 (the shifts wrap modulo
    2^16); plus 200,000 random rows."""
    x = np.arange(1 << 16, dtype=np.uint32)
    rows, prevs = [], []
    for shift in (0, 1, -1, 1024, -1024, None):
        for fixed in ((None,) if shift is not None else
                      (0, 0x7FFF, 0x8000, 0xFFFF, 0x0400, 0xFC00)):
            n = x if fixed is None else np.full_like(x, fixed)
            nb = ((x.astype(np.int64) + shift) & 0xFFFF).astype(np.uint32) \
                if shift is not None else n
            for lane in range(8):  # x at this lane, its neighbour before it
                lanes = np.tile(((x * 7919 + 13) & 0xFFFF)[:, None], (1, 8))
                lanes[:, lane] = x
                if lane:
                    lanes[:, lane - 1] = nb
                    p = (x * 31) & 0xFFFF
                else:
                    p = nb
                rows.append((lanes[:, 0::2] | (lanes[:, 1::2] << 16))
                            .astype(np.uint32))
                prevs.append(p.astype(np.uint32))
    rng = np.random.default_rng(5)
    rows.append(rng.integers(0, 2**32, (200_000, 4), dtype=np.uint64)
                .astype(np.uint32))
    prevs.append(rng.integers(0, 2**16, 200_000).astype(np.uint32))
    words, prev = np.concatenate(rows), np.concatenate(prevs)
    first = np.full(len(words), seg_first)
    want = mk.sparse_deltas_ref(words, prev, first)
    got = mk.sparse_deltas_fast(words, prev, first)
    assert np.array_equal(got, want)
    assert (want == 0).any() and (want != 0).any()


# -- the colour ------------------------------------------------------------------


@pytest.mark.parametrize("channel", ["y", "cr", "cb"])
def test_the_dp2a_placements_give_each_pixels_sum(channel):
    """For 200,000 random quads, each pixel's two dp2a products at its byte
    position sum to r·R + g·G + b·B + add."""
    rng = np.random.default_rng(7)
    px = rng.integers(0, 256, (200_000, 4, 3), dtype=np.uint8)
    words = px.reshape(-1, 12).copy().view("<u4")
    r, g, b, add = mk.COLOUR_COEFS[channel]
    c = px.astype(np.int64)
    want = r * c[..., 0] + g * c[..., 1] + b * c[..., 2] + add
    assert np.array_equal(mk.quad_sums(words, channel), want)


def test_per_mille_is_floor_division_for_every_colour():
    """floor(S / 1000) by one multiply equals integer division for every S
    of every colour (2^24 of them, each channel), and for all S below
    6·10^6, the bound the kernel's comment states."""
    s = np.arange(6_000_000, dtype=np.int64)
    assert np.array_equal(mk.per_mille(s), s // 1000)
    v = np.arange(256, dtype=np.int64)
    for r, g, b, add in mk.COLOUR_COEFS.values():
        sums = (r * v[:, None, None] + g * v[None, :, None]
                + b * v[None, None, :] + add).ravel()
        assert sums.min() >= 0 and sums.max() < 6_000_000
        assert np.array_equal(mk.per_mille(sums), sums // 1000)
