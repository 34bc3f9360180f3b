"""LZ4's greedy parses, K10 and K11 (``ops/lz4_parse.py``), on the CPU.

* The kernels' numpy mirrors equal the plain versions exactly: K10's
  segment plan (units of whole segments up to a tile, a segment longer
  than a tile walked in tiles with its pointer carried, the odd-pitch
  slots) on K2's plain candidates at strides 1, 2 and 4, lcp words 2 and
  4, on crafted candidates (matches ending on a segment end, ragged
  lengths, distances past ``max_dist``), and on the field entry's int32
  and int64 inputs, wrapping values included; K11's diagonal scan (tiles
  of positions from the last, runs carried across tiles, warps of 32
  distances, ``parity_key`` and the warp maximum) and its four-byte walk
  on the truncation and tie blocks, all-equal bytes, random bytes, ragged
  blocks, at ``max_match`` 1,024, 100 and below 4.
* The key never overflows 32 bits over every block length the frame takes
  and every ``max_match``.
* The mirrors' constants are the source's.
* On CPU tensors the wrappers run their plain versions and count no launch.

Tolerance: exact, dtypes included.  (The plain versions are held to the
JAX package in ``test_torch_lz4_match.py`` and ``test_torch_lz4_parity.py``.)
"""

import re

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.kernels.build import CSRC_DIR
from lz4jpeg_tpu_torch.ops import lz4_parse
from lz4jpeg_tpu_torch.ops.fused_match import match_candidates_ref
from lz4jpeg_tpu_torch.ops.lz4_fast import pad_blocks_fast
from lz4jpeg_tpu_torch.ops.match import pad_blocks
from lz4jpeg_tpu_torch.utils.inputs import (
    crafted_match_blocks,
    crafted_parity_bytes,
    generate_text,
    segment_end_candidates,
)

SOURCE = (CSRC_DIR / "lz4_parse_kernel.cu").read_text()


def _equal(got, want):
    for g, w in zip(got, want):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name,value", [
    ("kParseThreads", lz4_parse.PARSE_THREADS),
    ("kTileAnchors", lz4_parse.TILE_ANCHORS),
    ("kParityThreads", lz4_parse.PARITY_THREADS),
    ("kTileK", lz4_parse.TILE_K),
    ("kMaxPositions", lz4_parse.MAX_POSITIONS),
])
def test_mirror_constants_are_the_sources(name, value):
    m = re.search(rf"constexpr int {name} = ([^;]+);", SOURCE)
    assert m is not None and eval(m.group(1), {}) == value


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------


def _text_blocks(seed=0):
    data = generate_text(3 * 4096 + 1000, np.random.default_rng(seed))
    padded, lengths = pad_blocks_fast(data, 12)  # ragged last block
    return torch.from_numpy(padded.astype(np.uint8)), torch.from_numpy(lengths)


@pytest.mark.parametrize("stride,lcp_words", [(1, 2), (1, 4), (2, 2), (2, 4),
                                              (4, 2), (4, 4)])
@pytest.mark.parametrize("tile", [lz4_parse.TILE_ANCHORS, 100])
def test_candidate_mirror_equals_plain_on_k2_candidates(stride, lcp_words, tile):
    """At the kernel's tile a unit holds several segments; a tile of 100
    anchors is shorter than a segment, so each segment is walked in tiles
    with its pointer carried."""
    x, lengths = _text_blocks()
    packed = match_candidates_ref(x, lengths, stride, lcp_words)
    for seg, max_dist in ((512, 65535), (256, 3000), (4096, 9)):
        want = lz4_parse.parse_candidates_ref(packed, lengths, 4096, max_dist,
                                              stride, seg)
        got = lz4_parse.emulate_parse_candidates(
            packed.numpy(), lengths.numpy(), 4096, max_dist, stride, seg,
            tile=tile)
        _equal(got, want)
        assert int(want[0].sum()) > (100 if max_dist > 9 else 0)


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("tile", [lz4_parse.TILE_ANCHORS, 64])
def test_candidate_mirror_equals_plain_on_crafted_candidates(stride, tile):
    packed, lengths = segment_end_candidates(4096, stride,
                                             np.random.default_rng(3))
    for max_dist in (65535, 1000, 4 * (1024 // stride)):
        want = lz4_parse.parse_candidates_ref(
            torch.from_numpy(packed), torch.from_numpy(lengths), 4096,
            max_dist, stride, 512)
        got = lz4_parse.emulate_parse_candidates(packed, lengths, 4096,
                                                 max_dist, stride, 512,
                                                 tile=tile)
        _equal(got, want)
    # Row 0's matches run back to back: the last match of each of its 8
    # segments ends on the segment's end.
    is_match, emit_len, _ = (w.numpy() for w in want)
    starts = np.flatnonzero(is_match[0])
    ends = starts + emit_len[0, starts]
    assert np.isin(ends, np.arange(512, 4097, 512)).sum() == 8


def test_candidate_mirror_on_crafted_match_blocks():
    blocks, lengths = crafted_match_blocks(4096, np.random.default_rng(1))
    x, lens = torch.from_numpy(blocks), torch.from_numpy(lengths)
    for stride in (1, 2, 4):
        packed = match_candidates_ref(x, lens, stride, 4)
        want = lz4_parse.parse_candidates_ref(packed, lens, 4096, 65535, stride)
        got = lz4_parse.emulate_parse_candidates(packed.numpy(), lengths, 4096,
                                                 65535, stride)
        _equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("seg,stride,tile", [(512, 1, lz4_parse.TILE_ANCHORS),
                                             (256, 3, lz4_parse.TILE_ANCHORS),
                                             (1024, 1, 100), (7, 2, 64)])
def test_field_mirror_equals_plain(dtype, seg, stride, tile):
    """The sort matcher's entry, also on values the plain version's integer
    arithmetic wraps on (the kernel computes in the inputs' type)."""
    rng = np.random.default_rng(seg)
    n = 3 * 1024 if seg != 7 else 3 * 7 * 40
    ml = rng.integers(-5, 40, n).astype(dtype).reshape(3, -1)
    md = rng.integers(0, 1 << 20, n).astype(dtype).reshape(3, -1)
    info = np.iinfo(dtype)
    ml[0, 5], ml[1, 7], ml[2, 3] = info.max, info.max // 2, info.max - 1
    want = lz4_parse.greedy_parse_ref(torch.from_numpy(ml),
                                      torch.from_numpy(md), seg, stride)
    got = lz4_parse.emulate_greedy_parse(ml, md, seg, stride, tile=tile)
    _equal(got, want)


@pytest.mark.parametrize("n_anchors,seg_a,tile", [
    (2048 * 16384, 512, 2048), (4096, 1, 2048), (4096, 3 * 1024, 2048),
    (3 * 5000, 5000, 2048), (10, 5, 4)])
def test_segment_plan_covers_every_anchor_once(n_anchors, seg_a, tile):
    if n_anchors % seg_a:
        n_anchors -= n_anchors % seg_a
    seen = np.zeros(n_anchors, np.int32)
    plan = lz4_parse.segment_plan(n_anchors, seg_a, tile)
    for base, end, long_seg in plan[:4096]:
        assert (end - base) % seg_a == 0 or long_seg
        assert long_seg == (seg_a > tile)
        seen[base:end] += 1
    if len(plan) <= 4096:
        assert np.all(seen == 1)
    units = -(-n_anchors // ((tile // seg_a) * seg_a)) if seg_a <= tile else (
        n_anchors // seg_a)
    assert len(plan) == units


@pytest.mark.parametrize("seg_a", [1, 2, 3, 64, 512, 1024, 2048])
def test_segment_slots_fit_and_give_walkers_distinct_banks(seg_a):
    tile = lz4_parse.TILE_ANCHORS
    n = (tile // seg_a) * seg_a
    slots = lz4_parse.slot_of(np.arange(n), seg_a, False)
    assert len(set(slots.tolist())) == n
    assert slots.max() < tile + tile // 2  # kTileSlots
    walkers = np.arange(min(32, n // seg_a)) * (seg_a | 1)
    assert len(set((walkers % 32).tolist())) == len(walkers)


# ---------------------------------------------------------------------------
# K11
# ---------------------------------------------------------------------------


def _parity_blocks(p, seed):
    """(B, p) padded int32 blocks: the truncation and tie rows of
    ``crafted_parity_bytes``, all-equal bytes, random bytes, text, and a
    ragged last block."""
    rng = np.random.default_rng(seed)
    data = (crafted_parity_bytes(p) + b"q" * p
            + rng.integers(0, 256, p, dtype=np.uint8).tobytes()
            + generate_text(p + p // 3 + 1, rng))
    return pad_blocks(data, p)[0]


@pytest.mark.parametrize("p,max_match,tile", [
    (300, 1024, lz4_parse.TILE_K), (300, 100, lz4_parse.TILE_K),
    (300, 3, lz4_parse.TILE_K), (300, 1024, 96), (300, 100, 100),
    (1024, 100, lz4_parse.TILE_K), (1024, 1024, 250)])
def test_parity_mirror_equals_plain(p, max_match, tile):
    """A tile shorter than the block carries each distance's run across
    tiles, as K11 does past kTileK positions."""
    blocks = _parity_blocks(p, seed=p + max_match)
    want = lz4_parse.parity_tables_ref(torch.from_numpy(blocks), max_match)
    got = lz4_parse.emulate_parity(blocks, max_match, tile=tile)
    _equal(got, want)
    if max_match >= 4:
        assert int(want[2].sum()) > 10


def test_parity_mirror_on_random_and_all_equal_blocks():
    rng = np.random.default_rng(7)
    for blocks in (rng.integers(0, 256, (6, 300)).astype(np.int32),
                   np.full((2, 2000), 97, np.int32)):
        for max_match in (1024, 100):
            want = lz4_parse.parity_tables_ref(torch.from_numpy(blocks),
                                               max_match)
            got = lz4_parse.emulate_parity(blocks, max_match, tile=512)
            _equal(got, want)


@pytest.mark.parametrize("max_match", [0, 3, 4, 100, 255, 256, 1024, 65535,
                                       65536, 1 << 31])
def test_parity_key_never_overflows(max_match):
    """Over every block length the frame takes (16-bit sizes: P ≤ 65,536;
    the config refuses only 500) the largest key, the longest clamped run
    at the largest distance, stays below 2^32 and unpacks to both."""
    mm = lz4_parse.clamp_max_match(max_match)
    assert 0 <= mm < 1 << lz4_parse.KEY_SHIFT
    for p in (5, 300, 1024, 4096, 65535, lz4_parse.MAX_POSITIONS):
        run, d = min(p - 1, mm, max_match), p - 1
        key = lz4_parse.parity_key(run, d)
        assert key < 1 << 32
        if run >= 4:
            assert key >> lz4_parse.KEY_SHIFT == run and key & 0xFFFF == d
        assert lz4_parse.parity_key(run, d - 1) <= key  # ties: larger d wins
    assert lz4_parse.parity_key(3, 9) == 0


def test_parity_clamp_gives_the_plain_results():
    """Clamping max_match to [0, 65535] changes no output: a value under 4
    finds nothing, and no run reaches 2^16."""
    blocks = _parity_blocks(300, seed=1)
    x = torch.from_numpy(blocks)
    for max_match in (-7, 0, 3, 1 << 20):
        want = lz4_parse.parity_tables_ref(x, max_match)
        got = lz4_parse.parity_tables_ref(x, lz4_parse.clamp_max_match(max_match))
        _equal(got, want)


# ---------------------------------------------------------------------------
# The wrappers on the CPU
# ---------------------------------------------------------------------------


def test_cpu_wrappers_run_plain_and_count_no_launch():
    before = (lz4_parse.parse_candidates.launches,
              lz4_parse.greedy_parse.launches, lz4_parse.parity_parse.launches)
    x, lengths = _text_blocks(1)
    packed = match_candidates_ref(x, lengths, 2, 2)
    _equal(lz4_parse.parse_candidates(packed, lengths, 4096, stride=2),
           lz4_parse.parse_candidates_ref(packed, lengths, 4096, stride=2))
    ml = torch.arange(2048, dtype=torch.int64).reshape(2, 1024) % 9
    _equal(lz4_parse.greedy_parse(ml, ml * 3, 512),
           lz4_parse.greedy_parse_ref(ml, ml * 3, 512))
    blocks = torch.from_numpy(_parity_blocks(300, seed=2))
    _equal(lz4_parse.parity_parse(blocks, 1024),
           lz4_parse.parity_parse_ref(blocks, 1024))
    _equal(lz4_parse.parity_tables(blocks, 100),
           lz4_parse.parity_tables_ref(blocks, 100))
    assert (lz4_parse.parse_candidates.launches,
            lz4_parse.greedy_parse.launches,
            lz4_parse.parity_parse.launches) == before


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((2, 512), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        lz4_parse.greedy_parse(meta, meta, 512)
    with pytest.raises(ValueError):
        lz4_parse.parity_parse(meta.int())


def test_the_probe_shapes_the_source():
    """``profiles/parse_probe.py``'s builds each set their constants once;
    the codec's build walks, 8 slots ahead."""
    from lz4jpeg_tpu_torch.profiles import parse_probe

    assert re.search(r"constexpr bool kWalk = true;", SOURCE)
    assert re.search(r"constexpr int kWalkBatch = 8;", SOURCE)
    for values in parse_probe.BUILDS.values():
        shaped = parse_probe.shaped_source(SOURCE, **values)
        for name, value in values.items():
            assert re.search(rf"constexpr \w+ {name} = {value};", shaped)
        assert shaped.count("\n") == SOURCE.count("\n")
