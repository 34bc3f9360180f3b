"""The RGB frames of the forward megakernel's template
(``csrc/fwd_megakernel.cuh``, instantiated in ``csrc/fwd_probe_kernel.cu``),
mirrored in numpy by ``lz4jpeg_tpu_torch/profiles/megakernel.py``, on the
CPU.

The chunk sweep's band rows (P-abl's ``band_128``, ``band_16``, ``band_32``)
run K1's arithmetic in frames that fit their band: at T = 128 two groups
whose output rows lie over their operands, at T = 16 twelve groups of 2
warps on a basis staged in shared memory, four producer warps taking the
bands in turn, rows over the operands and a ring of K1's bytes.  Held
here, each tied to the source:

* every RGB variant's frame (``rgb_frame``: groups, warps a group,
  producer warps, threads, launch registers, ring slots, bytes a group,
  aliased rows, the staged basis, dynamic shared memory) against the
  source's instantiations and constants, within the SM's 232,448 B and
  its 1,024 threads, the group ids within the named barriers;
* the ring (``band_plan``, ``band_schedule``, ``ring_events``) at the new
  slot and group counts: no slot refilled before its group read it, each
  group reading its own band, on full and ragged shapes;
* the bands' copies and stores at T = 16 and 128 (``band_geometry``,
  ``bulk_copies``, ``bulk_stores``): every band loaded once, every output
  row stored once, a partial last band included;
* the aliased rows at band_128's two groups and band_16's twelve
  (``alias_events``): the store's read before the next convert's writes,
  and the order without the group's barrier caught;
* the groups of 2 and 4 warps' maps: the quads of the convert, the rows of the
  store pass and the product's columns each taken once, and the staged
  basis's ``ldmatrix`` giving each lane the B fragment that
  ``load_basis_b`` reads from the parts;
* the SASS count of a band loop whose product is no loop (T = 16).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from lz4jpeg_tpu_torch.profiles import megakernel as mk
from lz4jpeg_tpu_torch.profiles import sass_loops

CSRC = Path(mk.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "fwd_megakernel.cuh").read_text()
FLAT = " ".join(HEADER.split())
PROBES = (CSRC / "fwd_probe_kernel.cu").read_text()
RESIDENT = 132  # an H100's SMs, one CTA each
RGB = [v.name for v in mk.RGB_VARIANTS]
# (frames, H, W): the runs' gate, a last band of 2 tiles at T = 16, 32 and
# 128 (W = 1040), one of 8 (W = 1088), 32 frames of 2048² at few CTAs.
SHAPES = [(2, 64, 128), (2, 64, 1040), (1, 128, 1088), (3, 2048, 2048)]


def _body(name: str) -> str:
    body = HEADER[HEADER.index(f"void {name}("):]
    return " ".join(body[:body.index("\n}\n")].split())


def _rgb_instances():
    """{variant name: (T, groups)} of the RGB instantiations in the probe
    library (``using X = Variant<T, ...[, groups]>;`` and ``with_variant``'s
    cases; K1Variant for the full row)."""
    names = re.findall(r'"(\w+)"', PROBES[PROBES.index("kNames[] = {"):
                                          PROBES.index("constexpr int kCount")])
    cases = dict(re.findall(r"case (\d+): return f\((\w+)\{\}\);", PROBES))
    aliases = {"Full": (64, 3)}
    for alias, args in re.findall(r"using (\w+) = Variant<(\d[^;]*)>;",
                                  PROBES):
        parts = [a.strip() for a in args.split(",")]
        aliases[alias] = (int(parts[0]), int(parts[7]) if len(parts) > 7 else 3)
    return {names[int(i)]: aliases[a] for i, a in cases.items()
            if a in aliases}


# -- the frames -----------------------------------------------------------------


def test_the_rgb_groups_are_the_sources_instantiations():
    assert "using Full = K1Variant;" in PROBES
    assert "bool BlockMajor, int Groups = 3," in FLAT
    inst = _rgb_instances()
    assert set(inst) == set(RGB)
    for name, (t, groups) in inst.items():
        assert t == mk.BY_NAME[name].tiles, name
        assert groups == mk.RGB_GROUPS[name], name


@pytest.mark.parametrize("name", RGB)
def test_each_rgb_frame_fits_the_sm(name):
    f = mk.rgb_frame(name)
    assert f["smem"] <= mk.SMEM_LIMIT and f["threads"] <= 1024
    assert 2 <= f["slots"] and f["slots"] % f["producers"] == 0
    assert f["threads"] == 32 * (f["groups"] * f["group_warps"]
                                 + f["producer_warps"])
    assert f["producer_warps"] == (4 if f["group_warps"] < 8 else 1)
    if f["group_warps"] == 8:  # K1's frame: 5 slots at most
        assert f["slots"] <= 5 and f["staged_bytes"] == 0
    if f["aliased"]:  # the rows (T x 128 int16) fit over the bf16 operands
        t = mk.BY_NAME[name].tiles
        assert t * 128 * 2 <= t * (mk.LUM_STRIDE + 2 * mk.CHR_STRIDE) * 2


def test_the_band_rows_frames():
    """band_128: 2 groups, 3 slots of 24,576 B, 17 warps at 96 registers,
    rows over the operands (74 KB a group); band_16: 12 groups of 2 warps
    and 4 producer warps taking bands in turn, 28 warps at 72 registers
    (K1's), the staged basis, rows over the operands, 20 slots (K1's 61,440
    B of ring); band_32 and the full row: K1's frame."""
    assert mk.rgb_frame("band_128") == {
        "groups": 2, "group_warps": 8, "producer_warps": 1, "producers": 1,
        "threads": 544, "launch_registers": 96, "slots": 3,
        "group_bytes": 73_760, "aliased": 1, "staged_bytes": 0,
        "smem": 221_392}
    assert mk.rgb_frame("band_16") == {
        "groups": 12, "group_warps": 2, "producer_warps": 4, "producers": 4,
        "threads": 896, "launch_registers": 72, "slots": 20,
        "group_bytes": 9_248, "aliased": 1,
        "staged_bytes": mk.STAGED_BASIS_BYTES, "smem": 208_704}
    assert 20 * 8 * 16 * 24 == mk.RING_BYTES
    k1 = mk.rgb_frame("full")
    assert (k1["groups"], k1["slots"], k1["threads"], k1["smem"]) == (
        mk.K1_GROUPS, mk.K1_SLOTS, mk.K1_THREADS, mk.K1_SMEM)
    assert k1["group_bytes"] == mk.K1_GROUP_BYTES
    assert mk.rgb_frame("band_32")["smem"] == 110_928  # K1's frame at T = 32


def test_the_rgb_frame_mirror_is_the_sources():
    assert "constexpr int kRingBytes = 5 * 8 * 64 * 24;" in HEADER
    assert mk.RING_BYTES == 5 * 8 * 64 * 24
    for text in (
            "static constexpr bool kWide = Groups > 4;",
            "static constexpr int kGroupWarps = kWide ? 24 / Groups : 8;",
            "static constexpr int kGroupThreads = 32 * kGroupWarps;",
            "static constexpr int kStagedBytes = (kKtProduct && BasisA) || "
            "kWide ? kStagedBasisBytes : 0;",
            "static constexpr int kCtaThreads = Groups * kGroupThreads + "
            "32 * kProducerWarps;",
            "static constexpr int kProducerWarps = kRegSplit || kWide ? 4 : 1;",
            "static constexpr int kProducers = kWide ? kProducerWarps : 1;",
            "static_assert(kSlots % V::kProducers == 0,",
            "static constexpr bool kAliasOut = kProduct && kBulkOut && "
            "(In == Input::kKt || Tiles == 128 || kWide);",
            "constexpr int kCap = V::kWide ? kRingBytes / V::kBandBytes : 5;",
            "using Group = std::conditional_t<V::kAliasOut, AliasGroup<V>, "
            "RowsGroup<V>>;"):
        assert text in FLAT, text
    rows = HEADER[HEADER.index("struct alignas(16) RowsGroup {"):]
    rows = rows[:rows.index("};")]
    assert re.findall(r"^\s+(?:Band|uint16_t|int16_t) (\w+)", rows,
                      re.M) == ["out", "band", "lum", "chr", "q"]


def test_each_producer_warp_takes_every_fourth_band():
    """The 16-tile band's producer warp p (of the last 4) starts at the
    CTA's band p and steps by 4 bands: the plan's producers."""
    loop = _body("band_loop")
    for text in ("const int first = V::kProducers > 1 ? warp - V::kGroups * "
                 "V::kGroupWarps : 0;",
                 "uint32_t i = first;",
                 "for (uint32_t band = blockIdx.x + first * step; band < "
                 "n_bands; band += V::kProducers * step, i += V::kProducers)"):
        assert text in loop, text
    assert mk.band_plan("band_16", 2, 64, 128, RESIDENT).producers == 4
    assert mk.band_plan("band_128", 2, 64, 128, RESIDENT).producers == 1


def test_group_ids_stay_within_the_named_barriers():
    """Group g waits on named barrier g + 1 over its own threads (0 is
    ``__syncthreads``'), so ids 1..groups must lie under 16; the source
    takes more than 4 groups only as groups of 24 / G warps."""
    assert ('asm volatile("bar.sync %0, %1;" ::"r"(g + 1), '
            '"n"(V::kGroupThreads)') in FLAT
    assert ("static_assert((Groups >= 1 && Groups <= 4) || (Groups == 12 && "
            "In == Input::kRgb && Parts == 3 &&") in FLAT
    for v in mk.VARIANTS:
        f = mk.rgb_frame(v.name) if v.input == "rgb" else mk.kt_frame(v.name)
        assert 1 <= f["groups"] < mk.NAMED_BARRIERS, v.name
        assert f["groups"] <= 4 or f["groups"] * f["group_warps"] == 24


# -- the ring at the new counts -------------------------------------------------


@pytest.mark.parametrize("name", mk.BAND_ROWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_the_ring_never_refills_an_unread_slot_at_the_band_frames(name, shape):
    """``ring_events`` (random interleavings, three seeds) on each band
    row's plan: every band filled once and read once, by its own group,
    no slot refilled before it was read; at 20 slots and 6 groups, and at
    3 slots and 2 groups (neither a multiple of the other), the parity
    alone would take another group's fill where CTAs take many bands."""
    plan = mk.band_plan(name, *shape, RESIDENT)
    f = mk.rgb_frame(name)
    assert (plan.groups, plan.slots, plan.tiles) == (
        f["groups"], f["slots"], mk.BY_NAME[name].tiles)
    stale = 0
    for seed in range(3):
        log = mk.ring_events(plan, seed)
        stale += log["stale"]
        fills, reads = np.array(log["fills"]), np.array(log["reads"])
        assert len(fills) == len(reads) == plan.n_bands
        assert np.array_equal(np.sort(reads[:, 2]), np.arange(plan.n_bands))
        sched = mk.band_schedule(plan)
        group = dict(zip(map(tuple, sched[:, [1, 0]]), sched[:, 3]))
        assert all(group[cta, band] == g for cta, g, band, _ in reads)
        for cta in range(min(plan.ctas, 4)):  # each producer's bands in order
            mine = fills[fills[:, 0] == cta, 1]
            for p in range(plan.producers):
                want = np.arange(cta + p * plan.ctas, plan.n_bands,
                                 plan.producers * plan.ctas)
                assert np.array_equal(
                    mine[(mine - cta) // plan.ctas % plan.producers == p], want)
    if plan.n_bands >= plan.ctas * (plan.slots + plan.groups):
        assert stale > 0


@pytest.mark.parametrize("name", mk.BAND_ROWS)
@pytest.mark.parametrize("shape", SHAPES)
def test_every_band_row_band_is_loaded_and_stored_once(name, shape):
    t = mk.BY_NAME[name].tiles
    b, h, w = shape
    plan = mk.band_plan(name, *shape, RESIDENT)
    geo = mk.band_geometry(*shape, t)
    assert len(geo) == plan.n_bands
    copies = mk.bulk_copies(*shape, t)
    assert np.array_equal(np.bincount(copies[:, 0], minlength=plan.n_bands),
                          geo[:, 2])
    assert (copies[:, 1] + copies[:, 3] <= 8 * t * 24).all()
    assert (copies[:, 3] % 16 == 0).all() and (copies[:, 2] % 16 == 0).all()
    stores = mk.bulk_stores(*shape, t)
    order = np.argsort(stores[:, 0])
    start, size = stores[order, 0], stores[order, 1]
    assert start[0] == 0 and np.array_equal(start[1:], start[:-1] + size[:-1])
    assert start[-1] + size[-1] == b * (h // 8) * (w // 8) * mk.K1_ROW_BYTES
    last = (w // 8) % t
    if shape[2] in (1040, 1088):  # a partial last band at every T
        assert last and (geo[:, 4] == last).sum() == b * h // 8


# -- the aliased rows at band_128's two groups and band_16's twelve -----------


@pytest.mark.parametrize("name", ["band_128", "band_16"])
@pytest.mark.parametrize("seed", range(4))
def test_the_store_reads_before_the_next_convert_writes(name, seed):
    f = mk.rgb_frame(name)
    threads = min(3, f["group_warps"])  # a group's warps (3 of 8 modelled)
    log = mk.alias_events(bands=4, seed=seed, threads=threads,
                          groups=f["groups"])
    assert log == {"violations": 0, "stores": 4 * f["groups"]}


@pytest.mark.parametrize("name", ["band_128", "band_16"])
def test_without_the_barrier_a_convert_overwrites_a_read(name):
    f = mk.rgb_frame(name)
    caught = sum(mk.alias_events(bands=4, seed=s, barrier=False,
                                 threads=min(3, f["group_warps"]),
                                 groups=f["groups"])["violations"]
                 for s in range(4))
    assert caught > 0


def test_the_band_128_rows_alias_in_the_band_loop():
    """The RGB convert writes the operands the aliased rows lie over, so
    the storing thread's wait and the group's barrier come first."""
    loop = _body("band_loop")
    wait = loop.index("bulk_wait_read(); // the last band's store has read "
                      "`out`")
    barrier = loop.index("if constexpr (V::kAliasOut) group_sync<V>(g);")
    convert = loop.index("src.convert(gr, sm.raw[s], b, tid);")
    assert wait < barrier < convert
    assert "return reinterpret_cast<int16_t*>(gr.lum);" in HEADER


# -- the groups of 4 warps' maps ------------------------------------------------


@pytest.mark.parametrize("tiles,threads", [(16, 64), (16, 128), (16, 256),
                                           (64, 256), (128, 256)])
def test_each_quad_is_converted_once(tiles, threads):
    """``Quads``: thread i takes tile-half i % 2T of rows i / 2T + (threads
    / 2T)·j, j < 16T / threads; every (row, tile, half) once."""
    per, step = 16 * tiles // threads, threads // (2 * tiles)
    seen = np.zeros((8, tiles, 2), dtype=np.int64)
    for tid in range(threads):
        gi = tid & (2 * tiles - 1)
        for j in range(per):
            seen[tid // (2 * tiles) + step * j, gi >> 1, gi & 1] += 1
    assert (seen == 1).all()
    assert ("static constexpr int kPerThread = 16 * V::kTiles / "
            "V::kGroupThreads;") in FLAT
    assert ("static constexpr int kRowStep = V::kGroupThreads / "
            "(2 * V::kTiles);") in FLAT


@pytest.mark.parametrize("tiles,threads", [(16, 64), (16, 128), (128, 256)])
def test_each_store_row_chunk_is_written_once(tiles, threads):
    """``store_rows``: 16 threads a row of 128 lanes, rows tid / 16 +
    (threads / 16)·j, j < 16T / threads."""
    seen = np.zeros((tiles, 16), dtype=np.int64)
    for tid in range(threads):
        for j in range(tiles * 16 // threads):
            seen[tid // 16 + j * (threads // 16), tid & 15] += 1
    assert (seen == 1).all()
    body = _body("store_rows")
    assert "constexpr int kRowsPerPass = V::kGroupThreads / kPerRow;" in body
    assert "j < V::kTiles * kPerRow / V::kGroupThreads;" in body


def _columns(group_warps: int):
    """{warp: staged columns} of a group's product: 8 warps take 8 luma
    and 8 chroma lanes (``band_loop``'s lum_col, chr_col); W = 4 or 2
    warps 64/W and 64/W in pieces of 8 (``product_staged``), a warp's
    chroma lanes in one channel."""
    cols = {}
    for gw in range(group_warps):
        if group_warps == 8:
            lum, chr_ = 8 * gw, 64 + 32 * (gw >> 2) + 8 * (gw & 3)
            cols[gw] = [*range(lum, lum + 8), *range(chr_, chr_ + 8)]
            continue
        lanes = 64 // group_warps
        first = lanes * gw
        ch = first >> 5
        cols[gw] = []
        for j in range(lanes // 8):
            ln, cn = first + 8 * j, (first & 31) + 8 * j
            assert (first + 8 * j) >> 5 == ch  # one chroma channel a warp
            cols[gw] += [*range(ln, ln + 8),
                         *range(64 + 32 * ch + cn, 64 + 32 * ch + cn + 8)]
    return cols


@pytest.mark.parametrize("group_warps", [8, 4, 2])
def test_each_output_lane_is_one_warps(group_warps):
    cols = _columns(group_warps)
    every = sorted(c for v in cols.values() for c in v)
    assert every == list(range(128))
    body = _body("product_staged")
    for text in ("constexpr int kWarpLanes = 64 / V::kGroupWarps;",
                 "const int first = kWarpLanes * gw;",
                 "const int ch = first >> 5;",
                 "for (int j = 0; j < kWarpLanes / 8; ++j) {",
                 "const int ln = first + 8 * j;",
                 "const int cn = (first & 31) + 8 * j;",
                 "put_block<V>(ls, ll, gr.q, row, ln + 2 * (lane & 3));",
                 "put_block<V>(cs, cl, gr.q, row, 64 + 32 * ch + cn + "
                 "2 * (lane & 3));"):
        assert text in body, text
    loop = _body("band_loop")
    for text in ("const int lum_col = 8 * gw;",
                 "const int chr_col = 64 + 32 * ch + 8 * (gw & 3);"):
        assert text in loop, text


def _ldmatrix_x4(smem: np.ndarray, rows: list) -> np.ndarray:
    """(32, 4) words: ``ldmatrix.x4`` of the 8-element rows whose element
    addresses lanes 0-31 give (matrix i from lanes 8i..8i+7): lane L's
    register i holds elements 2(L % 4), + 1 of row L / 4 of matrix i, the
    first in the low half."""
    out = np.zeros((32, 4), dtype=np.uint32)
    for lane in range(32):
        for i in range(4):
            at = rows[8 * i + lane // 4] + 2 * (lane % 4)
            out[lane, i] = int(smem[at]) | (int(smem[at + 1]) << 16)
    return out


def test_the_staged_basis_gives_load_basis_bs_fragments():
    """Each lane's ``ldmatrix`` of the staged basis (``stage_basis``'s
    padded rows; ``product_staged``'s addresses) holds the words that
    ``load_basis_b`` reads from the parts for the same lanes, part and
    k-step: B fragment ``b[p][ks]`` = (parts[p, n0 + L/4, 16ks + 2(L%4)],
    +1) and the same 8 positions on."""
    rng = np.random.default_rng(3)
    parts = rng.integers(0, 1 << 16, 3 * 4096 + 3 * 1024, dtype=np.int64)
    lum_basis = 3 * 64 * mk.LUM_STRIDE
    staged = np.zeros(lum_basis + 3 * 32 * mk.CHR_STRIDE, dtype=np.int64)
    for p in range(3):
        for r in range(64):
            at = (p * 64 + r) * mk.LUM_STRIDE
            staged[at:at + 64] = parts[p * 4096 + r * 64:p * 4096 + r * 64 + 64]
        for r in range(32):
            at = lum_basis + (p * 32 + r) * mk.CHR_STRIDE
            src = 3 * 4096 + p * 1024 + r * 32
            staged[at:at + 32] = parts[src:src + 32]

    def word(i):
        return int(parts[i]) | (int(parts[i + 1]) << 16)

    for gw in range(2):  # band_16's groups of 2 warps: 32 lanes a warp
        for j in range(4):
            ln, cn = 32 * gw + 8 * j, 8 * j
            for p in range(3):
                for m in range(2):  # luma k-steps 2m, 2m + 1
                    rows = [(p * 64 + ln + (lane & 7)) * mk.LUM_STRIDE + 32 * m
                            + 8 * (lane >> 3) for lane in range(32)]
                    got = _ldmatrix_x4(staged, rows)
                    for lane in range(32):
                        n, k = lane >> 2, 2 * (lane & 3)
                        for h in range(2):
                            ks = 2 * m + h
                            base = p * 4096 + (ln + n) * 64 + 16 * ks + k
                            assert got[lane, 2 * h] == word(base)
                            assert got[lane, 2 * h + 1] == word(base + 8)
                rows = [lum_basis + (p * 32 + cn + (lane & 7)) * mk.CHR_STRIDE
                        + 8 * (lane >> 3) for lane in range(32)]
                got = _ldmatrix_x4(staged, rows)
                for lane in range(32):
                    n, k = lane >> 2, 2 * (lane & 3)
                    for ks in range(2):
                        base = 3 * 4096 + p * 1024 + (cn + n) * 32 + 16 * ks + k
                        assert got[lane, 2 * ks] == word(base)
                        assert got[lane, 2 * ks + 1] == word(base + 8)
    body = _body("product_staged")
    for text in ("basis + (p * 64 + ln + (lane & 7)) * kLumStride + 32 * m + "
                 "8 * (lane >> 3));",
                 "basis + kLumBasis + (p * 32 + cn + (lane & 7)) * kChrStride "
                 "+ 8 * (lane >> 3));"):
        assert text in body, text


def test_the_staged_product_keeps_k1s_chain_order():
    """Each output's two float32 chains are K1's: lo then mid into one, hi
    into the other (``product``), so the outputs stay identical."""
    staged = _body("product_staged")
    order = [m.group(1) for m in re.finditer(
        r"mma_bf16\((\w+), a[lc]\[ks\], (\w+)", staged)]
    assert order == ["ls", "ll", "cs", "cl", "ls", "cs"]
    parts = re.findall(r"mma_bf16\(\w+, a[lc]\[ks\], (\w+)\[", staged)
    assert parts == ["lo", "hi", "clo", "chi", "mid", "cmid"]
    assert re.findall(r"(lum|chr)_b\((\d)", staged) == [
        ("lum", "2"), ("lum", "2"), ("lum", "0"), ("lum", "0"), ("chr", "2"),
        ("chr", "0"), ("lum", "1"), ("lum", "1"), ("chr", "1")]
    k1 = _body("product")
    assert k1.index("bl[2][ks]") < k1.index("bl[0][ks]") < k1.index("bl[1][ks]")


# -- the SASS count of a band with one m-tile -----------------------------------


def _listing(lines):
    labels, out = {}, []
    for ln in lines:
        if ln.endswith(":"):
            labels[ln[:-1]] = len(out)
        else:
            out.append(ln)
    return [re.sub(r"@(\w+)$", lambda m: f"{16 * labels[m.group(1)]:#x}", x)
            for x in out]


def test_a_band_loop_without_an_mma_loop_is_counted():
    """At T = 16 the m-tile loop has one trip and ptxas drops it: the band
    loop holds the HMMA itself (with its spin and wait loops inside);
    ``band_path`` counts that loop's pass, the spin once."""
    ins = _listing([
        "S2R R0, SR_TID.X", "@P5 BRA @producer",
        "outer:", "NOP",
        "spin:", "LDS R2, [R3]", "@P0 BRA @spin",
        "BAR.SYNC 0x1", *["HMMA.16816.F32.BF16 R8, R4, R12, R8"] * 18,
        "BAR.SYNC 0x1", "STS [R2], R8", "@P3 BRA @outer", "EXIT",
        "producer:", "NOP",
        "ploop:", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R4",
        *["UBLKCP.S.G [UR8], [UR10], UR12"] * 8, "@P4 BRA @ploop", "EXIT",
    ])
    got = sass_loops.band_path(ins, 1)
    assert got["consumer"] == 1 + 2 + 1 + 18 + 1 + 2
    assert got["segments"] == [4, 19, 2]
    assert got["hmma_loop"] == 0 and got["producer"] == 10
    assert sass_loops.band_path(ins, 2) is None  # T/16 > 1 wants the loop
