"""The forward megakernel's KT product frame (``csrc/fwd_megakernel.cuh``,
``csrc/fwd_probe_kernel.cu``), mirrored in numpy by
``lz4jpeg_tpu_torch/profiles/megakernel.py``, on the CPU.

The KT products run on the card only.  What their frame does is held here
through its mirrors, each tied to the source's constants:

* the basis-A product's split (``basis_a_plan``): every (channel, m-tile,
  n-tile) block of a band taken once, 9 mma per 8 tiles on each of the 8
  warps at T = 32, 64, 128;
* the product in the kernel's part order (``basis_a_coefficients``, its
  blocks placed by the split) equal to the plain version of
  ``kt_basis_a`` (``megakernel_variant_ref``) on random KT blocks, a
  ragged last band too;
* each KT variant's shared memory (``kt_frame``: groups, slots, output
  rows over the operands, the staged basis) within the SM's 232,448 B,
  its groups the source's instantiations;
* the register split (setmaxnreg): both counts multiples of 8 in [24,
  256], the consumers' and producer's registers within what the launch
  holds, a scheduler's 16,384 and the SM's 65,536;
* the order of a group's bulk-store read and its next convert's writes
  over the aliased rows (``alias_events``) under random interleavings,
  and a broken order caught;
* the producer warpgroup's copies (``kt_copy_plan``): the one-warp route's
  chunks, slot offsets and swizzle, each once;
* the SASS counting by warp role (``sass_loops.kt_band_path``) on a
  synthetic listing of each split.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.ops.rle import rle_decode_sparse16
from lz4jpeg_tpu_torch.profiles import megakernel as mk
from lz4jpeg_tpu_torch.profiles import sass_loops

CSRC = Path(mk.__file__).resolve().parent.parent / "csrc"
HEADER = (CSRC / "fwd_megakernel.cuh").read_text()
PROBES = (CSRC / "fwd_probe_kernel.cu").read_text()
TILES = (32, 64, 128)


def _int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert m, name
    return int(m.group(1))


# -- the basis-A split ----------------------------------------------------------


@pytest.mark.parametrize("tiles", TILES)
def test_the_basis_a_split_takes_each_block_once_at_9_mma_a_warp(tiles):
    plan = mk.basis_a_plan(tiles)
    blocks = [tuple(r) for r in plan[:, 1:]]
    want = {(0, mt, nt) for mt in range(4) for nt in range(tiles // 8)}
    want |= {(ch, mt, nt) for ch in (1, 2) for mt in range(2)
             for nt in range(tiles // 8)}
    assert len(blocks) == len(set(blocks)) and set(blocks) == want
    mma = mk.plan_mma(plan)
    assert (mma == 9 * tiles // 8).all(), mma  # 9 per 8 tiles, every warp
    assert mma.sum() == 72 * tiles // 8


def test_the_basis_a_split_is_the_sources():
    """The mirror's split is ``basis_a_band``'s: the luma n-tiles cut at
    3T/32, the chroma warps' channel, m-tile and lanes, the staged basis's
    parts."""
    body = HEADER[HEADER.index("void basis_a_band("):]
    body = body[:body.index("\n}\n")]
    for text in ("constexpr int kSplit = 3 * V::kTiles / 32;",
                 "if (gw >= 4) {",
                 "load_basis_a<2, kChrStride, 32>(basis + kLumBasis, gw & 1, af);",
                 "for (int nt = 0; nt < V::kTiles / 8; ++nt) {",
                 "gr.chr[(gw >> 1) & 1], nt, af, gr.q,",
                 "64 + 16 * (gw & 3));",
                 "load_basis_a<4, kLumStride, 64>(basis, gw & 3, af);",
                 "for (int nt = gw < 4 ? 0 : kSplit; nt < (gw < 4 ? kSplit : "
                 "V::kTiles / 8);",
                 "product_basis_a<4, kLumStride>(gr.lum, nt, af, gr.q, "
                 "16 * (gw & 3));"):
        assert text in " ".join(body.split()), text


@pytest.mark.parametrize("n", [1024, 2048 + 48])
def test_the_product_in_the_kernels_order_is_the_plain_version(n):
    """The numpy product (lo then mid into one float32 chain, hi into the
    other, one add, the snap-trunc), placed block by block by the split,
    equals the plain version's coefficients; N = 2,096 ends on a ragged
    band."""
    kt = mk.noise_kt(n, seed=n)
    ref = mk.megakernel_variant_ref(kt, "kt_basis_a", LUM, CHR)
    want = torch.cat([rle_decode_sparse16(ref[:, a:b])
                      for a, b in ((0, 64), (64, 96), (96, 128))], dim=1)
    got = mk.basis_a_coefficients(kt.numpy(), LUM, CHR)
    assert np.array_equal(got, want.numpy())


def test_a_plan_that_skips_a_block_is_caught(monkeypatch):
    plan = mk.basis_a_plan(64)
    monkeypatch.setattr(mk, "basis_a_plan", lambda t: plan[1:])
    with pytest.raises(AssertionError, match="twice or never"):
        mk.basis_a_coefficients(mk.noise_kt(64, seed=1).numpy(), LUM, CHR)


# -- shared memory and groups ---------------------------------------------------


def _instances():
    """{variant name: (T, groups)} of the KT instantiations in the probe
    library (ids 17-25 of ``with_variant``)."""
    names = re.findall(r'"(\w+)"', PROBES[PROBES.index("kNames[] = {"):
                                          PROBES.index("constexpr int kCount")])
    cases = dict(re.findall(r"case (\d+): return f\((\w+)\{\}\);", PROBES))
    aliases = {}
    for alias, kind, t, rest in re.findall(
            r"using (\w+) = Kt(Product|Copy)<(\d+)([^;]*)>;", PROBES):
        if kind == "Product":
            groups = int(re.match(r", Stage::k\w+, (\d+)", rest).group(1))
        else:
            groups = int(rest[2:]) if rest else 3  # KtCopy's default
        aliases[alias] = (int(t), groups)
    return {names[int(i)]: aliases[a] for i, a in cases.items()
            if a in aliases}


def test_the_kt_groups_are_the_sources_instantiations():
    assert "template <int T, int Groups = 3>\nusing KtCopy" in PROBES
    inst = _instances()
    assert set(inst) == {v.name for v in mk.KT_VARIANTS}
    for name, (t, groups) in inst.items():
        assert t == mk.BY_NAME[name].tiles, name
        assert groups == mk.KT_GROUPS[name], name


@pytest.mark.parametrize("name", [v.name for v in mk.KT_VARIANTS])
def test_each_kt_frame_fits_the_sm(name):
    f = mk.kt_frame(name)
    assert 2 <= f["slots"] <= 5
    assert f["smem"] <= mk.SMEM_LIMIT
    if name in mk.KT_PRODUCTS and name != "kt_split_runs":
        # the rows (T x 128 int16) fit over the bf16 operands
        t = mk.BY_NAME[name].tiles
        assert t * 128 * 2 <= t * (mk.LUM_STRIDE + 2 * mk.CHR_STRIDE) * 2
    if name == "kt_full_128":  # two groups at T = 128, two slots at least
        assert f["groups"] == 2 and f["slots"] >= 2


def test_the_frame_mirror_constants_are_the_sources():
    assert _int("kSmemLimit") == mk.SMEM_LIMIT
    stages = re.search(r"enum class Stage \{([^}]*)\};", HEADER).group(1)
    assert [re.sub(r"(?<!^)([A-Z])", r"_\1", x.strip()[1:]).lower()
            for x in stages.split(",")] == [
        "sparse", "trunc", "copy_u8", "cast_i16", "sum_f32", "split"]
    assert mk.STAGES == ("sparse", "trunc", "copy_u8", "cast_i16", "sum_f32",
                         "split")
    assert re.search(r"constexpr int kLumStride = 64 \+ 8;", HEADER)
    assert re.search(r"constexpr int kChrStride = 32 \+ 8;", HEADER)
    assert re.search(r"constexpr int kQStride = 128 \+ 8;", HEADER)
    assert "constexpr int kLumBasis = 3 * 64 * kLumStride;" in HEADER
    assert ("constexpr int kStagedBasisBytes = (kLumBasis + 3 * 32 * "
            "kChrStride) * 2;") in HEADER
    assert mk.STAGED_BASIS_BYTES == 35_328
    # ring_slots: at most 5 slots of the band's bytes, its geometry and two
    # mbarriers beside the groups and the staged basis, 64 B spare
    assert "V::kGroups * static_cast<int>(sizeof(Group<V>)) + V::kStagedBytes;" \
        in HEADER
    assert ("constexpr int kPerSlot = V::kBandBytes + "
            "static_cast<int>(sizeof(Band)) + 16;") in HEADER
    assert "constexpr int kFit = (kSmemLimit - kFixed - 64) / kPerSlot;" in HEADER
    # the aliased group: the geometry, the operands, the staging
    kt_group = HEADER[HEADER.index("struct alignas(16) AliasGroup {"):]
    kt_group = kt_group[:kt_group.index("};")]
    assert re.findall(r"^\s+(?:Band|uint16_t|int16_t) (\w+)", kt_group,
                      re.M) == ["band", "lum", "chr", "q"]
    assert "return reinterpret_cast<int16_t*>(gr.lum);" in HEADER
    assert ("static constexpr bool kAliasOut = kProduct && kBulkOut && "
            "(In == Input::kKt || Tiles == 128 || kWide);" in " ".join(HEADER.split()))


# -- the register split ---------------------------------------------------------


def test_the_register_split_fits_what_the_launch_holds():
    consumer, producer = _int("kConsumerRegs"), _int("kProducerRegs")
    assert (consumer, producer) == (mk.KT_CONSUMER_REGS, mk.KT_PRODUCER_REGS)
    for regs in (consumer, producer):
        assert regs % 8 == 0 and 24 <= regs <= 256
    for name in mk.KT_PRODUCTS:
        f = mk.kt_frame(name)
        if f["producer_warps"] == 1:
            continue
        assert f["threads"] == 896 and f["launch_registers"] == 72
        consumers = f["groups"] * 256
        total = consumers * consumer + 32 * f["producer_warps"] * producer
        assert total <= 65_536 and total <= f["threads"] * f["launch_registers"]
        # warp w on scheduler w % 4: 6 consumer warps and 1 producer warp
        assert 6 * 32 * consumer + 32 * producer <= 16_384
    assert ('asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" '
            '::"n"(kProducerRegs));') in HEADER
    assert ('asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" '
            '::"n"(kConsumerRegs));') in HEADER
    assert "static constexpr bool kRegSplit = kKtProduct && Groups == 3;" \
        in HEADER


def test_the_launch_registers_rule_is_the_sources_and_k1s():
    assert ("16384 / (32 * ((kCtaThreads / 32 + 3) / 4)) / 8 * 8;"
            in " ".join(HEADER.split()))
    assert mk.kt_frame("kt_copy")["launch_registers"] == 72  # 25 warps, as K1
    assert mk.kt_frame("kt_split_runs")["launch_registers"] == 96


# -- the aliased rows' order ----------------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_the_store_reads_the_rows_before_the_next_convert_writes(seed):
    log = mk.alias_events(bands=5, seed=seed)
    assert log == {"violations": 0, "stores": 5}


def test_without_the_groups_barrier_a_convert_overwrites_a_read():
    caught = sum(mk.alias_events(bands=5, seed=s, barrier=False)["violations"]
                 for s in range(8))
    assert caught > 0


def test_the_alias_order_is_the_band_loops():
    loop = " ".join(HEADER[HEADER.index("void band_loop("):].split())
    wait = loop.index("bulk_wait_read(); // the last band's store has read "
                      "`out`")
    barrier = loop.index("if constexpr (V::kAliasOut) group_sync<V>(g);")
    convert = loop.index("src.convert(gr, sm.raw[s], b, tid);")
    assert wait < barrier < convert


# -- the producer warpgroup's copies --------------------------------------------


@pytest.mark.parametrize("tiles", TILES)
def test_the_producer_warpgroup_copies_each_chunk_once(tiles):
    one = mk.kt_copy_plan(tiles, 1)
    four = mk.kt_copy_plan(tiles, 4)
    as_set = lambda rows: {tuple(r) for r in rows[:, 1:]}
    assert len(four) == len(one) == 12 * tiles
    assert as_set(four) == as_set(one)  # the same slot offset per chunk
    assert np.array_equal(np.sort(four[:, 1]), 16 * np.arange(12 * tiles))
    per = tiles // 16
    for lane in range(128):  # one swizzle: pieces a multiple of 8 apart
        pieces = four[four[:, 0] == lane, 2]
        assert len(set(pieces % 8)) == 1 and (four[four[:, 0] == lane, 3]
                                              == lane % per).all()


# -- counting by warp role ------------------------------------------------------


def _listing(lines):
    """Instructions with each "@label" branch target resolved to its
    address (16 bytes an instruction)."""
    labels, out = {}, []
    for ln in lines:
        if ln.endswith(":"):
            labels[ln[:-1]] = len(out)
        else:
            out.append(ln)
    return [re.sub(r"@(\w+)$", lambda m: f"{16 * labels[m.group(1)]:#x}", x)
            for x in out]


def _kernel(balanced: bool):
    chroma_exit = [] if balanced else ["BRA @join"]
    return _listing([
        "S2R R0, SR_TID.X", "@P5 BRA @producer",
        "outer:", "NOP", "BAR.SYNC 0x1", "@P0 BRA @luma_a",
        "LDSM.16.M88.4 R4, [R2]",
        "chroma:", *["HMMA.16816.F32.BF16 R8, R4, R12, R8"] * 6,
        "IADD3 R1, R1, 0x1, RZ", "@P1 BRA @chroma", *chroma_exit,
        "luma_a:", "LDSM.16.M88.4 R4, [R3]",
        "luma:", *["HMMA.16816.F32.BF16 R8, R4, R12, R8"] * 12,
        "IADD3 R1, R1, 0x1, RZ", "@P2 BRA @luma",
        "join:", "BAR.SYNC 0x1", "@P3 BRA @outer", "EXIT",
        "producer:", "NOP",
        "ploop:", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R4",
        *["@P6 LDGSTS.E.BYPASS.128 [R2], desc[UR6][R4.64]"] * 6,
        "@P4 BRA @ploop", "EXIT",
    ])


def test_the_role_counts_of_the_balanced_split():
    """Warps 0-3 skip the chroma loop and take 6 of the band's 8 luma
    n-tiles; warps 4-7 take 8 chroma n-tiles and 2 luma ones; four
    producer warps share 768 copies, 6 a lane."""
    got = sass_loops.kt_band_path(_kernel(True), 64, 768)
    assert got["luma"]["count"] == 3 + 1 + 14 * 6 + 2
    assert got["chroma"]["count"] == 3 + 1 + 8 * 8 + 1 + 14 * 2 + 2
    assert got["producer"] == {"warps": 4, "count": 8}
    assert got["per_tile"] == (4 * 90 + 4 * 99 + 32) / 64


def test_the_role_counts_of_the_earlier_split():
    """Luma warps take all 8 luma n-tiles, chroma warps the chroma loop
    only."""
    got = sass_loops.kt_band_path(_kernel(False), 64, 768)
    assert got["luma"]["count"] == 3 + 1 + 14 * 8 + 2
    assert got["chroma"]["count"] == 3 + 1 + 8 * 8 + 1 + 2


# -- the KT colour's lane map ---------------------------------------------------


@pytest.mark.parametrize("tiles", TILES)
def test_the_kt_convert_writes_each_operand_once_with_its_colour(tiles):
    """``convert_kt`` thread by thread (``emulate_convert_kt``: the slot's
    swizzle, a unit's two addresses and channel offsets, the half-word
    turn, the staging pointers) writes each operand once, the centred
    colour of its block's pixel (the odd columns for chroma)."""
    from lz4jpeg_tpu_torch.ops.color import rgb_to_ycbcr

    band = np.random.default_rng(tiles).integers(0, 256, (3, 64, tiles),
                                                 dtype=np.uint8)
    lum, chroma = mk.emulate_convert_kt(band)
    pixels = torch.from_numpy(np.ascontiguousarray(band.transpose(2, 1, 0)))
    y, cr, cb = (c.reshape(tiles, 64).numpy().astype(np.int64) - 128
                 for c in rgb_to_ycbcr(pixels.reshape(tiles, 8, 8, 3)))
    assert np.array_equal(lum, y)
    assert np.array_equal(chroma[0], cr[:, 1::2])
    assert np.array_equal(chroma[1], cb[:, 1::2])


def test_the_kt_convert_mirror_is_the_sources():
    body = HEADER[HEADER.index("void convert_kt("):]
    body = " ".join(body[:body.index("\n}\n")].split())
    for text in ("constexpr int kChannel = 64 * (V::kTiles / 16) * 16;",
                 "const int q = 8 * (gw & 3) + ln.qq;",
                 "const int first = 2 * q + ln.h, second = 2 * q + 1 - ln.h;",
                 "const int t0 = 16 * (gw >> 2) + 4 * ln.w;",
                 "gr.lum + (t0 + ln.rot) * kLumStride + 2 * q;",
                 "gr.lum + (t0 - ln.rot) * kLumStride + 2 * q;",
                 "const uint32_t turn = ln.rot ? 0x1032u : 0x3210u;",
                 "const int j = (gw >> 2) + 2 * m;",
                 "buf + kt_chunk_offset<V>(first, j) + 4 * ln.w;",
                 "a + c * kChannel), 0, turn);",
                 "e[c] = ln.h ? y : x;",
                 "(i < 2 ? lum_lo : lum_hi) + (32 * m + i) * kLumStride;",
                 "chr[V::kTiles * kChrStride] ="):
        assert text in body, text
    assert "return ((piece * (V::kTiles / 16) + j) ^ (piece & 7)) * 16;" \
        in HEADER
    assert "return __umulhi(static_cast<uint32_t>(s), 4294968u) + 0x4B000000u;" \
        in HEADER
