"""The MCU transform kernels' maps (``csrc/mcu_transform_kernel.cu``),
mirrored in numpy by ``lz4jpeg_tpu_torch/profiles/mcu.py``, on the CPU.

The kernels run on the card only.  What they compute is held here through
their mirrors, each test naming the inputs it covers:

* the coefficient split (``split_coefficients``): integers |z| < 2⁸ need
  hi alone and |z| < 2¹⁶ hi and mid; random float32 bit patterns, ±0 and
  magnitudes up to the largest float32 rebuild exactly from three bf16
  parts;
* exact products: every product of a coefficient part and a basis part is
  exact, so each tile's part products sum to the float64 product of the
  float32 operands;
* the vote (``fragment_votes``, ``products_issued``): which parts a warp's
  fragment issues, smallest first;
* the epilogues (``snap_trunc_fast``, ``pixel_fast``): the plain versions'
  values bit for bit, and the outputs their tie tests send to the tie pass;
  the inverse's sums far below zero clamped on the float's bits, where a
  32-bit floor would wrap to 255; the tie pass needed (the fp32 chain and exact rounding part at about
  1e-5 of the A/B's pixels) and enough (every such pixel in its window);
* the maps: the k slots a permutation, the operand fragments' slots those
  of the PTX A fragment, the accumulators → staged block → device memory a
  permutation of the (16, HW) block, every shared load and store at its
  fewest wavefronts, and ``emulate`` (the maps composed) equal to the
  product;
* the ring (``chunk_plan``, ``chunk_schedule``, ``chunk_rows``): every tile
  computed once at N = 1, 5, 511, 513, a chunk ± 1 and ragged last chunks,
  every slot filled before it is read and released before it is refilled;
* the mirror's constants against the source.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lz4jpeg_tpu_torch.ops.fused import _table_key, forward_basis, inverse_basis
from lz4jpeg_tpu_torch.ops.fwd_megakernel import split_basis
from lz4jpeg_tpu_torch.ops.quantize import (
    CHROMINANCE_QUANTIZATION_TABLE as CHR,
    LUMINANCE_QUANTIZATION_TABLE as LUM,
)
from lz4jpeg_tpu_torch.profiles import mcu

SOURCE = (Path(mcu.__file__).resolve().parent.parent / "csrc"
          / "mcu_transform_kernel.cu")
SHAPES = [(8, LUM), (4, CHR)]  # (width, table); height 8


def _parts(z: np.ndarray) -> np.ndarray:
    return mcu.split_coefficients(torch.from_numpy(z)).numpy()


def _is_bf16(x: np.ndarray) -> bool:
    return bool((x.view(np.uint32) & 0xFFFF == 0).all())


def _basis(kind, width, table):
    key = _table_key(table)
    b = (forward_basis(width, 8, key)[0] if kind == "forward"
         else inverse_basis(width, 8, key))
    return np.asarray(b, dtype=np.float32)


# -- the coefficient split ----------------------------------------------------------


@pytest.mark.parametrize("bits,needs", [(8, 1), (16, 2)])
def test_integer_coefficients_need_one_or_two_parts(bits, needs):
    """Every integer |z| < 2^bits (all of them for 8 bits, 200,000 random
    ones and the edges for 16) rebuilds from its first ``needs`` parts; the
    rest are zero, and for 16 bits some need mid."""
    top = 1 << bits
    if bits == 8:
        z = np.arange(-top + 1, top)
    else:
        rng = np.random.default_rng(16)
        z = np.concatenate([rng.integers(-top + 1, top, 200_000),
                            [top - 1, -(top - 1), top // 2 + 1, 257, -257]])
    z = z.astype(np.float32)
    p = _parts(z)
    assert (p[needs:] == 0).all()
    assert np.array_equal(p[:needs].astype(np.float64).sum(0), z)
    assert _is_bf16(p)
    if needs == 2:
        assert (p[1] != 0).any()


@pytest.mark.parametrize("case", ["random bits", "signed zeros", "large",
                                  "small", "codec"])
def test_every_finite_coefficient_rebuilds_from_three_parts(case):
    """hi + mid + lo == z exactly (in float64), each part a bf16 value:
    1,000,000 random finite bit patterns with |z| ≥ 2⁻¹¹⁰ (``random
    bits``), ±0, magnitudes from 2¹⁰⁰ to the largest float32 (whose hi is
    clamped to bf16's largest finite value), 2⁻¹¹⁰ ≤ |z| < 1, and quantized
    coefficients with fractions."""
    rng = np.random.default_rng(len(case))
    if case == "random bits":
        z = rng.integers(0, 2**32, 1_000_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
        z = z[np.isfinite(z) & ((np.abs(z) >= 2.0**-110) | (z == 0))]
    elif case == "signed zeros":
        z = np.array([0.0, -0.0], dtype=np.float32)
    elif case == "large":
        z = np.concatenate([
            np.ldexp(rng.uniform(1, 2, 10_000), rng.integers(100, 128, 10_000)),
            [np.finfo(np.float32).max, 3.3961e38, 3.3895e38]]).astype(np.float32)
        z = np.concatenate([z, -z])
    elif case == "small":
        z = np.ldexp(rng.uniform(1, 2, 100_000),
                     rng.integers(-110, 0, 100_000)).astype(np.float32)
    else:
        z = (rng.integers(-2000, 2000, 100_000)
             + rng.uniform(-0.5, 0.5, 100_000)).astype(np.float32)
    p = _parts(z)
    assert np.isfinite(p).all() and _is_bf16(p)
    assert np.array_equal(p.astype(np.float64).sum(0), z.astype(np.float64))
    assert np.array_equal(np.signbit(p[0]) & (p[0] != 0),
                          np.signbit(z) & (z != 0))


def test_the_split_is_split_basis_below_the_clamp():
    """Below bf16's largest finite value the coefficients' split is
    ``split_basis``'s, value for value."""
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(50_000) * np.exp(rng.uniform(-30, 30, 50_000))
         ).astype(np.float32)
    assert np.array_equal(_parts(z), split_basis(z))


# -- exact products ------------------------------------------------------------------


@pytest.mark.parametrize("width,table", SHAPES)
@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_part_products_sum_to_the_product(kind, width, table):
    """Per tile (64 random ones) and output: each part product z_a · m_b is
    exact in float64, their 9 · HW terms sum (math.fsum) to the float64
    product of the float32 operands; the forward's A, x − 128, is one exact
    part."""
    hw = 8 * width
    rng = np.random.default_rng(hw)
    m = _basis(kind, width, table)
    mp = split_basis(m).astype(np.float64)
    if kind == "forward":
        z = (rng.integers(0, 256, (64, hw)) - 128).astype(np.float32)
    else:
        z = (rng.standard_normal((64, hw)) * 500).astype(np.float32)
    zp = _parts(z).astype(np.float64)
    z64 = z.astype(np.float64)
    m64 = m.astype(np.float64)
    for t in range(64):
        for o in range(hw):
            terms = (zp[:, None, t, :] * mp[None, :, o, :]).ravel()
            assert np.array_equal(
                (zp[:, None, t, :] * mp[None, :, o, :]).sum((0, 1)),
                z64[t] * m64[o])
            assert math.fsum(terms) == math.fsum(z64[t] * m64[o])


# -- the vote ------------------------------------------------------------------------


@pytest.mark.parametrize("block,live", [
    ("zeros", (False, False, False)),
    ("negative zeros", (False, False, False)),
    ("bytes", (True, False, False)),
    ("int16", (True, True, False)),
    ("one fraction", (True, True, True)),
    ("fractions", (True, True, True)),
])
def test_the_vote_issues_the_parts_a_fragment_needs(block, live):
    """On a (16, 64) block: all ±0 issue nothing; integers |z| < 256 hi
    alone (3 products); |z| < 2¹⁶ hi and mid (6); one value with a fraction
    among integers, or random fractions, all nine; in order from the
    smallest level pa + pb to the largest."""
    rng = np.random.default_rng(5)
    z = {
        "zeros": np.zeros((16, 64)),
        "negative zeros": -np.zeros((16, 64)),
        "bytes": rng.integers(-255, 256, (16, 64)),
        "int16": rng.integers(-30000, 30000, (16, 64)),
        "one fraction": np.where(np.arange(16 * 64).reshape(16, 64) == 77,
                                 0.1, rng.integers(-9, 9, (16, 64))),
        "fractions": rng.uniform(-300, 300, (16, 64)),
    }[block].astype(np.float32)
    assert mcu.fragment_votes(torch.from_numpy(z)) == live
    issued = mcu.products_issued(live)
    assert len(issued) == 3 * sum(live)
    assert all(live[pa] and 0 <= pb <= 2 for pa, pb in issued)
    levels = [pa + pb for pa, pb in issued]
    assert levels == sorted(levels, reverse=True)
    if all(live):
        assert issued[0] == (2, 2) and issued[-1] == (0, 0)


def test_the_forward_issues_its_basis_parts_smallest_first():
    assert mcu.products_issued((True, False, False), "forward") == [
        (0, 2), (0, 1), (0, 0)]


def test_inverse_products_counts_the_parts_of_each_tile():
    z = torch.zeros((4, 64))
    z[1, 3] = 7.0          # hi
    z[2, 0] = 1000.0 + 1   # hi, mid
    z[3, 5] = 0.1          # hi, mid, lo
    assert mcu.inverse_products(z) == 3 * (0 + 1 + 2 + 3)


# -- the epilogues -------------------------------------------------------------------


def _ratios(rng, n):
    """Float32 ratios: uniform in ±1100, integers and integers ± snap_eps
    ± a few ulps, ±0 and halves: the output steps and the snap's edges."""
    f32 = np.float32
    ints = rng.integers(-1024, 1025, n).astype(f32)
    ulps = rng.integers(-3, 4, n).astype(f32)
    edges = np.concatenate([
        ints, ints + f32(1e-5), ints - f32(1e-5), ints + f32(0.5),
        (ints + f32(1e-5)) * (f32(1) + ulps * f32(2**-23)),
        (ints - f32(1e-5)) * (f32(1) + ulps * f32(2**-23)),
        [0.0, -0.0]]).astype(f32)
    return np.concatenate([rng.uniform(-1100, 1100, n).astype(f32), edges])


def test_the_forward_epilogue_is_the_plain_snap_trunc():
    """``snap_trunc_fast`` gives ``ops/color.py::_snap_trunc``'s float32
    value bit for bit (signed zeros too) on 200,000 random ratios and
    1,400,002 at the snap's edges; ``near`` marks the ratios within the tie
    window of a step n − snap_eps (in float64, more than an ulp of 1024
    from the window's own edges), about 2 · TIE_WINDOW of random ratios."""
    from lz4jpeg_tpu_torch.ops.color import _snap_trunc

    rng = np.random.default_rng(11)
    r = _ratios(rng, 200_000)
    got, near = mcu.snap_trunc_fast(r)
    want = _snap_trunc(torch.from_numpy(r), 1e-5).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    x = np.abs(r.astype(np.float64)) + float(np.float32(1e-5))
    d = np.abs(x - np.round(x))  # to the nearest step
    clear = np.abs(d - mcu.TIE_WINDOW) > 1e-4  # float32 ulps of |r| ≤ 1100
    assert np.array_equal(near[clear], (d < mcu.TIE_WINDOW)[clear])
    share = near[:200_000].mean()
    assert 1.5 * mcu.TIE_WINDOW < share < 2.5 * mcu.TIE_WINDOW


# Sums whose v = acc + 128.5 lies in (-2²⁴, -2²³), where v + 2²³ rounded
# toward zero is a negative float: its bits less 2²³'s wrap in 32 bits.
WRAPPING = [-1.2e7, -(2.0**23) - 200, -(2.0**24) + 129, -9e6, -1.6e7,
            -(2.0**23) - 131]


def test_the_inverse_epilogue_is_the_plain_round_clamp_off_ties():
    """``pixel_fast`` gives ``ops/fused.py::_round_clamp(acc + 128)``'s byte
    wherever it does not mark the sum ``near`` (there the tie pass takes
    the reference's byte) on 200,000 random sums in ±1000, at every
    half-integer pixel and a few ulps off it, at ±0, past ±2²³ and at
    ±inf; ``near`` marks the pixels within the tie window of a
    half-integer whose byte the tie can change, about 2 · TIE_WINDOW of
    the random sums in [0, 255], every half-integer pixel from 0.5 to
    254.5, and no pixel the clamp decides.  Also far below zero, where v +
    2²³ is a negative float (-2²⁴ < v < -2²³) and a 32-bit floor would
    wrap to 255."""
    from lz4jpeg_tpu_torch.ops.fused import _round_clamp

    f32 = np.float32
    rng = np.random.default_rng(12)
    halves = np.arange(-300, 600).astype(f32) + f32(0.5) - f32(128)
    ulps = rng.integers(-3, 4, halves.size).astype(f32)
    acc = np.concatenate([
        rng.uniform(-1000, 1000, 200_000).astype(f32), halves,
        np.nextafter(halves, f32(1e9)), np.nextafter(halves, f32(-1e9)),
        halves * (f32(1) + ulps * f32(2**-23)),
        [0.0, -0.0, -128.0, 3e7, -3e7, 2.0**30, np.inf, -np.inf],
        WRAPPING]).astype(f32)
    got, near = mcu.pixel_fast(acc)
    want = _round_clamp(torch.from_numpy(acc) + 128.0).numpy()
    assert np.array_equal(got[~near], want[~near])
    pix = acc[:200_000].astype(np.float64) + 128
    d = np.abs(np.abs(pix) - np.floor(np.abs(pix)) - 0.5)
    inside = (pix > 0.1) & (pix < 254.9)  # the byte can change at the tie
    clear = (np.abs(d - mcu.TIE_WINDOW) > 1e-4) & inside
    assert np.array_equal(near[:200_000][clear], (d < mcu.TIE_WINDOW)[clear])
    assert not near[:200_000][(pix < -1) | (pix > 256)].any()
    share = near[:200_000][inside].mean()
    assert 1.5 * mcu.TIE_WINDOW < share < 2.5 * mcu.TIE_WINDOW
    h = halves + f32(128)
    assert near[200_000:200_000 + halves.size][(h >= 0.5) & (h <= 254.5)].all()


@pytest.mark.parametrize("acc", WRAPPING)
def test_the_inverse_epilogue_clamps_sums_far_below_zero(acc):
    """A sum far below zero gives the byte 0, as ``_round_clamp`` does, and
    is no tie; clamping the signed 32-bit floor, not the bits, would wrap
    to a large positive int and give 255."""
    from lz4jpeg_tpu_torch.ops.fused import _round_clamp

    a = np.array([acc], dtype=np.float32)
    v = a + np.float32(128.5)  # the kernel's float32 sum
    assert -(2.0**24) < v[0] < -(2.0**23)
    got, near = mcu.pixel_fast(a)
    want = _round_clamp(torch.from_numpy(a) + 128.0).numpy()
    assert got[0] == want[0] == 0 and not near[0]
    bits = mcu._rz32(v.astype(np.float64) + mcu.K23).view(np.int32)
    signed = (bits.astype(np.int64) - int(np.float32(mcu.K23).view(np.int32))
              + 2**31) % 2**32 - 2**31  # the card's int32 subtraction
    assert signed[0] > 255


@pytest.mark.parametrize("width,table", SHAPES)
def test_the_tie_pass_is_needed_and_enough(width, table, capsys):
    """On the quantized coefficients of 20,000 random tiles, the fp32 FMA
    chain in index order (the order of the plain version's product, and of
    the tie pass) rounds some pixels to the other side of a half-integer
    than exact rounding does (printed with -s: about 1e-5 of the pixels,
    the size of the 1e-5 flip cap, so no other order may stand in for
    it), and every such pixel lies inside the tie window, where the kernel
    takes the chain's byte."""
    hw = 8 * width
    rng = np.random.default_rng(21)
    tiles = torch.from_numpy(rng.integers(0, 256, (20_000, 8, width),
                                          dtype=np.uint8))
    z = mcu.fused_forward_candidate_ref(tiles, table, width, 8).numpy()
    m = _basis("inverse", width, table).astype(np.float64)
    z64 = z.astype(np.float64)
    exact = z64 @ m.T + 128.0
    acc = np.zeros_like(exact, dtype=np.float32)
    for k in range(hw):  # fmaf: the product is exact in float64
        acc = (z64[:, k:k + 1] * m[:, k] + acc).astype(np.float32)
    chain = (acc + np.float32(128)).astype(np.float64)

    def c_round(v):
        return np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), 0, 255)

    differ = c_round(chain) != c_round(exact)
    with capsys.disabled():
        print(f"HW {hw}: the chain and exact rounding differ in "
              f"{int(differ.sum())} of {differ.size} pixels")
    assert differ.any()
    assert differ.mean() < 3e-5
    gap = np.abs(exact - np.floor(exact) - 0.5)[differ]
    assert (gap < mcu.TIE_WINDOW / 4).all()


# -- the maps ------------------------------------------------------------------------


def _wavefronts(byte_addrs: np.ndarray, width: int) -> int:
    """Shared-memory wavefronts of one warp access of ``width`` bytes a lane
    at these byte addresses: the warp is served in phases of 128 bytes'
    worth of lanes (8 lanes of 16 bytes, 16 of 8, all 32 below), each phase
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
@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_operands_fill_the_ptx_fragment_slots(kind, hw):
    """The slot map is a permutation of k; the element a lane puts in each
    A register half sits at the slot the PTX A fragment gives that half,
    each (row, element) once; the basis parts in slot order, contiguous as
    the kernel reads them, rebuild the float32 basis."""
    sigma = mcu.slot_map(hw, kind)
    assert np.array_equal(np.sort(sigma), np.arange(hw))
    fill = mcu.operand_map(hw, kind)
    frag = mcu.a_fragment_slot(hw)
    assert np.array_equal(fill[..., 0], frag[..., 0])
    assert np.array_equal(sigma[fill[..., 1]], frag[..., 1])
    cells = (fill[..., 0] * hw + fill[..., 1]).ravel()
    assert np.array_equal(np.sort(cells), np.arange(16 * hw))
    width = hw // 8
    table = LUM if hw == 64 else CHR
    dev_parts = mcu.device_parts(kind, width, 8, _table_key(table),
                                 torch.device("cpu"))
    assert dev_parts.is_contiguous()  # the kernel reads raw (3, HW, HW)
    bits = dev_parts.numpy().view(np.uint16)
    parts = (bits.astype(np.uint32) << 16).view(np.float32)
    assert np.array_equal(parts.astype(np.float64).sum(0)[:, sigma],
                          _basis(kind, width, table))


@pytest.mark.parametrize("hw", [64, 32])
@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_the_block_maps_are_permutations(kind, hw):
    """Accumulators → staged block: each (row, column) of the (16, HW)
    block once; the staging stores write each staged element once; the
    16-byte stores to device memory take each vector of each row once and
    each instruction whole 128-byte lines."""
    acc = mcu.accumulator_map(hw)
    assert acc.shape == (32, hw // 8, 4, 2)
    cells = (acc[..., 0] * hw + acc[..., 1]).ravel()
    assert np.array_equal(np.sort(cells), np.arange(16 * hw))
    row_bytes = mcu.stage_row_bytes(hw, kind)
    elem = 4 if kind == "forward" else 1
    written = np.concatenate([
        (offs[:, None] + elem * np.arange(size // elem)[None, :]).ravel()
        for size, offs in mcu.stage_stores(hw, kind)])
    want = (np.arange(16)[:, None] * row_bytes
            + elem * np.arange(hw)[None, :]).ravel()
    assert np.array_equal(np.sort(written), np.sort(want))
    vec = 16 // elem
    seen = []
    for rows, q in mcu.store_map(hw, kind):
        assert q.max() < hw // vec
        addr = rows * hw * elem + 16 * q  # bytes from the block's first row
        lines = addr // 128
        for line in set(lines):
            assert (lines == line).sum() == 8  # 8 vectors: the whole line
        seen.append(rows * (hw // vec) + q)
    seen = np.concatenate(seen)
    assert np.array_equal(np.sort(seen), np.arange(16 * hw // vec))


@pytest.mark.parametrize("hw", [64, 32])
@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_shared_accesses_take_their_fewest_wavefronts(kind, hw):
    """The A loads from the ring slot, every ldmatrix of the basis, the
    staging stores and the 16-byte reads of the staged block: each at
    (bytes a warp moves) / 128 wavefronts."""
    for size, offs in mcu.operand_loads(hw, kind):
        assert _wavefronts(offs, size) == 32 * size // 128
    for addrs in mcu.basis_loads(hw):
        for m in range(4):  # each 8×8 matrix: 8 rows of 16 bytes
            assert _wavefronts(addrs[8 * m:8 * m + 8], 16) == 1
        assert (addrs % 16 == 0).all()  # 16-byte aligned rows
    for size, offs in mcu.stage_stores(hw, kind):
        assert _wavefronts(offs, size) == max(1, 32 * size // 128)
    row_bytes = mcu.stage_row_bytes(hw, kind)
    for rows, q in mcu.store_map(hw, kind):
        assert _wavefronts(rows * row_bytes + 16 * q, 16) == 4


def test_a_bank_conflict_is_caught():
    """Without the inverse's v ^ (g & 1) order, rows g and g + 1 of a load
    phase hit the same banks; without the staging pad, the forward's float2
    stores of rows g to g + 3 do: twice and four times their fewest."""
    lane = np.arange(32)
    g, c = lane // 4, lane % 4
    assert _wavefronts((g * 64 + 4 * c) * 4, 16) == 2 * 4
    assert _wavefronts(g * 64 * 4 + 8 * c, 8) == 4 * 2


@pytest.mark.parametrize("width,table", SHAPES)
@pytest.mark.parametrize("kind,data", [
    ("forward", "pixels"), ("inverse", "codec"), ("inverse", "int16"),
    ("inverse", "fractions"), ("inverse", "mixed blocks")])
def test_emulate_computes_the_product(kind, data, width, table):
    """The maps composed (``emulate``) on 37 tiles (two full warp blocks
    and a ragged one) equal the float64 product of the float32 operands:
    exactly for the forward's pixels, within float64 rounding for the
    inverse's coefficients: quantized ones, integers to 2¹⁵, fractions to
    ±500, and blocks that issue one, two and three parts."""
    hw = 8 * width
    rng = np.random.default_rng(hw + len(data))
    m = _basis(kind, width, table).astype(np.float64)
    if kind == "forward":
        x = torch.from_numpy(rng.integers(0, 256, (37, 8, width), dtype=np.uint8))
        want = (x.reshape(37, hw).numpy() - 128.0) @ m.T
        assert np.array_equal(mcu.emulate(kind, x, table, width, 8), want)
        return
    tiles = torch.from_numpy(rng.integers(0, 256, (37, 8, width), dtype=np.uint8))
    codec = mcu.fused_forward_candidate_ref(tiles, table, width, 8).numpy()
    z = {"codec": codec,
         "int16": rng.integers(-2**15, 2**15, (37, hw)),
         "fractions": rng.uniform(-500, 500, (37, hw)),
         "mixed blocks": np.concatenate([codec[:16], codec[16:32] * 300,
                                         codec[32:] + 0.25])}[data]
    z = torch.from_numpy(np.asarray(z, dtype=np.float32))
    want = z.numpy().astype(np.float64) @ m.T
    got = mcu.emulate(kind, z, table, width, 8)
    assert np.allclose(got, want, rtol=1e-12, atol=1e-9)


# -- the ring ------------------------------------------------------------------------


def _ring_ok(sched: np.ndarray, stages: int, seed: int) -> bool:
    """One CTA's producer and its ``mcu.WARPS`` consumer warps on ``sched``
    in a seeded random interleaving, each mbarrier as its count of completed
    phases (a wait on parity p passes while the count's parity is not p):
    "full" completes on the producer's fill, "empty" on the warps'
    arrivals.  Asserts that a fill finds its slot released and a read the
    chunk it expects; a deadlock raises."""
    rng = np.random.default_rng(seed)
    warps = mcu.WARPS
    full, empty, arrived = [0] * stages, [0] * stages, [0] * stages
    holds = [None] * stages
    fills, reads, t = 0, [0] * warps, len(sched)
    while fills < t or min(reads) < t:
        ready = []
        if fills < t and (empty[sched[fills][1]] & 1) != sched[fills][2]:
            ready.append(-1)
        ready += [w for w in range(warps) if reads[w] < t
                  and (full[sched[reads[w]][1]] & 1) != sched[reads[w]][3]]
        assert ready, "deadlock"
        who = ready[rng.integers(len(ready))]
        if who < 0:
            chunk, s = sched[fills][:2]
            assert holds[s] is None, "a slot refilled before its release"
            holds[s], full[s], fills = chunk, full[s] + 1, fills + 1
        else:
            chunk, s = sched[reads[who]][:2]
            assert holds[s] == chunk, "a read found another chunk"
            arrived[s] += 1
            if arrived[s] == warps:
                arrived[s], holds[s] = 0, None
                empty[s] += 1
            reads[who] += 1
    return True


C = mcu.CHUNK
TILE_COUNTS = (1, 5, 511, 513, C - 1, C, C + 1, 3 * C + 17, 2_097_152)


@pytest.mark.parametrize("n", TILE_COUNTS)
@pytest.mark.parametrize("resident", [1, 3, 264])
@pytest.mark.parametrize("kind", ["forward", "inverse"])
def test_the_chunk_plan_computes_every_tile_once(kind, n, resident):
    """Chunk → CTA and slot, chunk → warps' rows: every tile of N once,
    the last chunk's rows only; CTAs within one chunk of each other; the
    first and the last CTA's rings (up to 200 chunks) run in the mbarrier
    model."""
    plan = mcu.chunk_plan(n, resident, kind)
    assert plan.chunks == -(-n // C) and plan.ctas == min(plan.chunks, resident)
    sched = mcu.chunk_schedule(plan)
    chunks = np.concatenate([s[:, 0] for s in sched])
    assert np.array_equal(np.sort(chunks), np.arange(plan.chunks))
    counts = [len(s) for s in sched]
    assert max(counts) - min(counts) <= 1
    if n <= 4 * C + 100:
        tiles = [t0 + r for ch in chunks for t0, rows in mcu.chunk_rows(plan, n, ch)
                 for r in range(rows)]
        assert sorted(tiles) == list(range(n))
    last = mcu.chunk_rows(plan, n, plan.chunks - 1)
    assert sum(rows for _, rows in last) == n - (plan.chunks - 1) * C
    for b in {0, plan.ctas - 1}:
        if len(sched[b]) <= 200:
            assert _ring_ok(sched[b], plan.stages, seed=n + b)


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("chunks_a_cta", [1, 2, 4, 5, 9])
def test_the_ring_ends_before_on_and_past_a_wrap(stages, chunks_a_cta):
    plan = mcu.chunk_plan((3 * chunks_a_cta - 1) * C - 7, 3, "inverse")
    plan = plan._replace(stages=stages)
    for cta in mcu.chunk_schedule(plan):
        assert np.array_equal(cta[:, 1], np.arange(len(cta)) % stages)
        for seed in range(3):
            assert _ring_ok(cta, stages, seed)


def test_a_wrong_parity_is_caught():
    plan = mcu.chunk_plan(20 * C, 1, "forward")
    good = mcu.chunk_schedule(plan)[0]
    for bad in (good[:, [0, 1, 3, 3]], good[:, [0, 1, 2, 2]]):
        with pytest.raises(AssertionError):
            for seed in range(20):
                _ring_ok(bad, plan.stages, seed)


def test_the_mirror_matches_the_source():
    """The mirror's constants are the source's, and the shared memory of
    each instantiation its Shape's sum."""
    text = SOURCE.read_text()
    assert re.search(r"constexpr int kWarps = (\d+);", text)[1] == str(mcu.WARPS)
    assert "constexpr int kChunk = 16 * kWarps;" in text
    assert (f"kStages = Forward ? {mcu.STAGES['forward']} : "
            f"{mcu.STAGES['inverse']};") in text
    assert mcu.CTAS_PER_SM["forward"] == mcu.CTAS_PER_SM["inverse"]
    assert f"kCtasPerSm = {mcu.CTAS_PER_SM['forward']};" in text
    assert "kTieWindow = 1.0f / 4096.0f" in text and mcu.TIE_WINDOW == 2**-12
    assert "min(max(bits, kBits23), kBits23 + 255)" in text
    assert re.search(r"kBits23 = 0x([0-9A-F]+);", text)[1] == (
        f"{int(np.float32(mcu.K23).view(np.int32)):X}")
    assert (f"(HW == 64 ? {mcu.PIXEL_ROW[64]} : {mcu.PIXEL_ROW[32]})") in text
    assert {(k, hw): mcu.smem_bytes(hw, k) for k in mcu.KINDS
            for hw in (64, 32)} == {
        ("forward", 64): 27_648 + 3 * 4096 + 4 * 16 * 288 + 48,
        ("forward", 32): 7_680 + 3 * 2048 + 4 * 16 * 160 + 48,
        ("inverse", 64): 27_648 + 2 * 16_384 + 4 * 16 * 80 + 32,
        ("inverse", 32): 7_680 + 2 * 8192 + 4 * 16 * 48 + 32}
    assert mcu.chunk_plan(2_097_152, 264, "forward").threads == 160
