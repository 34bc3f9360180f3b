// The body of the forward megakernel (K1, csrc/fwd_megakernel.cu) as a
// template over a compile-time Variant.
//
// csrc/fwd_megakernel.cu instantiates K1's variant only (K1Variant below:
// its design is described there).  csrc/fwd_probe_kernel.cu instantiates
// the attribution variants that port profiles/probe_megakernel_ablate.py and
// profiles/probe_megakernel_dma.py (each turns one part of K1 off or builds
// it up from a bare copy, so the difference of two variants' times is the
// cost of that part), and the layout variants that port
// profiles/probe_megakernel.py, probe_megakernel_t.py and
// probe_megakernel_v2.py (K1's work read from the KT block layout).  A
// Variant fixes
//   - kTiles: T, the band in tiles of one block row (16, 32, 64 or 128);
//   - kParts: 3 bf16 basis parts (hi + mid + lo, K1's exact split) or 1
//     (hi only: the TPU's one-pass bf16 product, DEFAULT precision);
//   - kColour: YCbCr (K1), R feeding all three channels, or R, G, B feeding
//     the luma, Cr and Cb products raw (the ladder's dots);
//   - kChannels: 3, or luma only (64 output lanes);
//   - kStage: what the band stores: the sparse-delta epilogue (K1), the same
//     split into the luma, Cr and Cb outputs with each block's run counts,
//     truncated coefficients, or no product at all: R[0:64], G[0:32] and
//     B[0:32] of each tile copied as u8, cast to i16, or through f32
//     (lanes 64-95 hold G + B);
//   - kCentred: samples v - 128 with the offsets folded in and snap-trunc
//     (K1), or raw v with no offset, truncated toward zero;
//   - kBlockMajor: block-major (N, lanes) output (K1) or coefficient-major
//     (lanes, N), staged transposed in shared memory so that each lane's T
//     values go out as one contiguous run;
//   - kGroups: the consumer groups of a CTA: 3 (K1: 25 warps an SM hold
//     72 registers a thread; the KT products: 28 warps, whose producer
//     warpgroup hands registers to the consumers, below), 2 where a variant
//     needs more registers than 72 without spilling or at T = 128 (a
//     product group takes 74 KB there, its output rows over its operands),
//     1 for the KT copy at T = 128, or 12 groups of 2 warps for the
//     16-tile band (kWide, below);
//   - kInput: (B, H, W, 3) RGB image bands (K1) or slabs of T blocks of the
//     (3, 64, N) KT layout (ops/fwd_megakernel.py::rgb_to_kt): 192 row
//     pieces of T bytes at stride N, the same 192·T bytes as an image band
//     (the i16 cast copies only the 128 pieces it reads);
//   - kBasisA: the samples as the mma's A operand (K1: the product comes out
//     (tile, lane)) or the basis (it comes out (lane, tile) and is written
//     transposed into the staging: the TPU production kernel's "dot, then
//     transpose out").
// Every value a variant computes feeds a stored output, so the compiler
// removes nothing that a variant's time claims to include.
//
// The CTA (band_loop below): one producer warp fills a ring of band slots,
// each with a "full" and an "empty" mbarrier and the band's geometry
// beside it; kGroups consumer groups of 8 warps (2 in the 16-tile band's
// frame, below) take the CTA's bands in turn (band i of the CTA: slot i %
// slots, group i % kGroups) and wait only on their own named barrier, so
// one group's epilogue and store overlap the others' colour and product,
// and the ring's loads overlap them all.
//
// The 16-tile band's frame (kWide).  One producer warp issues a band's
// eight bulk copies (their addresses, uniform registers and geometry, ~230
// instructions, dependent) no faster than one band in ~1,500 clocks (an
// H100 80GB HBM3 at 700 W), the pace of 16-tile bands on an SM: four
// producer warps take the CTA's bands in turn (kProducers), each filling
// its own ring slots.  A band's fixed costs (the slot's wait, the group's
// barriers, the store pass's addresses and its bulk store: ~220
// instructions a warp) are paid by fewer warps a band, and more bands are
// in flight an SM: 12 groups of 2 warps (28 warps with the producers, K1's
// 72 registers), each warp taking 32 luma and 32 chroma lanes, four times
// a group of 8's.  Its basis fragments would then take 144 registers, so
// the basis is staged in shared memory once a CTA (as the basis-A
// product's) and each band's fragments come by ldmatrix (product_staged).
// The output rows lie over the operands (AliasGroup), and the ring holds
// K1's bytes in flight (kRingBytes: 20 slots of 3 KB, against 5 for a
// count), which shared memory then allows.
//
// The KT products' frame.  Their colour from the KT slab and their product
// need more than 72 registers a thread, what 25 warps an SM leave.  At
// three groups their producer is a whole warpgroup (warps 24-27, 896
// threads, launched at 72 registers): it drops to kProducerRegs
// (setmaxnreg.dec) and the consumer warpgroups rise to kConsumerRegs
// (setmaxnreg.inc) on the two sides of one branch that never rejoins, and
// its four warps share the band's 16-byte copies.  A KT product group's
// unpadded output rows alias its bf16 operands (AliasGroup), dead once the
// product has passed the group's barrier, so that three groups at T = 64
// (with the basis-A variant's staged basis) and two at T = 128 fit beside
// the ring: a group's storing thread waits for its last bulk store to have
// read the rows, then the group's barrier, before the next convert writes
// them.  The RGB T = 128 band takes the same layout and fits two groups
// (74 KB a group, 106 KB with rows of its own).

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;              // threads of a group of 8 warps
constexpr int kLumStride = 64 + 8;         // bf16 per operand row (+16 B:
constexpr int kChrStride = 32 + 8;         //  conflict-free ldmatrix)
constexpr int kQStride = 128 + 8;          // int16 per staged output row
constexpr int kBias = 1024;                // SPARSE16_DELTA_BIAS
constexpr int kLumPart = 64 * 64;          // bf16 values of one luma part
constexpr int kChrPart = 32 * 32;
constexpr int kSmemLimit = 232448;         // dynamic shared memory a CTA
constexpr int kRingBytes = 5 * 8 * 64 * 24;  // K1's ring: 5 slots of T = 64
constexpr int kConsumerRegs = 80;          // the KT products' setmaxnreg
constexpr int kProducerRegs = 24;          //  (consumers .inc, producer .dec)
// The basis staged once a CTA for the basis-A product's ldmatrix: the
// three luma parts (64 × 64) and the three chroma parts (32 × 32), rows
// padded 16 B (conflict-free, as the operands).
constexpr int kLumBasis = 3 * 64 * kLumStride;  // bf16 values
constexpr int kStagedBasisBytes = (kLumBasis + 3 * 32 * kChrStride) * 2;

enum class Colour { kYCbCr, kR, kRGB };
enum class Stage { kSparse, kTrunc, kCopyU8, kCastI16, kSumF32, kSplit };
enum class Input { kRgb, kKt };

template <int Tiles, int Parts, Colour C, int Channels, Stage S, bool Centred,
          bool BlockMajor, int Groups = 3, Input In = Input::kRgb,
          bool BasisA = false>
struct Variant {
  static constexpr int kTiles = Tiles;
  static constexpr int kParts = Parts;
  static constexpr Colour kColour = C;
  static constexpr int kChannels = Channels;
  static constexpr Stage kStage = S;
  static constexpr bool kCentred = Centred;
  static constexpr bool kBlockMajor = BlockMajor;
  static constexpr int kGroups = Groups;
  static constexpr Input kInput = In;
  static constexpr bool kBasisA = BasisA;
  static constexpr bool kDeltas = S == Stage::kSparse || S == Stage::kSplit;
  static constexpr bool kProduct = kDeltas || S == Stage::kTrunc;
  static constexpr int kLanes = Channels == 3 ? 128 : 64;
  static constexpr int kRowBytes = Tiles * 24;  // one image row of a band
  static constexpr int kBandBytes = 8 * kRowBytes;
  // Block-major rows leave by one bulk store a band (the split stage's
  // three outputs and coefficient-major runs by thread stores).
  static constexpr bool kBulkOut = BlockMajor && S != Stage::kSplit;
  using Out = std::conditional_t<S == Stage::kCopyU8, uint8_t, int16_t>;
  // Coefficient-major staging: one row of T outputs (+16 B) per lane.
  static constexpr int kLaneStride = Tiles + 16 / static_cast<int>(sizeof(Out));
  static constexpr int kQElems =
      BlockMajor ? Tiles * kQStride
                 : (kLanes * kLaneStride * static_cast<int>(sizeof(Out)) + 1) / 2;
  static constexpr int kOutElems = kBulkOut ? Tiles * kLanes : 8;
  // The KT products' frame (above): a producer warpgroup at three groups,
  // output rows over the operands, the staged basis of the basis-A product.
  // The RGB T = 128 product's rows over its operands too; the 16-tile
  // band's groups of 2 warps on a staged basis (kWide, above).
  static constexpr bool kKtProduct = In == Input::kKt && kProduct;
  static constexpr bool kRegSplit = kKtProduct && Groups == 3;
  static constexpr bool kWide = Groups > 4;
  static constexpr bool kAliasOut =
      kProduct && kBulkOut && (In == Input::kKt || Tiles == 128 || kWide);
  // Producer warps: the register split's warpgroup shares each band's
  // copies; the 16-tile band's four take the CTA's bands in turn
  // (kProducers), each filling its own slots.
  static constexpr int kProducerWarps = kRegSplit || kWide ? 4 : 1;
  static constexpr int kProducers = kWide ? kProducerWarps : 1;
  static constexpr int kGroupWarps = kWide ? 24 / Groups : 8;
  static constexpr int kGroupThreads = 32 * kGroupWarps;
  static constexpr int kStagedBytes =
      (kKtProduct && BasisA) || kWide ? kStagedBasisBytes : 0;
  static constexpr int kCtaThreads = Groups * kGroupThreads + 32 * kProducerWarps;

  static_assert(Tiles >= 16 && Tiles <= 128 && (Tiles & (Tiles - 1)) == 0,
                "T is a power of two in [16, 128]: 2T groups fill whole rows");
  static_assert(Parts == 1 || Parts == 3, "one or three bf16 basis parts");
  static_assert(Channels == 3 || (Channels == 1 && C == Colour::kYCbCr),
                "luma only is a YCbCr variant");
  static_assert(kProduct || (Channels == 3 && (!BlockMajor ||
                                               (S == Stage::kCastI16 &&
                                                In == Input::kKt))),
                "the copy stages are the ladder's coefficient-major rungs, "
                "or the i16 cast of a KT slab, block-major");
  static_assert(!(kDeltas && !Centred), "sparse deltas are K1's");
  static_assert(In == Input::kRgb ||
                    (Tiles >= 32 && (kProduct ? C == Colour::kYCbCr && Centred &&
                                                    Parts == 3 && BlockMajor
                                              : S == Stage::kCastI16)),
                "a KT variant is K1's arithmetic or the i16 cast, T >= 32");
  static_assert(!BasisA || (kProduct && BlockMajor && Channels == 3),
                "the basis as A operand is a block-major product");
  static_assert(S != Stage::kSplit || (BlockMajor && Channels == 3),
                "the split stage cuts the three segments of block-major rows");
  static_assert((Groups >= 1 && Groups <= 4) ||
                    (Groups == 12 && In == Input::kRgb && Parts == 3 &&
                     Channels == 3 && S == Stage::kSparse && BlockMajor),
                "named barriers 1..Groups (at most 15); 12 groups of 2 warps "
                "are the staged-basis frame of K1's arithmetic");
  // Registers a thread at launch: a scheduler's 16,384 over the warps of
  // the fullest of the 4 (warp w on scheduler w % 4), in steps of 8.
  static constexpr int kLaunchRegs =
      16384 / (32 * ((kCtaThreads / 32 + 3) / 4)) / 8 * 8;
  static_assert(!kRegSplit ||
                    Groups * kGroupThreads * kConsumerRegs +
                            32 * kProducerWarps * kProducerRegs <=
                        kCtaThreads * kLaunchRegs,
                "the consumers take no more registers than the producer "
                "hands them");
};

// K1: bands of 64 tiles, three parts, colour, three channels, the sparse
// epilogue, centred samples, block-major output, three consumer groups.
using K1Variant = Variant<64, 3, Colour::kYCbCr, 3, Stage::kSparse, true, true>;

// Where a band lies: written by the producer beside the band's ring slot.
struct Band {
  const uint8_t* src;   // first byte of the band's first image row (or slab)
  int64_t out_row;      // output row of its first tile
  int rows;             // image rows inside the frame (1..8)
  int cols;             // pixel columns inside the frame (may be ≤ 0 past W)
  int tiles;            // tiles inside the block row (1..T)
  uint32_t index;       // the band's number
};

// One consumer group's operands and staging: the bf16 operands (luma T × 64,
// Cr and Cb T × 32, rows padded 16 B), the staged int16 outputs (rows
// padded 16 B: the mma epilogue's stores are free of bank conflicts), and
// the band's unpadded output rows that the bulk store reads.
template <class V>
struct alignas(16) RowsGroup {
  int16_t out[V::kOutElems];
  Band band;  // the band being stored, for the thread that stores it
  uint16_t lum[V::kTiles * kLumStride];
  uint16_t chr[2][V::kTiles * kChrStride];
  int16_t q[V::kQElems];
};

// A product group whose output rows lie over its operands (out_rows): the
// KT products, the RGB T = 128 band and the 16-tile band's groups.
template <class V>
struct alignas(16) AliasGroup {
  Band band;
  uint16_t lum[V::kTiles * kLumStride];
  uint16_t chr[2][V::kTiles * kChrStride];
  int16_t q[V::kQElems];
  static_assert(sizeof(Band) % 16 == 0 &&
                    sizeof(lum) + sizeof(chr) >= V::kOutElems * sizeof(int16_t),
                "the output rows fit over the operands, 16-byte aligned");
};

template <class V>
using Group = std::conditional_t<V::kAliasOut, AliasGroup<V>, RowsGroup<V>>;

// The group's unpadded output rows.
template <class V>
__device__ __forceinline__ int16_t* out_rows(Group<V>& gr) {
  if constexpr (V::kAliasOut) {
    return reinterpret_cast<int16_t*>(gr.lum);
  } else {
    return gr.out;
  }
}

// The ring's slot count: as many band slots as fit beside the groups, at
// most 5 (K1's 3 groups leave room for 5; a fifth slot gained over a
// fourth, a sixth does not fit), or at most K1's bytes in the 16-tile
// band's frame (kWide).
template <class V>
constexpr int ring_slots() {
  constexpr int kFixed =
      V::kGroups * static_cast<int>(sizeof(Group<V>)) + V::kStagedBytes;
  constexpr int kPerSlot = V::kBandBytes + static_cast<int>(sizeof(Band)) + 16;
  constexpr int kFit = (kSmemLimit - kFixed - 64) / kPerSlot;
  constexpr int kCap = V::kWide ? kRingBytes / V::kBandBytes : 5;
  return kFit < kCap ? kFit : kCap;
}

template <class V>
struct Smem {
  static constexpr int kSlots = ring_slots<V>();
  static_assert(kSlots >= 2, "a ring of two slots at least");
  static_assert(kSlots % V::kProducers == 0,
                "each producer warp fills its own slots, in order");
  uint8_t raw[kSlots][V::kBandBytes];
  Group<V> group[V::kGroups];
  Band band[kSlots];
  uint64_t full[kSlots];   // the slot's bytes (and geometry) landed
  uint64_t empty[kSlots];  // its group's 8 warps have read it
};

// A CTA's dynamic shared memory: Smem, then the staged basis (if any).
template <class V>
constexpr int dynamic_smem() {
  return static_cast<int>(sizeof(Smem<V>)) + V::kStagedBytes;
}

// Band geometry in 32-bit arithmetic (the launcher checks that every band,
// block row and image row index fits in 31 bits); 64-bit only for the
// pointer and output row.
template <class V>
__device__ __forceinline__ Band band_at(const uint8_t* rgb, uint32_t band,
                                        int height, int width, int bpc,
                                        int bpr, int bands_per_row) {
  const uint32_t row_id = band / bands_per_row;  // frame · bpc + block row
  const int bx0 = static_cast<int>(band - row_id * bands_per_row) * V::kTiles;
  const uint32_t f = row_id / bpc;
  const int by = static_cast<int>(row_id - f * bpc);
  Band b;
  b.index = band;
  b.src = rgb + static_cast<int64_t>(f * height + by * 8) * (width * 3) +
          bx0 * 3 * 8;
  b.out_row = static_cast<int64_t>(row_id) * bpr + bx0;
  b.rows = min(8, height - by * 8);
  b.cols = width - bx0 * 8;
  b.tiles = min(V::kTiles, bpr - bx0);
  return b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Arrive on `bar` once every cp.async this thread issued before has landed;
// the arrival counts toward the barrier's expected count (.noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The group's own barrier: named barrier g + 1 over its threads (barrier 0
// is __syncthreads').
template <class V>
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(V::kGroupThreads)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// snap-trunc (eps 1e-5) of a product sum, as an int: the reference snaps x
// to its nearest integer where they lie within eps and truncates
// otherwise.  For |x| < 2^23 that is sign(x)·floor(|x| + eps) in exact
// arithmetic: floor(|x|) + 1 where 1 - frac(|x|) ≤ eps (1 - frac is exact
// there, frac ≥ 1/2), floor(|x|) elsewhere.  Rounding |x| + eps toward
// zero keeps every integer it passes (integers up to 2^24 are floats), so
// truncating x + copysign(eps, x) rounded toward zero gives it: one LOP3,
// one FADD.RZ and one F2I.TRUNC (a quarter-rate conversion, but three
// issue slots where testing 1 - frac takes nine;
// profiles/megakernel.py::snap_trunc_fast mirrors it and
// tests/test_torch_megakernel_plan.py holds it to the test of 1 - frac).
__device__ __forceinline__ int snap_trunc_int(float x) {
  uint32_t eps;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;"  // (x & sign) | 1e-5f
      : "=r"(eps)
      : "r"(__float_as_uint(x)), "r"(0x80000000u), "r"(__float_as_uint(1e-5f)));
  return __float2int_rz(__fadd_rz(x, __uint_as_float(eps)));
}

// A product sum as an int: snap-trunc for centred samples (K1), truncation
// toward zero for raw ones (the ladder's dots, as a float → int16 cast).
template <bool kCentred>
__device__ __forceinline__ int to_int(float x) {
  return kCentred ? snap_trunc_int(x) : __float2int_rz(x);
}

// Colour with the reference's truncation, in exact integer arithmetic.  The
// coefficients have three decimals, so 1000·Y = 299R + 587G + 114B exactly,
// and the reference's float32 snap-trunc (eps 1e-4) returns floor(Y): its
// rounding error is far below the 1e-3 that separates a non-integer value
// on the 1/1000 grid from an integer (ops/color.py::_snap_trunc; checked on
// all 2^24 colours by tests/test_torch_forward.py).  Cr and Cb (+128) lie
// in [16, 239], so the reference's clamp to [0, 255] never binds.
// Each sum is two 2-way dot products (dp2a) of 16-bit coefficients with
// the pixel's bytes, wherever its R, G and B sit in the two words (lo, hi)
// that hold them: at byte k = 0 of lo, R and G are lo's bytes 0-1 and B its
// byte 2; k = 1: R is lo's byte 1, G and B its bytes 2-3; k = 2: R and G
// lo's bytes 2-3, B hi's byte 0; k = 3: R lo's byte 3, G and B hi's bytes
// 0-1.
enum class Chan { kY, kCr, kCb };
template <Chan C>
struct CoefOf;  // 1000·v = r·R + g·G + b·B + add
template <>
struct CoefOf<Chan::kY> {
  static constexpr int r = 299, g = 587, b = 114, add = 0;
};
template <>
struct CoefOf<Chan::kCr> {
  static constexpr int r = 439, g = -368, b = -71, add = 128000;
};
template <>
struct CoefOf<Chan::kCb> {
  static constexpr int r = -148, g = -291, b = 439, add = 128000;
};

__host__ __device__ constexpr uint32_t pair16(int lo, int hi) {
  return (static_cast<uint32_t>(lo) & 0xffffu) | (static_cast<uint32_t>(hi) << 16);
}

template <bool kHi>
__device__ __forceinline__ int32_t dp2a(uint32_t coef, uint32_t bytes,
                                        int32_t acc) {
  int32_t d;
  if constexpr (kHi) {
    asm("dp2a.hi.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(coef), "r"(bytes), "r"(acc));
  } else {
    asm("dp2a.lo.s32.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(coef), "r"(bytes), "r"(acc));
  }
  return d;
}

// The float 2^23 + floor(S / 1000) as its bits, for 0 ≤ S < 6·10^6: the
// high word of S · ceil(2^32 / 1000) is floor(S / 1000) there (the
// multiplier's excess, S · 0.704 / 2^32, stays below the 1/1000 that
// separates S / 1000 from the next integer), plus 0x4B000000 as the high
// word of the same IMAD.HI's 64-bit addend.  S ≤ 128000 + 439 · 255 for
// every channel.
__device__ __forceinline__ uint32_t per_mille(int32_t s) {
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(s)) * 4294968u +
       (0x4B000000ull << 32)) >> 32);
}

// 1000·v + add at placement K (above) from the coefficient words `first`
// ((r, g) at K = 0, 2; (0, r) at K = 1, 3) and `second` ((b, 0); (g, b)).
template <int K>
__device__ __forceinline__ uint32_t colour_at(uint32_t lo, uint32_t hi,
                                              uint32_t first, uint32_t second,
                                              int32_t add) {
  int32_t s;
  if constexpr (K == 0 || K == 1) {
    s = dp2a<false>(first, lo, dp2a<true>(second, lo, add));
  } else {
    s = dp2a<true>(first, lo, dp2a<false>(second, hi, add));
  }
  return per_mille(s);
}

template <int K, Chan kC>
__device__ __forceinline__ uint32_t colour(uint32_t lo, uint32_t hi) {
  using c = CoefOf<kC>;
  constexpr bool kRG = K == 0 || K == 2;
  return colour_at<K>(lo, hi, kRG ? pair16(c::r, c::g) : pair16(0, c::r),
                      kRG ? pair16(c::b, 0) : pair16(c::g, c::b), c::add);
}

// The float v - 128 (centred) or v (raw) for v in [0, 255], exact, from
// the bits of 2^23 + v (0x4B000000 | v, or per_mille's word).  Its top 16
// bits are its bf16 value (exact: at most 8 significant bits).
template <bool kCentred>
__device__ __forceinline__ uint32_t sample_of(uint32_t word) {
  return __float_as_uint(__fadd_rn(__uint_as_float(word),
                                   kCentred ? -8388736.f : -8388608.f));
}

template <bool kCentred>
__device__ __forceinline__ uint32_t sample(uint32_t v) {
  return sample_of<kCentred>(0x4B000000u | v);
}

// Two samples v as a bf16 pair (first in the low half; the MCU transforms'
// operands, csrc/mcu_transform_kernel.cu).
template <bool kCentred>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t first, uint32_t second) {
  return __byte_perm(sample<kCentred>(first), sample<kCentred>(second), 0x7632);
}

// Two sample words as a bf16 pair (first in the low half).
template <bool kCentred>
__device__ __forceinline__ uint32_t bf16_pair_of(uint32_t first,
                                                 uint32_t second) {
  return __byte_perm(sample_of<kCentred>(first), sample_of<kCentred>(second),
                     0x7632);
}

// A quad is (row r, tile t, half h): pixels 8t + 4h .. + 3 of image row r,
// 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3 B3.  Group thread i takes
// quads (t, h) = (i/2 % T, i % 2) of rows i / (2T) + (threads / 2T)·j,
// the same cells in every band: 16T / threads quads per thread (T/16 in a
// group of 8 warps).
template <class V>
struct Quads {
  static constexpr int kPerThread = 16 * V::kTiles / V::kGroupThreads;
  static constexpr int kRowStep = V::kGroupThreads / (2 * V::kTiles);
  static_assert(8 * 2 * V::kTiles == kPerThread * V::kGroupThreads,
                "whole quads");
};

// Colour of four pixels per thread → bf16 operands in shared memory: luma
// (T × 64), Cr and Cb (T × 32) each.  Chroma is computed for the odd
// columns only (the 4:2:2 pick).  A band on the aligned route whose rows
// and columns all lie inside the frame (every band but a frame's last
// block row or column of bands) is read from its ring slot `buf` with no
// test a quad; any other band is read from device memory, where padding
// pixels are Y = Cr = Cb = 0 (the direct route, and a staged band at an
// edge).
template <class V>
__device__ __forceinline__ void convert_band(Group<V>& gr, const uint8_t* buf,
                                             const Band& b, int row_bytes,
                                             bool staged, int tid) {
  constexpr bool kChroma = V::kChannels == 3;
  constexpr uint32_t kZero = 0x4B000000u;  // the sample word of v = 0
  const int gi = tid & (2 * V::kTiles - 1);
  const int t = gi >> 1;
  const int h = gi & 1;
  const int pc = 8 * t + 4 * h;  // band-relative pixel column
  const int r0 = tid / (2 * V::kTiles);
  // Four pixels' sample words (y0..y3 and the odd columns' chroma) → the
  // quad's bf16 operands of row r.
  const auto put = [&](int r, uint32_t y0, uint32_t y1, uint32_t y2,
                       uint32_t y3, uint32_t cr1, uint32_t cr3, uint32_t cb1,
                       uint32_t cb3) {
    *reinterpret_cast<uint2*>(&gr.lum[t * kLumStride + r * 8 + 4 * h]) =
        make_uint2(bf16_pair_of<V::kCentred>(y0, y1),
                   bf16_pair_of<V::kCentred>(y2, y3));
    if constexpr (kChroma) {
      // Odd columns 1 and 3 of the quad are chroma samples 2h and 2h + 1.
      *reinterpret_cast<uint32_t*>(&gr.chr[0][t * kChrStride + r * 4 + 2 * h]) =
          bf16_pair_of<V::kCentred>(cr1, cr3);
      *reinterpret_cast<uint32_t*>(&gr.chr[1][t * kChrStride + r * 4 + 2 * h]) =
          bf16_pair_of<V::kCentred>(cb1, cb3);
    }
  };
  if (staged && b.rows == 8 && b.cols >= V::kTiles * 8) {
#pragma unroll
    for (int j = 0; j < Quads<V>::kPerThread; ++j) {
      const int r = r0 + Quads<V>::kRowStep * j;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(buf + r * V::kRowBytes + 12 * gi);
      const uint32_t w0 = src[0], w1 = src[1], w2 = src[2];
      if constexpr (V::kColour == Colour::kYCbCr) {
        uint32_t cr1 = kZero, cr3 = kZero, cb1 = kZero, cb3 = kZero;
        if constexpr (kChroma) {
          cr1 = colour<3, Chan::kCr>(w0, w1);
          cr3 = colour<1, Chan::kCr>(w2, 0u);
          cb1 = colour<3, Chan::kCb>(w0, w1);
          cb3 = colour<1, Chan::kCb>(w2, 0u);
        }
        put(r, colour<0, Chan::kY>(w0, w1), colour<3, Chan::kY>(w0, w1),
            colour<2, Chan::kY>(w1, w2), colour<1, Chan::kY>(w2, 0u), cr1,
            cr3, cb1, cb3);
      } else {  // R0 = byte 0, R1 = byte 3, R2 = byte 6, R3 = byte 9
        const uint32_t y1 = kZero | (w0 >> 24), y3 = kZero | ((w2 >> 8) & 0xffu);
        if constexpr (V::kColour == Colour::kR) {
          put(r, kZero | (w0 & 0xffu), y1, kZero | ((w1 >> 16) & 0xffu), y3,
              y1, y3, y1, y3);
        } else {  // G1 = byte 4, G3 = byte 10; B1 = byte 5, B3 = byte 11
          put(r, kZero | (w0 & 0xffu), y1, kZero | ((w1 >> 16) & 0xffu), y3,
              kZero | (w1 & 0xffu), kZero | ((w2 >> 16) & 0xffu),
              kZero | ((w1 >> 8) & 0xffu), kZero | (w2 >> 24));
        }
      }
    }
    return;
  }
  const int in_cols = max(0, min(4, b.cols - pc));
#pragma unroll
  for (int j = 0; j < Quads<V>::kPerThread; ++j) {
    const int r = r0 + Quads<V>::kRowStep * j;
    const int valid = r < b.rows ? in_cols : 0;
    const uint8_t* src = b.src + r * row_bytes + pc * 3;
    uint32_t px[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < valid) {
        px[i] = src[3 * i] | (static_cast<uint32_t>(src[3 * i + 1]) << 8) |
                (static_cast<uint32_t>(src[3 * i + 2]) << 16);
      }
    }
    if constexpr (V::kColour == Colour::kYCbCr) {
      uint32_t cr1 = kZero, cr3 = kZero, cb1 = kZero, cb3 = kZero;
      if constexpr (kChroma) {
        cr1 = valid > 1 ? colour<0, Chan::kCr>(px[1], 0u) : kZero;
        cr3 = valid > 3 ? colour<0, Chan::kCr>(px[3], 0u) : kZero;
        cb1 = valid > 1 ? colour<0, Chan::kCb>(px[1], 0u) : kZero;
        cb3 = valid > 3 ? colour<0, Chan::kCb>(px[3], 0u) : kZero;
      }
      put(r, valid > 0 ? colour<0, Chan::kY>(px[0], 0u) : kZero,
          valid > 1 ? colour<0, Chan::kY>(px[1], 0u) : kZero,
          valid > 2 ? colour<0, Chan::kY>(px[2], 0u) : kZero,
          valid > 3 ? colour<0, Chan::kY>(px[3], 0u) : kZero, cr1, cr3, cb1,
          cb3);
    } else {
      const int shift = V::kColour == Colour::kR ? 0 : 8;
      put(r, kZero | (px[0] & 0xffu), kZero | (px[1] & 0xffu),
          kZero | (px[2] & 0xffu), kZero | (px[3] & 0xffu),
          kZero | ((px[1] >> shift) & 0xffu), kZero | ((px[3] >> shift) & 0xffu),
          kZero | ((px[1] >> 2 * shift) & 0xffu),
          kZero | ((px[3] >> 2 * shift) & 0xffu));
    }
  }
}

// The ladder's bare rungs (no product), staged route only: each tile's R
// bytes (positions 0-63) and the first 32 positions (rows 0-3) of G and B go
// to the coefficient-major staging, lanes 0-63, 64-95 and 96-127: as u8, as
// i16, or through f32 with lanes 64-95 holding G + B.
template <class V>
__device__ __forceinline__ void convert_bare(Group<V>& gr, const uint8_t* buf,
                                             int tid) {
  using Out = typename V::Out;
  Out* q = reinterpret_cast<Out*>(gr.q);
  const int gi = tid & (2 * V::kTiles - 1);
  const int t = gi >> 1;
  const int h = gi & 1;
  const auto put = [&](int lane, uint32_t v) {
    q[lane * V::kLaneStride + t] = static_cast<Out>(v);
  };
  const auto f32 = [](uint32_t v) {
    return static_cast<uint32_t>(__float2int_rz(__uint2float_rn(v)));
  };
#pragma unroll
  for (int j = 0; j < Quads<V>::kPerThread; ++j) {
    const int r = tid / (2 * V::kTiles) + Quads<V>::kRowStep * j;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(buf + r * V::kRowBytes + 12 * gi);
    const uint32_t w0 = src[0], w1 = src[1], w2 = src[2];
    const uint32_t red[4] = {w0 & 0xffu, w0 >> 24, (w1 >> 16) & 0xffu,
                             (w2 >> 8) & 0xffu};
    const int lane = r * 8 + 4 * h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      put(lane + i, V::kStage == Stage::kSumF32 ? f32(red[i]) : red[i]);
    }
    if (r < 4) {
      const uint32_t green[4] = {(w0 >> 8) & 0xffu, w1 & 0xffu, w1 >> 24,
                                 (w2 >> 16) & 0xffu};
      const uint32_t blue[4] = {(w0 >> 16) & 0xffu, (w1 >> 8) & 0xffu,
                                w2 & 0xffu, w2 >> 24};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (V::kStage == Stage::kSumF32) {
          put(64 + lane + i, static_cast<uint32_t>(__float2int_rz(
                                 __fadd_rn(__uint2float_rn(green[i]),
                                           __uint2float_rn(blue[i])))));
          put(96 + lane + i, f32(blue[i]));
        } else {
          put(64 + lane + i, green[i]);
          put(96 + lane + i, blue[i]);
        }
      }
    }
  }
}

// The epilogue of one mma accumulator: d[0], d[1] are (row, c), (row, c +
// 1) and d[2], d[3] the same columns of row + 8, each the sum of the two
// chains (lo + mid and hi, added once) or hi's alone; into q: row-major
// (tile, lane) for block-major output, (lane, tile) otherwise.
template <class V>
__device__ __forceinline__ void put_block(const float (&small)[4],
                                          const float (&large)[4], int16_t* q,
                                          int row, int c) {
  const auto sum = [&](int i) {
    return V::kParts == 3 ? __fadd_rn(small[i], large[i]) : large[i];
  };
  if constexpr (V::kBlockMajor) {
    const auto pack = [](float first, float second) {
      return __byte_perm(static_cast<uint32_t>(to_int<V::kCentred>(first)),
                         static_cast<uint32_t>(to_int<V::kCentred>(second)),
                         0x5410);
    };
    *reinterpret_cast<uint32_t*>(&q[row * kQStride + c]) = pack(sum(0), sum(1));
    *reinterpret_cast<uint32_t*>(&q[(row + 8) * kQStride + c]) =
        pack(sum(2), sum(3));
  } else {
    int16_t* p = q + c * V::kLaneStride + row;
    p[0] = static_cast<int16_t>(to_int<V::kCentred>(sum(0)));
    p[V::kLaneStride] = static_cast<int16_t>(to_int<V::kCentred>(sum(1)));
    p[8] = static_cast<int16_t>(to_int<V::kCentred>(sum(2)));
    p[V::kLaneStride + 8] = static_cast<int16_t>(to_int<V::kCentred>(sum(3)));
  }
}

// One m-tile (16 tiles) of the product for this warp's columns: 8 luma
// lanes at lum_col (depth 64) and, with chroma, 8 lanes of its chroma
// channel at chr_col (depth 32), one pass (hi) or three (lo, mid, hi).  The
// luma and chroma chains are written interleaved, four independent
// accumulators, so that ptxas may overlap them where registers allow (one
// product's two chains alone leave the tensor pipe's latency between
// dependent mma).  Each chain sums lo then mid into one accumulator, hi
// into the other.
template <class V>
__device__ __forceinline__ void product(const Group<V>& gr, int mt, int ch,
                                        const uint32_t (&bl)[V::kParts][4][2],
                                        const uint32_t (&bc)[V::kParts][2][2],
                                        int16_t* q, int lum_col, int chr_col) {
  constexpr bool kChroma = V::kChannels == 3;
  const int lane = threadIdx.x & 31;
  uint32_t al[4][4], ac[2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ldmatrix_x4(al[ks], gr.lum + (16 * mt + (lane & 15)) * kLumStride +
                            16 * ks + (lane >> 4) * 8);
  }
  if constexpr (kChroma) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      ldmatrix_x4(ac[ks], gr.chr[ch] + (16 * mt + (lane & 15)) * kChrStride +
                              16 * ks + (lane >> 4) * 8);
    }
  }
  float ls[4] = {}, ll[4] = {}, cs[4] = {}, cl[4] = {};
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if constexpr (V::kParts == 3) mma_bf16(ls, al[ks], bl[2][ks][0], bl[2][ks][1]);
    mma_bf16(ll, al[ks], bl[0][ks][0], bl[0][ks][1]);
    if (kChroma && ks < 2) {
      if constexpr (V::kParts == 3) mma_bf16(cs, ac[ks], bc[2][ks][0], bc[2][ks][1]);
      mma_bf16(cl, ac[ks], bc[0][ks][0], bc[0][ks][1]);
    }
  }
  if constexpr (V::kParts == 3) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      mma_bf16(ls, al[ks], bl[1][ks][0], bl[1][ks][1]);
      if (kChroma && ks < 2) mma_bf16(cs, ac[ks], bc[1][ks][0], bc[1][ks][1]);
    }
  }
  const int row = 16 * mt + (lane >> 2);
  put_block<V>(ls, ll, q, row, lum_col + 2 * (lane & 3));
  if constexpr (kChroma) put_block<V>(cs, cl, q, row, chr_col + 2 * (lane & 3));
}

// One m-tile of the product for a warp of a group of W = 4 or 2 warps
// (kWide): its 64/W luma lanes at (64/W)·gw and as many of the 64 chroma
// lanes, of one channel, in pieces of 8 lanes, each summed in product()'s
// order (lo then mid into one chain, hi into the other, luma and chroma
// interleaved).  The basis fragments come by ldmatrix from the basis
// staged in shared memory (stage_basis: rows are output lanes, the B
// operand's "col" layout): one x4 gives a luma part two k-steps, or a
// chroma part both; lo and hi first, then mid, so that at most 24 fragment
// registers are live.
template <class V>
__device__ __forceinline__ void product_staged(Group<V>& gr,
                                               const uint16_t* basis, int mt,
                                               int gw) {
  constexpr int kWarpLanes = 64 / V::kGroupWarps;  // luma (chroma) lanes
  const int lane = threadIdx.x & 31;
  const int first = kWarpLanes * gw;  // luma lane, and of the chroma lanes
  const int ch = first >> 5;
  uint32_t al[4][4], ac[2][4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    ldmatrix_x4(al[ks], gr.lum + (16 * mt + (lane & 15)) * kLumStride +
                            16 * ks + (lane >> 4) * 8);
  }
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    ldmatrix_x4(ac[ks], gr.chr[ch] + (16 * mt + (lane & 15)) * kChrStride +
                            16 * ks + (lane >> 4) * 8);
  }
  const int row = 16 * mt + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kWarpLanes / 8; ++j) {
    const int ln = first + 8 * j;         // the piece's first luma lane
    const int cn = (first & 31) + 8 * j;  // and chroma lane of channel ch
    // Part p of the piece's 8 basis rows: luma k-steps 2m, 2m + 1; chroma 0, 1.
    const auto lum_b = [&](int p, int m, uint32_t (&r)[4]) {
      ldmatrix_x4(r, basis + (p * 64 + ln + (lane & 7)) * kLumStride + 32 * m +
                         8 * (lane >> 3));
    };
    const auto chr_b = [&](int p, uint32_t (&r)[4]) {
      ldmatrix_x4(r, basis + kLumBasis + (p * 32 + cn + (lane & 7)) * kChrStride +
                         8 * (lane >> 3));
    };
    float ls[4] = {}, ll[4] = {}, cs[4] = {}, cl[4] = {};
    {
      uint32_t lo[2][4], hi[2][4], clo[4], chi[4];
      lum_b(2, 0, lo[0]);
      lum_b(2, 1, lo[1]);
      lum_b(0, 0, hi[0]);
      lum_b(0, 1, hi[1]);
      chr_b(2, clo);
      chr_b(0, chi);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int m = ks >> 1, k = 2 * (ks & 1);
        mma_bf16(ls, al[ks], lo[m][k], lo[m][k + 1]);
        mma_bf16(ll, al[ks], hi[m][k], hi[m][k + 1]);
        if (ks < 2) {
          mma_bf16(cs, ac[ks], clo[2 * ks], clo[2 * ks + 1]);
          mma_bf16(cl, ac[ks], chi[2 * ks], chi[2 * ks + 1]);
        }
      }
    }
    uint32_t mid[2][4], cmid[4];
    lum_b(1, 0, mid[0]);
    lum_b(1, 1, mid[1]);
    chr_b(1, cmid);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int m = ks >> 1, k = 2 * (ks & 1);
      mma_bf16(ls, al[ks], mid[m][k], mid[m][k + 1]);
      if (ks < 2) mma_bf16(cs, ac[ks], cmid[2 * ks], cmid[2 * ks + 1]);
    }
    put_block<V>(ls, ll, gr.q, row, ln + 2 * (lane & 3));
    put_block<V>(cs, cl, gr.q, row, 64 + 32 * ch + cn + 2 * (lane & 3));
  }
}

// The sparse deltas of the 8 staged lanes at qr, segment-local (the lane
// before the first is one 2-byte shared read, none at a segment's start),
// plus kBias where a run starts and 0 elsewhere; they wrap modulo 2^16 like
// the reference's int16 cast.  Only each difference's low 16 bits are
// kept, so the low half x0 of a word w = x1:x0 needs no extracting: x0 -
// prev and x1 - x0 are w - prev and x1 - w there, and x0 == prev is a zero
// low half of w ^ prev (profiles/megakernel.py::sparse_deltas_fast mirrors
// it).
__device__ __forceinline__ uint4 sparse_deltas(const int16_t* qr,
                                               bool seg_first) {
  const uint4 v = *reinterpret_cast<const uint4*>(qr);
  const uint32_t word[4] = {v.x, v.y, v.z, v.w};
  uint32_t prev = seg_first ? 0u : static_cast<uint16_t>(qr[-1]);
  uint32_t d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t w = word[e], x1 = w >> 16;
    const bool run0 = (e == 0 && seg_first) || ((w ^ prev) & 0xffffu) != 0;
    const bool run1 = ((x1 ^ w) & 0xffffu) != 0;
    d[e] = __byte_perm(run0 ? w - prev + kBias : 0u,
                       run1 ? x1 - w + kBias : 0u, 0x5410);
    prev = x1;
  }
  return make_uint4(d[0], d[1], d[2], d[3]);
}

// Block-major rows into the group's unpadded `out`: thread i takes lanes
// 8c..8c+7 (c = i % (lanes/8)) of staged rows i/(lanes/8), + threads /
// (lanes/8), ... as one 16-byte read and one 16-byte write; the sparse
// stage forms the segment-local deltas on the way (segments start at lanes
// 0, 64 and 96).  Rows past the band's tiles are formed too and never
// stored.  Then the band's b.tiles rows leave by one bulk store, issued by
// the group's thread 0 once every thread has written its rows.
template <class V>
__device__ __forceinline__ void store_rows(Group<V>& gr,
                                           int16_t* __restrict__ out, int g,
                                           int tid) {
  constexpr int kPerRow = V::kLanes / 8;  // threads per output row
  constexpr int kRowsPerPass = V::kGroupThreads / kPerRow;
  const int c = tid & (kPerRow - 1);
  const bool seg_first =
      V::kChannels == 3 ? c == 0 || c == 8 || c == 12 : c == 0;
  const int r0 = tid / kPerRow;
  const int16_t* src = gr.q + r0 * kQStride + 8 * c;
  uint4* dst = reinterpret_cast<uint4*>(out_rows<V>(gr)) + r0 * kPerRow + c;
#pragma unroll
  for (int j = 0; j < V::kTiles * kPerRow / V::kGroupThreads; ++j) {
    const int16_t* qr = src + j * kRowsPerPass * kQStride;
    if constexpr (V::kStage == Stage::kSparse) {
      dst[j * kRowsPerPass * kPerRow] = sparse_deltas(qr, seg_first);
    } else {
      dst[j * kRowsPerPass * kPerRow] = *reinterpret_cast<const uint4*>(qr);
    }
  }
  fence_proxy_async();  // these writes before the bulk store's reads
  group_sync<V>(g);
  if (tid == 0) {
    bulk_store(out + gr.band.out_row * V::kLanes, out_rows<V>(gr),
               static_cast<uint32_t>(gr.band.tiles) * V::kLanes * 2);
  }
}

// Coefficient-major store: thread i takes 16-byte chunks of lane rows of the
// staging, so that each lane's T outputs of the band go out as one
// contiguous run of the (lanes, N) output.  Sparse deltas run along the
// lanes: an output minus the same tile's output in the lane before.  A band
// that is short or a run that is not 16-byte aligned goes out element by
// element.
template <class V>
__device__ __forceinline__ void store_lanes(const Group<V>& gr, const Band& b,
                                            typename V::Out* __restrict__ out,
                                            int64_t n_blocks, int tid) {
  using Out = typename V::Out;
  constexpr int kPer = 16 / static_cast<int>(sizeof(Out));  // per chunk
  constexpr int kChunks = V::kTiles / kPer;                  // per lane row
  constexpr int kTotal = V::kLanes * kChunks;
  const Out* q = reinterpret_cast<const Out*>(gr.q);
  const bool whole = b.tiles == V::kTiles && n_blocks % kPer == 0 &&
                     b.out_row % kPer == 0;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = tid + j * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int lane = i / kChunks;
    const int k = i - lane * kChunks;
    const Out* src = q + lane * V::kLaneStride + k * kPer;
    Out* dst = out + lane * n_blocks + b.out_row + k * kPer;
    uint4 v = *reinterpret_cast<const uint4*>(src);
    if constexpr (V::kStage == Stage::kSparse) {
      const bool seg_first = lane == 0 || lane == 64 || lane == 96;
      const uint4 p = seg_first ? make_uint4(0u, 0u, 0u, 0u)
                                : *reinterpret_cast<const uint4*>(
                                      src - V::kLaneStride);
      const uint32_t x[4] = {v.x, v.y, v.z, v.w}, y[4] = {p.x, p.y, p.z, p.w};
      uint32_t d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x0 = x[e] & 0xffffu, x1 = x[e] >> 16;
        const uint32_t p0 = y[e] & 0xffffu, p1 = y[e] >> 16;
        const uint32_t d0 = seg_first || x0 != p0 ? x0 - p0 + kBias : 0u;
        const uint32_t d1 = seg_first || x1 != p1 ? x1 - p1 + kBias : 0u;
        d[e] = __byte_perm(d0, d1, 0x5410);
      }
      v = make_uint4(d[0], d[1], d[2], d[3]);
    }
    if (whole) {
      __stcs(reinterpret_cast<uint4*>(dst), v);
    } else {
      constexpr int kPerWord = 4 / static_cast<int>(sizeof(Out));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        if (k * kPer + n < b.tiles) {
          dst[n] = static_cast<Out>(w[n / kPerWord] >>
                                    (8 * sizeof(Out) * (n % kPerWord)));
        }
      }
    }
  }
}

// ---- The KT input (the layout variants) ---------------------------------
//
// A KT band is T consecutive blocks n0..n0+T-1 of the (3, 64, N) u8 array:
// 192 row pieces (channel c, position p = 8r + col) of T bytes each, at
// stride N.  Piece ρ = 64c + p is T/16 chunks of 16 bytes; chunk j of piece
// ρ lands in the ring slot at chunk index g ^ (ρ & 7), g = ρ·(T/16) + j.
// The XOR keeps each aligned group of 8 chunks (one 128-byte row of the 32
// banks) and is a bijection; it lets 8 lanes that read the same chunk j of
// 8 pieces whose positions differ mod 8 hit 8 different 16-byte bank
// groups.

template <class V>
__device__ __forceinline__ int kt_chunk_offset(int piece, int j) {
  return ((piece * (V::kTiles / 16) + j) ^ (piece & 7)) * 16;
}

// The 32-bit word w (tiles 16j + 4w .. + 3) of chunk j of piece `piece`.
template <class V>
__device__ __forceinline__ uint32_t kt_word(const uint8_t* buf, int piece,
                                            int j, int w) {
  return *reinterpret_cast<const uint32_t*>(buf + kt_chunk_offset<V>(piece, j) +
                                            4 * w);
}

// The producer's 16-byte copies of one KT band: T/16 chunks of each piece
// the variant reads, producer lane i (of 32 a producer warp) copying chunks
// i, i + 32·warps, ...  A product reads all 192 pieces; the i16 cast only
// R[0:64], G[0:32] and B[0:32] (pieces 0-95 and 128-159: its 128·T bytes).
// A short last band (tiles < T, a multiple of 16 since N % 16 == 0) copies
// its whole chunks only; the rest of the slot keeps stale bytes, whose
// outputs are never stored.  A producer warpgroup's lane copies chunk c =
// lane % (T/16) of pieces lane / (T/16) + j·128/(T/16), a multiple of 8
// apart: one swizzle and one stride for all its copies (24 registers).
template <class V>
__device__ __forceinline__ void load_kt(uint8_t* buf, const uint8_t* src,
                                        int64_t n_blocks, int tiles, int lane) {
  constexpr int kPer = V::kTiles / 16;
  constexpr int kTotal = (V::kProduct ? 192 : 128) * kPer;
  const int chunks = tiles / 16;
  if constexpr (V::kProducerWarps > 1) {
    constexpr int kLanes = 32 * V::kProducerWarps;
    static_assert(V::kProduct && (kLanes / kPer) % 8 == 0 &&
                      kTotal % kLanes == 0,
                  "each lane's pieces share their swizzle");
    const int c = lane % kPer, first = lane / kPer;
    if (c < chunks) {
      const uint8_t* from = src + first * n_blocks + c * 16;
      uint8_t* to = buf + (lane ^ (first & 7)) * 16;
#pragma unroll
      for (int j = 0; j < kTotal / kLanes; ++j) {
        cp_async16(to + j * kLanes * 16, from + j * (kLanes / kPer) * n_blocks);
      }
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < kTotal / 32; ++j) {
      const int i = lane + j * 32;
      const int k = i / kPer;
      const int c = i - k * kPer;
      const int piece = V::kProduct || k < 96 ? k : k + 32;
      if (c < chunks) {
        cp_async16(buf + kt_chunk_offset<V>(piece, c),
                   src + piece * n_blocks + c * 16);
      }
    }
  }
}

// A thread's share of a KT band: units of (8 position pairs × 4 tile quads
// of one chunk j), lane = 8·w + qq holding pair q = 8·(unit) + qq (the
// positions 2q and 2q + 1) and tiles 16j + 4w .. + 3.  Lanes 4-7 of each 8
// read the odd position first, so each read instruction's 8 pieces differ
// mod 8 (conflict-free under the swizzle).  Lanes w = 2, 3 walk their four
// tiles in the order 2, 3, 0, 1, which spreads each staging write of the
// warp over the 32 banks (tile stride 144 or 272 bytes is 16 banks).
struct KtLane {
  int qq, w, h, rot;
  __device__ __forceinline__ KtLane() {
    const int lane = threadIdx.x & 31;
    qq = lane & 7;
    w = lane >> 3;
    h = (qq >> 2) & 1;
    rot = w & 2;
  }
  // The words of positions 2q and 2q + 1 of channel c, tiles of chunk j.
  template <class V>
  __device__ __forceinline__ void read(const uint8_t* buf, int c, int q, int j,
                                       uint32_t& even, uint32_t& odd) const {
    const uint32_t a = kt_word<V>(buf, 64 * c + 2 * q + h, j, w);
    const uint32_t b = kt_word<V>(buf, 64 * c + 2 * q + 1 - h, j, w);
    even = h ? b : a;
    odd = h ? a : b;
  }
};

// Byte s of the R, G and B words as one pixel word whose bytes 0-2 are R, G,
// B (byte 3 is R again: colour<0> reads bytes 0-2 only).
__device__ __forceinline__ uint32_t kt_pixel(uint32_t r, uint32_t g, uint32_t b,
                                             int s) {
  const uint32_t rg = __byte_perm(r, g, s | ((s + 4) << 4));
  return __byte_perm(rg, b, 0x0010 | ((s + 4) << 8));
}

// colour<0, kC>(px, 0u) with floor(S / 1000) and 2^23's bits as one mad.hi:
// per_mille's word (the low half of its 64-bit addend is 0), where ptxas
// builds per_mille from two instructions at the KT products' registers
// (K1's colour keeps per_mille as it is).
template <Chan kC>
__device__ __forceinline__ uint32_t kt_colour(uint32_t px) {
  using c = CoefOf<kC>;
  const int32_t s = dp2a<false>(pair16(c::r, c::g), px,
                                dp2a<true>(pair16(c::b, 0), px, c::add));
  return __umulhi(static_cast<uint32_t>(s), 4294968u) + 0x4B000000u;
}

// Colour of a KT band → the bf16 operands of K1 in shared memory (luma T ×
// 64, Cr and Cb T × 32, tile-major), the same values convert_band writes
// for the same blocks: chroma is computed for the odd columns, position
// 8r + 2c' + 1 → chroma sample 4r + c' = q.  A lane's pair q = 8·(warp &
// 3) + qq is the same in every unit, its chunk j = (warp >> 2) + 2m; the
// pieces 64c + p of channel c lie 64c·T/16 chunks past those of p under
// the swizzle, so a unit's six words are two addresses and constant
// offsets.  Lanes with rot = 2 swap the halves of each word (byte k → k ^
// 2): step i takes byte i of every word (constant selects) for tile 16j +
// 4w + (i ^ rot), whose staging rows are two per-lane pointers (i < 2, i
// ≥ 2) and constant offsets.
template <class V>
__device__ __forceinline__ void convert_kt(Group<V>& gr, const uint8_t* buf,
                                           int tid) {
  constexpr int kChannel = 64 * (V::kTiles / 16) * 16;  // bytes a channel
  const KtLane ln;
  const int gw = tid >> 5;
  const int q = 8 * (gw & 3) + ln.qq;
  const int first = 2 * q + ln.h, second = 2 * q + 1 - ln.h;
  const int t0 = 16 * (gw >> 2) + 4 * ln.w;
  uint16_t* const lum_lo = gr.lum + (t0 + ln.rot) * kLumStride + 2 * q;
  uint16_t* const lum_hi = gr.lum + (t0 - ln.rot) * kLumStride + 2 * q;
  uint16_t* const chr_lo = gr.chr[0] + (t0 + ln.rot) * kChrStride + q;
  uint16_t* const chr_hi = gr.chr[0] + (t0 - ln.rot) * kChrStride + q;
  const uint32_t turn = ln.rot ? 0x1032u : 0x3210u;
#pragma unroll
  for (int m = 0; m < V::kTiles / 32; ++m) {
    const int j = (gw >> 2) + 2 * m;
    const uint8_t* a = buf + kt_chunk_offset<V>(first, j) + 4 * ln.w;
    const uint8_t* b = buf + kt_chunk_offset<V>(second, j) + 4 * ln.w;
    uint32_t e[3], o[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint32_t x = __byte_perm(
          *reinterpret_cast<const uint32_t*>(a + c * kChannel), 0, turn);
      const uint32_t y = __byte_perm(
          *reinterpret_cast<const uint32_t*>(b + c * kChannel), 0, turn);
      e[c] = ln.h ? y : x;
      o[c] = ln.h ? x : y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint16_t* const lum = (i < 2 ? lum_lo : lum_hi) + (32 * m + i) * kLumStride;
      uint16_t* const chr = (i < 2 ? chr_lo : chr_hi) + (32 * m + i) * kChrStride;
      const uint32_t pe = kt_pixel(e[0], e[1], e[2], i);
      const uint32_t po = kt_pixel(o[0], o[1], o[2], i);
      *reinterpret_cast<uint32_t*>(lum) = bf16_pair_of<true>(
          kt_colour<Chan::kY>(pe), kt_colour<Chan::kY>(po));
      chr[0] = static_cast<uint16_t>(
          sample_of<true>(kt_colour<Chan::kCr>(po)) >> 16);
      chr[V::kTiles * kChrStride] = static_cast<uint16_t>(
          sample_of<true>(kt_colour<Chan::kCb>(po)) >> 16);
    }
  }
}

// The i16 cast of a KT band, block-major: lanes 0-63, 64-95 and 96-127 of
// tile t's staged row are R[0:64], G[0:32] and B[0:32] of block t (v2's
// "copy" mode).  Pairs q = 0..63 of output lanes; 8 pairs of one channel per
// lane octet.
template <class V>
__device__ __forceinline__ void convert_kt_bare(Group<V>& gr,
                                                const uint8_t* buf, int tid) {
  const KtLane ln;
#pragma unroll
  for (int m = 0; m < V::kTiles / 16; ++m) {
    const int u = (tid >> 5) + 8 * m;
    const int q = 8 * (u & 7) + ln.qq;
    const int j = u >> 3;
    const int c = q < 32 ? 0 : (q < 48 ? 1 : 2);
    uint32_t e, o;
    ln.read<V>(buf, c, q - (c == 0 ? 0 : 16 + 16 * c), j, e, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = i ^ ln.rot;
      const int t = 16 * j + 4 * ln.w + s;
      *reinterpret_cast<uint32_t*>(&gr.q[t * kQStride + 2 * q]) =
          __byte_perm(e, o, s | ((s + 4) << 8)) & 0x00ff00ffu;
    }
  }
}

// The basis as the mma's A operand (m = 16 coefficient lanes, k = positions),
// the samples as B (n = 8 tiles) by ldmatrix from the tile-major operands:
// the product comes out (lane, tile), as the TPU production kernel's basis
// × samples, and is written transposed into the (tile, lane) staging.  The
// A fragments of m-tile mt (rows 16mt..16mt+15 of each part, parts
// kPartRows rows apart) come by ldmatrix from the basis staged in shared
// memory, once a band, live only in the product (basis_a_band).
template <int KSteps, int Stride, int PartRows>
__device__ __forceinline__ void load_basis_a(const uint16_t* basis, int mt,
                                             uint32_t (&af)[3][KSteps][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      ldmatrix_x4(af[p][ks], basis + (p * PartRows + 16 * mt + (lane & 15)) *
                                         Stride +
                                 16 * ks + (lane >> 4) * 8);
    }
  }
}

// One (16 lanes × 8 tiles) block of the basis-A product: tiles 8nt..8nt+7,
// lanes col + 0..15 of the staging, the three parts summed as in product().
template <int KSteps, int Stride>
__device__ __forceinline__ void product_basis_a(
    const uint16_t* op, int nt, const uint32_t (&af)[3][KSteps][4], int16_t* q,
    int col) {
  const int lane = threadIdx.x & 31;
  uint32_t b[KSteps][2];
#pragma unroll
  for (int ks = 0; ks < KSteps; ks += 2) {
    uint32_t r[4];
    ldmatrix_x4(r, op + (8 * nt + (lane & 7)) * Stride + 16 * ks +
                       8 * (lane >> 3));
    b[ks][0] = r[0];
    b[ks][1] = r[1];
    b[ks + 1][0] = r[2];
    b[ks + 1][1] = r[3];
  }
  float small[4] = {}, large[4] = {};
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    mma_bf16(small, af[2][ks], b[ks][0], b[ks][1]);
    mma_bf16(large, af[0][ks], b[ks][0], b[ks][1]);
  }
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    mma_bf16(small, af[1][ks], b[ks][0], b[ks][1]);
  }
  const int m = col + (lane >> 2);      // staging lane of d[0], d[1]
  const int t = 8 * nt + 2 * (lane & 3);  // tile of d[0], d[2]
  const auto put = [&](int tile, int l, int i) {
    q[tile * kQStride + l] =
        static_cast<int16_t>(snap_trunc_int(__fadd_rn(small[i], large[i])));
  };
  put(t, m, 0);
  put(t + 1, m, 1);
  put(t, m + 8, 2);
  put(t + 1, m + 8, 3);
}

// The basis-A product of one band by a group's 8 warps, 9 mma per 8 tiles
// each (72 a band's 8 tiles): warp w < 4 takes luma m-tile w over the
// first 3T/32 n-tiles; warp w ≥ 4 its chroma m-tile (m-tile w & 1 of
// channel (w >> 1) & 1) over all T/8, then luma m-tile w - 4 over the last
// T/32.  Each output is one warp's, summed in product_basis_a's part order
// (lo then mid into one chain, hi into the other, then one add) whichever
// warp that is (profiles/megakernel.py::basis_a_plan mirrors the split).
template <class V>
__device__ __forceinline__ void basis_a_band(Group<V>& gr,
                                             const uint16_t* basis, int gw) {
  constexpr int kSplit = 3 * V::kTiles / 32;
  if (gw >= 4) {
    uint32_t af[3][2][4];
    load_basis_a<2, kChrStride, 32>(basis + kLumBasis, gw & 1, af);
#pragma unroll 1
    for (int nt = 0; nt < V::kTiles / 8; ++nt) {
      product_basis_a<2, kChrStride>(gr.chr[(gw >> 1) & 1], nt, af, gr.q,
                                     64 + 16 * (gw & 3));
    }
  }
  uint32_t af[3][4][4];
  load_basis_a<4, kLumStride, 64>(basis, gw & 3, af);
#pragma unroll 1
  for (int nt = gw < 4 ? 0 : kSplit; nt < (gw < 4 ? kSplit : V::kTiles / 8);
       ++nt) {
    product_basis_a<4, kLumStride>(gr.lum, nt, af, gr.q, 16 * (gw & 3));
  }
}

// The basis's three luma then three chroma parts (parts, rows = output
// lanes) into the staged rows of `basis`, by all the CTA's threads.
__device__ __forceinline__ void stage_basis(uint16_t* basis,
                                            const uint16_t* parts) {
  constexpr int kLumWords = 3 * 64 * 32, kWords = kLumWords + 3 * 32 * 16;
  const uint32_t* src = reinterpret_cast<const uint32_t*>(parts);
  for (int i = threadIdx.x; i < kWords; i += blockDim.x) {
    const bool luma = i < kLumWords;
    const int j = luma ? i : i - kLumWords;
    const int words = luma ? 32 : 16;  // a row's words
    const int row = j / words;         // part · rows + row
    const int at = luma ? row * kLumStride : kLumBasis + row * kChrStride;
    *reinterpret_cast<uint32_t*>(basis + at + 2 * (j - row * words)) = src[i];
  }
}

// The outputs of a KT variant: p[0] the (N, lanes) rows; for the split
// stage p[0..2] the (N, 64), (N, 32) and (N, 32) int16 luma, Cr and Cb
// segments and p[3..5] their (N,) int32 run counts.
struct KtOut {
  void* p[6];
};

// The split store: the block-major rows' threads and sparse deltas, each
// 16-byte piece going to the segment's own output; then the number of
// nonzero words of each segment (every run's first word is nonzero: slot 0
// carries kBias, a later start a nonzero delta), summed over the segment's
// 8 or 4 threads by shuffles, written by its first thread.
template <class V>
__device__ __forceinline__ void store_split(const Group<V>& gr, const Band& b,
                                            const KtOut& out, int tid) {
  constexpr int kPerRow = 16;
  constexpr int kRowsPerPass = kThreads / kPerRow;
  const int c = tid & (kPerRow - 1);
  const int seg = c < 8 ? 0 : (c < 12 ? 1 : 2);
  const int first = seg == 0 ? 0 : 4 + 4 * seg;
  const int width = seg == 0 ? 64 : 32;
  const int r0 = tid / kPerRow;
  // Pointers by selects: an index into out.p would put it in local memory.
  void* const seg_out = seg == 0 ? out.p[0] : (seg == 1 ? out.p[1] : out.p[2]);
  void* const seg_runs = seg == 0 ? out.p[3] : (seg == 1 ? out.p[4] : out.p[5]);
  int16_t* dst = static_cast<int16_t*>(seg_out) + (b.out_row + r0) * width +
                 8 * (c - first);
  int32_t* runs = static_cast<int32_t*>(seg_runs) + b.out_row + r0;
  const int16_t* src = gr.q + r0 * kQStride + 8 * c;
#pragma unroll
  for (int j = 0; j < V::kTiles / kRowsPerPass; ++j) {
    const uint4 d = sparse_deltas(src + j * kRowsPerPass * kQStride, c == first);
    int n = __popc(__vcmpne2(d.x, 0u)) + __popc(__vcmpne2(d.y, 0u)) +
            __popc(__vcmpne2(d.z, 0u)) + __popc(__vcmpne2(d.w, 0u));
    n += __shfl_xor_sync(0xffffffffu, n, 1);
    n += __shfl_xor_sync(0xffffffffu, n, 2);
    const int other = __shfl_xor_sync(0xffffffffu, n, 4);
    if (seg == 0) n += other;
    if (r0 + j * kRowsPerPass < b.tiles) {
      __stcs(reinterpret_cast<uint4*>(dst + j * kRowsPerPass * width), d);
      if (c == first) runs[j * kRowsPerPass] = n >> 4;
    }
  }
}

// Basis fragments as B operands ("col" layout: lane holds rows n = lane/4,
// depth pairs 2·(lane%4) and +8), loaded once per CTA.  Luma columns
// 8w..8w+7; chroma columns 8(w%4).. of channel w/4 (Cr and Cb share the
// basis).  w is the warp within its group.
template <class V>
__device__ __forceinline__ void load_basis_b(const uint16_t* parts, int warp,
                                             int lane,
                                             uint32_t (&bl)[V::kParts][4][2],
                                             uint32_t (&bc)[V::kParts][2][2]) {
  const int n = lane >> 2, k = 2 * (lane & 3);
  const uint32_t* lum = reinterpret_cast<const uint32_t*>(parts);
  const uint32_t* chr = reinterpret_cast<const uint32_t*>(parts + 3 * kLumPart);
#pragma unroll
  for (int p = 0; p < V::kParts; ++p) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int base = p * kLumPart + (8 * warp + n) * 64 + 16 * ks + k;
      bl[p][ks][0] = lum[base / 2];
      bl[p][ks][1] = lum[(base + 8) / 2];
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int base = p * kChrPart + (8 * (warp & 3) + n) * 32 + 16 * ks + k;
      bc[p][ks][0] = chr[base / 2];
      bc[p][ks][1] = chr[(base + 8) / 2];
    }
  }
}

// The geometry of KT band `band`: blocks n0 = band·T .. of the slab.
template <class V>
__device__ __forceinline__ Band kt_band_at(const uint8_t* kt, uint32_t band,
                                           int64_t n_blocks) {
  Band b;
  b.index = band;
  b.out_row = static_cast<int64_t>(band) * V::kTiles;
  b.src = kt + b.out_row;
  b.rows = 8;
  b.cols = 0;
  b.tiles = static_cast<int>(min(static_cast<int64_t>(V::kTiles),
                                 n_blocks - b.out_row));
  return b;
}

// Where a variant's bands come from, as the band loop asks for them: a
// band's geometry, the producer's copies of it into a ring slot, and its
// convert steps (colour into the bf16 operands, or the bare copy into the
// staging).  Image bands of (B, H, W, 3) RGB (K1): on the staged route the
// producer's lane 0 copies the band's rows inside the frame, each
// min(T·8, cols)·3 bytes (a multiple of 48 where W % 16 == 0) at stride
// W·3, by one 1-D bulk copy a row with the band's bytes as the full
// barrier's transaction count; on the direct route it copies nothing, and
// the consumers read device memory.
template <class V>
struct RgbBands {
  static constexpr int kFullCount = 1;  // lane 0's arrival (with its bytes)
  const uint8_t* rgb;
  int height, width, bpc, bpr, bands_per_row, row_bytes;
  bool staged;
  __device__ __forceinline__ Band at(uint32_t band) const {
    return band_at<V>(rgb, band, height, width, bpc, bpr, bands_per_row);
  }
  __device__ __forceinline__ void produce(uint8_t* buf, const Band& b,
                                          uint64_t* full, int lane) const {
    if (lane != 0) return;
    if (!staged) {
      mbar_arrive(full);
      return;
    }
    const uint32_t len = static_cast<uint32_t>(min(V::kTiles * 8, b.cols) * 3);
    mbar_expect_tx(full, static_cast<uint32_t>(b.rows) * len);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < b.rows) {
        bulk_load(buf + r * V::kRowBytes, b.src + r * row_bytes, len, full);
      }
    }
  }
  __device__ __forceinline__ void convert(Group<V>& gr, const uint8_t* buf,
                                          const Band& b, int tid) const {
    convert_band<V>(gr, buf, b, row_bytes, staged, tid);
  }
  __device__ __forceinline__ void bare(Group<V>& gr, const uint8_t* buf,
                                       int tid) const {
    convert_bare<V>(gr, buf, tid);
  }
};

// KT slabs of T blocks of the (3, 64, N) layout (always staged): every
// producer lane issues its 16-byte cp.async copies (the swizzle above) and
// arrives once they land; lane 0 arrives once more after writing the
// band's geometry.
template <class V>
struct KtBands {
  static constexpr int kFullCount = 32 * V::kProducerWarps + 1;
  const uint8_t* kt;
  int64_t n_blocks;
  __device__ __forceinline__ Band at(uint32_t band) const {
    return kt_band_at<V>(kt, band, n_blocks);
  }
  __device__ __forceinline__ void produce(uint8_t* buf, const Band& b,
                                          uint64_t* full, int lane) const {
    load_kt<V>(buf, b.src, n_blocks, b.tiles, lane);
    cp_async_arrive(full);
    if (lane == 0) mbar_arrive(full);
  }
  __device__ __forceinline__ void convert(Group<V>& gr, const uint8_t* buf,
                                          const Band&, int tid) const {
    convert_kt<V>(gr, buf, tid);
  }
  __device__ __forceinline__ void bare(Group<V>& gr, const uint8_t* buf,
                                       int tid) const {
    convert_kt_bare<V>(gr, buf, tid);
  }
};

// The body of every variant.  Persistent CTAs walk over bands of T tiles:
// CTA c takes bands c, c + grid, ...; its i-th band goes to ring slot i %
// S and to consumer group i % G.  The producer warp (the CTA's last) waits
// for a slot to be empty (parity ((i / S) & 1) ^ 1), writes the band's
// geometry beside it and fills it (src.produce); the group waits for it to
// be full (parity (i / S) & 1), converts it, and its warps release it.
// Then, on the group's named barrier only: product, the store pass into
// the group's unpadded rows and one bulk store of the band (block-major),
// or thread stores (the split stage, coefficient-major).  `out` is the
// variant's output pointer, or KtOut for a KT variant; n_blocks is the lane
// stride of coefficient-major output.  In the KT products' register split
// the producer is the last warpgroup, its four warps sharing the copies
// (producer lane pl of 128), and the two setmaxnreg sit on the two sides of
// the producer branch, which returns; in the 16-tile band's frame the
// last warpgroup's four warps each fill every fourth band.
template <class V, class Bands, class Out>
__device__ __forceinline__ void band_loop(const Bands& src, Out out,
                                          const uint16_t* __restrict__ parts,
                                          uint32_t n_bands, int64_t n_blocks) {
  using S = Smem<V>;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  S& sm = *reinterpret_cast<S*>(smem_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t step = gridDim.x;
  if constexpr (V::kStagedBytes > 0) {  // the basis, after Smem
    stage_basis(reinterpret_cast<uint16_t*>(smem_bytes + sizeof(S)), parts);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kSlots; ++s) {
      mbar_init(&sm.full[s], Bands::kFullCount);
      mbar_init(&sm.empty[s], V::kGroupWarps);
      sm.band[s].index = ~0u;  // no band (n_bands < 2^30)
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (V::kProducerWarps == 1 ? warp == V::kGroups * V::kGroupWarps
                              : warp >= V::kGroups * V::kGroupWarps) {
    if constexpr (V::kRegSplit) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    }
    const int pl = V::kProducerWarps == 1 || V::kProducers > 1
                       ? lane
                       : static_cast<int>(threadIdx.x) -
                             V::kGroups * V::kGroupThreads;
    // Producer warp p of kProducers takes the CTA's bands i ≡ p.
    const int first = V::kProducers > 1 ? warp - V::kGroups * V::kGroupWarps : 0;
    uint32_t i = first;
    for (uint32_t band = blockIdx.x + first * step; band < n_bands;
         band += V::kProducers * step, i += V::kProducers) {
      const int s = static_cast<int>(i % S::kSlots);
      mbar_wait(&sm.empty[s], ((i / S::kSlots) & 1) ^ 1);
      const Band b = src.at(band);
      if (pl == 0) sm.band[s] = b;
      src.produce(sm.raw[s], b, &sm.full[s], pl);
    }
    return;
  }
  if constexpr (V::kRegSplit) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  }

  const int g = warp / V::kGroupWarps;
  const int tid = threadIdx.x - g * V::kGroupThreads;
  const int gw = warp - g * V::kGroupWarps;  // warp within the group
  Group<V>& gr = sm.group[g];
  constexpr int kBParts = V::kBasisA || V::kWide ? 1 : V::kParts;
  uint32_t bl[kBParts][4][2], bc[kBParts][2][2];
  if constexpr (V::kProduct && !V::kBasisA && !V::kWide) {
    load_basis_b<V>(parts, gw, lane, bl, bc);
  }
  const int ch = gw >> 2;
  const int lum_col = 8 * gw;
  const int chr_col = 64 + 32 * ch + 8 * (gw & 3);

  for (uint32_t i = g; blockIdx.x + i * step < n_bands; i += V::kGroups) {
    const int s = static_cast<int>(i % S::kSlots);
    // The parity wait alone would also pass while the slot's previous fill
    // (band i - S, another group's when S % G != 0) has not landed.  Once
    // the band's number stands beside the slot, the producer has passed
    // that fill's release, so the wait passes on this fill only.
    while (*static_cast<volatile uint32_t*>(&sm.band[s].index) !=
           blockIdx.x + i * step) {
    }
    mbar_wait(&sm.full[s], (i / S::kSlots) & 1);
    const Band b = sm.band[s];
    if (V::kBulkOut && tid == 0) {
      bulk_wait_read();     // the last band's store has read `out`
      gr.band = sm.band[s];  // only this thread stores the band
    }
    if constexpr (V::kAliasOut) group_sync<V>(g);  // ... before convert writes it
    if constexpr (V::kProduct) {
      src.convert(gr, sm.raw[s], b, tid);
    } else {
      group_sync<V>(g);  // the last band's store pass has read q
      src.bare(gr, sm.raw[s], tid);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);  // the slot's reads are done
    group_sync<V>(g);
    if constexpr (V::kProduct) {
      if constexpr (V::kBasisA) {
        basis_a_band<V>(
            gr, reinterpret_cast<const uint16_t*>(smem_bytes + sizeof(S)), gw);
      } else if constexpr (V::kWide) {
#pragma unroll 1
        for (int mt = 0; mt < V::kTiles / 16; ++mt) {
          product_staged<V>(
              gr, reinterpret_cast<const uint16_t*>(smem_bytes + sizeof(S)),
              mt, gw);
        }
      } else {
#pragma unroll 1
        for (int mt = 0; mt < V::kTiles / 16; ++mt) {
          product<V>(gr, mt, ch, bl, bc, gr.q, lum_col, chr_col);
        }
      }
      group_sync<V>(g);
    }
    if constexpr (V::kStage == Stage::kSplit) {
      store_split<V>(gr, b, out, tid);
    } else if constexpr (V::kInput == Input::kKt) {
      store_rows<V>(gr, static_cast<int16_t*>(out.p[0]), g, tid);
    } else if constexpr (V::kBlockMajor) {
      store_rows<V>(gr, out, g, tid);
    } else {
      store_lanes<V>(gr, b, out, n_blocks, tid);
    }
  }
  if (V::kBulkOut && tid == 0) bulk_wait_read();  // out stays until read
}

// The kernel of the RGB variants (K1 among them): band_loop over image
// bands.
template <class V>
__global__ void __launch_bounds__(V::kCtaThreads, 1)
    fwd_megakernel(const uint8_t* __restrict__ rgb,
                   typename V::Out* __restrict__ out,
                   const uint16_t* __restrict__ parts, uint32_t n_bands,
                   int height, int width, int bpc, int bpr, bool staged) {
  const int bands_per_row = (bpr + V::kTiles - 1) / V::kTiles;
  int64_t n_blocks = 0;  // N: the lane stride of coefficient-major output
  if constexpr (!V::kBlockMajor) {
    n_blocks = static_cast<int64_t>(n_bands / bands_per_row) * bpr;
  }
  const RgbBands<V> src{rgb, height, width, bpc, bpr, bands_per_row,
                        width * 3, staged};
  band_loop<V>(src, out, parts, n_bands, n_blocks);
}

// The kernel of the KT variants: band_loop over KT slabs, always staged
// (the launcher checks the cp.async route's alignment).
template <class V>
__global__ void __launch_bounds__(V::kCtaThreads, 1)
    fwd_megakernel_kt(const uint8_t* __restrict__ kt, KtOut out,
                      const uint16_t* __restrict__ parts, uint32_t n_bands,
                      int64_t n_blocks) {
  band_loop<V>(KtBands<V>{kt, n_blocks}, out, parts, n_bands, n_blocks);
}

// The launch of variant V over n_bands bands: the resident CTAs (SMs ×
// the occupancy query), the CTAs launched, the consumer groups a CTA, the
// ring slots, the threads a CTA, the dynamic shared memory, the bytes a
// ring slot and the tiles a band (T).
struct Launch {
  long long n_bands, resident, ctas;
  int groups, slots, threads, smem, slot_bytes, tiles;
};

// The persistent grid of `kernel` (variant V) for n_bands: the resident
// CTAs of every SM, at most n_bands.  Returns the first failed attribute
// call or query; for a register split, cudaErrorInvalidConfiguration where
// the kernel was not built at the registers its consumers' setmaxnreg.inc
// takes from the producer's .dec (they would wait for them forever).
template <class V, class K>
cudaError_t persistent_grid(K kernel, int64_t n_bands, Launch* p) {
  const int smem = dynamic_smem<V>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if constexpr (V::kRegSplit) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * V::kCtaThreads <
        V::kGroups * V::kGroupThreads * kConsumerRegs +
            32 * V::kProducerWarps * kProducerRegs) {
      return cudaErrorInvalidConfiguration;
    }
  }
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      V::kCtaThreads, smem);
  if (err != cudaSuccess) return err;
  p->n_bands = n_bands;
  p->resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  p->ctas = p->resident < n_bands ? p->resident : n_bands;
  p->groups = V::kGroups;
  p->slots = Smem<V>::kSlots;
  p->threads = V::kCtaThreads;
  p->smem = smem;
  p->slot_bytes = V::kBandBytes;
  p->tiles = V::kTiles;
  return cudaSuccess;
}

// The bands of a (batch, H, W) RGB launch of V, or -1 where the 32-bit band
// geometry would not hold (band + grid, image rows and W·24 below 2^31).
template <class V>
int64_t rgb_bands(int batch, int height, int width, int bpc, int bpr) {
  const int64_t n_bands = static_cast<int64_t>(batch) * bpc *
                          ((bpr + V::kTiles - 1) / V::kTiles);
  if (n_bands > (1ll << 30) || static_cast<int64_t>(batch) * height >= (1ll << 31) ||
      static_cast<int64_t>(width) * 24 >= (1ll << 31)) {
    return -1;
  }
  return n_bands;
}

// Launch variant V on `stream` (the contract of fwd_megakernel_launch in
// csrc/fwd_megakernel.cu): returns cudaGetLastError() or the first failed
// query, never synchronises.  A block-major output leaves by bulk stores:
// it must be 16-byte aligned.
template <class V>
int launch_variant(const void* rgb, void* out, const void* parts, int batch,
                   int height, int width, int bpc, int bpr, int staged,
                   void* stream) {
  const int64_t n_bands = rgb_bands<V>(batch, height, width, bpc, bpr);
  if (n_bands < 0) return cudaErrorInvalidValue;
  if (n_bands == 0) return cudaSuccess;
  if (staged && (reinterpret_cast<uintptr_t>(rgb) % 16 != 0 ||
                 (static_cast<int64_t>(width) * 3) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (V::kBulkOut && reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  Launch p;
  const cudaError_t err = persistent_grid<V>(fwd_megakernel<V>, n_bands, &p);
  if (err != cudaSuccess) return err;
  fwd_megakernel<V><<<static_cast<unsigned>(p.ctas), V::kCtaThreads, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<typename V::Out*>(out),
      static_cast<const uint16_t*>(parts), static_cast<uint32_t>(n_bands),
      height, width, bpc, bpr, staged != 0);
  return cudaGetLastError();
}

// Launch KT variant V on `stream`: kt is (3, 64, n_blocks) uint8,
// contiguous; the cp.async route needs n_blocks % 16 == 0 and a 16-byte
// aligned kt, else cudaErrorInvalidValue.  Returns cudaGetLastError() or
// the first failed query, never synchronises.
template <class V>
int launch_kt(const void* kt, const KtOut& out, const void* parts,
              int64_t n_blocks, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (n_blocks % 16 != 0 || reinterpret_cast<uintptr_t>(kt) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (V::kBulkOut && reinterpret_cast<uintptr_t>(out.p[0]) % 16 != 0) {
    return cudaErrorMisalignedAddress;
  }
  const int64_t n_bands = (n_blocks + V::kTiles - 1) / V::kTiles;
  if (n_bands > (1ll << 30)) return cudaErrorInvalidValue;
  Launch p;
  const cudaError_t err = persistent_grid<V>(fwd_megakernel_kt<V>, n_bands, &p);
  if (err != cudaSuccess) return err;
  fwd_megakernel_kt<V><<<static_cast<unsigned>(p.ctas), V::kCtaThreads, p.smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(kt), out,
      static_cast<const uint16_t*>(parts), static_cast<uint32_t>(n_bands),
      n_blocks);
  return cudaGetLastError();
}

// Registers a thread, shared memory a CTA (static + dynamic) and resident
// CTAs an SM of `kernel`, variant V (cudaFuncGetAttributes and the
// occupancy query at its threads and shared memory).
template <class V, class K>
int kernel_attributes(K kernel, int* regs, int* smem, int* ctas_per_sm) {
  const int bytes = dynamic_smem<V>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel,
                                                      V::kCtaThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *smem = bytes + static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaSuccess);
}

}  // namespace
