// Inverse megakernel (K9) for Hopper (sm_90a): the (B, N, 128) int16
// combined sparse16 buffer -> (B, height, width, 3) uint8 interleaved RGB,
// in one launch.
//
// Replaces the sparse16 decode of lz4jpeg_tpu/models/jpeg.py::_inverse_impl
// (:383, branch :408-436, fed by _inverse_sparse_impl :448), which XLA ran
// with no Pallas kernel: the un-bias, per channel the suffix-basis einsum
// (ops/fused.py:220 fused_inverse_plane_sparse_jnp on :201
// inverse_suffix_basis: the RLE prefix sum and the 4:2:2 upsample live in
// the basis) and the colour merge (ops/color.py:92 ycbcr_planes_to_rgb with
// chroma_upsampled=True), the merge the TPU candidate P-color
// (profiles/profile_plane_color_kernel.py:27, pallas_call :55) computed.
// N = bpc · bpr tiles a frame, block-row-major; lanes [0, 64) luma, [64, 96)
// Cr, [96, 128) Cb.  Per tile:
//   1. delta = (w != 0) ? w - 1024 : 0;
//   2. Y[8u + v] = sum_m delta_m · S_lum[8u + v, m] over 64 terms; Cr and Cb
//      4 samples a row over 32 terms each;
//   3. + 128.0f, then the plain version's round op for op: sign(x) ·
//      floor(|x| + 0.5f), clamped to [0, 255] (not roundf, which differs
//      where |x| + 0.5 rounds up in fp32);
//   4. the colour merge of csrc/color_merge.cuh (P-color's arithmetic);
//   5. only pixels with row < height and col < width are stored.
// Every output byte is meant to be the one the fp32 FMA chain over m in
// order from 0 gives (the design this one replaced summed every plane value
// so): step 2 runs on the tensor cores, exactly in parts, and where its value
// lies near a point where the byte changes the chain is recomputed (Ties,
// below).  That rests on a measured window, not on a proof: on every buffer
// tested the bytes are the chain's; elsewhere a value whose tensor-core sum
// and chain lie on two sides of a step outside its window would give the
// other of two neighbouring bytes, a one-step flip that
// utils/parity.py::decode_flips admits.  Against the plain version (cuBLAS's
// summation order) a plane value may round the other way only where it lies
// within the fp32 error of two summation orders of a half-integer
// (decode_flips).
//
// What bounds it.  A tile reads 256 B and writes at most 192 B of RGB: at
// 2048² b64 1,073,741,824 B in and 805,306,368 B out, 0.5609 ms at the 3.35
// TB/s of an H100 SXM's data sheet.  The product is 64·64 + 2·32·32 = 6,144
// multiply-adds a tile; as bf16 part products (3 where every delta of a
// warp's unit lies under 2^8 in magnitude, 6 otherwise) 154.6 to 309.2
// GFLOP at b64, 0.1563 to 0.3127 ms at the data sheet's 989 TFLOP/s dense
// bf16.  So the bytes bound it.
//
// Design (csrc/mcu_transform_kernel.cu's inverse, P-mcu-i, carried over).
// - Work map.  A unit is 16 consecutive tiles of one block row (frames ×
//   block rows × ceil(bpr / 16) units), the 16 rows of a warp's A operand;
//   a block row's last unit takes the rest, and its missing rows are
//   computed as zero deltas but never stored.
// - Ring.  Persistent CTAs, one an SM (the occupancy query at kSmem), of
//   kWarps warps and kStages slots, each holding a chunk of kWarps
//   consecutive units, which lie in one contiguous run of tiles: one 1-D
//   cp.async.bulk of the run on the slot's "full" mbarrier
//   (csrc/bulk_ring.cuh); an input base off 16 bytes takes the word route
//   (the filling warp's lanes copy the run a word each, one arrives).  Warp
//   w takes unit w of each chunk and releases the slot once it has loaded
//   its words.  There is no producer warp: warp 0 fills the first kStages
//   chunks, and the last warp to release a slot (a counter beside the slot)
//   fills it with the CTA's chunk kStages on.  So a CTA is kWarps = 8
//   warps, two a scheduler, and ptxas may give each thread up to 255
//   registers: at 9 or more warps (three on one scheduler) its limit is
//   168 and it spills.
// - A operand: the deltas, formed in registers from the slot.  Lane (g, c)
//   holds rows g and g + 8; the order of k inside a product is free, so term
//   j of a channel sits in k slot sigma(j) = 16 v + 2 c + (e & 1) + 8 (e >>
//   1) with j = (HW/4) c + 4 v + e: lane c reads its terms of a row as one
//   32-byte (luma: two 16-byte loads) or 16-byte run (Cr, Cb).  Tiles lie
//   256 bytes apart, so rows g and g + 1, which one 128-bit load phase
//   pairs, hit the same banks: 8 such loads a lane and unit take twice
//   their fewest wavefronts (swapping their order by g's parity would cost
//   selects on an issue-bound path).  Each int16 word w becomes delta by
//   full-rate operations (its bits ^ 0x8000 under 2^23's exponent, less
//   2^23 + 33,792; a zero word gives -1024 and is selected to 0), then
//   splits exactly into bf16 parts hi (the float's top 16 bits) and mid =
//   delta - hi (at most 8 significant bits for |delta| < 2^16): not
//   split_pair's rounding, a truncation, which saves the conversions and is
//   as exact.  A warp vote per channel (__any_sync) issues the mid products
//   only where the warp's fragment has a mid part.  The channels run Cr,
//   Cb, then luma, each to its bytes, so that one channel's accumulators
//   live at a time.
// - B operand: the three bf16 parts of ops/fwd_megakernel.py::split_basis
//   of the float32 suffix bases (ops/inv_megakernel.py::basis_parts),
//   staged once a CTA, rows padded (72 bf16 luma, 40 chroma) so that each
//   ldmatrix.x4's eight rows fall in distinct banks; columns k in slot order
//   and rows (output columns) permuted so that each lane's accumulators hold
//   what its pixels need: column n = 8 t + 2 c + e of n-tile t is luma pixel
//   (2 (t >> 1) + (c >> 1), 4 (c & 1) + 2 (t & 1) + e) and chroma sample
//   (2 t + (c >> 1), 2 (c & 1) + e).  Lane (g, c) then holds, for its tiles
//   g and g + 8 and pixel rows u = 2k + (c >> 1), the Y of pixels 4 (c & 1)
//   .. + 3 and the Cr and Cb of the two samples they take: the merge needs
//   no shuffle.  mma.sync m16n8k16 bf16 with fp32 accumulators (K1's
//   mma_bf16 and ldmatrix_x4, csrc/fwd_megakernel.cuh), the part products
//   smallest first (mid · lo, then by level down to hi · hi): the tensor
//   core adds a k-step's products to the accumulator aligned to the largest
//   of them and truncated, so the small terms are summed while the sum is
//   small.
// - Epilogue.  Full-rate float adds only: v = acc + 128.5 and v + 2^23
//   rounded toward zero, whose bits clamped to [2^23's, + 255] hold the
//   byte floor(v) in [0, 255] (the parent's byte wherever v is not within
//   an ulp of an integer), packed four to a register.
// - Ties.  Where v lies within W of an integer and the byte steps there,
//   the lane recomputes the plane value by the parent's chain (fp32 fmaf
//   over the un-biased deltas in m order from 0: the deltas as the warp
//   staged them in fp32 rows of its buffer while forming the A operand, the
//   fp32 basis row staged once a CTA) and its byte by the parent's round,
//   before the merge.  Each lane walks its own tie mask;
//   the launch's `ties`, if given, counts the values.  W is a row's own:
//   kTieWindow (2^-9) or, where larger, the row's sum over its terms of
//   |delta_m| · max_p |S[p][m]| · kRowScale (the weights staged once a
//   CTA), a bound of every output's sum |delta · S| scaled; a row whose W
//   passes kEveryWindow (1/16) sends every value to the chain.  The
//   argument: the chain and the tensor-core sum each differ from the exact
//   sum by their own rounding, which grows with sum |delta · S|; while
//   their distance stays under W, outside the window both lie on one side
//   of every point where the byte changes and give one byte, and inside it
//   the chain's byte is taken.  The distance has no proof of a bound here
//   (the worst case of a 64-term chain alone is ~2^-18 of sum |delta · S|):
//   it is measured.  On the card (profiles/inv_probe.py's distance build,
//   noise at quality 50-100, stress buffers of uniform deltas of ±32 to
//   ±256) the largest distance of a value whose byte may step was rho =
//   2^-23.8 of its row's unscaled sum; kRowScale = 2^-21 keeps every row's
//   distance under rho / kRowScale = 0.14 of its W whatever the floor, so
//   under the quarter kept as margin (at 2^-22 a ±64 buffer reached 0.24).
//   The CPU mirror's model (ops/inv_megakernel.py::emulate) stays under it
//   too.  Measuring builds edit the constants below (profiles/
//   inv_probe.py): kFixedWindow holds every row at kTieWindow, kDistance
//   records the largest distance.
// - Merge and stores.  The merge (color_merge.cuh's terms_of and clamp255)
//   from the lane's bytes: a chroma byte under 2^23's exponent less 2^23 +
//   128 is (float)byte - 128.0f exactly, no conversion; each warp stages
//   its 8 pixel rows of 16 tiles of RGB over its delta rows (384 contiguous
//   bytes a row, rows 448 bytes apart, so that a warp's 4-byte staging
//   stores hit distinct banks) and stores them as 16-byte vectors when the
//   output base and the row stride W·3 are 16-byte aligned (a unit starts
//   at a multiple of 384 bytes), a byte a lane otherwise.
// - 64-bit offsets: b256 at 2048² reads 4.29 GB and writes 3.2 GB.
//
// Resources (ptxas and the occupancy query on an H100, sm_90a; phase 29 of
// chip_smoke.py prints them): 226 registers, 203,288 B of dynamic shared
// memory, 1 CTA an SM, no spill stores.  What holds it (PERF.md §6):
// issue and latency with two warps a scheduler, and the tie pass, about
// 0.5 ms of 1.9 at 2048² b64 (profiles/inv_probe.py times the kernel
// without it).

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "color_merge.cuh"
#include "fwd_megakernel.cuh"

namespace {
namespace k9 {

using color_merge::clamp255;

constexpr int kUnit = 16;                    // tiles a unit: the A rows
constexpr int kWarps = 8;                    // consumer warps a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                   // ring slots
constexpr int kCtasPerSm = 1;
constexpr int kLanes = 128;                  // int16 words a tile
constexpr int kTileBytes = 2 * kLanes;
constexpr int kSlotBytes = kWarps * kUnit * kTileBytes;
constexpr int kLumStride = 72;               // bf16 a staged basis row
constexpr int kChrStride = 40;
constexpr int kLumPart = 64 * kLumStride;
constexpr int kChrPart = 32 * kChrStride;
constexpr int kLumRow = 68;                 // fp32 a staged basis row
constexpr int kChrRow = 36;
constexpr int kFloats = 3 * (kLumPart + 2 * kChrPart) * 2;  // its offset
constexpr int kRing =
    (kFloats + (64 * kLumRow + 64 * kChrRow) * 4 + 512 + 127) / 128 * 128;
constexpr int kStageRow = 448;               // bytes a staged RGB row
constexpr int kDeltaRow = kLanes + 4;       // floats a staged delta row
// A warp's buffer: its unit's deltas as fp32 rows (the tie pass's), then
// its staged RGB rows over them.
constexpr int kBufferBytes = kUnit * kDeltaRow * 4;
constexpr int kStaging = kRing + kStages * kSlotBytes;
constexpr int kBarriers = kStaging + kWarps * kBufferBytes;
constexpr int kSmem = kBarriers + 12 * kStages;  // mbarriers, counters
constexpr int kBias = 1024;                  // ops/rle.py::SPARSE16_DELTA_BIAS
constexpr float kTieWindow = 1.0f / 512.0f;     // 2^-9: a row's least W
constexpr float kRowScale = 1.0f / 2097152.0f;   // 2^-21: a row's window
constexpr float kEveryWindow = 1.0f / 16.0f;     // past it, every value
// Measuring builds only (profiles/inv_probe.py): every row's W kTieWindow;
// the largest |sum - chain| / W and / (W's unscaled sum) into ties[1], [2].
constexpr bool kFixedWindow = false;
constexpr bool kDistance = false;
constexpr int kWeights = kRing - 512;            // the 128 term weights
constexpr float k23 = 8388608.0f;
constexpr int kBits23 = 0x4B000000;          // the bits of k23
constexpr float kDeltaMagic = k23 + 32768.0f + kBias;  // exact
static_assert(kStageRow >= 24 * kUnit && kStageRow % 16 == 0 &&
                  8 * kStageRow <= kBufferBytes,
              "staged rows");

struct Unit {
  int64_t tile0;  // the unit's first tile in the buffer
  int tiles;      // tiles in the unit (kUnit but in a row's last unit)
  int frame, block_row, col0;  // col0: the unit's first block column
};

__device__ __forceinline__ Unit unit_of(int unit, int units_row, int bpc,
                                        int bpr) {
  const int fr = unit / units_row;  // frame · bpc + block row
  Unit g;
  g.col0 = (unit - fr * units_row) * kUnit;
  g.tiles = min(kUnit, bpr - g.col0);
  g.tile0 = static_cast<int64_t>(fr) * bpr + g.col0;
  g.frame = fr / bpc;
  g.block_row = fr - g.frame * bpc;
  return g;
}

// The three basis parts of each channel, (3, 64, 64) luma then (3, 32, 32)
// Cr and Cb bf16 bits in [column][slot] order, into the padded rows of
// shared memory, 16 bytes a copy.
__device__ __forceinline__ void stage_basis(uint16_t* dst,
                                            const uint16_t* __restrict__ src) {
  for (int i = threadIdx.x; i < 3 * 64 * 8; i += kThreads)
    reinterpret_cast<uint4*>(dst + (i >> 3) * kLumStride)[i & 7] =
        reinterpret_cast<const uint4*>(src)[i];
  const uint16_t* cs = src + 3 * 64 * 64;
  uint16_t* cd = dst + 3 * kLumPart;
  for (int i = threadIdx.x; i < 6 * 32 * 4; i += kThreads)
    reinterpret_cast<uint4*>(cd + (i >> 2) * kChrStride)[i & 3] =
        reinterpret_cast<const uint4*>(cs)[i];
}

// The fp32 bases (the tie pass's), [pixel][term], into rows of kLumRow
// (luma) and kChrRow floats (Cr rows 0-31, Cb 32-63), so that the 16-byte
// loads of eight lanes on eight rows fall in distinct banks.
__device__ __forceinline__ void stage_bases(float* dst,
                                            const float* __restrict__ src) {
  for (int i = threadIdx.x; i < 64 * 16; i += kThreads)
    reinterpret_cast<float4*>(dst + (i >> 4) * kLumRow)[i & 15] =
        reinterpret_cast<const float4*>(src)[i];
  float* cd = dst + 64 * kLumRow;
  for (int i = threadIdx.x; i < 64 * 8; i += kThreads)
    reinterpret_cast<float4*>(cd + (i >> 3) * kChrRow)[i & 7] =
        reinterpret_cast<const float4*>(src + 64 * 64)[i];
}

// Each term's weight in its row's window: the largest |S[p][m]| over the
// channel's outputs p (luma terms 0-63, Cr 64-95, Cb 96-127), times
// kRowScale.
__device__ __forceinline__ void stage_weights(float* dst,
                                              const float* __restrict__ src) {
  for (int m = threadIdx.x; m < 128; m += kThreads) {
    const bool luma = m < 64;
    const int n = luma ? 64 : 32;
    const float* col = luma ? src + m : src + 4096 + 1024 * ((m - 64) >> 5) +
                                           ((m - 64) & 31);
    float top = 0.0f;
    for (int p = 0; p < n; ++p) top = fmaxf(top, fabsf(col[n * p]));
    dst[m] = top * kRowScale;
  }
}

// acc += A . part over every k-step and n-tile: the B fragments of n-tiles
// 2p and 2p + 1 of k-step ks by one ldmatrix.x4 (P-mcu-i's product), each
// just before its two products (the warps around hide its latency).
template <int KSteps, int Stride>
__device__ __forceinline__ void product(float (&acc)[2 * KSteps][4],
                                        const uint32_t (&a)[KSteps][4],
                                        const uint16_t* part, int lane) {
  const uint16_t* base =
      part + ((lane & 7) + 8 * (lane >> 4)) * Stride + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
#pragma unroll
    for (int p = 0; p < KSteps; ++p) {
      uint32_t b[4];
      ldmatrix_x4(b, base + 16 * p * Stride + 16 * ks);
      mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
    }
  }
}

// The deltas of the two int16 words of `w` (low half first), exactly:
// (w ^ 0x8000) under 2^23's exponent is 2^23 + 32768 + w, less kDeltaMagic
// is w - 1024, which is -1024 only for w = 0, whose delta is 0.
__device__ __forceinline__ void deltas(uint32_t w, float& d0, float& d1) {
  const uint32_t y = w ^ 0x80008000u;
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(y, 0x4B00u, 0x5410)),
                             kDeltaMagic);
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(y, 0x4B00u, 0x5432)),
                             kDeltaMagic);
  d0 = f0 == -1024.0f ? 0.0f : f0;
  d1 = f1 == -1024.0f ? 0.0f : f1;
}

// One channel's A operand for KSteps k-steps (HW = 16 KSteps terms) from the
// lane's 32-bit words of rows g ([0]) and g + 8 ([1]), word q holding terms
// (HW/4) c + 2q and + 1 (k-step q >> 1, A register 2 (q & 1) + row): the
// hi or (Mid) the mid part's registers.  For the hi part also the deltas
// as fp32 into the warp's rows at `drow` (row g's run of the lane's terms;
// row g + 8 eight rows on), each row's sum of |delta| · weight over the
// lane's terms (`wt`: their HW/4 weights) and the OR of the deltas' low 16
// bits: the mid part (delta less its hi part, exact) is non-zero exactly
// where a delta's float has them.
template <int KSteps, bool Mid>
__device__ __forceinline__ void operand(uint32_t (&a)[KSteps][4],
                                        const uint32_t (&w)[2][2 * KSteps],
                                        const float* wt, float* drow,
                                        float (&sum)[2], uint32_t& low) {
#pragma unroll
  for (int v = 0; v < KSteps; ++v) {  // words 2v, 2v + 1: k-step v
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (!Mid) u = *reinterpret_cast<const float4*>(wt + 4 * v);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[4];
      deltas(w[h][2 * v], d[0], d[1]);
      deltas(w[h][2 * v + 1], d[2], d[3]);
      if (Mid) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[e] = __fsub_rn(d[e], __uint_as_float(__float_as_uint(d[e]) &
                                                 0xFFFF0000u));
      } else {
        sum[h] = fmaf(fabsf(d[0]), u.x, fmaf(fabsf(d[1]), u.y, sum[h]));
        sum[h] = fmaf(fabsf(d[2]), u.z, fmaf(fabsf(d[3]), u.w, sum[h]));
        low |= __float_as_uint(d[0]) | __float_as_uint(d[1]) |
               __float_as_uint(d[2]) | __float_as_uint(d[3]);
        *reinterpret_cast<float4*>(drow + 8 * h * kDeltaRow + 4 * v) =
            make_float4(d[0], d[1], d[2], d[3]);
      }
      a[v][h] = __byte_perm(__float_as_uint(d[0]), __float_as_uint(d[1]),
                            0x7632);
      a[v][2 + h] = __byte_perm(__float_as_uint(d[2]), __float_as_uint(d[3]),
                                0x7632);
    }
  }
}

// A channel's products, smallest first: by level pa + pb from 3 (mid · lo)
// to 0 (hi · hi), the mid delta part first within a level, the mid part
// only where the warp's vote finds it.  Returns in `sum` the rows' (g, g +
// 8) sums of |delta| · weight over all their terms (the lane quad's).
template <int KSteps, int Stride>
__device__ __forceinline__ void channel_product(
    float (&acc)[2 * KSteps][4], const uint32_t (&w)[2][2 * KSteps],
    const uint16_t* parts, const float* wt, float* drow, float (&sum)[2],
    int lane) {
  constexpr int kPart = 16 * KSteps * Stride;
  uint32_t hi[KSteps][4];
  uint32_t low = 0u;
  sum[0] = sum[1] = 0.0f;
  operand<KSteps, false>(hi, w, wt, drow, sum, low);
  if (__any_sync(0xFFFFFFFFu, (low & 0xFFFFu) != 0u)) {
    uint32_t mid[KSteps][4];
    operand<KSteps, true>(mid, w, nullptr, nullptr, sum, low);
    product<KSteps, Stride>(acc, mid, parts + 2 * kPart, lane);  // mid · lo
    product<KSteps, Stride>(acc, mid, parts + kPart, lane);      // mid · mid
    product<KSteps, Stride>(acc, hi, parts + 2 * kPart, lane);
    product<KSteps, Stride>(acc, mid, parts, lane);              // mid · hi
    product<KSteps, Stride>(acc, hi, parts + kPart, lane);
  } else {
    product<KSteps, Stride>(acc, hi, parts + 2 * kPart, lane);
    product<KSteps, Stride>(acc, hi, parts + kPart, lane);
  }
  product<KSteps, Stride>(acc, hi, parts, lane);                  // hi · hi
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xFFFFFFFFu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xFFFFFFFFu, sum[h], 2);
  }
}

// The epilogue's byte of a tensor-core plane value: v = acc + 128.5 and
// the bits of v + 2^23 rounded toward zero, clamped to [kBits23, kBits23 +
// 255]: kBits23 + clamp(floor(v), 0, 255), which as a float is 2^23 plus
// the byte.  `near`: v within W of an integer (|v - floor(v) - 0.5| > 0.5 -
// W, exact: 2^23 - 0.5 is a float, as is floor(v) + 0.5) where the clamp
// left the bits as they were (the byte steps there).
__device__ __forceinline__ int fast_bits(float acc, float half_less_w,
                                         bool& near) {
  const float v = __fadd_rn(acc, 128.5f);
  const float shifted = __fadd_rz(v, k23);
  const int bits = __float_as_int(shifted);
  const int clamped = min(max(bits, kBits23), kBits23 + 255);
  near = fabsf(__fsub_rn(v, __fsub_rn(shifted, k23 - 0.5f))) > half_less_w &&
         clamped == bits;
  return clamped;
}

// The parent's + 128, round and clamp: sign(x) · floor(|x| + 0.5f) clamped
// to [0, 255]; every x <= 0 rounds to a value <= 0, so to 0.
__device__ __forceinline__ int pixel(float acc) {
  const float x = __fadd_rn(acc, 128.0f);
  return x > 0.0f
             ? static_cast<int>(fminf(floorf(__fadd_rn(x, 0.5f)), 255.0f))
             : 0;
}

// The parent's plane value: fp32 fmaf over n terms in m order from 0, the
// deltas and the basis row from shared memory.
__device__ __forceinline__ float chain(const float* d, const float* s,
                                       int n) {
  float acc = 0.0f;
#pragma unroll 4
  for (int q = 0; q < n; q += 4) {
    const float4 dv = *reinterpret_cast<const float4*>(d + q);
    const float4 sv = *reinterpret_cast<const float4*>(s + q);
    acc = fmaf(dv.x, sv.x, acc);
    acc = fmaf(dv.y, sv.y, acc);
    acc = fmaf(dv.z, sv.z, acc);
    acc = fmaf(dv.w, sv.w, acc);
  }
  return acc;
}

// Row h's window from its weighted |delta| sum (Ties, above).
__device__ __forceinline__ float row_window(float sum) {
  return kFixedWindow ? kTieWindow : fmaxf(kTieWindow, sum);
}

// The parent's plane value of the lane's value i (luma 4 t + r, Cr 32 + 4 t
// + r, Cb 48 + 4 t + r: n-tile t, accumulator r): its tile row's deltas as
// the warp staged them in `buf` and its basis row, luma pixel p = 8u + v or
// chroma channel chn's sample p = 4u + s (column_map's inverse).
__device__ __forceinline__ float value_chain(int i, int g, int c,
                                             const float* buf,
                                             const float* fbasis) {
  const int r = i & 3, t = (i >> 2) & 7;
  const float* d = buf + (g + 8 * (r >> 1)) * kDeltaRow;
  if (i < 32)
    return chain(d, fbasis + kLumRow * (8 * (2 * (t >> 1) + (c >> 1)) +
                                        4 * (c & 1) + 2 * (t & 1) + (r & 1)),
                 64);
  const int chn = (i - 32) >> 4;
  return chain(d + 64 + 32 * chn,
               fbasis + 64 * kLumRow +
                   kChrRow * (32 * chn + 4 * (2 * (t & 3) + (c >> 1)) +
                              2 * (c & 1) + (r & 1)),
               32);
}

// A measuring build's record (kDistance): over the channel's values (i0 +
// 4 t + r) whose byte may step (chain + 128.5 in (-1, 256)) in rows that do
// not chain every value, the largest |sum - chain| / W into ties[1] and /
// (W's sum unscaled: sum_m |delta_m| max_p |S[p][m]|) into ties[2], as
// float bits (atomicMax: non-negative floats order as their bits).
template <int NT>
__device__ __forceinline__ void distance(const float (&y)[NT][4],
                                         const float (&sum)[2], int i0,
                                         int g, int c, const float* buf,
                                         const float* fbasis,
                                         unsigned long long* ties) {
  __syncwarp();  // the warp's staged delta rows
  float top = 0.0f, rel = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float s = value_chain(i0 + 4 * t + r, g, c, buf, fbasis);
      const float v = s + 128.5f, w = row_window(sum[r >> 1]);
      const float e = fabsf(y[t][r] - s);
      if (v > -1.0f && v < 256.0f && (kFixedWindow || w <= kEveryWindow)) {
        top = fmaxf(top, e / w);
        if (sum[r >> 1] > 0.0f) rel = fmaxf(rel, e * kRowScale / sum[r >> 1]);
      }
    }
  }
  const unsigned a = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(top));
  const unsigned b = __reduce_max_sync(0xFFFFFFFFu, __float_as_uint(rel));
  if ((threadIdx.x & 31) == 0 && ties != nullptr) {
    atomicMax(ties + 1, static_cast<unsigned long long>(a));
    atomicMax(ties + 2, static_cast<unsigned long long>(b));
  }
}

// One channel's bytes from its NT n-tiles of accumulators, packed four to
// a word into pk[0 .. NT - 1]; its tie bits (near a step, or every value
// of a row whose window passes kEveryWindow) into `ties` from bit `at`.
// sum[h]: row h's weighted |delta| sum.
template <int NT>
__device__ __forceinline__ void channel_bytes(uint32_t* pk, uint32_t& ties,
                                              int at,
                                              const float (&y)[NT][4],
                                              const float (&sum)[2]) {
  float half_less_w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float w = row_window(sum[h]);
    half_less_w[h] = 0.5f - w;
    if (!kFixedWindow && w > kEveryWindow)
      ties |= (h ? 0xCCCCCCCCu : 0x33333333u) &
              ((0xFFFFFFFFu >> (32 - 4 * NT)) << at);
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    uint32_t q[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool near;
      q[r] = static_cast<uint32_t>(
          fast_bits(y[t][r], half_less_w[r >> 1], near));
      ties |= near ? 1u << (at + 4 * t + r) : 0u;
    }
    pk[t] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                        __byte_perm(q[2], q[3], 0x0040), 0x5410);
  }
}

// The rows of the unit that exist: bits 4 t + 2 h + e of a tie mask hold
// row g + 8h.
__device__ __forceinline__ uint32_t valid_rows(int g, int rows) {
  return (g < rows ? 0x33333333u : 0u) | (g + 8 < rows ? 0xCCCCCCCCu : 0u);
}

// One warp's unit from its tiles at `x` (in the ring slot): the products,
// the bytes and the tie pass; the slot released; the merge staged at `st`
// and the unit's pixels stored.
template <typename Release>
__device__ __forceinline__ void unit_block(
    const int16_t* x, const Unit& un, const uint16_t* basis,
    const float* fbasis, const float* wts, float* buf,
    uint8_t* __restrict__ out, int height, int width, bool vec_out,
    unsigned long long* ties, const Release& release,
    int lane) {
  const int g = lane >> 2, c = lane & 3;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  // -- chroma first, then luma (so that one channel's accumulators live at
  // a time): each channel's words of rows g and g + 8 (zero past the
  // unit's tiles), its products, its rows' windows from their weighted
  // |delta| sums and its bytes, packed: value i (luma 4 t + r, Cr 32 + 4 t
  // + r, Cb 48 + 4 t + r: n-tile t, accumulator r) is byte i & 3 of
  // pk[i >> 2]; the tie masks tl (luma) and tc (Cr bits 0-15, Cb 16-31),
  // row h's bits 0x3333.. (h = 0) or 0xCCCC.., all of a row whose window
  // passes kEveryWindow.
  uint32_t wc[2][2][4], wl[2][8];  // Cr and Cb, luma
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint4 l0 = make_uint4(0, 0, 0, 0), l1 = l0, r0 = l0, b0 = l0;
    if (g + 8 * h < un.tiles) {
      const uint8_t* row = xb + (g + 8 * h) * kTileBytes;
      l0 = *reinterpret_cast<const uint4*>(row + 32 * c);
      l1 = *reinterpret_cast<const uint4*>(row + 32 * c + 16);
      r0 = *reinterpret_cast<const uint4*>(row + 128 + 16 * c);
      b0 = *reinterpret_cast<const uint4*>(row + 192 + 16 * c);
    }
    wl[h][0] = l0.x, wl[h][1] = l0.y, wl[h][2] = l0.z, wl[h][3] = l0.w;
    wl[h][4] = l1.x, wl[h][5] = l1.y, wl[h][6] = l1.z, wl[h][7] = l1.w;
    wc[0][h][0] = r0.x, wc[0][h][1] = r0.y, wc[0][h][2] = r0.z;
    wc[0][h][3] = r0.w;
    wc[1][h][0] = b0.x, wc[1][h][1] = b0.y, wc[1][h][2] = b0.z;
    wc[1][h][3] = b0.w;
  }
  release();  // the slot's reads are done: the tie pass reads `buf`
  uint32_t pk[16];
  uint32_t tl = 0u, tc = 0u;
  const uint16_t* chr = basis + 3 * kLumPart;
  float* drow = buf + g * kDeltaRow;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    float y[4][4] = {}, sum[2];
    channel_product<2, kChrStride>(y, wc[ch], chr + 3 * kChrPart * ch,
                                   wts + 64 + 32 * ch + 8 * c,
                                   drow + 64 + 32 * ch + 8 * c, sum, lane);
    channel_bytes<4>(pk + 8 + 4 * ch, tc, 16 * ch, y, sum);
    if constexpr (kDistance)
      distance<4>(y, sum, 32 + 16 * ch, g, c, buf, fbasis, ties);
  }
  {
    float y[8][4] = {}, sum[2];
    channel_product<4, kLumStride>(y, wl, basis, wts + 16 * c,
                                   drow + 16 * c, sum, lane);
    channel_bytes<8>(pk, tl, 0, y, sum);
    if constexpr (kDistance) distance<8>(y, sum, 0, g, c, buf, fbasis, ties);
  }
  const uint32_t rows = valid_rows(g, un.tiles);
  tl &= rows;
  tc &= rows;
  if (ties != nullptr) {  // the count of the tie pass's values, if asked
    const unsigned n = __reduce_add_sync(0xFFFFFFFFu, __popc(tl) + __popc(tc));
    if (lane == 0) atomicAdd(ties, static_cast<unsigned long long>(n));
  }

  // -- ties: the parent's chain and round, each lane its own values, from
  // the deltas the warp staged
  __syncwarp();
  while (tl | tc) {
    int i;
    if (tl) {
      i = __ffs(tl) - 1;
      tl &= tl - 1;
    } else {
      i = 32 + __ffs(tc) - 1;
      tc &= tc - 1;
    }
    const int r = i & 3;
    const uint32_t b =
        static_cast<uint32_t>(pixel(value_chain(i, g, c, buf, fbasis)));
    // byte i & 3 of pk[i >> 2] := b
    const uint32_t sel = (0x3210u & ~(0xFu << (4 * r))) | (4u << (4 * r));
#pragma unroll
    for (int k = 0; k < 16; ++k)
      pk[k] = k == (i >> 2) ? __byte_perm(pk[k], b, sel) : pk[k];
  }
  __syncwarp();  // the deltas read: the staged RGB goes over them
  uint8_t* st = reinterpret_cast<uint8_t*>(buf);

  // -- the merge, staged: pixel row 2k + (c >> 1), 12 bytes a tile.  A
  // chroma byte under 2^23's exponent, less 2^23 + 128, is (float)byte -
  // 128.0f, exactly.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t rgb[12];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int s = 4 * k + 2 * h + b;  // Cr value 32 + s, Cb 48 + s
        const color_merge::Terms tm = color_merge::terms_of(
            __fsub_rn(__uint_as_float(__byte_perm(pk[8 + (s >> 2)],
                                                  0x4B000000u,
                                                  0x7440 | (s & 3))),
                      k23 + 128.0f),
            __fsub_rn(__uint_as_float(__byte_perm(pk[12 + (s >> 2)],
                                                  0x4B000000u,
                                                  0x7440 | (s & 3))),
                      k23 + 128.0f));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = 2 * b + e;  // Y value 4 (2k + b) + 2h + e
          const int yy = static_cast<int>(
              __byte_perm(pk[2 * k + b], 0u, 0x4440 | (2 * h + e)));
          rgb[3 * q] = clamp255(yy + tm.cr);
          rgb[3 * q + 1] = clamp255(yy - tm.g);
          rgb[3 * q + 2] = clamp255(yy + tm.cb);
        }
      }
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          st + (2 * k + (c >> 1)) * kStageRow + 24 * (g + 8 * h) +
          12 * (c & 1));
#pragma unroll
      for (int w = 0; w < 3; ++w)  // bytes 4w .. 4w + 3 of the 12
        dst[w] = __byte_perm(__byte_perm(rgb[4 * w], rgb[4 * w + 1], 0x0040),
                             __byte_perm(rgb[4 * w + 2], rgb[4 * w + 3],
                                         0x0040),
                             0x5410);
    }
  }
  __syncwarp();

  // -- the stores: rows below the image, bytes of the unit inside it
  const int rows_in = min(8, height - 8 * un.block_row);
  const int count = 3 * min(8 * un.tiles, width - 8 * un.col0);
  if (rows_in > 0 && count > 0) {
    const int64_t pitch = 3LL * width;
    uint8_t* dst = out + (static_cast<int64_t>(un.frame) * height +
                          8 * un.block_row) * pitch +
                   24LL * un.col0;
    if (vec_out) {
      const int n_vec = count / 16;
      for (int q = lane; q < rows_in * 24; q += 32) {
        const int u = q / 24, k = q - 24 * u;
        if (k < n_vec)
          __stcs(reinterpret_cast<uint4*>(dst + u * pitch) + k,
                 *reinterpret_cast<const uint4*>(st + u * kStageRow + 16 * k));
      }
      for (int q = lane; q < rows_in * 16; q += 32) {
        const int u = q >> 4, k = 16 * n_vec + (q & 15);
        if (k < count) dst[u * pitch + k] = st[u * kStageRow + k];
      }
    } else {
      for (int q = lane; q < rows_in * count; q += 32) {
        const int u = q / count, k = q - count * u;
        dst[u * pitch + k] = st[u * kStageRow + k];
      }
    }
  }
  __syncwarp();
}

// Fill ring slot `slot` with chunk `chunk`: its units' run of tiles by one
// bulk copy on `full` (lane 0), or on the word route a word a lane of the
// calling warp and one arrival.
__device__ __forceinline__ void fill(unsigned char* slot, uint64_t* full,
                                     const int16_t* __restrict__ in,
                                     int chunk, int n_units, int units_row,
                                     int bpc, int bpr, bool vec_in,
                                     int lane) {
  const int u0 = chunk * kWarps;
  const Unit a = unit_of(u0, units_row, bpc, bpr);
  const Unit z = unit_of(min(u0 + kWarps, n_units) - 1, units_row, bpc, bpr);
  const int tiles = static_cast<int>(z.tile0 - a.tile0) + z.tiles;
  if (vec_in) {
    if (lane == 0) {
      const uint32_t bytes = static_cast<uint32_t>(tiles) * kTileBytes;
      mbar_expect_tx(full, bytes);
      bulk_load(slot, in + a.tile0 * kLanes, bytes, full);
    }
  } else {
    const int16_t* src = in + a.tile0 * kLanes;
    int16_t* dst = reinterpret_cast<int16_t*>(slot);
    for (int k = lane; k < tiles * kLanes; k += 32) dst[k] = __ldcs(src + k);
    __syncwarp();
    if (lane == 0) mbar_arrive(full);
  }
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
    inv_megakernel(const int16_t* __restrict__ in, uint8_t* __restrict__ out,
                   const uint16_t* __restrict__ parts,
                   const float* __restrict__ bases, int n_units,
                   int units_row, int bpc, int bpr, int height, int width,
                   int vec_in, int vec_out,
                   unsigned long long* __restrict__ ties) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* basis = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kBarriers);
  uint32_t* released = reinterpret_cast<uint32_t*>(full + kStages);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_basis(basis, parts);
  stage_bases(reinterpret_cast<float*>(smem + kFloats), bases);
  stage_weights(reinterpret_cast<float*>(smem + kWeights), bases);
  __syncthreads();
  const int chunks = (n_units + kWarps - 1) / kWarps;
  const int stride = static_cast<int>(gridDim.x);
  if (warp == 0) {  // the first fills: chunk i of the CTA into slot i
    for (int s = 0; s < kStages; ++s) {
      const int chunk = blockIdx.x + s * stride;
      if (chunk < chunks)
        fill(ring + s * kSlotBytes, &full[s], in, chunk, n_units, units_row,
             bpc, bpr, vec_in != 0, lane);
    }
  }

  float* buf = reinterpret_cast<float*>(smem + kStaging + warp * kBufferBytes);
  int i = 0;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += stride, ++i) {
    const int s = i % kStages;
    unsigned char* slot = ring + s * kSlotBytes;
    mbar_wait(&full[s], (i / kStages) & 1);
    // The slot released: the last of the CTA's warps to finish reading it
    // fills it with the CTA's chunk kStages on (no producer warp, so a CTA
    // of kWarps warps keeps ptxas's register limit at 255).
    const auto release = [&]() {
      __syncwarp();
      unsigned last = 0u;
      if (lane == 0) {
        __threadfence_block();
        last = atomicAdd(&released[s], 1u) == kWarps - 1;
      }
      last = __shfl_sync(0xFFFFFFFFu, last, 0);
      const int next = chunk + kStages * stride;
      if (last && next < chunks) {
        if (lane == 0) {
          released[s] = 0u;
          __threadfence_block();
          fence_proxy_async();
        }
        __syncwarp();
        fill(slot, &full[s], in, next, n_units, units_row, bpc, bpr,
             vec_in != 0, lane);
      }
    };
    const int unit = chunk * kWarps + warp;
    if (unit < n_units) {
      const Unit un = unit_of(unit, units_row, bpc, bpr);
      const Unit first = unit_of(chunk * kWarps, units_row, bpc, bpr);
      const int16_t* x = reinterpret_cast<const int16_t*>(slot) +
                         (un.tile0 - first.tile0) * kLanes;
      unit_block(x, un, basis, reinterpret_cast<const float*>(smem + kFloats),
                 reinterpret_cast<const float*>(smem + kWeights), buf, out,
                 height, width, vec_out != 0, ties, release, lane);
    } else {
      release();
    }
  }
}

struct Plan {
  long long units, chunks, resident, ctas;
  int units_row;
  bool vec_in, vec_out;
};

// The launch of a (batch, bpc · bpr, 128) buffer into (batch, height,
// width, 3) RGB, its input and output bases at these residues mod 16: every
// resident CTA (the occupancy query at kSmem), at most one a chunk.
cudaError_t plan_of(int batch, int bpc, int bpr, int height, int width,
                    int in_mod16, int out_mod16, Plan* p) {
  if (batch < 0 || bpc < 0 || bpr < 0 || height < 0 || width < 0 ||
      height > 8LL * bpc || width > 8LL * bpr || 24LL * bpr > INT32_MAX)
    return cudaErrorInvalidValue;
  p->units_row = (bpr + kUnit - 1) / kUnit;
  p->units = static_cast<long long>(batch) * bpc * p->units_row;
  // A unit index and a frame-row index are 32-bit: 2^31 units of 4 KiB
  // are far more than a card holds.
  if (p->units > INT32_MAX - kWarps) return cudaErrorInvalidValue;
  p->chunks = (p->units + kWarps - 1) / kWarps;
  p->vec_in = in_mod16 == 0;
  p->vec_out = out_mod16 == 0 && (3LL * width) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      inv_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_megakernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p->resident = static_cast<long long>(sms) * per_sm;
  p->ctas = p->chunks < p->resident ? p->chunks : p->resident;
  return cudaSuccess;
}

}  // namespace k9
}  // namespace

// combined: (batch, bpc · bpr, 128) int16, contiguous; out: (batch, height,
// width, 3) uint8, contiguous; parts: 18,432 bf16 bits (ops/
// inv_megakernel.py::basis_parts: luma (3, 64, 64), Cr and Cb (3, 32, 32),
// each [part][column][slot]), 16-byte aligned; bases: 6,144 fp32 (luma (64,
// 64), Cr (32, 32), Cb (32, 32), each [pixel][term]), 16-byte aligned;
// ties: nullptr, or a uint64 to which the launch adds the count of values
// its tie pass recomputes (a kDistance build's: three, ties[1] and [2] its
// largest distances).  Launches on `stream` and returns the first CUDA error of
// the queries or the launch (0 on success; cudaErrorInvalidValue for a
// shape it does not take, cudaErrorMisalignedAddress for parts or bases
// off 16 bytes); never synchronises.
extern "C" int inv_megakernel_launch(const void* combined, void* out,
                                     const void* parts, const void* bases,
                                     int batch, int bpc, int bpr, int height,
                                     int width, void* ties,
                                     void* stream) {
  if (reinterpret_cast<uintptr_t>(parts) % 16 ||
      reinterpret_cast<uintptr_t>(bases) % 16)
    return cudaErrorMisalignedAddress;
  k9::Plan p;
  const cudaError_t err = k9::plan_of(
      batch, bpc, bpr, height, width,
      static_cast<int>(reinterpret_cast<uintptr_t>(combined) % 16),
      static_cast<int>(reinterpret_cast<uintptr_t>(out) % 16), &p);
  if (err != cudaSuccess) return err;
  if (p.units == 0 || height == 0 || width == 0) return cudaSuccess;
  k9::inv_megakernel<<<static_cast<unsigned>(p.ctas), k9::kThreads, k9::kSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(combined), static_cast<uint8_t*>(out),
      static_cast<const uint16_t*>(parts), static_cast<const float*>(bases),
      static_cast<int>(p.units), p.units_row, bpc, bpr, height, width,
      p.vec_in, p.vec_out, static_cast<unsigned long long*>(ties));
  return cudaGetLastError();
}

// plan[0] units, [1] tiles a unit, [2] units a chunk, [3] chunks, [4]
// resident CTAs, [5] CTAs, [6] threads a CTA,
// [7] ring slots, [8] dynamic shared memory bytes, [9] the input route (1:
// bulk copies), [10] the store route (1: 16-byte vectors).
extern "C" int inv_megakernel_plan(int batch, int bpc, int bpr, int height,
                                   int width, int in_mod16, int out_mod16,
                                   long long* plan) {
  k9::Plan p;
  const cudaError_t err =
      k9::plan_of(batch, bpc, bpr, height, width, in_mod16, out_mod16, &p);
  if (err != cudaSuccess) return err;
  const long long shape[11] = {p.units,     k9::kUnit,    k9::kWarps,
                               p.chunks,    p.resident,   p.ctas,
                               k9::kThreads, k9::kStages, k9::kSmem,
                               p.vec_in,    p.vec_out};
  for (int i = 0; i < 11; ++i) plan[i] = shape[i];
  return cudaSuccess;
}

// K9's registers a thread, shared memory a CTA (static and dynamic) and
// resident CTAs an SM.
extern "C" int inv_megakernel_attributes(int* regs, int* smem, int* ctas) {
  k9::Plan p;
  cudaError_t err = k9::plan_of(0, 0, 0, 0, 0, 0, 0, &p);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, k9::inv_megakernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *smem = static_cast<int>(a.sharedSizeBytes) + k9::kSmem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, k9::inv_megakernel, k9::kThreads, k9::kSmem);
}

extern "C" const char* inv_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
