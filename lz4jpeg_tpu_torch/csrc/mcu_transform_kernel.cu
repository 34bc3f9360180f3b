// Fused MCU transforms for Hopper (sm_90a): the JPEG per-block chain as one
// product against a fused (HW, HW) basis, HW = 64 (8x8 luma) or 32 (8 rows
// of 4: a 4:2:2 chroma block).
//
// mcu_forward: replaces profiles/pallas_mcu.py::_forward_kernel (:36,
// pallas_call :68).  (N, HW) uint8 tiles -> (N, HW) float32 quantized zigzag
// coefficients: ratio = x . M[k] - off[k] with M = forward_basis(...)[0]
// (fused DCT, quantize and zigzag; ops/fused.py), snapped to the nearest
// integer (round half to even, rintf: jnp.round and torch.round) when
// |ratio - nearest| <= snap_eps, then truncated toward zero (truncf).
//
// mcu_inverse: replaces profiles/pallas_mcu.py::_inverse_kernel (:48,
// pallas_call :91).  (N, HW) float32 zigzag coefficients -> (N, HW) uint8
// pixels: p = z . Minv[p] + 128 with Minv = inverse_basis(...), C round
// (half away from zero, computed as copysignf(floorf(fabsf(p) + 0.5f), p);
// roundf differs at 0.49999997f), clamped to [0, 255].
//
// Design.  The product runs exactly on the tensor cores as bf16 parts, by
// mma.sync m16n8k16 (K1's mma_bf16 and ldmatrix_x4, csrc/fwd_megakernel.cuh).
//   Layout.  A warp takes 16 consecutive tiles as the A operand's 16 rows and
//   computes their (16, HW) block: HW/16 k-steps x HW/8 n-tiles a part.  The
//   basis is the B operand, as the three bf16 parts of ops/fwd_megakernel.py::
//   split_basis(M) (forward) or split_basis(Minv) (inverse), whose sum is the
//   fp32 basis exactly.  The wrapper builds their bits once per (table,
//   shape, device); each CTA stages them once in shared memory, rows padded
//   by 16 bytes so that an ldmatrix's eight rows fall in distinct banks
//   (3 x 64 x 72 bf16, 27 KiB at luma), and a warp reads them by ldmatrix.x4
//   for every 16 tiles (the shared-memory pipe's largest load: 24 KiB a warp
//   and part product at luma).  The order of k inside a product is free, so
//   element j of a tile row sits in k slot
//     sigma(j) = 16 v + 2 c + (e & 1) + 8 (e >> 1)
//   of the operand, with (c, v, e) chosen so that lane (g, c) = (lane / 4,
//   lane % 4), which holds rows g and g + 8 at slots 16 v + 2c, +1, +8, +9 of
//   k-step v, reads its part of a tile row in whole vectors: the forward's
//   j = (HW/4) c + 4 v + e, one 16-byte (luma) or 8-byte load of bytes; the
//   inverse's j = 16 v + 4 c + e, the float4 4c + 16v for v = 0 .. HW/16 - 1,
//   loaded in the order v ^ (g & 1) so that rows g and g + 1, which one
//   128-bit load phase pairs, fall in opposite halves of the banks.  The
//   staged basis columns are permuted by the same sigma.
//   Forward.  A is x - 128, exact in bf16 (K1's sample and bf16_pair).  In
//   real numbers (x - 128) . M = x . M - off, because ops/fused.py sets off =
//   128 sum(M), so no offset enters and the sums are as small as K1's; the
//   snap and the truncation follow (the epilogue below).
//   Inverse.  A is each coefficient split in registers into bf16 parts hi,
//   mid and lo by split_basis's rounding (nearest, ties to even; two values
//   a cvt.rn.satfinite.bf16x2 instruction, which also holds hi to bf16's
//   largest finite value), so that z = hi + mid + lo exactly for every
//   finite z with |z| >= 2^-110 (below that the bits under bf16's 2^-133
//   fall away, far under any pixel's rounding).  The products of a part are
//   issued only where a warp vote (__any_sync) finds that part non-zero in
//   the warp's fragment, a warp-uniform branch: integer coefficients |z| <
//   2^8 pay for hi alone (3 products), |z| < 2^16 for hi and mid (6), any
//   other for all nine.  Then + 128, the C round and the clamp.
//   Order of accumulation.  Every part product is exact; the tensor core adds
//   a k-step's 16 products to the accumulator aligned to the largest of them
//   and truncated.  So the products accumulate from the smallest to the
//   largest (the inverse's lo . lo, 2^-32 of the value, first; hi . hi last):
//   the small terms are summed while the running sum is small and keep their
//   bits, and the large ones come last, when only their own truncation is
//   left.  Added largest first, every later small term would be cut to the
//   large sum's last bit.
//   Epilogues.  Full-rate float adds only, no rintf/floorf/truncf or float
//   to int conversion (a quarter of the FP32 rate): x + 2^23 rounded toward
//   zero holds floor(x) in its low bits.  The forward's output is
//   ±floor(|ratio| + snap_eps), bit for bit snap_trunc's value; the
//   inverse's byte clamp(floor(acc + 128.5), 0, 255), c_round's byte away
//   from a round-half tie.
//   Ties.  Where the tensor-core value lies within kTieWindow = 2^-12 of a
//   point where the output steps (the forward's |ratio| + snap_eps at an
//   integer; the inverse's acc + 128.5 where the clamped byte changes), the
//   lane recomputes that output by the fp32 FMA chain over k in index
//   order from 0 (the order of cuBLAS's product on the card, which the
//   plain versions run) from the tile in the ring slot and the fp32 basis
//   row in device memory, before the block is stored.
//   Two fp32 orders round a value within their noise of such a point
//   either way; for the coefficients of 8-bit tiles that noise is below
//   2^-13, so elsewhere every order gives the same output and here the
//   reference's is taken.  About 2^-11 of the outputs (0.05%) take it, so
//   about 40% of the warps' 1,024-output blocks run one chain, on the lanes
//   that need it.
//   Ring.  Persistent CTAs, 3 an SM (the resident count of the occupancy
//   query), of kWarps consumer warps and one producer warp.  One producer
//   lane fills each of kStages slots (3 forward, 2 inverse) with one 1-D
//   cp.async.bulk of a chunk of kChunk = 16 kWarps contiguous tiles, on
//   "full" and "empty" mbarriers (basis_dot's ring, csrc/bulk_ring.cuh); a
//   partial last chunk copies and expects only its own bytes, and its
//   missing rows are computed but never stored.  A warp releases its slot
//   after the tie pass, so the producer runs kStages - 1 chunks ahead.
//   Stores.  Each warp stages its (16, HW) block from the accumulator
//   fragments in its own shared buffer: fp32 rows of HW + 8 floats
//   (forward) or packed u8 rows of 80 (luma) or 48 bytes (inverse), strides
//   at which the fragments' 8- or 2-byte stores and the 16-byte reads hit
//   distinct banks.  Then it writes the block's 16 contiguous output rows
//   as 16-byte vectors, neighbouring lanes on neighbouring addresses, whole
//   128-byte lines each instruction; the last chunk stores only its rows.
//
// What bounds it.  Per tile HW + 4 HW bytes of device memory: at 2,097,152
// luma tiles (the A/B's shape) 671.1 MB, 0.2003 ms at the 3.35 TB/s of an
// H100 SXM's data sheet.  The tensor-core work is 2 HW^2 operations a
// product and tile: the forward's 3 products are 51.5 GFLOP, 0.0521 ms at
// its 989 TFLOP/s dense bf16; the inverse's 3 (integer coefficients under
// 256) to 9 (non-integer ones), 0.0521 to 0.1563 ms.  Bytes bound both
// directions.  What holds the kernels back (PERF.md section 6, the kernel
// timed in turns with its tie test or its products taken out): the ring,
// the operand loads and the staged stores alone run at about 82% (forward)
// and 90% (inverse) of the bound's rate; the inverse's tie test and pass
// cost about a tenth more; with all nine part products, `mma.sync` and the
// B operand's ldmatrix reads (8 KiB a warp, product and 16 tiles at luma)
// bound it.
//
// Resources (ptxas and the occupancy query on an H100, sm_90a; phase 21 of
// chip_smoke.py prints them): registers, shared memory a CTA, CTAs an SM,
// spill stores
//   mcu_forward_kernel<64>  128  58,416 B  3  0 B
//   mcu_forward_kernel<32>   90  24,112 B  4  0 B
//   mcu_inverse_kernel<64>  124  65,568 B  3  0 B
//   mcu_inverse_kernel<32>   72  27,168 B  5  0 B

#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_ring.cuh"
#include "fwd_megakernel.cuh"

namespace {
namespace mcu {

constexpr int kWarps = 4;                     // consumer warps a CTA
constexpr int kThreads = 32 * kWarps + 32;    // and the producer warp
constexpr int kChunk = 16 * kWarps;           // tiles a ring slot
constexpr int kParts = 3;                     // bf16 parts: hi, mid, lo
constexpr float kTieWindow = 1.0f / 4096.0f;  // 2^-12

template <int HW, bool Forward>
struct Shape {
  static constexpr int kStride = HW + 8;   // bf16 a staged basis row
  static constexpr int kPartElems = HW * kStride;
  static constexpr int kInBytes = Forward ? HW : 4 * HW;  // a tile in
  static constexpr int kStages = Forward ? 3 : 2;
  static constexpr int kCtasPerSm = 3;
  static constexpr int kSlotBytes = kChunk * kInBytes;
  // A warp's staged (16, HW) block: fp32 rows of HW + 8 floats, or u8 rows
  // of 80 (luma) or 48 bytes.
  static constexpr int kStageRow =
      Forward ? 4 * (HW + 8) : (HW == 64 ? 80 : 48);
  static constexpr int kStageBytes = 16 * kStageRow;
  static constexpr int kRing = (kParts * kPartElems * 2 + 127) / 128 * 128;
  static constexpr int kStaging = kRing + kStages * kSlotBytes;
  static constexpr int kBarriers = kStaging + kWarps * kStageBytes;
  static constexpr int kSmem = kBarriers + 16 * kStages;
  static_assert(HW == 64 || HW == 32, "luma or 4:2:2 chroma tiles");
  static_assert(kStride * 2 % 16 == 0 && kStageRow % 16 == 0, "16-byte rows");
};

// The three basis parts, (3, HW, HW) bf16 bits in slot order, into the
// padded rows of shared memory, 16 bytes a copy.
template <int HW, bool Forward>
__device__ __forceinline__ void stage_basis(uint16_t* dst,
                                            const uint16_t* __restrict__ src) {
  using S = Shape<HW, Forward>;
  constexpr int kVecs = HW / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < kParts * HW * kVecs; i += kThreads) {
    const int row = i / kVecs;
    reinterpret_cast<uint4*>(dst + row * S::kStride)[i - row * kVecs] =
        reinterpret_cast<const uint4*>(src)[i];
  }
}

// acc += A . part over every k-step and n-tile: the B fragments of n-tiles
// 2p and 2p + 1 of k-step ks by one ldmatrix.x4 (matrices: rows 16p .. + 7
// at k 16ks and 16ks + 8, then rows 16p + 8 .. at the same k).  The loads
// of k-step ks + 1 are issued before the products of ks (the asm statements
// keep their order).
template <int HW>
__device__ __forceinline__ void product(float (&acc)[HW / 8][4],
                                        const uint32_t (&a)[HW / 16][4],
                                        const uint16_t* part, int lane) {
  constexpr int kStride = HW + 8;
  constexpr int kSteps = HW / 16;  // also the n-tile pairs
  const uint16_t* base =
      part + ((lane & 7) + 8 * (lane >> 4)) * kStride + 8 * ((lane >> 3) & 1);
  uint32_t b[2][kSteps][4];
#pragma unroll
  for (int p = 0; p < kSteps; ++p)
    ldmatrix_x4(b[0][p], base + 16 * p * kStride);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    if (ks + 1 < kSteps) {
#pragma unroll
      for (int p = 0; p < kSteps; ++p)
        ldmatrix_x4(b[(ks + 1) & 1][p],
                    base + 16 * p * kStride + 16 * (ks + 1));
    }
#pragma unroll
    for (int p = 0; p < kSteps; ++p) {
      mma_bf16(acc[2 * p], a[ks], b[ks & 1][p][0], b[ks & 1][p][1]);
      mma_bf16(acc[2 * p + 1], a[ks], b[ks & 1][p][2], b[ks & 1][p][3]);
    }
  }
}

// Two floats rounded to bf16 (nearest, ties to even: split_basis's
// rounding; beyond bf16's largest finite value, that value) as one pair, x
// in the low half.
__device__ __forceinline__ uint32_t bf16_round_pair(float x, float y) {
  uint32_t d;
  asm("cvt.rn.satfinite.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(y), "f"(x));
  return d;
}

// x = hi + mid + lo and y likewise, each part a bf16 value, as the pairs
// (x's part, y's part): hi rounds x, mid rounds the rest x - hi (exact in
// fp32), and lo = rest - mid is exact in bf16 (split_basis's argument: 24
// bits, 8 a part).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = bf16_round_pair(x, y);
  const float rx = __fsub_rn(x, __uint_as_float(hi << 16));
  const float ry = __fsub_rn(y, __uint_as_float(hi & 0xFFFF0000u));
  mid = bf16_round_pair(rx, ry);
  const float lx = __fsub_rn(rx, __uint_as_float(mid << 16));
  const float ly = __fsub_rn(ry, __uint_as_float(mid & 0xFFFF0000u));
  lo = __byte_perm(__float_as_uint(lx), __float_as_uint(ly), 0x7632);
}

// The forward's output at a ratio: snap to the nearest integer within
// snap_eps, then truncate (the tie pass's form, the plain version's).
__device__ __forceinline__ float snap_trunc(float ratio, float snap_eps) {
  const float nearest = rintf(ratio);
  if (fabsf(__fsub_rn(ratio, nearest)) <= snap_eps) ratio = nearest;
  return truncf(ratio);
}

__device__ __forceinline__ float c_round(float pix) {
  const float r = copysignf(floorf(__fadd_rn(fabsf(pix), 0.5f)), pix);
  return fminf(fmaxf(r, 0.0f), 255.0f);
}

// The epilogues use full-rate float adds only (rintf, floorf, truncf and
// float -> int conversions run at a quarter of the FP32 rate): for 0 <= x <
// 2^23, x + 2^23 rounded toward zero is 2^23 + floor(x), and its low bits
// are floor(x) as an integer.
constexpr float k23 = 8388608.0f;

// snap_trunc of a forward ratio, the same value bit for bit: the output is
// ±floor(|ratio| + snap_eps) (rintf's nearest lies within snap_eps exactly
// when frac(|ratio|) <= snap_eps, which truncation keeps, or 1 -
// frac(|ratio|) <= snap_eps), and |ratio| + snap_eps rounded toward zero
// has the same floor (an integer below the exact sum is below its rounding
// too).  |ratio| is at most 1024 for 8-bit pixels.  `near`: |ratio| +
// snap_eps within kTieWindow of an integer, where the output steps.
__device__ __forceinline__ float snap_trunc_fast(float ratio, float snap_eps,
                                                 bool& near) {
  const float t = __fadd_rz(fabsf(ratio), snap_eps);
  const float mag = __fsub_rn(__fadd_rz(t, k23), k23);
  near = fabsf(__fsub_rn(__fsub_rn(t, mag), 0.5f)) > 0.5f - kTieWindow;
  return copysignf(mag, ratio);
}

// The inverse's pixel byte of the product sum: v = acc + 128.5 and
// clamp(floor(v), 0, 255), which is c_round(acc + 128)'s byte wherever v
// is not within an ulp or two of an integer (C's round is floor(p + 0.5)
// for p >= 0, and every p < 0 gives 0): inside kTieWindow, where `near` is
// set, the tie pass recomputes the byte in the reference's order; only
// where the step changes the clamped byte (floor(v) in [0, 255]).  The
// clamp acts on the bits of v + 2^23 rounded toward zero as signed ints:
// from v = 0 up they are 2^23's plus floor(v) and order as the floats, and
// every v < 0 gives bits below 2^23's (negative ones below v = -2^23).
// Their difference with 2^23's bits is taken unsigned, for the tie test
// alone: as a signed int it wraps for -2^24 < v < -2^23, to a large
// positive floor.
constexpr int kBits23 = 0x4B000000;  // the bits of k23

__device__ __forceinline__ uint32_t pixel_fast(float acc, bool& near) {
  const float v = __fadd_rn(acc, 128.5f);
  const float shifted = __fadd_rz(v, k23);
  const int bits = __float_as_int(shifted);
  // v - (floor(v) + 0.5), exact: 2^23 - 0.5 is a float, as is floor(v) + 0.5.
  near = fabsf(__fsub_rn(v, __fsub_rn(shifted, k23 - 0.5f))) >
             0.5f - kTieWindow &&
         static_cast<unsigned>(bits) - static_cast<unsigned>(kBits23) <= 255u;
  // kBits23's low byte is 0, so the clamped bits' low byte is the pixel.
  return static_cast<uint32_t>(min(max(bits, kBits23), kBits23 + 255)) & 0xFFu;
}

// The rows of the warp's block that exist: bits 4 nt + 2 h + e of a lane's
// tie mask hold row g + 8h.
__device__ __forceinline__ uint32_t valid_rows(int g, int rows) {
  return (g < rows ? 0x33333333u : 0u) | (g + 8 < rows ? 0xCCCCCCCCu : 0u);
}

// Element i = 4 nt + 2 h + e of a lane's accumulators is acc[nt][2h + e]:
// row g + 8h, column 8 nt + 2c + e of the warp's block.

// The tie pass: each lane recomputes the outputs its tie mask marks by the
// fp32 FMA chain over k in index order from 0, from the block's rows still
// in the ring slot and the fp32 basis row in device memory, into the
// staged block.
template <int HW>
__device__ __forceinline__ void forward_ties(uint32_t ties, const uint8_t* x,
                                             const float* __restrict__ m32,
                                             const float* __restrict__ off,
                                             float* st, float snap_eps,
                                             int lane) {
  const int g = lane >> 2, c = lane & 3;
  while (ties) {
    const int i = __ffs(ties) - 1;
    ties &= ties - 1;
    const int row = g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * c + (i & 1);
    const uint32_t* xr = reinterpret_cast<const uint32_t*>(x + row * HW);
    const float4* mr = reinterpret_cast<const float4*>(m32 + col * HW);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < HW / 4; ++q) {
      const uint32_t w = xr[q];
      const float4 m = __ldg(mr + q);
      acc = fmaf(static_cast<float>(w & 0xFFu), m.x, acc);
      acc = fmaf(static_cast<float>((w >> 8) & 0xFFu), m.y, acc);
      acc = fmaf(static_cast<float>((w >> 16) & 0xFFu), m.z, acc);
      acc = fmaf(static_cast<float>(w >> 24), m.w, acc);
    }
    st[row * (HW + 8) + col] =
        snap_trunc(__fsub_rn(acc, __ldg(off + col)), snap_eps);
  }
}

template <int HW>
__device__ __forceinline__ void inverse_ties(uint32_t ties, const float* z,
                                             const float* __restrict__ m32,
                                             uint8_t* st, int lane) {
  constexpr int kRow = HW == 64 ? 80 : 48;
  const int g = lane >> 2, c = lane & 3;
  while (ties) {
    const int i = __ffs(ties) - 1;
    ties &= ties - 1;
    const int row = g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * c + (i & 1);
    const float4* zr = reinterpret_cast<const float4*>(z + row * HW);
    const float4* mr = reinterpret_cast<const float4*>(m32 + col * HW);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < HW / 4; ++q) {
      const float4 v = zr[q];
      const float4 m = __ldg(mr + q);
      acc = fmaf(v.x, m.x, acc);
      acc = fmaf(v.y, m.y, acc);
      acc = fmaf(v.z, m.z, acc);
      acc = fmaf(v.w, m.w, acc);
    }
    st[row * kRow + col] =
        static_cast<uint8_t>(c_round(__fadd_rn(acc, 128.0f)));
  }
}

// The A operand of the forward: the centred pixels of rows g and g + 8 of
// the warp's 16 at `x` (the ring slot), bytes (HW/4) c .. of each.
template <int HW>
__device__ __forceinline__ void forward_operand(uint32_t (&a)[HW / 16][4],
                                                const uint8_t* x, int lane) {
  const int g = lane >> 2, c = lane & 3;
  uint32_t w0[HW / 16], w1[HW / 16];
  if constexpr (HW == 64) {
    const uint4 r0 = *reinterpret_cast<const uint4*>(x + g * HW + 16 * c);
    const uint4 r1 = *reinterpret_cast<const uint4*>(x + (g + 8) * HW + 16 * c);
    w0[0] = r0.x, w0[1] = r0.y, w0[2] = r0.z, w0[3] = r0.w;
    w1[0] = r1.x, w1[1] = r1.y, w1[2] = r1.z, w1[3] = r1.w;
  } else {
    const uint2 r0 = *reinterpret_cast<const uint2*>(x + g * HW + 8 * c);
    const uint2 r1 = *reinterpret_cast<const uint2*>(x + (g + 8) * HW + 8 * c);
    w0[0] = r0.x, w0[1] = r0.y;
    w1[0] = r1.x, w1[1] = r1.y;
  }
#pragma unroll
  for (int v = 0; v < HW / 16; ++v) {
    a[v][0] = bf16_pair<true>(w0[v] & 0xFFu, (w0[v] >> 8) & 0xFFu);
    a[v][1] = bf16_pair<true>(w1[v] & 0xFFu, (w1[v] >> 8) & 0xFFu);
    a[v][2] = bf16_pair<true>((w0[v] >> 16) & 0xFFu, w0[v] >> 24);
    a[v][3] = bf16_pair<true>((w1[v] >> 16) & 0xFFu, w1[v] >> 24);
  }
}

// One warp's 16 tiles of the forward, from the rows at `x` (the ring
// slot): the products, the epilogue and the tie pass staged at `st` (fp32,
// rows of HW + 8), and the block's `rows` rows stored from `out` (its
// first row) on.
template <int HW>
__device__ __forceinline__ void forward_block(
    const uint8_t* x, const uint16_t* parts, const float* __restrict__ m32,
    const float* __restrict__ off, float* st, float* __restrict__ out,
    int rows, float snap_eps, int lane) {
  constexpr int kPart = HW * (HW + 8);
  constexpr int kRow = HW + 8;
  const int g = lane >> 2, c = lane & 3;
  uint32_t a[HW / 16][4];
  forward_operand<HW>(a, x, lane);
  float acc[HW / 8][4] = {};
  product<HW>(acc, a, parts + 2 * kPart, lane);  // lo
  product<HW>(acc, a, parts + kPart, lane);      // mid
  product<HW>(acc, a, parts, lane);              // hi

  uint32_t ties = 0;
#pragma unroll
  for (int nt = 0; nt < HW / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float q[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool near;
        q[e] = snap_trunc_fast(acc[nt][2 * h + e], snap_eps, near);
        if (near) ties |= 1u << (4 * nt + 2 * h + e);
      }
      *reinterpret_cast<float2*>(st + (g + 8 * h) * kRow + 8 * nt + 2 * c) =
          make_float2(q[0], q[1]);
    }
  }
  forward_ties<HW>(ties & valid_rows(g, rows), x, m32, off, st, snap_eps, lane);
  __syncwarp();
  // 16 rows of HW floats: float4 f = lane + 32 i is row f / (HW/4).
#pragma unroll
  for (int i = 0; i < HW / 8; ++i) {
    const int f = lane + 32 * i;
    const int row = f / (HW / 4), q = f % (HW / 4);
    if (row < rows) {
      *reinterpret_cast<float4*>(out + row * HW + 4 * q) =
          *reinterpret_cast<const float4*>(st + row * kRow + 4 * q);
    }
  }
}

// The A operand of the inverse in its three parts, rows g and g + 8 of the
// warp's 16 coefficient rows at `z` (the ring slot), and the vote: live[p]
// where part p is non-zero (not ±0) somewhere in the warp's fragment.
template <int HW>
__device__ __forceinline__ void inverse_operand(
    uint32_t (&a)[kParts][HW / 16][4], bool (&live)[kParts], const float* z,
    int lane) {
  constexpr int kSteps = HW / 16;
  const int g = lane >> 2, c = lane & 3;
  const bool odd = g & 1;
  uint32_t seen[kParts] = {0u, 0u, 0u};
#pragma unroll
  for (int half = 0; half < 2; ++half) {  // rows g, then g + 8
    const float* zr = z + (g + 8 * half) * HW + 4 * c;
    float4 ld[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u)
      ld[u] = *reinterpret_cast<const float4*>(zr + 16 * (u ^ (odd ? 1 : 0)));
#pragma unroll
    for (int v = 0; v < kSteps; ++v) {
      const float4 f = odd ? ld[v ^ 1] : ld[v];  // the float4 of k-step v
      // slots 2c, 2c + 1, then 2c + 8, 2c + 9
      split_pair(f.x, f.y, a[0][v][half], a[1][v][half], a[2][v][half]);
      split_pair(f.z, f.w, a[0][v][2 + half], a[1][v][2 + half],
                 a[2][v][2 + half]);
#pragma unroll
      for (int p = 0; p < kParts; ++p)
        seen[p] |= a[p][v][half] | a[p][v][2 + half];
    }
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p)
    live[p] = __any_sync(0xFFFFFFFFu, (seen[p] & 0x7FFF7FFFu) != 0u);
}

// One warp's 16 tiles of the inverse, from the rows at `z` (the ring
// slot): the live parts' products, the pixels and the tie pass staged at
// `st` (u8 rows of kStageRow bytes), and the block's rows stored.
template <int HW>
__device__ __forceinline__ void inverse_block(
    const float* z, const uint16_t* parts, const float* __restrict__ m32,
    uint8_t* st, uint8_t* __restrict__ out, int rows, int lane) {
  constexpr int kPart = HW * (HW + 8);
  constexpr int kRow = HW == 64 ? 80 : 48;
  const int g = lane >> 2, c = lane & 3;
  uint32_t a[kParts][HW / 16][4];
  bool live[kParts];
  inverse_operand<HW>(a, live, z, lane);
  float acc[HW / 8][4] = {};
  // Level pa + pb from 4 (lo . lo) down to 0 (hi . hi); a part that the
  // vote found all ±0 adds nothing, and its products are not issued.
#pragma unroll
  for (int level = 2 * (kParts - 1); level >= 0; --level) {
#pragma unroll
    for (int pa = kParts - 1; pa >= 0; --pa) {
      const int pb = level - pa;
      if (pb < 0 || pb >= kParts) continue;
      if (live[pa]) product<HW>(acc, a[pa], parts + pb * kPart, lane);
    }
  }

  uint32_t ties = 0;
#pragma unroll
  for (int nt = 0; nt < HW / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t px[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bool near;
        px[e] = pixel_fast(acc[nt][2 * h + e], near);
        if (near) ties |= 1u << (4 * nt + 2 * h + e);
      }
      *reinterpret_cast<uint16_t*>(st + (g + 8 * h) * kRow + 8 * nt + 2 * c) =
          static_cast<uint16_t>(px[0] | (px[1] << 8));
    }
  }
  inverse_ties<HW>(ties & valid_rows(g, rows), z, m32, st, lane);
  __syncwarp();
  // 16 rows of HW bytes as 16-byte vectors: a 128-bit phase of 8 lanes reads
  // rows whose staged bytes sit in opposite bank halves (luma rows r, r + 4;
  // chroma rows r, r + 2, r + 4, r + 6), and each instruction writes 8
  // (luma) or 16 (chroma) whole rows.
#pragma unroll
  for (int i = 0; i < HW / 32; ++i) {
    const int row = HW == 64
        ? (lane >> 3) + 4 * ((lane >> 2) & 1) + 8 * i
        : ((lane >> 3) & 1) + 2 * ((lane >> 1) & 3) + 8 * (lane >> 4);
    const int q = HW == 64 ? lane & 3 : lane & 1;
    if (row < rows) {
      *reinterpret_cast<uint4*>(out + row * HW + 16 * q) =
          *reinterpret_cast<const uint4*>(st + row * kRow + 16 * q);
    }
  }
}

// The kernel body: the producer lane fills the ring, the consumer warps
// take 16 tiles of each chunk.  `in` is (n, HW) u8 (forward) or f32
// (inverse); `parts` the (3, HW, HW) bf16 bits in slot order; `m32` the fp32
// basis row-major and `off` the forward's offsets (the tie pass's
// operands); `snap_eps` the forward's.
template <int HW, bool Forward>
__device__ __forceinline__ void run(const void* __restrict__ in,
                                    const uint16_t* __restrict__ parts,
                                    const float* __restrict__ m32,
                                    const float* __restrict__ off,
                                    void* __restrict__ out, long long n,
                                    float snap_eps) {
  using S = Shape<HW, Forward>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* basis = reinterpret_cast<uint16_t*>(smem);
  unsigned char* ring = smem + S::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBarriers);
  uint64_t* empty = full + S::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stage_basis<HW, Forward>(basis, parts);
  __syncthreads();
  const long long chunks = (n + kChunk - 1) / kChunk;

  if (warp == kWarps) {  // the producer warp: one lane fills the ring
    if (lane != 0) return;
    const unsigned char* src = static_cast<const unsigned char*>(in);
    int i = 0;
    for (long long chunk = blockIdx.x; chunk < chunks;
         chunk += gridDim.x, ++i) {
      const int s = i % S::kStages;
      mbar_wait(&empty[s], ((i / S::kStages) & 1) ^ 1);
      const long long t0 = chunk * kChunk;
      const int rows = n - t0 < kChunk ? static_cast<int>(n - t0) : kChunk;
      const uint32_t bytes = static_cast<uint32_t>(rows) * S::kInBytes;
      mbar_expect_tx(&full[s], bytes);
      bulk_load(ring + s * S::kSlotBytes, src + t0 * S::kInBytes, bytes,
                &full[s]);
    }
    return;
  }

  unsigned char* st = smem + S::kStaging + warp * S::kStageBytes;
  int i = 0;
  for (long long chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x, ++i) {
    const int s = i % S::kStages;
    mbar_wait(&full[s], (i / S::kStages) & 1);
    const long long tile0 = chunk * kChunk + 16 * warp;
    const int rows = n - tile0 < 16 ? static_cast<int>(n - tile0) : 16;
    if (rows > 0) {
      const unsigned char* slot =
          ring + s * S::kSlotBytes + 16 * warp * S::kInBytes;
      if constexpr (Forward) {
        forward_block<HW>(slot, basis, m32, off, reinterpret_cast<float*>(st),
                          static_cast<float*>(out) + tile0 * HW, rows,
                          snap_eps, lane);
      } else {
        inverse_block<HW>(reinterpret_cast<const float*>(slot), basis, m32, st,
                          static_cast<uint8_t*>(out) + tile0 * HW, rows, lane);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the slot's reads are done
  }
}

template <int HW>
__global__ void __launch_bounds__(kThreads, Shape<HW, true>::kCtasPerSm)
    mcu_forward_kernel(const uint8_t* __restrict__ tiles,
                       const uint16_t* __restrict__ parts,
                       const float* __restrict__ basis,
                       const float* __restrict__ offset,
                       float* __restrict__ out, long long n, float snap_eps) {
  run<HW, true>(tiles, parts, basis, offset, out, n, snap_eps);
}

template <int HW>
__global__ void __launch_bounds__(kThreads, Shape<HW, false>::kCtasPerSm)
    mcu_inverse_kernel(const float* __restrict__ zz,
                       const uint16_t* __restrict__ parts,
                       const float* __restrict__ basis,
                       uint8_t* __restrict__ out, long long n) {
  run<HW, false>(zz, parts, basis, nullptr, out, n, 0.0f);
}

// The kernel of (direction, HW) as a function pointer, with its Shape's
// dynamic shared memory; nullptr for another HW.
const void* kernel_of(bool forward, int hw, int* smem) {
  if (forward && hw == 64) {
    *smem = Shape<64, true>::kSmem;
    return reinterpret_cast<const void*>(mcu_forward_kernel<64>);
  }
  if (forward && hw == 32) {
    *smem = Shape<32, true>::kSmem;
    return reinterpret_cast<const void*>(mcu_forward_kernel<32>);
  }
  if (!forward && hw == 64) {
    *smem = Shape<64, false>::kSmem;
    return reinterpret_cast<const void*>(mcu_inverse_kernel<64>);
  }
  if (!forward && hw == 32) {
    *smem = Shape<32, false>::kSmem;
    return reinterpret_cast<const void*>(mcu_inverse_kernel<32>);
  }
  return nullptr;
}

int stages_of(bool forward) {
  return forward ? Shape<64, true>::kStages : Shape<64, false>::kStages;
}

struct Plan {
  long long chunks, resident, ctas;
  int per_sm, smem;
};

// The persistent grid for n tiles: every resident CTA (the occupancy query
// at the kernel's dynamic shared memory), at most one a chunk.  A failed
// attribute call or query is returned, not guessed around.
cudaError_t plan_of(bool forward, int hw, long long n, Plan* p) {
  int smem = 0;
  const void* fn = kernel_of(forward, hw, &smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p->chunks = (n + kChunk - 1) / kChunk;
  p->resident = static_cast<long long>(sms) * per_sm;
  p->ctas = p->chunks < p->resident ? p->chunks : p->resident;
  p->per_sm = per_sm;
  p->smem = smem;
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace mcu
}  // namespace

// tiles: (n, hw) uint8; parts: (3, hw, hw) bf16 bits of split_basis(M) with
// columns in slot order (profiles/mcu.py::device_parts); basis: (hw, hw)
// float32 M, row k the basis of output k; offset: (hw,) float32; out: (n,
// hw) float32; all contiguous, tiles, parts and out 16-byte aligned.
// Launches on `stream` and returns the first CUDA error of the attribute
// call, the queries or the launch (0 on success); never synchronises.
extern "C" int mcu_forward_launch(const void* tiles, const void* parts,
                                  const void* basis, const void* offset,
                                  void* out, long long n, int hw,
                                  float snap_eps, void* stream) {
  if ((hw != 64 && hw != 32) || n < 0) return cudaErrorInvalidValue;
  if (!mcu::aligned(tiles, 16) || !mcu::aligned(parts, 16) ||
      !mcu::aligned(out, 16) || !mcu::aligned(basis, 4) ||
      !mcu::aligned(offset, 4))
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  mcu::Plan p;
  const cudaError_t err = mcu::plan_of(true, hw, n, &p);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const uint8_t*>(tiles);
  const auto* b = static_cast<const uint16_t*>(parts);
  const auto* m = static_cast<const float*>(basis);
  const auto* o = static_cast<const float*>(offset);
  auto* y = static_cast<float*>(out);
  const unsigned grid = static_cast<unsigned>(p.ctas);
  if (hw == 64)
    mcu::mcu_forward_kernel<64><<<grid, mcu::kThreads, p.smem, s>>>(
        x, b, m, o, y, n, snap_eps);
  else
    mcu::mcu_forward_kernel<32><<<grid, mcu::kThreads, p.smem, s>>>(
        x, b, m, o, y, n, snap_eps);
  return cudaGetLastError();
}

// zz: (n, hw) float32; parts: (3, hw, hw) bf16 bits of split_basis(Minv) in
// slot order; basis: (hw, hw) float32 Minv, row p the basis of pixel p; out:
// (n, hw) uint8; all contiguous, zz, parts and out 16-byte aligned.
extern "C" int mcu_inverse_launch(const void* zz, const void* parts,
                                  const void* basis, void* out, long long n,
                                  int hw, void* stream) {
  if ((hw != 64 && hw != 32) || n < 0) return cudaErrorInvalidValue;
  if (!mcu::aligned(zz, 16) || !mcu::aligned(parts, 16) ||
      !mcu::aligned(out, 16) || !mcu::aligned(basis, 4))
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  mcu::Plan p;
  const cudaError_t err = mcu::plan_of(false, hw, n, &p);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* z = static_cast<const float*>(zz);
  const auto* b = static_cast<const uint16_t*>(parts);
  const auto* m = static_cast<const float*>(basis);
  auto* y = static_cast<uint8_t*>(out);
  const unsigned grid = static_cast<unsigned>(p.ctas);
  if (hw == 64)
    mcu::mcu_inverse_kernel<64><<<grid, mcu::kThreads, p.smem, s>>>(
        z, b, m, y, n);
  else
    mcu::mcu_inverse_kernel<32><<<grid, mcu::kThreads, p.smem, s>>>(
        z, b, m, y, n);
  return cudaGetLastError();
}

// The launch of (forward, hw) for n >= 0 tiles: plan[0] chunks, [1] resident
// CTAs, [2] CTAs, [3] tiles a chunk, [4] ring slots, [5] threads a CTA (the
// last warp the producer), [6] dynamic shared memory bytes.  Returns the
// first CUDA error of the queries, cudaErrorInvalidValue for another hw or
// n < 0.
extern "C" int mcu_plan(int forward, int hw, long long n, long long* plan) {
  if (n < 0) return cudaErrorInvalidValue;
  mcu::Plan p;
  const cudaError_t err = mcu::plan_of(forward != 0, hw, n, &p);
  if (err != cudaSuccess) return err;
  const long long shape[7] = {p.chunks, p.resident, p.ctas, mcu::kChunk,
                              mcu::stages_of(forward != 0), mcu::kThreads,
                              p.smem};
  for (int i = 0; i < 7; ++i) plan[i] = shape[i];
  return cudaSuccess;
}

// Registers a thread, shared memory a CTA (static + dynamic) and resident
// CTAs an SM of the (forward, hw) kernel.
extern "C" int mcu_attributes(int forward, int hw, int* regs, int* smem,
                              int* ctas) {
  mcu::Plan p;
  cudaError_t err = mcu::plan_of(forward != 0, hw, 0, &p);
  if (err != cudaSuccess) return err;
  int dynamic = 0;
  const void* fn = mcu::kernel_of(forward != 0, hw, &dynamic);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes) + dynamic;
  *ctas = p.per_sm;
  return cudaSuccess;
}

extern "C" const char* mcu_transform_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
