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
//   1. delta = (w != 0) ? w - 1024 : 0 in int32, then fp32 (exact for any
//      int16 word);
//   2. Y[8u + v] = sum_m delta_m · S_lum[8u + v, m] over 64 terms; Cr and Cb
//      4 samples a row (c = v / 2) over 32 terms each: fp32 FMA in m order;
//   3. + 128.0f, then the plain version's round op for op: sign(x) ·
//      floor(|x| + 0.5f), clamped to [0, 255] (not roundf, which differs
//      where |x| + 0.5 rounds up in fp32);
//   4. the colour merge of csrc/color_merge.cuh (P-color's arithmetic);
//   5. only pixels with row < height and col < width are stored.
// Against the plain version (cuBLAS's summation order) a plane value may
// round the other way only where it lies within the fp32 error of two
// summation orders of a half-integer (utils/parity.py::decode_flips).
//
// What bounds it.  A tile reads 256 B and writes at most 192 B of RGB: at
// 2048² b64 1,073,741,824 B in and 805,306,368 B out, 0.5609 ms at the 3.35
// TB/s of an H100 SXM's data sheet.  The product is 64·64 + 2·32·32 = 6,144
// FMA a tile, 25.77 G at b64: 0.770 ms at 132 SMs × 128 lanes × 1.98 GHz.
// This design issues every FMA (zero deltas are not skipped), so it cannot
// pass 0.770 ms; with a 16-byte shared load for every 4 FMA and the
// epilogue its issue floor is near 1.2 ms.
//
// Design.
// - Persistent CTAs of 8 warps walk over units of up to 32 tiles of one
//   block row (frames × block rows × ceil(bpr / 32) units); CTA c takes
//   units c, c + grid, ...
// - The bases (24 KiB: luma (64, 64), Cr and Cb (32, 32), fp32) are staged
//   once a CTA, transposed so that one term's outputs of a pixel row are
//   two (luma) or one (chroma) 16-byte words, read by a warp as broadcasts.
// - A unit's 32 × 256 B are loaded as 16-byte vectors, two a thread, into
//   registers one unit ahead, then un-biased into shared memory as fp32
//   rows of 132 floats (128 + 4, so that the 16-byte loads of a quarter
//   warp, 8 tiles, fall in distinct banks).  An input base off 16 bytes
//   takes the word-wise load route, with no prefetch.
// - Warp u computes pixel row u of the unit, lane i tile i: 8 Y and 4 + 4
//   chroma accumulators, 768 FMA, then 24 bytes of RGB into the warp's
//   768-byte staging row (three 8-byte stores, conflict-free); then the
//   warp stores the row's valid bytes, as 16-byte vectors when the output
//   base and the row stride W·3 are 16-byte aligned (a unit starts at a
//   multiple of 768 bytes), a byte a lane otherwise.  A warp whose row lies
//   past the image computes nothing.
// - 64-bit offsets: b256 at 2048² reads 4.29 GB and writes 3.2 GB.
// Two CTA barriers a unit; 47,616 B of static shared memory, 3 CTAs an SM
// at up to 80 registers a thread (no spills; at 4 CTAs an SM, 64 registers,
// ptxas spills), so one CTA's stores and barriers overlap the others' FMA.

#include <cstdint>

#include <cuda_runtime.h>

#include "color_merge.cuh"

namespace {

using color_merge::clamp255;

constexpr int kBand = 32;             // tiles a unit: a lane each
constexpr int kWarps = 8;             // a warp a pixel row of the unit
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 128;           // int16 words a tile
constexpr int kStride = kLanes + 4;   // floats a staged tile
constexpr int kRowBytes = 24 * kBand;  // RGB bytes of one pixel row of a unit
constexpr int kLumTerms = 64;
constexpr int kChrTerms = 32;
constexpr int kBias = 1024;           // ops/rle.py::SPARSE16_DELTA_BIAS
constexpr int kVecs = kBand * kLanes * 2 / 16 / kThreads;  // 16 B loads a thread
constexpr int kMinCtasPerSm = 3;
constexpr int kBasisFloats = kLumTerms * kLumTerms + 2 * kChrTerms * kChrTerms;

struct Shared {
  float lum[8 * kLumTerms * 8];   // [u][m][v] = S_lum[8u + v][m]
  float cr[8 * kChrTerms * 4];    // [u][m][c] = S_cr[4u + c][m]
  float cb[8 * kChrTerms * 4];
  float delta[kBand * kStride];   // [tile][lane], un-biased fp32
  uint8_t stage[kWarps][kRowBytes];
};

struct Unit {
  int64_t tile0;  // the unit's first tile in the buffer
  int ntiles;     // tiles in the unit (kBand but in a row's last unit)
  int frame, block_row, col0;  // col0: the unit's first block column
};

__device__ __forceinline__ Unit unit_of(int unit, int units_row, int bpc,
                                        int bpr) {
  const int fr = unit / units_row;  // frame · bpc + block row
  Unit g;
  g.col0 = (unit - fr * units_row) * kBand;
  g.ntiles = min(kBand, bpr - g.col0);
  g.tile0 = static_cast<int64_t>(fr) * bpr + g.col0;
  g.frame = fr / bpc;
  g.block_row = fr - g.frame * bpc;
  return g;
}

__device__ __forceinline__ float unbias(int w) {
  return static_cast<float>(w != 0 ? w - kBias : 0);
}

// Thread tid's kVecs 16-byte pieces of the unit (zeros past its tiles).
__device__ __forceinline__ void load_unit(const int16_t* in, const Unit& g,
                                          int tid, uint4 (&raw)[kVecs]) {
  const uint4* src = reinterpret_cast<const uint4*>(in + g.tile0 * kLanes);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int q = tid + k * kThreads;  // piece q: tile q / 16, words 8 (q % 16)
    raw[k] = (q >> 4) < g.ntiles ? __ldcs(src + q) : make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ float lo16(uint32_t x) {
  return unbias(static_cast<int16_t>(x & 0xffffu));
}

__device__ __forceinline__ float hi16(uint32_t x) {
  return unbias(static_cast<int16_t>(x >> 16));
}

__device__ __forceinline__ void stage_unit(const uint4 (&raw)[kVecs],
                                           float* delta, int tid) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int q = tid + k * kThreads;
    float* row = delta + (q >> 4) * kStride + (q & 15) * 8;
    const uint4 r = raw[k];
    *reinterpret_cast<float4*>(row) =
        make_float4(lo16(r.x), hi16(r.x), lo16(r.y), hi16(r.y));
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(lo16(r.z), hi16(r.z), lo16(r.w), hi16(r.w));
  }
}

// The word-wise route, for an input base off 16 bytes.
__device__ __forceinline__ void load_words(const int16_t* in, const Unit& g,
                                           int tid, float* delta) {
  const int16_t* src = in + g.tile0 * kLanes;
  for (int q = tid; q < kBand * kLanes; q += kThreads) {
    const int t = q / kLanes;
    delta[t * kStride + q % kLanes] = t < g.ntiles ? unbias(__ldcs(src + q))
                                                   : 0.0f;
  }
}

// The plain version's + 128, round and clamp: sign(x) · floor(|x| + 0.5f)
// clamped to [0, 255]; every x <= 0 rounds to a value <= 0, so to 0.
__device__ __forceinline__ int pixel(float acc) {
  const float x = __fadd_rn(acc, 128.0f);
  return x > 0.0f
             ? static_cast<int>(fminf(floorf(__fadd_rn(x, 0.5f)), 255.0f))
             : 0;
}

// Warp `u`'s pixel row of the unit: lane i computes tile i's 8 pixels,
// stages their 24 bytes and the warp stores the row's valid bytes.
__device__ __forceinline__ void unit_row(Shared& sh, const Unit& g, int u,
                                         int lane, uint8_t* out, int height,
                                         int width, bool vec_out) {
  const int row = 8 * g.block_row + u;
  const int cols = min(8 * g.ntiles, width - 8 * g.col0);
  if (row >= height || cols <= 0) return;
  const float* d = sh.delta + lane * kStride;
  float y[8] = {}, r[4] = {}, b[4] = {};
  const float4* sl = reinterpret_cast<const float4*>(sh.lum + u * kLumTerms * 8);
#pragma unroll 4
  for (int m = 0; m < kLumTerms; m += 4) {
    const float4 dv = *reinterpret_cast<const float4*>(d + m);
    const float dd[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 s0 = sl[2 * (m + j)];
      const float4 s1 = sl[2 * (m + j) + 1];
      y[0] = fmaf(dd[j], s0.x, y[0]);
      y[1] = fmaf(dd[j], s0.y, y[1]);
      y[2] = fmaf(dd[j], s0.z, y[2]);
      y[3] = fmaf(dd[j], s0.w, y[3]);
      y[4] = fmaf(dd[j], s1.x, y[4]);
      y[5] = fmaf(dd[j], s1.y, y[5]);
      y[6] = fmaf(dd[j], s1.z, y[6]);
      y[7] = fmaf(dd[j], s1.w, y[7]);
    }
  }
  const float4* sr = reinterpret_cast<const float4*>(sh.cr + u * kChrTerms * 4);
  const float4* sb = reinterpret_cast<const float4*>(sh.cb + u * kChrTerms * 4);
#pragma unroll 2
  for (int m = 0; m < kChrTerms; m += 4) {
    const float4 rv = *reinterpret_cast<const float4*>(d + kLumTerms + m);
    const float4 bv =
        *reinterpret_cast<const float4*>(d + kLumTerms + kChrTerms + m);
    const float dr[4] = {rv.x, rv.y, rv.z, rv.w};
    const float db[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 s = sr[m + j];
      const float4 t = sb[m + j];
      r[0] = fmaf(dr[j], s.x, r[0]);
      r[1] = fmaf(dr[j], s.y, r[1]);
      r[2] = fmaf(dr[j], s.z, r[2]);
      r[3] = fmaf(dr[j], s.w, r[3]);
      b[0] = fmaf(db[j], t.x, b[0]);
      b[1] = fmaf(db[j], t.y, b[1]);
      b[2] = fmaf(db[j], t.z, b[2]);
      b[3] = fmaf(db[j], t.w, b[3]);
    }
  }
  uint32_t w[6] = {};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const color_merge::Terms t = color_merge::terms(
        static_cast<uint32_t>(pixel(r[c])), static_cast<uint32_t>(pixel(b[c])));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = 2 * c + e;
      const int yy = pixel(y[v]);
      const uint32_t px[3] = {clamp255(yy + t.cr), clamp255(yy - t.g),
                              clamp255(yy + t.cb)};
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int k = 3 * v + ch;
        w[k / 4] |= px[ch] << (8 * (k % 4));
      }
    }
  }
  uint8_t* srow = sh.stage[u];
  uint2* st = reinterpret_cast<uint2*>(srow + 24 * lane);
  st[0] = make_uint2(w[0], w[1]);
  st[1] = make_uint2(w[2], w[3]);
  st[2] = make_uint2(w[4], w[5]);
  __syncwarp();
  const int count = 3 * cols;
  uint8_t* dst =
      out + ((static_cast<int64_t>(g.frame) * height + row) * width +
             8 * static_cast<int64_t>(g.col0)) * 3;
  int k0 = 0;
  if (vec_out) {
    const int n_vec = count / 16;
    for (int k = lane; k < n_vec; k += 32)
      __stcs(reinterpret_cast<uint4*>(dst) + k,
             reinterpret_cast<const uint4*>(srow)[k]);
    k0 = 16 * n_vec;
  }
  for (int k = k0 + lane; k < count; k += 32) dst[k] = srow[k];
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, kMinCtasPerSm)
    inv_megakernel(const int16_t* __restrict__ in, uint8_t* __restrict__ out,
                   const float* __restrict__ bases, int n_units,
                   int units_row, int bpc, int bpr, int height, int width,
                   int vec_in, int vec_out) {
  __shared__ __align__(16) Shared sh;
  const int tid = threadIdx.x;
  for (int i = tid; i < kLumTerms * kLumTerms; i += kThreads) {
    const int p = i / kLumTerms, m = i % kLumTerms;  // p = 8u + v
    sh.lum[((p / 8) * kLumTerms + m) * 8 + p % 8] = bases[i];
  }
  for (int i = tid; i < kChrTerms * kChrTerms; i += kThreads) {
    const int p = i / kChrTerms, m = i % kChrTerms;  // p = 4u + c
    const int at = ((p / 4) * kChrTerms + m) * 4 + p % 4;
    sh.cr[at] = bases[kLumTerms * kLumTerms + i];
    sh.cb[at] = bases[kLumTerms * kLumTerms + kChrTerms * kChrTerms + i];
  }
  uint4 raw[kVecs];
  int unit = blockIdx.x;
  if (vec_in && unit < n_units)
    load_unit(in, unit_of(unit, units_row, bpc, bpr), tid, raw);
  for (; unit < n_units; unit += gridDim.x) {
    const Unit g = unit_of(unit, units_row, bpc, bpr);
    __syncthreads();  // the bases are staged; the last unit's deltas read
    if (vec_in)
      stage_unit(raw, sh.delta, tid);
    else
      load_words(in, g, tid, sh.delta);
    __syncthreads();
    if (vec_in && unit + static_cast<int>(gridDim.x) < n_units)
      load_unit(in, unit_of(unit + gridDim.x, units_row, bpc, bpr), tid, raw);
    unit_row(sh, g, tid / 32, tid % 32, out, height, width, vec_out != 0);
  }
}

struct Plan {
  long long units, resident, ctas;
  int units_row;
  bool vec_in, vec_out;
};

// The launch of a (batch, bpc · bpr, 128) buffer into (batch, height,
// width, 3) RGB, its input and output bases at these residues mod 16.
cudaError_t plan_of(int batch, int bpc, int bpr, int height, int width,
                    int in_mod16, int out_mod16, Plan* p) {
  if (batch < 0 || bpc < 0 || bpr < 0 || height < 0 || width < 0 ||
      height > 8LL * bpc || width > 8LL * bpr || 24LL * bpr > INT32_MAX)
    return cudaErrorInvalidValue;
  p->units_row = (bpr + kBand - 1) / kBand;
  p->units = static_cast<long long>(batch) * bpc * p->units_row;
  // A unit index and a frame-row index are 32-bit: 2^31 units of 8 KiB
  // are far more than a card holds.
  if (p->units > INT32_MAX) return cudaErrorInvalidValue;
  p->vec_in = in_mod16 == 0;
  p->vec_out = out_mod16 == 0 && (3LL * width) % 16 == 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inv_megakernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  p->resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  p->ctas = p->units < p->resident ? p->units : p->resident;
  return cudaSuccess;
}

}  // namespace

// combined: (batch, bpc · bpr, 128) int16, contiguous; out: (batch, height,
// width, 3) uint8, contiguous; bases: 6,144 fp32 (luma (64, 64), Cr (32,
// 32), Cb (32, 32), each [pixel][term]).  Launches on `stream` and returns
// the first CUDA error of the queries or the launch (0 on success;
// cudaErrorInvalidValue for a shape it does not take); never synchronises.
extern "C" int inv_megakernel_launch(const void* combined, void* out,
                                     const void* bases, int batch, int bpc,
                                     int bpr, int height, int width,
                                     void* stream) {
  Plan p;
  const cudaError_t err = plan_of(
      batch, bpc, bpr, height, width,
      static_cast<int>(reinterpret_cast<uintptr_t>(combined) % 16),
      static_cast<int>(reinterpret_cast<uintptr_t>(out) % 16), &p);
  if (err != cudaSuccess) return err;
  if (p.units == 0 || height == 0 || width == 0) return cudaSuccess;
  inv_megakernel<<<static_cast<unsigned>(p.ctas), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(combined), static_cast<uint8_t*>(out),
      static_cast<const float*>(bases), static_cast<int>(p.units), p.units_row,
      bpc, bpr, height, width, p.vec_in, p.vec_out);
  return cudaGetLastError();
}

// plan[0] units, [1] tiles a unit, [2] resident CTAs, [3] CTAs, [4] threads
// a CTA, [5] the input load route (1: 16-byte vectors), [6] the store route
// (1: 16-byte vectors), [7] basis floats.
extern "C" int inv_megakernel_plan(int batch, int bpc, int bpr, int height,
                                   int width, int in_mod16, int out_mod16,
                                   long long* plan) {
  Plan p;
  const cudaError_t err =
      plan_of(batch, bpc, bpr, height, width, in_mod16, out_mod16, &p);
  if (err != cudaSuccess) return err;
  const long long shape[8] = {p.units, kBand, p.resident, p.ctas, kThreads,
                              p.vec_in, p.vec_out, kBasisFloats};
  for (int i = 0; i < 8; ++i) plan[i] = shape[i];
  return cudaSuccess;
}

// K9's registers a thread, static shared memory a CTA and resident CTAs an
// SM.
extern "C" int inv_megakernel_attributes(int* regs, int* smem, int* ctas) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, inv_megakernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *smem = static_cast<int>(a.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, inv_megakernel,
                                                       kThreads, 0);
}

extern "C" const char* inv_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
