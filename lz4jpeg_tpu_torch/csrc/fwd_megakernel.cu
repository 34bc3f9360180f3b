// Forward megakernel for Hopper (sm_90a): RGB uint8 image → the (N, 128)
// int16 combined sparse-delta streams of the JPEG fast path, in one pass.
//
// Replaces lz4jpeg_tpu/ops/pallas_fwd.py::_fwd_kernel, the Pallas TPU kernel
// (fed by rgb_to_kt).  Per 8x8 MCU it computes what that kernel computes:
//   1. YCbCr with the reference's truncation (snap-trunc, eps 1e-4; Cr and Cb
//      +128 then clamped to [0, 255]);
//   2. DCT + quantize + zigzag as one f32 basis product per channel: lane k
//      of the 128 output lanes is my[k]·Y (k < 64), mc64[k-64]·Cr (64 ≤ k <
//      96) or mc64[k-96]·Cb (k ≥ 96), minus offs[k], snap-trunc eps 1e-5.
//      mc64 has the 4:2:2 odd-column pick folded in (chroma sample (r, c')
//      reads tile column 2c'+1), so no subsample step exists;
//   3. the sparse-delta epilogue (ops/rle.py::rle_encode_sparse16) with
//      segments starting at lanes 0, 64 and 96.
//
// Layout.  The TPU kernel needed the "kt" relayout and N padded to 2048
// only because Mosaic cannot lower lane-split reshapes.  Here a CTA reads
// its 8x8x3 tiles straight from the contiguous (B, H, W, 3) image and writes
// rows of (frames, block rows, block columns) order, as the JAX package
// does.  Ragged images: a pixel with row >= H or col >= W is Y = Cr = Cb = 0
// AFTER the color transform (split_mcus's plane-domain padding; padding the
// RGB instead would give chroma 128).  With the pick folded into mc64, a
// chroma sample is valid exactly when its column 2c'+1 < W, so one test
// covers odd widths too.
//
// What bounds it.  About 7 B/px of traffic (3 B read, 4 B written) against
// 128 f32 FMA/px, so CUDA-core FMA throughput and memory are about even on
// an H100.  Design: 128 threads per CTA, one per output lane; each thread
// keeps its 64-entry basis row in registers (loaded once per CTA); the CTA
// loops over groups of kMcus MCUs, staging the color-converted tiles in
// shared memory where a warp reads them as broadcasts (a warp's lanes all
// belong to one channel).  The previous lane's value for the delta comes
// through shared memory, not a warp shuffle: the k=32 → 31 step crosses a
// warp.  Stores are one coalesced 256 B row per MCU.  Full IEEE f32 with
// the products summed in j order by FMA; no TF32, no tensor cores.  wgmma/
// TMA and an exact split-precision product are left to later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;  // 64 Y + 32 Cr + 32 Cb lanes per MCU
constexpr int kTerms = 64;   // pixels of one 8x8 tile
constexpr int kMcus = 8;     // MCUs per CTA iteration
constexpr int kBias = 1024;  // SPARSE16_DELTA_BIAS

__device__ __forceinline__ float snap_trunc(float x, float eps) {
  const float nearest = rintf(x);  // half to even, like torch.round
  return truncf(fabsf(x - nearest) <= eps ? nearest : x);
}

__global__ void __launch_bounds__(kLanes)
    fwd_megakernel(const uint8_t* __restrict__ rgb, int16_t* __restrict__ out,
                   const float* __restrict__ basis,
                   const float* __restrict__ offs, int64_t n_blocks,
                   int height, int width, int bpc, int bpr) {
  __shared__ __align__(16) float planes[3][kMcus][kTerms];
  __shared__ int q[kMcus][kLanes];

  const int k = threadIdx.x;
  float m[kTerms];
#pragma unroll
  for (int j = 0; j < kTerms; ++j) m[j] = basis[k * kTerms + j];
  const float off = offs[k];
  const int ch = k < 64 ? 0 : (k < 96 ? 1 : 2);
  const bool seg_first = k == 0 || k == 64 || k == 96;
  const int64_t per_frame = static_cast<int64_t>(bpc) * bpr;

  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kMcus;
       base < n_blocks; base += static_cast<int64_t>(gridDim.x) * kMcus) {
    // Load + color.  Pixel i is (tile row r, MCU, tile column c), so a warp
    // reads 32 neighbouring pixels of one image row when its MCUs are
    // neighbours in a block row.
    for (int i = k; i < kMcus * kTerms; i += kLanes) {
      const int r = i / (kMcus * 8);
      const int mcu = (i / 8) % kMcus;
      const int c = i % 8;
      const int64_t n = base + mcu;
      float y = 0.f, cr = 0.f, cb = 0.f;
      if (n < n_blocks) {
        const int64_t f = n / per_frame;
        const int64_t t = n - f * per_frame;
        const int row = static_cast<int>(t / bpr) * 8 + r;
        const int col = static_cast<int>(t % bpr) * 8 + c;
        if (row < height && col < width) {
          const uint8_t* p = rgb + ((f * height + row) * width + col) * 3;
          const float R = p[0], G = p[1], B = p[2];
          y = snap_trunc(0.299f * R + 0.587f * G + 0.114f * B, 1e-4f);
          cr = fminf(fmaxf(snap_trunc(0.439f * R - 0.368f * G - 0.071f * B
                                          + 128.f, 1e-4f), 0.f), 255.f);
          cb = fminf(fmaxf(snap_trunc(-0.148f * R - 0.291f * G + 0.439f * B
                                          + 128.f, 1e-4f), 0.f), 255.f);
        }
      }
      planes[0][mcu][r * 8 + c] = y;
      planes[1][mcu][r * 8 + c] = cr;
      planes[2][mcu][r * 8 + c] = cb;
    }
    __syncthreads();

    // Basis product: one lane per thread, 64 FMAs in j order.
#pragma unroll 1
    for (int mcu = 0; mcu < kMcus; ++mcu) {
      const float4* x4 = reinterpret_cast<const float4*>(planes[ch][mcu]);
      float acc = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kTerms / 4; ++j4) {
        const float4 x = x4[j4];
        acc = fmaf(x.x, m[4 * j4 + 0], acc);
        acc = fmaf(x.y, m[4 * j4 + 1], acc);
        acc = fmaf(x.z, m[4 * j4 + 2], acc);
        acc = fmaf(x.w, m[4 * j4 + 3], acc);
      }
      q[mcu][k] = static_cast<int>(snap_trunc(acc - off, 1e-5f));
    }
    __syncthreads();

    // Sparse-delta epilogue: one coalesced 256 B row per MCU.
    for (int mcu = 0; mcu < kMcus; ++mcu) {
      const int64_t n = base + mcu;
      if (n >= n_blocks) break;
      const int xq = q[mcu][k];
      const int prev = seg_first ? 0 : q[mcu][k - 1];
      const bool start = seg_first || xq != prev;
      out[n * kLanes + k] = static_cast<int16_t>(start ? xq - prev + kBias : 0);
    }
    __syncthreads();  // planes and q are rewritten by the next group
  }
}

}  // namespace

// rgb: (B, H, W, 3) uint8, contiguous; out: (n_blocks, 128) int16 with
// n_blocks = B * bpc * bpr; basis: (128, 64) f32 rows [my; mc64[:32];
// mc64[:32]]; offs: (128,) f32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int fwd_megakernel_launch(const void* rgb, void* out,
                                     const void* basis, const void* offs,
                                     long long n_blocks, int height, int width,
                                     int bpc, int bpr, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_megakernel,
                                                      kLanes, 0);
  if (err != cudaSuccess) return err;
  const long long groups = (n_blocks + kMcus - 1) / kMcus;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > groups) grid = groups;
  fwd_megakernel<<<static_cast<unsigned>(grid), kLanes, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int16_t*>(out),
      static_cast<const float*>(basis), static_cast<const float*>(offs),
      n_blocks, height, width, bpc, bpr);
  return cudaGetLastError();
}

extern "C" const char* fwd_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
