// The fused-DCT gates for Hopper (sm_90a): two kernels a fused plane →
// packed16 forward would be built from.
//
// basis_dot: out[n, j] = Σ_k x[n, k] · m[j, k] for (N, 64) x and a (64, 64)
// basis m, float32 in and out, in IEEE fp32 FFMA on the CUDA cores with k
// summed in order 0 .. 63 for every output (no tensor cores: neither TF32
// nor bf16 parts are the question).  Replaces
// profiles/profile_fused_dct_gates.py::dot_kernel (:26, pallas_call :35),
// which asked whether a Pallas kernel's HIGHEST-precision dot_general equals
// XLA's highest matmul with the luma forward basis.  cuBLAS picks its own
// summation order, so outputs may differ from it in the last bits; the
// kernel is held to 64 · 2^-24 · Σ_k |x_k · m_jk| of a float64 product.
// Design: persistent CTAs of 128 threads; the basis is staged once a CTA,
// transposed, in shared memory (mt[k][j], 16 KiB); a CTA walks 64-row tiles
// of x, each staged row-major in shared memory (16 KiB) by coalesced
// 16-byte loads; a thread owns an 8-row × 4-output register block (32
// accumulators) and per 4 steps of k reads 8 float4 of its rows and 4
// float4 of the basis for 128 FFMA; outputs leave as 16-byte stores, two
// 256-byte rows a warp instruction.
// What bounds it: x read once and the result written once, 512 bytes a
// row: at 2,097,152 rows 1,073,758,208 bytes with the basis, 0.3205 ms at
// 3.35 TB/s; the 17.18 GFLOP of FFMA work take 0.2564 ms at the data
// sheet's 67 TFLOP/s fp32, so bytes bound it, if narrowly.
//
// minor_transpose: (B, bw, tw) → (B, tw, bw) float32, any bw ≥ 1 and 1 ≤ tw
// ≤ 64.  Replaces profile_fused_dct_gates.py::tr_kernel (:50, pallas_call
// :56), the (8, bw, tw) → (8, tw, bw) minor-dims transpose the TPU probe
// asked Mosaic to lower.  Design: a tile is one batch's 128 consecutive
// columns (bw) with all tw rows; its tw · 128 input floats are contiguous
// and are read flat and coalesced, each into a transposed shared tile
// [tw][128 + pad] whose padding spreads one warp's 32 stores over 32 banks
// for tw a divisor of 32; after one CTA barrier each output row's 128
// columns leave as coalesced stores.  The flat index splits into (column,
// row) by a multiply-high with a reciprocal of tw computed on the host.
// Persistent CTAs walk the tiles.
// What bounds it: one read and one write of the tensor, 8 bytes an element:
// the luma bands of 16 frames of 2048² (32,768, 256, 8) 536,870,912 bytes,
// 0.1603 ms at 3.35 TB/s; chroma (32,768, 128, 4) 0.0401 ms.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kDepth = 64;       // basis_dot: k
constexpr int kOutputs = 64;     // basis_dot: j
constexpr int kRows = 64;        // basis_dot: rows of x a tile
constexpr int kDotThreads = 128; // 16 × 4 outputs by 8 × 8 rows
constexpr int kTrThreads = 256;
constexpr int kChunk = 128;      // minor_transpose: columns a tile
constexpr int kMaxTw = 64;

__global__ void __launch_bounds__(kDotThreads)
    basis_dot_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     float* __restrict__ out, long long n) {
  __shared__ alignas(16) float mt[kDepth][kOutputs];  // mt[k][j] = m[j][k]
  __shared__ alignas(16) float xs[kRows][kDepth];
  const int t = threadIdx.x;
  const int tc = t % 16;  // outputs 4 tc .. 4 tc + 3
  const int tr = t / 16;  // rows 8 tr .. 8 tr + 7 of the tile
  for (int i = t; i < kDepth * kOutputs; i += kDotThreads) {
    const int k = i / kOutputs, j = i % kOutputs;
    mt[k][j] = m[j * kDepth + k];
  }
  const long long tiles = (n + kRows - 1) / kRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * kRows;
    __syncthreads();  // the basis is staged; the last tile's reads are done
    for (int q = t; q < kRows * kDepth / 4; q += kDotThreads) {
      const int r = q / (kDepth / 4), c4 = q % (kDepth / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < n)
        v = __ldcs(reinterpret_cast<const float4*>(x + (r0 + r) * kDepth) + c4);
      *reinterpret_cast<float4*>(&xs[r][4 * c4]) = v;
    }
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kDepth; k += 4) {
      float4 xv[8], mv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        xv[i] = *reinterpret_cast<const float4*>(&xs[8 * tr + i][k]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mv[e] = *reinterpret_cast<const float4*>(&mt[k + e][4 * tc]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* mk = reinterpret_cast<const float*>(&mv[e]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float xk = reinterpret_cast<const float*>(&xv[i])[e];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(xk, mk[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = r0 + 8 * tr + i;
      if (r < n)
        __stcs(reinterpret_cast<float4*>(out + r * kOutputs) + tc,
               make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    }
  }
}

__global__ void __launch_bounds__(kTrThreads)
    minor_transpose_kernel(const float* __restrict__ in,
                           float* __restrict__ out, long long batches,
                           long long bw, int tw, int stride, unsigned recip) {
  extern __shared__ float s[];  // [tw][stride]
  const long long chunks = (bw + kChunk - 1) / kChunk;
  const long long units = batches * chunks;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const long long b = u / chunks;
    const long long c0 = (u - b * chunks) * kChunk;
    const int width = static_cast<int>(bw - c0 < kChunk ? bw - c0 : kChunk);
    const int count = width * tw;
    const float* src = in + (b * bw + c0) * tw;
    __syncthreads();  // the last tile's reads are done
#pragma unroll 4
    for (int f = threadIdx.x; f < count; f += kTrThreads) {
      const int c = tw == 1 ? f : static_cast<int>(__umulhi(f, recip));
      s[(f - c * tw) * stride + c] = __ldcs(src + f);
    }
    __syncthreads();
    float* dst = out + b * tw * bw + c0;
#pragma unroll 4
    for (int f = threadIdx.x; f < tw * kChunk; f += kTrThreads) {
      const int row = f / kChunk, c = f % kChunk;
      if (c < width) __stcs(dst + row * bw + c, s[row * stride + c]);
    }
  }
}

// Shared row stride of the transpose's tile: for tw a divisor of 32 below
// it, ≡ 32 / tw (mod 32), so a warp's 32 consecutive flat stores (32 / tw
// columns × tw rows) fall in 32 distinct banks; else ≡ 1.
int transpose_stride(int tw) {
  return kChunk + (tw < 32 && 32 % tw == 0 ? 32 / tw : 1);
}

size_t transpose_smem(int tw) {
  return sizeof(float) * static_cast<size_t>(tw) * transpose_stride(tw);
}

// Persistent CTAs: as many as fit on the SMs, no more than `units`.
cudaError_t grid_for(const void* kernel, int threads, size_t smem,
                     long long units, unsigned* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *ctas = static_cast<unsigned>(units < resident ? units : resident);
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

cudaError_t attributes_of(const void* fn, int threads, size_t dynamic,
                          int* regs, int* smem, int* ctas) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dynamic);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads,
                                                       dynamic);
}

}  // namespace

// x: (n, k) float32, m: (j, k) float32, out: (n, j) float32, all contiguous;
// k and j must be 64; x and out 16-byte aligned, m 4-byte.  Launches on
// `stream` and returns the first CUDA error of the device and occupancy
// queries or the launch (0 on success), cudaErrorInvalidValue for a shape it
// does not take, cudaErrorMisalignedAddress for a misaligned pointer; never
// synchronises.
extern "C" int basis_dot_launch(const void* x, const void* m, void* out,
                                long long n, int k, int j, void* stream) {
  if (n < 0 || k != kDepth || j != kOutputs) return cudaErrorInvalidValue;
  if (misaligned(x, 16) || misaligned(out, 16) || misaligned(m, 4))
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(basis_dot_kernel);
  unsigned ctas = 0;
  const cudaError_t err =
      grid_for(fn, kDotThreads, 0, (n + kRows - 1) / kRows, &ctas);
  if (err != cudaSuccess) return err;
  basis_dot_kernel<<<ctas, kDotThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), n);
  return cudaGetLastError();
}

// in: (batches, bw, tw) float32, out: (batches, tw, bw) float32, both
// contiguous and 4-byte aligned; bw ≥ 1, 1 ≤ tw ≤ 64.  Returns as
// basis_dot_launch does.
extern "C" int minor_transpose_launch(const void* in, void* out,
                                      long long batches, long long bw, int tw,
                                      void* stream) {
  if (batches < 0 || bw < 1 || tw < 1 || tw > kMaxTw)
    return cudaErrorInvalidValue;
  if (misaligned(in, 4) || misaligned(out, 4))
    return cudaErrorMisalignedAddress;
  if (batches == 0) return cudaSuccess;
  const void* fn = reinterpret_cast<const void*>(minor_transpose_kernel);
  const size_t smem = transpose_smem(tw);
  const long long units = batches * ((bw + kChunk - 1) / kChunk);
  unsigned ctas = 0;
  const cudaError_t err = grid_for(fn, kTrThreads, smem, units, &ctas);
  if (err != cudaSuccess) return err;
  const unsigned recip = tw == 1 ? 0u
      : static_cast<unsigned>(((1ull << 32) + tw - 1) / tw);
  minor_transpose_kernel<<<ctas, kTrThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), batches, bw,
      tw, transpose_stride(tw), recip);
  return cudaGetLastError();
}

// Registers per thread, shared memory per CTA (static and, for the
// transpose at this tw, dynamic) and resident CTAs per SM of kernel 0
// (basis_dot) or 1 (minor_transpose); returns the first CUDA error.
extern "C" int dct_gate_attributes(int kernel, int tw, int* regs, int* smem,
                                   int* ctas) {
  if (kernel == 0)
    return attributes_of(reinterpret_cast<const void*>(basis_dot_kernel),
                         kDotThreads, 0, regs, smem, ctas);
  if (kernel == 1 && tw >= 1 && tw <= kMaxTw)
    return attributes_of(reinterpret_cast<const void*>(minor_transpose_kernel),
                         kTrThreads, transpose_smem(tw), regs, smem, ctas);
  return cudaErrorInvalidValue;
}

extern "C" const char* dct_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
