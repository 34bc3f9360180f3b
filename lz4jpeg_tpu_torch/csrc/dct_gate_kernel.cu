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
// Persistent CTAs walk the tiles.  That is the route for any shape; tw 2, 4
// and 8 with bw % 4 == 0, both bases 16-byte aligned and fewer than 2³²
// four-column groups take a barrier-free one (``minor_transpose_vec_kernel``):
// a 4-column group is 4·tw contiguous floats in and one float4 of each of
// its tw output rows out, so tw lanes each load one float4 of it, swap
// values with their group's lanes by __shfl_xor_sync (a swap of a lane
// bit with an element bit per exchange: one for tw 2, two for tw 4 and 8)
// until each lane holds one output row's four columns, and store that
// float4.  A warp's 32 loads are 512 contiguous bytes, each lane keeps 4
// loads in flight, and the CTAs walk the flat float4 index in order, one
// CTA for each 1,024 float4 (8 warps × 4 × 32), with no shared memory and
// no CTA barrier.  The hardware starts CTAs in index order, so the bytes in
// flight stay in one moving window of memory; persistent CTAs striding
// over the index ran slower at luma on an H100 (``PERF.md``).  The route
// is chosen by shape and alignment alone (``vector_route``).
// What bounds it: one read and one write of the tensor, 8 bytes an element:
// the luma bands of 16 frames of 2048² (32,768, 256, 8) 536,870,912 bytes,
// 0.1603 ms at 3.35 TB/s; chroma (32,768, 128, 4) 0.0401 ms.

#include <climits>
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
constexpr int kVecThreads = 256;
constexpr int kVecUnroll = 4;    // float4 loads in flight a lane

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

// Bit kLaneBit of the lane swapped with bit kElemBit of the index of v's
// four floats across the lanes 1 << kLaneBit apart: afterwards the float
// at (lane, index) is the one that was at the lane and index with those two
// bits exchanged.
template <int kLaneBit, int kElemBit>
__device__ __forceinline__ void swap_bits(float (&v)[4], int lane) {
  constexpr int kE = 1 << kElemBit;
  const bool mine = (lane >> kLaneBit) & 1;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e & kE) continue;
    const float lo = v[e], hi = v[e | kE];
    const float got = __shfl_xor_sync(0xffffffffu, mine ? lo : hi,
                                      1 << kLaneBit);
    v[e] = mine ? got : lo;
    v[e | kE] = mine ? hi : got;
  }
}

// The barrier-free route, kTw 2, 4 or 8: float4 f of the input (n4 of
// them) is float4 f % kTw of the 4-column group f / kTw, whose input is its
// 4 columns' kTw rows, column-major.  The lanes of a group hold (column,
// row) by the bits of (lane % kTw, index): for kTw 2 (c1 | c0 r0), 4 (c1
// c0 | r1 r0), 8 (c1 c0 r2 | r1 r0).  Swapping bits leaves each lane one
// row's 4 columns: the row (r0), (r1 r0), (r1 r0 r2) of its lane bits, the
// columns in order but for kTw 2 (c0 c1: floats 1 and 2 swap).  Group u
// is batch u / groups, columns 4 (u % groups) ..; magic = ⌈2⁶⁴ / groups⌉
// divides u < 2³² exactly (0 for one group a batch).  Warp w of the grid
// moves float4 32 kVecUnroll w ..; the loop strides by the grid for a
// grid cut at 2³¹ − 1 CTAs.
template <int kTw>
__global__ void __launch_bounds__(kVecThreads)
    minor_transpose_vec_kernel(const float4* __restrict__ in,
                               float* __restrict__ out, long long n4,
                               long long bw, unsigned long long groups,
                               unsigned long long magic) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kVecThreads / 32);
  const long long first =
      static_cast<long long>(blockIdx.x) * (kVecThreads / 32) + (threadIdx.x >> 5);
  const int row = kTw == 2   ? lane & 1
                  : kTw == 4 ? lane & 3
                             : 4 * (lane & 1) + 2 * ((lane >> 2) & 1) +
                                   ((lane >> 1) & 1);
  for (long long w = first * kVecUnroll; w * 32 < n4; w += warps * kVecUnroll) {
    float v[kVecUnroll][4];
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      const long long f = (w + k) * 32 + lane;
      const float4 q = f < n4 ? __ldg(in + f) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[k][0] = q.x;
      v[k][1] = q.y;
      v[k][2] = q.z;
      v[k][3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < kVecUnroll; ++k) {
      if constexpr (kTw == 2) {
        swap_bits<0, 0>(v[k], lane);
      } else if constexpr (kTw == 4) {
        swap_bits<0, 0>(v[k], lane);
        swap_bits<1, 1>(v[k], lane);
      } else {
        swap_bits<1, 0>(v[k], lane);
        swap_bits<2, 1>(v[k], lane);
      }
      const long long f = (w + k) * 32 + lane;
      if (f >= n4) continue;
      const unsigned long long u = static_cast<unsigned long long>(f) / kTw;
      const unsigned long long b = magic ? __umul64hi(u, magic) : u;
      const long long c0 = 4 * static_cast<long long>(u - b * groups);
      float* dst = out + (static_cast<long long>(b) * kTw + row) * bw + c0;
      *reinterpret_cast<float4*>(dst) =
          kTw == 2 ? make_float4(v[k][0], v[k][2], v[k][1], v[k][3])
                   : make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
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

// The barrier-free route takes tw 2, 4 or 8, bw % 4 == 0, both bases
// 16-byte aligned and fewer than 2³² four-column groups.
bool vector_route(const void* in, const void* out, long long batches,
                  long long bw, int tw) {
  return (tw == 2 || tw == 4 || tw == 8) && bw % 4 == 0 &&
         !misaligned(in, 16) && !misaligned(out, 16) &&
         batches * (bw / 4) < (1LL << 32);
}

const void* vec_kernel(int tw) {
  switch (tw) {
    case 2: return reinterpret_cast<const void*>(minor_transpose_vec_kernel<2>);
    case 4: return reinterpret_cast<const void*>(minor_transpose_vec_kernel<4>);
    case 8: return reinterpret_cast<const void*>(minor_transpose_vec_kernel<8>);
    default: return nullptr;
  }
}

cudaError_t launch_vec(const float* in, float* out, long long batches,
                       long long bw, int tw, cudaStream_t stream) {
  const long long n4 = batches * bw * tw / 4;
  const long long per_cta = 32LL * kVecUnroll * (kVecThreads / 32);
  const long long need = (n4 + per_cta - 1) / per_cta;
  const unsigned ctas = static_cast<unsigned>(need < INT_MAX ? need : INT_MAX);
  const unsigned long long groups = static_cast<unsigned long long>(bw / 4);
  const unsigned long long magic = groups == 1 ? 0 : ~0ULL / groups + 1;
  const float4* src = reinterpret_cast<const float4*>(in);
  switch (tw) {
    case 2:
      minor_transpose_vec_kernel<2><<<ctas, kVecThreads, 0, stream>>>(
          src, out, n4, bw, groups, magic);
      break;
    case 4:
      minor_transpose_vec_kernel<4><<<ctas, kVecThreads, 0, stream>>>(
          src, out, n4, bw, groups, magic);
      break;
    default:
      minor_transpose_vec_kernel<8><<<ctas, kVecThreads, 0, stream>>>(
          src, out, n4, bw, groups, magic);
      break;
  }
  return cudaGetLastError();
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
// contiguous and 4-byte aligned; bw ≥ 1, 1 ≤ tw ≤ 64.  Takes the
// barrier-free route where ``minor_transpose_route`` says so, the tile
// route otherwise.  Returns as basis_dot_launch does.
extern "C" int minor_transpose_launch(const void* in, void* out,
                                      long long batches, long long bw, int tw,
                                      void* stream) {
  if (batches < 0 || bw < 1 || tw < 1 || tw > kMaxTw)
    return cudaErrorInvalidValue;
  if (misaligned(in, 4) || misaligned(out, 4))
    return cudaErrorMisalignedAddress;
  if (batches == 0) return cudaSuccess;
  if (vector_route(in, out, batches, bw, tw))
    return launch_vec(static_cast<const float*>(in), static_cast<float*>(out),
                      batches, bw, tw, static_cast<cudaStream_t>(stream));
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

// The route minor_transpose_launch takes for these arguments: 1 the
// barrier-free route, 0 the tile route.
extern "C" int minor_transpose_route(const void* in, const void* out,
                                     long long batches, long long bw, int tw) {
  return vector_route(in, out, batches, bw, tw) ? 1 : 0;
}

// Registers per thread, shared memory per CTA (static and, for the tile
// transpose at this tw, dynamic) and resident CTAs per SM of kernel 0
// (basis_dot), 1 (minor_transpose's tile route) or 2 (its barrier-free
// route, tw 2, 4 or 8); returns the first CUDA error.
extern "C" int dct_gate_attributes(int kernel, int tw, int* regs, int* smem,
                                   int* ctas) {
  if (kernel == 0)
    return attributes_of(reinterpret_cast<const void*>(basis_dot_kernel),
                         kDotThreads, 0, regs, smem, ctas);
  if (kernel == 1 && tw >= 1 && tw <= kMaxTw)
    return attributes_of(reinterpret_cast<const void*>(minor_transpose_kernel),
                         kTrThreads, transpose_smem(tw), regs, smem, ctas);
  if (kernel == 2 && vec_kernel(tw))
    return attributes_of(vec_kernel(tw), kVecThreads, 0, regs, smem, ctas);
  return cudaErrorInvalidValue;
}

extern "C" const char* dct_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
