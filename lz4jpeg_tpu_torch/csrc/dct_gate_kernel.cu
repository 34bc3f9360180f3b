// The fused-DCT gates for Hopper (sm_90a): two kernels a fused plane →
// packed16 forward would be built from.
//
// basis_dot: out[n, j] = Σ_k x[n, k] · m[j, k] for (N, 64) x and a (64, 64)
// basis m, float32 in and out, in IEEE fp32 FFMA on the CUDA cores with k
// summed in order 0 .. 63 from 0 for every output (no tensor cores: neither
// TF32 nor bf16 parts are the question).  Replaces
// profiles/profile_fused_dct_gates.py::dot_kernel (:26, pallas_call :35),
// which asked whether a Pallas kernel's HIGHEST-precision dot_general equals
// XLA's highest matmul with the luma forward basis.  cuBLAS picks its own
// summation order, so outputs may differ from it in the last bits; the
// kernel is held to 64 · 2^-24 · Σ_k |x_k · m_jk| of a float64 product.
// Design: persistent CTAs (kCtasPerSm an SM at most) of one producer warp
// and kConsumers compute threads.  Each CTA stages the basis once,
// transposed (mt[k][j], 16 KiB), and walks the tiles of kTileRows rows of x
// blockIdx.x, blockIdx.x + gridDim.x, ... through a ring of kStages tiles
// in dynamic shared memory.  One producer lane fills a slot by 1-D bulk
// copies (cp.async.bulk, one for each group of kBlockRows rows, 256 bytes a
// row, completing on the slot's "full" mbarrier with the bytes as its
// transaction count) as soon as the consumers have arrived on the slot's
// "empty" mbarrier, so the loads of the next tiles overlap the FFMA of this
// one (the mbarrier and copy helpers: csrc/bulk_ring.cuh).  A consumer
// thread owns a kBlockRows × 4 register block: the rows
// of one group and the columns 4 cg .. 4 cg + 3.  A warp holds two row
// groups and all 16 column groups, so a basis load (one float4 of mt[k]) is
// 16 contiguous float4 broadcast to the row groups, and an x load (one
// float4 of a row, four k) is one address a row group broadcast to its
// columns; the row groups sit kGroupBytes + 16 bytes apart in the slot, so
// their float4 fall in distinct banks: no bank conflict, 16 wavefronts for
// 128 FFMA (8 x loads of one, 4 basis loads of two).  A consumer warp
// releases the slot once its sums are in registers, then stores them as
// 16-byte vectors with the default hints (a warp's store: the 256
// contiguous bytes of each of its row groups' rows).  The producer waits on
// "empty" with the parity of the slot's last round (the first round passes
// at once), the consumers on "full" with the parity of this round; a
// partial last tile copies only its rows and expects only their bytes, and
// its other rows' sums are not stored.  The shape, 64-row tiles, two
// slots, three CTAs an SM and 8 × 4 blocks (4 consumer warps a CTA), is the
// fastest of a sweep of 47 on an H100 (PERF.md §6: 8 × 8 blocks, with
// half the basis loads, leave too few warps an SM).
// What bounds it: x read once and the result written once, 512 bytes a
// row: at 2,097,152 rows 1,073,758,208 bytes with the basis, 0.3205 ms at
// 3.35 TB/s; the 17.18 GFLOP of FFMA work take 0.2564 ms at the data
// sheet's 67 TFLOP/s fp32, so bytes bound it, if narrowly, and only loads,
// stores and FFMA that overlap come near it.
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

#include "bulk_ring.cuh"

namespace {

constexpr int kDepth = 64;       // basis_dot: k
constexpr int kOutputs = 64;     // basis_dot: j
constexpr int kTrThreads = 256;
constexpr int kChunk = 128;      // minor_transpose: columns a tile
constexpr int kMaxTw = 64;
constexpr int kVecThreads = 256;
constexpr int kVecUnroll = 4;    // float4 loads in flight a lane

namespace dot {  // basis_dot's shape (see the design above)
constexpr int kTileRows = 64;
constexpr int kStages = 2;
constexpr int kCtasPerSm = 3;
constexpr int kBlockRows = 8;
constexpr int kRowBytes = kDepth * 4;                // 256: one row of x
constexpr int kColGroups = kOutputs / 4;            // 16 column groups
constexpr int kRowGroups = kTileRows / kBlockRows;  // row groups a tile
constexpr int kConsumers = kRowGroups * kColGroups; // compute threads
constexpr int kThreads = kConsumers + 32;           // and the producer warp
constexpr int kGroupBytes = kBlockRows * kRowBytes; // one bulk copy
constexpr int kGroupStride = kGroupBytes + 16;      // 4 banks between groups
constexpr int kTileBytes = kRowGroups * kGroupStride;
constexpr int kBasisBytes = kDepth * kOutputs * 4;
constexpr size_t kSmem =
    kBasisBytes + static_cast<size_t>(kStages) * kTileBytes + 16 * kStages;
static_assert(kConsumers % 32 == 0, "whole warps");
static_assert(kGroupBytes % 128 == 0, "a group starts 4 banks on from the last");
}  // namespace dot

__global__ void __launch_bounds__(dot::kThreads, dot::kCtasPerSm)
    basis_dot_kernel(const float* __restrict__ x, const float* __restrict__ m,
                     float* __restrict__ out, long long n) {
  using namespace dot;
  extern __shared__ __align__(128) unsigned char smem[];
  float* mt = reinterpret_cast<float*>(smem);  // mt[k * 64 + j] = m[j][k]
  unsigned char* ring = smem + kBasisBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kTileBytes);
  uint64_t* empty = full + kStages;
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = t; i < kDepth * kOutputs; i += kThreads)
    mt[i] = m[(i % kOutputs) * kDepth + i / kOutputs];
  __syncthreads();
  const long long tiles = (n + kTileRows - 1) / kTileRows;

  if (t >= kConsumers) {  // the producer warp: one lane fills the ring
    if (t != kConsumers) return;
    int i = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
      const int s = i % kStages;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      const long long r0 = tile * kTileRows;
      const int rows = n - r0 < kTileRows ? static_cast<int>(n - r0) : kTileRows;
      mbar_expect_tx(&full[s], rows * kRowBytes);
      unsigned char* slot = ring + s * kTileBytes;
      for (int g = 0; g * kBlockRows < rows; ++g) {
        const int left = rows - g * kBlockRows;
        bulk_load(slot + g * kGroupStride, x + (r0 + g * kBlockRows) * kDepth,
                  (left < kBlockRows ? left : kBlockRows) * kRowBytes, &full[s]);
      }
    }
    return;
  }

  const int lane = t & 31;
  const int cg = lane % kColGroups;
  const int rg = (t >> 5) * (32 / kColGroups) + lane / kColGroups;
  const float* mcol = mt + 4 * cg;
  int i = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const float* xs =
        reinterpret_cast<const float*>(ring + s * kTileBytes + rg * kGroupStride);
    float acc[kBlockRows][4];
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 2
    for (int k = 0; k < kDepth; k += 4) {
      float4 xv[kBlockRows];
#pragma unroll
      for (int r = 0; r < kBlockRows; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + r * kDepth + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 q =
            *reinterpret_cast<const float4*>(mcol + (k + e) * kOutputs);
        const float mv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int r = 0; r < kBlockRows; ++r) {
          const float xk = reinterpret_cast<const float*>(&xv[r])[e];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xk, mv[c], acc[r][c]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the slot's reads are done
    const long long r0 = tile * kTileRows + rg * kBlockRows;
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      if (r0 + r >= n) break;
      *reinterpret_cast<float4*>(out + (r0 + r) * kOutputs + 4 * cg) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
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

// basis_dot's launch for n rows: its tiles, the resident CTAs (kCtasPerSm
// an SM, or fewer where the shared memory allows fewer) and the CTAs, no
// more than the tiles.  Allows the kernel its dynamic shared memory first.
struct DotPlan {
  long long tiles, resident, ctas;
};

cudaError_t dot_plan(long long n, DotPlan* p) {
  const void* fn = reinterpret_cast<const void*>(basis_dot_kernel);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dot::kSmem));
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, dot::kThreads, dot::kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm > dot::kCtasPerSm) per_sm = dot::kCtasPerSm;
  p->tiles = (n + dot::kTileRows - 1) / dot::kTileRows;
  p->resident = static_cast<long long>(sms) * per_sm;
  p->ctas = p->tiles < p->resident ? p->tiles : p->resident;
  return p->resident > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
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
  DotPlan p;
  const cudaError_t err = dot_plan(n, &p);
  if (err != cudaSuccess) return err;
  basis_dot_kernel<<<static_cast<unsigned>(p.ctas), dot::kThreads, dot::kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m),
      static_cast<float*>(out), n);
  return cudaGetLastError();
}

// The launch basis_dot_launch makes for n ≥ 0 rows: plan[0] tiles, [1]
// resident CTAs, [2] CTAs, [3] rows a tile, [4] ring slots, [5] threads a
// CTA (the last warp the producer), [6] dynamic shared memory bytes;
// returns the first CUDA error of the queries, cudaErrorInvalidValue for
// n < 0.
extern "C" int basis_dot_plan(long long n, long long* plan) {
  if (n < 0) return cudaErrorInvalidValue;
  DotPlan p;
  const cudaError_t err = dot_plan(n, &p);
  if (err != cudaSuccess) return err;
  const long long shape[7] = {p.tiles, p.resident, p.ctas, dot::kTileRows,
                              dot::kStages, dot::kThreads,
                              static_cast<long long>(dot::kSmem)};
  for (int i = 0; i < 7; ++i) plan[i] = shape[i];
  return cudaSuccess;
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

// Registers per thread, shared memory per CTA (static and dynamic: the
// basis and the ring for basis_dot, the shared tile at this tw for the tile
// transpose) and resident CTAs per SM (for basis_dot as it launches) of
// kernel 0 (basis_dot), 1 (minor_transpose's tile route) or 2 (its barrier-free
// route, tw 2, 4 or 8); returns the first CUDA error.
extern "C" int dct_gate_attributes(int kernel, int tw, int* regs, int* smem,
                                   int* ctas) {
  if (kernel == 0) {
    DotPlan p;
    cudaError_t err = dot_plan(0, &p);
    if (err == cudaSuccess)
      err = attributes_of(reinterpret_cast<const void*>(basis_dot_kernel),
                          dot::kThreads, dot::kSmem, regs, smem, ctas);
    if (err == cudaSuccess && *ctas > dot::kCtasPerSm) *ctas = dot::kCtasPerSm;
    return err;
  }
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
