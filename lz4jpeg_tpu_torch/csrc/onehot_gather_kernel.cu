// The LZ4T resolve as a dense one-hot product on the tensor cores, for
// Hopper (sm_90a): one template for the four TPU probes of the formulation.
//
// Replaces the pallas_call sites of profiles/probe_lz4t_mxu_gather.py
// (kernel3 :66, pallas_call :97), probe_lz4t_mxu_gather2.py (kernel :47,
// make(mode) :46, :86), probe_lz4t_mxu_gather3.py (kernel :51, make(T, ...)
// :44, :72) and probe_lz4t_mxu_gather4.py (kernel :53, make(rows_per_step,
// dtype_mode) :48, :93).  The byte at root r of a block is row r >> 7, lane
// r & 127 of the block's literals viewed as (C, 128), C = P / 128.  The
// probes compute it densely: a one-hot H (outputs × C) of r >> 7, times the
// literals L (C × 128), then the lane r & 127 of each output's row.  Every
// k-slice of the C-deep contraction is multiplied, the all-zero ones too,
// and no byte is looked up directly: the measurement is the price of the
// 2·P² product a block (the direct gather is csrc/resolve_kernel.cu, K3).
//
// Compile-time parameters of the template:
//   * the orientation: H · L, outputs as the A rows (g1-g3), or Lᵀ · Hᵀ,
//     outputs as the B columns (g4);
//   * the element type: bf16 with f32 accumulation (bytes 0-255 are exact
//     in bf16), or s8 with s32 accumulation, bytes riding as v − 128 and
//     128 added to the product (one 1 a one-hot column keeps it exact);
//   * the cut: full (the lane r & 127), nomask (the sum of all 128 lanes of
//     the row) or hbuild (the one-hot built and summed, plus r & 127; no
//     product and no literals);
//   * the outputs per CTA (the probe's grid step): 2,048 for g1 and g2, T
//     for g3, R · 128 for g4;
//   * the output type: u8 (g1) or i32.
// The nine instantiations are the probes' ten rows less one: g2's full row
// and g3's T = 2,048 row are the same kernel (a GPU has no sublane or lane
// placement; g2 differs by the torch transposes around the call).
//
// Design.  A CTA of 8 warps takes one step of one block.  It stages the
// block's literal operand once in shared memory as contiguous 16 × 16
// tiles (``stage_slab``; every tile on a 32-byte boundary, as wmma wants,
// and its rows in distinct banks): 128 KiB in bf16 and 64 KiB in s8 at
// C = 512.  Each warp holds 32 outputs,
// one root a lane, and walks k in slices of 16: each lane writes its
// output's 16 one-hot values (a compare of r >> 7 against the slice) into
// the warp's two 16 × 16 tiles in shared memory, and the warp multiplies
// them with the slice's eight literal tiles through nvcuda::wmma
// (m16n16k16), 16 accumulator tiles a warp.  The accumulators go tile by
// tile through a 16 × 16 scratch in shared memory, where each lane picks
// its lane (or sums all of them).  A simple kernel: no wgmma, no TMA, no
// overlap of the staging with the product.
//
// What bounds it: the product, 2 · outputs · C · 128 operations: at 64
// blocks of 65,536 (4 MiB of text, C = 512) 5.498e11, 0.5559 ms at the
// data sheet's 989 TFLOP/s dense bf16, 0.2778 ms at 1,979 TOPS dense int8.
// hbuild moves roots and outputs only (33.6 MB, 0.0100 ms), and its
// 2.1e9 compares bound it harder.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 128;      // literal lanes a chunk: r & 127
constexpr int kMaxChunks = 512;  // C of a 65,536-byte block
constexpr int kTile = 16;        // wmma m = n = k

enum class Orient { kHL = 0, kLtHt = 1 };
enum class Cut { kFull = 0, kNoMask = 1, kHBuild = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr uint32_t kOne = 0x3F80u;  // the bits of bf16 1.0
  static constexpr int kBias = 0;
  __device__ static int value(float v) { return __float2int_rz(v); }
  // The sum of a lane's 16 one-hot values, read back as two 16-byte words.
  __device__ static int sum_run(const __nv_bfloat16* run) {
    int sum = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(run)[k];
      const uint32_t ws[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sum += __float2int_rz(__uint_as_float(ws[j] << 16)) +
               __float2int_rz(__uint_as_float(ws[j] & 0xFFFF0000u));
    }
    return sum;
  }
};
template <>
struct Elem<signed char> {
  using Acc = int;
  static constexpr uint32_t kOne = 1u;
  static constexpr int kBias = 128;  // literals ride as v − 128
  __device__ static int value(int v) { return v; }
  __device__ static int sum_run(const signed char* run) {
    const uint4 q = *reinterpret_cast<const uint4*>(run);
    const uint32_t ws[4] = {q.x, q.y, q.z, q.w};
    int sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        sum += static_cast<signed char>(ws[j] >> (8 * b));
    return sum;
  }
};

template <Orient O, typename T>
struct Frags {
  using Acc = typename Elem<T>::Acc;
  using LitRole =
      std::conditional_t<O == Orient::kHL, wmma::matrix_b, wmma::matrix_a>;
  using HotRole =
      std::conditional_t<O == Orient::kHL, wmma::matrix_a, wmma::matrix_b>;
  using HotLayout =
      std::conditional_t<O == Orient::kHL, wmma::row_major, wmma::col_major>;
  using Lit = wmma::fragment<LitRole, kTile, kTile, kTile, T, wmma::row_major>;
  using Hot = wmma::fragment<HotRole, kTile, kTile, kTile, T, HotLayout>;
  using Sum = wmma::fragment<wmma::accumulator, kTile, kTile, kTile, Acc>;
  // The literal tile of k-slice kc and lane block n (``stage_slab``'s
  // layout), row-major with a leading dimension of 16.
  __device__ static const T* lit_tile(const T* slab, int kc, int n) {
    return slab + (kc * (kLanes / kTile) + n) * kTile * kTile;
  }
  // The accumulator of output j (its lane within the 16) and literal lane
  // t of a tile in the row-major scratch: outputs are the rows of H · L and
  // the columns of Lᵀ · Hᵀ.
  __device__ static Acc at(const Acc* scratch, int j, int t) {
    return O == Orient::kHL ? scratch[j * kTile + t] : scratch[t * kTile + j];
  }
};

// One output's 16 one-hot values of a k-slice, d = (r >> 7) − first k of
// the slice, as 16 consecutive elements (the lane's row of the A tile for
// H · L, its column of the column-major B tile for Lᵀ · Hᵀ).
template <typename T>
__device__ __forceinline__ void one_hot_run(T* run, int d) {
  constexpr int kWords = kTile * static_cast<int>(sizeof(T)) / 4;
  const bool hit = static_cast<unsigned>(d) < static_cast<unsigned>(kTile);
  const int byte = d * static_cast<int>(sizeof(T));
  uint32_t w[kWords];
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    w[k] = hit && (byte >> 2) == k ? Elem<T>::kOne << (8 * (byte & 3)) : 0u;
  uint4* dst = reinterpret_cast<uint4*>(run);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k)
    dst[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

// The block's literal operand (chunks × 128 for H · L, 128 × chunks for
// Lᵀ · Hᵀ, row-major in device memory) into shared memory as 16 × 16
// tiles, each row-major and 512 or 256 contiguous bytes: tile (k-slice kc,
// lane block n) at (kc · 8 + n) · 256 elements, holding rows k, columns
// lanes (the B operand of H · L) or rows lanes, columns k (the A operand of
// Lᵀ · Hᵀ).  A tile's rows then lie in distinct banks, where the C × 128
// slab's rows, 256 bytes apart, would all start in one.
template <Orient O, typename T>
__device__ void stage_slab(T* slab, const T* src, int chunks) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const uint4* g = reinterpret_cast<const uint4*>(src);
  uint4* s = reinterpret_cast<uint4*>(slab);
  for (int q = threadIdx.x; q < chunks * kLanes / kVec; q += kThreads) {
    const int e = q * kVec;
    const int k = O == Orient::kHL ? e / kLanes : e % chunks;
    const int lane = O == Orient::kHL ? e % kLanes : e / chunks;
    const int tile = (k / kTile) * (kLanes / kTile) + lane / kTile;
    const int in_tile = O == Orient::kHL ? (k % kTile) * kTile + lane % kTile
                                         : (lane % kTile) * kTile + k % kTile;
    s[(tile * kTile * kTile + in_tile) / kVec] = __ldg(g + q);
  }
}

template <Orient O, typename T, Cut K>
__host__ __device__ constexpr size_t smem_bytes(int chunks) {
  return (K == Cut::kHBuild ? 0 : static_cast<size_t>(chunks) * kLanes *
                                      sizeof(T)) +
         kWarps * 32 * kTile * sizeof(T) +
         kWarps * kTile * kTile * sizeof(typename Elem<T>::Acc);
}

template <Orient O, typename T, Cut K, int kStep, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
    onehot_gather_kernel(const int32_t* __restrict__ roots,
                         const T* __restrict__ lit, Out* __restrict__ out,
                         int p) {
  static_assert(kStep % (kWarps * 32) == 0, "a step is whole warp rounds");
  using F = Frags<O, T>;
  using Acc = typename F::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunks = p / kLanes;
  const int slices = chunks / kTile;  // 16-deep k-slices of the contraction
  const long long first = static_cast<long long>(blockIdx.x) * kStep;
  const long long block = first / p;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab_elems = K == Cut::kHBuild ? 0 : chunks * kLanes;
  T* slab = reinterpret_cast<T*>(smem);
  T* hot = slab + slab_elems + warp * 32 * kTile;
  Acc* scratch =
      reinterpret_cast<Acc*>(slab + slab_elems + kWarps * 32 * kTile) +
      warp * kTile * kTile;
  if constexpr (K != Cut::kHBuild)
    stage_slab<O>(slab, lit + block * slab_elems, chunks);
  __syncthreads();

  T* run = hot + lane * kTile;
  for (int base = warp * 32; base < kStep; base += kWarps * 32) {
    const long long i = first + base + lane;
    const int r = roots[i];
    const int hi = r >> 7, lo = r & (kLanes - 1);
    int value = 0;
    if constexpr (K == Cut::kHBuild) {
      for (int kc = 0; kc < slices; ++kc) {
        one_hot_run(run, hi - kc * kTile);
        __syncwarp();
        value += Elem<T>::sum_run(run);
        __syncwarp();
      }
      value += lo;
    } else {
      typename F::Sum acc[2][kLanes / kTile];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int n = 0; n < kLanes / kTile; ++n)
          wmma::fill_fragment(acc[f][n], Acc(0));
      for (int kc = 0; kc < slices; ++kc) {
        one_hot_run(run, hi - kc * kTile);
        __syncwarp();
        typename F::Hot h[2];
        wmma::load_matrix_sync(h[0], hot, kTile);
        wmma::load_matrix_sync(h[1], hot + kTile * kTile, kTile);
#pragma unroll
        for (int n = 0; n < kLanes / kTile; ++n) {
          typename F::Lit l;
          wmma::load_matrix_sync(l, F::lit_tile(slab, kc, n), kTile);
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            if constexpr (O == Orient::kHL)
              wmma::mma_sync(acc[f][n], h[f], l, acc[f][n]);
            else
              wmma::mma_sync(acc[f][n], l, h[f], acc[f][n]);
          }
        }
        __syncwarp();
      }
      const int j = lane & (kTile - 1);
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int n = 0; n < kLanes / kTile; ++n) {
          wmma::store_matrix_sync(scratch, acc[f][n], kTile,
                                  wmma::mem_row_major);
          __syncwarp();
          if ((lane >> 4) == f) {
            if constexpr (K == Cut::kFull) {
              if ((lo >> 4) == n)
                value = Elem<T>::value(F::at(scratch, j, lo & (kTile - 1))) +
                        Elem<T>::kBias;
            } else {
#pragma unroll
              for (int t = 0; t < kTile; ++t)
                value += Elem<T>::value(F::at(scratch, j, t)) + Elem<T>::kBias;
            }
          }
          __syncwarp();
        }
    }
    out[i] = static_cast<Out>(value);
  }
}

struct Variant {
  const void* fn;
  int orient, elem_bytes, cut, step, out_bytes;
  size_t (*smem)(int chunks);
  cudaError_t (*launch)(const void* roots, const void* lit, void* out,
                        long long blocks, int p, cudaStream_t stream);
};

template <Orient O, typename T, Cut K, int S, typename Out>
struct Inst {
  static size_t smem(int chunks) { return smem_bytes<O, T, K>(chunks); }
  static cudaError_t launch(const void* roots, const void* lit, void* out,
                            long long blocks, int p, cudaStream_t stream) {
    const void* fn =
        reinterpret_cast<const void*>(onehot_gather_kernel<O, T, K, S, Out>);
    const size_t bytes = smem(p / kLanes);
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    onehot_gather_kernel<O, T, K, S, Out>
        <<<static_cast<unsigned>(blocks * (p / S)), kThreads, bytes, stream>>>(
            static_cast<const int32_t*>(roots), static_cast<const T*>(lit),
            static_cast<Out*>(out), p);
    return cudaGetLastError();
  }
  static Variant describe() {
    return {reinterpret_cast<const void*>(onehot_gather_kernel<O, T, K, S, Out>),
            static_cast<int>(O), static_cast<int>(sizeof(T)),
            static_cast<int>(K), S, static_cast<int>(sizeof(Out)), &smem,
            &launch};
  }
};

using Bf16 = __nv_bfloat16;
using S8 = signed char;

// The instantiations, in the order of profiles/onehot_gather.py's KERNELS.
bool variant_of(int id, Variant* v) {
  switch (id) {
    case 0: *v = Inst<Orient::kHL, Bf16, Cut::kFull, 2048, uint8_t>::describe(); return true;
    case 1: *v = Inst<Orient::kHL, Bf16, Cut::kFull, 2048, int32_t>::describe(); return true;
    case 2: *v = Inst<Orient::kHL, Bf16, Cut::kNoMask, 2048, int32_t>::describe(); return true;
    case 3: *v = Inst<Orient::kHL, Bf16, Cut::kHBuild, 2048, int32_t>::describe(); return true;
    case 4: *v = Inst<Orient::kHL, Bf16, Cut::kFull, 512, int32_t>::describe(); return true;
    case 5: *v = Inst<Orient::kHL, Bf16, Cut::kFull, 1024, int32_t>::describe(); return true;
    case 6: *v = Inst<Orient::kLtHt, Bf16, Cut::kFull, 4096, int32_t>::describe(); return true;
    case 7: *v = Inst<Orient::kLtHt, S8, Cut::kFull, 4096, int32_t>::describe(); return true;
    case 8: *v = Inst<Orient::kLtHt, S8, Cut::kFull, 2048, int32_t>::describe(); return true;
    default: return false;
  }
}

constexpr int kVariants = 9;

}  // namespace

extern "C" int onehot_gather_variant_count() { return kVariants; }

// The compile-time parameters of instantiation `id`: orientation (0 H · L,
// 1 Lᵀ · Hᵀ), element bytes (2 bf16, 1 s8), cut (0 full, 1 nomask, 2
// hbuild), outputs a CTA, output bytes (1 u8, 4 i32); cudaErrorInvalidValue
// for an unknown id.
extern "C" int onehot_gather_describe(int id, int* orient, int* elem_bytes,
                                      int* cut, int* step, int* out_bytes) {
  Variant v;
  if (!variant_of(id, &v)) return cudaErrorInvalidValue;
  *orient = v.orient;
  *elem_bytes = v.elem_bytes;
  *cut = v.cut;
  *step = v.step;
  *out_bytes = v.out_bytes;
  return cudaSuccess;
}

// roots: blocks × p int32; lit: the literal operand of the variant (blocks ×
// (p / 128) × 128 for H · L, blocks × 128 × (p / 128) for Lᵀ · Hᵀ, bf16 or
// s8; not read by hbuild); out: blocks × p of the output type; all
// contiguous.  Launches on `stream` and returns the first CUDA error of the
// shared-memory attribute or the launch (0 on success);
// cudaErrorInvalidValue for an unknown id, blocks < 0, p not a positive
// multiple of 2,048 and of the variant's step, p > 65,536 (the literal slab
// must fit in shared memory), or a grid past 2³¹ − 1 CTAs;
// cudaErrorMisalignedAddress for literals off a 16-byte boundary or roots
// off a 4-byte one.  Never synchronises.
extern "C" int onehot_gather_launch(int id, const void* roots, const void* lit,
                                    void* out, long long blocks, int p,
                                    void* stream) {
  Variant v;
  if (!variant_of(id, &v) || blocks < 0 || p <= 0 || p % (kTile * kLanes) ||
      p / kLanes > kMaxChunks || p % v.step)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lit) % 16 ||
      reinterpret_cast<uintptr_t>(roots) % 4)
    return cudaErrorMisalignedAddress;
  if (blocks == 0) return cudaSuccess;
  if (blocks * (p / v.step) > INT_MAX) return cudaErrorInvalidValue;
  return v.launch(roots, lit, out, blocks, p,
                  static_cast<cudaStream_t>(stream));
}

// Registers per thread, shared memory per CTA (static and dynamic, at C =
// 512) and resident CTAs per SM of instantiation `id`; returns the first
// CUDA error.
extern "C" int onehot_gather_attributes(int id, int* regs, int* smem,
                                        int* ctas) {
  Variant v;
  if (!variant_of(id, &v)) return cudaErrorInvalidValue;
  const size_t bytes = v.smem(kMaxChunks);
  cudaError_t err = cudaFuncSetAttribute(
      v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, v.fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + bytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, v.fn, kThreads,
                                                       bytes);
}

extern "C" const char* onehot_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
