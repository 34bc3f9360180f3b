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
//   * the outputs a CTA takes between two checks of its block (the probe's
//     grid step): 2,048 for g1 and g2, T for g3, R · 128 for g4;
//   * the output type: u8 (g1) or i32.
// The nine instantiations are the probes' ten rows less one: g2's full row
// and g3's T = 2,048 row are the same kernel (a GPU has no sublane or lane
// placement; g2 differs by the torch transposes around the call).
//
// Design.  mma.sync through inline PTX: m16n8k16 (bf16, f32 accumulate)
// and m16n8k32 (s8, s32 accumulate).  A warp takes 64 outputs and walks
// the contraction in 32-byte k-slices (16 bf16 or 32 s8) twice, once for
// each half of the 128 literal lanes, with a 64 × 64 tile of accumulators
// (4 × 8 fragments, 128 a thread): 32 mma a slice, every slice multiplied.
//   * The one-hot is built in registers: each lane knows from the PTX
//     fragment layout which outputs (8j + lane / 4, j < 8) and which k
//     (k_per_register · (lane % 4), and 8 or 16 further) its one-hot
//     registers hold, so a register is `one << shift` with shift =
//     (hi − k0) · bits (``one_at``; PTX clamps a shift past 31 to 0), the
//     hi of its 8 outputs read once a warp group.  No one-hot element goes
//     through shared memory.
//   * The literals come from a slab staged in shared memory as 4,096-byte
//     k-slices of 128 lanes × 32 bytes (``chunk_offset``): for H · L each
//     k row of 256 bytes with its 16-byte chunks XOR-swizzled by the row's
//     low 3 bits, read as B fragments by ldmatrix.x4.trans (8 k rows of one
//     chunk fall in 8 distinct bank groups); for Lᵀ · Hᵀ each lane row's
//     32 bytes with its two halves swapped by bit 2 of the lane, read as A
//     fragments by ldmatrix.x4 (8 rows 32 bytes apart, conflict-free); the
//     s8 fragments as b16 pairs.  A literal fragment feeds 4 mma (64 bytes
//     a mma), and the next slice's fragments load while this slice's mma
//     run (two register buffers).
//   * Persistent CTAs: the resident CTAs only, each walking a contiguous
//     run of steps and staging a block's slab (16-byte cp.async) only when
//     its run enters the block, as the TPU's BlockSpec skipped the copy of
//     an unchanged block; a warp's next group of roots is prefetched into
//     L2 while it multiplies.
//   * The epilogue works in registers: the full cut's lane r & 127 lies in
//     one accumulator of one lane (``pick8`` selects it there, shuffles
//     bring it to the lane that stores the output, 32 consecutive outputs a
//     store); nomask sums its row in registers and over its quad by
//     shfl_xor; hbuild sums the one-hot registers as bf16 pairs.  No
//     accumulator goes through shared memory.
//
// What bounds it: the product, 2 · outputs · C · 128 operations: at 64
// blocks of 65,536 (4 MiB of text, C = 512) 5.498e11, 0.5559 ms at the
// data sheet's 989 TFLOP/s dense bf16, 0.2778 ms at 1,979 TOPS dense int8;
// those are wgmma rates, which mma.sync does not reach.  hbuild moves roots
// and outputs only (33.6 MB, 0.0100 ms), and its 2.1e9 compares bound it
// harder.

#include <climits>
#include <cstdint>
#include <cstring>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kLanes = 128;       // literal lanes a chunk: r & 127
constexpr int kMaxChunks = 512;   // C of a 65,536-byte block
constexpr int kQuantum = 16 * kLanes;  // P holds whole 16-deep k-slices
constexpr int kGroup = 64;        // outputs a warp
constexpr int kSliceBytes = 32;   // k bytes a slice: 16 bf16 or 32 s8
constexpr int kSliceSlab = kLanes * kSliceBytes;  // slab bytes a slice

enum class Orient { kHL = 0, kLtHt = 1 };
enum class Cut { kFull = 0, kNoMask = 1, kHBuild = 2 };

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr uint32_t kOne = 0x3F80u;  // the bits of bf16 1.0
  static constexpr int kBits = 16;  // bits an element
  static constexpr int kPer = 2;    // consecutive k a register holds
  static constexpr int kBias = 0;
  __device__ static int value(float v) { return __float2int_rz(v); }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Elem<signed char> {
  using Acc = int;
  static constexpr uint32_t kOne = 1u;
  static constexpr int kBits = 8;
  static constexpr int kPer = 4;
  static constexpr int kBias = 128;  // literals ride as v − 128
  __device__ static int value(int v) { return v; }
  __device__ static void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// `one` shifted left by `shift` bits: a one-hot register whose first
// element lies `shift` bits below the one; 0 for a shift outside [0, 32),
// since PTX clamps the unsigned shift amount to 32.
__device__ __forceinline__ uint32_t one_at(uint32_t one, int shift) {
  uint32_t v;
  asm("shl.b32 %0, %1, %2;" : "=r"(v) : "r"(one), "r"(shift));
  return v;
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t bits) {
  __nv_bfloat162 v;
  memcpy(&v, &bits, sizeof(v));
  return v;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The slab byte of the 16-byte chunk `c` of literal row `row`: for H · L a
// k row of 128 lanes (256 bytes in bf16), its chunks XOR-swizzled by the
// row's low 3 bits; for Lᵀ · Hᵀ a lane row of the k bytes, chunk c in
// k-slice c / 2, whose 128 rows of 32 bytes lie together, the two halves
// of a row swapped when bit 2 of the row is set.
template <Orient O>
__host__ __device__ constexpr int chunk_offset(int row, int c) {
  return O == Orient::kHL
             ? row * 256 + 16 * (c ^ (row & 7))
             : (c >> 1) * kSliceSlab + row * kSliceBytes +
                   16 * ((c & 1) ^ ((row >> 2) & 1));
}

template <typename T>
__host__ __device__ constexpr int slices_of(int chunks) {
  return (chunks * static_cast<int>(sizeof(T)) + kSliceBytes - 1) /
         kSliceBytes;
}

// One block's literal operand (chunks × 128 for H · L, 128 × chunks for
// Lᵀ · Hᵀ, row-major in device memory) into the slab by 16-byte cp.async;
// an s8 slab whose last k-slice is half full gets zeros in the other half.
template <Orient O, typename T>
__device__ void stage_slab(uint32_t slab, const T* src, int chunks) {
  const int rows = O == Orient::kHL ? chunks : kLanes;
  const int row_chunks =
      (O == Orient::kHL ? kLanes : chunks) * static_cast<int>(sizeof(T)) / 16;
  const int padded = O == Orient::kHL ? row_chunks : 2 * slices_of<T>(chunks);
  const char* g = reinterpret_cast<const char*>(src);
  for (int q = threadIdx.x; q < rows * padded; q += kThreads) {
    const int row = q / padded, c = q - row * padded;
    const uint32_t dst = slab + chunk_offset<O>(row, c);
    if (c < row_chunks) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                   "l"(g + (static_cast<long long>(row) * row_chunks + c) * 16));
    } else {
      asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(dst),
                   "r"(0));
    }
  }
  asm volatile("cp.async.wait_all;");
}

// v[i] for a runtime i < 8, by a tree of selects (no local memory).
template <typename A>
__device__ __forceinline__ A pick8(const A (&v)[8], int i) {
  const A a0 = i & 1 ? v[1] : v[0], a1 = i & 1 ? v[3] : v[2];
  const A a2 = i & 1 ? v[5] : v[4], a3 = i & 1 ? v[7] : v[6];
  const A b0 = i & 2 ? a1 : a0, b1 = i & 2 ? a3 : a2;
  return i & 4 ? b1 : b0;
}

// The k-slices walked with two fragment buffers: slice s + 1's fragments
// load while slice s's mma run.
template <typename F, typename Load, typename Compute>
__device__ __forceinline__ void walk_slices(int slices, F& f0, F& f1,
                                            Load load, Compute compute) {
  load(f0, 0);
  int s = 0;
#pragma unroll 1
  for (; s + 2 <= slices; s += 2) {
    load(f1, s + 1);
    compute(f0, s);
    if (s + 2 < slices) load(f0, s + 2);
    compute(f1, s + 1);
  }
  if (s < slices) compute(f0, s);
}

// The product of one pass: the warp's 64 outputs against the literal lanes
// 64h .. 64h + 63, all `slices` k-slices, into acc[m-tile][n-tile][c].  For
// H · L the m-tiles are outputs, the n-tiles lanes; for Lᵀ · Hᵀ the
// reverse.  d[j] is the one-hot shift of output 8j + lane / 4 at slice 0.
template <Orient O, typename T>
__device__ __forceinline__ void product(typename Elem<T>::Acc (&acc)[4][8][4],
                                        uint32_t slab, int slices, int h,
                                        const int (&d)[8]) {
  using E = Elem<T>;
  const int lane = threadIdx.x & 31;
  // ldmatrix: lane l gives row l % 8 of matrix l / 8 (rows 8 · (l / 8 % 2)
  // on, chunk l / 16 of the pair or half).
  const int row = 8 * ((lane >> 3) & 1) + (lane & 7);
  if constexpr (O == Orient::kHL) {
    uint32_t addr[4];  // n-tiles 2q and 2q + 1 of k rows 0-15 of slice 0
#pragma unroll
    for (int q = 0; q < 4; ++q)
      addr[q] = slab + chunk_offset<O>(row, 8 * h + 2 * q + (lane >> 4));
    uint32_t f0[8][2], f1[8][2];
    auto load = [&](uint32_t (&f)[8][2], int s) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t r[4];
        ldsm_x4_trans(r, addr[q] + s * kSliceSlab);
        f[2 * q][0] = r[0];
        f[2 * q][1] = r[1];
        f[2 * q + 1][0] = r[2];
        f[2 * q + 1][1] = r[3];
      }
    };
    auto compute = [&](const uint32_t (&f)[8][2], int s) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // rows g and g + 8 of the m-tile, k 2t.. and 2t + 8..
        const int r0 = d[2 * mt] - 256 * s, r1 = d[2 * mt + 1] - 256 * s;
        const uint32_t a[4] = {one_at(E::kOne, r0), one_at(E::kOne, r1),
                               one_at(E::kOne, r0 - 128),
                               one_at(E::kOne, r1 - 128)};
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) E::mma(acc[mt][nt], a, f[nt][0], f[nt][1]);
      }
    };
    walk_slices(slices, f0, f1, load, compute);
  } else {
    // m-tile mt: lanes 64h + 16mt + row, k half lane / 16 of the slice
    const uint32_t addr =
        slab + chunk_offset<O>(64 * h + row, lane >> 4);
    uint32_t f0[4][4], f1[4][4];
    auto load = [&](uint32_t (&f)[4][4], int s) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(f[mt], addr + mt * 16 * kSliceBytes + s * kSliceSlab);
    };
    auto compute = [&](const uint32_t (&f)[4][4], int s) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int shift = d[nt] - 256 * s;
        const uint32_t b0 = one_at(E::kOne, shift);
        const uint32_t b1 = one_at(E::kOne, shift - 128);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) E::mma(acc[mt][nt], f[mt], b0, b1);
      }
    };
    walk_slices(slices, f0, f1, load, compute);
  }
}

// One warp's 64 outputs: roots and out point at the first.  Lane L stores
// outputs L and 32 + L.
template <Orient O, typename T, Cut K, typename Out>
__device__ __forceinline__ void gather_group(uint32_t slab, int slices,
                                             const int32_t* __restrict__ roots,
                                             Out* __restrict__ out) {
  using E = Elem<T>;
  using Acc = typename E::Acc;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  int d[8];  // the one-hot shift of output 8j + g at slice 0
#pragma unroll
  for (int j = 0; j < 8; ++j)
    d[j] = ((__ldg(roots + 8 * j + g) >> 7) - E::kPer * t) * E::kBits;
  int lo_out[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) lo_out[u] = __ldg(roots + 32 * u + lane) & (kLanes - 1);
  Acc res[2] = {Acc(0), Acc(0)};

  if constexpr (K == Cut::kHBuild) {
    static_assert(O == Orient::kHL && sizeof(T) == 2, "hbuild is H · L bf16");
    // the A registers of rows 8j + g summed as bf16 pairs: 0 or 1 a row
    __nv_bfloat162 count[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) count[j] = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll 2
    for (int s = 0; s < slices; ++s) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t lo = one_at(E::kOne, d[j] - 256 * s);
        const uint32_t hi = one_at(E::kOne, d[j] - 256 * s - 128);
        count[j] = __hadd2(count[j], as_bf16x2(lo));
        count[j] = __hadd2(count[j], as_bf16x2(hi));
      }
    }
    float sum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum[j] = __low2float(count[j]) + __high2float(count[j]);
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __shfl_sync(0xffffffffu, sum[j], 4 * (lane & 7));
      if ((j & 3) == (lane >> 3)) res[j >> 2] = v;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
      out[32 * u + lane] = static_cast<Out>(E::value(res[u]) + lo_out[u]);
  } else {
    static_assert(O == Orient::kHL || K == Cut::kFull,
                  "Lᵀ · Hᵀ has the full cut only");
    float rowsum[8] = {};  // nomask: this lane's share of row 8j + g
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      Acc acc[4][8][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][b][c] = Acc(0);
      product<O, T>(acc, slab, slices, h, d);

      if constexpr (K == Cut::kNoMask) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            rowsum[j] += acc[j >> 1][nt][2 * (j & 1)] +
                         acc[j >> 1][nt][2 * (j & 1) + 1];
      } else if constexpr (O == Orient::kHL) {
        // output 8j + g, lane l = lo & 63 of the pass: m-tile j / 2, n-tile
        // l / 8, c = 2 (j % 2) + l % 2, in the lane of quad g with t =
        // (l / 2) % 4
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // lane (8j + g) % 32 stores output 8j + g and holds its lo
          const int l = __shfl_sync(0xffffffffu, lo_out[j >> 2],
                                    8 * (j & 3) + g) & 63;
          Acc v[8];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
            v[nt] = l & 1 ? acc[j >> 1][nt][2 * (j & 1) + 1]
                          : acc[j >> 1][nt][2 * (j & 1)];
          const Acc cand = pick8(v, l >> 3);
          const int u = j >> 2;
          const int src = 4 * (lane & 7) + ((lo_out[u] >> 1) & 3);
          const Acc got = __shfl_sync(0xffffffffu, cand, src);
          if ((j & 3) == (lane >> 3) && (lo_out[u] >> 6) == h) res[u] = got;
        }
      } else {
        // output o = 8nt + 2t + p, lane l = lo & 63 of the pass: m-tile
        // l / 16, c = 2 (l / 8 % 2) + p, in the lane of quad l % 8 with t =
        // (o / 2) % 4
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int l = __shfl_sync(0xffffffffu, lo_out[nt >> 2],
                                      8 * (nt & 3) + 2 * t + p) & 63;
            Acc v[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) v[i] = acc[i >> 1][nt][2 * (i & 1) + p];
            const Acc cand = pick8(v, l >> 3);
            const int u = nt >> 2;
            const int src = 4 * (lo_out[u] & 7) + ((lane >> 1) & 3);
            const Acc got = __shfl_sync(0xffffffffu, cand, src);
            if ((nt & 3) == (lane >> 3) && p == (lane & 1) &&
                (lo_out[u] >> 6) == h)
              res[u] = got;
          }
      }
    }
    if constexpr (K == Cut::kNoMask) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        rowsum[j] += __shfl_xor_sync(0xffffffffu, rowsum[j], 1);
        rowsum[j] += __shfl_xor_sync(0xffffffffu, rowsum[j], 2);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float v = __shfl_sync(0xffffffffu, rowsum[j], 4 * (lane & 7));
        if ((j & 3) == (lane >> 3)) res[j >> 2] = v;
      }
    }
    constexpr int kAdd = (K == Cut::kNoMask ? kLanes : 1) * E::kBias;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      out[32 * u + lane] = static_cast<Out>(E::value(res[u]) + kAdd);
  }
}

template <Orient O, typename T, Cut K>
__host__ __device__ constexpr size_t smem_bytes(int chunks) {
  return K == Cut::kHBuild
             ? 0
             : static_cast<size_t>(slices_of<T>(chunks)) * kSliceSlab;
}

// hbuild (no slab, 64 registers) runs 4 CTAs an SM: 2,048 steps over 528
// CTAs end within 3% of even, where 3 CTAs an SM left 16% of the last
// round idle.
template <Orient O, typename T, Cut K, int kStep, typename Out>
__global__ void __launch_bounds__(kThreads, K == Cut::kHBuild ? 4 : 1)
    onehot_gather_kernel(const int32_t* __restrict__ roots,
                         const T* __restrict__ lit, Out* __restrict__ out,
                         long long blocks, int p) {
  static_assert(kStep % (kWarps * kGroup) == 0, "a step is whole warp rounds");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t slab = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int chunks = p / kLanes;
  const int slices = slices_of<T>(chunks);
  const long long per_block = p / kStep;
  const long long steps = blocks * per_block;
  const long long end = steps * (blockIdx.x + 1) / gridDim.x;
  const int warp = threadIdx.x >> 5;
  long long staged = -1;
  for (long long st = steps * blockIdx.x / gridDim.x; st < end; ++st) {
    const long long block = st / per_block;
    if (K != Cut::kHBuild && block != staged) {
      __syncthreads();  // every warp is done with the last block's slab
      stage_slab<O>(slab, lit + block * chunks * kLanes, chunks);
      __syncthreads();
      staged = block;
    }
#pragma unroll 1
    for (int base = warp * kGroup; base < kStep; base += kWarps * kGroup) {
      const long long first = st * kStep + base;
      // The warp's next group, kWarps · 64 outputs on in this step or the
      // next: its roots into L2 while this group multiplies.
      const long long next = first + kWarps * kGroup;
      if (K != Cut::kHBuild && (threadIdx.x & 31) < 8 && next < end * kStep)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(
            roots + next + 8 * (threadIdx.x & 31)));
      gather_group<O, T, K>(slab, slices, roots + first, out + first);
    }
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
  static const void* fn() {
    return reinterpret_cast<const void*>(onehot_gather_kernel<O, T, K, S, Out>);
  }
  static size_t smem(int chunks) { return smem_bytes<O, T, K>(chunks); }
  // The resident CTAs, no more than the steps, each a contiguous run.
  static cudaError_t launch(const void* roots, const void* lit, void* out,
                            long long blocks, int p, cudaStream_t stream) {
    const size_t bytes = smem(p / kLanes);
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        fn(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn(),
                                                          kThreads, bytes);
    if (err != cudaSuccess) return err;
    const long long steps = blocks * (p / S);
    const long long resident = static_cast<long long>(sms) * per_sm;
    const long long ctas = steps < resident ? steps : resident;
    if (ctas <= 0) return cudaErrorInvalidConfiguration;
    onehot_gather_kernel<O, T, K, S, Out>
        <<<static_cast<unsigned>(ctas), kThreads, bytes, stream>>>(
            static_cast<const int32_t*>(roots), static_cast<const T*>(lit),
            static_cast<Out*>(out), blocks, p);
    return cudaGetLastError();
  }
  static Variant describe() {
    return {fn(), static_cast<int>(O), static_cast<int>(sizeof(T)),
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
// hbuild), outputs a CTA takes between two checks of its block, output
// bytes (1 u8, 4 i32); cudaErrorInvalidValue for an unknown id.
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
// shared-memory attribute, the device and occupancy queries or the launch
// (0 on success); cudaErrorInvalidValue for an unknown id, blocks < 0, p
// not a positive multiple of 2,048 and of the variant's step, p > 65,536
// (the literal slab must fit in shared memory), or more than 2³¹ − 1 steps;
// cudaErrorMisalignedAddress for literals off a 16-byte boundary or roots
// off a 4-byte one.  Never synchronises.
extern "C" int onehot_gather_launch(int id, const void* roots, const void* lit,
                                    void* out, long long blocks, int p,
                                    void* stream) {
  Variant v;
  if (!variant_of(id, &v) || blocks < 0 || p <= 0 || p % kQuantum ||
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
