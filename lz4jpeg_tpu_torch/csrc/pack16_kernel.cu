// Packed16 run-length compaction for Hopper (sm_90a): (N, L) values →
// front-compacted run words (count - 1) << 10 | (value + 512), zero slots past
// the runs, and lengths = 2 · runs.  L is a power of two ≤ 64.
//
// K4, pack16_rows: replaces lz4jpeg_tpu/ops/pallas_rle.py::_rle_pack16_kernel.
// The TPU kernel built each run's rank with a bf16 MXU prefix matmul and
// moved the runs to the front on a 6-stage lane-roll butterfly, because
// Mosaic has no cross-lane scan.  A warp has one.  Each lane loads 16 bytes
// of a block row, V = min(L, 8) int16 or min(L, 4) int32 values, so L / V
// lanes form the row's segment and one warp instruction reads 32 / (L / V)
// consecutive rows; a warp issues the loads of kDepth such passes before it
// decodes any, so several loads a lane are in flight.  A lane finds its run
// starts in registers (its first value against the previous lane's last,
// taken by one segmented shuffle), a segmented shuffle scan of the lanes'
// start counts gives each start's rank, and the starts' (position, value)
// pairs are compacted by rank into shared memory.  Each lane then reads its
// V output slots back as vectors: slot m of a row with `runs` runs holds
// the word of run m, whose count is the gap to the next start (or to L),
// and 0 past the runs.  The words leave as one 2·V-byte store a lane, the
// lengths of a pass's rows as one coalesced store.
//
// K5, pack16_kt: replaces _rle_pack16_kt_kernel (the same compaction fed
// the plane layout (R, K, C), K block positions along the middle axis).
// One thread per block column scans its K values serially (a warp's loads
// of [r, k, c .. c + 31] are coalesced), writes its K words to a 32 × K tile
// in shared memory, and the warp then stores the tile's 32 consecutive
// output rows as one contiguous run of 32 · K words.
//
// What bounds them: one read of the values and one write of the words and
// lengths, 2 (int16) or 4 (int32) + 2 + 4/L bytes per value.  At 2048²,
// batch 64 (4,194,304 luma blocks of 64) that is 1.09 GB in int16, 0.33 ms
// at the 3.35 TB/s of an H100 SXM's data sheet (700 W), and 1.63 GB in
// int32, 0.49 ms.  Both kernels are memory-bound; the integer work per value
// is a handful of warp instructions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;  // K4: warps per 256-thread CTA
constexpr int kKtWarps = 4;   // K5: 32-column tiles per 128-thread CTA
constexpr long long kMaxCtas = 1 << 16;

__device__ __forceinline__ uint16_t pack_word(int count, int32_t value) {
  return static_cast<uint16_t>(((count - 1) << 10) | (value + 512));
}

// V consecutive elements of `bytes` bytes each as a single load or store.
template <int bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

template <typename T, int V>
union LaneOf {
  typename Raw<sizeof(T) * V>::type v;
  T e[V];
};

constexpr int kDepth = 4;  // K4: passes whose loads a warp issues at once

template <typename T, int L>
__global__ void __launch_bounds__(kRowWarps * 32)
    pack16_rows_kernel(const T* __restrict__ values, uint16_t* __restrict__ packed,
                       int32_t* __restrict__ lengths, long long n_rows) {
  constexpr int V0 = 16 / static_cast<int>(sizeof(T));
  constexpr int V = L < V0 ? L : V0;  // values per lane
  constexpr int S = L / V;            // lanes per block row
  constexpr int R = 32 / S;           // block rows per warp pass
  using In = LaneOf<T, V>;
  using Out = LaneOf<uint16_t, V>;
  // Per warp: the starts' positions and values, slot row · L + rank.
  __shared__ alignas(16) int16_t start_pos[kRowWarps][32 * V];
  __shared__ alignas(16) int16_t start_val[kRowWarps][32 * V];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % S;  // lane within the row's segment
  const int r = lane / S;    // row within the pass
  int16_t* pos = start_pos[warp];
  int16_t* val = start_val[warp];
  const long long step = static_cast<long long>(gridDim.x) * kRowWarps;
  for (long long group = static_cast<long long>(blockIdx.x) * kRowWarps + warp;
       group * kDepth * R < n_rows; group += step) {
    In x[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long row = (group * kDepth + d) * R + r;
      x[d].v = typename Raw<sizeof(T) * V>::type{};
      if (row < n_rows)
        x[d].v = *reinterpret_cast<const decltype(x[d].v)*>(values + row * L +
                                                            sub * V);
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long row = (group * kDepth + d) * R + r;
      int32_t v[V];
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = static_cast<int32_t>(x[d].e[j]);
      // The previous lane's last value (a segment's first lane gets its own).
      const int32_t prev = __shfl_up_sync(kFull, v[V - 1], 1, S);
      bool start[V];
      int count = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        start[j] = j == 0 ? sub == 0 || v[0] != prev : v[j] != v[(j + V - 1) % V];
        count += start[j];
      }
      int scan = count;  // segmented inclusive scan of the start counts
#pragma unroll
      for (int e = 1; e < S; e <<= 1) {
        const int t = __shfl_up_sync(kFull, scan, e, S);
        if (sub >= e) scan += t;
      }
      const int runs = __shfl_sync(kFull, scan, S - 1, S);
      int rank = r * L + scan - count;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (start[j]) {
          pos[rank] = static_cast<int16_t>(sub * V + j);
          val[rank] = static_cast<int16_t>(v[j]);
          ++rank;
        }
      }
      __syncwarp();
      Out p, q;  // this lane's slots' start positions and values
      p.v = *reinterpret_cast<const decltype(p.v)*>(pos + r * L + sub * V);
      q.v = *reinterpret_cast<const decltype(q.v)*>(val + r * L + sub * V);
      // The start of slot sub·V + V, the next lane's first slot.
      const int after = __shfl_down_sync(kFull, static_cast<int>(
          static_cast<int16_t>(p.e[0])), 1, S);
      Out o;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int m = sub * V + j;
        const int next = m + 1 >= runs ? L
                         : j + 1 < V   ? static_cast<int16_t>(p.e[(j + 1) % V])
                                       : after;
        // Only the low 16 bits of value + 512 reach the word, so the value's
        // int16 bits (all that shared memory keeps of an int32) suffice.
        o.e[j] = m < runs ? pack_word(next - static_cast<int16_t>(p.e[j]),
                                      static_cast<int16_t>(q.e[j]))
                          : 0;
      }
      __syncwarp();  // the next pass overwrites the starts
      if (row < n_rows) {
        *reinterpret_cast<decltype(o.v)*>(packed + row * L + sub * V) = o.v;
        if (sub == 0) lengths[row] = 2 * runs;
      }
    }
  }
}

template <typename T, int kSeg>
__global__ void __launch_bounds__(kKtWarps * 32)
    pack16_kt_kernel(const T* __restrict__ zz, uint16_t* __restrict__ packed,
                     int32_t* __restrict__ lengths, long long rows,
                     long long cols) {
  // Row stride kSeg + 1 words: a lane's slot j sits in bank (lane + j) % 32
  // when every lane writes the same slot.
  __shared__ uint32_t tile[kKtWarps][32][kSeg + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* my = tile[warp][lane];
  const long long col_tiles = (cols + 31) / 32;
  const long long total = rows * col_tiles;
  const long long step = static_cast<long long>(gridDim.x) * kKtWarps;
  for (long long w = static_cast<long long>(blockIdx.x) * kKtWarps + warp;
       w < total; w += step) {
    const long long r = w / col_tiles;
    const long long c0 = (w % col_tiles) * 32;
    const int width = static_cast<int>(min(32LL, cols - c0));
    if (lane < width) {
      const T* x = zz + r * kSeg * cols + c0 + lane;
      int32_t v[kSeg];
#pragma unroll
      for (int k = 0; k < kSeg; ++k) v[k] = static_cast<int32_t>(x[k * cols]);
      int runs = 0;
      int begin = 0;
#pragma unroll
      for (int k = 1; k < kSeg; ++k) {
        if (v[k] != v[k - 1]) {
          my[runs++] = pack_word(k - begin, v[k - 1]);
          begin = k;
        }
      }
      my[runs++] = pack_word(kSeg - begin, v[kSeg - 1]);
      for (int k = runs; k < kSeg; ++k) my[k] = 0;
      lengths[r * cols + c0 + lane] = 2 * runs;
    }
    __syncwarp();
    // Rows r·C + c0 … r·C + c0 + width - 1 are consecutive in the output.
    uint16_t* out = packed + (r * cols + c0) * kSeg;
    for (int i = lane; i < width * kSeg; i += 32) {
      out[i] = static_cast<uint16_t>(tile[warp][i / kSeg][i % kSeg]);
    }
    __syncwarp();
  }
}

unsigned grid_for(long long units, int per_cta) {
  const long long ctas = (units + per_cta - 1) / per_cta;
  return static_cast<unsigned>(ctas < kMaxCtas ? ctas : kMaxCtas);
}

template <typename T>
cudaError_t launch_kt(const void* zz, void* packed, void* lengths,
                      long long rows, int seg, long long cols,
                      cudaStream_t s) {
  const unsigned grid = grid_for(rows * ((cols + 31) / 32), kKtWarps);
  const T* in = static_cast<const T*>(zz);
  uint16_t* out = static_cast<uint16_t*>(packed);
  int32_t* lens = static_cast<int32_t*>(lengths);
  switch (seg) {
#define PACK16_KT_CASE(S)                                                   \
  case S:                                                                   \
    pack16_kt_kernel<T, S><<<grid, kKtWarps * 32, 0, s>>>(in, out, lens,    \
                                                          rows, cols);      \
    break;
    PACK16_KT_CASE(1)
    PACK16_KT_CASE(2)
    PACK16_KT_CASE(4)
    PACK16_KT_CASE(8)
    PACK16_KT_CASE(16)
    PACK16_KT_CASE(32)
    PACK16_KT_CASE(64)
#undef PACK16_KT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int L>
cudaError_t launch_rows_seg(const T* values, uint16_t* packed,
                            int32_t* lengths, long long n_rows,
                            cudaStream_t s) {
  constexpr int V0 = 16 / static_cast<int>(sizeof(T));
  constexpr int R = 32 / (L / (L < V0 ? L : V0));  // rows per warp pass
  const unsigned grid = grid_for((n_rows + kDepth * R - 1) / (kDepth * R),
                                 kRowWarps);
  pack16_rows_kernel<T, L><<<grid, kRowWarps * 32, 0, s>>>(values, packed,
                                                           lengths, n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rows(const void* values, void* packed, void* lengths,
                        long long n_rows, int seg, cudaStream_t s) {
  const T* in = static_cast<const T*>(values);
  uint16_t* out = static_cast<uint16_t*>(packed);
  int32_t* lens = static_cast<int32_t*>(lengths);
  switch (seg) {
    case 1: return launch_rows_seg<T, 1>(in, out, lens, n_rows, s);
    case 2: return launch_rows_seg<T, 2>(in, out, lens, n_rows, s);
    case 4: return launch_rows_seg<T, 4>(in, out, lens, n_rows, s);
    case 8: return launch_rows_seg<T, 8>(in, out, lens, n_rows, s);
    case 16: return launch_rows_seg<T, 16>(in, out, lens, n_rows, s);
    case 32: return launch_rows_seg<T, 32>(in, out, lens, n_rows, s);
    case 64: return launch_rows_seg<T, 64>(in, out, lens, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// values: (n_rows, seg) int16 (elem_bytes 2) or int32 (4); packed: (n_rows,
// seg) uint16; lengths: (n_rows,) int32; all contiguous, values and packed
// 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int pack16_rows_launch(const void* values, int elem_bytes,
                                  void* packed, void* lengths,
                                  long long n_rows, int seg, void* stream) {
  if (seg < 1 || seg > 64 || (seg & (seg - 1))) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(values) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return cudaErrorMisalignedAddress;
  if (n_rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch_rows<int16_t>(values, packed, lengths, n_rows, seg, s);
  if (elem_bytes == 4)
    return launch_rows<int32_t>(values, packed, lengths, n_rows, seg, s);
  return cudaErrorInvalidValue;
}

// zz: (rows, seg, cols) int16 or int32; packed: (rows · cols, seg) uint16;
// lengths: (rows · cols,) int32; all contiguous.
extern "C" int pack16_kt_launch(const void* zz, int elem_bytes, void* packed,
                                void* lengths, long long rows, int seg,
                                long long cols, void* stream) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch_kt<int16_t>(zz, packed, lengths, rows, seg, cols, s);
  if (elem_bytes == 4)
    return launch_kt<int32_t>(zz, packed, lengths, rows, seg, cols, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* pack16_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
