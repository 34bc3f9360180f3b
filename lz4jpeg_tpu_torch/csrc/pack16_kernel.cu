// Packed16 run-length compaction for Hopper (sm_90a): (N, L) values →
// front-compacted run words (count - 1) << 10 | (value + 512), zero slots past
// the runs, and lengths = 2 · runs.  L is a power of two ≤ 64.
//
// K4, pack16_rows: replaces lz4jpeg_tpu/ops/pallas_rle.py::_rle_pack16_kernel.
// The TPU kernel built each run's rank with a bf16 MXU prefix matmul and
// moved the runs to the front on a 6-stage lane-roll butterfly, because
// Mosaic has no cross-lane scan.  A warp has one: one warp per block row,
// lane m holds x[m] (and x[m + 32] when L = 64), the run starts are one or
// two __ballot_sync masks, a start's rank is __popc of the mask below it and
// its count the distance to the next set bit (__ffsll) or to L.  Each start
// writes its word to packed[rank] and each slot at or past the run count
// writes 0, so every output slot is written once, from registers.
//
// K5, pack16_kt: replaces _rle_pack16_kt_kernel (the same compaction fed
// the plane layout (R, K, C), K block positions along the middle axis).
// One thread per block column scans its K values serially (a warp's loads
// of [r, k, c .. c + 31] are coalesced), writes its K words to a 32 × K tile
// in shared memory, and the warp then stores the tile's 32 consecutive
// output rows as one contiguous run of 32 · K words.
//
// What bounds them: one read of the values and one write of the words and
// lengths, about 2 + 2 + 4/L bytes per int16 value.  At 2048², batch 64
// (4,194,304 luma blocks of 64) that is 1.09 GB, 0.33 ms at the 3.35 TB/s
// of an H100 SXM's data sheet (700 W).
// Both kernels are memory-bound; the integer work per value is a handful of
// warp instructions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWarps = 8;  // K4: block rows per 256-thread CTA
constexpr int kKtWarps = 4;   // K5: 32-column tiles per 128-thread CTA
constexpr long long kMaxCtas = 1 << 16;

__device__ __forceinline__ uint16_t pack_word(int count, int32_t value) {
  return static_cast<uint16_t>(((count - 1) << 10) | (value + 512));
}

// Emits slot m's share of a row: its word if it starts a run, a zero if the
// row has no run of rank m.
__device__ __forceinline__ void emit(int m, bool start, int32_t v,
                                     uint64_t mask, int seg, int runs,
                                     uint16_t* out) {
  if (start) {
    const int rank = __popcll(mask & ((1ull << m) - 1));
    const uint64_t above = m == 63 ? 0ull : mask & (~0ull << (m + 1));
    const int next = above ? __ffsll(static_cast<long long>(above)) - 1 : seg;
    out[rank] = pack_word(next - m, v);
  }
  if (m < seg && m >= runs) out[m] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
    pack16_rows_kernel(const T* __restrict__ values, uint16_t* __restrict__ packed,
                       int32_t* __restrict__ lengths, long long n_rows, int seg) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kRowWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kRowWarps +
                       (threadIdx.x >> 5);
       row < n_rows; row += step) {
    const T* x = values + row * seg;
    const bool in0 = lane < seg;
    const bool in1 = lane + 32 < seg;
    const int32_t v0 = in0 ? static_cast<int32_t>(x[lane]) : 0;
    const int32_t v1 = in1 ? static_cast<int32_t>(x[lane + 32]) : 0;
    const int32_t p0 = __shfl_up_sync(kFull, v0, 1);
    const int32_t last0 = __shfl_sync(kFull, v0, 31);
    int32_t p1 = __shfl_up_sync(kFull, v1, 1);
    if (lane == 0) p1 = last0;
    const bool s0 = in0 && (lane == 0 || v0 != p0);
    const bool s1 = in1 && v1 != p1;
    const uint64_t mask =
        static_cast<uint64_t>(__ballot_sync(kFull, s0)) |
        (static_cast<uint64_t>(__ballot_sync(kFull, s1)) << 32);
    const int runs = __popcll(mask);
    uint16_t* out = packed + row * seg;
    emit(lane, s0, v0, mask, seg, runs, out);
    emit(lane + 32, s1, v1, mask, seg, runs, out);
    if (lane == 0) lengths[row] = 2 * runs;
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

}  // namespace

// values: (n_rows, seg) int16 (elem_bytes 2) or int32 (4); packed: (n_rows,
// seg) uint16; lengths: (n_rows,) int32; all contiguous.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int pack16_rows_launch(const void* values, int elem_bytes,
                                  void* packed, void* lengths,
                                  long long n_rows, int seg, void* stream) {
  if (seg < 1 || seg > 64 || (seg & (seg - 1))) return cudaErrorInvalidValue;
  if (n_rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(n_rows, kRowWarps);
  if (elem_bytes == 2) {
    pack16_rows_kernel<int16_t><<<grid, kRowWarps * 32, 0, s>>>(
        static_cast<const int16_t*>(values), static_cast<uint16_t*>(packed),
        static_cast<int32_t*>(lengths), n_rows, seg);
  } else if (elem_bytes == 4) {
    pack16_rows_kernel<int32_t><<<grid, kRowWarps * 32, 0, s>>>(
        static_cast<const int32_t*>(values), static_cast<uint16_t*>(packed),
        static_cast<int32_t*>(lengths), n_rows, seg);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
