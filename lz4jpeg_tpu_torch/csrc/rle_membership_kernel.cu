// Packed16 run-length decode by interval membership, for Hopper (sm_90a):
// (N, L) packed16 words (count - 1) << 10 | (value + 512) and (N,) symbol
// lengths -> (N, out_size) int32 values.  Slots at or past lengths // 2
// count 0; run k covers [begin_k, end_k) with end the inclusive prefix sum
// of the counts; output position q takes the sum of the values of the runs
// whose interval holds q (one run or none: the intervals are disjoint), so
// positions past the runs are 0 and runs past out_size are cut.
//
// Replaces profiles/pallas_rle_decode.py::_decode_kernel (:26;
// rle_decode_packed16_pallas :52, pallas_call :62), the TPU candidate that
// built the (T, out_size, L) membership of 256 rows in VMEM and reduced it
// on the vector unit, against the einsum of ops/rle.py::rle_decode_packed16.
// Its formulation is kept, not K6's (csrc/expand16_kernel.cu: scan, popc
// and rank), so the A/B asks the TPU's question on Hopper: does an
// O(out_size * L) membership reduction beat K6's direct placement?  The
// wrapper's padding of N to 256 rows was a TPU detail and is gone.
//
// Design.  A row takes L / 4 lanes (16 at L = 64, 8 at L = 32), so a warp
// takes 32 / (L / 4) rows at once; lane h of a row holds slots 4h .. 4h + 3
// and output positions 4h .. 4h + 3.  The lane masks its slots by
// lengths // 2 and sums their counts; a scan over the row's lanes
// (__shfl_up_sync of width L / 4) gives each slot's begin, and the row's
// table in shared memory gets one 8-byte entry a slot.  Only positions
// below L are ever tested, so each run is cut to [lo, hi) = [begin, end)
// within [0, L]: every membership of such a position is kept, and all the
// numbers are integers of at most 2L, exact in fp16.  The entry holds the
// half2 {c, n} = {lo + hi, hi - lo} and the value as a half2 of two equal
// halves.  Slots past the valid ones hold n = 0, so the table is padded
// with empty intervals to L, a multiple of the unroll: the reduction runs
// the warp's largest valid count rounded up to 4 entries, unrolled, with
// no guard per entry.  A lane loads two entries with one broadcast 16-byte
// shared load and, per entry and pair of positions (q, q + 1) as a half2,
// makes the test |2q + 1 - c| < n (q in [lo, hi) for integers) and the
// sum: HADD2, HSET2 (1.0 or 0.0 a half; the absolute value an operand
// modifier, c and n operand swizzles of {c, n}), HFMA2 of the test and
// the value: three instructions for two (position, run) pairs.  Each
// position meets one run at most, so the fp16 sum is exact.  (A float32
// test, FADD, FSETP and a predicated FADD a pair, issues twice the
// instructions; an integer one puts all three on the ALU pipe, which
// takes a warp instruction every other clock.)  __launch_bounds__ asks
// for 5 CTAs an SM: 47 registers, no spill.
//
// Rows in flight.  A warp's next rows' words and lengths are loaded into
// registers before it reduces the current ones.  The grid: CTAs of 8
// warps in a grid-stride loop, kWaves = 8 times as many as are resident,
// which measured ahead of the resident count (the capped persistent grid)
// and of one row group a warp in index order.
//
// What bounds it.  Bytes: 2L + 4 in and 4 out_size out a row, 0.4858 ms at
// 4,194,304 x 64 (the luma of 64 frames of 2048^2) at 3.35 TB/s.  The
// membership reduction issues 1.5 instructions per (position, valid run)
// pair; at 53.2 valid runs a row that is 4,194,304 x 64 x 53.2 x 1.5 = 21 G
// lane instructions, 0.64 ms on 132 SMs issuing a warp instruction a
// scheduler a clock: the issue floor, above the bytes bound.

#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA
constexpr int kValueBias = 512;
constexpr int kPositions = 4;  // slots and output positions a lane
constexpr int kUnroll = 4;     // table entries a loop step, two a load
constexpr int kMinCtas = 5;    // CTAs an SM ptxas must fit
constexpr int kWaves = 8;      // the grid: 8 x the resident CTAs

// A lane's four packed16 words: two 4-byte loads at L = 64 (rows are
// 4-byte aligned), four 2-byte loads at L = 32.
template <int L>
__device__ __forceinline__ void load_words(const uint16_t* __restrict__ src,
                                           uint32_t (&w)[2]) {
  if constexpr (L == 64) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    w[0] = s[0];
    w[1] = s[1];
  } else {
    w[0] = src[0] | (static_cast<uint32_t>(src[1]) << 16);
    w[1] = src[2] | (static_cast<uint32_t>(src[3]) << 16);
  }
}

template <int L>
__global__ void __launch_bounds__(kWarps * 32, kMinCtas)
    membership_kernel(const uint16_t* __restrict__ packed,
                      const int32_t* __restrict__ lengths,
                      int32_t* __restrict__ out, long long n_rows,
                      int out_size, bool vec_store) {
  constexpr int kLanes = L / kPositions;  // lanes a row
  constexpr int kRows = 32 / kLanes;      // rows a warp
  __shared__ uint2 table[kWarps][kRows][L];  // half2 {c, n} and {v, v}
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / kLanes;  // the warp's row this lane works on
  const int h = lane % kLanes;
  const uint4* mine = reinterpret_cast<const uint4*>(table[warp][sub]);

  __half2 at[kPositions / 2];  // 2q + 1 of the lane's positions, in pairs
#pragma unroll
  for (int i = 0; i < kPositions / 2; ++i)
    at[i] = __floats2half2_rn(static_cast<float>(2 * (kPositions * h + 2 * i) + 1),
                              static_cast<float>(2 * (kPositions * h + 2 * i) + 3));

  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  long long group = static_cast<long long>(blockIdx.x) * kWarps + warp;
  uint32_t words[2] = {0u, 0u};
  int length = 0;
  auto fetch = [&](long long g, uint32_t (&w)[2], int& len) {
    const long long row = g * kRows + sub;
    if (row < n_rows) {
      load_words<L>(packed + row * L + kPositions * h, w);
      len = lengths[row];
    } else {
      len = 0;
    }
  };
  if (group * kRows < n_rows) fetch(group, words, length);

  for (; group * kRows < n_rows; group += step) {  // uniform in the warp
    uint32_t next_words[2] = {0u, 0u};
    int next_length = 0;
    if ((group + step) * kRows < n_rows)
      fetch(group + step, next_words, next_length);

    const long long row = group * kRows + sub;
    const int npairs = length >> 1;  // floor, as lengths // 2
    int count[kPositions], value[kPositions], sum = 0;
#pragma unroll
    for (int j = 0; j < kPositions; ++j) {
      const int w = (words[j >> 1] >> (16 * (j & 1))) & 0xffff;
      count[j] = kPositions * h + j < npairs ? (w >> 10) + 1 : 0;
      value[j] = (w & 0x3ff) - kValueBias;
      sum += count[j];
    }
    int end = sum;  // inclusive scan over the row's lanes
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d, kLanes);
      if (h >= d) end += up;
    }
    int begin = end - sum;
    uint2* entry = table[warp][sub] + kPositions * h;
#pragma unroll
    for (int j = 0; j < kPositions; ++j) {
      // Only positions below L are tested: the interval cut to [0, L] keeps
      // every membership and makes c and n at most 2L.
      const int lo = min(begin, L), hi = min(begin + count[j], L);
      const float v = static_cast<float>(value[j]);
      const __half2 cn = __floats2half2_rn(static_cast<float>(lo + hi),
                                           static_cast<float>(hi - lo));
      const __half2 vv = __floats2half2_rn(v, v);
      entry[j] = make_uint2(*reinterpret_cast<const uint32_t*>(&cn),
                            *reinterpret_cast<const uint32_t*>(&vv));
      begin += count[j];
    }
    __syncwarp();

    const int valid = npairs < L ? (npairs > 0 ? npairs : 0) : L;
    const int most = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(valid)));
    const int entries = (most + kUnroll - 1) / kUnroll * kUnroll;  // <= L
    __half2 acc[kPositions / 2];
#pragma unroll
    for (int i = 0; i < kPositions / 2; ++i) acc[i] = __float2half2_rn(0.f);
    for (int e = 0; e < entries; e += kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll / 2; ++u) {  // two entries a load
        const uint4 r = mine[e / 2 + u];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t cn_bits = half ? r.z : r.x, v_bits = half ? r.w : r.y;
          const __half2 cn = *reinterpret_cast<const __half2*>(&cn_bits);
          const __half2 v = *reinterpret_cast<const __half2*>(&v_bits);
          const __half2 c = __low2half2(cn), n = __high2half2(cn);
#pragma unroll
          for (int i = 0; i < kPositions / 2; ++i)  // two positions a step
            acc[i] = __hfma2(__hlt2(__habs2(__hsub2(at[i], c)), n), v, acc[i]);
        }
      }
    }
    if (row < n_rows) {
      int got[kPositions];
#pragma unroll
      for (int i = 0; i < kPositions / 2; ++i) {
        got[2 * i] = __half2int_rn(__low2half(acc[i]));
        got[2 * i + 1] = __half2int_rn(__high2half(acc[i]));
      }
      int32_t* dst = out + row * out_size + kPositions * h;
      if (vec_store && kPositions * h < out_size) {
        *reinterpret_cast<int4*>(dst) = make_int4(got[0], got[1], got[2], got[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPositions; ++i)
          if (kPositions * h + i < out_size) dst[i] = got[i];
      }
    }
    __syncwarp();  // the table is rewritten for the next rows
    words[0] = next_words[0];
    words[1] = next_words[1];
    length = next_length;
  }
}

template <int L>
const void* kernel_of() {
  return reinterpret_cast<const void*>(membership_kernel<L>);
}

const void* kernel_for(int seg) {
  return seg == 64 ? kernel_of<64>() : seg == 32 ? kernel_of<32>() : nullptr;
}

// The row groups of a launch: 32 / (seg / 4) rows a warp.
long long row_groups(long long n_rows, int seg) {
  const int rows = 32 / (seg / kPositions);
  return (n_rows + rows - 1) / rows;
}

}  // namespace

// packed: (n_rows, seg) uint16 words, 4-byte aligned (seg 64) or 2-byte
// (seg 32); lengths: (n_rows,) int32; out: (n_rows, out_size) int32; all
// contiguous.  seg is 32 or 64 and 1 <= out_size <= seg.  Grid-stride CTAs,
// kWaves times as many as are resident (at most one a warp's row group).
// Launches on `stream` and returns the first CUDA error of the device and
// occupancy queries or the launch (0 on success); never synchronises.
extern "C" int rle_membership_launch(const void* packed, const void* lengths,
                                     void* out, long long n_rows, int seg,
                                     int out_size, void* stream) {
  const void* kernel = kernel_for(seg);
  if (kernel == nullptr || out_size < 1 || out_size > seg || n_rows < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(packed) % (seg / 16) ||
      reinterpret_cast<uintptr_t>(lengths) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 4)
    return cudaErrorMisalignedAddress;
  if (n_rows == 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  const long long ctas =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) * kWaves;
  const long long need = (row_groups(n_rows, seg) + kWarps - 1) / kWarps;
  const unsigned grid = static_cast<unsigned>(need < ctas ? need : ctas);
  const bool vec_store =
      out_size % kPositions == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint16_t*>(packed);
  const auto* l = static_cast<const int32_t*>(lengths);
  auto* o = static_cast<int32_t*>(out);
  if (seg == 64)
    membership_kernel<64><<<grid, kWarps * 32, 0, s>>>(p, l, o, n_rows,
                                                       out_size, vec_store);
  else
    membership_kernel<32><<<grid, kWarps * 32, 0, s>>>(p, l, o, n_rows,
                                                       out_size, vec_store);
  return cudaGetLastError();
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the seg-slot kernel on the current device; returns the first CUDA
// error.
extern "C" int rle_membership_attributes(int seg, int* regs, int* smem,
                                         int* ctas) {
  const void* kernel = kernel_for(seg);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel,
                                                       kWarps * 32, 0);
}

extern "C" const char* rle_membership_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
