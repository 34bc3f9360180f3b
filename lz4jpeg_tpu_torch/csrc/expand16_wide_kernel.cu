// Lane-dense packed16 run-length expansion for Hopper (sm_90a): (N, K) run
// words (count - 1) << 10 | (value + 512) plus symbol lengths → (N, K)
// int16 values, K a power of two ≤ 64.
//
// K8, expand16_wide: replaces lz4jpeg_tpu/ops/pallas_rle.py::
// _rle_decode_wide_kernel.  It computes what K6 (expand16_kernel.cu)
// computes, ops/rle.py::rle_decode_packed16 with out_size = K: slots below
// lengths / 2 are valid, run k covers [begin_k, begin_k + count_k) with the
// begins the exclusive prefix sum of the valid counts, position p takes the
// value of the last valid run that begins at or before p, and 0 at or past
// the covered total.
//
// The TPU kernel read the flat (N·K/128, 128) view of the words, so several
// blocks shared a lane row, and built the prefix and total sums from two
// 128×128 MXU matmuls plus lane rolls.  Here the flat stream is read the
// same way, without matmuls: each lane loads V = min(K, 8) consecutive words
// in one load (16 bytes at K ≥ 8), so a warp reads 32·V consecutive words,
// 32·V / K block rows, coalesced at every K (K6 gives each row a warp and
// loads 2 bytes a lane, half its lanes idle at K = 32).  The L = K / V lanes
// of a row form a segment: the lane scans its own counts, a segmented
// __shfl_up_sync scan (width L) adds the lanes before it and a width-L
// shuffle from the segment's last lane gives the total; each lane ORs its
// run starts below K into a 64-bit mask, and a segmented __shfl_xor_sync
// reduction gives every lane the row's mask.  The run values go to shared
// memory (one warp's 32·V words); position p reads the value of run
// popc(mask & bits 0..p) - 1 from there.  The V int16 results leave in one
// store of 2·V bytes.
//
// What bounds it: one read of the words and lengths, one write of the
// values, 2 + 4/K bytes in and 2 bytes out per value: at 2048², batch 64
// (4,194,304 luma blocks of 64) 1.09 GB, 0.32 ms at the 3.35 TB/s of an H100
// SXM's data sheet (K6 moves 1.63 GB for the same blocks: it writes int32).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA
constexpr long long kMaxCtas = 1 << 16;

// One lane's V consecutive 16-bit words as a single load or store.
template <int V> struct VecOf;
template <> struct VecOf<8> { using type = uint4; };
template <> struct VecOf<4> { using type = uint2; };
template <> struct VecOf<2> { using type = uint32_t; };
template <> struct VecOf<1> { using type = uint16_t; };

template <int V>
union Lane16 {
  typename VecOf<V>::type v;
  uint16_t h[V];
};

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    expand16_wide_kernel(const uint16_t* __restrict__ packed,
                         const int32_t* __restrict__ lengths,
                         uint16_t* __restrict__ out, long long n_rows) {
  constexpr int V = K < 8 ? K : 8;  // words per lane
  constexpr int L = K / V;          // lanes per block row
  constexpr int R = 32 / L;         // block rows per warp chunk
  using Vec = typename VecOf<V>::type;
  __shared__ int16_t run_values[kWarps][32 * V];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;  // lane within the row's segment
  const int r = lane / L;    // row within the chunk
  int16_t* values = run_values[warp];
  const long long n_chunks = (n_rows + R - 1) / R;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long chunk = static_cast<long long>(blockIdx.x) * kWarps + warp;
       chunk < n_chunks; chunk += step) {
    const long long row = chunk * R + r;
    const bool live = row < n_rows;
    const long long at = row * K + sub * V;
    Lane16<V> w;
    w.v = Vec{};
    int32_t len = 0;
    if (live) {
      w.v = *reinterpret_cast<const Vec*>(packed + at);
      len = lengths[row];
    }
    // floor(len / 2) for len < 0 is ≤ 0 too: no valid slot either way.
    const int n_valid = len > 0 ? len / 2 : 0;
    int counts[V];
    int incl = 0;  // inclusive sum of this lane's counts
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool valid = sub * V + j < n_valid;
      counts[j] = valid ? static_cast<int>(w.h[j] >> 10) + 1 : 0;
      incl += counts[j];
      values[lane * V + j] =
          static_cast<int16_t>(static_cast<int>(w.h[j] & 0x3FF) - 512);
    }
    int scan = incl;  // segmented inclusive scan over the row's lanes
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      const int t = __shfl_up_sync(kFull, scan, d, L);
      if (sub >= d) scan += t;
    }
    const int total = __shfl_sync(kFull, scan, L - 1, L);
    int start = scan - incl;  // begin of this lane's first run
    uint64_t mask = 0;        // bit s: a valid run begins at position s
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (counts[j] > 0 && start < K) mask |= 1ull << start;
      start += counts[j];
    }
#pragma unroll
    for (int d = 1; d < L; d <<= 1) mask |= __shfl_xor_sync(kFull, mask, d, L);
    __syncwarp();
    Lane16<V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int p = sub * V + j;
      // Bits 0..p (all 64 at p = 63, where 2 << 63 wraps to 0).
      const int rank = __popcll(mask & ((2ull << p) - 1ull)) - 1;
      o.h[j] = p < total && rank >= 0
                   ? static_cast<uint16_t>(values[r * K + rank])
                   : 0;
    }
    __syncwarp();  // the next chunk overwrites the values
    if (live) *reinterpret_cast<Vec*>(out + at) = o.v;
  }
}

template <int K>
cudaError_t launch(const void* packed, const void* lengths, void* out,
                   long long n_rows, cudaStream_t stream) {
  constexpr int V = K < 8 ? K : 8;
  constexpr int R = 32 / (K / V);
  const long long chunks = (n_rows + R - 1) / R;
  long long ctas = (chunks + kWarps - 1) / kWarps;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  expand16_wide_kernel<K><<<static_cast<unsigned>(ctas), kWarps * 32, 0,
                            stream>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<uint16_t*>(out),
      n_rows);
  return cudaGetLastError();
}

}  // namespace

// packed: (n_rows, seg) uint16; lengths: (n_rows,) int32; out: (n_rows, seg)
// int16; all contiguous, packed and out 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int expand16_wide_launch(const void* packed, const void* lengths,
                                    void* out, long long n_rows, int seg,
                                    void* stream) {
  if (reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  if (n_rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 1: return launch<1>(packed, lengths, out, n_rows, s);
    case 2: return launch<2>(packed, lengths, out, n_rows, s);
    case 4: return launch<4>(packed, lengths, out, n_rows, s);
    case 8: return launch<8>(packed, lengths, out, n_rows, s);
    case 16: return launch<16>(packed, lengths, out, n_rows, s);
    case 32: return launch<32>(packed, lengths, out, n_rows, s);
    case 64: return launch<64>(packed, lengths, out, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* expand16_wide_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
