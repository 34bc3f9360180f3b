// Run-length compaction for Hopper (sm_90a): (N, L) values -> (N, 2L) int16
// [count, value] pairs, runs front-compacted, the slots past them zero, and
// (N,) int32 lengths = 2 * runs.  L is a power of two <= 128.
//
// Replaces profiles/pallas_rle.py::_rle_kernel (:52, pallas_call :109), the
// TPU candidate that packs 128 / L rows per 128-lane vector, ranks each run
// start with a log2(L)-stage Hillis-Steele prefix sum over lane rolls and
// moves the starts to the front on a log2(L)-stage bit-fixing concentrator
// of rolls and selects.  That network is the TPU's workaround for having no
// cross-lane ballot; it is not carried over.
//
// Design.  One warp takes a row (L >= 32: each lane holds V = L / 32
// consecutive values) or 32 / L rows (L < 32: a segment of L lanes a row,
// one value a lane).  A lane loads its V values as one vector, finds its run
// starts in registers (its first value against the previous lane's last, one
// segmented shuffle), and one __ballot_sync per value slot gives the
// segment's start masks: __popc of the masks below the lane is the rank of
// its first start, __popc of the whole masks the row's run count.  The next
// start after a lane's last is the first start of the next lane holding one
// (__ffs of the masks above it, one shuffle).  Each start stores its
// [count, value] pair straight to its rank slot as one 32-bit word, count =
// next start - this start; each lane zeroes its own slots at or past the run
// count; the segment's first lane writes the length.  Values compare as
// int32, and the value is narrowed to int16 on the store, as the plain
// version's cast does.  K4 (csrc/pack16_kernel.cu) finds runs the same way
// but compacts them through shared memory into packed words; this kernel is
// its own source.
//
// What bounds it.  One read of the values and one write of the pairs and
// lengths: 2 (int16) or 4 (int32) + 4 + 4 / L bytes per value.  At
// 2,097,152 int16 rows of 64 (the A/B's shape) that is 268.4 MB in and
// 545.3 MB out, 0.2429 ms at the 3.35 TB/s of an H100 SXM's data sheet
// (700 W): memory-bound, a few warp instructions per value.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA

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

template <typename T, int L>
__global__ void __launch_bounds__(kWarps * 32)
    rle_compact_kernel(const T* __restrict__ values,
                       uint32_t* __restrict__ pairs,
                       int32_t* __restrict__ lengths, long long n_rows) {
  constexpr int V = L >= 32 ? L / 32 : 1;  // values per lane
  constexpr int S = L / V;                 // lanes per row
  constexpr int R = 32 / S;                // rows per warp pass
  using In = LaneOf<T, V>;

  const int lane = threadIdx.x & 31;
  const int sub = lane % S;  // lane within the row's segment
  const int r = lane / S;    // row within the pass
  const unsigned seg =
      S == 32 ? kFull : ((1u << (S % 32)) - 1u) << (r * S);  // segment lanes
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = ~below & ~(1u << lane);

  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long pass =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       pass * R < n_rows; pass += step) {
    const long long row = pass * R + r;
    const bool live = row < n_rows;
    In x;
    x.v = typename Raw<sizeof(T) * V>::type{};
    if (live)
      x.v = *reinterpret_cast<const decltype(x.v)*>(values + row * L +
                                                    sub * V);
    int32_t v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = static_cast<int32_t>(x.e[j]);

    // The previous lane's last value (a segment's first lane gets its own).
    const int32_t prev = __shfl_up_sync(kFull, v[V - 1], 1, S);
    bool start[V];
    start[0] = sub == 0 || v[0] != prev;
#pragma unroll
    for (int j = 1; j < V; ++j) start[j] = v[j] != v[j - 1];

    int rank = 0, runs = 0, first = V;
    unsigned any = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const unsigned mask = __ballot_sync(kFull, start[j]) & seg;
      rank += __popc(mask & below);
      runs += __popc(mask);
      any |= mask;
    }
#pragma unroll
    for (int j = V - 1; j >= 0; --j)
      if (start[j]) first = j;
    // The first start of the next lane that holds one, or L.
    const unsigned later = any & above;
    const int src = later ? __ffs(later) - 1 : lane;
    const int next_first = __shfl_sync(kFull, sub * V + first, src);
    const int after = later ? next_first : L;

    if (live) {
      uint32_t* out = pairs + row * L;  // slot m: count | value << 16
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (start[j]) {
          int next = after;
#pragma unroll
          for (int k = V - 1; k > j; --k)
            if (start[k]) next = sub * V + k;
          const uint32_t count = static_cast<uint32_t>(next - (sub * V + j));
          const uint32_t value =
              static_cast<uint16_t>(static_cast<int16_t>(v[j]));
          out[rank++] = count | value << 16;
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (sub * V + j >= runs) out[sub * V + j] = 0u;
      if (sub == 0) lengths[row] = 2 * runs;
    }
  }
}

// Persistent grid: as many CTAs as can be resident at once, no more than the
// passes need.  A failed device or occupancy query is returned.
cudaError_t grid_for(long long passes, const void* kernel, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  const long long need = (passes + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(need < cap ? need : cap);
  return cudaSuccess;
}

template <typename T, int L>
cudaError_t launch_seg(const void* values, void* pairs, void* lengths,
                       long long n_rows, cudaStream_t s) {
  constexpr int R = 32 / (L >= 32 ? 32 : L);
  unsigned grid = 0;
  const cudaError_t err =
      grid_for((n_rows + R - 1) / R,
               reinterpret_cast<const void*>(rle_compact_kernel<T, L>), &grid);
  if (err != cudaSuccess) return err;
  rle_compact_kernel<T, L><<<grid, kWarps * 32, 0, s>>>(
      static_cast<const T*>(values), static_cast<uint32_t*>(pairs),
      static_cast<int32_t*>(lengths), n_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* values, void* pairs, void* lengths,
                   long long n_rows, int seg, cudaStream_t s) {
  switch (seg) {
    case 1: return launch_seg<T, 1>(values, pairs, lengths, n_rows, s);
    case 2: return launch_seg<T, 2>(values, pairs, lengths, n_rows, s);
    case 4: return launch_seg<T, 4>(values, pairs, lengths, n_rows, s);
    case 8: return launch_seg<T, 8>(values, pairs, lengths, n_rows, s);
    case 16: return launch_seg<T, 16>(values, pairs, lengths, n_rows, s);
    case 32: return launch_seg<T, 32>(values, pairs, lengths, n_rows, s);
    case 64: return launch_seg<T, 64>(values, pairs, lengths, n_rows, s);
    case 128: return launch_seg<T, 128>(values, pairs, lengths, n_rows, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// values: (n_rows, seg) int16 (elem_bytes 2) or int32 (4), 16-byte aligned;
// pairs: (n_rows, 2 seg) int16, 4-byte aligned; lengths: (n_rows,) int32;
// all contiguous.  Launches on `stream` and returns the first CUDA error of
// the occupancy query or the launch (0 on success); never synchronises.
extern "C" int rle_compact_launch(const void* values, int elem_bytes,
                                  void* pairs, void* lengths, long long n_rows,
                                  int seg, void* stream) {
  if (seg < 1 || seg > 128 || (seg & (seg - 1))) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(values) % 16 ||
      reinterpret_cast<uintptr_t>(pairs) % 4)
    return cudaErrorMisalignedAddress;
  if (n_rows <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch<int16_t>(values, pairs, lengths, n_rows, seg, s);
  if (elem_bytes == 4)
    return launch<int32_t>(values, pairs, lengths, n_rows, seg, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* rle_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
