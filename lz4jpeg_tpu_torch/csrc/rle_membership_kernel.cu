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
// Design.  One warp a row.  Lane l holds slots V l .. V l + V - 1 (V = L /
// 32; one 16- or 32-bit load), masks them by lengths // 2 and sums their
// counts; an inclusive __shfl_up_sync scan over the lanes gives each slot's
// begin and end, which go to the warp's slice of shared memory as
// {begin, end, value} with the value.  Then lane l owns the positions l and
// l + 32 and reduces over the row's valid slots: one broadcast 16-byte
// shared load a slot, and per position an unsigned compare (q - begin <
// end - begin) and a select-add.  Slots past lengths // 2 hold empty
// intervals and are skipped (the loop runs to min(L, lengths // 2), the
// same for the whole warp).  Rows are taken by a persistent grid of
// 256-thread CTAs.
//
// What bounds it.  Bytes: 2L + 4 in and 4 out_size out a row, 0.4858 ms at
// 4,194,304 x 64 (the luma of 64 frames of 2048^2) at 3.35 TB/s.  The
// membership reduction issues about 3 instructions per (position, valid
// run) pair; with ~40 runs a row that is 4,194,304 x 64 x 40 x 3 = 32 G
// lane-instructions, several times the bytes bound on 132 SMs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA
constexpr int kValueBias = 512;

template <int bytes> struct Raw;
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };

template <int L>
__global__ void __launch_bounds__(kWarps * 32)
    membership_kernel(const uint16_t* __restrict__ packed,
                      const int32_t* __restrict__ lengths,
                      int32_t* __restrict__ out, long long n_rows,
                      int out_size) {
  constexpr int V = L / 32;  // slots per lane
  using Word = typename Raw<2 * V>::type;
  __shared__ int4 runs[kWarps][L];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int4* mine = runs[warp];

  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
       row < n_rows; row += step) {
    const Word raw = reinterpret_cast<const Word*>(packed + row * L)[lane];
    const int npairs = lengths[row] >> 1;  // floor, as lengths // 2
    int count[V], value[V], sum = 0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int w = (raw >> (16 * j)) & 0xffff;
      count[j] = V * lane + j < npairs ? (w >> 10) + 1 : 0;
      value[j] = (w & 0x3ff) - kValueBias;
      sum += count[j];
    }
    int end = sum;  // inclusive scan of the lanes' sums
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += up;
    }
    int begin = end - sum;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mine[V * lane + j] = make_int4(begin, begin + count[j], value[j], 0);
      begin += count[j];
    }
    __syncwarp();

    const int valid = npairs < L ? (npairs > 0 ? npairs : 0) : L;
    int acc0 = 0, acc1 = 0;
    for (int k = 0; k < valid; ++k) {
      const int4 r = mine[k];
      const unsigned len = static_cast<unsigned>(r.y - r.x);
      if (static_cast<unsigned>(lane - r.x) < len) acc0 += r.z;
      if (static_cast<unsigned>(lane + 32 - r.x) < len) acc1 += r.z;
    }
    int32_t* dst = out + row * out_size;
    if (lane < out_size) dst[lane] = acc0;
    if (lane + 32 < out_size) dst[lane + 32] = acc1;
    __syncwarp();  // the slice is rewritten for the next row
  }
}

template <int L>
const void* kernel_of() {
  return reinterpret_cast<const void*>(membership_kernel<L>);
}

const void* kernel_for(int seg) {
  return seg == 64 ? kernel_of<64>() : seg == 32 ? kernel_of<32>() : nullptr;
}

}  // namespace

// packed: (n_rows, seg) uint16 words, 4-byte aligned (seg 64) or 2-byte
// (seg 32); lengths: (n_rows,) int32; out: (n_rows, out_size) int32; all
// contiguous.  seg is 32 or 64 and 1 <= out_size <= seg.  Persistent grid.
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
  const long long need = (n_rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint16_t*>(packed);
  const auto* l = static_cast<const int32_t*>(lengths);
  auto* o = static_cast<int32_t*>(out);
  if (seg == 64)
    membership_kernel<64><<<grid, kWarps * 32, 0, s>>>(p, l, o, n_rows, out_size);
  else
    membership_kernel<32><<<grid, kWarps * 32, 0, s>>>(p, l, o, n_rows, out_size);
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
