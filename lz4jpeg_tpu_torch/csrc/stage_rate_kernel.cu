// The per-stage rate of the two sorting primitives, for Hopper (sm_90a):
// 32 stages over each 128-lane row of a (B, 128, 128) int32 array, as one
// template with two instantiations:
//   - kConcentration: a monotone-concentration butterfly stage, the radix
//     partition's primitive.  At stage b, step = 1 << (b % 7); the value
//     `step` lanes up arrives (less step) where it has bit 0 and bit `step`
//     set and the lane is below 128 - step, else a value with both bits set
//     departs (0), else the lane keeps its value;
//   - kCompareExchange: a bitonic compare-exchange stage, the sort's
//     primitive.  At stage b, d = 1 << (b % 7); lane c takes min or max of
//     itself and lane c ^ d, min where (c & d == 0) == (c & 2d == 0).
//
// Replaces profiles/probe_bucket_partition.py::conc_kernel (:45) and
// ::bitonic_kernel (:59), the two kernels of its pallas_call (:80), which
// ran one (128, 128) tile a grid step with pltpu.roll over the lanes.  The
// roll is jnp.roll's: roll(w, 128 - s)[c] = w[(c + s) % 128].
//
// Design.  One warp holds a row, 4 values a lane: lane l holds columns
// l + 32 i, i = 0..3, so a load or store of one i is 128 contiguous bytes.
// Reading the value s lanes up (s < 32) is one __shfl_sync of each register
// from lane (l + s) % 32 and a select of register i or i + 1 where the
// column wraps; s = 32 and 64 are register moves.  The partner c ^ d is
// __shfl_xor_sync for d < 32 and a register swap for d = 32, 64.  The 32
// stages are unrolled with their steps known at compile time.  Rows are
// taken by a persistent grid of 256-thread CTAs, a warp a row at a time.
//
// What bounds it.  One read and one write of the array: 2 x 64 KiB a
// block, 0.0100 ms for 256 blocks and 0.0801 ms for 2,048 at 3.35 TB/s.
// The stages are a few warp instructions per value each (shuffles,
// compares, selects): 32 x 16,384 stage-elements a block.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA
constexpr int kLanes = 128;
constexpr int kPerLane = kLanes / 32;
constexpr int kStages = 32;

enum Kind { kConcentration = 0, kCompareExchange = 1 };

// in[i] = the row's value at column (c + S) % 128, c = lane + 32 i.
template <int S>
__device__ __forceinline__ void from_above(const int32_t (&w)[kPerLane],
                                           int32_t (&in)[kPerLane], int lane) {
  if constexpr (S % 32 == 0) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) in[i] = w[(i + S / 32) % kPerLane];
  } else {
    int32_t x[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      x[i] = __shfl_sync(kFull, w[i], (lane + S) & 31);
    const bool wrap = lane + S >= 32;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      in[i] = wrap ? x[(i + 1) % kPerLane] : x[i];
  }
}

template <int Step>
__device__ __forceinline__ void concentration_stage(int32_t (&w)[kPerLane],
                                                    int lane) {
  int32_t in[kPerLane];
  from_above<Step>(w, in, lane);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int col = lane + 32 * i;
    const bool arrive = col < kLanes - Step && (in[i] & 1) && (in[i] & Step);
    const bool depart = (w[i] & 1) && (w[i] & Step);
    w[i] = arrive ? in[i] - Step : (depart ? 0 : w[i]);
  }
}

template <int D>
__device__ __forceinline__ void compare_exchange_stage(int32_t (&w)[kPerLane],
                                                       int lane) {
  int32_t partner[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if constexpr (D < 32)
      partner[i] = __shfl_xor_sync(kFull, w[i], D);
    else
      partner[i] = w[i ^ (D / 32)];
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int col = lane + 32 * i;
    const bool keep_min = ((col & D) == 0) == ((col & (2 * D)) == 0);
    w[i] = keep_min ? min(w[i], partner[i]) : max(w[i], partner[i]);
  }
}

template <int K, int B>
__device__ __forceinline__ void stages(int32_t (&w)[kPerLane], int lane) {
  if constexpr (B < kStages) {
    constexpr int step = 1 << (B % 7);
    if constexpr (K == kConcentration)
      concentration_stage<step>(w, lane);
    else
      compare_exchange_stage<step>(w, lane);
    stages<K, B + 1>(w, lane);
  }
}

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    stage_rate_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out,
                      long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row =
           static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < n_rows; row += step) {
    const int32_t* src = x + row * kLanes;
    int32_t w[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) w[i] = src[lane + 32 * i];
    stages<K, 0>(w, lane);
    int32_t* dst = out + row * kLanes;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) dst[lane + 32 * i] = w[i];
  }
}

const void* kernel_of(int kind) {
  return kind == kConcentration
             ? reinterpret_cast<const void*>(stage_rate_kernel<kConcentration>)
             : reinterpret_cast<const void*>(stage_rate_kernel<kCompareExchange>);
}

}  // namespace

// x, out: (n_rows, 128) int32, contiguous, 4-byte aligned; kind 0 runs the
// concentration stages, 1 the compare-exchange stages.  Persistent grid: as
// many CTAs as can be resident, no more than the rows need.  Launches on
// `stream` and returns the first CUDA error of the device and occupancy
// queries or the launch (0 on success); never synchronises.
extern "C" int stage_rate_launch(int kind, const void* x, void* out,
                                 long long n_rows, void* stream) {
  if (kind != kConcentration && kind != kCompareExchange)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 4)
    return cudaErrorMisalignedAddress;
  if (n_rows <= 0) return n_rows == 0 ? cudaSuccess : cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(kind),
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  const long long need = (n_rows + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  if (kind == kConcentration)
    stage_rate_kernel<kConcentration><<<grid, kWarps * 32, 0, s>>>(in, o, n_rows);
  else
    stage_rate_kernel<kCompareExchange><<<grid, kWarps * 32, 0, s>>>(in, o, n_rows);
  return cudaGetLastError();
}

// Registers per thread, shared memory per CTA and resident CTAs per SM of
// one kind on the current device; returns the first CUDA error.
extern "C" int stage_rate_attributes(int kind, int* regs, int* smem,
                                     int* ctas) {
  if (kind != kConcentration && kind != kCompareExchange)
    return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(kind));
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel_of(kind),
                                                       kWarps * 32, 0);
}

extern "C" const char* stage_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
