// The per-stage rate of the two sorting primitives, for Hopper (sm_90a):
// 32 stages over each 128-lane row of a (B, 128, 128) int32 array, as two
// kernels:
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
// Compare-exchange design.  One warp holds a row, 4 values a lane: lane l
// holds columns l + 32 i, i = 0..3, so a load or store of one i is 128
// contiguous bytes.  The partner c ^ d is __shfl_xor_sync
// for d < 32 and a register swap for d = 32, 64.  The 32 stages are
// unrolled with their steps known at compile time.  Rows are taken by a
// persistent grid of 256-thread CTAs, a warp a row at a time.
//
// Concentration design.  One thread holds a row, all 128 values in
// registers, so the value `step` columns up is a register of the same
// thread: a stage is register renames and three lane instructions a value,
// with no shuffle, no wrap select and no column test that depends on the
// lane.  The test p(v) = (v & m) == m, m = 1 | step, is both the arrive
// test of column c (on w[c + step]) and the depart test of column
// c + step, so the columns are updated in place in chains c = r, r + step,
// r + 2 step, ...: when column c is written, w[c + step] still holds its
// old value, and its test carries on to the next link.  The test is one
// LOP3 that writes a predicate, the update an add and a select: 2.86
// instructions a stage-element in the SASS loop.  The seven steps 1..64
// are one compile-time body (2,568 instructions) that a loop runs five
// times, leaving it after the fourth stage of the fifth (32 = 4 x 7 + 4
// stages); the 32 stages unrolled, four times the code, ran slower than the
// warp-a-row kernel.  The 4 warps of a CTA wait for each other twice a pass
// of the loop, which kept them on the same instructions and made the
// kernel faster.  A warp takes 32 rows, a row a lane.  The
// rows come in by 512-byte bulk copies (cp.async.bulk on the warp's
// mbarrier, csrc/bulk_ring.cuh), each lane copying its own row into shared
// memory padded to 528 bytes a row, and each lane reads its row as 32
// 16-byte loads: with a 132-word stride the 8 lanes of a quarter-warp hit 8
// distinct 16-byte bank groups.  Results go back the same way, into the
// padded row and out as one 512-byte bulk store.  Persistent CTAs of 4
// warps, 3 an SM (the 128 values and their temporaries fit the 168
// registers that leaves a thread, with no spills).  Each warp loads,
// computes and stores its tile in turn: while one CTA waits for its
// copies, the SM's other two compute.  A base off a 16-byte boundary takes
// the same kernel with direct 4-byte loads and stores in place of the
// copies.
//
// What bounds it.  One read and one write of the array: 2 x 64 KiB a
// block, 0.0100 ms for 256 blocks and 0.0801 ms for 2,048 at 3.35 TB/s.
// The stages are a few lane instructions per value each: 32 x 16,384
// stage-elements a block (a test, an add and a select for the
// concentration, shuffles and min-or-max for the compare-exchange), which
// take longer than the bytes: both kernels are bound by instruction issue.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "bulk_ring.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per 256-thread CTA
constexpr int kLanes = 128;
constexpr int kPerLane = kLanes / 32;
constexpr int kStages = 32;

enum Kind { kConcentration = 0, kCompareExchange = 1 };

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

template <int B>
__device__ __forceinline__ void compare_exchange_stages(int32_t (&w)[kPerLane],
                                                        int lane) {
  if constexpr (B < kStages) {
    compare_exchange_stage<1 << (B % 7)>(w, lane);
    compare_exchange_stages<B + 1>(w, lane);
  }
}

// The compare-exchange kernel; K is always kCompareExchange.
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
    compare_exchange_stages<0>(w, lane);
    int32_t* dst = out + row * kLanes;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) dst[lane + 32 * i] = w[i];
  }
}

namespace conc {
constexpr int kWarps = 4;       // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kCtasPerSm = 3;   // 12 warps an SM: 168 registers a thread
constexpr int kTileRows = 32;   // rows a warp takes at once, a row a lane
constexpr int kRowBytes = kLanes * 4;
constexpr int kPitch = kRowBytes + 16;  // a row's stride in shared memory
constexpr int kTileBytes = kTileRows * kPitch;
constexpr size_t kSmem = static_cast<size_t>(kWarps) * kTileBytes;
static_assert(kPitch % 128 == 16, "a row starts one 16-byte group on");
}  // namespace conc

// p(v): v has bit 0 and bit S set, so it leaves its column and arrives S
// columns lower.  Tested as (~v & m) == 0: the lop3 in PTX keeps the front
// end from folding that back into (v & m) == m, which ptxas compiles to a
// LOP3 and an ISETP; this way it is one LOP3 that writes the predicate.
template <int S>
__device__ __forceinline__ bool moves(int32_t v) {
  int32_t rest;
  asm("lop3.b32 %0, %1, %2, 0, 0x0c;" : "=r"(rest) : "r"(v), "n"(1 | S));
  return rest == 0;
}

// One stage, in place: column c takes w[c + S] - S where that value moves
// (and c + S < 128), else 0 where its own value moves, else keeps it.
template <int S>
__device__ __forceinline__ void concentration_stage(int32_t (&w)[kLanes]) {
#pragma unroll
  for (int r = 0; r < S; ++r) {
    bool leaves = moves<S>(w[r]);
#pragma unroll
    for (int c = r; c < kLanes; c += S) {
      if (c + S < kLanes) {
        const bool arrives = moves<S>(w[c + S]);
        w[c] = arrives ? w[c + S] - S : (leaves ? 0 : w[c]);
        leaves = arrives;
      } else {
        w[c] = leaves ? 0 : w[c];
      }
    }
  }
}

// Stages B..E - 1 of the 7-step cycle.
template <int B, int E>
__device__ __forceinline__ void concentration_stages(int32_t (&w)[kLanes]) {
  if constexpr (B < E) {
    concentration_stage<1 << B>(w);
    concentration_stages<B + 1, E>(w);
  }
}

// kBulk: both bases 16-byte aligned, rows staged by bulk copies; else
// direct loads and stores.  Tile t holds rows 32 t .. 32 t + 31, and warp w
// of CTA b takes tiles 4 b + w, 4 (b + grid) + w, ....  The CTA's warps go
// through the stages in step, waiting for each other twice a pass of the
// cycle, so that they run the same instructions at about the same time.
// So every warp of a CTA makes each of the CTA's passes: in the last, a
// warp whose tile lies past the last one runs the stages on whatever its
// registers hold, loads nothing and stores nothing.  The shared loads stay
// inside the branch of a warp with a tile: there, ptxas cannot move the
// first stages up among them (which costs registers and predicates).
template <bool kBulk>
__global__ void __launch_bounds__(conc::kThreads, conc::kCtasPerSm)
    concentration_kernel(const int32_t* __restrict__ x,
                         int32_t* __restrict__ out, long long n_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[conc::kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* mine = reinterpret_cast<int32_t*>(smem + warp * conc::kTileBytes +
                                             lane * conc::kPitch);
  if (kBulk && lane == 0) {
    mbar_init(&bar[warp], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int tiles =
      static_cast<int>((n_rows + conc::kTileRows - 1) / conc::kTileRows);
  uint32_t parity = 0;
  // The CTA's passes: it leaves when the tile of its warp 0 (t - warp, the
  // same for all its warps) lies past the last.
  const int first = blockIdx.x * conc::kWarps;
  for (int t = first + warp; first < tiles; t += gridDim.x * conc::kWarps) {
    const bool mine_tile = t < tiles;
    if (t - warp >= tiles) break;
    const long long row = static_cast<long long>(t) * conc::kTileRows + lane;
    int32_t w[kLanes];
    if (kBulk && mine_tile) {
      __syncwarp();  // every lane is past the last tile's wait
      if (lane == 0) {
        const long long left = n_rows - row;
        mbar_expect_tx(&bar[warp],
                       static_cast<uint32_t>(left < conc::kTileRows
                                                 ? left
                                                 : conc::kTileRows) *
                           conc::kRowBytes);
      }
      __syncwarp();
      if (row < n_rows)
        bulk_load(mine, x + row * kLanes, conc::kRowBytes, &bar[warp]);
      mbar_wait(&bar[warp], parity);
      parity ^= 1;
#pragma unroll
      for (int k = 0; k < kLanes / 4; ++k) {
        const int4 v = reinterpret_cast<const int4*>(mine)[k];
        w[4 * k] = v.x;
        w[4 * k + 1] = v.y;
        w[4 * k + 2] = v.z;
        w[4 * k + 3] = v.w;
      }
    } else if (!kBulk) {
#pragma unroll
      for (int c = 0; c < kLanes; ++c)
        w[c] = row < n_rows ? x[row * kLanes + c] : 0;
    }
    // The 32 stages: the cycle of steps 1..64 run five times, left after
    // its fourth stage the fifth time (32 = 4 x 7 + 4).
#pragma unroll 1
    for (int i = 0;; ++i) {
      __syncthreads();
      concentration_stages<0, kStages % 7>(w);
      if (i == kStages / 7) break;
      __syncthreads();
      concentration_stages<kStages % 7, 7>(w);
    }
    // The row again, so that no register holds it through the stages.
    const long long done = static_cast<long long>(t) * conc::kTileRows + lane;
    if (kBulk && mine_tile) {
#pragma unroll
      for (int k = 0; k < kLanes / 4; ++k)
        reinterpret_cast<int4*>(mine)[k] =
            make_int4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      fence_proxy_async();
      if (done < n_rows) {
        bulk_store(out + done * kLanes, mine, conc::kRowBytes);
        bulk_wait_read();
      }
    } else if (!kBulk && done < n_rows) {
#pragma unroll
      for (int c = 0; c < kLanes; ++c) out[done * kLanes + c] = w[c];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The kernel a launch takes: kind, and for a concentration whether both
// bases allow the bulk copies; its threads and dynamic shared memory, with
// that memory allowed to it.
cudaError_t kernel_of(int kind, bool bulk, const void** fn, int* threads,
                      size_t* smem) {
  if (kind == kCompareExchange) {
    *fn = reinterpret_cast<const void*>(stage_rate_kernel<kCompareExchange>);
    *threads = kWarps * 32;
    *smem = 0;
    return cudaSuccess;
  }
  *fn = bulk ? reinterpret_cast<const void*>(concentration_kernel<true>)
             : reinterpret_cast<const void*>(concentration_kernel<false>);
  *threads = conc::kThreads;
  *smem = bulk ? conc::kSmem : 0;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
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
  if (n_rows > static_cast<long long>(INT_MAX) * conc::kTileRows)
    return cudaErrorInvalidValue;
  const bool bulk = aligned16(x) && aligned16(out);
  const void* fn = nullptr;
  int threads = 0, dev = 0, sms = 0, per_sm = 0;
  size_t smem = 0;
  cudaError_t err = kernel_of(kind, bulk, &fn, &threads, &smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  const long long rows_a_cta = kind == kConcentration
                                   ? static_cast<long long>(conc::kWarps) *
                                         conc::kTileRows
                                   : kWarps;
  const long long need = (n_rows + rows_a_cta - 1) / rows_a_cta;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(need < cap ? need : cap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const int32_t*>(x);
  auto* o = static_cast<int32_t*>(out);
  if (kind == kCompareExchange)
    stage_rate_kernel<kCompareExchange><<<grid, threads, 0, s>>>(in, o, n_rows);
  else if (bulk)
    concentration_kernel<true><<<grid, threads, smem, s>>>(in, o, n_rows);
  else
    concentration_kernel<false><<<grid, threads, 0, s>>>(in, o, n_rows);
  return cudaGetLastError();
}

// Registers per thread, shared memory per CTA (static and dynamic) and
// resident CTAs per SM of one kind on the current device (a concentration's
// with 16-byte aligned bases); returns the first CUDA error.
extern "C" int stage_rate_attributes(int kind, int* regs, int* smem,
                                     int* ctas) {
  if (kind != kConcentration && kind != kCompareExchange)
    return cudaErrorInvalidValue;
  const void* fn = nullptr;
  int threads = 0;
  size_t dynamic = 0;
  cudaError_t err = kernel_of(kind, true, &fn, &threads, &dynamic);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes + dynamic);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, threads,
                                                       dynamic);
}

extern "C" const char* stage_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
