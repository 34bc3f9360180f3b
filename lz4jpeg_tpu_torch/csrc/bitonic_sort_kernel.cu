// Bitonic sort of 16,384-slot blocks with a payload, for Hopper (sm_90a):
// (B, 16384) int32 keys and payload -> the keys of each block ascending,
// the payload routed along with them.  A compile-time switch records each
// stage's swap mask and then replays the swaps in reverse stage order, so
// that the payload returns to its input position while the keys come out
// sorted: the un-sort the TPU matcher was built on.
//
// Replaces profiles/profile_pallas_sort.py::_kernel_sort (:35; make_sort
// :129, pallas_call :142), both record_masks=False and record_masks=True.
// The TPU kernel held a (128, 128) tile in VMEM and ran the 105 stages of
// the network as pltpu.roll pairs and selects over the whole tile, routing
// the payload by `new_key != key` and folding each stage's swap bits into
// four int32 bit-planes.  Its grid divisor batch_r was a TPU detail: here
// one launch sorts every block, one CTA a block.
//
// Design.  1,024 threads hold the block's 16,384 keys and payload words in
// registers, 16 of each a thread.  Register r of a thread holds slot
// part | r << lo, where the 4 bits lo..lo+3 of the slot are the register's
// and the thread's 10 bits fill the others (part): the layout lo.  Every
// stage whose partner distance 2^j has j in [lo, lo+4) is a compare-exchange
// between two registers of one thread.  The stages of merge 2^kk run with
// j = kk-1 down to 0; they are cut into chunks of at most 4 bits from the
// top (lo = max(0, hi - 3)), and between two chunks of other layouts the
// keys and payload go through shared memory into the next layout (28 such
// exchanges in the sort, 2 CTA barriers each).  Merges 2-16 share layout 0.
// Shared memory is read and written at slot ^ ((slot >> 4) & 31), a
// bijection that spreads every layout's 32 lanes over the 32 banks.
//
// The payload follows the compare's own outcome (swap iff the pair is out
// of order, equal keys never swap), so duplicate keys keep the
// (key, payload) multiset; the TPU kernel's `new_key != key` agrees.
//
// Swap masks.  They cannot stay in registers: a thread does 8
// compare-exchanges a stage, 8 bits, and 105 stages of them.  With
// kRecord, each thread writes its byte for stage s at masks[s * 1024 +
// tid]: 105 KiB a block.  The replay visits the same chunks in reverse,
// with the same layouts, so a thread reads back its own bits.  The
// shared-memory budget then holds one 64 KiB exchange buffer beside them
// (keys and payload pass through it in turn: 4 barriers an exchange), and
// 173,056 bytes in all; without kRecord two buffers, 131,072 bytes.
//
// What bounds it.  Device memory is not the limit: 4 x 64 KiB a block, 0.16
// ms at 2,048 blocks and 3.35 TB/s.  The network is: 105 x 8,192
// compare-exchanges a block, each a compare and four selects, and the 28
// exchanges through shared memory (256 KiB each way a block).  One CTA of
// 1,024 threads a SM (__launch_bounds__(1024, 1): 64 registers a thread).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLogSlots = 14;
constexpr int kSlots = 1 << kLogSlots;       // 16,384
constexpr int kThreads = 1024;
constexpr int kPerThread = kSlots / kThreads;  // 16
constexpr int kStages = kLogSlots * (kLogSlots + 1) / 2;  // 105

__host__ __device__ constexpr size_t smem_bytes(bool record) {
  return record ? static_cast<size_t>(kSlots) * 4 + kStages * kThreads
                : static_cast<size_t>(kSlots) * 8;
}

// Bank-spreading position of a slot in a shared-memory buffer.
__device__ __forceinline__ int phys(int slot) {
  return slot ^ ((slot >> 4) & 31);
}

// The thread's bits of its slots in layout lo (bits lo..lo+3 zero).
__device__ __forceinline__ int thread_part(int tid, int lo) {
  return (tid & ((1 << lo) - 1)) | ((tid >> lo) << (lo + 4));
}

__device__ __forceinline__ void put(int32_t* buf, const int32_t (&v)[kPerThread],
                                    int part, int lo) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) buf[phys(part | (r << lo))] = v[r];
}

__device__ __forceinline__ void get(const int32_t* buf, int32_t (&v)[kPerThread],
                                    int part, int lo) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) v[r] = buf[phys(part | (r << lo))];
}

// Moves keys and payload from layout `lo` (thread bits `part`) to layout
// `to` through shared memory: both at once in two buffers, or (kRecord, one
// buffer beside the masks) one after the other.
template <bool kRecord>
__device__ __forceinline__ void relayout(int32_t* buf0, int32_t* buf1,
                                         int32_t (&k)[kPerThread],
                                         int32_t (&p)[kPerThread], int tid,
                                         int& part, int& lo, int to) {
  const int to_part = thread_part(tid, to);
  if constexpr (kRecord) {
    put(buf0, k, part, lo);
    __syncthreads();
    get(buf0, k, to_part, to);
    __syncthreads();
    put(buf0, p, part, lo);
    __syncthreads();
    get(buf0, p, to_part, to);
    __syncthreads();
  } else {
    put(buf0, k, part, lo);
    put(buf1, p, part, lo);
    __syncthreads();
    get(buf0, k, to_part, to);
    get(buf1, p, to_part, to);
    __syncthreads();
  }
  lo = to;
  part = to_part;
}

// A compare-exchange stage between registers r and r | 2^Q (slot distance
// 2^(lo + Q)) in merge 2^kk: ascending where slot bit kk is 0.  `dir_t` is
// slot bit kk from the thread's bits, `dir_r` the register bit that holds
// it (0 if none).  Returns the 8 swap bits, pair by pair.
template <int Q>
__device__ __forceinline__ uint32_t ce_stage(int32_t (&k)[kPerThread],
                                             int32_t (&p)[kPerThread],
                                             bool dir_t, int dir_r) {
  uint32_t bits = 0;
  int pair = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & (1 << Q)) continue;
    const int s = r | (1 << Q);
    const bool desc = dir_t || (r & dir_r) != 0;
    const int32_t a = k[r], b = k[s];
    const bool swap = desc ? a < b : a > b;
    k[r] = swap ? b : a;
    k[s] = swap ? a : b;
    const int32_t pa = p[r], pb = p[s];
    p[r] = swap ? pb : pa;
    p[s] = swap ? pa : pb;
    bits |= static_cast<uint32_t>(swap) << pair;
    ++pair;
  }
  return bits;
}

// The payload swaps of a recorded stage, pair by pair as ce_stage made them.
template <int Q>
__device__ __forceinline__ void replay_stage(int32_t (&p)[kPerThread],
                                             uint32_t bits) {
  int pair = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & (1 << Q)) continue;
    const int s = r | (1 << Q);
    const bool swap = (bits >> pair) & 1u;
    const int32_t pa = p[r], pb = p[s];
    p[r] = swap ? pb : pa;
    p[s] = swap ? pa : pb;
    ++pair;
  }
}

__device__ __forceinline__ uint32_t ce_dispatch(int q, int32_t (&k)[kPerThread],
                                                int32_t (&p)[kPerThread],
                                                bool dir_t, int dir_r) {
  switch (q) {
    case 3: return ce_stage<3>(k, p, dir_t, dir_r);
    case 2: return ce_stage<2>(k, p, dir_t, dir_r);
    case 1: return ce_stage<1>(k, p, dir_t, dir_r);
    default: return ce_stage<0>(k, p, dir_t, dir_r);
  }
}

__device__ __forceinline__ void replay_dispatch(int q, int32_t (&p)[kPerThread],
                                                uint32_t bits) {
  switch (q) {
    case 3: replay_stage<3>(p, bits); break;
    case 2: replay_stage<2>(p, bits); break;
    case 1: replay_stage<1>(p, bits); break;
    default: replay_stage<0>(p, bits); break;
  }
}

// Layout 0: register r holds slot 16 * tid + r, four 16-byte words.
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         int32_t (&v)[kPerThread], int tid) {
  const int4* s = reinterpret_cast<const int4*>(src) + tid * (kPerThread / 4);
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    const int4 w = s[q];
    v[4 * q] = w.x;
    v[4 * q + 1] = w.y;
    v[4 * q + 2] = w.z;
    v[4 * q + 3] = w.w;
  }
}

__device__ __forceinline__ void store_row(int32_t* __restrict__ dst,
                                          const int32_t (&v)[kPerThread],
                                          int tid) {
  int4* d = reinterpret_cast<int4*>(dst) + tid * (kPerThread / 4);
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q)
    d[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <bool kRecord>
__global__ void __launch_bounds__(kThreads, 1)
    bitonic_sort_kernel(const int32_t* __restrict__ keys,
                        const int32_t* __restrict__ payload,
                        int32_t* __restrict__ out_keys,
                        int32_t* __restrict__ out_payload) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* buf0 = reinterpret_cast<int32_t*>(smem);
  int32_t* buf1 = buf0 + kSlots;  // without kRecord only
  uint8_t* masks = smem + kSlots * 4;  // with kRecord only
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * kSlots;

  int32_t k[kPerThread], p[kPerThread];
  load_row(keys + row, k, tid);
  load_row(payload + row, p, tid);

  int lo = 0, part = tid << 4;
  int stage = 0;
  for (int kk = 1; kk <= kLogSlots; ++kk) {
    for (int hi = kk - 1; hi >= 0;) {
      const int c_lo = hi > 3 ? hi - 3 : 0;
      if (c_lo != lo) relayout<kRecord>(buf0, buf1, k, p, tid, part, lo, c_lo);
      const bool dir_t = (part >> kk) & 1;
      const int dir_r = kk >= lo && kk < lo + 4 ? 1 << (kk - lo) : 0;
      for (int j = hi; j >= lo; --j) {
        const uint32_t bits = ce_dispatch(j - lo, k, p, dir_t, dir_r);
        if constexpr (kRecord)
          masks[stage * kThreads + tid] = static_cast<uint8_t>(bits);
        ++stage;
      }
      hi = lo - 1;
    }
  }
  // The last chunk (merge 2^14, strides 2 and 1) ran in layout 0.
  store_row(out_keys + row, k, tid);

  // Reverse replay: the same chunks in reverse order, each chunk's stages
  // from its lowest stride up; only the payload moves.  Every swap is a
  // transposition, so undoing them in reverse restores the input order.
  if constexpr (kRecord) {
    for (int kk = kLogSlots; kk >= 1; --kk) {
      const int chunks = (kk + 3) / 4;
      for (int c = chunks - 1; c >= 0; --c) {
        const int hi = kk - 1 - 4 * c;
        const int c_lo = hi > 3 ? hi - 3 : 0;
        if (c_lo != lo) {
          const int to_part = thread_part(tid, c_lo);
          put(buf0, p, part, lo);
          __syncthreads();
          get(buf0, p, to_part, c_lo);
          __syncthreads();
          lo = c_lo;
          part = to_part;
        }
        for (int j = lo; j <= hi; ++j) {
          --stage;
          replay_dispatch(j - lo, p, masks[stage * kThreads + tid]);
        }
      }
    }
  }
  store_row(out_payload + row, p, tid);
}

const void* kernel_of(bool record) {
  return record ? reinterpret_cast<const void*>(bitonic_sort_kernel<true>)
                : reinterpret_cast<const void*>(bitonic_sort_kernel<false>);
}

}  // namespace

// keys, payload, out_keys, out_payload: (n_blocks, 16384) int32, contiguous,
// 16-byte aligned.  Launches on `stream` and returns the first CUDA error
// of the attribute call or the launch (0 on success); never synchronises.
extern "C" int bitonic_sort_launch(const void* keys, const void* payload,
                                   void* out_keys, void* out_payload,
                                   long long n_blocks, int record,
                                   void* stream) {
  if (n_blocks < 0 || n_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(payload) |
       reinterpret_cast<uintptr_t>(out_keys) |
       reinterpret_cast<uintptr_t>(out_payload)) % 16)
    return cudaErrorMisalignedAddress;
  if (n_blocks == 0) return cudaSuccess;
  const bool rec = record != 0;
  const size_t smem = smem_bytes(rec);
  cudaError_t err = cudaFuncSetAttribute(
      kernel_of(rec), cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_blocks);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* p = static_cast<const int32_t*>(payload);
  auto* ok = static_cast<int32_t*>(out_keys);
  auto* op = static_cast<int32_t*>(out_payload);
  if (rec)
    bitonic_sort_kernel<true><<<grid, kThreads, smem, s>>>(k, p, ok, op);
  else
    bitonic_sort_kernel<false><<<grid, kThreads, smem, s>>>(k, p, ok, op);
  return cudaGetLastError();
}

// Registers per thread, dynamic shared memory per CTA and resident CTAs per
// SM of one variant on the current device; returns the first CUDA error.
extern "C" int bitonic_sort_attributes(int record, int* regs, int* smem,
                                       int* ctas) {
  const bool rec = record != 0;
  const void* kernel = kernel_of(rec);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(rec)));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(smem_bytes(rec) + attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads,
                                                       smem_bytes(rec));
}

extern "C" const char* bitonic_sort_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
