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
// The network.  Merge kk (1..14) sorts runs of 2^kk slots, ascending where
// slot bit kk is 0, by the stages j = kk-1 .. 0: slot s against s ^ 2^j,
// swapped iff strictly out of order, so equal keys never swap and the
// payload follows the compare's own outcome (the TPU kernel's
// `new_key != key`).  Stage s of the 105 is kk(kk-1)/2 + (kk-1-j).
//
// Design: K2's register-resident scheme (csrc/match_kernel.cu) with the
// payload carried along.  1,024 threads hold 16 keys and 16 payload words
// each.  Three layouts map (thread, register) to slots:
//   B  slot 16 tid + r: bits 0-3 in registers, 4-8 across lanes, 9-13
//      across warps;
//   T  slot 512 warp + 32 r + lane: bits 5-8 in registers, a warp's span
//      as in B;
//   X  for merge kk = 10..13, bits kk-4 .. kk-1 in registers (register r at
//      slot part | r << (kk-4), the thread's bits filling the rest in
//      order), so a warp holds slots of one merge group; for merge 14, bits
//      9-12 in registers, bit 13 on lane bit 4, bits 0-3 on lanes 0-3 and
//      4-8 across warps.
// Merges 1-9 stay in B: strides 1-8 between registers, 16-256 by
// __shfl_xor_sync (two shuffles a stage, key and payload).  Merge kk >= 10
// goes B -> X (strides 2^9 .. 2^(kk-1); merge 14's stride 8192 by a
// shuffle) -> T (strides 32-256) -> B (stride 16 by a shuffle, 1-8 in
// registers).  The keys of the halves a merge sorts descending are held
// complemented (~x reverses the signed order), so every stage from merge
// 4 on is ascending: a compare, then the minimum to the lower slot and
// the payload after it (a min, a max and two selects).  Merges 1-3 keep
// plain keys, their directions known at compile time.  The schedule is
// unrolled at compile time: no runtime stage switch, and every
// shared-memory address is a per-thread base plus or XOR a constant.
//
// Synchronisation.  In merge kk data flows only inside aligned groups of
// 2^(kk-4) threads.  B -> X and X -> T cross warps inside that group and
// wait at a named barrier for it (merges 10 and 11: groups of 128 threads,
// barriers 1-8; merge 12: 256, barriers 9-12; merge 13: 512, barriers 13
// and 14); only merge 14 waits for the whole CTA.  T -> B stays in a warp
// (__syncwarp).  The sort passes 2 CTA-wide barriers and 8 group barriers
// a thread (the replay variant's forward pass 6 and 24, its replay 2 and
// 8); K2 passes 11 CTA-wide ones.
//
// Shared memory.  Keys and payload each have a 64 KiB exchange buffer.  A
// slot is stored at slot ^ (bits 5,6 of the slot << 2) ^ (bit 13 << 4):
// the 16-byte stores and loads of B and the 4-byte accesses of T and X
// each touch every bank once per wavefront.
//
// Swap masks (kRecord).  A stage decides 8,192 swaps, a byte a thread: the
// 8 register pairs of a register stage, or, in a shuffle stage, half of the
// 16 pairs a lane shares with its partner (the lower lane keeps the bits
// of registers 0-7, the upper lane those of 8-15; the replay fetches the
// partner's byte by a shuffle), at masks[stage * 1024 + tid].  The 105
// stages take 105 KiB a block; with both exchange buffers that is 233 KiB,
// past the 227 KiB a CTA may hold.  So the replay variant keeps one 64 KiB
// buffer, 173,056 bytes in all, and its forward pass moves keys and
// payload through it in turn: each exchange waits three times (stored,
// read, the payload stored), not once.  (Parking the bytes of the stages
// before the first exchange outside shared memory instead, a word or a
// byte a stage, in registers or in the payload output, made ptxas 12.9
// fail to allocate the forward pass in 64 registers.)  The replay visits
// the same layouts in reverse with the payload alone, so a thread reads
// back its own bytes.
//
// What bounds it.  Device memory is not the limit: 4 x 64 KiB a block, 0.16
// ms at 2,048 blocks and 3.35 TB/s.  The network is: 105 x 8,192
// compare-exchanges a block, each a compare and four selects, 84 of the
// 105 stages between registers and 21 by shuffles (two shuffles, a
// min/max, a compare and a select a key each), and 15 exchanges through
// shared memory (128 KiB each way a block), 10 of them across warps.  One
// CTA of 1,024 threads a SM (__launch_bounds__(1024, 1): 64 registers a
// thread).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLogSlots = 14;
constexpr int kSlots = 1 << kLogSlots;       // 16,384
constexpr int kThreads = 1024;
constexpr int kPerThread = kSlots / kThreads;  // 16
constexpr int kStages = kLogSlots * (kLogSlots + 1) / 2;  // 105
constexpr int kFirstExchangeMerge = 10;  // merges 2^10 and up leave layout B
constexpr unsigned kFull = 0xffffffffu;

// Two exchange buffers; with the replay one, and a byte a thread a stage.
__host__ __device__ constexpr size_t smem_bytes(bool record) {
  return record ? static_cast<size_t>(kSlots) * 4 +
                      static_cast<size_t>(kStages) * kThreads
                : static_cast<size_t>(kSlots) * 8;
}

__host__ __device__ constexpr int stage_index(int kk, int j) {
  return kk * (kk - 1) / 2 + (kk - 1 - j);
}

// The word a slot takes in an exchange buffer (see "Shared memory").
__device__ __forceinline__ int swizzle(int slot) {
  return slot ^ (((slot >> 5) & 3) << 2) ^ (((slot >> 13) & 1) << 4);
}

// Waits for the threads that exchange with this one in merge KK: the CTA
// for merge 14, else the thread's aligned group on a named barrier.
template <int KK>
__device__ __forceinline__ void group_sync(int tid) {
  if constexpr (KK == kLogSlots) {
    __syncthreads();
  } else {
    constexpr int log_threads = KK <= 11 ? 7 : KK - 4;
    constexpr int first = KK <= 11 ? 1 : (KK == 12 ? 9 : 13);
    asm volatile("bar.sync %0, %1;" ::"r"(first + (tid >> log_threads)),
                 "n"(1 << log_threads)
                 : "memory");
  }
}

// ---- compare-exchange stages -------------------------------------------

// Registers r and r | 2^Q of every thread, pair by pair in r order:
// ascending, or for Dir >= 0 descending where register bit Dir is set
// (merges 1-3 in layout B).  Returns the 8 swap bits.
template <int Q, int Dir>
__device__ __forceinline__ uint32_t reg_stage(int32_t (&k)[kPerThread],
                                              int32_t (&p)[kPerThread]) {
  uint32_t bits = 0;
  int pair = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & (1 << Q)) continue;
    const int s = r | (1 << Q);
    const bool desc = Dir >= 0 && (r & (1 << (Dir < 0 ? 0 : Dir))) != 0;
    const int32_t a = k[r], b = k[s];
    const bool swap = desc ? a < b : a > b;
    k[r] = swap ? b : a;
    k[s] = swap ? a : b;
    const int32_t pa = p[r], pb = p[s];
    p[r] = swap ? pb : pa;
    p[s] = swap ? pa : pb;
    // A predicated OR: shifting the bool in made ptxas spill the replay
    // variant and cost it a third of its time.
    if (swap) bits |= 1u << pair;
    ++pair;
  }
  return bits;
}

template <int Q>
__device__ __forceinline__ void replay_reg_stage(int32_t (&p)[kPerThread],
                                                 uint32_t bits) {
  int pair = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & (1 << Q)) continue;
    const int s = r | (1 << Q);
    if (bits & (1u << pair)) {  // a bit test, two predicated moves
      const int32_t t = p[r];
      p[r] = p[s];
      p[s] = t;
    }
    ++pair;
  }
}

// min(a, b) if take_min, else max(a, b), as PTX selects: written in C++ the
// choice on a lane-dependent flag became a branch, which split every warp
// around the shuffles of a stage.
__device__ __forceinline__ int32_t min_or_max(int32_t a, int32_t b,
                                              uint32_t take_min) {
  int32_t r;
  asm("{\n\t.reg .pred p;\n\t.reg .s32 lo, hi;\n\t"
      "setp.ne.u32 p, %3, 0;\n\tmin.s32 lo, %1, %2;\n\t"
      "max.s32 hi, %1, %2;\n\tselp.s32 %0, lo, hi, p;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(take_min));
  return r;
}

// An ascending stage between lanes l and l ^ M, register by register: the
// lower lane keeps the minimum.  Both lanes see the same swap (the pair was
// strictly out of order), so the payload moves with the key.  Returns the
// lane's byte of the stage's swap bits.
template <int M>
__device__ __forceinline__ uint32_t shfl_stage(int32_t (&k)[kPerThread],
                                               int32_t (&p)[kPerThread],
                                               int lane) {
  const uint32_t lower = (lane & M) == 0;
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int32_t yk = __shfl_xor_sync(kFull, k[r], M);
    const int32_t yp = __shfl_xor_sync(kFull, p[r], M);
    const int32_t nk = min_or_max(k[r], yk, lower);
    const bool swap = nk != k[r];
    p[r] = swap ? yp : p[r];
    k[r] = nk;
    if (swap) bits |= 1u << r;
  }
  return lower ? bits & 0xffu : bits >> 8;
}

template <int M>
__device__ __forceinline__ void replay_shfl_stage(int32_t (&p)[kPerThread],
                                                  uint32_t byte, int lane) {
  const uint32_t other = __shfl_xor_sync(kFull, byte, M);
  const uint32_t bits =
      (lane & M) == 0 ? byte | (other << 8) : other | (byte << 8);
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int32_t yp = __shfl_xor_sync(kFull, p[r], M);
    p[r] = (bits >> r) & 1u ? yp : p[r];
  }
}

// ---- the layouts' shared-memory addresses -------------------------------

// B: register r of thread tid at slot 16 tid + r, moved as four 16-byte
// words; word q's int4 index is base ^ q.
__device__ __forceinline__ void store_b(int32_t* buf,
                                        const int32_t (&v)[kPerThread],
                                        int tid) {
  int4* w = reinterpret_cast<int4*>(buf);
  const int base = swizzle(16 * tid) >> 2;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    w[base ^ q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void load_b(const int32_t* buf,
                                       int32_t (&v)[kPerThread], int tid) {
  const int4* w = reinterpret_cast<const int4*>(buf);
  const int base = swizzle(16 * tid) >> 2;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 x = w[base ^ q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// T: register r at slot 512 warp + 32 r + lane; its word is
// (base ^ (r & 3) << 2) + 32 r.
template <bool kStore>
__device__ __forceinline__ void move_t(int32_t* buf, int32_t (&v)[kPerThread],
                                       int tid) {
  const int base = swizzle((tid >> 5) * 512 + (tid & 31));
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int at = (base ^ ((r & 3) << 2)) + 32 * r;
    if constexpr (kStore) buf[at] = v[r];
    else v[r] = buf[at];
  }
}

// X of merge KK: the slot bits the thread holds (register 0's slot).
template <int KK>
__device__ __forceinline__ int x_part(int tid) {
  if constexpr (KK == kLogSlots) {
    const int lane = tid & 31;
    return (lane & 15) | ((lane >> 4) << 13) | ((tid >> 5) << 4);
  } else {
    constexpr int xs = KK - 4;
    return (tid & ((1 << xs) - 1)) | ((tid >> xs) << (xs + 4));
  }
}

template <int KK, bool kStore>
__device__ __forceinline__ void move_x(int32_t* buf, int32_t (&v)[kPerThread],
                                       int tid) {
  constexpr int xs = KK == kLogSlots ? 9 : KK - 4;
  const int base = swizzle(x_part<KK>(tid));
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    // At xs = 6 register bit 0 is slot bit 6, which the swizzle folds into
    // word bit 3; every other register bit lies above the swizzled ones.
    const int at = (base ^ (xs == 6 ? (r & 1) << 3 : 0)) + (r << xs);
    if constexpr (kStore) buf[at] = v[r];
    else v[r] = buf[at];
  }
}

// ---- the sort ------------------------------------------------------------

template <bool kRecord>
struct BlockSort {
  int32_t k[kPerThread];
  int32_t p[kPerThread];
  int32_t* kbuf;
  int32_t* pbuf;       // kRecord: kbuf, keys and payload in turn
  uint8_t* masks;      // kRecord: a byte a thread a stage
  int tid;
  int lane;

  template <int S>
  __device__ __forceinline__ void record(uint32_t byte) {
    if constexpr (kRecord)
      masks[S * kThreads + tid] = static_cast<uint8_t>(byte);
  }

  template <int S>
  __device__ __forceinline__ uint32_t recorded() const {
    return masks[S * kThreads + tid];
  }

  // Stage j of merge KK in layout B.
  template <int KK, int J>
  __device__ __forceinline__ void b_stage() {
    if constexpr (J >= 4)
      record<stage_index(KK, J)>(shfl_stage<1 << (J - 4)>(k, p, lane));
    else
      record<stage_index(KK, J)>(reg_stage<J, (KK <= 3 ? KK : -1)>(k, p));
  }

  template <int KK, int J>
  __device__ __forceinline__ void b_stages() {  // strides 2^J .. 1
    b_stage<KK, J>();
    if constexpr (J > 0) b_stages<KK, J - 1>();
  }

  // Stages J .. Lo in a layout whose register bit 0 is slot bit Shift.
  template <int KK, int J, int Lo, int Shift>
  __device__ __forceinline__ void reg_stages() {
    record<stage_index(KK, J)>(reg_stage<J - Shift, -1>(k, p));
    if constexpr (J > Lo) reg_stages<KK, J - 1, Lo, Shift>();
  }

  template <int KK>
  __device__ __forceinline__ void merge() {
    if constexpr (KK >= 4) {
      // Complement the keys of the halves merge KK sorts descending, and
      // restore those merge KK-1 held complemented: slot bits KK and KK-1
      // are thread bits of layout B.
      const int flip = KK == 4 ? -(tid & 1)
                               : -(((tid >> (KK - 4)) ^ (tid >> (KK - 5))) & 1);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) k[r] ^= flip;
    }
    if constexpr (KK < kFirstExchangeMerge) {
      b_stages<KK, KK - 1>();
    } else {
      store_b(kbuf, k, tid);
      if constexpr (!kRecord) store_b(pbuf, p, tid);
      group_sync<KK>(tid);
      move_x<KK, false>(kbuf, k, tid);
      if constexpr (kRecord) {  // the payload through the same buffer
        group_sync<KK>(tid);
        store_b(pbuf, p, tid);
        group_sync<KK>(tid);
      }
      move_x<KK, false>(pbuf, p, tid);
      if constexpr (KK == kLogSlots) {
        record<stage_index(KK, 13)>(shfl_stage<16>(k, p, lane));
        reg_stages<KK, 12, 9, 9>();
      } else {
        reg_stages<KK, KK - 1, 9, KK - 4>();
      }
      move_x<KK, true>(kbuf, k, tid);
      if constexpr (!kRecord) move_x<KK, true>(pbuf, p, tid);
      group_sync<KK>(tid);
      move_t<false>(kbuf, k, tid);
      if constexpr (kRecord) {
        group_sync<KK>(tid);
        move_x<KK, true>(pbuf, p, tid);
        group_sync<KK>(tid);
      }
      move_t<false>(pbuf, p, tid);
      reg_stages<KK, 8, 5, 5>();
      move_t<true>(kbuf, k, tid);
      if constexpr (!kRecord) move_t<true>(pbuf, p, tid);
      __syncwarp();
      load_b(kbuf, k, tid);
      if constexpr (kRecord) {
        __syncwarp();
        move_t<true>(pbuf, p, tid);
        __syncwarp();
      }
      load_b(pbuf, p, tid);
      b_stages<KK, 4>();
    }
  }

  template <int KK>
  __device__ __forceinline__ void merges() {
    merge<KK>();
    if constexpr (KK < kLogSlots) merges<KK + 1>();
  }

  // ---- the replay: the payload's swaps undone in reverse stage order -----

  template <int KK, int J>
  __device__ __forceinline__ void replay_b_stage() {
    if constexpr (J >= 4)
      replay_shfl_stage<1 << (J - 4)>(p, recorded<stage_index(KK, J)>(), lane);
    else
      replay_reg_stage<J>(p, recorded<stage_index(KK, J)>());
  }

  template <int KK, int J, int Hi>
  __device__ __forceinline__ void replay_b_stages() {  // strides 2^J .. 2^Hi
    replay_b_stage<KK, J>();
    if constexpr (J < Hi) replay_b_stages<KK, J + 1, Hi>();
  }

  template <int KK, int J, int Hi, int Shift>
  __device__ __forceinline__ void replay_reg_stages() {
    replay_reg_stage<J - Shift>(p, recorded<stage_index(KK, J)>());
    if constexpr (J < Hi) replay_reg_stages<KK, J + 1, Hi, Shift>();
  }

  template <int KK>
  __device__ __forceinline__ void unmerge() {
    if constexpr (KK < kFirstExchangeMerge) {
      replay_b_stages<KK, 0, KK - 1>();
    } else {
      replay_b_stages<KK, 0, 4>();
      store_b(pbuf, p, tid);
      __syncwarp();
      move_t<false>(pbuf, p, tid);
      replay_reg_stages<KK, 5, 8, 5>();
      move_t<true>(pbuf, p, tid);
      group_sync<KK>(tid);
      move_x<KK, false>(pbuf, p, tid);
      if constexpr (KK == kLogSlots) {
        replay_reg_stages<KK, 9, 12, 9>();
        replay_shfl_stage<16>(p, recorded<stage_index(KK, 13)>(), lane);
      } else {
        replay_reg_stages<KK, 9, KK - 1, KK - 4>();
      }
      move_x<KK, true>(pbuf, p, tid);
      group_sync<KK>(tid);
      load_b(pbuf, p, tid);
    }
  }

  template <int KK>
  __device__ __forceinline__ void unmerges() {
    unmerge<KK>();
    if constexpr (KK > 1) unmerges<KK - 1>();
  }
};

// Layout B's 16 slots of a thread, four 16-byte words.
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

__device__ __forceinline__ void store_row(int32_t* dst,
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
  const size_t row = static_cast<size_t>(blockIdx.x) * kSlots;
  BlockSort<kRecord> s;
  s.tid = threadIdx.x;
  s.lane = threadIdx.x & 31;
  s.kbuf = reinterpret_cast<int32_t*>(smem);
  s.pbuf = kRecord ? s.kbuf : s.kbuf + kSlots;
  s.masks = smem + static_cast<size_t>(kSlots) * 4;
  load_row(keys + row, s.k, s.tid);
  load_row(payload + row, s.p, s.tid);
  s.template merges<1>();
  // Merge 14 ended in layout B with plain keys.
  store_row(out_keys + row, s.k, s.tid);
  if constexpr (kRecord) s.template unmerges<kLogSlots>();
  store_row(out_payload + row, s.p, s.tid);
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
