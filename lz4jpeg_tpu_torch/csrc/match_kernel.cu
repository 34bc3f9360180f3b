// Fused LZ4 match-candidate kernel for Hopper (sm_90a): one CTA per block
// (16 KiB on the main path), sort → neighbour candidates → un-sort, with
// nothing in device memory between the phases.
//
// Replaces lz4jpeg_tpu/ops/pallas_match.py::_match_kernel, the Pallas TPU
// kernel, together with the key/payload pre-pass of its wrapper
// fast_match_blocks_pallas.  For block b with anchors a = 0..Pa-1 (byte
// s·a, s = stride) it computes what that kernel returns:
//   1. key[a] = (h << pos_bits) | a with h = (w32 · 2654435761 mod 2^32)
//      >> 16 of the 4-byte little-endian window at s·a, or the unique
//      bucket 0x10000 + a when the window passes the block's length;
//   2. an ascending sort of the (unique) keys;
//   3. per sorted slot, the 1-back and 2-back neighbours in the same valid
//      bucket: lcp = leading equal bytes of the suffixes at s·pos and
//      s·pos_prev, capped at 4·lcp_words; a neighbour counts when
//      lcp ≥ 4; the longer lcp wins and ties keep the 1-back neighbour;
//   4. out[b, pos] = (lcp << pos_bits) | (pos - pos_prev), or 0.
// The TPU kernel carried payload words through its network and replayed
// the swaps backwards, because TPU scatters serialize.  Here the keys alone
// are sorted (they carry the anchor in their low bits), each lcp is read
// from the block's bytes staged in shared memory (P + 32 zero bytes: bytes
// past P read 0, as the wrapper's zero-padded payload words do), and the
// results are placed at their anchors in shared memory, then written out.
//
// What bounds it.  Device memory is not the limit: a block reads P bytes
// and writes 4·Pa (168 MB at 2048 × 16 KiB, 0.050 ms at 3.35 TB/s).  The
// sort is: log2(Pa)·(log2(Pa)+1)/2 = 105 bitonic stages at Pa = 16,384, each
// 8,192 compare-exchanges.  Run in shared memory, each stage is a full pass
// behind a CTA barrier (the earlier version: ~2 ms).  Here the network's
// compare and shuffle instructions, and the lcp reads of the candidates,
// bound it.
//
// Design (a), a register-resident bitonic sort.  Keys are padded with
// INT32_MAX sentinels to n = max(Pa, 512); n/16 threads each hold 16 keys
// in registers.  Three layouts map registers to sort slots (see the sort
// below): B, 16 consecutive slots per thread; T, slots 32 apart within a
// warp; X, slots 2^xs apart across warps.  Merges up to 512 run in B:
// strides 1-8 inside the thread, 16-256 by __shfl_xor_sync.  A merge k ≥
// 1024 goes through shared memory twice, B → X → T, and then within the
// warp back to B, so that every stride runs in registers but 16 (one
// shuffle stage); at n = 16,384 the stride 8192 is one shared-memory pass.
// That is 11 CTA barriers in the sort at Pa = 16,384 instead of 105.  The
// keys of the halves a merge sorts descending are held complemented (~x
// reverses the signed order), so every compare-exchange is a plain min and
// max with no direction select.  A radix sort, option (b), would scatter
// every key through shared memory once per digit pass and rank it with a
// block-wide scan; the anchor in the key's low bits makes a comparison
// network give the stable order for free.
//
// The budget.  16 keys in registers need more than the 32 registers that
// 2,048 resident threads (two 1,024-thread CTAs per SM) would leave, so
// the kernel runs one CTA per SM (__launch_bounds__(1024, 1); 47 registers)
// with its 82 KB of shared memory (keys, bytes).
//
// Candidates come from registers too: the slots before a thread's first
// come by a shuffle from the lane before, or across a warp through a
// 256-byte edge array.  lcp compares four 4-byte windows (funnel shifts of
// five staged words, loaded together) without a branch, and the 2-back
// neighbour is skipped when the 1-back one already reaches the cap.
// Results go to shared memory at their anchor and leave as 16-byte
// coalesced stores, not as scattered 4-byte stores.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kPerThread = 16;                  // sort slots in registers
constexpr int kWarpSpan = 32 * kPerThread;      // 512: strides below stay in a warp
constexpr int kMaxSlots = 1024 * kPerThread;    // one 1,024-thread CTA
constexpr int kEdgeBytes = 32 * 2 * 4;          // two keys per warp
constexpr uint32_t kHashMult = 2654435761u;
constexpr uint32_t kInvalidBucket = 0x10000u;
constexpr int32_t kSentinel = 0x7fffffff;
constexpr int kPad = 32;  // zero bytes after the block: windows read ≤ 19 ahead
constexpr int kMaxLcpBytes = 16;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int sort_slots(int pa) {
  return pa < kWarpSpan ? kWarpSpan : pa;
}

// The 4 bytes at byte offset s of the staged block, little-endian.
__device__ __forceinline__ uint32_t window(const uint32_t* words, int s) {
  return __funnelshift_r(words[s >> 2], words[(s >> 2) + 1], (s & 3) * 8);
}

// The four 4-byte windows at byte offsets s, s+4, s+8, s+12 of the staged
// block (five word loads, issued together).
__device__ __forceinline__ void windows(const uint32_t* words, int s,
                                        uint32_t (&w)[4]) {
  const uint32_t* p = words + (s >> 2);
  uint32_t a[5];
#pragma unroll
  for (int q = 0; q < 5; ++q) a[q] = p[q];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = __funnelshift_r(a[q], a[q + 1], (s & 3) * 8);
}

// Leading equal bytes of the suffixes whose windows are wx and those at
// byte y, capped at cap (a multiple of 4, ≤ 16); branch-free.
__device__ __forceinline__ int lcp_len(const uint32_t (&wx)[4],
                                       const uint32_t* words, int y, int cap) {
  uint32_t wy[4];
  windows(words, y, wy);
  int lcp = cap;
#pragma unroll
  for (int q = 3; q >= 0; --q) {
    const uint32_t d = wx[q] ^ wy[q];
    if (4 * q < cap && d != 0) lcp = 4 * q + (__ffs(d) - 1) / 8;
  }
  return lcp;
}

// Sorting direction.  During merge k every register holds its slot's key
// XOR flip_k(slot), all ones where the slot's bit k is set (the halves
// merged descending), else 0.  ~x = -1 - x reverses the signed order, so
// every compare-exchange of the merge is ascending: min to the lower slot.
// Merges 2, 4 and 8 stay inside a thread and take plain keys with
// directions known at compile time.
template <int K, int R>
__device__ __forceinline__ void small_stage(int32_t (&v)[kPerThread]) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & R) continue;
    const int32_t lo = min(v[r], v[r | R]);
    const int32_t hi = max(v[r], v[r | R]);
    v[r] = (r & K) ? hi : lo;
    v[r | R] = (r & K) ? lo : hi;
  }
}

// An ascending stage inside a thread: register r against register r | R.
template <int R>
__device__ __forceinline__ void reg_stage(int32_t (&v)[kPerThread]) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (r & R) continue;
    const int32_t lo = min(v[r], v[r | R]);
    v[r | R] = max(v[r], v[r | R]);
    v[r] = lo;
  }
}

// The stages of strides j_hi down to j_lo, powers of two inside the
// thread's register bits [shift, shift + 4).
__device__ __forceinline__ void reg_stages(int32_t (&v)[kPerThread], int shift,
                                           int j_hi, int j_lo) {
  for (int j = j_hi; j >= j_lo; j >>= 1) {
    switch (j >> shift) {
      case 8: reg_stage<8>(v); break;
      case 4: reg_stage<4>(v); break;
      case 2: reg_stage<2>(v); break;
      default: reg_stage<1>(v); break;
    }
  }
}

// An ascending stage of stride 16·lane_mask across the lanes of a warp.
__device__ __forceinline__ void shfl_stage(int32_t (&v)[kPerThread],
                                           int lane_mask, bool keep_min) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int32_t y = __shfl_xor_sync(kFull, v[r], lane_mask);
    v[r] = keep_min ? min(v[r], y) : max(v[r], y);
  }
}

__global__ void __launch_bounds__(1024, 1)
    match_kernel(const uint8_t* __restrict__ blocks,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ out, int p, int stride, int pa,
                 int pos_bits, int lcp_bytes, bool vec_load, bool vec_store) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = sort_slots(pa);
  int32_t* keys = reinterpret_cast<int32_t*>(smem);
  int32_t* edge = keys + n;
  uint8_t* bytes = smem + n * 4 + kEdgeBytes;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int threads = blockDim.x;  // n / 16
  const int base = tid * kPerThread;

  const int64_t b = blockIdx.x;
  const uint8_t* row = blocks + b * p;
  const int len = lengths[b];

  // ---- stage the block's bytes (and kPad zero bytes) ---------------------
  if (vec_load) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(bytes);
    for (int i = tid; i < p / 16; i += threads) dst[i] = src[i];
  } else {
    for (int i = tid; i < p; i += threads) bytes[i] = row[i];
  }
  if (tid < kPad) bytes[p + tid] = 0;
  __syncthreads();

  // ---- keys, straight into registers --------------------------------------
  int32_t v[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int a = base + r;
    if (a >= pa) {
      v[r] = kSentinel;
      continue;
    }
    const int s = a * stride;
    const uint32_t h = s + 4 <= len ? (window(words, s) * kHashMult) >> 16
                                    : kInvalidBucket + static_cast<uint32_t>(a);
    v[r] = static_cast<int32_t>((h << pos_bits) | static_cast<uint32_t>(a));
  }

  // ---- bitonic sort, ascending ---------------------------------------------
  // A thread's 16 keys are the sort slots of one of three layouts:
  //   B (blocked): slot 16·tid + r — slot bits 0-3 in registers, 4-8 across
  //     the lanes (__shfl_xor_sync), 9 and up across warps;
  //   T (warp-transposed): slot 512·warp + 32·r + lane — bits 5-8 in
  //     registers;
  //   X (across warps): bits [xs, xs + 4) in registers, xs = min(9, L - 4)
  //     for n = 2^L slots; the thread's bits fill the rest.
  // A merge k ≤ 512 stays in B: strides 16-256 by shuffles, 1-8 in
  // registers.  A merge k ≥ 1024 goes B → shared memory → X (strides ≥ 512
  // in registers; at n = 16,384 the stride 8192 is one shared-memory pass
  // before) → shared memory → T (strides 32-256) → B within the warp
  // (stride 16 by shuffle, 1-8 in registers).  At Pa = 16,384 the sort
  // passes 11 CTA barriers: two per merge k = 1024..8192, three at 16,384.
  const int log_n = 31 - __clz(n);
  const int xs = min(9, log_n - 4);
  const int x_base = (tid & ((1 << xs) - 1)) | ((tid >> xs) << (xs + 4));
  const int t_base = warp * kWarpSpan + lane;
  int4* own = reinterpret_cast<int4*>(keys + base);
  small_stage<2, 1>(v);
  small_stage<4, 2>(v);
  small_stage<4, 1>(v);
  small_stage<8, 4>(v);
  small_stage<8, 2>(v);
  small_stage<8, 1>(v);
  for (int k = 16; k <= n; k <<= 1) {
    // flip_{k/2} ^ flip_k of this thread's slots 16·tid + r: bit 4 and up
    // of the slot are the thread's, so one value serves all 16 registers
    // (merge 8 took plain keys: flip_8 is 0 here).
    const int lk = 31 - __clz(k);
    const int32_t flip = k == 16 ? -((base >> 4) & 1)
                                 : -(((base >> (lk - 1)) ^ (base >> lk)) & 1);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) v[r] ^= flip;
    int j = k >> 1;
    if (j >= kWarpSpan) {
#pragma unroll
      for (int q = 0; q < kPerThread / 4; ++q) {
        own[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      __syncthreads();
      for (; j >= (kPerThread << xs); j >>= 1) {  // beyond X's registers
        for (int t = tid; t < n / 2; t += threads) {
          const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
          const int32_t x = keys[i];
          const int32_t y = keys[i | j];
          keys[i] = min(x, y);
          keys[i | j] = max(x, y);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) v[r] = keys[x_base + (r << xs)];
      reg_stages(v, xs, j, kWarpSpan);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) keys[x_base + (r << xs)] = v[r];
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) v[r] = keys[t_base + 32 * r];
      reg_stages(v, 5, kWarpSpan / 2, 32);
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) keys[t_base + 32 * r] = v[r];
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kPerThread / 4; ++q) {
        const int4 w = own[q];
        v[4 * q] = w.x;
        v[4 * q + 1] = w.y;
        v[4 * q + 2] = w.z;
        v[4 * q + 3] = w.w;
      }
      j = kPerThread;
    }
    for (; j >= kPerThread; j >>= 1) {
      const int lane_mask = j / kPerThread;
      shfl_stage(v, lane_mask, (lane & lane_mask) == 0);
    }
    reg_stages(v, 0, kPerThread / 2, 1);
  }
  // After merge n, flip_n is 0 on every slot: the registers hold plain keys.

  // ---- neighbour candidates, placed at their anchors -----------------------
  if (lane == 31) {
    edge[2 * warp] = v[kPerThread - 2];
    edge[2 * warp + 1] = v[kPerThread - 1];
  }
  __syncthreads();  // also: every thread has read its keys back
  int32_t before2 = __shfl_up_sync(kFull, v[kPerThread - 2], 1);
  int32_t before1 = __shfl_up_sync(kFull, v[kPerThread - 1], 1);
  if (lane == 0) {
    before2 = warp > 0 ? edge[2 * warp - 2] : kSentinel;
    before1 = warp > 0 ? edge[2 * warp - 1] : kSentinel;
  }
  const int32_t mask = (1 << pos_bits) - 1;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    if (base + r >= pa) break;  // sentinels sort last
    const int32_t key = v[r];
    const int32_t bucket = key >> pos_bits;
    const int32_t pos = key & mask;
    const int32_t prev1 = r >= 1 ? v[r - 1] : before1;
    const int32_t prev2 = r >= 2 ? v[r - 2] : (r == 1 ? before1 : before2);
    int best_len = 0;
    int best_dist = 0;
    if (bucket < static_cast<int32_t>(kInvalidBucket) &&
        (prev1 >> pos_bits) == bucket) {
      uint32_t wx[4];
      windows(words, pos * stride, wx);
      const int32_t p1 = prev1 & mask;
      const int l1 = lcp_len(wx, words, p1 * stride, lcp_bytes);
      if (l1 >= 4) {
        best_len = l1;
        best_dist = pos - p1;
      }
      // Sorted: if 1-back is in another bucket, so is 2-back; and 2-back
      // wins only with a longer lcp than a capped 1-back.
      if (l1 < lcp_bytes && (prev2 >> pos_bits) == bucket) {
        const int32_t p2 = prev2 & mask;
        const int l2 = lcp_len(wx, words, p2 * stride, lcp_bytes);
        if (l2 >= 4 && l2 > best_len) {
          best_len = l2;
          best_dist = pos - p2;
        }
      }
    }
    keys[pos] = best_dist > 0 ? (best_len << pos_bits) | best_dist : 0;
  }
  __syncthreads();

  // ---- the row, in anchor order, as coalesced stores ----------------------
  int32_t* orow = out + b * pa;
  if (vec_store) {
    const int4* src = reinterpret_cast<const int4*>(keys);
    int4* dst = reinterpret_cast<int4*>(orow);
    for (int i = tid; i < pa / 4; i += threads) dst[i] = src[i];
  } else {
    for (int i = tid; i < pa; i += threads) orow[i] = keys[i];
  }
}

}  // namespace

// blocks: (n_blocks, p) uint8, contiguous; lengths: (n_blocks,) int32;
// out: (n_blocks, pa) int32 with pa = p / stride a power of two ≤ 16,384
// and (0x10000 + pa) << pos_bits < 2^31 (the wrapper checks both); lcp_bytes
// ≤ 16.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int match_candidates_launch(const void* blocks, const void* lengths,
                                       void* out, long long n_blocks, int p,
                                       int stride, int pa, int pos_bits,
                                       int lcp_bytes, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (lcp_bytes > kMaxLcpBytes || lcp_bytes % 4 != 0 || pa <= 0 ||
      pa > kMaxSlots || (pa & (pa - 1)) != 0 || pa * stride != p) {
    return cudaErrorInvalidValue;
  }
  const int n = sort_slots(pa);
  const size_t smem = static_cast<size_t>(n) * 4 + kEdgeBytes + p + kPad;
  cudaError_t err = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec_load =
      p % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  const bool vec_store =
      pa % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  match_kernel<<<static_cast<unsigned>(n_blocks), n / kPerThread, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(out), p,
      stride, pa, pos_bits, lcp_bytes, vec_load, vec_store);
  return cudaGetLastError();
}

extern "C" const char* match_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
