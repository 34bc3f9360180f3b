// Fused LZ4 match-candidate kernel for Hopper (sm_90a): one CTA per 16 KiB
// block, sort → neighbour candidates → un-sort, with nothing in device
// memory between the phases.
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
//
// Design against the TPU kernel.  The TPU kernel carried lcp_words payload
// words through its bitonic network and recorded every stage's swap mask to
// replay the network backwards, because TPU scatters serialize.  At the
// default lcp_words = 4 and stride 1 that working set (16,384 × 5 × 4 B =
// 320 KB) exceeds the 227 KB a CTA may hold.  Here the keys alone are
// sorted (they carry the anchor in their low bits), the lcp is read from the
// block's bytes staged in shared memory (P + 16 zero bytes: the bytes past
// P read 0, as the wrapper's zero-padded payload words do), and the result
// is scattered straight to out[b, pos].  Shared memory at Pa = 16,384:
// 64 KB of keys + 16 KB of bytes.
//
// What bounds it.  The bitonic network's log2(Pa)·(log2(Pa)+1)/2 stages
// (105 at Pa = 16,384), each a shared-memory pass over Pa/2 compare-
// exchanges and a CTA barrier: shared-memory bandwidth and barrier latency,
// not device memory (the kernel reads P bytes and writes 4·Pa bytes per
// block).  Register-resident warp stages or a radix sort are later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kHashMult = 2654435761u;
constexpr uint32_t kInvalidBucket = 0x10000u;
constexpr int kPad = 16;  // zero bytes after the block: lcp reads ≤ 16 ahead

__host__ __device__ constexpr int bytes_offset(int pa) {
  return (pa * 4 + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kThreads)
    match_kernel(const uint8_t* __restrict__ blocks,
                 const int32_t* __restrict__ lengths,
                 int32_t* __restrict__ out, int p, int stride, int pa,
                 int pos_bits, int lcp_bytes, bool vec_load) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* keys = reinterpret_cast<int32_t*>(smem);
  uint8_t* bytes = smem + bytes_offset(pa);

  const int64_t b = blockIdx.x;
  const uint8_t* row = blocks + b * p;
  const int len = lengths[b];

  // ---- stage the block's bytes (and 16 zero bytes) -----------------------
  if (vec_load) {
    const uint4* src = reinterpret_cast<const uint4*>(row);
    uint4* dst = reinterpret_cast<uint4*>(bytes);
    for (int i = threadIdx.x; i < p / 16; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < p; i += blockDim.x) bytes[i] = row[i];
  }
  if (threadIdx.x < kPad) bytes[p + threadIdx.x] = 0;
  __syncthreads();

  // ---- keys: hashed 4-byte window per anchor ------------------------------
  for (int a = threadIdx.x; a < pa; a += blockDim.x) {
    const int s = a * stride;
    uint32_t h;
    if (s + 4 <= len) {
      const uint32_t w = static_cast<uint32_t>(bytes[s]) |
                         (static_cast<uint32_t>(bytes[s + 1]) << 8) |
                         (static_cast<uint32_t>(bytes[s + 2]) << 16) |
                         (static_cast<uint32_t>(bytes[s + 3]) << 24);
      h = (w * kHashMult) >> 16;
    } else {
      h = kInvalidBucket + static_cast<uint32_t>(a);
    }
    keys[a] = static_cast<int32_t>((h << pos_bits) | static_cast<uint32_t>(a));
  }
  __syncthreads();

  // ---- bitonic sort of the keys, ascending --------------------------------
  for (int k = 2; k <= pa; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < pa / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));  // bit j clear
        const int l = i | j;
        const int32_t x = keys[i];
        const int32_t y = keys[l];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
  }

  // ---- neighbour candidates, scattered back to anchor order ---------------
  const int32_t mask = (1 << pos_bits) - 1;
  int32_t* orow = out + b * pa;
  for (int s = threadIdx.x; s < pa; s += blockDim.x) {
    const int32_t key = keys[s];
    const int32_t bucket = key >> pos_bits;
    const int32_t pos = key & mask;
    int best_len = 0;
    int best_dist = 0;
    if (bucket < static_cast<int32_t>(kInvalidBucket)) {
      for (int shift = 1; shift <= 2 && s >= shift; ++shift) {
        const int32_t prev = keys[s - shift];
        if ((prev >> pos_bits) != bucket) break;  // sorted: 2-back differs too
        const int32_t ppos = prev & mask;
        const uint8_t* x = bytes + pos * stride;
        const uint8_t* y = bytes + ppos * stride;
        int lcp = 0;
        while (lcp < lcp_bytes && x[lcp] == y[lcp]) ++lcp;
        if (lcp >= 4 && lcp > best_len) {
          best_len = lcp;
          best_dist = pos - ppos;
        }
      }
    }
    orow[pos] = best_dist > 0 ? (best_len << pos_bits) | best_dist : 0;
  }
}

}  // namespace

// blocks: (n_blocks, p) uint8, contiguous; lengths: (n_blocks,) int32;
// out: (n_blocks, pa) int32 with pa = p / stride a power of two and
// (0x10000 + pa) << pos_bits < 2^31 (the wrapper checks both).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int match_candidates_launch(const void* blocks, const void* lengths,
                                       void* out, long long n_blocks, int p,
                                       int stride, int pa, int pos_bits,
                                       int lcp_bytes, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (lcp_bytes > kPad || pa <= 0 || (pa & (pa - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = static_cast<size_t>(bytes_offset(pa)) + p + kPad;
  cudaError_t err = cudaFuncSetAttribute(
      match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const bool vec_load =
      p % 16 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  match_kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(out), p,
      stride, pa, pos_bits, lcp_bytes, vec_load);
  return cudaGetLastError();
}

extern "C" const char* match_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
