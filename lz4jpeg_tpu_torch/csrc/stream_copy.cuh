// The streaming identity copy for Hopper (sm_90a): dst[i] = src[i] over n
// bytes of device memory.  csrc/stream_copy_kernel.cu (the stream-copy
// probe, P-copy, and the lane split, P-split) and
// csrc/rle_expand_copy_kernel.cu (the row-major copy of K7's stream, P-rm
// and P-wide) both launch it.
//
// What bounds it: 2 bytes of device memory a byte copied (read once,
// written once) and no arithmetic, so memory bandwidth alone.
//
// Design: the bytes in flight stay in one window of memory that moves
// through the array.  Each CTA copies one 16 KiB chunk of the 16-byte
// body, one vector a thread, a warp's lanes on adjacent vectors (512
// contiguous bytes a warp), and the grid has one CTA a chunk, with no cap
// at the resident count and no grid-stride walk: the hardware starts CTAs
// in index order, so the CTAs in flight hold neighbouring chunks.  Loads
// and stores keep the default cache hints: with the evict-first hint
// (__ldcs) the copy ran 1.5% slower whenever the L2 held other lines, as
// it does after any other kernel.  A sweep on the H100 (PERF.md, PR 18)
// put this shape ahead of 128-512 threads a CTA, of 2-16 vectors a thread
// (all loads before the first store), of ld.global.L2::256B and of the
// 1-D TMA bulk copy through shared memory.  Offsets are 64-bit: a copy
// above 2^31 bytes works.
//
// Alignment.  The vector body runs where src and dst share their offset
// modulo 16: a byte-wise head up to src's first 16-byte boundary, the
// body, a byte-wise tail.  Where the offsets differ every byte goes
// byte-wise, a chunk of bytes a CTA (correct, and far slower).  The head
// and tail bytes are the first bytes of the byte-wise list, so CTA 0
// copies them.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace stream_copy {

constexpr int kThreads = 1024;
constexpr int64_t kChunkVecs = kThreads;  // one 16-byte vector a thread
constexpr int64_t kChunkBytes = 16 * kChunkVecs;

// The launch: head and tail bytes around n_vec 16-byte vectors (head = n,
// n_vec = tail = 0 where the offsets differ), and one CTA a chunk of the
// body or of the byte-wise list, whichever needs more.
struct Plan {
  int64_t head, n_vec, tail, ctas;
};

inline Plan plan(const void* src, const void* dst, int64_t n) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src) % 16;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst) % 16;
  Plan p{n, 0, 0, 0};
  if (s == d) {
    p.head = static_cast<int64_t>((16 - s) % 16);
    if (p.head > n) p.head = n;
    p.n_vec = (n - p.head) / 16;
    p.tail = n - p.head - 16 * p.n_vec;
  }
  const int64_t body = (p.n_vec + kChunkVecs - 1) / kChunkVecs;
  const int64_t bytes = (p.head + p.tail + kChunkBytes - 1) / kChunkBytes;
  p.ctas = body > bytes ? body : bytes;
  return p;
}

__global__ void __launch_bounds__(kThreads)
    copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                int64_t head, int64_t n_vec, int64_t tail) {
  const int64_t c = blockIdx.x;
  const int64_t i = c * kChunkVecs + threadIdx.x;
  if (i < n_vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
    uint4* d4 = reinterpret_cast<uint4*>(dst + head);
    d4[i] = s4[i];
  }

  // Byte-wise list: the head [0, head), then the tail [tail0, tail0 +
  // tail); chunk c of it here.
  const int64_t rest = head + tail;
  const int64_t tail0 = head + 16 * n_vec;
  const int64_t end = (c + 1) * kChunkBytes < rest ? (c + 1) * kChunkBytes
                                                   : rest;
  for (int64_t j = c * kChunkBytes + threadIdx.x; j < end; j += kThreads) {
    const int64_t k = j < head ? j : tail0 + (j - head);
    dst[k] = src[k];
  }
}

// Copy n bytes from src to dst (device memory, not overlapping) on
// `stream`; returns cudaGetLastError() (0 on success), never synchronises.
inline cudaError_t launch(const void* src, void* dst, int64_t n,
                          cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const Plan p = plan(src, dst, n);
  copy_kernel<<<static_cast<unsigned>(p.ctas), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), p.head,
      p.n_vec, p.tail);
  return cudaGetLastError();
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of copy_kernel; returns the first CUDA error.
inline cudaError_t attributes(int* regs, int* smem, int* ctas) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, copy_kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, copy_kernel,
                                                       kThreads, 0);
}

}  // namespace stream_copy
