// Stream-copy kernel for Hopper (sm_90a): dst[i] = src[i] over n bytes of
// device memory, the card's kernel-side stream ceiling.
//
// Replaces profiles/probe_pallas_copy_ceiling.py::copy_kernel, the Pallas
// TPU probe (pallas_call at :56) that copies (rows, 2048) u8/i16/f32
// arrays block by block through VMEM to find what a bare kernel streams.
// On Hopper there is no staging buffer to fill: each thread moves 16-byte
// vectors straight from registers, four loads in flight before the four
// stores, in a grid-stride loop over a grid sized to the SM count, so
// enough requests are outstanding to cover the memory latency.  The loads
// and stores carry the streaming cache hint (evict first): every byte is
// touched once.
//
// Alignment.  The vector body runs where src and dst have the same offset
// modulo 16: a byte-wise head up to the first 16-byte boundary, the body,
// a byte-wise tail.  Where the offsets differ, every byte goes byte-wise
// (correct, and far slower: no caller of the ceiling probe takes it).
//
// What bounds it.  2 bytes of device memory per byte copied (read once,
// written once) and no arithmetic: memory bandwidth.  At 512 MiB that is
// 1,073,741,824 bytes, about 0.32 ms at the data sheet's 3.35 TB/s.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
    stream_copy_kernel(const uint8_t* __restrict__ src,
                       uint8_t* __restrict__ dst, int64_t n, int64_t head,
                       int64_t n_vec) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;

  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  int64_t i = tid;
  for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(s4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcs(d4 + i + u * stride, v[u]);
  }
  for (; i < n_vec; i += stride) __stcs(d4 + i, __ldcs(s4 + i));

  // Head [0, head) and tail [head + 16 n_vec, n), byte by byte.
  const int64_t tail0 = head + 16 * n_vec;
  const int64_t rest = head + (n - tail0);
  for (int64_t j = tid; j < rest; j += stride) {
    const int64_t k = j < head ? j : tail0 + (j - head);
    dst[k] = src[k];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0) {
      sms = 132;  // H100 SXM
    }
  }
  return sms;
}

}  // namespace

// Copy n bytes from src to dst (both device memory, not overlapping).
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// never synchronises.
extern "C" int stream_copy_launch(const void* src, void* dst, long long n,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  int64_t head = n, n_vec = 0;
  if (s % 16 == d % 16) {
    head = static_cast<int64_t>((16 - s % 16) % 16);
    if (head > n) head = n;
    n_vec = (n - head) / 16;
  }
  const int64_t work = n_vec > 0 ? n_vec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  stream_copy_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n, head,
      n_vec);
  return cudaGetLastError();
}

extern "C" const char* stream_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
