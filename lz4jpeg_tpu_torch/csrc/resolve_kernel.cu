// Rooted-resolve kernel for Hopper (sm_90a): out[b, i] = lit[b, root[b, i]]
// over a fully rooted LZ4T copy program, one CTA per block row.
//
// Replaces lz4jpeg_tpu/ops/lz4t_decode.py::_mxu_resolve_kernel, the Pallas
// TPU kernel, which gathers by a one-hot bf16 matmul per 128-output tile
// (2·P² MACs per P-byte block) because data-dependent gathers serialize on
// the TPU.  On Hopper the gather is direct: the CTA stages its block's
// literal row in shared memory when it fits (P ≤ 64 KiB, the LZ4T default
// block) and reads it from device memory otherwise; each thread loads four
// roots with one 16-byte load and writes four bytes with one 4-byte store.
//
// No read leaves the row, whatever the root holds: a root outside [0, P)
// yields byte 0 (the native program builder rejects bad offsets, and the
// decoder verifies the frame checksum after the resolve).
//
// What bounds it.  6 bytes of device memory per output byte (4 B of root,
// 1 B of literal in, 1 B out) against one shared-memory byte load: memory
// bandwidth.  At 128 MiB that is 805 MB, about 0.24 ms at 3.35 TB/s.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxStaged = 1 << 16;  // bytes of literal row held in smem

__device__ __forceinline__ uint32_t fetch(const uint8_t* row, int32_t r,
                                          int p) {
  return static_cast<uint32_t>(r) < static_cast<uint32_t>(p) ? row[r] : 0u;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
    resolve_kernel(const uint8_t* __restrict__ lit,
                   const int32_t* __restrict__ root, uint8_t* __restrict__ out,
                   int p, bool vec_lit, bool vec_root) {
  extern __shared__ __align__(16) uint8_t staged[];
  const int64_t b = blockIdx.x;
  const uint8_t* lrow = lit + b * p;
  const int32_t* rrow = root + b * p;
  uint8_t* orow = out + b * p;

  const uint8_t* src = lrow;
  if constexpr (kStage) {
    if (vec_lit) {
      const uint4* s4 = reinterpret_cast<const uint4*>(lrow);
      uint4* d4 = reinterpret_cast<uint4*>(staged);
      for (int i = threadIdx.x; i < p / 16; i += blockDim.x) d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < p; i += blockDim.x) staged[i] = lrow[i];
    }
    __syncthreads();
    src = staged;
  }

  if (vec_root) {
    const int4* r4 = reinterpret_cast<const int4*>(rrow);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(orow);
    for (int g = threadIdx.x; g < p / 4; g += blockDim.x) {
      const int4 r = r4[g];
      o4[g] = fetch(src, r.x, p) | (fetch(src, r.y, p) << 8) |
              (fetch(src, r.z, p) << 16) | (fetch(src, r.w, p) << 24);
    }
  } else {
    for (int i = threadIdx.x; i < p; i += blockDim.x) {
      orow[i] = static_cast<uint8_t>(fetch(src, rrow[i], p));
    }
  }
}

}  // namespace

// lit: (n_rows, p) uint8; root: (n_rows, p) int32; out: (n_rows, p) uint8;
// all contiguous.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int resolve_rooted_launch(const void* lit, const void* root,
                                     void* out, long long n_rows, int p,
                                     void* stream) {
  if (n_rows <= 0 || p <= 0) return cudaSuccess;
  const bool vec_lit =
      p % 16 == 0 && reinterpret_cast<uintptr_t>(lit) % 16 == 0;
  const bool vec_root = p % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(root) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(n_rows);
  if (p <= kMaxStaged) {
    cudaError_t err = cudaFuncSetAttribute(
        resolve_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, p);
    if (err != cudaSuccess) return err;
    resolve_kernel<true><<<grid, kThreads, p, s>>>(
        static_cast<const uint8_t*>(lit), static_cast<const int32_t*>(root),
        static_cast<uint8_t*>(out), p, vec_lit, vec_root);
  } else {
    resolve_kernel<false><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(lit), static_cast<const int32_t*>(root),
        static_cast<uint8_t*>(out), p, vec_lit, vec_root);
  }
  return cudaGetLastError();
}

extern "C" const char* resolve_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
