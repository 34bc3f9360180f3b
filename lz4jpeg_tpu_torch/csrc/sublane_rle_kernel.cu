// Packed16 run-length compaction along the leading (sublane) axis for Hopper
// (sm_90a): (SEG, B) values, block b in column b → (SEG, B) words and (1, B)
// run counts.  Column b's runs are front-compacted down the column as
// (count - 1) << 10 | (value + 512), the slots past them are 0, and
// runs[0, b] is the number of runs (K4's lengths halved).  SEG is 32 or 64;
// values are int16 or int32 with |value| ≤ 511 (the packed16 format's
// precondition, as lz4jpeg_tpu/ops/rle.py::rle_encode_packed16 states).
//
// Replaces profiles/profile_sublane_butterfly.py::kernel (:24, pallas_call
// :64) and profiles/profile_plane_exact.py's make_kernel(SEG) kernel (:63,
// pallas_call :107, SEG 32 and 64).  On the TPU a block's positions lie
// along the sublanes of a (SEG, 128) tile, and Mosaic has no sublane scan:
// the kernel ranked the run starts with a bf16 lower-triangular MXU dot and
// moved each start's word to its rank through six pltpu.roll stages.  A
// CUDA thread scans serially in registers, so none of that carries over.
//
// Design: one thread a block column, 128 columns a CTA (K5's
// pack16_kt_kernel does the same on the (R, K, C) layout).  Across a warp,
// the load of row m is one contiguous 64- or 128-byte transaction; a thread
// issues all SEG loads (the loop is unrolled at compile time, the values
// sit in registers) before it compares any.  Each run's word goes to slot
// `rank` of the thread's own column of a shared [SEG][128] int16 tile
// (16 KiB at SEG 64); the column then leaves row by row, word m if m <
// runs and 0 past them, so each warp store is 32 consecutive words.  A
// thread reads back only what it wrote, so the kernel needs no barrier, and
// a ragged last tile (B % 128 ≠ 0) simply has idle threads.  Loads and
// stores are per element, so any 2- or 4-byte aligned base works.
//
// What bounds it: one read of the values and one write of the words and
// the counts, SEG · (4 + 2) + 4 bytes a column in int32.  At the probe's
// (64, 2,097,152) int32 that is 813,694,976 bytes, 0.2429 ms at the 3.35
// TB/s of an H100 SXM's data sheet; at SEG 32, 411,041,792 bytes, 0.1227
// ms.  The integer work is a compare and a predicated shared store a value.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // block columns (threads) a CTA

__device__ __forceinline__ uint16_t pack_word(int count, int32_t value) {
  return static_cast<uint16_t>(((count - 1) << 10) | (value + 512));
}

template <typename T, int kSeg>
__global__ void __launch_bounds__(kCols)
    sublane_rle_kernel(const T* __restrict__ x, uint16_t* __restrict__ packed,
                       int32_t* __restrict__ runs, long long cols) {
  __shared__ uint16_t tile[kSeg][kCols];
  const int t = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * kCols + t;
  if (b >= cols) return;  // no barrier below: each thread keeps to its column
  int32_t v[kSeg];
#pragma unroll
  for (int m = 0; m < kSeg; ++m)
    v[m] = static_cast<int32_t>(__ldg(x + m * cols + b));
  int n = 0;
  int begin = 0;
#pragma unroll
  for (int m = 1; m < kSeg; ++m) {
    if (v[m] != v[m - 1]) {
      tile[n++][t] = pack_word(m - begin, v[m - 1]);
      begin = m;
    }
  }
  tile[n++][t] = pack_word(kSeg - begin, v[kSeg - 1]);
#pragma unroll
  for (int m = 0; m < kSeg; ++m)
    packed[m * cols + b] = m < n ? tile[m][t] : static_cast<uint16_t>(0);
  runs[b] = n;
}

template <typename T>
const void* kernel_for(int seg) {
  if (seg == 32) return reinterpret_cast<const void*>(sublane_rle_kernel<T, 32>);
  if (seg == 64) return reinterpret_cast<const void*>(sublane_rle_kernel<T, 64>);
  return nullptr;
}

const void* kernel_for(int seg, int elem_bytes) {
  if (elem_bytes == 2) return kernel_for<int16_t>(seg);
  if (elem_bytes == 4) return kernel_for<int32_t>(seg);
  return nullptr;
}

template <typename T>
cudaError_t launch(const void* x, void* packed, void* runs, int seg,
                   long long cols, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((cols + kCols - 1) / kCols);
  const T* in = static_cast<const T*>(x);
  uint16_t* out = static_cast<uint16_t*>(packed);
  int32_t* counts = static_cast<int32_t*>(runs);
  if (seg == 32)
    sublane_rle_kernel<T, 32><<<grid, kCols, 0, s>>>(in, out, counts, cols);
  else
    sublane_rle_kernel<T, 64><<<grid, kCols, 0, s>>>(in, out, counts, cols);
  return cudaGetLastError();
}

}  // namespace

// x: (seg, cols) int16 (elem_bytes 2) or int32 (4); packed: (seg, cols)
// uint16; runs: (cols,) int32; all contiguous and aligned to their element.
// seg is 32 or 64.  Launches on `stream` and returns the launch's CUDA error
// (0 on success), cudaErrorInvalidValue for a shape or type it does not
// take, cudaErrorMisalignedAddress for a pointer off its element; never
// synchronises.
extern "C" int sublane_rle_launch(const void* x, int elem_bytes, void* packed,
                                  void* runs, int seg, long long cols,
                                  void* stream) {
  if (kernel_for(seg, elem_bytes) == nullptr || cols < 0 ||
      (cols + kCols - 1) / kCols > INT_MAX)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % elem_bytes ||
      reinterpret_cast<uintptr_t>(packed) % 2 ||
      reinterpret_cast<uintptr_t>(runs) % 4)
    return cudaErrorMisalignedAddress;
  if (cols == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch<int16_t>(x, packed, runs, seg, cols, s);
  return launch<int32_t>(x, packed, runs, seg, cols, s);
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the instantiation at (seg, elem_bytes); returns the first CUDA error.
extern "C" int sublane_rle_attributes(int seg, int elem_bytes, int* regs,
                                      int* smem, int* ctas) {
  const void* fn = kernel_for(seg, elem_bytes);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kCols, 0);
}

extern "C" const char* sublane_rle_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
