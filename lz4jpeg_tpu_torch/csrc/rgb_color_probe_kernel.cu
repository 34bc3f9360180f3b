// The TPU colour probe's kernel for Hopper (sm_90a): interleaved RGB
// (rows, width, 3) uint8 → Y (rows, width) int16 and the odd columns of Cr
// and Cb (rows, width / 2) int16.
//
// Replaces profiles/profile_pallas_color.py::color_kernel (:21, pallas_call
// :43), and computes what its body computes in interpret mode (XLA on the
// CPU contracts the f32 sums into FMAs), with no tie snap:
//   Y  = fma(0.114f, b, fma(0.299f, r, 0.587f·g))
//   Cr = fma(-0.071f, b, fma(0.439f, r, -(0.368f·g))) + 128
//   Cb = fma(0.439f, b, fma(-0.148f, r, -(0.291f·g))) + 128
// each step rounded once to float32 (__fmul_rn / __fmaf_rn / __fadd_rn, so
// that nvcc's --fmad cannot contract them again), the chroma clipped to
// [0, 255] (fminf / fmaxf), then truncated toward zero to int16.  The
// probe computes chroma at every column and keeps the odd ones; here only
// the odd ones are computed (the same result).
//
// Design: a thread takes a run of 16 pixels: three 16-byte loads (48
// bytes, through the read-only path so that the warp's three strided
// loads meet in L1), the de-interleave in registers, 32 bytes of Y and 16
// bytes each of Cr and Cb stored as 16-byte vectors.  A width is even, so
// a pixel's column parity is its flat index's and the kernel walks the
// flat pixels; the pixels past the last whole run go one by one.  The
// input and the outputs must be 16-byte aligned (the wrapper copies an
// input that is not).  The grid is as many CTAs as fit on the SMs.
//
// What bounds it: 7 bytes of device memory a pixel (3 read, 2 of Y and 2
// of chroma written) and a few flops: memory bandwidth.  At 32 frames of
// 2048² (134,217,728 pixels) 939.5 MB, 0.2805 ms at 3.35 TB/s.

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;  // pixels a thread converts at a time

__device__ __forceinline__ float luma(float r, float g, float b) {
  return __fmaf_rn(0.114f, b, __fmaf_rn(0.299f, r, __fmul_rn(0.587f, g)));
}

__device__ __forceinline__ float chroma_r(float r, float g, float b) {
  return __fadd_rn(
      __fmaf_rn(-0.071f, b, __fmaf_rn(0.439f, r, -__fmul_rn(0.368f, g))),
      128.0f);
}

__device__ __forceinline__ float chroma_b(float r, float g, float b) {
  return __fadd_rn(
      __fmaf_rn(0.439f, b, __fmaf_rn(-0.148f, r, -__fmul_rn(0.291f, g))),
      128.0f);
}

__device__ __forceinline__ int16_t trunc16(float v) {
  return static_cast<int16_t>(__float2int_rz(v));
}

__device__ __forceinline__ int16_t clip_trunc16(float v) {
  return trunc16(fminf(fmaxf(v, 0.0f), 255.0f));
}

__global__ void __launch_bounds__(kThreads)
    rgb_color_kernel(const uint8_t* __restrict__ rgb, int16_t* __restrict__ y,
                     int16_t* __restrict__ cr, int16_t* __restrict__ cb,
                     long long n_pix) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n_runs = n_pix / kRun;
  const uint4* in = reinterpret_cast<const uint4*>(rgb);
  uint4* y4 = reinterpret_cast<uint4*>(y);
  uint4* cr4 = reinterpret_cast<uint4*>(cr);
  uint4* cb4 = reinterpret_cast<uint4*>(cb);
  for (long long run = tid; run < n_runs; run += stride) {
    union {
      uint4 v[3];
      uint8_t b[48];
    } px;
#pragma unroll
    for (int k = 0; k < 3; ++k) px.v[k] = __ldg(in + 3 * run + k);
    union {
      uint4 v[2];
      int16_t e[16];
    } yo;
    union {
      uint4 v;
      int16_t e[8];
    } ro, bo;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const float r = px.b[3 * i], g = px.b[3 * i + 1], b = px.b[3 * i + 2];
      yo.e[i] = trunc16(luma(r, g, b));
      if (i & 1) {
        ro.e[i / 2] = clip_trunc16(chroma_r(r, g, b));
        bo.e[i / 2] = clip_trunc16(chroma_b(r, g, b));
      }
    }
    __stcs(y4 + 2 * run, yo.v[0]);
    __stcs(y4 + 2 * run + 1, yo.v[1]);
    __stcs(cr4 + run, ro.v);
    __stcs(cb4 + run, bo.v);
  }
  for (long long i = n_runs * kRun + tid; i < n_pix; i += stride) {
    const float r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    y[i] = trunc16(luma(r, g, b));
    if (i & 1) {
      cr[i / 2] = clip_trunc16(chroma_r(r, g, b));
      cb[i / 2] = clip_trunc16(chroma_b(r, g, b));
    }
  }
}

// As many CTAs as fit on the SMs, no more than the work needs.
cudaError_t grid_for(long long units, unsigned* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(rgb_color_kernel), kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = (units + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *ctas = static_cast<unsigned>(need < resident ? need : resident);
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// rgb: rows × width × 3 bytes; y: rows × width int16; cr, cb: rows × width
// / 2 int16; all contiguous and 16-byte aligned.  Launches on `stream` and
// returns the first CUDA error of the device and occupancy queries or the
// launch (0 on success), cudaErrorInvalidValue for rows < 0 or a width that
// is negative or odd, cudaErrorMisalignedAddress for a pointer off a
// 16-byte boundary; never synchronises.
extern "C" int rgb_color_launch(const void* rgb, void* y, void* cr, void* cb,
                                long long rows, long long width,
                                void* stream) {
  if (rows < 0 || width < 0 || width % 2) return cudaErrorInvalidValue;
  for (const void* p : {rgb, static_cast<const void*>(y),
                        static_cast<const void*>(cr),
                        static_cast<const void*>(cb)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const long long n_pix = rows * width;
  if (n_pix == 0) return cudaSuccess;
  unsigned ctas = 0;
  const long long units = n_pix / kRun + kThreads;
  const cudaError_t err = grid_for(units, &ctas);
  if (err != cudaSuccess) return err;
  rgb_color_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int16_t*>(y),
      static_cast<int16_t*>(cr), static_cast<int16_t*>(cb), n_pix);
  return cudaGetLastError();
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the kernel; returns the first CUDA error.
extern "C" int rgb_color_attributes(int* regs, int* smem, int* ctas) {
  const void* fn = reinterpret_cast<const void*>(rgb_color_kernel);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, 0);
}

extern "C" const char* rgb_color_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
