// The MCU relayout for Hopper (sm_90a): a uint8 channel plane (bands of 8
// rows, Wp bytes a row) → its 8 × tw tiles, frames outermost, then
// block-row-major, each tile's 8 rows of tw bytes contiguous.  tw is 8
// (luma) or 4 (4:2:2 chroma).
//
// Replaces profiles/profile_colorsplit3.py::kernel (made by
// _relayout_kernel(tw) :115, pallas_tile :129, pallas_call :134), which
// moved (64, 128) input blocks to (8, 1024) output blocks in VMEM; the
// tiling is ops/color.py::split_mcus's for H % 8 == 0 and Wp % tw == 0.
//
// Design.  A band of 8 plane rows is a contiguous 8·Wp bytes of the input,
// and its tiles are a contiguous 8·Wp bytes of the output: the relayout is
// a permutation inside each band.  A CTA takes a band (or a span of 2,048
// columns of a wider one): it loads the span's 8 rows with coalesced
// 16-byte loads into shared memory, one row every 2,064 bytes (16 bytes of
// padding, so that the 8- and 4-byte reads below fall in distinct banks),
// then writes the span's tiles with coalesced 16-byte stores, a store
// being two 8-byte tile rows (luma) or four 4-byte ones (chroma) read from
// shared memory.  The grid is as many CTAs as fit on the SMs, each walking
// over spans.  Where Wp % 16 ≠ 0 the rows start off a 16-byte boundary, so
// the span is loaded in 4-byte words (Wp % tw == 0 keeps them aligned);
// the stores stay 16 bytes wide, since a band's tiles are 8·Wp bytes, a
// multiple of 32.  Both pointers must be 16-byte aligned: the wrapper
// copies an unaligned plane first.
//
// What bounds it: every byte read once and written once, no arithmetic:
// memory bandwidth.  At 32 frames of 2048² (luma, 134,217,728 bytes) 0.0801
// ms at 3.35 TB/s, a chroma plane of 2048 × 1024 a frame 0.0401 ms.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSpan = 2048;        // plane columns a CTA stages at a time
constexpr int kPitch = kSpan + 16;  // bytes a staged row takes

template <int TW>
__global__ void __launch_bounds__(kThreads)
    relayout(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    long long n_bands, long long wp) {
  __shared__ __align__(16) uint8_t tile[8 * kPitch];
  const long long spans = (wp + kSpan - 1) / kSpan;
  for (long long job = blockIdx.x; job < n_bands * spans; job += gridDim.x) {
    const long long band = job / spans;
    const long long col0 = (job % spans) * kSpan;
    const int span = static_cast<int>(wp - col0 < kSpan ? wp - col0 : kSpan);
    const uint8_t* src = in + band * 8 * wp + col0;
    if (wp % 16 == 0) {
      const int row_vecs = span / 16;
      for (int v = threadIdx.x; v < 8 * row_vecs; v += kThreads) {
        const int r = v / row_vecs, c = (v % row_vecs) * 16;
        *reinterpret_cast<uint4*>(tile + r * kPitch + c) =
            __ldcs(reinterpret_cast<const uint4*>(src + r * wp + c));
      }
    } else {
      const int row_words = span / 4;
      for (int v = threadIdx.x; v < 8 * row_words; v += kThreads) {
        const int r = v / row_words, c = (v % row_words) * 4;
        *reinterpret_cast<unsigned*>(tile + r * kPitch + c) =
            __ldcs(reinterpret_cast<const unsigned*>(src + r * wp + c));
      }
    }
    __syncthreads();
    // The span's tiles start at tile col0 / TW of the band: byte 8 · col0.
    uint4* dst = reinterpret_cast<uint4*>(out + band * 8 * wp + col0 * 8);
    for (int v = threadIdx.x; v < span / 2; v += kThreads) {
      union {
        uint4 u;
        uint2 h[2];
        uint32_t w[4];
      } o;
      if constexpr (TW == 8) {  // tile v / 4, rows 2 (v % 4) and the next
        const uint8_t* t = tile + (v & 3) * 2 * kPitch + (v >> 2) * 8;
        o.h[0] = *reinterpret_cast<const uint2*>(t);
        o.h[1] = *reinterpret_cast<const uint2*>(t + kPitch);
      } else {  // tile v / 2, rows 4 (v % 2) to 4 (v % 2) + 3
        const uint8_t* t = tile + (v & 1) * 4 * kPitch + (v >> 1) * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o.w[k] = *reinterpret_cast<const uint32_t*>(t + k * kPitch);
      }
      __stcs(dst + v, o.u);
    }
    __syncthreads();
  }
}

const void* kernel_of(int tw) {
  if (tw == 8) return reinterpret_cast<const void*>(relayout<8>);
  if (tw == 4) return reinterpret_cast<const void*>(relayout<4>);
  return nullptr;
}

// As many CTAs as fit on the SMs, no more than `units` of kThreads.
cudaError_t grid_for(const void* kernel, long long units, unsigned* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *ctas = static_cast<unsigned>(units < resident ? units : resident);
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// in: n_bands × 8 rows × wp bytes (a stack of planes, H % 8 == 0); out:
// n_bands · wp / tw tiles of 8 · tw bytes; both contiguous and 16-byte
// aligned.  Launches the kernel on `stream` and returns the first CUDA
// error of the device and occupancy queries or the launch (0 on success);
// cudaErrorInvalidValue for tw other than 4 or 8, n_bands < 0, wp < 1,
// wp % tw ≠ 0 or a pointer off a 16-byte boundary.  Never synchronises.
extern "C" int mcu_relayout_launch(const void* in, void* out,
                                   long long n_bands, long long wp, int tw,
                                   void* stream) {
  const void* fn = kernel_of(tw);
  if (fn == nullptr || n_bands < 0 || wp < 1 || wp % tw ||
      reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorInvalidValue;
  if (n_bands == 0) return cudaSuccess;
  unsigned ctas = 0;
  const cudaError_t err =
      grid_for(fn, n_bands * ((wp + kSpan - 1) / kSpan), &ctas);
  if (err != cudaSuccess) return err;
  const auto* src = static_cast<const uint8_t*>(in);
  auto* dst = static_cast<uint8_t*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tw == 8)
    relayout<8><<<ctas, kThreads, 0, s>>>(src, dst, n_bands, wp);
  else
    relayout<4><<<ctas, kThreads, 0, s>>>(src, dst, n_bands, wp);
  return cudaGetLastError();
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the tw kernel; returns the first CUDA error, cudaErrorInvalidValue
// for another tw.
extern "C" int mcu_relayout_attributes(int tw, int* regs, int* smem,
                                       int* ctas) {
  const void* fn = kernel_of(tw);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, 0);
}

extern "C" const char* mcu_relayout_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
