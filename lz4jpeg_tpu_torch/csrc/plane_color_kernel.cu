// Plane YCbCr -> RGB merge for Hopper (sm_90a): (n, w) uint8 luma and
// (n, w / 2) uint8 Cr and Cb planes (4:2:2, w even) -> three (n, w) uint8
// planes R, G, B.
//
// Replaces profiles/profile_plane_color_kernel.py::_kernel (:27, pallas_call
// :55), the TPU candidate that upsampled the chroma columns with
// pltpu.repeat in VMEM and wrote three planar channels.  The arithmetic is
// the reference's assemble_image (JPEG.c:598-604) as ops/color.py runs it in
// float32, from csrc/color_merge.cuh (shared with the inverse megakernel):
// each chroma term is one IEEE fp32 product of (float)c - 128.0f by the fp32
// constant, truncated toward zero; R = y + cr_term, G = y - g_cb - g_cr, B =
// y + cb_term, each clamped to [0, 255].  The products are __fmul_rn, never
// contracted, so the kernel is bit-identical to its plain torch version.
//
// Design.  With w even, pixel i of the flattened (n, w) luma takes chroma
// sample i / 2 of the flattened (n, w / 2) planes, across rows too, so the
// kernel walks the planes as flat arrays: a thread step reads 16 luma bytes
// and 8 + 8 chroma bytes (one 16-byte and two 8-byte loads), computes the
// three terms once per chroma sample, and writes 16 bytes to each of R, G
// and B.  The flat tail past the last whole 16-pixel step (w not a multiple
// of 16 only moves where the tail starts) goes a pixel at a time, and so
// does everything when a pointer is not 16-byte aligned.  A grid-stride loop
// over a grid of resident CTAs.
//
// What bounds it.  2 bytes in (one luma, two half-width chroma) and 3 out
// per pixel, nothing reused: memory bandwidth.  At 2048 x 2048 x 64 (the
// A/B's shape, 268.4 MPix) that is 536.9 MB in and 805.3 MB out, 0.4007 ms
// at the 3.35 TB/s of an H100 SXM's data sheet (700 W).

#include <cstdint>

#include <cuda_runtime.h>

#include "color_merge.cuh"

namespace {

using color_merge::clamp255;
using color_merge::Terms;
using color_merge::terms;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    plane_color_kernel(const uint8_t* __restrict__ y,
                       const uint8_t* __restrict__ cr,
                       const uint8_t* __restrict__ cb,
                       uint8_t* __restrict__ r, uint8_t* __restrict__ g,
                       uint8_t* __restrict__ b, long long n_pix,
                       long long n_vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = tid; c < n_vec; c += stride) {
    const uint4 yv = __ldcs(reinterpret_cast<const uint4*>(y) + c);
    const uint2 rv = __ldcs(reinterpret_cast<const uint2*>(cr) + c);
    const uint2 bv = __ldcs(reinterpret_cast<const uint2*>(cb) + c);
    const uint32_t yw[4] = {yv.x, yv.y, yv.z, yv.w};
    const uint32_t rw[2] = {rv.x, rv.y};
    const uint32_t bw[2] = {bv.x, bv.y};
    uint32_t ro[4], go[4], bo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // luma word q: chroma samples 2q, 2q + 1
      uint32_t rr = 0, gg = 0, bb = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 2 * q + h;
        const Terms t = terms((rw[s / 4] >> (8 * (s % 4))) & 0xffu,
                              (bw[s / 4] >> (8 * (s % 4))) & 0xffu);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int shift = 8 * (2 * h + e);
          const int yy = static_cast<int>((yw[q] >> shift) & 0xffu);
          rr |= clamp255(yy + t.cr) << shift;
          gg |= clamp255(yy - t.g) << shift;
          bb |= clamp255(yy + t.cb) << shift;
        }
      }
      ro[q] = rr;
      go[q] = gg;
      bo[q] = bb;
    }
    __stcs(reinterpret_cast<uint4*>(r) + c,
           make_uint4(ro[0], ro[1], ro[2], ro[3]));
    __stcs(reinterpret_cast<uint4*>(g) + c,
           make_uint4(go[0], go[1], go[2], go[3]));
    __stcs(reinterpret_cast<uint4*>(b) + c,
           make_uint4(bo[0], bo[1], bo[2], bo[3]));
  }
  for (long long i = 16 * n_vec + tid; i < n_pix; i += stride) {
    const Terms t = terms(cr[i / 2], cb[i / 2]);
    const int yy = y[i];
    r[i] = static_cast<uint8_t>(clamp255(yy + t.cr));
    g[i] = static_cast<uint8_t>(clamp255(yy - t.g));
    b[i] = static_cast<uint8_t>(clamp255(yy + t.cb));
  }
}

}  // namespace

// y, r, g, b: n_pix uint8; cr, cb: n_pix / 2 uint8 (n_pix even: the planes
// are (n, w) and (n, w / 2) with w even, flattened); all contiguous device
// memory.  Launches on `stream` and returns the first CUDA error of the
// occupancy query or the launch (0 on success); never synchronises.
extern "C" int plane_color_launch(const void* y, const void* cr,
                                  const void* cb, void* r, void* g, void* b,
                                  long long n_pix, void* stream) {
  if (n_pix % 2) return cudaErrorInvalidValue;
  if (n_pix <= 0) return cudaSuccess;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(cr) |
      reinterpret_cast<uintptr_t>(cb) | reinterpret_cast<uintptr_t>(r) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(b);
  const bool vec = bits % 16 == 0;
  const long long n_vec = vec ? n_pix / 16 : 0;
  const long long work = n_vec > 0 ? n_vec : n_pix;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, plane_color_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  plane_color_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(cr),
      static_cast<const uint8_t*>(cb), static_cast<uint8_t*>(r),
      static_cast<uint8_t*>(g), static_cast<uint8_t*>(b), n_pix, n_vec);
  return cudaGetLastError();
}

extern "C" const char* plane_color_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
