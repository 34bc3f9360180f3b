// Fused MCU transforms for Hopper (sm_90a): the JPEG per-block chain as one
// product against a fused (HW, HW) basis, HW = 64 (8x8 luma) or 32 (8 rows
// of 4: a 4:2:2 chroma block).
//
// mcu_forward: replaces profiles/pallas_mcu.py::_forward_kernel (:36,
// pallas_call :68).  (N, HW) uint8 tiles -> (N, HW) float32 quantized zigzag
// coefficients: ratio = x . M[k] - off[k] with M = forward_basis(...)[0]
// (fused DCT, quantize and zigzag; ops/fused.py), snapped to the nearest
// integer (round half to even, rintf: jnp.round and torch.round) when
// |ratio - nearest| <= snap_eps, then truncated toward zero (truncf).
//
// mcu_inverse: replaces profiles/pallas_mcu.py::_inverse_kernel (:48,
// pallas_call :91).  (N, HW) float32 zigzag coefficients -> (N, HW) uint8
// pixels: p = z . Minv[p] + 128 with Minv = inverse_basis(...), C round
// (half away from zero, computed as copysignf(floorf(fabsf(p) + 0.5f), p);
// roundf differs at 0.49999997f), clamped to [0, 255].
//
// Design.  The TPU kernel fed a (512, HW) block of tiles to the MXU against
// the basis held in VMEM.  Here one thread owns one tile: it loads its HW
// bytes (forward) or HW floats (inverse) as 16-byte vectors into registers,
// and computes its HW outputs in turn, each a sequential IEEE fp32 FMA chain
// over j = 0 .. HW-1 against a basis row that the CTA staged once in shared
// memory (16 KiB at HW = 64).  Every lane of a warp reads the same basis
// element at once, so the shared-memory reads are broadcasts, four floats a
// load.  Outputs leave four floats (forward) or sixteen bytes (inverse) per
// 16-byte store.  Persistent CTAs, sized by the occupancy calculator, walk
// the tiles in a grid-stride loop.  No tensor cores yet (a later PR's work):
// the same product runs exactly on them as bf16 parts, K1's three basis parts
// against pixel values that bf16 holds exactly, and for the inverse's integer
// coefficients (|z| <= 1024) two exact bf16 parts of z against those three.
//
// What bounds it.  Per tile HW + 4 HW bytes of device memory; counted as
// those bf16 tensor-core products, 3 (forward) or 6 (inverse) times
// 2 * HW * HW operations.  At 2,097,152 luma tiles (the A/B's shape):
// 671.1 MB, 0.2003 ms at the 3.35 TB/s of an H100 SXM's data sheet, against
// 51.5 or 103.1 GFLOP, 0.0521 or 0.1042 ms at its 989 TFLOP/s: the bytes
// bound both directions.  In fp32 FMAs on the CUDA cores, as here, the same
// work takes at least 0.2564 ms at 67 TFLOP/s, and one LDS.128 feeds four
// FMAs, so the FMA and shared-memory pipes are this kernel's limits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int HW>
__global__ void __launch_bounds__(kThreads)
    mcu_forward_kernel(const uint8_t* __restrict__ tiles,
                       const float* __restrict__ basis,
                       const float* __restrict__ offset,
                       float* __restrict__ out, long long n, float snap_eps) {
  __shared__ alignas(16) float m[HW * HW];
  __shared__ float off[HW];
  for (int i = threadIdx.x; i < HW * HW; i += blockDim.x) m[i] = basis[i];
  for (int i = threadIdx.x; i < HW; i += blockDim.x) off[i] = offset[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n; t += stride) {
    float x[HW];
    const uint4* src = reinterpret_cast<const uint4*>(tiles + t * HW);
#pragma unroll
    for (int v = 0; v < HW / 16; ++v) {
      const uint4 w = __ldcs(src + v);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          x[16 * v + 4 * q + b] =
              static_cast<float>((words[q] >> (8 * b)) & 0xffu);
    }
    float4* dst = reinterpret_cast<float4*>(out + t * HW);
#pragma unroll 1
    for (int k0 = 0; k0 < HW; k0 += 4) {
      float r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4* row = reinterpret_cast<const float4*>(m + (k0 + u) * HW);
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < HW / 4; ++j) {
          const float4 b = row[j];
          acc = fmaf(x[4 * j + 0], b.x, acc);
          acc = fmaf(x[4 * j + 1], b.y, acc);
          acc = fmaf(x[4 * j + 2], b.z, acc);
          acc = fmaf(x[4 * j + 3], b.w, acc);
        }
        float ratio = __fsub_rn(acc, off[k0 + u]);
        const float nearest = rintf(ratio);
        if (fabsf(__fsub_rn(ratio, nearest)) <= snap_eps) ratio = nearest;
        r[u] = truncf(ratio);
      }
      __stcs(dst + k0 / 4, make_float4(r[0], r[1], r[2], r[3]));
    }
  }
}

template <int HW>
__global__ void __launch_bounds__(kThreads)
    mcu_inverse_kernel(const float* __restrict__ zz,
                       const float* __restrict__ basis,
                       uint8_t* __restrict__ out, long long n) {
  __shared__ alignas(16) float m[HW * HW];
  for (int i = threadIdx.x; i < HW * HW; i += blockDim.x) m[i] = basis[i];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n; t += stride) {
    float z[HW];
    const float4* src = reinterpret_cast<const float4*>(zz + t * HW);
#pragma unroll
    for (int v = 0; v < HW / 4; ++v) {
      const float4 w = __ldcs(src + v);
      z[4 * v + 0] = w.x;
      z[4 * v + 1] = w.y;
      z[4 * v + 2] = w.z;
      z[4 * v + 3] = w.w;
    }
    uint4* dst = reinterpret_cast<uint4*>(out + t * HW);
#pragma unroll 1
    for (int p0 = 0; p0 < HW; p0 += 16) {
      uint32_t words[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float4* row =
              reinterpret_cast<const float4*>(m + (p0 + 4 * q + b) * HW);
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < HW / 4; ++j) {
            const float4 c = row[j];
            acc = fmaf(z[4 * j + 0], c.x, acc);
            acc = fmaf(z[4 * j + 1], c.y, acc);
            acc = fmaf(z[4 * j + 2], c.z, acc);
            acc = fmaf(z[4 * j + 3], c.w, acc);
          }
          const float pix = __fadd_rn(acc, 128.0f);
          float rounded = copysignf(floorf(__fadd_rn(fabsf(pix), 0.5f)), pix);
          rounded = fminf(fmaxf(rounded, 0.0f), 255.0f);
          word |= static_cast<uint32_t>(rounded) << (8 * b);
        }
        words[q] = word;
      }
      __stcs(dst + p0 / 16, make_uint4(words[0], words[1], words[2], words[3]));
    }
  }
}

// Persistent grid: as many CTAs as can be resident at once, no more than the
// tiles need.  A failed device or occupancy query is returned, not guessed
// around.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long n, unsigned* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(need < cap ? need : cap);
  return cudaSuccess;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// tiles: (n, hw) uint8; basis: (hw, hw) float32, row k the basis of output
// k; offset: (hw,) float32; out: (n, hw) float32; all contiguous, tiles and
// out 16-byte aligned.  Launches on `stream` and returns the first CUDA
// error of the occupancy query or the launch (0 on success); never
// synchronises.
extern "C" int mcu_forward_launch(const void* tiles, const void* basis,
                                  const void* offset, void* out, long long n,
                                  int hw, float snap_eps, void* stream) {
  if (hw != 64 && hw != 32) return cudaErrorInvalidValue;
  if (!aligned16(tiles) || !aligned16(out)) return cudaErrorMisalignedAddress;
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* x = static_cast<const uint8_t*>(tiles);
  const float* m = static_cast<const float*>(basis);
  const float* o = static_cast<const float*>(offset);
  float* y = static_cast<float*>(out);
  unsigned grid = 0;
  cudaError_t err;
  if (hw == 64) {
    err = grid_for(mcu_forward_kernel<64>, n, &grid);
    if (err != cudaSuccess) return err;
    mcu_forward_kernel<64><<<grid, kThreads, 0, s>>>(x, m, o, y, n, snap_eps);
  } else {
    err = grid_for(mcu_forward_kernel<32>, n, &grid);
    if (err != cudaSuccess) return err;
    mcu_forward_kernel<32><<<grid, kThreads, 0, s>>>(x, m, o, y, n, snap_eps);
  }
  return cudaGetLastError();
}

// zz: (n, hw) float32; basis: (hw, hw) float32, row p the basis of pixel p;
// out: (n, hw) uint8; all contiguous, zz and out 16-byte aligned.
extern "C" int mcu_inverse_launch(const void* zz, const void* basis, void* out,
                                  long long n, int hw, void* stream) {
  if (hw != 64 && hw != 32) return cudaErrorInvalidValue;
  if (!aligned16(zz) || !aligned16(out)) return cudaErrorMisalignedAddress;
  if (n <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* z = static_cast<const float*>(zz);
  const float* m = static_cast<const float*>(basis);
  uint8_t* y = static_cast<uint8_t*>(out);
  unsigned grid = 0;
  cudaError_t err;
  if (hw == 64) {
    err = grid_for(mcu_inverse_kernel<64>, n, &grid);
    if (err != cudaSuccess) return err;
    mcu_inverse_kernel<64><<<grid, kThreads, 0, s>>>(z, m, y, n);
  } else {
    err = grid_for(mcu_inverse_kernel<32>, n, &grid);
    if (err != cudaSuccess) return err;
    mcu_inverse_kernel<32><<<grid, kThreads, 0, s>>>(z, m, y, n);
  }
  return cudaGetLastError();
}

extern "C" const char* mcu_transform_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
