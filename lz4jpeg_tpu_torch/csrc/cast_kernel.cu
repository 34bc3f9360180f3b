// Elementwise dtype casts for Hopper (sm_90a), bit-identical to torch's
// Tensor.to(dst): the seven conversions of the TPU cast probe,
//   0 int16 → float32   1 int32 → float32   2 uint8 → int32   3 int8 → int32
//   4 int16 → int32     5 uint8 → int16     6 bfloat16 → float32.
//
// Replaces profiles/profile_mosaic_casts.py::kern (:15, pallas_call :19),
// which asked which casts Mosaic lowers and whether each is exact on a
// (64, 256) tile.  On Hopper every one is a conversion instruction or a
// move: int → float rounds to nearest even (__int2float_rn: exact for int16,
// the IEEE rounding of |x| > 2^24 for int32; a plain C cast under
// -use_fast_math need not be), the integer widenings zero- or sign-extend,
// and bfloat16 → float32 is the 16-bit shift of the bits (subnormals,
// infinities and NaN payloads carry over, as in c10::BFloat16).
//
// Design: one template <Src, Dst>, a grid-stride loop over groups of
// 16 / max(sizeof(Src), sizeof(Dst)) elements: a thread moves 16 bytes of
// the wider type and 4-16 of the narrower, so each warp load and each warp
// store covers consecutive addresses (a 16-byte source vector with its
// 32- or 64-byte result stored by one lane would leave every store
// instruction strided); 64 bytes of the source a thread are loaded before
// any is stored, with the streaming cache hint; the last elements past the
// groups one by one.  Both pointers must be 16-byte aligned (the wrapper
// copies a source that is not).  The grid is as many CTAs as fit on the
// SMs.
//
// What bounds it: one read of the source and one write of the result, no
// arithmetic to speak of.  At 134,217,728 elements (the probe's tile grown
// to 64 × 2,097,152): uint8 → int16 402,653,184 bytes, 0.1202 ms at 3.35
// TB/s; uint8 / int8 → int32 0.2003 ms; the 2 → 4-byte casts 0.2404 ms;
// int32 → float32 0.3205 ms.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Bf16 {  // the 16 bits of a bfloat16
  uint16_t bits;
};

template <typename S, typename D>
struct Convert;
template <>
struct Convert<int16_t, float> {
  __device__ static float of(int16_t x) { return __int2float_rn(x); }
};
template <>
struct Convert<int32_t, float> {
  __device__ static float of(int32_t x) { return __int2float_rn(x); }
};
template <typename S>
struct Convert<S, int32_t> {
  __device__ static int32_t of(S x) { return static_cast<int32_t>(x); }
};
template <>
struct Convert<uint8_t, int16_t> {
  __device__ static int16_t of(uint8_t x) { return static_cast<int16_t>(x); }
};
template <>
struct Convert<Bf16, float> {
  __device__ static float of(Bf16 x) {
    return __uint_as_float(static_cast<uint32_t>(x.bits) << 16);
  }
};

// n consecutive bytes as one load or store.
template <int bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };

// A thread converts kN elements at a time: 16 bytes of the wider of the two
// types, so a warp's loads and stores both cover consecutive addresses.
// kUnroll such groups are loaded before any is converted and stored, 64
// bytes of the source a thread in flight (at least 4 groups).
template <typename S, typename D>
struct Vectors {
  static constexpr int kWide = sizeof(S) > sizeof(D) ? sizeof(S) : sizeof(D);
  static constexpr int kN = 16 / kWide;
  static constexpr int kInBytes = kN * static_cast<int>(sizeof(S));
  static constexpr int kUnroll = 64 / kInBytes > 4 ? 64 / kInBytes : 4;
  using Load = typename Raw<kInBytes>::type;
  using Store = typename Raw<kN * static_cast<int>(sizeof(D))>::type;
  union In {
    Load v;
    S e[kN];
  };
  union Out {
    Store v;
    D e[kN];
  };
};

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const S* __restrict__ in, D* __restrict__ out, long long n) {
  using V = Vectors<S, D>;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long n_vec = n / V::kN;
  const auto* src = reinterpret_cast<const typename V::Load*>(in);
  auto* dst = reinterpret_cast<typename V::Store*>(out);
  auto convert = [](const typename V::In& a) {
    typename V::Out o;
#pragma unroll
    for (int j = 0; j < V::kN; ++j) o.e[j] = Convert<S, D>::of(a.e[j]);
    return o.v;
  };
  long long i = tid;
  for (; i + (V::kUnroll - 1) * stride < n_vec; i += V::kUnroll * stride) {
    typename V::In a[V::kUnroll];
#pragma unroll
    for (int u = 0; u < V::kUnroll; ++u) a[u].v = __ldcs(src + i + u * stride);
#pragma unroll
    for (int u = 0; u < V::kUnroll; ++u)
      __stcs(dst + i + u * stride, convert(a[u]));
  }
  for (; i < n_vec; i += stride) {
    typename V::In a;
    a.v = __ldcs(src + i);
    __stcs(dst + i, convert(a));
  }
  for (i = n_vec * V::kN + tid; i < n; i += stride)
    out[i] = Convert<S, D>::of(in[i]);
}

// The pair's (source bytes, destination bytes) and kernel, or 0 and nullptr.
const void* pair_kernel(int pair, int* src_bytes, int* dst_bytes) {
  switch (pair) {
#define CAST_PAIR(ID, S, D)                                 \
  case ID:                                                  \
    *src_bytes = sizeof(S);                                 \
    *dst_bytes = sizeof(D);                                 \
    return reinterpret_cast<const void*>(cast_kernel<S, D>);
    CAST_PAIR(0, int16_t, float)
    CAST_PAIR(1, int32_t, float)
    CAST_PAIR(2, uint8_t, int32_t)
    CAST_PAIR(3, int8_t, int32_t)
    CAST_PAIR(4, int16_t, int32_t)
    CAST_PAIR(5, uint8_t, int16_t)
    CAST_PAIR(6, Bf16, float)
#undef CAST_PAIR
    default:
      *src_bytes = *dst_bytes = 0;
      return nullptr;
  }
}

// As many CTAs as fit on the SMs, no more than the work needs.
cudaError_t grid_for(const void* kernel, long long units, unsigned* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long need = (units + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *ctas = static_cast<unsigned>(need < resident ? need : resident);
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <typename S, typename D>
cudaError_t launch(const void* in, void* out, long long n, cudaStream_t s) {
  using V = Vectors<S, D>;
  const long long units = (n / V::kN + V::kUnroll - 1) / V::kUnroll + 1;
  unsigned ctas = 0;
  const cudaError_t err = grid_for(
      reinterpret_cast<const void*>(cast_kernel<S, D>), units, &ctas);
  if (err != cudaSuccess) return err;
  cast_kernel<S, D><<<ctas, kThreads, 0, s>>>(static_cast<const S*>(in),
                                               static_cast<D*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// in: n elements of the pair's source type, out: n of its destination type,
// both contiguous and 16-byte aligned.  Launches on `stream` and returns
// the first CUDA error of the device and occupancy queries or the launch
// (0 on success), cudaErrorInvalidValue for an unknown pair or n < 0,
// cudaErrorMisalignedAddress for a pointer off a 16-byte boundary; never
// synchronises.
extern "C" int cast_launch(int pair, const void* in, void* out, long long n,
                           void* stream) {
  int sb = 0, db = 0;
  if (pair_kernel(pair, &sb, &db) == nullptr || n < 0)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pair) {
    case 0: return launch<int16_t, float>(in, out, n, s);
    case 1: return launch<int32_t, float>(in, out, n, s);
    case 2: return launch<uint8_t, int32_t>(in, out, n, s);
    case 3: return launch<int8_t, int32_t>(in, out, n, s);
    case 4: return launch<int16_t, int32_t>(in, out, n, s);
    case 5: return launch<uint8_t, int16_t>(in, out, n, s);
    default: return launch<Bf16, float>(in, out, n, s);
  }
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the pair's kernel; returns the first CUDA error.
extern "C" int cast_attributes(int pair, int* regs, int* smem, int* ctas) {
  int sb = 0, db = 0;
  const void* fn = pair_kernel(pair, &sb, &db);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, 0);
}

extern "C" const char* cast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
