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
// Design: the streaming shape of csrc/stream_copy.cuh.  A lane converts one
// vector of kIn = 16 / sizeof(D) elements: it loads their kIn · sizeof(S)
// source bytes (4, 8 or 16) as one load and stores their results as one
// 16-byte vector.  The lanes of a warp hold adjacent vectors, so each warp
// load and each warp store covers whole 128-byte lines.  Each CTA of
// kThreads threads converts one chunk of kThreads vectors, and the grid
// has one CTA a chunk in index order, with no cap at the resident count and
// no grid-stride walk, so the bytes in flight stay in one window that moves
// through the array; the loads and stores keep the default cache hints (the
// evict-first hints of a persistent grid-stride loop cost the copies 1.5%
// whenever the L2 held other lines, PERF.md §6).  The last n % kIn elements
// go one by one, as chunks of a list, CTA 0 taking the first.  Offsets are
// 64-bit.  Both pointers must be 16-byte aligned (the wrapper copies a
// source that is not).  A sweep of 45 launch shapes on an H100 (PERF.md §6)
// put this one, at 512 threads, within 0.3% of the fastest for six pairs
// (int32 → float32 within 0.2% of its 1,024-thread build, timed in turns);
// a 16-byte source vector whose results one lane stores took uint8 → int32
// 2.1× as long, regrouping those stores by shuffles only came back to this
// shape, and more vectors a thread only added time.
//
// What bounds it: one read of the source and one write of the result, no
// arithmetic to speak of.  At 134,217,728 elements (the probe's tile grown
// to 64 × 2,097,152): uint8 → int16 402,653,184 bytes, 0.1202 ms at 3.35
// TB/s; uint8 / int8 → int32 0.2003 ms; the 2 → 4-byte casts 0.2404 ms;
// int32 → float32 0.3205 ms.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

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

// n consecutive bytes as one load.
template <int bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };

constexpr int kThreads = 512;

// What the pair's types make of a vector: kIn elements, kIn · sizeof(S)
// bytes in and 16 bytes out.
template <typename S, typename D>
struct Layout {
  static constexpr int kIn = 16 / static_cast<int>(sizeof(D));
  static constexpr int kLoadBytes = kIn * static_cast<int>(sizeof(S));
  using Load = typename Raw<kLoadBytes>::type;
  union In {
    Load v;
    S e[kIn];
  };
  union Out {
    uint4 v;
    D e[kIn];
  };
};

// The launch: n_vec vectors, then `tail` elements one by one; one CTA a
// chunk of the vectors or of the tail list, whichever needs more.
struct Plan {
  int64_t n_vec, tail, ctas;
};

template <typename S, typename D>
Plan plan_of(int64_t n) {
  using L = Layout<S, D>;
  Plan p;
  p.n_vec = n / L::kIn;
  p.tail = n - p.n_vec * L::kIn;
  const int64_t body = (p.n_vec + kThreads - 1) / kThreads;
  const int64_t chunk = static_cast<int64_t>(kThreads) * L::kIn;
  const int64_t rest = (p.tail + chunk - 1) / chunk;
  p.ctas = body > rest ? body : rest;
  return p;
}

template <typename S, typename D>
__global__ void __launch_bounds__(kThreads)
    cast_kernel(const S* __restrict__ in, D* __restrict__ out, int64_t n_vec,
                int64_t tail) {
  using L = Layout<S, D>;
  const int64_t c = blockIdx.x;
  const int64_t i = c * kThreads + threadIdx.x;
  if (i < n_vec) {
    typename L::In a;
    a.v = reinterpret_cast<const typename L::Load*>(in)[i];
    typename L::Out o;
#pragma unroll
    for (int j = 0; j < L::kIn; ++j) o.e[j] = Convert<S, D>::of(a.e[j]);
    reinterpret_cast<uint4*>(out)[i] = o.v;
  }

  // The tail list: elements n_vec · kIn + j, chunk c of it here.
  const int64_t t0 = n_vec * L::kIn;
  const int64_t chunk = static_cast<int64_t>(kThreads) * L::kIn;
  const int64_t end = (c + 1) * chunk < tail ? (c + 1) * chunk : tail;
  for (int64_t j = c * chunk + threadIdx.x; j < end; j += kThreads)
    out[t0 + j] = Convert<S, D>::of(in[t0 + j]);
}

template <typename S, typename D>
cudaError_t launch(const void* in, void* out, int64_t n, cudaStream_t s) {
  const Plan p = plan_of<S, D>(n);
  cast_kernel<S, D><<<static_cast<unsigned>(p.ctas), kThreads, 0, s>>>(
      static_cast<const S*>(in), static_cast<D*>(out), p.n_vec, p.tail);
  return cudaGetLastError();
}

// The pair's plan for n elements: plan[0] vectors, [1] tail elements, [2]
// CTAs, [3] elements a vector, [4] threads a CTA (and vectors a chunk).
template <typename S, typename D>
void describe(int64_t n, long long* plan) {
  const Plan p = plan_of<S, D>(n);
  plan[0] = p.n_vec;
  plan[1] = p.tail;
  plan[2] = p.ctas;
  plan[3] = Layout<S, D>::kIn;
  plan[4] = kThreads;
}

template <typename S, typename D>
cudaError_t attributes(int* regs, int* smem, int* ctas) {
  const void* fn = reinterpret_cast<const void*>(cast_kernel<S, D>);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, 0);
}

// Runs CALL with S and D the pair's source and destination types; nothing
// for an unknown pair.
#define CAST_DISPATCH(PAIR, CALL)          \
  switch (PAIR) {                          \
    case 0: { using S = int16_t; using D = float; CALL; } break;   \
    case 1: { using S = int32_t; using D = float; CALL; } break;   \
    case 2: { using S = uint8_t; using D = int32_t; CALL; } break; \
    case 3: { using S = int8_t; using D = int32_t; CALL; } break;  \
    case 4: { using S = int16_t; using D = int32_t; CALL; } break; \
    case 5: { using S = uint8_t; using D = int16_t; CALL; } break; \
    case 6: { using S = Bf16; using D = float; CALL; } break;      \
    default: break;                        \
  }

bool known(int pair) { return pair >= 0 && pair < 7; }

}  // namespace

// in: n elements of the pair's source type, out: n of its destination type,
// both contiguous and 16-byte aligned.  Launches on `stream` and returns
// the launch's CUDA error (0 on success), cudaErrorInvalidValue for an
// unknown pair or n < 0, cudaErrorMisalignedAddress for a pointer off a
// 16-byte boundary; never synchronises.
extern "C" int cast_launch(int pair, const void* in, void* out, long long n,
                           void* stream) {
  if (!known(pair) || n < 0) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(in) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return cudaErrorMisalignedAddress;
  if (n == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  CAST_DISPATCH(pair, err = (launch<S, D>(in, out, n, s)))
  return err;
}

// The launch cast_launch makes for n ≥ 0 elements of the pair (describe's
// five numbers); cudaErrorInvalidValue for an unknown pair or n < 0.
extern "C" int cast_plan(int pair, long long n, long long* plan) {
  if (!known(pair) || n < 0) return cudaErrorInvalidValue;
  CAST_DISPATCH(pair, (describe<S, D>(n, plan)))
  return cudaSuccess;
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of the pair's kernel; returns the first CUDA error.
extern "C" int cast_attributes(int pair, int* regs, int* smem, int* ctas) {
  if (!known(pair)) return cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
  CAST_DISPATCH(pair, err = (attributes<S, D>(regs, smem, ctas)))
  return err;
}

extern "C" const char* cast_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
