// The phase split of K7, the packed16 plane decode, for Hopper (sm_90a):
// (bh · bw, K) packed16 words + (bh · bw,) symbol lengths → (bh, K, bw)
// int16, at K = 32 (chroma) and 64 (luma).
//
// Replaces profiles/profile_rle_expand_ablate.py::kernel (:38; build :94,
// pallas_call :109), the cumulative ablation of the TPU's plane decode:
// copyT, +unpack, +matmul, +dist, full.  Each ablated phase is an
// instantiation of K7's template (csrc/expand16_plane.cuh, which states what
// each phase writes), so the phases run K7's own code up to their cut, in
// K7's CTA shape, ring and stores; the full phase is K7 itself
// (csrc/expand16_kernel.cu), which is not built again here.  Eight
// instantiations: four phases at K = 32 and 64.
//
// What bounds them: the bytes K7 moves, words and lengths in, int16 values
// out (2 + 4/K bytes in, 2 out per value): 0.0814 ms for the luma of 16
// frames of 2048² (1,048,576 × 64) at 3.35 TB/s, 0.0207 ms for their Cr
// chroma (524,288 × 32).  The phases differ only in instruction count, so
// the step from one phase to the next is the cost of that phase's code.

#include <type_traits>

#include "expand16_plane.cuh"

namespace {

constexpr int kPhases = 4;

// f(std::integral_constant<Phase, P>{}) for the phase numbered `phase`.
template <class F>
cudaError_t with_phase(int phase, F f) {
  switch (phase) {
    case 0: return f(std::integral_constant<Phase, Phase::kCopyT>{});
    case 1: return f(std::integral_constant<Phase, Phase::kUnpack>{});
    case 2: return f(std::integral_constant<Phase, Phase::kMatmul>{});
    case 3: return f(std::integral_constant<Phase, Phase::kDist>{});
    default: return cudaErrorInvalidValue;
  }
}

bool bad(int phase, int seg) {
  return phase < 0 || phase >= kPhases || (seg != 32 && seg != 64);
}

}  // namespace

// phase: 0 copyT, 1 unpack, 2 matmul, 3 dist; seg 32 or 64.
// packed: (bh · bw, seg) uint16, block-row-major, 16-byte aligned;
// lengths: (bh · bw,) int32, 4-byte aligned; out: (bh, seg, bw) int16; all
// contiguous.  Launches on `stream` and returns the first CUDA error of the
// device and occupancy queries or the launch (0 on success); never
// synchronises.
extern "C" int expand16_probe_launch(int phase, const void* packed,
                                     const void* lengths, void* out,
                                     long long bh, long long bw, int seg,
                                     void* stream) {
  if (bad(phase, seg) || bh < 0 || bw < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(packed) % 16 ||
      reinterpret_cast<uintptr_t>(lengths) % 4 ||
      reinterpret_cast<uintptr_t>(out) % 2)
    return cudaErrorMisalignedAddress;
  if (bh == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_phase(phase, [&](auto p) {
    constexpr Phase P = decltype(p)::value;
    return seg == 64 ? launch_plane<64, P>(packed, lengths, out, bh, bw, s)
                     : launch_plane<32, P>(packed, lengths, out, bh, bw, s);
  });
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of a phase at seg on the current device; returns the first CUDA error.
extern "C" int expand16_probe_attributes(int phase, int seg, int* regs,
                                         int* smem, int* ctas) {
  if (bad(phase, seg)) return cudaErrorInvalidValue;
  return with_phase(phase, [&](auto p) {
    constexpr Phase P = decltype(p)::value;
    return seg == 64 ? plane_attributes<64, P>(regs, smem, ctas)
                     : plane_attributes<32, P>(regs, smem, ctas);
  });
}

extern "C" const char* expand16_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
