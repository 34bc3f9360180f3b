// The forward megakernel's attribution variants for Hopper (sm_90a): K1's
// body (csrc/fwd_megakernel.cuh) with one part turned off at a time, and
// built up from a bare copy.
//
// Replaces the Pallas TPU kernels of two probes, which ablated the TPU's K1:
//   - profiles/probe_megakernel_ablate.py:77 `kernel` (pallas_call :139): the
//     megakernel with six switches, chunk of blocks per grid step, dot
//     precision, output orientation, colour, channels, sparse epilogue;
//   - profiles/probe_megakernel_dma.py:78 `kernel` (pallas_call :154): the
//     ladder of bare costs, a u8 copy of R[0:64], G[0:32] and B[0:32] per
//     tile, an i16 cast, a trip through f32, then raw basis dots.
// Here every row is one instantiation of K1's template, so each difference
// between two rows' times is the cost of the part that differs, inside K1's
// own frame: the same bands, ring, barriers and shared memory.  The band of
// T tiles plays the TPU's chunk of C blocks (T = 64 for C = 2048).  The
// TPU's DEFAULT precision and its "bf16 one-pass" dots are one pass of the
// hi bf16 basis part on Hopper (one instantiation); HIGHEST is K1's three
// exact parts.  No TF32 anywhere.
//
// What bounds them.  Every variant reads the 3 bytes of each pixel and
// writes 64 or 128 lanes per tile (1 or 2 bytes each): 0.2805 ms at 32
// frames of 2048² and 3.35 TB/s for K1's row, 0.2003 ms for the u8 copy;
// the product, where there is one, is at most 0.078 ms of bf16 tensor work
// at 989 TFLOP/s.  Each variant keeps K1's shared-memory layout (66-72 KB
// at T = 64) and its three CTAs per SM, so a difference of two rows is the
// work of the part that differs, not a change of occupancy (T = 128 needs
// 144 KB: one CTA per SM).

#include "fwd_megakernel.cuh"

namespace {

constexpr auto kYCbCr = Colour::kYCbCr;
constexpr auto kR = Colour::kR;
constexpr auto kRGB = Colour::kRGB;

// The ablation (probe_megakernel_ablate.py:148-167).
using Full = K1Variant;
using OnePart = Variant<64, 1, kYCbCr, 3, Stage::kSparse, true, true, 3>;
using CoefficientMajor = Variant<64, 3, kYCbCr, 3, Stage::kSparse, true, false, 3>;
using NoSparse = Variant<64, 3, kYCbCr, 3, Stage::kTrunc, true, true, 3>;
using NoColour = Variant<64, 3, kR, 3, Stage::kSparse, true, true, 3>;
using LumaOnly = Variant<64, 3, kYCbCr, 1, Stage::kSparse, true, true, 3>;
using Band128 = Variant<128, 3, kYCbCr, 3, Stage::kSparse, true, true, 1>;
using Band16 = Variant<16, 3, kYCbCr, 3, Stage::kSparse, true, true, 3>;
using Band32 = Variant<32, 3, kYCbCr, 3, Stage::kSparse, true, true, 3>;
using Bare = Variant<64, 1, kR, 3, Stage::kTrunc, true, false, 3>;
// The ladder (probe_megakernel_dma.py:167-174): raw samples, no offset.
using CopyU8 = Variant<64, 1, kRGB, 3, Stage::kCopyU8, false, false, 3>;
using CastI16 = Variant<64, 1, kRGB, 3, Stage::kCastI16, false, false, 3>;
using SumF32 = Variant<64, 1, kRGB, 3, Stage::kSumF32, false, false, 3>;
using DotsOnePart = Variant<64, 1, kRGB, 3, Stage::kTrunc, false, false, 3>;
using DotsThreeParts = Variant<64, 3, kRGB, 3, Stage::kTrunc, false, false, 3>;
using DotsThreePartsBlock = Variant<64, 3, kRGB, 3, Stage::kTrunc, false, true, 3>;
using DotsOnePartBlock = Variant<64, 1, kRGB, 3, Stage::kTrunc, false, true, 3>;

// Variant ids: the order of lz4jpeg_tpu_torch/profiles/megakernel.py's
// VARIANTS, which checks these names when it loads the library.
const char* const kNames[] = {
    "full", "one_part", "coefficient_major", "no_sparse", "no_colour",
    "luma_only", "band_128", "band_16", "band_32", "bare",
    "copy_u8", "cast_i16", "sum_f32", "dots_one_part", "dots_three_parts",
    "dots_three_parts_block", "dots_one_part_block",
};
constexpr int kCount = sizeof(kNames) / sizeof(kNames[0]);

template <class F>
int with_variant(int id, F&& f) {
  switch (id) {
    case 0: return f(Full{});
    case 1: return f(OnePart{});
    case 2: return f(CoefficientMajor{});
    case 3: return f(NoSparse{});
    case 4: return f(NoColour{});
    case 5: return f(LumaOnly{});
    case 6: return f(Band128{});
    case 7: return f(Band16{});
    case 8: return f(Band32{});
    case 9: return f(Bare{});
    case 10: return f(CopyU8{});
    case 11: return f(CastI16{});
    case 12: return f(SumF32{});
    case 13: return f(DotsOnePart{});
    case 14: return f(DotsThreeParts{});
    case 15: return f(DotsThreePartsBlock{});
    case 16: return f(DotsOnePartBlock{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fwd_probe_variant_count() { return kCount; }

extern "C" const char* fwd_probe_variant_name(int variant) {
  return variant >= 0 && variant < kCount ? kNames[variant] : nullptr;
}

// rgb: (batch, H, W, 3) uint8, contiguous and 16-byte aligned, with H % 8
// == 0 and W·3 % 16 == 0 (the staged cp.async route, the only one the
// probes run); out: the variant's (N, lanes) or (lanes, N) output, N =
// batch·(H/8)·(W/8); parts: K1's basis operand (three bf16 parts of the
// luma then the chroma basis; one-part variants read the hi part only).
// Returns cudaErrorInvalidValue for anything else, the first failed query,
// or cudaGetLastError() after the launch on `stream`; never synchronises.
extern "C" int fwd_probe_launch(int variant, const void* rgb, void* out,
                                const void* parts, int batch, int height,
                                int width, void* stream) {
  if (height % 8 != 0 || (static_cast<int64_t>(width) * 3) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rgb) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  return with_variant(variant, [&](auto v) {
    using V = decltype(v);
    return launch_variant<V>(rgb, out, parts, batch, height, width, height / 8,
                             width / 8, 1, stream);
  });
}

// The variant's registers per thread, dynamic + static shared memory per CTA
// and resident CTAs per SM (cudaFuncGetAttributes and the occupancy query
// at 256 threads): what explains a row without a profiler.
extern "C" int fwd_probe_attributes(int variant, int* regs, int* smem,
                                    int* ctas_per_sm) {
  return with_variant(variant, [&](auto v) {
    using V = decltype(v);
    const int bytes = static_cast<int>(sizeof(Smem<V>));
    cudaError_t err = cudaFuncSetAttribute(
        fwd_megakernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fwd_megakernel<V>);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, fwd_megakernel<V>, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *smem = bytes + static_cast<int>(attr.sharedSizeBytes);
    return static_cast<int>(cudaSuccess);
  });
}

extern "C" const char* fwd_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
