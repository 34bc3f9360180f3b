// The forward megakernel's probe variants for Hopper (sm_90a): K1's body
// (csrc/fwd_megakernel.cuh) with one part turned off at a time, built up
// from a bare copy, or fed the KT block layout.
//
// Replaces the Pallas TPU kernels of five probes:
//   - profiles/probe_megakernel_ablate.py:77 `kernel` (pallas_call :139): the
//     megakernel with six switches, chunk of blocks per grid step, dot
//     precision, output orientation, colour, channels, sparse epilogue;
//   - profiles/probe_megakernel_dma.py:78 `kernel` (pallas_call :154): the
//     ladder of bare costs, a u8 copy of R[0:64], G[0:32] and B[0:32] per
//     tile, an i16 cast, a trip through f32, then raw basis dots;
//   - profiles/probe_megakernel.py:108 `kernel` (pallas_call :174): the
//     megakernel fed by a KT transpose, writing per-channel (N, 64), (N, 32),
//     (N, 32) int16 streams and three (N, 1) int32 run counts;
//   - profiles/probe_megakernel_t.py:50 `kernel` (pallas_call :89): the
//     product emitted (C, 128) directly, against the production kernel's
//     basis × samples and transpose out;
//   - profiles/probe_megakernel_v2.py:85 `kernel` (pallas_call :126): the
//     combined (C, 128) output from the KT layout in the modes copy, dct
//     and full, at chunks C = 1024, 2048 and 4096.
// Here every row is one instantiation of K1's template, so each difference
// between two rows' times is the cost of the part that differs, inside K1's
// own frame: the same bands, ring, barriers and shared memory.  The band of
// T tiles plays the TPU's chunk of C blocks (T = 32, 64, 128 for C = 1024,
// 2048, 4096).  The TPU's DEFAULT precision and its "bf16 one-pass" dots are
// one pass of the hi bf16 basis part on Hopper (one instantiation); HIGHEST
// is K1's three exact parts.  No TF32 anywhere.  The probes' float32 colour
// with snap-trunc is K1's exact integer colour here (identical on every
// colour).
//
// What bounds them.  Every variant reads the 3 bytes of each pixel (192 per
// block, as RGB bands or KT slabs; the KT i16 cast only the 128 of R[0:64],
// G[0:32] and B[0:32], which its slab holds apart) and writes 64 or 128
// lanes per tile (1 or 2 bytes each; the split stage 4 bytes more of run
// counts): 0.2805 ms at 32 frames of 2048² and 3.35 TB/s for K1's row,
// 0.2880 for the split stage, 0.2404 for the KT cast, 0.2003 ms for the u8
// copy; the product, where there is one, is at most 0.078 ms of bf16 tensor
// work at 989 TFLOP/s.  Each variant keeps K1's shared-memory layout (66-72
// KB at T = 64) and its three CTAs per SM, so a difference of two rows is
// the work of the part that differs, not a change of occupancy (T = 128
// needs 144 KB: one CTA per SM).

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
// The layout variants (probe_megakernel.py, probe_megakernel_t.py,
// probe_megakernel_v2.py): K1's arithmetic, or the i16 cast, read from KT
// slabs.
constexpr auto kKt = Input::kKt;
template <int T, Stage S, int MinCtas = 3, bool BasisA = false>
using KtProduct = Variant<T, 3, kYCbCr, 3, S, true, true, MinCtas, kKt, BasisA>;
template <int T, int MinCtas = 3>
using KtCopy = Variant<T, 1, kRGB, 3, Stage::kCastI16, false, true, MinCtas, kKt>;
using KtSplitRuns = KtProduct<64, Stage::kSplit>;
using KtFull = KtProduct<64, Stage::kSparse>;
using KtFull32 = KtProduct<32, Stage::kSparse>;
using KtFull128 = KtProduct<128, Stage::kSparse, 1>;
using KtBasisA = KtProduct<64, Stage::kSparse, 3, true>;
using KtDct = KtProduct<64, Stage::kTrunc>;
using KtCopy32 = KtCopy<32>;
using KtCopy64 = KtCopy<64>;
using KtCopy128 = KtCopy<128, 1>;

// Variant ids: the order of lz4jpeg_tpu_torch/profiles/megakernel.py's
// VARIANTS, which checks these names when it loads the library.
const char* const kNames[] = {
    "full", "one_part", "coefficient_major", "no_sparse", "no_colour",
    "luma_only", "band_128", "band_16", "band_32", "bare",
    "copy_u8", "cast_i16", "sum_f32", "dots_one_part", "dots_three_parts",
    "dots_three_parts_block", "dots_one_part_block",
    "kt_split_runs", "kt_full", "kt_full_32", "kt_full_128", "kt_basis_a",
    "kt_dct", "kt_copy_32", "kt_copy", "kt_copy_128",
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
    case 17: return f(KtSplitRuns{});
    case 18: return f(KtFull{});
    case 19: return f(KtFull32{});
    case 20: return f(KtFull128{});
    case 21: return f(KtBasisA{});
    case 22: return f(KtDct{});
    case 23: return f(KtCopy32{});
    case 24: return f(KtCopy64{});
    case 25: return f(KtCopy128{});
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
// Returns cudaErrorInvalidValue for anything else (a KT variant too), the
// first failed query, or cudaGetLastError() after the launch on `stream`;
// never synchronises.
extern "C" int fwd_probe_launch(int variant, const void* rgb, void* out,
                                const void* parts, int batch, int height,
                                int width, void* stream) {
  if (height % 8 != 0 || (static_cast<int64_t>(width) * 3) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rgb) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  return with_variant(variant, [&](auto v) {
    using V = decltype(v);
    if constexpr (V::kInput == Input::kKt) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      return launch_variant<V>(rgb, out, parts, batch, height, width,
                               height / 8, width / 8, 1, stream);
    }
  });
}

// kt: (3, 64, n_blocks) uint8, contiguous and 16-byte aligned, n_blocks %
// 16 == 0; outs: the variant's outputs (KtOut: outs[0] its (N, lanes)
// rows, or for the split stage the (N, 64), (N, 32), (N, 32) int16 segments
// and their three (N,) int32 run counts); parts as fwd_probe_launch's.
// Returns cudaErrorInvalidValue for anything else (an RGB variant too), the
// first failed query, or cudaGetLastError() after the launch on `stream`;
// never synchronises.
extern "C" int fwd_probe_kt_launch(int variant, const void* kt,
                                   void* const* outs, const void* parts,
                                   int64_t n_blocks, void* stream) {
  return with_variant(variant, [&](auto v) {
    using V = decltype(v);
    if constexpr (V::kInput == Input::kKt) {
      KtOut out{};
      const int n_outs = V::kStage == Stage::kSplit ? 6 : 1;
      for (int i = 0; i < n_outs; ++i) out.p[i] = outs[i];
      return launch_kt<V>(kt, out, parts, n_blocks, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  });
}

template <class V>
auto kernel_of() {
  if constexpr (V::kInput == Input::kKt) {
    return fwd_megakernel_kt<V>;
  } else {
    return fwd_megakernel<V>;
  }
}

// The variant's registers per thread, dynamic + static shared memory per CTA
// and resident CTAs per SM (cudaFuncGetAttributes and the occupancy query
// at 256 threads): what explains a row without a profiler.
extern "C" int fwd_probe_attributes(int variant, int* regs, int* smem,
                                    int* ctas_per_sm) {
  return with_variant(variant, [&](auto v) {
    using V = decltype(v);
    const int bytes = static_cast<int>(sizeof(Smem<V>));
    const auto kernel = kernel_of<V>();
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas_per_sm, kernel, kThreads, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *smem = bytes + static_cast<int>(attr.sharedSizeBytes);
    return static_cast<int>(cudaSuccess);
  });
}

extern "C" const char* fwd_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
