// The body of the forward megakernel (K1, csrc/fwd_megakernel.cu) as a
// template over a compile-time Variant.
//
// csrc/fwd_megakernel.cu instantiates K1's variant only (K1Variant below:
// its design is described there).  csrc/fwd_probe_kernel.cu instantiates
// the attribution variants that port profiles/probe_megakernel_ablate.py and
// profiles/probe_megakernel_dma.py (each turns one part of K1 off or builds
// it up from a bare copy, so the difference of two variants' times is the
// cost of that part), and the layout variants that port
// profiles/probe_megakernel.py, probe_megakernel_t.py and
// probe_megakernel_v2.py (K1's work read from the KT block layout).  A
// Variant fixes
//   - kTiles: T, the band in tiles of one block row (16, 32, 64 or 128);
//   - kParts: 3 bf16 basis parts (hi + mid + lo, K1's exact split) or 1
//     (hi only: the TPU's one-pass bf16 product, DEFAULT precision);
//   - kColour: YCbCr (K1), R feeding all three channels, or R, G, B feeding
//     the luma, Cr and Cb products raw (the ladder's dots);
//   - kChannels: 3, or luma only (64 output lanes);
//   - kStage: what the band stores: the sparse-delta epilogue (K1), the same
//     split into the luma, Cr and Cb outputs with each block's run counts,
//     truncated coefficients, or no product at all: R[0:64], G[0:32] and
//     B[0:32] of each tile copied as u8, cast to i16, or through f32
//     (lanes 64-95 hold G + B);
//   - kCentred: samples v - 128 with the offsets folded in and snap-trunc
//     (K1), or raw v with no offset, truncated toward zero;
//   - kBlockMajor: block-major (N, lanes) output (K1) or coefficient-major
//     (lanes, N), staged transposed in shared memory so that each lane's T
//     values go out as one contiguous run;
//   - kMinCtas: the minimum CTAs per SM of __launch_bounds__;
//   - kInput: (B, H, W, 3) RGB image bands (K1) or slabs of T blocks of the
//     (3, 64, N) KT layout (ops/fwd_megakernel.py::rgb_to_kt): 192 row
//     pieces of T bytes at stride N, the same 192·T bytes as an image band
//     (the i16 cast copies only the 128 pieces it reads);
//   - kBasisA: the samples as the mma's A operand (K1: the product comes out
//     (tile, lane)) or the basis (it comes out (lane, tile) and is written
//     transposed into the staging: the TPU production kernel's "dot, then
//     transpose out").
// Every value a variant computes feeds a stored output, so the compiler
// removes nothing that a variant's time claims to include.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;                 // band buffers in the ring
constexpr int kLumStride = 64 + 8;         // bf16 per operand row (+16 B:
constexpr int kChrStride = 32 + 8;         //  conflict-free ldmatrix)
constexpr int kQStride = 128 + 8;          // int16 per staged output row
constexpr int kBias = 1024;                // SPARSE16_DELTA_BIAS
constexpr int kLumPart = 64 * 64;          // bf16 values of one luma part
constexpr int kChrPart = 32 * 32;

enum class Colour { kYCbCr, kR, kRGB };
enum class Stage { kSparse, kTrunc, kCopyU8, kCastI16, kSumF32, kSplit };
enum class Input { kRgb, kKt };

template <int Tiles, int Parts, Colour C, int Channels, Stage S, bool Centred,
          bool BlockMajor, int MinCtas, Input In = Input::kRgb,
          bool BasisA = false>
struct Variant {
  static constexpr int kTiles = Tiles;
  static constexpr int kParts = Parts;
  static constexpr Colour kColour = C;
  static constexpr int kChannels = Channels;
  static constexpr Stage kStage = S;
  static constexpr bool kCentred = Centred;
  static constexpr bool kBlockMajor = BlockMajor;
  static constexpr int kMinCtas = MinCtas;
  static constexpr Input kInput = In;
  static constexpr bool kBasisA = BasisA;
  static constexpr bool kDeltas = S == Stage::kSparse || S == Stage::kSplit;
  static constexpr bool kProduct = kDeltas || S == Stage::kTrunc;
  static constexpr int kLanes = Channels == 3 ? 128 : 64;
  static constexpr int kRowBytes = Tiles * 24;  // one image row of a band
  static constexpr int kRowChunks = kRowBytes / 16;
  static constexpr int kBandBytes = 8 * kRowBytes;
  using Out = std::conditional_t<S == Stage::kCopyU8, uint8_t, int16_t>;
  // Coefficient-major staging: one row of T outputs (+16 B) per lane.
  static constexpr int kLaneStride = Tiles + 16 / static_cast<int>(sizeof(Out));
  static constexpr int kQElems =
      BlockMajor ? Tiles * kQStride
                 : (kLanes * kLaneStride * static_cast<int>(sizeof(Out)) + 1) / 2;

  static_assert(Tiles >= 16 && Tiles <= 128 && (Tiles & (Tiles - 1)) == 0,
                "T is a power of two in [16, 128]: 2T groups fill whole rows");
  static_assert(Parts == 1 || Parts == 3, "one or three bf16 basis parts");
  static_assert(Channels == 3 || (Channels == 1 && C == Colour::kYCbCr),
                "luma only is a YCbCr variant");
  static_assert(kProduct || (Channels == 3 && (!BlockMajor ||
                                               (S == Stage::kCastI16 &&
                                                In == Input::kKt))),
                "the copy stages are the ladder's coefficient-major rungs, "
                "or the i16 cast of a KT slab, block-major");
  static_assert(!(kDeltas && !Centred), "sparse deltas are K1's");
  static_assert(In == Input::kRgb ||
                    (Tiles >= 32 && (kProduct ? C == Colour::kYCbCr && Centred &&
                                                    Parts == 3 && BlockMajor
                                              : S == Stage::kCastI16)),
                "a KT variant is K1's arithmetic or the i16 cast, T >= 32");
  static_assert(!BasisA || (kProduct && BlockMajor && Channels == 3),
                "the basis as A operand is a block-major product");
  static_assert(S != Stage::kSplit || (BlockMajor && Channels == 3),
                "the split stage cuts the three segments of block-major rows");
};

// K1: bands of 64 tiles, three parts, colour, three channels, the sparse
// epilogue, centred samples, block-major output, three CTAs per SM.
using K1Variant =
    Variant<64, 3, Colour::kYCbCr, 3, Stage::kSparse, true, true, 3>;

template <class V>
struct Smem {
  uint8_t raw[kStages][V::kBandBytes];
  uint16_t lum[V::kTiles * kLumStride];
  uint16_t chr[2][V::kTiles * kChrStride];
  int16_t q[V::kQElems];
};

struct Band {
  const uint8_t* src;   // first byte of the band's first image row
  int64_t out_row;      // output row of its first tile
  int rows;             // image rows inside the frame (1..8)
  int cols;             // pixel columns inside the frame (may be ≤ 0 past W)
  int tiles;            // tiles inside the block row (1..T)
};

// Band geometry in 32-bit arithmetic (the launcher checks that every band,
// block row and image row index fits in 31 bits); 64-bit only for the
// pointer and output row.
template <class V>
__device__ __forceinline__ Band band_at(const uint8_t* rgb, uint32_t band,
                                        int height, int width, int bpc,
                                        int bpr, int bands_per_row) {
  const uint32_t row_id = band / bands_per_row;  // frame · bpc + block row
  const int bx0 = static_cast<int>(band - row_id * bands_per_row) * V::kTiles;
  const uint32_t f = row_id / bpc;
  const int by = static_cast<int>(row_id - f * bpc);
  Band b;
  b.src = rgb + static_cast<int64_t>(f * height + by * 8) * (width * 3) +
          bx0 * 3 * 8;
  b.out_row = static_cast<int64_t>(row_id) * bpr + bx0;
  b.rows = min(8, height - by * 8);
  b.cols = width - bx0 * 8;
  b.tiles = min(V::kTiles, bpr - bx0);
  return b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// snap-trunc (eps 1e-5) of a product sum, as an int, with full-rate float
// adds only (rintf, truncf and float → int conversions run at a quarter of
// the FP32 rate).  |x| + 2^23 rounded toward zero is 2^23 + floor(|x|) for
// |x| < 2^23; frac = |x| - floor(|x|) is exact.  The reference snaps x to
// its nearest integer where they lie within eps: that is floor(|x|) when
// frac ≤ eps (truncation gives the same) and floor(|x|) + 1 when 1 - frac
// ≤ eps (1 - frac is exact there); otherwise it truncates.
__device__ __forceinline__ int snap_trunc_int(float x) {
  constexpr float k23 = 8388608.f;
  const float ax = fabsf(x);
  const float shifted = __fadd_rz(ax, k23);
  const float frac = __fadd_rn(ax, -__fadd_rn(shifted, -k23));
  const int mag = __float_as_int(shifted) - __float_as_int(k23) +
                  (__fadd_rn(1.f, -frac) <= 1e-5f ? 1 : 0);
  return x < 0.f ? -mag : mag;
}

// A product sum as an int: snap-trunc for centred samples (K1), truncation
// toward zero for raw ones (the ladder's dots, as a float → int16 cast).
template <bool kCentred>
__device__ __forceinline__ int to_int(float x) {
  return kCentred ? snap_trunc_int(x) : __float2int_rz(x);
}

// Colour with the reference's truncation, in exact integer arithmetic.  The
// coefficients have three decimals, so 1000·Y = 299R + 587G + 114B exactly,
// and the reference's float32 snap-trunc (eps 1e-4) returns floor(Y): its
// rounding error is far below the 1e-3 that separates a non-integer value
// on the 1/1000 grid from an integer (ops/color.py::_snap_trunc; checked on
// all 2^24 colours by tests/test_torch_forward.py).  Cr and Cb (+128) lie
// in [16, 239], so the reference's clamp to [0, 255] never binds.
// Each sum is two byte dot products (dp4a) of the pixel's R, G, B bytes with
// signed 8-bit coefficients, 1000·v = 256·dot(hi) + dot(lo) (+ 128000):
//   Y: 299 = 256 + 43, 587 = 512 + 75, 114 = 0 + 114;
//   Cr: 439 = 512 - 73, -368 = -256 - 112, -71 = 0 - 71;
//   Cb: -148 = -256 + 108, -291 = -256 - 35, 439 = 512 - 73.
// A pixel whose bytes start at byte 1 of its word takes the coefficients
// shifted up one byte (kShift).
constexpr int32_t kYHi = 0x00000201, kYLo = 0x00724B2B;
constexpr int32_t kCrHi = 0x0000FF02, kCrLo = 0x00B990B7;
constexpr int32_t kCbHi = 0x0002FFFF, kCbLo = 0x00B7DD6C;

__device__ __forceinline__ int32_t dp4a(uint32_t bytes, int32_t coef,
                                        int32_t acc) {
  int32_t d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(bytes), "r"(coef), "r"(acc));
  return d;
}

template <int kShift>
__device__ __forceinline__ uint32_t colour(uint32_t px, int32_t hi, int32_t lo,
                                           int32_t add) {
  const auto shifted = [](int32_t coef) {
    return static_cast<int32_t>(static_cast<uint32_t>(coef) << kShift);
  };
  const int32_t h = dp4a(px, shifted(hi), 0);
  return static_cast<uint32_t>(dp4a(px, shifted(lo), add + 256 * h)) / 1000u;
}

// The float v - 128 (centred) or v (raw) for v in [0, 255], exact, without
// an int → float conversion: 2^23 + v is the float whose bits are
// 0x4B000000 | v.  Its top 16 bits are its bf16 value (exact: at most 8
// significant bits).
template <bool kCentred>
__device__ __forceinline__ uint32_t sample(uint32_t v) {
  return __float_as_uint(__fadd_rn(__uint_as_float(0x4B000000u | v),
                                   kCentred ? -8388736.f : -8388608.f));
}

// Two samples as a bf16 pair (first in the low half).
template <bool kCentred>
__device__ __forceinline__ uint32_t bf16_pair(uint32_t first, uint32_t second) {
  return __byte_perm(sample<kCentred>(first), sample<kCentred>(second), 0x7632);
}

// Issue the 16-byte copies of one band into a ring buffer (aligned route).
// Thread i copies chunks i, i + kThreads, ...: the same (row, chunk) cells
// in every band.  A chunk index past the band's 8 rows has r ≥ 8 and copies
// nothing, so the loop may round its count up (T = 16 and 32).
template <class V>
__device__ __forceinline__ void load_band(uint8_t* buf, const Band& b,
                                          int row_bytes) {
  const int chunks = min(V::kTiles * 8, b.cols) * 3 / 16;
#pragma unroll
  for (int j = 0; j < (8 * V::kRowChunks + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / V::kRowChunks;
    const int c = i - r * V::kRowChunks;
    if (r < b.rows && c < chunks) {
      cp_async16(buf + r * V::kRowBytes + c * 16, b.src + r * row_bytes + c * 16);
    }
  }
}

// A group is (row r, tile t, half h): pixels 8t + 4h .. + 3 of image row r,
// 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3 B3.  Thread i takes groups
// (t, h) = (i/2 % T, i % 2) of rows i / (2T) + (kThreads / 2T)·j, the same
// cells in every band: T/16 groups per thread.
template <class V>
struct Groups {
  static constexpr int kPerThread = V::kTiles / 16;
  static constexpr int kRowStep = kThreads / (2 * V::kTiles);
  static_assert(8 * 2 * V::kTiles == kPerThread * kThreads, "whole groups");
};

// Colour of four pixels per thread → bf16 operands in shared memory: luma
// (T × 64), Cr and Cb (T × 32) each.  Chroma is computed for the odd
// columns only (the 4:2:2 pick).
template <class V>
__device__ __forceinline__ void convert_band(Smem<V>& sm, const uint8_t* buf,
                                             const Band& b, int row_bytes,
                                             bool staged) {
  constexpr bool kChroma = V::kChannels == 3;
  const int gi = threadIdx.x & (2 * V::kTiles - 1);
  const int t = gi >> 1;
  const int h = gi & 1;
  const int pc = 8 * t + 4 * h;  // band-relative pixel column
  const int in_cols = max(0, min(4, b.cols - pc));
#pragma unroll
  for (int j = 0; j < Groups<V>::kPerThread; ++j) {
    const int r = threadIdx.x / (2 * V::kTiles) + Groups<V>::kRowStep * j;
    const int valid = r < b.rows ? in_cols : 0;
    uint32_t w0, w1, w2, y0, y1, y2, y3, cr1 = 0, cr3 = 0, cb1 = 0, cb3 = 0;
    if (staged && valid == 4) {  // the aligned route: all four pixels inside
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(buf + r * V::kRowBytes + 12 * gi);
      w0 = src[0];
      w1 = src[1];
      w2 = src[2];
      if constexpr (V::kColour == Colour::kYCbCr) {
        // Pixels 0-3 as words whose bytes 0-2 (pixel 3: 1-3) are R, G, B.
        const uint32_t p1 = __byte_perm(w0, w1, 0x0543);
        const uint32_t p2 = __byte_perm(w1, w2, 0x0432);
        y0 = colour<0>(w0, kYHi, kYLo, 0);
        y1 = colour<0>(p1, kYHi, kYLo, 0);
        y2 = colour<0>(p2, kYHi, kYLo, 0);
        y3 = colour<8>(w2, kYHi, kYLo, 0);
        if constexpr (kChroma) {
          cr1 = colour<0>(p1, kCrHi, kCrLo, 128000);
          cr3 = colour<8>(w2, kCrHi, kCrLo, 128000);
          cb1 = colour<0>(p1, kCbHi, kCbLo, 128000);
          cb3 = colour<8>(w2, kCbHi, kCbLo, 128000);
        }
      } else {  // R0 = byte 0, R1 = byte 3, R2 = byte 6, R3 = byte 9
        y0 = w0 & 0xffu;
        y1 = w0 >> 24;
        y2 = (w1 >> 16) & 0xffu;
        y3 = (w2 >> 8) & 0xffu;
        if constexpr (V::kColour == Colour::kR) {
          cr1 = cb1 = y1;
          cr3 = cb3 = y3;
        } else {  // G1 = byte 4, G3 = byte 10; B1 = byte 5, B3 = byte 11
          cr1 = w1 & 0xffu;
          cr3 = (w2 >> 16) & 0xffu;
          cb1 = (w1 >> 8) & 0xffu;
          cb3 = w2 >> 24;
        }
      }
    } else {  // bytes from device memory; padding pixels are Y = Cr = Cb = 0
      const uint8_t* src = b.src + r * row_bytes + pc * 3;
      uint32_t px[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < valid) {
          px[i] = src[3 * i] | (static_cast<uint32_t>(src[3 * i + 1]) << 8) |
                  (static_cast<uint32_t>(src[3 * i + 2]) << 16);
        }
      }
      if constexpr (V::kColour == Colour::kYCbCr) {
        y0 = valid > 0 ? colour<0>(px[0], kYHi, kYLo, 0) : 0u;
        y1 = valid > 1 ? colour<0>(px[1], kYHi, kYLo, 0) : 0u;
        y2 = valid > 2 ? colour<0>(px[2], kYHi, kYLo, 0) : 0u;
        y3 = valid > 3 ? colour<0>(px[3], kYHi, kYLo, 0) : 0u;
        if constexpr (kChroma) {
          cr1 = valid > 1 ? colour<0>(px[1], kCrHi, kCrLo, 128000) : 0u;
          cr3 = valid > 3 ? colour<0>(px[3], kCrHi, kCrLo, 128000) : 0u;
          cb1 = valid > 1 ? colour<0>(px[1], kCbHi, kCbLo, 128000) : 0u;
          cb3 = valid > 3 ? colour<0>(px[3], kCbHi, kCbLo, 128000) : 0u;
        }
      } else {
        y0 = px[0] & 0xffu;
        y1 = px[1] & 0xffu;
        y2 = px[2] & 0xffu;
        y3 = px[3] & 0xffu;
        const int shift = V::kColour == Colour::kR ? 0 : 8;
        cr1 = (px[1] >> shift) & 0xffu;
        cr3 = (px[3] >> shift) & 0xffu;
        cb1 = (px[1] >> 2 * shift) & 0xffu;
        cb3 = (px[3] >> 2 * shift) & 0xffu;
      }
    }
    *reinterpret_cast<uint2*>(&sm.lum[t * kLumStride + r * 8 + 4 * h]) =
        make_uint2(bf16_pair<V::kCentred>(y0, y1),
                   bf16_pair<V::kCentred>(y2, y3));
    if constexpr (kChroma) {
      // Odd columns 1 and 3 of the group are chroma samples 2h and 2h + 1.
      *reinterpret_cast<uint32_t*>(&sm.chr[0][t * kChrStride + r * 4 + 2 * h]) =
          bf16_pair<V::kCentred>(cr1, cr3);
      *reinterpret_cast<uint32_t*>(&sm.chr[1][t * kChrStride + r * 4 + 2 * h]) =
          bf16_pair<V::kCentred>(cb1, cb3);
    }
  }
}

// The ladder's bare rungs (no product), staged route only: each tile's R
// bytes (positions 0-63) and the first 32 positions (rows 0-3) of G and B go
// to the coefficient-major staging, lanes 0-63, 64-95 and 96-127: as u8, as
// i16, or through f32 with lanes 64-95 holding G + B.
template <class V>
__device__ __forceinline__ void convert_bare(Smem<V>& sm, const uint8_t* buf) {
  using Out = typename V::Out;
  Out* q = reinterpret_cast<Out*>(sm.q);
  const int gi = threadIdx.x & (2 * V::kTiles - 1);
  const int t = gi >> 1;
  const int h = gi & 1;
  const auto put = [&](int lane, uint32_t v) {
    q[lane * V::kLaneStride + t] = static_cast<Out>(v);
  };
  const auto f32 = [](uint32_t v) {
    return static_cast<uint32_t>(__float2int_rz(__uint2float_rn(v)));
  };
#pragma unroll
  for (int j = 0; j < Groups<V>::kPerThread; ++j) {
    const int r = threadIdx.x / (2 * V::kTiles) + Groups<V>::kRowStep * j;
    const uint32_t* src =
        reinterpret_cast<const uint32_t*>(buf + r * V::kRowBytes + 12 * gi);
    const uint32_t w0 = src[0], w1 = src[1], w2 = src[2];
    const uint32_t red[4] = {w0 & 0xffu, w0 >> 24, (w1 >> 16) & 0xffu,
                             (w2 >> 8) & 0xffu};
    const int lane = r * 8 + 4 * h;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      put(lane + i, V::kStage == Stage::kSumF32 ? f32(red[i]) : red[i]);
    }
    if (r < 4) {
      const uint32_t green[4] = {(w0 >> 8) & 0xffu, w1 & 0xffu, w1 >> 24,
                                 (w2 >> 16) & 0xffu};
      const uint32_t blue[4] = {(w0 >> 16) & 0xffu, (w1 >> 8) & 0xffu,
                                w2 & 0xffu, w2 >> 24};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (V::kStage == Stage::kSumF32) {
          put(64 + lane + i, static_cast<uint32_t>(__float2int_rz(
                                 __fadd_rn(__uint2float_rn(green[i]),
                                           __uint2float_rn(blue[i])))));
          put(96 + lane + i, f32(blue[i]));
        } else {
          put(64 + lane + i, green[i]);
          put(96 + lane + i, blue[i]);
        }
      }
    }
  }
}

// One (16 tiles × 8 lanes) output block: ksteps k16-steps over the operand
// rows of m-tile mt, one pass (hi) or three (lo, mid, hi), into q: row-major
// (tile, lane) for block-major output, (lane, tile) otherwise.
template <class V, int KSteps, int Stride>
__device__ __forceinline__ void product(const uint16_t* op, int mt,
                                        const uint32_t (&bf)[V::kParts][KSteps][2],
                                        int16_t* q, int col) {
  const int lane = threadIdx.x & 31;
  uint32_t a[KSteps][4];
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    ldmatrix_x4(a[ks], op + (16 * mt + (lane & 15)) * Stride + 16 * ks +
                           (lane >> 4) * 8);
  }
  // Two mma chains: lo then mid into one accumulator, hi into the other.
  float small[4] = {}, large[4] = {};
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    if constexpr (V::kParts == 3) {
      mma_bf16(small, a[ks], bf[2][ks][0], bf[2][ks][1]);
    }
    mma_bf16(large, a[ks], bf[0][ks][0], bf[0][ks][1]);
  }
  if constexpr (V::kParts == 3) {
#pragma unroll
    for (int ks = 0; ks < KSteps; ++ks) {
      mma_bf16(small, a[ks], bf[1][ks][0], bf[1][ks][1]);
    }
  }
  const int row = 16 * mt + (lane >> 2);
  const int c = col + 2 * (lane & 3);
  const auto sum = [&](int i) {
    return V::kParts == 3 ? __fadd_rn(small[i], large[i]) : large[i];
  };
  if constexpr (V::kBlockMajor) {
    const auto pack = [](float first, float second) {
      return (static_cast<uint32_t>(to_int<V::kCentred>(first)) & 0xffffu) |
             (static_cast<uint32_t>(to_int<V::kCentred>(second)) << 16);
    };
    *reinterpret_cast<uint32_t*>(&q[row * kQStride + c]) = pack(sum(0), sum(1));
    *reinterpret_cast<uint32_t*>(&q[(row + 8) * kQStride + c]) =
        pack(sum(2), sum(3));
  } else {
    int16_t* p = q + c * V::kLaneStride + row;
    p[0] = static_cast<int16_t>(to_int<V::kCentred>(sum(0)));
    p[V::kLaneStride] = static_cast<int16_t>(to_int<V::kCentred>(sum(1)));
    p[8] = static_cast<int16_t>(to_int<V::kCentred>(sum(2)));
    p[V::kLaneStride + 8] = static_cast<int16_t>(to_int<V::kCentred>(sum(3)));
  }
}

// The sparse deltas of the 8 staged lanes at qr, segment-local (the lane
// before the first is one 2-byte shared read, none at a segment's start),
// plus kBias where a run starts and 0 elsewhere; they wrap modulo 2^16 like
// the reference's int16 cast.
__device__ __forceinline__ uint4 sparse_deltas(const int16_t* qr,
                                               bool seg_first) {
  const uint4 v = *reinterpret_cast<const uint4*>(qr);
  const uint32_t word[4] = {v.x, v.y, v.z, v.w};
  uint32_t prev = seg_first ? 0u : static_cast<uint16_t>(qr[-1]);
  uint32_t d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t x0 = word[e] & 0xffffu, x1 = word[e] >> 16;
    const uint32_t d0 = (e == 0 && seg_first) || x0 != prev ? x0 - prev + kBias : 0u;
    const uint32_t d1 = x1 != x0 ? x1 - x0 + kBias : 0u;
    d[e] = __byte_perm(d0, d1, 0x5410);
    prev = x1;
  }
  return make_uint4(d[0], d[1], d[2], d[3]);
}

// Block-major store: thread i takes lanes 8c..8c+7 (c = i % (lanes/8)) of
// staged rows i/(lanes/8), + kThreads/(lanes/8), ... and writes each as one
// 16-byte store: each output row goes out coalesced.  The sparse stage
// forms the segment-local deltas first (segments start at lanes 0, 64 and
// 96).
template <class V>
__device__ __forceinline__ void store_rows(const Smem<V>& sm, const Band& b,
                                           int16_t* __restrict__ out) {
  constexpr int kPerRow = V::kLanes / 8;  // threads per output row
  constexpr int kRowsPerPass = kThreads / kPerRow;
  const int c = threadIdx.x & (kPerRow - 1);
  const bool seg_first =
      V::kChannels == 3 ? c == 0 || c == 8 || c == 12 : c == 0;
  uint4* dst = reinterpret_cast<uint4*>(out + b.out_row * V::kLanes) +
               (threadIdx.x / kPerRow) * kPerRow + c;
  const int16_t* src = sm.q + (threadIdx.x / kPerRow) * kQStride + 8 * c;
  const int rows = b.tiles - (threadIdx.x / kPerRow);
#pragma unroll
  for (int j = 0; j < V::kTiles * kPerRow / kThreads; ++j) {
    if (j * kRowsPerPass >= rows) break;
    const int16_t* qr = src + j * kRowsPerPass * kQStride;
    if constexpr (V::kStage == Stage::kSparse) {
      __stcs(dst + j * kRowsPerPass * kPerRow, sparse_deltas(qr, seg_first));
    } else {
      __stcs(dst + j * kRowsPerPass * kPerRow,
             *reinterpret_cast<const uint4*>(qr));
    }
  }
}

// Coefficient-major store: thread i takes 16-byte chunks of lane rows of the
// staging, so that each lane's T outputs of the band go out as one
// contiguous run of the (lanes, N) output.  Sparse deltas run along the
// lanes: an output minus the same tile's output in the lane before.  A band
// that is short or a run that is not 16-byte aligned goes out element by
// element.
template <class V>
__device__ __forceinline__ void store_lanes(const Smem<V>& sm, const Band& b,
                                            typename V::Out* __restrict__ out,
                                            int64_t n_blocks) {
  using Out = typename V::Out;
  constexpr int kPer = 16 / static_cast<int>(sizeof(Out));  // per chunk
  constexpr int kChunks = V::kTiles / kPer;                  // per lane row
  constexpr int kTotal = V::kLanes * kChunks;
  const Out* q = reinterpret_cast<const Out*>(sm.q);
  const bool whole = b.tiles == V::kTiles && n_blocks % kPer == 0 &&
                     b.out_row % kPer == 0;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (kTotal % kThreads != 0 && i >= kTotal) break;
    const int lane = i / kChunks;
    const int k = i - lane * kChunks;
    const Out* src = q + lane * V::kLaneStride + k * kPer;
    Out* dst = out + lane * n_blocks + b.out_row + k * kPer;
    uint4 v = *reinterpret_cast<const uint4*>(src);
    if constexpr (V::kStage == Stage::kSparse) {
      const bool seg_first = lane == 0 || lane == 64 || lane == 96;
      const uint4 p = seg_first ? make_uint4(0u, 0u, 0u, 0u)
                                : *reinterpret_cast<const uint4*>(
                                      src - V::kLaneStride);
      const uint32_t x[4] = {v.x, v.y, v.z, v.w}, y[4] = {p.x, p.y, p.z, p.w};
      uint32_t d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t x0 = x[e] & 0xffffu, x1 = x[e] >> 16;
        const uint32_t p0 = y[e] & 0xffffu, p1 = y[e] >> 16;
        const uint32_t d0 = seg_first || x0 != p0 ? x0 - p0 + kBias : 0u;
        const uint32_t d1 = seg_first || x1 != p1 ? x1 - p1 + kBias : 0u;
        d[e] = __byte_perm(d0, d1, 0x5410);
      }
      v = make_uint4(d[0], d[1], d[2], d[3]);
    }
    if (whole) {
      __stcs(reinterpret_cast<uint4*>(dst), v);
    } else {
      constexpr int kPerWord = 4 / static_cast<int>(sizeof(Out));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int n = 0; n < kPer; ++n) {
        if (k * kPer + n < b.tiles) {
          dst[n] = static_cast<Out>(w[n / kPerWord] >>
                                    (8 * sizeof(Out) * (n % kPerWord)));
        }
      }
    }
  }
}

// ---- The KT input (the layout variants) ---------------------------------
//
// A KT band is T consecutive blocks n0..n0+T-1 of the (3, 64, N) u8 array:
// 192 row pieces (channel c, position p = 8r + col) of T bytes each, at
// stride N.  Piece ρ = 64c + p is T/16 chunks of 16 bytes; chunk j of piece
// ρ lands in the ring buffer at chunk index g ^ (ρ & 7), g = ρ·(T/16) + j.
// The XOR keeps each aligned group of 8 chunks (one 128-byte row of the 32
// banks) and is a bijection; it lets 8 lanes that read the same chunk j of
// 8 pieces whose positions differ mod 8 hit 8 different 16-byte bank
// groups.

template <class V>
__device__ __forceinline__ int kt_chunk_offset(int piece, int j) {
  return ((piece * (V::kTiles / 16) + j) ^ (piece & 7)) * 16;
}

// The 32-bit word w (tiles 16j + 4w .. + 3) of chunk j of piece `piece`.
template <class V>
__device__ __forceinline__ uint32_t kt_word(const uint8_t* buf, int piece,
                                            int j, int w) {
  return *reinterpret_cast<const uint32_t*>(buf + kt_chunk_offset<V>(piece, j) +
                                            4 * w);
}

// Start the 16-byte copies of one KT band: T/16 chunks of each piece the
// variant reads, thread i copying chunks i, i + kThreads, ...  A product
// reads all 192 pieces; the i16 cast only R[0:64], G[0:32] and B[0:32]
// (pieces 0-95 and 128-159: its 128·T bytes).  A short last band (tiles <
// T, a multiple of 16 since N % 16 == 0) copies its whole chunks only; the
// rest of the buffer keeps stale bytes, whose outputs are never stored.
template <class V>
__device__ __forceinline__ void load_kt(uint8_t* buf, const uint8_t* src,
                                        int64_t n_blocks, int tiles) {
  constexpr int kPer = V::kTiles / 16;
  constexpr int kTotal = (V::kProduct ? 192 : 128) * kPer;
  const int chunks = tiles / 16;
#pragma unroll
  for (int j = 0; j < (kTotal + kThreads - 1) / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int k = i / kPer;
    const int c = i - k * kPer;
    const int piece = V::kProduct || k < 96 ? k : k + 32;
    if ((kTotal % kThreads == 0 || i < kTotal) && c < chunks) {
      cp_async16(buf + kt_chunk_offset<V>(piece, c),
                 src + piece * n_blocks + c * 16);
    }
  }
}

// A thread's share of a KT band: units of (8 position pairs × 4 tile quads
// of one chunk j), lane = 8·w + qq holding pair q = 8·(group) + qq (the
// positions 2q and 2q + 1) and tiles 16j + 4w .. + 3.  Lanes 4-7 of each 8
// read the odd position first, so each read instruction's 8 pieces differ
// mod 8 (conflict-free under the swizzle).  Lanes w = 2, 3 walk their four
// tiles in the order 2, 3, 0, 1, which spreads each staging write of the
// warp over the 32 banks (tile stride 144 or 272 bytes is 16 banks).
struct KtLane {
  int qq, w, h, rot;
  __device__ __forceinline__ KtLane() {
    const int lane = threadIdx.x & 31;
    qq = lane & 7;
    w = lane >> 3;
    h = (qq >> 2) & 1;
    rot = w & 2;
  }
  // The words of positions 2q and 2q + 1 of channel c, tiles of chunk j.
  template <class V>
  __device__ __forceinline__ void read(const uint8_t* buf, int c, int q, int j,
                                       uint32_t& even, uint32_t& odd) const {
    const uint32_t a = kt_word<V>(buf, 64 * c + 2 * q + h, j, w);
    const uint32_t b = kt_word<V>(buf, 64 * c + 2 * q + 1 - h, j, w);
    even = h ? b : a;
    odd = h ? a : b;
  }
};

// Byte s of the R, G and B words as one pixel word whose bytes 0-2 are R, G,
// B (byte 3 is R again: every colour coefficient word is 0 there), the
// input of colour<0>.
__device__ __forceinline__ uint32_t kt_pixel(uint32_t r, uint32_t g, uint32_t b,
                                             int s) {
  const uint32_t rg = __byte_perm(r, g, s | ((s + 4) << 4));
  return __byte_perm(rg, b, 0x0010 | ((s + 4) << 8));
}

// Colour of a KT band → the bf16 operands of K1 in shared memory (luma T ×
// 64, Cr and Cb T × 32, tile-major), the same values convert_band writes
// for the same blocks: chroma is computed for the odd columns, position
// 8r + 2c' + 1 → chroma sample 4r + c' = q.
template <class V>
__device__ __forceinline__ void convert_kt(Smem<V>& sm, const uint8_t* buf) {
  const KtLane ln;
#pragma unroll
  for (int m = 0; m < V::kTiles / 32; ++m) {
    const int u = (threadIdx.x >> 5) + 8 * m;
    const int q = 8 * (u & 3) + ln.qq;
    const int j = u >> 2;
    uint32_t e[3], o[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) ln.read<V>(buf, c, q, j, e[c], o[c]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = i ^ ln.rot;
      const int t = 16 * j + 4 * ln.w + s;
      const uint32_t pe = kt_pixel(e[0], e[1], e[2], s);
      const uint32_t po = kt_pixel(o[0], o[1], o[2], s);
      *reinterpret_cast<uint32_t*>(&sm.lum[t * kLumStride + 2 * q]) =
          bf16_pair<true>(colour<0>(pe, kYHi, kYLo, 0),
                          colour<0>(po, kYHi, kYLo, 0));
      sm.chr[0][t * kChrStride + q] = static_cast<uint16_t>(
          sample<true>(colour<0>(po, kCrHi, kCrLo, 128000)) >> 16);
      sm.chr[1][t * kChrStride + q] = static_cast<uint16_t>(
          sample<true>(colour<0>(po, kCbHi, kCbLo, 128000)) >> 16);
    }
  }
}

// The i16 cast of a KT band, block-major: lanes 0-63, 64-95 and 96-127 of
// tile t's staged row are R[0:64], G[0:32] and B[0:32] of block t (v2's
// "copy" mode).  Pairs q = 0..63 of output lanes; 8 pairs of one channel per
// lane group.
template <class V>
__device__ __forceinline__ void convert_kt_bare(Smem<V>& sm,
                                                const uint8_t* buf) {
  const KtLane ln;
#pragma unroll
  for (int m = 0; m < V::kTiles / 16; ++m) {
    const int u = (threadIdx.x >> 5) + 8 * m;
    const int q = 8 * (u & 7) + ln.qq;
    const int j = u >> 3;
    const int c = q < 32 ? 0 : (q < 48 ? 1 : 2);
    uint32_t e, o;
    ln.read<V>(buf, c, q - (c == 0 ? 0 : 16 + 16 * c), j, e, o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = i ^ ln.rot;
      const int t = 16 * j + 4 * ln.w + s;
      *reinterpret_cast<uint32_t*>(&sm.q[t * kQStride + 2 * q]) =
          __byte_perm(e, o, s | ((s + 4) << 8)) & 0x00ff00ffu;
    }
  }
}

// The basis as the mma's A operand (m = 16 coefficient lanes, k = positions)
// in registers, the samples as B (n = 8 tiles) by ldmatrix from the
// tile-major operands: the product comes out (lane, tile), as the TPU
// production kernel's basis × samples, and is written transposed into the
// (tile, lane) staging.  Warp w < 4 holds luma m-tile w (lanes 16w..+15,
// depth 64), warp w ≥ 4 chroma m-tile w & 1 of channel (w >> 1) & 1 (depth
// 32, Cr and Cb share the basis): 48 registers of fragments at most, where
// an even split of the 72 mma per 8 tiles would need 72.  The luma warps
// carry 12 mma per 8 tiles, the chroma warps 6.
template <class V>
__device__ __forceinline__ void load_basis_a(const uint16_t* parts, int warp,
                                             int lane, uint32_t (&af)[3][4][4]) {
  const bool luma = warp < 4;
  const int width = luma ? 64 : 32;
  const int row = (luma ? 16 * warp : 16 * (warp & 1)) + (lane >> 2);
  const int k = 2 * (lane & 3);
  const uint16_t* base = luma ? parts : parts + 3 * kLumPart;
  const int part = luma ? kLumPart : kChrPart;
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < 2 || luma) {
        const uint16_t* a = base + p * part + row * width + 16 * ks + k;
        af[p][ks][0] = *reinterpret_cast<const uint32_t*>(a);
        af[p][ks][1] = *reinterpret_cast<const uint32_t*>(a + 8 * width);
        af[p][ks][2] = *reinterpret_cast<const uint32_t*>(a + 8);
        af[p][ks][3] = *reinterpret_cast<const uint32_t*>(a + 8 * width + 8);
      }
    }
  }
}

// One (16 lanes × 8 tiles) block of the basis-A product: tiles 8nt..8nt+7,
// lanes col + 0..15 of the staging, the three parts summed as in product().
template <int KSteps, int Stride>
__device__ __forceinline__ void product_basis_a(const uint16_t* op, int nt,
                                                const uint32_t (&af)[3][4][4],
                                                int16_t* q, int col) {
  const int lane = threadIdx.x & 31;
  uint32_t b[KSteps][2];
#pragma unroll
  for (int ks = 0; ks < KSteps; ks += 2) {
    uint32_t r[4];
    ldmatrix_x4(r, op + (8 * nt + (lane & 7)) * Stride + 16 * ks +
                       8 * (lane >> 3));
    b[ks][0] = r[0];
    b[ks][1] = r[1];
    b[ks + 1][0] = r[2];
    b[ks + 1][1] = r[3];
  }
  float small[4] = {}, large[4] = {};
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    mma_bf16(small, af[2][ks], b[ks][0], b[ks][1]);
    mma_bf16(large, af[0][ks], b[ks][0], b[ks][1]);
  }
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    mma_bf16(small, af[1][ks], b[ks][0], b[ks][1]);
  }
  const int m = col + (lane >> 2);      // staging lane of d[0], d[1]
  const int t = 8 * nt + 2 * (lane & 3);  // tile of d[0], d[2]
  const auto put = [&](int tile, int l, int i) {
    q[tile * kQStride + l] =
        static_cast<int16_t>(snap_trunc_int(__fadd_rn(small[i], large[i])));
  };
  put(t, m, 0);
  put(t + 1, m, 1);
  put(t, m + 8, 2);
  put(t + 1, m + 8, 3);
}

// The outputs of a KT variant: p[0] the (N, lanes) rows; for the split
// stage p[0..2] the (N, 64), (N, 32) and (N, 32) int16 luma, Cr and Cb
// segments and p[3..5] their (N,) int32 run counts.
struct KtOut {
  void* p[6];
};

// The split store: the block-major store's threads and sparse deltas, each
// 16-byte piece going to the segment's own output; then the number of
// nonzero words of each segment (every run's first word is nonzero: slot 0
// carries kBias, a later start a nonzero delta), summed over the segment's
// 8 or 4 threads by shuffles, written by its first thread.
template <class V>
__device__ __forceinline__ void store_split(const Smem<V>& sm, const Band& b,
                                            const KtOut& out) {
  constexpr int kPerRow = 16;
  constexpr int kRowsPerPass = kThreads / kPerRow;
  const int c = threadIdx.x & (kPerRow - 1);
  const int seg = c < 8 ? 0 : (c < 12 ? 1 : 2);
  const int first = seg == 0 ? 0 : 4 + 4 * seg;
  const int width = seg == 0 ? 64 : 32;
  const int r0 = threadIdx.x / kPerRow;
  // Pointers by selects: an index into out.p would put it in local memory.
  void* const seg_out = seg == 0 ? out.p[0] : (seg == 1 ? out.p[1] : out.p[2]);
  void* const seg_runs = seg == 0 ? out.p[3] : (seg == 1 ? out.p[4] : out.p[5]);
  int16_t* dst = static_cast<int16_t*>(seg_out) + (b.out_row + r0) * width +
                 8 * (c - first);
  int32_t* runs = static_cast<int32_t*>(seg_runs) + b.out_row + r0;
  const int16_t* src = sm.q + r0 * kQStride + 8 * c;
#pragma unroll
  for (int j = 0; j < V::kTiles / kRowsPerPass; ++j) {
    const uint4 d = sparse_deltas(src + j * kRowsPerPass * kQStride, c == first);
    int n = __popc(__vcmpne2(d.x, 0u)) + __popc(__vcmpne2(d.y, 0u)) +
            __popc(__vcmpne2(d.z, 0u)) + __popc(__vcmpne2(d.w, 0u));
    n += __shfl_xor_sync(0xffffffffu, n, 1);
    n += __shfl_xor_sync(0xffffffffu, n, 2);
    const int other = __shfl_xor_sync(0xffffffffu, n, 4);
    if (seg == 0) n += other;
    if (r0 + j * kRowsPerPass < b.tiles) {
      __stcs(reinterpret_cast<uint4*>(dst + j * kRowsPerPass * width), d);
      if (c == first) runs[j * kRowsPerPass] = n >> 4;
    }
  }
}

// Basis fragments as B operands ("col" layout: lane holds rows n = lane/4,
// depth pairs 2·(lane%4) and +8), loaded once per CTA.  Luma columns
// 8w..8w+7; chroma columns 8(w%4).. of channel w/4 (Cr and Cb share the
// basis).
template <class V>
__device__ __forceinline__ void load_basis_b(const uint16_t* parts, int warp,
                                             int lane,
                                             uint32_t (&bl)[V::kParts][4][2],
                                             uint32_t (&bc)[V::kParts][2][2]) {
  const int n = lane >> 2, k = 2 * (lane & 3);
  const uint32_t* lum = reinterpret_cast<const uint32_t*>(parts);
  const uint32_t* chr = reinterpret_cast<const uint32_t*>(parts + 3 * kLumPart);
#pragma unroll
  for (int p = 0; p < V::kParts; ++p) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int base = p * kLumPart + (8 * warp + n) * 64 + 16 * ks + k;
      bl[p][ks][0] = lum[base / 2];
      bl[p][ks][1] = lum[(base + 8) / 2];
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int base = p * kChrPart + (8 * (warp & 3) + n) * 32 + 16 * ks + k;
      bc[p][ks][0] = chr[base / 2];
      bc[p][ks][1] = chr[(base + 8) / 2];
    }
  }
}

// The geometry of KT band `band`: blocks n0 = band·T .. of the slab.
template <class V>
__device__ __forceinline__ Band kt_band_at(const uint8_t* kt, uint32_t band,
                                           int64_t n_blocks) {
  Band b;
  b.out_row = static_cast<int64_t>(band) * V::kTiles;
  b.src = kt + b.out_row;
  b.rows = 8;
  b.cols = 0;
  b.tiles = static_cast<int>(min(static_cast<int64_t>(V::kTiles),
                                 n_blocks - b.out_row));
  return b;
}

// Where a variant's bands come from, as the band loop asks for them: a
// band's geometry, its cp.async copies into a ring buffer, and its convert
// steps (colour into the bf16 operands, or the bare copy into the staging).
// Image bands of (B, H, W, 3) RGB (K1):
template <class V>
struct RgbBands {
  const uint8_t* rgb;
  int height, width, bpc, bpr, bands_per_row, row_bytes;
  __device__ __forceinline__ Band at(uint32_t band) const {
    return band_at<V>(rgb, band, height, width, bpc, bpr, bands_per_row);
  }
  __device__ __forceinline__ void load(uint8_t* buf, const Band& b) const {
    load_band<V>(buf, b, row_bytes);
  }
  __device__ __forceinline__ void convert(Smem<V>& sm, const uint8_t* buf,
                                          const Band& b, bool staged) const {
    convert_band<V>(sm, buf, b, row_bytes, staged);
  }
  __device__ __forceinline__ void bare(Smem<V>& sm, const uint8_t* buf) const {
    convert_bare<V>(sm, buf);
  }
};

// KT slabs of T blocks of the (3, 64, N) layout (always staged).
template <class V>
struct KtBands {
  const uint8_t* kt;
  int64_t n_blocks;
  __device__ __forceinline__ Band at(uint32_t band) const {
    return kt_band_at<V>(kt, band, n_blocks);
  }
  __device__ __forceinline__ void load(uint8_t* buf, const Band& b) const {
    load_kt<V>(buf, b.src, n_blocks, b.tiles);
  }
  __device__ __forceinline__ void convert(Smem<V>& sm, const uint8_t* buf,
                                          const Band&, bool) const {
    convert_kt<V>(sm, buf);
  }
  __device__ __forceinline__ void bare(Smem<V>& sm, const uint8_t* buf) const {
    convert_kt_bare<V>(sm, buf);
  }
};

// The body of every variant.  Persistent CTAs walk over bands of T tiles
// (src.at); bands are loaded two ahead into a ring of kStages buffers by
// cp.async (staged) or read straight from device memory (RGB bands only).
// Each band: convert → product, or the bare copy → store.  `out` is the
// variant's output pointer, or KtOut for a KT variant; n_blocks is the lane
// stride of coefficient-major output.
template <class V, class Bands, class Out>
__device__ __forceinline__ void band_loop(const Bands& src, Out out,
                                          const uint16_t* __restrict__ parts,
                                          uint32_t n_bands, bool staged,
                                          int64_t n_blocks) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem<V>& sm = *reinterpret_cast<Smem<V>*>(smem_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  constexpr int kBParts = V::kBasisA ? 1 : V::kParts;
  uint32_t bl[kBParts][4][2], bc[kBParts][2][2], af[V::kBasisA ? 3 : 1][4][4];
  if constexpr (V::kProduct && V::kBasisA) {
    load_basis_a<V>(parts, warp, lane, af);
  } else if constexpr (V::kProduct) {
    load_basis_b<V>(parts, warp, lane, bl, bc);
  }
  const int ch = warp >> 2;
  const int lum_col = 8 * warp;
  const int chr_col = 64 + 32 * ch + 8 * (warp & 3);

  const uint32_t step = gridDim.x;
  if (staged) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      const uint32_t nb = blockIdx.x + s * step;
      if (nb < n_bands) src.load(sm.raw[s], src.at(nb));
      cp_async_commit();
    }
  }
  int slot = 0;
  for (uint32_t band = blockIdx.x; band < n_bands; band += step) {
    const Band b = src.at(band);
    if (staged) {
      const uint32_t nb = band + (kStages - 1) * step;
      if (nb < n_bands) {
        src.load(sm.raw[(slot + kStages - 1) % kStages], src.at(nb));
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();  // this band's bytes landed; the last store pass is done
    if constexpr (V::kProduct) {
      src.convert(sm, sm.raw[slot], b, staged);
      __syncthreads();
      if constexpr (V::kBasisA) {
        if (warp < 4) {
#pragma unroll 1
          for (int nt = 0; nt < V::kTiles / 8; ++nt) {
            product_basis_a<4, kLumStride>(sm.lum, nt, af, sm.q, 16 * warp);
          }
        } else {
#pragma unroll 1
          for (int nt = 0; nt < V::kTiles / 8; ++nt) {
            product_basis_a<2, kChrStride>(sm.chr[(warp >> 1) & 1], nt, af,
                                           sm.q, 64 + 16 * (warp & 3));
          }
        }
      } else {
#pragma unroll 1
        for (int mt = 0; mt < V::kTiles / 16; ++mt) {
          product<V, 4, kLumStride>(sm.lum, mt, bl, sm.q, lum_col);
          if constexpr (V::kChannels == 3) {
            product<V, 2, kChrStride>(sm.chr[ch], mt, bc, sm.q, chr_col);
          }
        }
      }
    } else {
      src.bare(sm, sm.raw[slot]);
    }
    __syncthreads();
    if constexpr (V::kStage == Stage::kSplit) {
      store_split<V>(sm, b, out);
    } else if constexpr (V::kInput == Input::kKt) {
      store_rows<V>(sm, b, static_cast<int16_t*>(out.p[0]));
    } else if constexpr (V::kBlockMajor) {
      store_rows<V>(sm, b, out);
    } else {
      store_lanes<V>(sm, b, out, n_blocks);
    }
    slot = (slot + 1) % kStages;
  }
  if (staged) cp_async_wait<0>();
}

// The kernel of the RGB variants (K1 among them): band_loop over image
// bands.
template <class V>
__global__ void __launch_bounds__(kThreads, V::kMinCtas)
    fwd_megakernel(const uint8_t* __restrict__ rgb,
                   typename V::Out* __restrict__ out,
                   const uint16_t* __restrict__ parts, uint32_t n_bands,
                   int height, int width, int bpc, int bpr, bool staged) {
  const int bands_per_row = (bpr + V::kTiles - 1) / V::kTiles;
  int64_t n_blocks = 0;  // N: the lane stride of coefficient-major output
  if constexpr (!V::kBlockMajor) {
    n_blocks = static_cast<int64_t>(n_bands / bands_per_row) * bpr;
  }
  const RgbBands<V> src{rgb, height, width, bpc, bpr, bands_per_row, width * 3};
  band_loop<V>(src, out, parts, n_bands, staged, n_blocks);
}

// The kernel of the KT variants: band_loop over KT slabs, always staged
// (the launcher checks the cp.async route's alignment).
template <class V>
__global__ void __launch_bounds__(kThreads, V::kMinCtas)
    fwd_megakernel_kt(const uint8_t* __restrict__ kt, KtOut out,
                      const uint16_t* __restrict__ parts, uint32_t n_bands,
                      int64_t n_blocks) {
  band_loop<V>(KtBands<V>{kt, n_blocks}, out, parts, n_bands, true, n_blocks);
}

// The persistent grid of `kernel` with `smem` bytes of dynamic shared
// memory: the resident CTAs of every SM, at most n_bands.  Returns the
// first failed attribute call or query.
template <class K>
cudaError_t persistent_grid(K kernel, int smem, int64_t n_bands,
                            unsigned* grid) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  int64_t g = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(g < n_bands ? g : n_bands);
  return cudaSuccess;
}

// Launch variant V on `stream` (the contract of fwd_megakernel_launch in
// csrc/fwd_megakernel.cu): returns cudaGetLastError() or the first failed
// query, never synchronises.
template <class V>
int launch_variant(const void* rgb, void* out, const void* parts, int batch,
                   int height, int width, int bpc, int bpr, int staged,
                   void* stream) {
  const int64_t n_bands = static_cast<int64_t>(batch) * bpc *
                          ((bpr + V::kTiles - 1) / V::kTiles);
  if (n_bands <= 0) return cudaSuccess;
  // 32-bit band geometry: band + grid, image rows and W·3 below 2^31.
  if (n_bands > (1ll << 30) || static_cast<int64_t>(batch) * height >= (1ll << 31) ||
      static_cast<int64_t>(width) * 24 >= (1ll << 31)) {
    return cudaErrorInvalidValue;
  }
  if (staged && (reinterpret_cast<uintptr_t>(rgb) % 16 != 0 ||
                 (static_cast<int64_t>(width) * 3) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  const int smem = static_cast<int>(sizeof(Smem<V>));
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(fwd_megakernel<V>, smem, n_bands, &grid);
  if (err != cudaSuccess) return err;
  fwd_megakernel<V><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<typename V::Out*>(out),
      static_cast<const uint16_t*>(parts), static_cast<uint32_t>(n_bands),
      height, width, bpc, bpr,
      staged != 0);
  return cudaGetLastError();
}

// Launch KT variant V on `stream`: kt is (3, 64, n_blocks) uint8,
// contiguous; the cp.async route needs n_blocks % 16 == 0 and a 16-byte
// aligned kt, else cudaErrorInvalidValue.  Returns cudaGetLastError() or
// the first failed query, never synchronises.
template <class V>
int launch_kt(const void* kt, const KtOut& out, const void* parts,
              int64_t n_blocks, void* stream) {
  if (n_blocks <= 0) return cudaSuccess;
  if (n_blocks % 16 != 0 || reinterpret_cast<uintptr_t>(kt) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int64_t n_bands = (n_blocks + V::kTiles - 1) / V::kTiles;
  if (n_bands > (1ll << 30)) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(sizeof(Smem<V>));
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(fwd_megakernel_kt<V>, smem, n_bands, &grid);
  if (err != cudaSuccess) return err;
  fwd_megakernel_kt<V><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(kt), out,
      static_cast<const uint16_t*>(parts), static_cast<uint32_t>(n_bands),
      n_blocks);
  return cudaGetLastError();
}

}  // namespace
