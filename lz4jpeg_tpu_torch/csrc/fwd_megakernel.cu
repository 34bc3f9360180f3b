// Forward megakernel for Hopper (sm_90a): RGB uint8 image → the (N, 128)
// int16 combined sparse-delta streams of the JPEG fast path, in one pass.
//
// Replaces lz4jpeg_tpu/ops/pallas_fwd.py::_fwd_kernel, the Pallas TPU kernel
// (fed by rgb_to_kt).  Per 8x8 MCU it computes what that kernel computes:
//   1. YCbCr with the reference's truncation (snap-trunc, eps 1e-4; Cr and Cb
//      +128 then clamped to [0, 255]);
//   2. DCT + quantize + zigzag as one f32 basis product per channel: lane k
//      of the 128 output lanes is my[k]·Y (k < 64), mc[k-64]·Cr (64 ≤ k <
//      96) or mc[k-96]·Cb (k ≥ 96), minus offs[k], snap-trunc eps 1e-5.  The
//      chroma operand is the 4:2:2 odd-column pick of the tile (sample (r,
//      c') is tile column 2c'+1), so its product has depth 32;
//   3. the sparse-delta epilogue (ops/rle.py::rle_encode_sparse16) with
//      segments starting at lanes 0, 64 and 96.
// Ragged images: a pixel with row >= H or col >= W is Y = Cr = Cb = 0 AFTER
// the color transform (split_mcus's plane-domain padding).  Rows come out in
// (frames, block rows, block columns) order, as in the JAX package.
//
// What bounds it.  Per pixel it reads 3 B and writes 4 B (128 int16 lanes
// per 64 pixels): 1.88 GB at 2048² b64, 0.561 ms at 3.35 TB/s, the bound.
// The product is 64·64 + 2·32·32 = 6,144 multiply-adds per tile, three
// bf16 passes on the tensor cores: 0.156 ms at the 989 TFLOP/s of wgmma.
// On the way to the bound the kernel is held by instruction issue (colour,
// snap-trunc and delta code per pixel and per lane) and by the phases of a
// band running one after another inside a CTA; a copy without the mma.sync
// instructions runs barely faster, so the tensor cores are not the limit.
//
// Design.
// - Persistent CTAs of 256 threads (8 warps; 80 registers, 72 KB of shared
//   memory, three CTAs per SM) walk over bands of kTiles = 64 tiles of one
//   block row: 8 image rows × 1,536 bytes.  Indices are 32-bit per band and
//   per tile; one 64-bit base per band.  Three CTA barriers per band.
// - Band loads: 16-byte cp.async into a ring of kStages = 3 band buffers,
//   two bands ahead.  The wrapper picks this route when the image pointer and
//   the row stride W·3 are 16-byte aligned (W % 16 == 0, as at 2048²);
//   otherwise the same kernel reads the pixels straight from device memory
//   (the direct route: ragged widths, unaligned views).
// - Colour on CUDA cores in exact integer arithmetic (byte dot products,
//   dp4a; see luma() below), four pixels per thread from three 32-bit words,
//   chroma for the odd columns only.  The operands are the CENTRED samples
//   v - 128, written to shared memory as bf16 (exact: integers -128..127):
//   luma (T × 64), Cr and Cb (T × 32) each.  Σ (v-128)·m = Σ v·m - offs
//   exactly, so the epilogue subtracts nothing and the f32 sums stay small
//   (no cancellation against the ~10² offs).
// - Product on tensor cores: mma.sync.m16n8k16 bf16 → f32.  The f32 basis is
//   split on the host (ops/fwd_megakernel.py::split_basis) into three bf16
//   parts hi + mid + lo whose sum is exactly the f32 basis; each product
//   sample × part is exact in f32; lo and mid accumulate in one f32 chain, hi
//   in another, and the two are added once.  No TF32.  Warp w owns output
//   columns 8w..8w+7 of luma and 8(w%4).. of Cr (w < 4) or Cb, so its 36
//   basis fragment registers are loaded once per CTA.
// - Epilogue: snap-trunc with full-rate float adds (snap_trunc_int), int16
//   into a padded shared row per tile; then each thread takes 8 lanes of a
//   row, forms the segment-local deltas (the lane before its first is one
//   2-byte shared read), adds kBias and writes one 16-byte streaming store:
//   each 256 B output row goes out coalesced.
// The sum order differs from cuBLAS's, so a coefficient whose ratio lies
// within rounding noise of an integer may truncate one step apart
// (utils/parity.py::sum_order_flips).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTiles = 64;                 // T: tiles per band
constexpr int kStages = 3;                 // band buffers in the ring
constexpr int kRowBytes = kTiles * 24;     // one image row of a band
constexpr int kRowChunks = kRowBytes / 16;
constexpr int kBandBytes = 8 * kRowBytes;
constexpr int kLumStride = 64 + 8;         // bf16 per operand row (+16 B:
constexpr int kChrStride = 32 + 8;         //  conflict-free ldmatrix)
constexpr int kQStride = 128 + 8;          // int16 per staged output row
constexpr int kLanes = 128;
constexpr int kBias = 1024;                // SPARSE16_DELTA_BIAS
constexpr int kLumPart = 64 * 64;          // bf16 values of one luma part
constexpr int kChrPart = 32 * 32;

struct Smem {
  uint8_t raw[kStages][kBandBytes];
  uint16_t lum[kTiles * kLumStride];
  uint16_t chr[2][kTiles * kChrStride];
  int16_t q[kTiles * kQStride];
};

struct Band {
  const uint8_t* src;   // first byte of the band's first image row
  int64_t out_row;      // output row of its first tile
  int rows;             // image rows inside the frame (1..8)
  int cols;             // pixel columns inside the frame (may be ≤ 0 past W)
  int tiles;            // tiles inside the block row (1..kTiles)
};

// Band geometry in 32-bit arithmetic (the launcher checks that every band,
// block row and image row index fits in 31 bits); 64-bit only for the
// pointer and output row.
__device__ __forceinline__ Band band_at(const uint8_t* rgb, uint32_t band,
                                        int height, int width, int bpc,
                                        int bpr, int bands_per_row) {
  const uint32_t row_id = band / bands_per_row;  // frame · bpc + block row
  const int bx0 = static_cast<int>(band - row_id * bands_per_row) * kTiles;
  const uint32_t f = row_id / bpc;
  const int by = static_cast<int>(row_id - f * bpc);
  Band b;
  b.src = rgb + static_cast<int64_t>(f * height + by * 8) * (width * 3) +
          bx0 * 3 * 8;
  b.out_row = static_cast<int64_t>(row_id) * bpr + bx0;
  b.rows = min(8, height - by * 8);
  b.cols = width - bx0 * 8;
  b.tiles = min(kTiles, bpr - bx0);
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

// The float v - 128 for v in [0, 255], exact, without an int → float
// conversion: 2^23 + v is the float whose bits are 0x4B000000 | v.  Its top
// 16 bits are its bf16 value.
__device__ __forceinline__ uint32_t centred(uint32_t v) {
  return __float_as_uint(__fadd_rn(__uint_as_float(0x4B000000u | v), -8388736.f));
}

// Two centred values as a bf16 pair (first in the low half).
__device__ __forceinline__ uint32_t bf16_pair(uint32_t first, uint32_t second) {
  return __byte_perm(centred(first), centred(second), 0x7632);
}

// Issue the 16-byte copies of one band into a ring buffer (aligned route).
// Thread i copies chunks i, i + kThreads, ...: the same (row, chunk) cells
// in every band.
__device__ __forceinline__ void load_band(uint8_t* buf, const Band& b,
                                          int row_bytes) {
  const int chunks = min(kTiles * 8, b.cols) * 3 / 16;
#pragma unroll
  for (int j = 0; j < 8 * kRowChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / kRowChunks;
    const int c = i - r * kRowChunks;
    if (r < b.rows && c < chunks) {
      cp_async16(buf + r * kRowBytes + c * 16, b.src + r * row_bytes + c * 16);
    }
  }
}

// Colour of four pixels per thread → centred bf16 operands in shared memory.
// A group is (row r, tile t, half h): pixels 8t + 4h .. + 3 of image row r,
// 12 bytes R0 G0 B0 R1 | G1 B1 R2 G2 | B2 R3 G3 B3.  Thread i takes groups
// (t, h) = (i/2 % kTiles, i % 2) of rows i / (2·kTiles) + 2j, the same cells
// in every band.  Chroma is computed for the odd columns only (the 4:2:2
// pick).
static_assert(8 * 2 * kTiles == 4 * kThreads, "four groups per thread");

__device__ __forceinline__ void convert_band(Smem& sm, const uint8_t* buf,
                                             const Band& b, int row_bytes,
                                             bool staged) {
  const int gi = threadIdx.x & (2 * kTiles - 1);
  const int t = gi >> 1;
  const int h = gi & 1;
  const int pc = 8 * t + 4 * h;  // band-relative pixel column
  const int in_cols = max(0, min(4, b.cols - pc));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = threadIdx.x / (2 * kTiles) + 2 * j;
    const int valid = r < b.rows ? in_cols : 0;
    uint32_t w0, w1, w2, y0, y1, y2, y3, cr1, cr3, cb1, cb3;
    if (staged && valid == 4) {  // the aligned route: all four pixels inside
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(buf + r * kRowBytes + 12 * gi);
      w0 = src[0];
      w1 = src[1];
      w2 = src[2];
      // Pixels 0-3 as words whose bytes 0-2 (pixel 3: 1-3) are R, G, B.
      const uint32_t p1 = __byte_perm(w0, w1, 0x0543);
      const uint32_t p2 = __byte_perm(w1, w2, 0x0432);
      y0 = colour<0>(w0, kYHi, kYLo, 0);
      y1 = colour<0>(p1, kYHi, kYLo, 0);
      y2 = colour<0>(p2, kYHi, kYLo, 0);
      y3 = colour<8>(w2, kYHi, kYLo, 0);
      cr1 = colour<0>(p1, kCrHi, kCrLo, 128000);
      cr3 = colour<8>(w2, kCrHi, kCrLo, 128000);
      cb1 = colour<0>(p1, kCbHi, kCbLo, 128000);
      cb3 = colour<8>(w2, kCbHi, kCbLo, 128000);
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
      y0 = valid > 0 ? colour<0>(px[0], kYHi, kYLo, 0) : 0u;
      y1 = valid > 1 ? colour<0>(px[1], kYHi, kYLo, 0) : 0u;
      y2 = valid > 2 ? colour<0>(px[2], kYHi, kYLo, 0) : 0u;
      y3 = valid > 3 ? colour<0>(px[3], kYHi, kYLo, 0) : 0u;
      cr1 = valid > 1 ? colour<0>(px[1], kCrHi, kCrLo, 128000) : 0u;
      cr3 = valid > 3 ? colour<0>(px[3], kCrHi, kCrLo, 128000) : 0u;
      cb1 = valid > 1 ? colour<0>(px[1], kCbHi, kCbLo, 128000) : 0u;
      cb3 = valid > 3 ? colour<0>(px[3], kCbHi, kCbLo, 128000) : 0u;
    }
    *reinterpret_cast<uint2*>(&sm.lum[t * kLumStride + r * 8 + 4 * h]) =
        make_uint2(bf16_pair(y0, y1), bf16_pair(y2, y3));
    // Odd columns 1 and 3 of the group are chroma samples 2h and 2h + 1.
    *reinterpret_cast<uint32_t*>(&sm.chr[0][t * kChrStride + r * 4 + 2 * h]) =
        bf16_pair(cr1, cr3);
    *reinterpret_cast<uint32_t*>(&sm.chr[1][t * kChrStride + r * 4 + 2 * h]) =
        bf16_pair(cb1, cb3);
  }
}

// One (16 tiles × 8 lanes) output block: ksteps k16-steps over the operand
// rows of m-tile mt, three passes (lo, mid, hi), into q.
template <int KSteps, int Stride>
__device__ __forceinline__ void product(const uint16_t* op, int mt,
                                        const uint32_t (&bf)[3][KSteps][2],
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
    mma_bf16(small, a[ks], bf[2][ks][0], bf[2][ks][1]);
    mma_bf16(large, a[ks], bf[0][ks][0], bf[0][ks][1]);
  }
#pragma unroll
  for (int ks = 0; ks < KSteps; ++ks) {
    mma_bf16(small, a[ks], bf[1][ks][0], bf[1][ks][1]);
  }
  const int row = 16 * mt + (lane >> 2);
  const int c = col + 2 * (lane & 3);
  const auto sum = [&](int i) { return __fadd_rn(small[i], large[i]); };
  const auto pack = [](float first, float second) {
    return (static_cast<uint32_t>(snap_trunc_int(first)) & 0xffffu) |
           (static_cast<uint32_t>(snap_trunc_int(second)) << 16);
  };
  *reinterpret_cast<uint32_t*>(&q[row * kQStride + c]) = pack(sum(0), sum(1));
  *reinterpret_cast<uint32_t*>(&q[(row + 8) * kQStride + c]) =
      pack(sum(2), sum(3));
}

// Sparse-delta epilogue: thread i takes lanes 8c..8c+7 (c = i % 16) of
// staged rows i/16, i/16 + 16, ... and writes each as one 16-byte store.  The
// deltas wrap modulo 2^16 like the reference's int16 cast.
__device__ __forceinline__ void store_band(const Smem& sm, const Band& b,
                                           int16_t* __restrict__ out) {
  const int c = threadIdx.x & 15;
  const bool seg_first = c == 0 || c == 8 || c == 12;  // lanes 0, 64, 96
  uint4* dst = reinterpret_cast<uint4*>(out + b.out_row * kLanes) +
               (threadIdx.x >> 4) * (kLanes / 8) + c;
  const int16_t* src = sm.q + (threadIdx.x >> 4) * kQStride + 8 * c;
  const int rows = b.tiles - (threadIdx.x >> 4);
#pragma unroll
  for (int j = 0; j < kTiles * 16 / kThreads; ++j) {
    if (j * (kThreads / 16) >= rows) break;
    const int16_t* qr = src + j * (kThreads / 16) * kQStride;
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
    __stcs(dst + j * (kThreads / 16) * (kLanes / 8), make_uint4(d[0], d[1], d[2], d[3]));
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    fwd_megakernel(const uint8_t* __restrict__ rgb, int16_t* __restrict__ out,
                   const uint16_t* __restrict__ parts, uint32_t n_bands,
                   int height, int width, int bpc, int bpr, bool staged) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_bytes);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bands_per_row = (bpr + kTiles - 1) / kTiles;
  const int row_bytes = width * 3;

  // Basis fragments (B operands, "col" layout: lane holds rows n = lane/4,
  // depth pairs 2·(lane%4) and +8), loaded once.  Luma columns 8w..8w+7;
  // chroma columns 8(w%4).. of channel w/4 (Cr and Cb share the basis).
  uint32_t bl[3][4][2], bc[3][2][2];
  {
    const int n = lane >> 2, k = 2 * (lane & 3);
    const uint32_t* lum = reinterpret_cast<const uint32_t*>(parts);
    const uint32_t* chr = reinterpret_cast<const uint32_t*>(parts + 3 * kLumPart);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
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
  const int ch = warp >> 2;
  const int lum_col = 8 * warp;
  const int chr_col = 64 + 32 * ch + 8 * (warp & 3);

  const uint32_t step = gridDim.x;
  if (staged) {
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      const uint32_t nb = blockIdx.x + s * step;
      if (nb < n_bands) {
        load_band(sm.raw[s], band_at(rgb, nb, height, width, bpc, bpr,
                                     bands_per_row), row_bytes);
      }
      cp_async_commit();
    }
  }
  int slot = 0;
  for (uint32_t band = blockIdx.x; band < n_bands; band += step) {
    const Band b = band_at(rgb, band, height, width, bpc, bpr, bands_per_row);
    if (staged) {
      const uint32_t nb = band + (kStages - 1) * step;
      if (nb < n_bands) {
        load_band(sm.raw[(slot + kStages - 1) % kStages],
                  band_at(rgb, nb, height, width, bpc, bpr, bands_per_row),
                  row_bytes);
      }
      cp_async_commit();
      cp_async_wait<kStages - 1>();
    }
    __syncthreads();  // this band's bytes landed; the last store pass is done
    convert_band(sm, sm.raw[slot], b, row_bytes, staged);
    __syncthreads();
#pragma unroll 1
    for (int mt = 0; mt < kTiles / 16; ++mt) {
      product<4, kLumStride>(sm.lum, mt, bl, sm.q, lum_col);
      product<2, kChrStride>(sm.chr[ch], mt, bc, sm.q, chr_col);
    }
    __syncthreads();
    store_band(sm, b, out);
    slot = (slot + 1) % kStages;
  }
  if (staged) cp_async_wait<0>();
}

}  // namespace

// rgb: (batch, H, W, 3) uint8, contiguous; out: (batch·bpc·bpr, 128) int16;
// parts: 3·64·64 luma then 3·32·32 chroma bf16 values (the hi, mid and lo
// parts of my and mc, rows = output lanes).  staged != 0 asks for the
// cp.async route, which needs rgb and W·3 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int fwd_megakernel_launch(const void* rgb, void* out,
                                     const void* parts, int batch, int height,
                                     int width, int bpc, int bpr, int staged,
                                     void* stream) {
  const int64_t n_bands = static_cast<int64_t>(batch) * bpc *
                          ((bpr + kTiles - 1) / kTiles);
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
  const int smem = static_cast<int>(sizeof(Smem));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_megakernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwd_megakernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > n_bands) grid = n_bands;
  fwd_megakernel<<<static_cast<unsigned>(grid), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int16_t*>(out),
      static_cast<const uint16_t*>(parts), static_cast<uint32_t>(n_bands),
      height, width, bpc, bpr,
      staged != 0);
  return cudaGetLastError();
}

extern "C" const char* fwd_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
