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
//
// The body is the template of csrc/fwd_megakernel.cuh; this file
// instantiates K1's variant (K1Variant) only.  csrc/fwd_probe_kernel.cu
// instantiates the probe variants (attribution and KT layout) of the same
// template.

#include "fwd_megakernel.cuh"

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
  return launch_variant<K1Variant>(rgb, out, parts, batch, height, width, bpc,
                                   bpr, staged, stream);
}

extern "C" const char* fwd_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
