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
// Below the bound the kernel is held by instruction issue: the earlier
// design's loop took about 170 warp instructions a tile in its SASS
// (band geometry and cp.async copies in every warp, the snap-trunc at
// twelve instructions an output, the HMMA chains padded with NOPs, the
// deltas and their stores), near its time at about half an instruction a
// clock a scheduler, and its three CTA barriers a band idled the
// schedulers in between.  So this design takes instructions out and lets
// the phases of three bands overlap.  What is left of the instructions
// still bounds it, issued at about half an instruction a clock a
// scheduler (profiles/megakernel.py::band_sass_counts counts them).
//
// Design.
// - Persistent CTAs (one an SM) of one producer warp and three consumer
//   groups of 8 warps walk over bands of kTiles = 64 tiles of one block
//   row: 8 image rows × 1,536 bytes.  CTA c takes bands c, c + grid, ...;
//   its i-th band goes to ring slot i % 5 and to group i % 3.
// - The producer: one lane computes each band's geometry (the divisions,
//   once a band instead of in every warp), writes it and the band's number
//   beside the slot and copies the band's rows inside the frame with one
//   1-D cp.async.bulk a row onto the slot's "full" mbarrier (the band's
//   bytes as its transaction count), once the slot's "empty" mbarrier says
//   its last band's group has read it (csrc/bulk_ring.cuh).  The wrapper
//   picks this route when the image pointer and the row stride W·3 are
//   16-byte aligned (W % 16 == 0, as at 2048²); otherwise the producer
//   writes the geometry only and the consumers read the pixels straight
//   from device memory (the direct route: ragged widths, unaligned views).
// - The consumers: no CTA barrier in the band loop.  A group synchronises
//   on its own named barrier (bar.sync 1 + g, 256 threads) three times a
//   band, so one group's store pass overlaps the others' colour and
//   product, and the ring's loads overlap all three.  A group waits for
//   its band's number beside the slot, then for the slot's parity (5
//   slots are no multiple of 3 groups: the parity alone also passes on an
//   earlier fill, of another group's band, that has not landed).  Each group has its own operands,
//   staging and output rows (53,280 B); with the ring, 221,520 B a CTA.
//   25 warps an SM leave 72 registers a thread: K1 fits them, no spills.
// - Colour on CUDA cores in exact integer arithmetic: two 2-way byte dot
//   products (dp2a) of 16-bit coefficients a value, wherever its R, G, B
//   lie in the words read, and floor(S / 1000) as the high word of one
//   multiply that also adds 2^23's bits (per_mille), four pixels per
//   thread from three 32-bit words, chroma for the odd columns only.  The
//   operands are the CENTRED samples v - 128, written to shared memory as
//   bf16 (exact: integers -128..127): luma (T × 64), Cr and Cb (T × 32)
//   each.  Σ (v-128)·m = Σ v·m - offs exactly, so the epilogue subtracts
//   nothing and the f32 sums stay small (no cancellation against the ~10²
//   offs).
// - Product on tensor cores: mma.sync.m16n8k16 bf16 → f32.  The f32 basis is
//   split on the host (ops/fwd_megakernel.py::split_basis) into three bf16
//   parts hi + mid + lo whose sum is exactly the f32 basis; each product
//   sample × part is exact in f32; lo and mid accumulate in one f32 chain, hi
//   in another, and the two are added once.  No TF32.  Warp w of a group
//   owns output columns 8w..8w+7 of luma and 8(w%4).. of Cr (w < 4) or Cb,
//   so its 36 basis fragment registers are loaded once per CTA.  Its luma
//   and chroma chains are written interleaved (four independent
//   accumulators); within 72 registers ptxas runs them one after another,
//   with NOPs between dependent mma.
// - Epilogue: snap-trunc as one LOP3, one FADD.RZ and one F2I an output
//   (snap_trunc_int), int16 into a padded shared row per tile (conflict-free
//   stores); then each thread takes 8 lanes of a row, forms the
//   segment-local deltas (the lane before its first is one 2-byte shared
//   read), adds kBias and writes them into the group's unpadded rows; the
//   band's rows, b.tiles × 256 contiguous bytes at out_row · 256, leave by
//   one cp.async.bulk store (16 KiB for a full band).
// The products, their sum order, the snap-trunc and the deltas are the
// same values as before, so the outputs are bit-identical to the earlier
// design's.  The sum order differs from cuBLAS's, so a coefficient whose
// ratio lies within rounding noise of an integer may truncate one step
// apart from the plain version (utils/parity.py::sum_order_flips).
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

// The launch of a (batch, H, W) image batch with bpc × bpr blocks a frame:
// plan[0] bands, [1] resident CTAs, [2] CTAs, [3] consumer groups a CTA,
// [4] ring slots, [5] threads a CTA (the last warp the producer), [6]
// dynamic shared memory bytes, [7] bytes a ring slot, [8] tiles a band.
// Returns the first CUDA error of the queries, cudaErrorInvalidValue where
// the band geometry would not fit in 32 bits.
extern "C" int fwd_megakernel_plan(int batch, int height, int width, int bpc,
                                   int bpr, long long* plan) {
  const int64_t n_bands = rgb_bands<K1Variant>(batch, height, width, bpc, bpr);
  if (n_bands < 0) return cudaErrorInvalidValue;
  Launch p;
  const cudaError_t err =
      persistent_grid<K1Variant>(fwd_megakernel<K1Variant>, n_bands, &p);
  if (err != cudaSuccess) return err;
  const long long shape[9] = {p.n_bands, p.resident, p.ctas, p.groups,
                              p.slots, p.threads, p.smem, p.slot_bytes,
                              p.tiles};
  for (int i = 0; i < 9; ++i) plan[i] = shape[i];
  return cudaSuccess;
}

// K1's registers a thread, shared memory a CTA (static + dynamic) and
// resident CTAs an SM.
extern "C" int fwd_megakernel_attributes(int* regs, int* smem, int* ctas) {
  return kernel_attributes<K1Variant>(fwd_megakernel<K1Variant>, regs, smem,
                                      ctas);
}

extern "C" const char* fwd_megakernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
