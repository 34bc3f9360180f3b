// Packed16 run-length expansion for Hopper (sm_90a): (N, K) run words
// (count - 1) << 10 | (value + 512) plus symbol lengths → values, K a power
// of two ≤ 64.
//
// K6, expand16_rows: replaces lz4jpeg_tpu/ops/pallas_rle.py::
// _rle_decode_kt_kernel, output (N, out_size) int32 row-major.
// K7, expand16_plane: replaces _rle_decode_kt_plane_kernel, output
// (bh, K, bw) int16 in the plane layout the plane inverse reads.
//
// The TPU kernels distributed value deltas to their run starts on a
// sublane-roll butterfly and filled by a delta-prefix MXU matmul.  On
// Hopper K6 expands one block row per warp from registers: lane s holds pair
// slots s and s + 32; slots below lengths / 2 are valid; a __shfl_up_sync
// scan of the valid counts gives each run's start; __reduce_or_sync builds
// the bit mask of starts below out_size; position p takes the value of the
// run of rank popc(starts ≤ p) - 1 (a __shfl_sync), and 0 at or past the
// covered total.  That is ops/rle.py::rle_decode_packed16 exactly, on every
// input, and not only what the Pallas kernels compute: they ignore lengths
// and treat a word of 0 as padding, but a valid word of 0 is value -512
// with count 1 (the native packed16 walker accepts it), and a run that
// crosses a block boundary belongs to the block where it ends, so it may
// start past that block's first slot and leave positions uncovered.
//
// What bounds them: one read of the words and lengths, one write of the
// values: 2 + 4/K bytes in and 4 (K6) or 2 (K7) bytes out per value.  At
// 2048², batch 64 (4,194,304 luma blocks of 64) K6 moves 1.63 GB, 0.49 ms
// at the 3.35 TB/s of an H100 SXM's data sheet (700 W); K7 1.09 GB,
// 0.33 ms.
//
// K7's design against that bound.  A tile is T = 64 consecutive blocks of
// one block row: its words (T·K·2 bytes) and lengths (T·4 bytes) are each
// one contiguous range, and each plane row k of its output is T·2 = 128
// contiguous bytes.  Persistent CTAs (as many as fit on the SMs) walk the
// tiles.  A ring of two tiles in shared memory keeps the next tile's loads
// in flight while the current one is decoded and stored: each lane starts
// 16-byte cp.async copies of the words it will decode (the lane-dense
// mapping of expand16_wide_kernel.cu: V = min(K, 8) words a lane, K / V
// lanes a block) and of its block's length, and waits only for its own
// copies and its block's (one warp), so the ring needs no CTA barrier.  The
// decode: a segmented shuffle scan of the counts gives each run's start;
// each run marks its start position in a per-block row of shared memory
// with its value + 513, and every slot past the valid ones marks the
// covered total with 513 (value 0), so no position needs a bound check;
// each position then takes the last mark at or before it (the lane's own
// marks, then a segmented shuffle scan across the block's lanes).  The
// decode is issue-bound, so a CTA has few warps (4 at K = 64, 2 below), each
// running the phases of its passes over the tile (4 at K = 32 and 64)
// together, so that their latencies overlap.  The values go as int16
// straight into a transposed [K][T] tile whose 16-byte chunks are
// XOR-swizzled by k / 8, so a warp's column writes fall on 16 distinct
// banks; the tile is then stored as 16-byte vectors, plane row by plane
// row.  Two output tiles alternate, so one CTA barrier per tile of 64
// blocks suffices.  A chunk past the block row's end, or a
// plane whose rows are not 16-byte aligned (bw % 8 ≠ 0), is stored element
// by element.  profiles/rle_expand_ablate.py times K7 cut after each phase.
// Its reading: the ring, the transposed tile and the stores with no decode
// run at some 78% of the bound, as fast as a plain transposing copy, and
// the last-mark fill adds most of the rest of the gap; the unpack, the
// scan and the marks add nothing the split resolves (two of its steps are
// slightly negative).  The split is not clean: the variants hold 65 to 80
// registers, and without K7's marks in shared memory the copy-only one fits
// more CTAs an SM (6 against 5 at K = 64, 13 against 10 at K = 32), so the
// movement's share is read at another occupancy than K7 runs at.
//
// The body of K7 is the template of csrc/expand16_plane.cuh (Phase::kFull
// here); csrc/expand16_probe_kernel.cu instantiates its ablated phases.

#include "expand16_plane.cuh"

namespace {

constexpr int kWarps = 8;  // K6: warps per 256-thread CTA
constexpr long long kMaxCtas = 1 << 16;

struct Expanded {
  int32_t lo;  // value at position lane
  int32_t hi;  // value at position lane + 32
};

// The warp expands one row; every lane must call it.  `p` is the row's
// words, `len` its symbol count.
__device__ __forceinline__ Expanded expand_row(const uint16_t* __restrict__ p,
                                               int32_t len, int seg,
                                               int out_size, int lane) {
  // floor(len / 2) for len < 0 is ≤ 0 too: no valid slot either way.
  const int n_valid = len > 0 ? len / 2 : 0;
  const bool va = lane < seg && lane < n_valid;
  const bool vb = lane + 32 < seg && lane + 32 < n_valid;
  const uint32_t wa = va ? p[lane] : 0u;
  const uint32_t wb = vb ? p[lane + 32] : 0u;
  const int ca = va ? static_cast<int>(wa >> 10) + 1 : 0;
  const int cb = vb ? static_cast<int>(wb >> 10) + 1 : 0;
  const int32_t xa = static_cast<int32_t>(wa & 0x3FF) - 512;
  const int32_t xb = static_cast<int32_t>(wb & 0x3FF) - 512;
  int ia = ca, ib = cb;  // inclusive scans of the counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ta = __shfl_up_sync(kFull, ia, d);
    const int tb = __shfl_up_sync(kFull, ib, d);
    if (lane >= d) {
      ia += ta;
      ib += tb;
    }
  }
  ib += __shfl_sync(kFull, ia, 31);
  const int total = __shfl_sync(kFull, ib, 31);
  const int sa = ia - ca;  // run starts
  const int sb = ib - cb;
  uint32_t lo = 0, hi = 0;
  if (va && sa < out_size) (sa < 32 ? lo : hi) |= 1u << (sa & 31);
  if (vb && sb < out_size) (sb < 32 ? lo : hi) |= 1u << (sb & 31);
  lo = __reduce_or_sync(kFull, lo);
  hi = __reduce_or_sync(kFull, hi);
  const uint32_t upto = (2u << lane) - 1u;  // bits 0..lane (all at lane 31)
  const int ra = __popc(lo & upto) - 1;
  const int rb = __popc(lo) + __popc(hi & upto) - 1;
  const int32_t ga = __shfl_sync(kFull, xa, ra & 31);
  const int32_t gb = __shfl_sync(kFull, xb, ra & 31);
  const int32_t ha = __shfl_sync(kFull, xa, rb & 31);
  const int32_t hb = __shfl_sync(kFull, xb, rb & 31);
  Expanded e;
  e.lo = lane < total ? (ra < 32 ? ga : gb) : 0;
  e.hi = lane + 32 < total ? (rb < 32 ? ha : hb) : 0;
  return e;
}

__global__ void __launch_bounds__(kWarps * 32)
    expand16_rows_kernel(const uint16_t* __restrict__ packed,
                         const int32_t* __restrict__ lengths,
                         int32_t* __restrict__ out, long long n_rows, int seg,
                         int out_size) {
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
       row < n_rows; row += step) {
    const Expanded e =
        expand_row(packed + row * seg, lengths[row], seg, out_size, lane);
    int32_t* o = out + row * out_size;
    if (lane < out_size) o[lane] = e.lo;
    if (lane + 32 < out_size) o[lane + 32] = e.hi;
  }
}

unsigned grid_for(long long units, int per_cta) {
  const long long ctas = (units + per_cta - 1) / per_cta;
  return static_cast<unsigned>(ctas < kMaxCtas ? ctas : kMaxCtas);
}

bool bad_seg(int seg) { return seg < 1 || seg > 64 || (seg & (seg - 1)); }

}  // namespace

// packed: (n_rows, seg) uint16; lengths: (n_rows,) int32; out: (n_rows,
// out_size) int32, 1 ≤ out_size ≤ 64; all contiguous.  Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int expand16_rows_launch(const void* packed, const void* lengths,
                                    void* out, long long n_rows, int seg,
                                    int out_size, void* stream) {
  if (bad_seg(seg) || out_size < 1 || out_size > 64)
    return cudaErrorInvalidValue;
  if (n_rows <= 0) return cudaSuccess;
  expand16_rows_kernel<<<grid_for(n_rows, kWarps), kWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(out),
      n_rows, seg, out_size);
  return cudaGetLastError();
}

// packed: (bh · bw, seg) uint16, block-row-major, 16-byte aligned;
// lengths: (bh · bw,) int32; out: (bh, seg, bw) int16; all contiguous.
extern "C" int expand16_plane_launch(const void* packed, const void* lengths,
                                     void* out, long long bh, long long bw,
                                     int seg, void* stream) {
  if (reinterpret_cast<uintptr_t>(packed) % 16)
    return cudaErrorMisalignedAddress;
  if (bad_seg(seg)) return cudaErrorInvalidValue;
  if (bh <= 0 || bw <= 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (seg) {
    case 1: return launch_plane<1>(packed, lengths, out, bh, bw, s);
    case 2: return launch_plane<2>(packed, lengths, out, bh, bw, s);
    case 4: return launch_plane<4>(packed, lengths, out, bh, bw, s);
    case 8: return launch_plane<8>(packed, lengths, out, bh, bw, s);
    case 16: return launch_plane<16>(packed, lengths, out, bh, bw, s);
    case 32: return launch_plane<32>(packed, lengths, out, bh, bw, s);
    default: return launch_plane<64>(packed, lengths, out, bh, bw, s);
  }
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of K7 at seg on the current device; returns the first CUDA error.
extern "C" int expand16_plane_attributes(int seg, int* regs, int* smem,
                                         int* ctas) {
  if (bad_seg(seg)) return cudaErrorInvalidValue;
  switch (seg) {
    case 1: return plane_attributes<1>(regs, smem, ctas);
    case 2: return plane_attributes<2>(regs, smem, ctas);
    case 4: return plane_attributes<4>(regs, smem, ctas);
    case 8: return plane_attributes<8>(regs, smem, ctas);
    case 16: return plane_attributes<16>(regs, smem, ctas);
    case 32: return plane_attributes<32>(regs, smem, ctas);
    default: return plane_attributes<64>(regs, smem, ctas);
  }
}

extern "C" const char* expand16_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
