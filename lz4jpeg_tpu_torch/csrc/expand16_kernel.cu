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
// by element.  What remains between it and the bound is the decode's
// instruction count, not the memory pipeline: a copy of the kernel that
// skips the decode moves the same bytes much closer to the bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
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

// One lane's V consecutive 16-bit words as a single load or store.
template <int V> struct VecOf;
template <> struct VecOf<8> { using type = uint4; };
template <> struct VecOf<4> { using type = uint2; };
template <> struct VecOf<2> { using type = uint32_t; };
template <> struct VecOf<1> { using type = uint16_t; };

template <int V>
union Lane16 {
  typename VecOf<V>::type v;
  uint16_t h[V];
};

constexpr int kTile = 64;  // K7: blocks of one block row per tile

// K7: warps per CTA.
template <int K>
constexpr int kPlaneWarps = K >= 64 ? 4 : 2;

// Index of plane row k, tile column c in a [K][kTile] int16 tile whose
// 16-byte chunks (8 columns) are XOR-swizzled by k / 8.
__device__ __forceinline__ int swz(int k, int c) {
  return k * kTile + ((((c >> 3) ^ (k >> 3)) & 7) << 3) + (c & 7);
}

// Asynchronous copy of N bytes (4, 8 or 16) from device to shared memory;
// N = 2 is an ordinary load and store.
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (N == 2) {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                   "l"(src));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                   "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int K>
__global__ void __launch_bounds__(kPlaneWarps<K> * 32)
    expand16_plane_kernel(const uint16_t* __restrict__ packed,
                          const int32_t* __restrict__ lengths,
                          int16_t* __restrict__ out, long long bh,
                          long long bw, bool vec_out) {
  constexpr int kCtaWarps = kPlaneWarps<K>;
  constexpr int V = K < 8 ? K : 8;  // words per lane
  constexpr int L = K / V;          // lanes per block
  constexpr int R = 32 / L;         // blocks per warp pass
  constexpr int kPasses = kTile / R;
  constexpr int kMine = kPasses / kCtaWarps;  // passes per warp
  static_assert(kPasses % kCtaWarps == 0, "every warp takes kMine passes");
  constexpr int kStages = 2;  // tiles of input in the ring
  // A block's marks, padded by 16 bytes so that the blocks of a warp pass
  // start on different banks.
  constexpr int kRow = K >= 8 ? K + 8 : K;
  using Vec = typename VecOf<V>::type;
  __shared__ alignas(16) uint16_t ring_words[kStages][kTile * K];
  __shared__ int32_t ring_lengths[kStages][kTile];
  __shared__ alignas(16) int16_t tile[2][K * kTile];
  // Per warp pass: each block's run starts, marked position by position.
  __shared__ alignas(16) int16_t marks[kCtaWarps][kMine][R * kRow];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;  // lane within the block's segment
  const int r = lane / L;    // block within the warp pass
  const int first = sub * V;  // this lane's first word and output position
  // Tile t is tile t % row_tiles of block row t / row_tiles.  A CTA walks
  // t = blockIdx.x, + gridDim.x, ...: the coordinates advance by (step_a,
  // step_b) with a carry, with no 64-bit division in the loop.
  const long long row_tiles = (bw + kTile - 1) / kTile;
  const long long step_a = gridDim.x / row_tiles;
  const long long step_b = gridDim.x % row_tiles;
  struct At {
    long long a, b;  // block row, tile within it
  };
  auto at = [&](long long t) { return At{t / row_tiles, t % row_tiles}; };
  auto advance = [&](At& p) {
    p.a += step_a;
    p.b += step_b;
    if (p.b >= row_tiles) {
      p.b -= row_tiles;
      ++p.a;
    }
  };

  // Starts the copies of this lane's words of tile p, and of its block's
  // length (first lane of a block), into ring stage st.
  auto fetch = [&](At p, int st) {
    const long long b0 = p.b * kTile;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int col = (warp + i * kCtaWarps) * R + r;
      if (b0 + col < bw) {
        const long long row = p.a * bw + b0 + col;
        copy_async<V * 2>(&ring_words[st][col * K + first],
                          packed + row * K + first);
        if (sub == 0) copy_async<4>(&ring_lengths[st][col], lengths + row);
      }
    }
  };

  At ahead = at(blockIdx.x);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ahead.a < bh) fetch(ahead, st);
    commit_copies();
    advance(ahead);
  }
  int st = 0, buf = 0;
  for (At cur = at(blockIdx.x); cur.a < bh; advance(cur)) {
    if (ahead.a < bh) fetch(ahead, (st + kStages - 1) % kStages);
    commit_copies();
    advance(ahead);
    wait_copies<kStages - 1>();  // this lane's copies of tile cur have landed
    const long long a = cur.a;
    const long long b0 = cur.b * kTile;
    // The warp's passes run phase by phase, so their latencies overlap.
    Lane16<V> w[kMine];
    int counts[kMine][V];
    int start[kMine];
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int col = (warp + i * kCtaWarps) * R + r;
      const bool live = b0 + col < bw;
      w[i].v = live ? *reinterpret_cast<const Vec*>(
                          &ring_words[st][col * K + first])
                    : Vec{};
      const int32_t len = __shfl_sync(
          kFull, live && sub == 0 ? ring_lengths[st][col] : 0, 0, L);
      // floor(len / 2) for len < 0 is ≤ 0 too: no valid slot either way.
      const int n_valid = len > 0 ? len / 2 : 0;
      int incl = 0;  // inclusive sum of this lane's counts
#pragma unroll
      for (int j = 0; j < V; ++j) {
        counts[i][j] = first + j < n_valid ? (w[i].h[j] >> 10) + 1 : 0;
        incl += counts[i][j];
      }
      int scan = incl;  // segmented inclusive scan over the block's lanes
#pragma unroll
      for (int d = 1; d < L; d <<= 1) {
        const int s = __shfl_up_sync(kFull, scan, d, L);
        if (sub >= d) scan += s;
      }
      start[i] = scan - incl;  // begin of this lane's first run
      *reinterpret_cast<Vec*>(marks[warp][i] + r * kRow + first) = Vec{};
    }
    __syncwarp();
    // Each run marks its first position with its value + 513 (never 0).
    // Invalid slots have count 0 and all mark the covered total with 513,
    // which decodes to 0: every position at or past it is 0.
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      int16_t* mk = marks[warp][i] + r * kRow;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (start[i] < K)
          mk[start[i]] = static_cast<int16_t>(
              counts[i][j] ? (w[i].h[j] & 0x3FF) + 1 : 513);
        start[i] += counts[i][j];
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int col = (warp + i * kCtaWarps) * R + r;
      Lane16<V> m;  // this lane's positions' marks
      m.v = *reinterpret_cast<const Vec*>(marks[warp][i] + r * kRow + first);
      // Position p takes the mark of the last marked position ≤ p: the
      // lane's own marks, carried in from the lanes before it by a
      // segmented scan of "the last mark so far".
      int last = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) last = m.h[j] ? m.h[j] : last;
#pragma unroll
      for (int d = 1; d < L; d <<= 1) {
        const int t = __shfl_up_sync(kFull, last, d, L);
        if (sub >= d && last == 0) last = t;
      }
      int cur = __shfl_up_sync(kFull, last, 1, L);
      // swz(first + j, col) = o + j · kTile: (first + j) / 8 = first / 8.
      int16_t* o = tile[buf] + first * kTile +
                   ((((col >> 3) ^ (first >> 3)) & 7) << 3) + (col & 7);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        cur = m.h[j] ? m.h[j] : cur;
        o[j * kTile] = static_cast<int16_t>(cur - 513);
      }
    }
    __syncwarp();  // the next tile clears the marks
    __syncthreads();  // the tile is whole; the other buffer is free
    const int16_t* tl = tile[buf];
    for (int i = threadIdx.x; i < K * (kTile / 8); i += kCtaWarps * 32) {
      const int k = i >> 3;
      const int c = (i & 7) * 8;
      const long long b = b0 + c;
      if (b >= bw) continue;
      int16_t* dst = out + (a * K + k) * bw + b;
      const int16_t* src = tl + swz(k, c);
      if (vec_out && b + 8 <= bw) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && b + e < bw; ++e) dst[e] = src[e];
      }
    }
    buf ^= 1;
    st = st + 1 == kStages ? 0 : st + 1;
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

template <int K>
cudaError_t launch_plane(const void* packed, const void* lengths, void* out,
                         long long bh, long long bw, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, expand16_plane_kernel<K>, kPlaneWarps<K> * 32, 0);
  if (err != cudaSuccess) return err;
  const long long tiles = bh * ((bw + kTile - 1) / kTile);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long ctas = tiles < resident ? tiles : resident;
  const bool vec_out =
      bw % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  expand16_plane_kernel<K><<<static_cast<unsigned>(ctas), kPlaneWarps<K> * 32,
                             0,
                             stream>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<int16_t*>(out), bh,
      bw, vec_out);
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

extern "C" const char* expand16_kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
