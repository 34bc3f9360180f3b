// LZ4's greedy parses for Hopper (sm_90a): K10, the LZ4T segment parse that
// follows the match kernel K2, and K11, parity mode's match tables fused
// with their parse.  Both replace XLA stages that have no Pallas kernel:
//
//   K10  lz4jpeg_tpu/ops/pallas_match.py:285-338, the post-pass of
//        fast_match_blocks_pallas (caps, the lax.scan at :320, the stride
//        expansion), and lz4jpeg_tpu/ops/lz4_fast.py:223, the sort
//        matcher's lax.scan;
//   K11  lz4jpeg_tpu/ops/match.py:56 match_tables ((B, P, P) tables, a
//        reversed cummin, an argmax) and :93 greedy_parse (the vmapped
//        lax.scan at :121).
//
// The port ran both as Python loops over positions: every step a handful of
// torch launches over all blocks (K10: 512 steps of ~8 launches after each
// K2; K11: P steps of ~5 launches after six (B, P, P) tables).
//
// K10.  A segment (seg / stride anchors of a row) parses on its own, so a
// CTA takes a unit of whole segments (a tile of at most kTileAnchors
// anchors), or one segment longer than a tile in tiles of kTileAnchors.  A
// tile goes through shared memory in three steps:
//   1. load: coalesced reads of the anchors' inputs.  The candidate entry
//      unpacks K2's words ((lcp << pos_bits) | distance in anchors), scales
//      the distance by the stride, applies the max_dist cap, the segment-end
//      and block-end caps on the byte grid and the >= 4 re-check; the field
//      entry stages the capped lengths as they are;
//   2. walk: one thread a segment runs the greedy scan over its slots in
//      shared memory (slot k is taken when the segment's skip pointer is <= k
//      and its length is > 0; a taken length L moves the pointer to
//      k + ceil(L / stride)) and zeroes the lengths it does not take.  The
//      segments' rows are padded to an odd pitch, so the walkers of a warp
//      read 32 different banks;
//   3. store: coalesced writes of (is_match, emit_len, emit_dist), each
//      anchor's fields followed by stride - 1 zeros (the byte grid), one
//      16-, 8- or 4-byte vector a field at strides 4, 2 and 1.
// A segment longer than a tile is walked by one thread that carries its
// skip pointer from tile to tile.  The scan's arithmetic is the plain
// version's in the inputs' integer type, wrapping as torch's does.
//
// What bounds K10.  Bytes: at 2048 blocks of 16 KiB, stride 1, it reads
// 134 MB of K2's words and writes 403 MB of fields, 0.160 ms at 3.35 TB/s.
// The walks (seg / stride dependent steps from shared memory, 4 walkers a
// CTA at stride 1) add to the load and store steps what other CTAs' traffic
// does not hide; profiles/parse_probe.py times K10 without them.
//
// K11.  One CTA a block of P positions.  For each distance d the equality
// run R(d, k) (x[j] == x[j - d] for j = k, k + 1, ...) follows backwards
// along k: R(d, k) = eq ? min(R(d, k + 1) + 1, max_match) : 0, clamped
// before anything compares it.  The best match at k is the largest clamped
// run over d in [1, k] with ties to the largest d, so a warp takes 32
// consecutive d, packs key = (run << 16) | d (0 below the 4-byte minimum),
// reduces it by __reduce_max_sync and one lane raises the position's
// shared key by atomicMax: O(P^2) compares a block and no (P, P) table.
// Positions go in tiles of kTileK keys from the last tile to the first; a
// block of more than kTileK positions carries each d's run across tiles in
// a scratch row.  The keys give best_len and best_dist; best_len & 0xFF (the
// reference's uint8 truncation: 256 and 512 become literals, 257 a match of
// 1) go to shared memory, where one thread walks the parse four bytes at a
// time; then every thread writes the fields.  The key holds run and d in 16
// bits each: P <= 65,536 (the frame's block size is 16 bits), so d and the
// clamped run are both below 2^16.
//
// What bounds K11.  Neither bytes (a 255-block, 300-byte frame moves ~1 MB)
// nor issue at the codec's sizes (P^2 / 2 lane compares, ~23 million at 255
// x 300): the launch and the walk's ~P dependent steps set its time.
//
// Host side: plain C entry points; each returns cudaGetLastError() after
// its launch (0 on success).

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

// ---- K10 ------------------------------------------------------------------

constexpr int kParseThreads = 128;
constexpr int kTileAnchors = 2048;
// A tile's segments at an odd pitch: at most one pad slot for every two.
constexpr int kTileSlots = kTileAnchors + kTileAnchors / 2;

struct ParseGeom {
  long long n_anchors;   // rows * pa
  long long pa;          // anchors a row
  long long seg;         // bytes a segment (the caps' segment)
  long long max_dist;
  int seg_a;             // anchors a segment (the walk's length)
  int pitch;             // shared-memory pitch of a segment in a tile
  int tile_n;            // anchors of a full tile
  int stride;
  int pos_bits;
  int pa_shift;          // log2(pa) when pa is a power of two, else -1
  int seg_shift;         // log2(seg_a) likewise
  int stride_shift;      // log2(stride) likewise
};

// torch's integer arithmetic: wrapping add, floor division by a positive.
template <typename T>
__device__ __forceinline__ T wrap_add(T a, T b) {
  using U = typename std::conditional<sizeof(T) == 8, unsigned long long,
                                      unsigned int>::type;
  return static_cast<T>(static_cast<U>(a) + static_cast<U>(b));
}

template <typename T>
__device__ __forceinline__ T floor_div(T a, T s) {
  T q = a / s;
  return (a % s != 0 && a < 0) ? q - 1 : q;
}

// Slot of tile anchor i in shared memory: segment rows at the odd pitch (a
// segment longer than a tile fills it in order).
__device__ __forceinline__ int slot_of(int i, const ParseGeom& g,
                                       bool long_seg) {
  if (long_seg) return i;
  const int s = g.seg_shift >= 0 ? i >> g.seg_shift : i / g.seg_a;
  return s * g.pitch + (i - s * g.seg_a);
}

// Slots a walker loads ahead of its scan.
constexpr int kWalkBatch = 8;
// False builds K10 without its walk (profiles/parse_probe.py: the walk's
// share of the time); the codec's build walks.
constexpr bool kWalk = true;

// ceil(ml / stride) as torch computes it: (ml + stride - 1) // stride,
// wrapping; a shift when the stride is a power of two.
template <typename T>
__device__ __forceinline__ T consumed_of(T ml, T stride, int shift) {
  const T sum = wrap_add(ml, static_cast<T>(stride - 1));
  return shift >= 0 ? (sum >> shift) : floor_div(sum, stride);
}

// The greedy scan over n slots from segment step k0 on.  A slot's length is
// taken when the pointer has reached it (skip <= k) and it is > 0; the
// lengths not taken are zeroed.  Where the pointer has reached an empty slot
// it moves to k, which changes no later comparison, so the step that carries
// the pointer is one compare and one select; the slots are loaded
// kWalkBatch ahead of it.
template <typename T>
__device__ void walk(T* lens, int n, long long k0, T& skip, T stride,
                     int shift) {
  for (int j = 0; j < n; j += kWalkBatch) {
    T ml[kWalkBatch];
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      ml[u] = j + u < n ? lens[j + u] : static_cast<T>(0);
    }
#pragma unroll
    for (int u = 0; u < kWalkBatch; ++u) {
      const T k = static_cast<T>(k0 + j + u);
      const T next =
          ml[u] > 0 ? wrap_add(k, consumed_of(ml[u], stride, shift)) : k;
      const bool reach = skip <= k;
      if (!reach && ml[u] > 0) lens[j + u] = 0;
      skip = reach ? next : skip;
    }
  }
}

// kCandidates: T = int32, inputs K2's packed words and the rows' lengths,
// the output on the byte grid.  Otherwise: T = int32 or int64 capped
// lengths and distances, the output on the same grid.
template <typename T, bool kCandidates>
__global__ void __launch_bounds__(kParseThreads)
    segment_parse_kernel(const void* __restrict__ in_len,
                         const void* __restrict__ in_dist,
                         const int32_t* __restrict__ lengths, ParseGeom g,
                         int32_t* __restrict__ is_match,
                         int32_t* __restrict__ emit_len,
                         int32_t* __restrict__ emit_dist) {
  __shared__ T s_len[kTileSlots];
  __shared__ int32_t s_dist[kCandidates ? kTileSlots : 1];
  const int tid = threadIdx.x;
  const bool long_seg = g.seg_a > kTileAnchors;
  const long long unit_base =
      static_cast<long long>(blockIdx.x) *
      (long_seg ? static_cast<long long>(g.seg_a) : g.tile_n);
  const long long unit_end =
      min(g.n_anchors, unit_base + (long_seg ? static_cast<long long>(g.seg_a)
                                             : g.tile_n));
  T skip = 0;  // thread 0's pointer through a segment longer than a tile
  for (long long base = unit_base; base < unit_end; base += kTileAnchors) {
    const int n = static_cast<int>(min(static_cast<long long>(
        long_seg ? kTileAnchors : g.tile_n), unit_end - base));
    // 1. load
    for (int i = tid; i < n; i += kParseThreads) {
      const long long f = base + i;
      const int s = slot_of(i, g, long_seg);
      if constexpr (kCandidates) {
        const long long row = g.pa_shift >= 0 ? f >> g.pa_shift : f / g.pa;
        const long long a = f - row * g.pa;
        const int32_t v = static_cast<const int32_t*>(in_len)[f];
        long long len = static_cast<long long>(v >> g.pos_bits);
        const int32_t mask = static_cast<int32_t>((1u << g.pos_bits) - 1u);
        long long dist = static_cast<long long>(v & mask) * g.stride;
        if (dist > g.max_dist) dist = 0;
        if (dist <= 0) len = 0;
        const long long bp = a * g.stride;
        const long long seg_left = g.seg - (bp & (g.seg - 1));
        const long long limit =
            min(static_cast<long long>(lengths[row]) - bp, seg_left);
        len = min(len, max(limit, 0ll));
        if (len < 4) len = 0;
        s_len[s] = static_cast<T>(len);
        s_dist[s] = len > 0 ? static_cast<int32_t>(dist) : 0;
      } else {
        s_len[s] = static_cast<const T*>(in_len)[f];
      }
    }
    __syncthreads();
    // 2. walk
    if (kWalk && long_seg) {
      if (tid == 0) {
        walk<T>(s_len, n, base - unit_base, skip, static_cast<T>(g.stride),
                g.stride_shift);
      }
    } else if (kWalk) {
      for (int w = tid; w * g.seg_a < n; w += kParseThreads) {
        T seg_skip = 0;
        walk<T>(s_len + w * g.pitch, g.seg_a, 0, seg_skip,
                static_cast<T>(g.stride), g.stride_shift);
      }
    }
    __syncthreads();
    // 3. store
    for (int i = tid; i < n; i += kParseThreads) {
      const long long f = base + i;
      const int s = slot_of(i, g, long_seg);
      const T l = s_len[s];
      const int32_t m = l > 0 ? 1 : 0;
      const int32_t ln = m ? static_cast<int32_t>(l) : 0;
      int32_t d = 0;
      if (m) {
        if constexpr (kCandidates) {
          d = s_dist[s];
        } else {
          d = static_cast<int32_t>(static_cast<const T*>(in_dist)[f]);
        }
      }
      if (!kCandidates || g.stride == 1) {
        is_match[f] = m;
        emit_len[f] = ln;
        emit_dist[f] = d;
      } else if (g.stride == 2) {
        reinterpret_cast<int2*>(is_match)[f] = make_int2(m, 0);
        reinterpret_cast<int2*>(emit_len)[f] = make_int2(ln, 0);
        reinterpret_cast<int2*>(emit_dist)[f] = make_int2(d, 0);
      } else if (g.stride == 4) {
        reinterpret_cast<int4*>(is_match)[f] = make_int4(m, 0, 0, 0);
        reinterpret_cast<int4*>(emit_len)[f] = make_int4(ln, 0, 0, 0);
        reinterpret_cast<int4*>(emit_dist)[f] = make_int4(d, 0, 0, 0);
      } else {
        const long long e = f * g.stride;
        is_match[e] = m;
        emit_len[e] = ln;
        emit_dist[e] = d;
        for (int r = 1; r < g.stride; ++r) {
          is_match[e + r] = 0;
          emit_len[e + r] = 0;
          emit_dist[e + r] = 0;
        }
      }
    }
    __syncthreads();
  }
}

// ---- K11 ------------------------------------------------------------------

constexpr int kParityThreads = 512;
constexpr int kTileK = 8192;
constexpr int kBatchK = 8;  // positions a warp loads ahead
constexpr int kMaxPositions = 1 << 16;

__global__ void __launch_bounds__(kParityThreads)
    parity_parse_kernel(const int32_t* __restrict__ blocks, int p, int mm,
                        int32_t* best_len, int32_t* best_dist,
                        uint8_t* __restrict__ is_match,
                        int32_t* __restrict__ emit_len,
                        int32_t* __restrict__ emit_dist, int32_t* carry) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = min(p, kTileK);
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  uint8_t* lens8 = smem + 4 * ((tile + 3) & ~3);
  const int p4 = (p + 3) & ~3;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kParityThreads / 32;
  const long long row = static_cast<long long>(blockIdx.x) * p;
  const int32_t* x = blocks + row;
  int32_t* carry_row =
      carry == nullptr ? nullptr : carry + blockIdx.x * static_cast<long long>(p4 + 32);
  for (int k = p + tid; k < p4; k += kParityThreads) lens8[k] = 0;

  const int n_tiles = (p + tile - 1) / tile;
  for (int t = n_tiles - 1; t >= 0; --t) {
    const int k0 = t * tile;
    const int k1 = min(p, k0 + tile);
    for (int i = tid; i < k1 - k0; i += kParityThreads) keys[i] = 0u;
    __syncthreads();
    // Distance groups of 32 with some d <= k1 - 1.
    const int groups = (k1 - 1) / 32 + 1;
    for (int grp = warp; grp < groups; grp += kWarps) {
      const int d = 32 * grp + lane;
      int r = t == n_tiles - 1 ? 0 : carry_row[d];
      const int kmin = max(k0, 32 * grp);
      // kBatchK positions at a time: the loads first, then the runs (the
      // only chain), then, if any lane holds a key, the warp maxima.
      for (int kb = k1 - 1; kb >= kmin; kb -= kBatchK) {
        int32_t xk[kBatchK], xj[kBatchK];
#pragma unroll
        for (int u = 0; u < kBatchK; ++u) {
          const int k = kb - u;
          const int j = k - d;
          xk[u] = k >= kmin ? __ldg(x + k) : 0;
          xj[u] = k >= kmin && d >= 1 && j >= 0 ? __ldg(x + j) : ~xk[u];
        }
        uint32_t key[kBatchK];
        uint32_t any = 0u;
#pragma unroll
        for (int u = 0; u < kBatchK; ++u) {
          const bool in = kb - u >= kmin;
          if (in) r = xj[u] == xk[u] ? min(r + 1, mm) : 0;
          key[u] = in && r >= 4 ? (static_cast<uint32_t>(r) << 16) |
                                      static_cast<uint32_t>(d)
                                : 0u;
          any |= key[u];
        }
        if (__any_sync(0xffffffffu, any != 0u)) {
#pragma unroll
          for (int u = 0; u < kBatchK; ++u) {
            const uint32_t top = __reduce_max_sync(0xffffffffu, key[u]);
            if (lane == 0 && top != 0u) atomicMax(&keys[kb - u - k0], top);
          }
        }
      }
      if (t > 0) carry_row[d] = r;
    }
    __syncthreads();
    for (int i = tid; i < k1 - k0; i += kParityThreads) {
      const uint32_t key = keys[i];
      best_len[row + k0 + i] = static_cast<int32_t>(key >> 16);
      best_dist[row + k0 + i] = static_cast<int32_t>(key & 0xffffu);
      lens8[k0 + i] = static_cast<uint8_t>(key >> 16);
    }
    __syncthreads();
  }

  // The parse: a position starts a match when the pointer has reached it and
  // its truncated length is not 0; the match moves the pointer past it.
  if (tid == 0) {
    uint32_t* words = reinterpret_cast<uint32_t*>(lens8);
    int skip = 0;
    for (int w = 0; w < p4 / 4; ++w) {
      const uint32_t word = words[w];
      uint32_t kept = word;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * w + b;
        const int l = (word >> (8 * b)) & 0xff;
        const bool reach = skip <= k;
        if (!reach && l != 0) kept &= ~(0xffu << (8 * b));
        skip = reach ? k + l : skip;
      }
      if (kept != word) words[w] = kept;
    }
  }
  __syncthreads();
  for (int k = tid; k < p; k += kParityThreads) {
    const int l = lens8[k];
    is_match[row + k] = l != 0;
    emit_len[row + k] = l;
    emit_dist[row + k] = l != 0 ? best_dist[row + k] : 0;
  }
}

int log2_exact(long long v) {
  if (v <= 0 || (v & (v - 1)) != 0) return -1;
  int s = 0;
  while ((1ll << s) < v) ++s;
  return s;
}

// A CTA's unit: whole segments up to a tile, or one segment longer than a
// tile.  Returns the number of units (CTAs).
long long plan_units(ParseGeom& g) {
  g.pitch = g.seg_a | 1;
  g.pa_shift = log2_exact(g.pa);
  g.seg_shift = log2_exact(g.seg_a);
  g.stride_shift = log2_exact(g.stride);
  if (g.seg_a > kTileAnchors) {
    g.tile_n = kTileAnchors;
    return g.n_anchors / g.seg_a;
  }
  g.tile_n = (kTileAnchors / g.seg_a) * g.seg_a;
  return (g.n_anchors + g.tile_n - 1) / g.tile_n;
}

// Bytes of K11's dynamic shared memory for blocks of p positions: the
// tile's keys, then the truncated lengths of every position.
long long parity_parse_shared_bytes(int p) {
  const int tile = p < kTileK ? p : kTileK;
  return 4ll * ((tile + 3) & ~3) + ((p + 3) & ~3);
}

}  // namespace

// K10, candidate entry: packed (rows, pa) int32 words of K2 and the rows'
// int32 lengths → three (rows, pa * stride) int32 fields.  seg_a = seg /
// stride divides pa.
extern "C" int segment_parse_candidates_launch(
    const void* packed, const void* lengths, void* is_match, void* emit_len,
    void* emit_dist, long long rows, long long pa, int stride, long long seg,
    int seg_a, int pos_bits, long long max_dist, void* stream) {
  if (rows <= 0 || pa <= 0) return cudaSuccess;
  if (stride < 1 || seg_a < 1 || pa % seg_a != 0 || pos_bits < 0 ||
      pos_bits > 30) {
    return cudaErrorInvalidValue;
  }
  ParseGeom g;
  g.n_anchors = rows * pa;
  g.pa = pa;
  g.seg = seg;
  g.max_dist = max_dist;
  g.seg_a = seg_a;
  g.stride = stride;
  g.pos_bits = pos_bits;
  const long long units = plan_units(g);
  if (units > 0x7fffffffll) return cudaErrorInvalidValue;
  segment_parse_kernel<int32_t, true>
      <<<static_cast<unsigned>(units), kParseThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          packed, nullptr, static_cast<const int32_t*>(lengths), g,
          static_cast<int32_t*>(is_match), static_cast<int32_t*>(emit_len),
          static_cast<int32_t*>(emit_dist));
  return cudaGetLastError();
}

// K10, field entry: n slots of capped lengths and distances (int32 when
// elem_bytes is 4, int64 when 8) in segments of seg slots → three int32
// fields of n slots.
extern "C" int segment_parse_fields_launch(
    const void* match_len, const void* match_dist, void* is_match,
    void* emit_len, void* emit_dist, long long n, int seg, int stride,
    int elem_bytes, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (seg < 1 || n % seg != 0 || stride < 1 ||
      (elem_bytes != 4 && elem_bytes != 8)) {
    return cudaErrorInvalidValue;
  }
  ParseGeom g;
  g.n_anchors = n;
  g.pa = n;
  g.seg = seg;
  g.max_dist = 0;
  g.seg_a = seg;
  g.stride = stride;
  g.pos_bits = 0;
  const long long units = plan_units(g);
  if (units > 0x7fffffffll) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(units);
  if (elem_bytes == 4) {
    segment_parse_kernel<int32_t, false><<<grid, kParseThreads, 0, s>>>(
        match_len, match_dist, nullptr, g, static_cast<int32_t*>(is_match),
        static_cast<int32_t*>(emit_len), static_cast<int32_t*>(emit_dist));
  } else {
    segment_parse_kernel<long long, false><<<grid, kParseThreads, 0, s>>>(
        match_len, match_dist, nullptr, g, static_cast<int32_t*>(is_match),
        static_cast<int32_t*>(emit_len), static_cast<int32_t*>(emit_dist));
  }
  return cudaGetLastError();
}

// Units (CTAs) of a K10 launch over n_anchors anchors in segments of seg_a.
extern "C" long long segment_parse_units(long long n_anchors, int seg_a) {
  ParseGeom g;
  g.n_anchors = n_anchors;
  g.pa = n_anchors;
  g.seg_a = seg_a;
  return seg_a < 1 ? 0 : plan_units(g);
}


// Int32 words of K11's carry scratch a block (0: none needed).
extern "C" long long parity_parse_carry_words(int p) {
  return p > kTileK ? static_cast<long long>(((p + 3) & ~3) + 32) : 0ll;
}

// K11: (rows, p) int32 blocks → best_len, best_dist, is_match (uint8 0/1),
// emit_len, emit_dist, each (rows, p).  mm is max_match clamped to
// [0, 65535]; carry holds rows * parity_parse_carry_words(p) words or is
// null when that is 0.
extern "C" int parity_parse_launch(const void* blocks, void* best_len,
                                   void* best_dist, void* is_match,
                                   void* emit_len, void* emit_dist,
                                   void* carry, long long rows, int p, int mm,
                                   void* stream) {
  if (rows <= 0 || p <= 0) return cudaSuccess;
  if (p > kMaxPositions || mm < 0 || mm > 0xffff || rows > 0x7fffffffll ||
      (parity_parse_carry_words(p) > 0 && carry == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const long long shared = parity_parse_shared_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      parity_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return err;
  parity_parse_kernel<<<static_cast<unsigned>(rows), kParityThreads,
                        static_cast<size_t>(shared),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(blocks), p, mm,
      static_cast<int32_t*>(best_len), static_cast<int32_t*>(best_dist),
      static_cast<uint8_t*>(is_match), static_cast<int32_t*>(emit_len),
      static_cast<int32_t*>(emit_dist), static_cast<int32_t*>(carry));
  return cudaGetLastError();
}

extern "C" const char* lz4_parse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
