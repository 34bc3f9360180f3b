// K7's body, the packed16 plane decode, as a template over the segment K
// and a cumulative phase.  csrc/expand16_kernel.cu instantiates
// Phase::kFull (K7, design in its header); csrc/expand16_probe_kernel.cu
// instantiates the four ablated phases at K = 32 and 64 for the phase split
// that profiles/profile_rle_expand_ablate.py made of the TPU's plane decode
// (its full row is K7 itself).
//
// Each phase keeps everything the one before it ran and writes int16 in the
// plane layout (bh, K, bw), at plane row k of block b, a value that depends
// on every live intermediate of its phases, so that nvcc keeps them:
//   kCopyT   the cp.async ring of words and lengths, the swizzled [K][T]
//            tile, the plane-row stores: the word at slot k;
//   kUnpack  + n_valid from the length and the counts: count + value at a
//            valid slot (k < n_valid), 0 past it;
//   kMatmul  + the segmented shuffle scan of the counts, which gives each
//            slot's run start s (the exclusive sum of the valid counts
//            before it): (int16) ((s << 6) ^ (value + 512)) at a valid
//            slot, 0 past it;
//   kDist    + the marks in shared memory: the block's marks row as it
//            stands before the fill, value + 513 at each run start below
//            K, 513 at the covered total if a slot is invalid and the
//            total is below K, 0 elsewhere;
//   kFull    + the last-mark fill: K7's output.
// (count = (word >> 10) + 1, value = (word & 0x3FF) - 512; n_valid =
// lengths / 2 for lengths > 0, else 0.)  The TPU probe's phases were
// copyT, +unpack, +matmul (its prefix sum of counts), +dist (six roll
// stages to the run starts) and full (six fill-forward stages).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

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

enum class Phase : int { kCopyT, kUnpack, kMatmul, kDist, kFull };

// Slot j of this lane's words goes to o[j * kTile] of the tile column that
// column_of returns: swz(first + j, col) = o + j · kTile, because (first +
// j) / 8 = first / 8.
__device__ __forceinline__ int16_t* column_of(int16_t* tile, int first,
                                              int col) {
  return tile + first * kTile + ((((col >> 3) ^ (first >> 3)) & 7) << 3) +
         (col & 7);
}

template <int K, Phase P = Phase::kFull>
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
      if constexpr (P == Phase::kCopyT) continue;
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
      if constexpr (P == Phase::kUnpack) continue;
      int scan = incl;  // segmented inclusive scan over the block's lanes
#pragma unroll
      for (int d = 1; d < L; d <<= 1) {
        const int s = __shfl_up_sync(kFull, scan, d, L);
        if (sub >= d) scan += s;
      }
      start[i] = scan - incl;  // begin of this lane's first run
      if constexpr (P == Phase::kMatmul) continue;
      *reinterpret_cast<Vec*>(marks[warp][i] + r * kRow + first) = Vec{};
    }
    if constexpr (P <= Phase::kMatmul) {
      // The cut: every pass's values, as they stand, into the tile.
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const int col = (warp + i * kCtaWarps) * R + r;
        int16_t* o = column_of(tile[buf], first, col);
        int s = P == Phase::kMatmul ? start[i] : 0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          int v = w[i].h[j];
          if constexpr (P == Phase::kUnpack)
            v = counts[i][j] ? counts[i][j] + (w[i].h[j] & 0x3FF) - 512 : 0;
          if constexpr (P == Phase::kMatmul) {
            v = counts[i][j] ? (s << 6) ^ (w[i].h[j] & 0x3FF) : 0;
            s += counts[i][j];
          }
          o[j * kTile] = static_cast<int16_t>(v);
        }
      }
    } else {
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
      if constexpr (P == Phase::kDist) {
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const int col = (warp + i * kCtaWarps) * R + r;
          Lane16<V> m;
          m.v = *reinterpret_cast<const Vec*>(marks[warp][i] + r * kRow +
                                              first);
          int16_t* o = column_of(tile[buf], first, col);
#pragma unroll
          for (int j = 0; j < V; ++j) o[j * kTile] = static_cast<int16_t>(m.h[j]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const int col = (warp + i * kCtaWarps) * R + r;
          Lane16<V> m;  // this lane's positions' marks
          m.v = *reinterpret_cast<const Vec*>(marks[warp][i] + r * kRow +
                                              first);
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
      }
      __syncwarp();  // the next tile clears the marks
    }
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

// Launches phase P at segment K with as many persistent CTAs as fit on the
// SMs (no more than there are tiles); returns the first CUDA error.
template <int K, Phase P = Phase::kFull>
cudaError_t launch_plane(const void* packed, const void* lengths, void* out,
                         long long bh, long long bw, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, expand16_plane_kernel<K, P>, kPlaneWarps<K> * 32, 0);
  if (err != cudaSuccess) return err;
  const long long tiles = bh * ((bw + kTile - 1) / kTile);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long ctas = tiles < resident ? tiles : resident;
  const bool vec_out =
      bw % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  expand16_plane_kernel<K, P><<<static_cast<unsigned>(ctas),
                                kPlaneWarps<K> * 32, 0, stream>>>(
      static_cast<const uint16_t*>(packed),
      static_cast<const int32_t*>(lengths), static_cast<int16_t*>(out), bh,
      bw, vec_out);
  return cudaGetLastError();
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of phase P at segment K on the current device; returns the first CUDA
// error.
template <int K, Phase P = Phase::kFull>
cudaError_t plane_attributes(int* regs, int* smem, int* ctas) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, expand16_plane_kernel<K, P>);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, expand16_plane_kernel<K, P>, kPlaneWarps<K> * 32, 0);
}

}  // namespace
