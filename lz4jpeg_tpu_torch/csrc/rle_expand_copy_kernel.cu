// Three copies of the (rows, K) int16 packed16 stream for Hopper (sm_90a),
// which split the cost of K7's data movement from its decode:
//   copy_rm: (rows, K) → (rows, K), the identity, row by row;
//   copy_t_contig: (rows, K) → (K, rows), a contiguous transpose;
//   copy_t_slab: (bh · bw, K) → (bh, K, bw), the plane layout K7 writes,
//   with no decode.
//
// Replaces profiles/profile_rle_expand_rm.py's copy_rm_kernel (:50;
// pallas_call :64, and :95 on the (rows/2, 128) view of the same bytes),
// copy_t_contig_kernel (:53; :67) and copy_t_slab_kernel (:56; :72).  On
// the TPU the two views contrasted half-empty and full vector registers;
// here they give two mappings of lanes to rows (K · 2 / 16 lanes a row, as
// K7's fetch maps them), and copy_t_contig is copy_t_slab with one block
// row of bw = rows blocks.
//
// What bounds them: one read and one write of the stream, 2 × 134,217,728
// bytes at the probe's (1,048,576, 64), 0.0801 ms at 3.35 TB/s.
//
// Design: K7's movement without its decode.  Persistent CTAs of 128
// threads (as many as fit on the SMs) walk the tiles; a ring of two tiles
// in shared memory keeps the next tile's 16-byte cp.async copies in flight
// while the current one is stored.  Each thread copies its own pieces into
// the ring and reads only those back, so the ring needs no CTA barrier.
// copy_rm: a tile is 512 pieces (8 KiB, K7's luma word tile) of whole
// rows, stored back row-major as 16-byte vectors.  The transposes: a tile
// is 64 rows (blocks) × up to 64 columns of K (K7's [K][64] tile; wider
// K is cut into groups of 64 columns); piece q of a tile is row q / (K/8),
// columns 8 (q % (K/8)) .. + 7, as in K7; each thread writes its pieces'
// values into a transposed [K][64] tile whose 16-byte chunks are
// XOR-swizzled by k / 8 (K7's swz), and after one CTA barrier the tile is
// stored as 16-byte vectors, plane row by plane row.  Two output tiles
// alternate.  A source that is not 16-byte aligned is read element by
// element; a chunk past the row's end, or a plane whose rows are not
// 16-byte aligned (bw % 8 ≠ 0), is stored element by element.

#include "expand16_plane.cuh"  // K7's swz, column_of, Lane16, cp.async

namespace {

constexpr int kThreads = 128;
constexpr int kStages = 2;     // tiles of input in the ring
constexpr int kPieces = 512;   // copy_rm: 16-byte pieces of a tile
constexpr int kCols = 64;      // transposes: columns of K in a tile
constexpr int kMineRm = kPieces / kThreads;           // pieces a thread
constexpr int kMineT = kTile * kCols / 8 / kThreads;  // pieces a thread

// 8 int16 values: one 16-byte cp.async when aligned, else 8 loads.
template <bool Vec>
__device__ __forceinline__ void fetch8(uint16_t* dst, const int16_t* src) {
  if constexpr (Vec) {
    copy_async<16>(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) copy_async<2>(dst + e, src + e);
  }
}

// Tile t of a grid with `units` tiles a row is (t / units, t % units).  A
// CTA walks t = blockIdx.x, + gridDim.x, ...: the coordinates advance by
// (step_a, step_b) with a carry, with no 64-bit division in the loop.
struct At {
  long long a, b;
};

struct Walk {
  long long units, step_a, step_b;
  __device__ explicit Walk(long long n)
      : units(n), step_a(gridDim.x / n), step_b(gridDim.x % n) {}
  __device__ At at(long long t) const { return At{t / units, t % units}; }
  __device__ void advance(At& p) const {
    p.a += step_a;
    p.b += step_b;
    if (p.b >= units) {
      p.b -= units;
      ++p.a;
    }
  }
};

// copy_rm: rows of `cols` int16 (cols % 8 == 0).  A tile is tile_rows
// whole rows of pg pieces, or, for rows of more than 512 pieces, one row's
// group of 512.
template <bool Vec>
__global__ void __launch_bounds__(kThreads)
    copy_rm_kernel(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                   long long rows, int cols) {
  __shared__ alignas(16) uint16_t ring[kStages][kPieces * 8];
  const int p_row = cols / 8;
  const int pg = p_row < kPieces ? p_row : kPieces;
  const int groups = (p_row + pg - 1) / pg;
  const int tile_rows = kPieces / pg;
  int prow[kMineRm], pcol[kMineRm];  // this thread's pieces of a tile
#pragma unroll
  for (int i = 0; i < kMineRm; ++i) {
    const int q = threadIdx.x + i * kThreads;
    prow[i] = q / pg;
    pcol[i] = q % pg;
  }
  const long long row_tiles = (rows + tile_rows - 1) / tile_rows;
  const Walk walk(groups);
  // Element offset of piece i of tile p, or -1 past the rows or the row.
  auto offset = [&](At p, int i) -> long long {
    const long long row = p.a * tile_rows + prow[i];
    const int c = static_cast<int>(p.b) * pg + pcol[i];
    if (prow[i] >= tile_rows || row >= rows || c >= p_row) return -1;
    return row * cols + c * 8;
  };
  auto fetch = [&](At p, int st) {
#pragma unroll
    for (int i = 0; i < kMineRm; ++i) {
      const long long off = offset(p, i);
      if (off >= 0)
        fetch8<Vec>(&ring[st][(threadIdx.x + i * kThreads) * 8], in + off);
    }
  };

  At ahead = walk.at(blockIdx.x);
  if (ahead.a < row_tiles) fetch(ahead, 0);
  commit_copies();
  walk.advance(ahead);
  int st = 0;
  for (At cur = walk.at(blockIdx.x); cur.a < row_tiles; walk.advance(cur)) {
    if (ahead.a < row_tiles) fetch(ahead, st ^ 1);
    commit_copies();
    walk.advance(ahead);
    wait_copies<kStages - 1>();  // this thread's copies of tile cur landed
#pragma unroll
    for (int i = 0; i < kMineRm; ++i) {
      const long long off = offset(cur, i);
      if (off < 0) continue;
      Lane16<8> x;
      x.v = *reinterpret_cast<const uint4*>(
          &ring[st][(threadIdx.x + i * kThreads) * 8]);
      if constexpr (Vec) {
        *reinterpret_cast<uint4*>(out + off) = x.v;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[off + e] = static_cast<int16_t>(x.h[e]);
      }
    }
    st ^= 1;
  }
}

// The transposes: (bh · bw, k) → (bh, k, bw), k % 8 == 0.  Tile (a, u) is
// block row a, blocks 64 (u / groups) .. + 63, columns 64 (u % groups) ..
// + 63 of k.
template <bool VecIn>
__global__ void __launch_bounds__(kThreads)
    copy_t_kernel(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                  long long bh, long long bw, int k, bool vec_out) {
  __shared__ alignas(16) uint16_t ring[kStages][kTile * kCols];
  __shared__ alignas(16) int16_t tile[2][kCols * kTile];
  const int kg = k < kCols ? k : kCols;  // columns of a full group
  const int pg = kg / 8;                 // pieces of a row in a group
  const int groups = (k + kCols - 1) / kCols;
  int pblk[kMineT], pchunk[kMineT];  // this thread's pieces: block, chunk
#pragma unroll
  for (int i = 0; i < kMineT; ++i) {
    const int q = threadIdx.x + i * kThreads;
    pblk[i] = q / pg;
    pchunk[i] = q % pg;
  }
  const long long row_tiles = (bw + kTile - 1) / kTile;
  const Walk walk(row_tiles * groups);
  struct Tile {
    long long a, b0;  // block row, its first block
    int c0;           // first column of k
  };
  auto tile_of = [&](At p) {
    const long long b = groups == 1 ? p.b : p.b / groups;
    const int g = groups == 1 ? 0 : static_cast<int>(p.b - b * groups);
    return Tile{p.a, b * kTile, g * kCols};
  };
  // Element offset of piece i of tile t in the input, or -1 outside it.
  auto offset = [&](const Tile& t, int i) -> long long {
    const int c = t.c0 + pchunk[i] * 8;
    if (pblk[i] >= kTile || t.b0 + pblk[i] >= bw || c >= k) return -1;
    return (t.a * bw + t.b0 + pblk[i]) * k + c;
  };
  auto fetch = [&](At p, int st) {
    const Tile t = tile_of(p);
#pragma unroll
    for (int i = 0; i < kMineT; ++i) {
      const long long off = offset(t, i);
      if (off >= 0)
        fetch8<VecIn>(&ring[st][pblk[i] * kg + pchunk[i] * 8], in + off);
    }
  };

  At ahead = walk.at(blockIdx.x);
  if (ahead.a < bh) fetch(ahead, 0);
  commit_copies();
  walk.advance(ahead);
  int st = 0, buf = 0;
  for (At cur = walk.at(blockIdx.x); cur.a < bh; walk.advance(cur)) {
    if (ahead.a < bh) fetch(ahead, st ^ 1);
    commit_copies();
    walk.advance(ahead);
    wait_copies<kStages - 1>();  // this thread's copies of tile cur landed
    const Tile t = tile_of(cur);
#pragma unroll
    for (int i = 0; i < kMineT; ++i) {
      if (offset(t, i) < 0) continue;
      Lane16<8> x;
      x.v = *reinterpret_cast<const uint4*>(
          &ring[st][pblk[i] * kg + pchunk[i] * 8]);
      int16_t* o = column_of(tile[buf], pchunk[i] * 8, pblk[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j * kTile] = static_cast<int16_t>(x.h[j]);
    }
    __syncthreads();  // the tile is whole; the other buffer is free
    const int16_t* tl = tile[buf];
    const int rows_here = k - t.c0 < kCols ? k - t.c0 : kCols;
    for (int i = threadIdx.x; i < rows_here * (kTile / 8); i += kThreads) {
      const int kl = i >> 3;
      const int c = (i & 7) * 8;
      const long long b = t.b0 + c;
      if (b >= bw) continue;
      int16_t* dst = out + (t.a * k + t.c0 + kl) * bw + b;
      const int16_t* src = tl + swz(kl, c);
      if (vec_out && b + 8 <= bw) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && b + e < bw; ++e) dst[e] = src[e];
      }
    }
    buf ^= 1;
    st ^= 1;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Persistent CTAs: as many as fit on the SMs, no more than `tiles`.
cudaError_t grid_for(const void* kernel, long long tiles, unsigned* ctas) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *ctas = static_cast<unsigned>(tiles < resident ? tiles : resident);
  return cudaSuccess;
}

bool bad_width(int k) { return k < 8 || k % 8; }

bool misaligned(const void* in, const void* out) {
  return reinterpret_cast<uintptr_t>(in) % 2 ||
         reinterpret_cast<uintptr_t>(out) % 2;
}

cudaError_t launch_t(const void* in, void* out, long long bh, long long bw,
                     int k, cudaStream_t stream) {
  const long long tiles =
      bh * ((bw + kTile - 1) / kTile) * ((k + kCols - 1) / kCols);
  const bool vec_in = aligned16(in);
  const void* kernel = vec_in ? reinterpret_cast<const void*>(copy_t_kernel<true>)
                              : reinterpret_cast<const void*>(copy_t_kernel<false>);
  unsigned ctas = 0;
  const cudaError_t err = grid_for(kernel, tiles, &ctas);
  if (err != cudaSuccess) return err;
  const bool vec_out = bw % 8 == 0 && aligned16(out);
  const auto* src = static_cast<const int16_t*>(in);
  auto* dst = static_cast<int16_t*>(out);
  if (vec_in)
    copy_t_kernel<true><<<ctas, kThreads, 0, stream>>>(src, dst, bh, bw, k,
                                                       vec_out);
  else
    copy_t_kernel<false><<<ctas, kThreads, 0, stream>>>(src, dst, bh, bw, k,
                                                        vec_out);
  return cudaGetLastError();
}

}  // namespace

// in: (rows, cols) int16, out: the same, both contiguous; cols ≥ 8 and a
// multiple of 8.  Each entry point launches on `stream` and returns the
// first CUDA error of the device and occupancy queries or the launch (0 on
// success), cudaErrorInvalidValue for a shape it does not take; never
// synchronises.
extern "C" int rle_expand_copy_rm_launch(const void* in, void* out,
                                         long long rows, int cols,
                                         void* stream) {
  if (bad_width(cols) || rows < 0) return cudaErrorInvalidValue;
  if (misaligned(in, out)) return cudaErrorMisalignedAddress;
  if (rows == 0) return cudaSuccess;
  const int p_row = cols / 8;
  const int pg = p_row < kPieces ? p_row : kPieces;
  const long long tile_rows = kPieces / pg;
  const long long tiles =
      (rows + tile_rows - 1) / tile_rows * ((p_row + pg - 1) / pg);
  const bool vec = aligned16(in) && aligned16(out);
  const void* kernel = vec ? reinterpret_cast<const void*>(copy_rm_kernel<true>)
                           : reinterpret_cast<const void*>(copy_rm_kernel<false>);
  unsigned ctas = 0;
  const cudaError_t err = grid_for(kernel, tiles, &ctas);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const int16_t*>(in);
  auto* dst = static_cast<int16_t*>(out);
  if (vec)
    copy_rm_kernel<true><<<ctas, kThreads, 0, s>>>(src, dst, rows, cols);
  else
    copy_rm_kernel<false><<<ctas, kThreads, 0, s>>>(src, dst, rows, cols);
  return cudaGetLastError();
}

// in: (rows, k) int16; out: (k, rows) int16.
extern "C" int rle_expand_copy_t_contig_launch(const void* in, void* out,
                                               long long rows, int k,
                                               void* stream) {
  if (bad_width(k) || rows < 0) return cudaErrorInvalidValue;
  if (misaligned(in, out)) return cudaErrorMisalignedAddress;
  if (rows == 0) return cudaSuccess;
  return launch_t(in, out, 1, rows, k, static_cast<cudaStream_t>(stream));
}

// in: (rows, k) int16, rows = bh · bw; out: (bh, k, bw) int16.
extern "C" int rle_expand_copy_t_slab_launch(const void* in, void* out,
                                             long long rows, int k,
                                             long long bw, void* stream) {
  if (bad_width(k) || rows < 0 || bw < 1 || rows % bw)
    return cudaErrorInvalidValue;
  if (misaligned(in, out)) return cudaErrorMisalignedAddress;
  if (rows == 0) return cudaSuccess;
  return launch_t(in, out, rows / bw, bw, k,
                  static_cast<cudaStream_t>(stream));
}

// Registers per thread, static shared memory per CTA and resident CTAs per
// SM of kernel 0 (copy_rm) or 1 (the transposes), 16-byte aligned routes;
// returns the first CUDA error.
extern "C" int rle_expand_copy_attributes(int kernel, int* regs, int* smem,
                                          int* ctas) {
  const void* fn =
      kernel == 0 ? reinterpret_cast<const void*>(copy_rm_kernel<true>)
      : kernel == 1 ? reinterpret_cast<const void*>(copy_t_kernel<true>)
                    : nullptr;
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *smem = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn, kThreads, 0);
}

extern "C" const char* rle_expand_copy_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
