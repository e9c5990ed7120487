// K2: delta-table placement, output-stationary. Builds the three [R, T, M]
// tables of the add stream's kept entries:
//     d_score[r, kid[r, j], rank[r, j]] = s_score[r, j]   (and d_dc, d_ts)
// for every (r, j) with keep[r, j] and (kid, rank) inside [0, T) x [0, M);
// every other cell is (NEG_INF, 0, 0). The kernel writes every cell itself:
// the caller allocates the tables uninitialised.
//
// Precondition: each replica's kid[r, :] is nondecreasing (the add
// stream's sort key; entries that are not kept may carry any kid that
// keeps the order, such as the sentinel T at the tail). It is not checked
// on the device: a check would cost the caller a host sync. Broken, it
// misplaces entries but never writes outside the tables. Kept addresses
// are unique by construction (rank counts within a kid group), so no two
// threads write one cell and the result is deterministic.
//
// Replaces: antidote_ccrdt_tpu/ops/delta_place.py delta_place_pallas (:136,
// body _carry_walk_kernel :56), which computes the three `.at[kid3, rank3]
// .set(..., mode="drop")` scatters of models/topk_rmv_dense.py:593-622.
//
// Bound on the H100: bytes. The tables are written once (3 x R x T x M
// int32: 154 MB at the main path's R=32, T=100k, M=4) and the stream read
// once (5 int32 + 1 bool per entry: 22 MB at B=32768): about 0.052 ms at
// 3.35 TB/s.
//
// Design: one launch that writes every output byte once. Block b owns the
// ids [k0, k0 + Tt) of replica r (Tt * M = kTileCells cells per table; Tt =
// 256 at M = 4). Two warps find the block's stream range [lo, hi) with a
// 32-ary lower-bound search of the sorted kid (3 rounds of loads at
// B = 32768); meanwhile the block fills a 3 x Tt x M tile in shared memory
// with (NEG_INF, 0, 0). The block places the kept entries of [lo, hi) into
// the tile: one thread per entry for the first kThreads * kUnroll entries,
// in one round trip to memory; in a hot tile (a Zipf-hot id's run of
// thousands of entries, of which only the first M are kept) the rest by
// 16-entry chunks of `keep`, skipping unkept chunks at one load each. It
// then writes the tile out with 16-byte evict-first stores. No fill of the
// tables precedes it, and no cell is written twice. The Pallas kernel's
// compaction sort and carry walk existed to turn the scatter into MXU
// one-hot products.
//
// A block's stream work is a chain of dependent loads (the search, then
// the entries), so the kernel is bound by latency as well as by bytes: on
// the H100 the writes alone run at the rate of a plain fill, and the
// stream work overlaps them only in part. The tile, block and unroll sizes
// below were the fastest of those tried at the main path's Zipf(1.2)
// stream.
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileCells = 1024;  // Tt * M cells of each table per block
constexpr int kUnroll = 2;        // stream entries a thread loads at once
constexpr int32_t kNegInf = -2147483647;  // ops/dense_table.py NEG_INF

// First i in [0, n) with a[i] >= key, n if none, for a nondecreasing `a`.
// Called by a whole warp: each round probes 32 evenly spaced entries and
// keeps the one gap where the order crosses `key`. Every lane returns it.
__device__ int64_t warp_lower_bound(const int32_t* __restrict__ a, int64_t n,
                                    int64_t key) {
  const int64_t lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const bool below = p < hi && (int64_t)a[p] < key;
    const int64_t cnt = __popc(__ballot_sync(0xffffffffu, below));
    if (cnt == 0) {
      hi = lo;
    } else {
      const int64_t last = lo + (cnt - 1) * step;  // a[last] < key
      hi = last + step < hi ? last + step : hi;
      lo = last + 1;
    }
  }
  return lo;
}

// A kept entry's values into the block's tile, if its address lies in it.
__device__ __forceinline__ void place(int32_t (&tile)[3][kTileCells],
                                      int64_t k, int64_t m, int32_t score,
                                      int32_t dc, int32_t ts, int64_t k0,
                                      int64_t k1, int64_t M) {
  if (k < k0 || k >= k1 || m < 0 || m >= M) return;
  const int64_t c = (k - k0) * M + m;
  tile[0][c] = score;
  tile[1][c] = dc;
  tile[2][c] = ts;
}

__global__ void __launch_bounds__(kThreads)
    delta_place_kernel(const int32_t* __restrict__ s_score,
                       const int32_t* __restrict__ s_ts,
                       const int32_t* __restrict__ s_dc,
                       const int32_t* __restrict__ kid,
                       const int32_t* __restrict__ rank,
                       const uint8_t* __restrict__ keep,
                       int32_t* __restrict__ d_score,
                       int32_t* __restrict__ d_dc, int32_t* __restrict__ d_ts,
                       int64_t R, int64_t B, int64_t T, int64_t M,
                       int64_t Tt) {
  __shared__ __align__(16) int32_t tile[3][kTileCells];
  __shared__ int64_t range[2];
  const int64_t r = blockIdx.x % R;
  const int64_t k0 = (blockIdx.x / R) * Tt;
  const int64_t k1 = k0 + Tt < T ? k0 + Tt : T;
  const int64_t n = (k1 - k0) * M;
  const int64_t row = r * B;

  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t at = warp_lower_bound(kid + row, B, warp == 0 ? k0 : k1);
    if ((threadIdx.x & 31) == 0) range[warp] = at;
  }
  const int4 empty[3] = {make_int4(kNegInf, kNegInf, kNegInf, kNegInf),
                         make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
  for (int64_t i = threadIdx.x; i < (n + 3) >> 2; i += kThreads) {
#pragma unroll
    for (int t = 0; t < 3; ++t) reinterpret_cast<int4*>(tile[t])[i] = empty[t];
  }
  __syncthreads();

  // The first kThreads * kUnroll entries of [lo, hi): one thread per entry,
  // every field loaded whether kept or not, so the loads are independent
  // and a tile's usual few dozen entries cost one round trip to memory.
  // (Loading `keep` first and the rest only for kept entries costs round
  // trips in series, and the block's latency, not the bytes, then bounds
  // the kernel.)
  const int64_t lo = range[0], hi = range[1];
  const int64_t mid = lo + kThreads * kUnroll < hi ? lo + kThreads * kUnroll : hi;
  {
    uint8_t kp[kUnroll];
    int32_t kk[kUnroll], mm[kUnroll], sc[kUnroll], dcv[kUnroll], tsv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = lo + threadIdx.x + u * kThreads;
      const bool in = j < mid;
      kp[u] = in ? keep[row + j] : 0;
      kk[u] = in ? kid[row + j] : 0;
      mm[u] = in ? rank[row + j] : 0;
      sc[u] = in ? s_score[row + j] : 0;
      dcv[u] = in ? s_dc[row + j] : 0;
      tsv[u] = in ? s_ts[row + j] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (kp[u]) place(tile, kk[u], mm[u], sc[u], dcv[u], tsv[u], k0, k1, M);
  }

  // The rest, [mid, hi), exists in hot tiles only: at Zipf(1.2) three
  // quarters of a replica's stream falls in its first tile, hot-id runs of
  // which only the first M entries are kept. It is read as 16-byte chunks
  // of `keep` aligned in memory, so unkept entries cost a sixteenth of a
  // load each. A chunk may reach past [mid, hi) (masked) but not past the
  // 16-byte aligned block that holds a byte of the tensor, so it stays in
  // its allocation.
  const uintptr_t base = reinterpret_cast<uintptr_t>(keep + row);
  for (uintptr_t a = ((base + mid) & ~uintptr_t(15)) + 16 * threadIdx.x;
       a < base + hi; a += 16 * kThreads) {
    const uint4 w = *reinterpret_cast<const uint4*>(a);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int64_t j = (int64_t)(a - base) + q;
      if (((words[q >> 2] >> (8 * (q & 3))) & 0xffu) == 0 || j < mid || j >= hi)
        continue;
      place(tile, kid[row + j], rank[row + j], s_score[row + j],
            s_dc[row + j], s_ts[row + j], k0, k1, M);
    }
  }
  __syncthreads();

  const int64_t off = (r * T + k0) * M;
  copy_cells<true, 1>(d_score + off, tile[0], n);
  copy_cells<true, 1>(d_dc + off, tile[1], n);
  copy_cells<true, 1>(d_ts + off, tile[2], n);
}

}  // namespace

extern "C" int delta_place(const int32_t* s_score, const int32_t* s_ts,
                           const int32_t* s_dc, const int32_t* kid,
                           const int32_t* rank, const uint8_t* keep,
                           int32_t* d_score, int32_t* d_dc, int32_t* d_ts,
                           int64_t R, int64_t B, int64_t T, int64_t M,
                           void* stream) {
  if (M < 1 || M > kTileCells) return (int)cudaErrorInvalidValue;
  const int64_t Tt = kTileCells / M;
  const int64_t blocks = R * ((T + Tt - 1) / Tt);
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  delta_place_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(s_score, s_ts, s_dc, kid, rank,
                                               keep, d_score, d_dc, d_ts, R,
                                               B, T, M, Tt);
  return (int)cudaGetLastError();
}
