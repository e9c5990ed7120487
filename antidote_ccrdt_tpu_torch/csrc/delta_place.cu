// K2: delta-table placement. For every stream entry (r, j) with keep[r, j]:
//     d_score[r, kid3[r, j], rank[r, j]] = s_score[r, j]   (and d_dc, d_ts)
// The caller allocates the tables filled with (NEG_INF, 0, 0); entries whose
// address falls outside [0, T) x [0, M) are dropped. Kept addresses are
// unique by construction (rank counts within a kid group), so no two
// threads write one cell and the result is deterministic.
//
// Replaces: antidote_ccrdt_tpu/ops/delta_place.py delta_place_pallas (:136,
// body _carry_walk_kernel :56), which computes the three `.at[kid3, rank3]
// .set(..., mode="drop")` scatters of models/topk_rmv_dense.py:593-622.
//
// Bound on the H100: bytes. The tables are written once (3 x R x T x M
// int32: 154 MB at the main path's R=32, T=100k, M=4) and the stream read
// once (5 int32 + 1 bool per entry: 22 MB at B=32768): about 52 us at
// 3.35 TB/s. The fill dominates; the scatter itself is 1M stores.
//
// Design: one thread per stream entry, three plain stores. The Pallas
// kernel's compaction sort and carry walk existed only to turn the scatter
// into MXU one-hot products over 128-address blocks; Hopper stores
// scattered int32s directly.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void delta_place_kernel(const int32_t* __restrict__ s_score,
                                   const int32_t* __restrict__ s_ts,
                                   const int32_t* __restrict__ s_dc,
                                   const int32_t* __restrict__ kid3,
                                   const int32_t* __restrict__ rank,
                                   const uint8_t* __restrict__ keep,
                                   int32_t* __restrict__ d_score,
                                   int32_t* __restrict__ d_dc,
                                   int32_t* __restrict__ d_ts, int64_t B,
                                   int64_t T, int64_t M, int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !keep[i]) return;
  int64_t k = kid3[i];
  int64_t m = rank[i];
  if (k < 0 || k >= T || m < 0 || m >= M) return;
  int64_t o = ((i / B) * T + k) * M + m;
  d_score[o] = s_score[i];
  d_dc[o] = s_dc[i];
  d_ts[o] = s_ts[i];
}

extern "C" int delta_place(const int32_t* s_score, const int32_t* s_ts,
                           const int32_t* s_dc, const int32_t* kid3,
                           const int32_t* rank, const uint8_t* keep,
                           int32_t* d_score, int32_t* d_dc, int32_t* d_ts,
                           int64_t R, int64_t B, int64_t T, int64_t M,
                           void* stream) {
  int64_t n = R * B;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  delta_place_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(s_score, s_ts, s_dc, kid3, rank,
                                               keep, d_score, d_dc, d_ts, B, T,
                                               M, n);
  return (int)cudaGetLastError();
}
