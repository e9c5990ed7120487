// The tombstone row scatter-max, in two entry points:
//
// K1 (scatter_max_rows), in place:
//     table[r, rows[r, j], d] = max(table[r, rows[r, j], d], upd[r, j, d])
// K1c (scatter_max_rows_copy), out of place, `table` not written:
//     out[r] = table[r], then the same row-wise max of this batch's updates
// for every (r, j, d) with 0 <= rows[r, j] < T; other rows are dropped and
// duplicate rows are allowed (integer max commutes and is exact, so the
// result does not depend on the order of the updates).
//
// Replaces: antidote_ccrdt_tpu/ops/pallas_kernels.py scatter_max_rows_pallas
// (:254, body :198; aliased, so in place: K1) and
// scatter_max_rows_onehot_pallas (:332, body :291; each grid step reads a
// table tile and writes a fresh output tile: K1c), and
// benchmarks/micro_tombstone.py pallas_bf16 (:77). All compute this
// function; the TPU engine's production version is the one-hot MXU matmul
// ops/dense_table.py scatter_max_rows_mxu, called at
// models/topk_rmv_dense.py:454, whose functional form the port's main
// path (ops/dense_table.py scatter_max_rows) launches as K1c.
//
// K1. Bound on the H100: bytes. It reads and writes the touched table rows
// and reads the rows and updates: at the main path's shapes (R=32,
// Br=2048, D=32) about 25 MB, 7.5 us at 3.35 TB/s. Design: one thread per
// (r, j, d), an int32 atomicMax into the table. Duplicate rows need
// neither the TPU kernels' dedup pre-pass nor the one-hot and its 7-bit
// value planes. Neighbouring threads take neighbouring d, so a warp's loads
// of `upd` and its atomics on one table row are coalesced.
//
// K1c. Bound on the H100: bytes. It reads the table and writes `out` once
// (409.6 MB each at R=32, T=100k, D=32) and reads the rows and updates
// (8.4 MB): about 0.247 ms at 3.35 TB/s. Design: one pass that writes
// every output cell once and then only the touched cells again, in L2.
// Block b owns rows [t0, t0 + Tt) of replica r (Tt * D = kCopyTileCells;
// Tt = 256 at D = 32). It copies its tile from `table` to `out` through
// registers, eight 16-byte vectors in flight per thread, while each warp
// has its share of the replica's Br row indices (8 KB, L2-resident) in
// flight too. After a block barrier each warp finds the rows that fall in
// the tile with __ballot_sync, reads the hits' update rows (D columns, 128
// coalesced bytes at D = 32) four at a time, and applies them with
// atomicMax on `out`; the tile's lines were just written and sit in L2.
// Removals are Zipf-drawn too, so a replica's first tile holds most of its
// rows. The table is read through its replica stride, which may be 0:
// after a sync DenseReplay's replicas are one row seen R times, and K1c
// reads that row R times, mostly from L2, instead of a copy of it
// materialised first. (Staging the tile in shared memory and applying the
// hits there was slower on the H100, on both a contiguous table and a
// broadcast view: the shared-memory round trip lengthens each block.)
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

__global__ void scatter_max_rows_kernel(int32_t* __restrict__ table,
                                        const int32_t* __restrict__ rows,
                                        const int32_t* __restrict__ upd,
                                        int64_t T, int64_t D, int64_t B,
                                        int64_t n) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t rj = i / D;  // r * B + j
  int64_t d = i - rj * D;
  int64_t r = rj / B;
  int32_t row = rows[rj];
  if (row < 0 || (int64_t)row >= T) return;
  atomicMax(table + (r * T + row) * D + d, upd[i]);
}

namespace {

constexpr int kCopyThreads = 256;
constexpr int kCopyTileCells = 8192;  // Tt * D cells per block
constexpr int kRowsPerLane = 8;       // row indices a lane holds in flight
constexpr int kHitsInFlight = 4;      // update rows a warp loads at once

// Row indices c0 + i * 32 + lane (i < kRowsPerLane) of one replica; -1,
// which no tile holds, past its end.
__device__ __forceinline__ void load_rows(int32_t (&rv)[kRowsPerLane],
                                          const int32_t* __restrict__ rows,
                                          int64_t B, int64_t c0) {
  const int64_t lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowsPerLane; ++i) {
    const int64_t j = c0 + i * 32 + lane;
    rv[i] = j < B ? rows[j] : -1;
  }
}

__global__ void __launch_bounds__(kCopyThreads)
    scatter_max_rows_copy_kernel(const int32_t* __restrict__ table,
                                 int64_t rstride,
                                 const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ upd,
                                 int32_t* __restrict__ out, int64_t R,
                                 int64_t T, int64_t D, int64_t B, int64_t Tt) {
  const int64_t r = blockIdx.x % R;
  const int64_t t0 = (blockIdx.x / R) * Tt;
  const int64_t t1 = t0 + Tt < T ? t0 + Tt : T;
  const int64_t lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)(blockDim.x >> 5) * 32 * kRowsPerLane;
  const int32_t* rows_r = rows + r * B;

  int64_t c0 = (int64_t)(threadIdx.x >> 5) * 32 * kRowsPerLane;
  int32_t rv[kRowsPerLane];
  load_rows(rv, rows_r, B, c0);  // in flight during the tile copy
  copy_cells(out + (r * T + t0) * D, table + r * rstride + t0 * D,
             (t1 - t0) * D);
  // The barrier orders the block's copy of the tile before its atomics on
  // the tile (it is a memory fence for device memory within the block).
  __syncthreads();

  while (c0 < B) {
#pragma unroll
    for (int i = 0; i < kRowsPerLane; ++i) {
      unsigned hits = __ballot_sync(0xffffffffu, rv[i] >= t0 && rv[i] < t1);
      while (hits) {
        // Up to kHitsInFlight hits at once, their update rows loaded
        // together before the atomics.
        int64_t j[kHitsInFlight], row[kHitsInFlight];
        int cnt = 0;
#pragma unroll
        for (int h = 0; h < kHitsInFlight; ++h) {
          const int src = hits ? __ffs(hits) - 1 : 0;
          row[h] = __shfl_sync(0xffffffffu, rv[i], src);
          j[h] = c0 + i * 32 + src;
          if (hits) ++cnt;
          hits &= hits - 1;
        }
        for (int64_t d = lane; d < D; d += 32) {
          int32_t v[kHitsInFlight];
#pragma unroll
          for (int h = 0; h < kHitsInFlight; ++h)
            if (h < cnt) v[h] = upd[(r * B + j[h]) * D + d];
#pragma unroll
          for (int h = 0; h < kHitsInFlight; ++h)
            if (h < cnt) atomicMax(out + (r * T + row[h]) * D + d, v[h]);
        }
      }
    }
    c0 += stride;
    load_rows(rv, rows_r, B, c0);
  }
}

}  // namespace

extern "C" int scatter_max_rows(int32_t* table, const int32_t* rows,
                                const int32_t* upd, int64_t R, int64_t T,
                                int64_t D, int64_t B, void* stream) {
  int64_t n = R * B * D;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  scatter_max_rows_kernel<<<(unsigned int)blocks, threads, 0,
                            (cudaStream_t)stream>>>(table, rows, upd, T, D, B,
                                                    n);
  return (int)cudaGetLastError();
}

extern "C" int scatter_max_rows_copy(const int32_t* table, int64_t rstride,
                                     const int32_t* rows, const int32_t* upd,
                                     int32_t* out, int64_t R, int64_t T,
                                     int64_t D, int64_t B, void* stream) {
  if (D < 1 || D > kCopyTileCells) return (int)cudaErrorInvalidValue;
  const int64_t Tt = kCopyTileCells / D;
  const int64_t blocks = R * ((T + Tt - 1) / Tt);
  if (blocks == 0) return 0;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  scatter_max_rows_copy_kernel<<<(unsigned int)blocks, kCopyThreads, 0,
                                 (cudaStream_t)stream>>>(
      table, rstride, rows, upd, out, R, T, D, B, Tt);
  return (int)cudaGetLastError();
}
