// K1: tombstone row scatter-max, in place:
//     table[r, rows[r, j], d] = max(table[r, rows[r, j], d], upd[r, j, d])
// for every (r, j, d) with 0 <= rows[r, j] < T; other rows are dropped.
//
// Replaces: antidote_ccrdt_tpu/ops/pallas_kernels.py scatter_max_rows_pallas
// (:254, body :198) and scatter_max_rows_onehot_pallas (:332, body :291), and
// benchmarks/micro_tombstone.py pallas_bf16 (:77): all three compute this
// function (the TPU engine's production version is the one-hot MXU matmul
// ops/dense_table.py scatter_max_rows_mxu, called at
// models/topk_rmv_dense.py:454).
//
// Bound on the H100: bytes. The function must read and write the touched
// table rows and read the rows and updates: at the main path's shapes
// (R=32, Br=2048, D=32) about 25 MB, 7.5 us at 3.35 TB/s. The functional
// copy the caller makes first (the state is immutable) moves 0.82 GB and
// is the real cost of the step.
//
// Design: one thread per (r, j, d), an int32 atomicMax into the table.
// Integer max commutes and is exact, so duplicate rows need neither the
// TPU kernels' dedup pre-pass nor the one-hot and its 7-bit value planes,
// and the result does not depend on the order of the atomics. Neighbouring
// threads take neighbouring d, so a warp's loads of `upd` and its atomics
// on one table row are coalesced.
#include <cstdint>
#include <cuda_runtime.h>

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
