// K3: per-row slot sort, dedup and keep, with the add-wins filter fused in
// front when a tombstone table is given. For each row (r, nk, i):
//
//   1. load the W = wa + wb <= 16 candidates (score, dc, ts): wa from side a,
//      wb from side b (the two slot lists of a join, read in place, never
//      concatenated in device memory);
//   2. fused only: a candidate survives iff ts > dom, where dom is
//      max(rmv_vc[row, dc], 0) for 0 <= dc < D and 0 otherwise; a dead one
//      becomes (NEG_INF, 0, 0) and ranks after every live candidate;
//   3. sort best-first by (score desc, ts desc, dc asc), compared directly
//      (no negation), with an odd-even network in registers;
//   4. blank each exact duplicate of its predecessor that has ts > 0;
//   5. sort again and write the first m_keep slots, plus n_live = the
//      number of slots with ts > 0.
//
// Replaces: antidote_ccrdt_tpu/ops/pallas_kernels.py sort_slots_pallas
// (:150, body _sort_slots_kernel :112, compare _cmpx_desc :98), which is
// steps 3-5. Fused, it computes _join_slots_union
// (models/topk_rmv_dense.py:246) for sides that keep the slot invariant
// (sorted, no duplicate within a side): the join of apply_ops (:631) and of
// merge (:689).
//
// Bound on the H100: bytes. At the main path's shapes (N = 32 x 100k rows,
// M = 4 per side, D = 32) the fused call reads 6 x N x 4 int32 of slots and
// the N x 32 int32 tombstone table (0.72 GB) and writes 3 x N x 4 int32
// plus N int32 (0.17 GB): about 0.26 ms at 3.35 TB/s. The two networks are
// 38 compare-exchanges of a few integer operations per row, far below the
// card's integer rate.
//
// Design: one thread per row, the candidates and their liveness in
// registers (the network's indices are compile-time constants). Virtual
// candidates beyond W carry live = -1 and sort last, so the 8-input network
// serves every W <= 8 (the main path's 2M = 8) and the 16-input one every
// W <= 16. The TPU kernel's [tile, W] -> [W, tile] transposes in VMEM have
// no counterpart: a thread owns its row.
#include <cstdint>
#include <cuda_runtime.h>

#define NEG_INF (-2147483647)

struct Slot {
  int32_t s, d, t, live;
};

// a strictly better than b: live desc, then score desc, ts desc, dc asc.
__device__ __forceinline__ bool better(const Slot& a, const Slot& b) {
  if (a.live != b.live) return a.live > b.live;
  if (a.s != b.s) return a.s > b.s;
  if (a.t != b.t) return a.t > b.t;
  return a.d < b.d;
}

__device__ __forceinline__ void cmpx(Slot& a, Slot& b) {
  bool swap = better(b, a);
  Slot hi = swap ? b : a;
  Slot lo = swap ? a : b;
  a = hi;
  b = lo;
}

// Batcher odd-even mergesort for 8 inputs (oddeven_network(8)).
#define NET8(X)                                                            \
  X(0, 1) X(2, 3) X(0, 2) X(1, 3) X(1, 2) X(4, 5) X(6, 7) X(4, 6) X(5, 7) \
  X(5, 6) X(0, 4) X(2, 6) X(2, 4) X(1, 5) X(3, 7) X(3, 5) X(1, 2) X(3, 4) \
  X(5, 6)
// Batcher odd-even mergesort for 16 inputs (oddeven_network(16)).
#define NET16(X) \
  X(0, 1) X(2, 3) X(0, 2) X(1, 3) X(1, 2) X(4, 5) X(6, 7) X(4, 6) X(5, 7) \
  X(5, 6) X(0, 4) X(2, 6) X(2, 4) X(1, 5) X(3, 7) X(3, 5) X(1, 2) X(3, 4) \
  X(5, 6) X(8, 9) X(10, 11) X(8, 10) X(9, 11) X(9, 10) X(12, 13) \
  X(14, 15) X(12, 14) X(13, 15) X(13, 14) X(8, 12) X(10, 14) X(10, 12) \
  X(9, 13) X(11, 15) X(11, 13) X(9, 10) X(11, 12) X(13, 14) X(0, 8) \
  X(4, 12) X(4, 8) X(2, 10) X(6, 14) X(6, 10) X(2, 4) X(6, 8) X(10, 12) \
  X(1, 9) X(5, 13) X(5, 9) X(3, 11) X(7, 15) X(7, 11) X(3, 5) X(7, 9) \
  X(11, 13) X(1, 2) X(3, 4) X(5, 6) X(7, 8) X(9, 10) X(11, 12) X(13, 14)
#define CMPX(i, j) cmpx(v[i], v[j]);

template <int P>
__device__ __forceinline__ void network(Slot* v);
template <>
__device__ __forceinline__ void network<8>(Slot* v) {
  NET8(CMPX)
}
template <>
__device__ __forceinline__ void network<16>(Slot* v) {
  NET16(CMPX)
}

template <int P>
__global__ void sort_slots_kernel(
    const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_d,
    const int32_t* __restrict__ a_t, int wa, const int32_t* __restrict__ b_s,
    const int32_t* __restrict__ b_d, const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D, int32_t* __restrict__ o_s,
    int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t N, int m_keep) {
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const bool fused = rmv_vc != nullptr;
  Slot v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    Slot x;
    if (i < wa) {
      int64_t o = row * wa + i;
      x.s = a_s[o];
      x.d = a_d[o];
      x.t = a_t[o];
      x.live = 1;
    } else if (i < wa + wb) {
      int64_t o = row * wb + (i - wa);
      x.s = b_s[o];
      x.d = b_d[o];
      x.t = b_t[o];
      x.live = 1;
    } else {
      x.s = NEG_INF;
      x.d = 0;
      x.t = 0;
      x.live = -1;
    }
    if (fused && x.live == 1) {
      int32_t dom = 0;
      if (x.d >= 0 && x.d < D) dom = max(rmv_vc[row * D + x.d], 0);
      if (!(x.t > dom)) {
        x.s = NEG_INF;
        x.d = 0;
        x.t = 0;
        x.live = 0;
      }
    }
    v[i] = x;
  }
  network<P>(v);
  // Equal triples are adjacent now; compare each with its predecessor
  // before that one is touched (top down), as the TPU kernel does.
#pragma unroll
  for (int i = P - 1; i > 0; --i) {
    bool dup = v[i].s == v[i - 1].s && v[i].t == v[i - 1].t &&
               v[i].d == v[i - 1].d && v[i].t > 0;
    if (dup) {
      v[i].s = NEG_INF;
      v[i].d = 0;
      v[i].t = 0;
      v[i].live = fused ? 0 : 1;
    }
  }
  network<P>(v);
  int32_t nl = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) nl += v[i].t > 0 ? 1 : 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < m_keep) {
      int64_t o = row * m_keep + i;
      o_s[o] = v[i].s;
      o_d[o] = v[i].d;
      o_t[o] = v[i].t;
    }
  }
  n_live[row] = nl;
}

// W = wa + wb <= 16 and 1 <= m_keep <= W are checked by the caller.
extern "C" int sort_slots(const int32_t* a_s, const int32_t* a_d,
                          const int32_t* a_t, int wa, const int32_t* b_s,
                          const int32_t* b_d, const int32_t* b_t, int wb,
                          const int32_t* rmv_vc, int D, int32_t* o_s,
                          int32_t* o_d, int32_t* o_t, int32_t* n_live,
                          int64_t N, int m_keep, void* stream) {
  const int threads = 256;
  unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (wa + wb <= 8)
    sort_slots_kernel<8><<<blocks, threads, 0, s>>>(
        a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t,
        n_live, N, m_keep);
  else
    sort_slots_kernel<16><<<blocks, threads, 0, s>>>(
        a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t,
        n_live, N, m_keep);
  return (int)cudaGetLastError();
}
