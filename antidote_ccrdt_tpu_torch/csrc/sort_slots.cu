// K3: per-row slot sort, dedup and keep, with the add-wins filter fused in
// front when a tombstone table is given. For each row (r, nk, i):
//
//   1. load the W = wa + wb candidates (score, dc, ts): wa from side a, wb
//      from side b (the two slot lists of a join, read in place, never
//      concatenated in device memory);
//   2. fused only: a candidate survives iff ts > dom, where dom is
//      max(rmv_vc[row, dc], 0) for 0 <= dc < D and 0 otherwise; a dead one
//      becomes (NEG_INF, 0, 0) and ranks after every live candidate;
//   3. sort best-first by (score desc, ts desc, dc asc), compared directly
//      (no negation);
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
// Four paths compute the same function; the caller picks one by W:
//
// * sort_slots_kernel<8>, W <= 8 (the replay's 2M = 8): one thread per
//   row, the candidates and their liveness in registers, Batcher's 8-input
//   odd-even network with compile-time indices. Virtual candidates beyond W
//   carry live = -1 and sort last.
// * sort_slots_warp_kernel<P>, 8 < W <= 256, P = next_pow2(W) >= 16
//   (batch_merge's converter at W = M and its fold at W = 2M). Persistent
//   blocks walk over tiles of rows; each tile is loaded with 16-byte
//   asynchronous copies into shared memory while the one before is worked
//   on, and written out with 16-byte stores, so every global access is
//   coalesced. A thread a row first finds the rows that need no sort
//   (fused, no candidate with ts > 0; unfused, every candidate the same
//   with ts <= 0: m_keep copies, which is most of batch_merge's rows) and
//   queues the rest; fused, the queued rows' tombstone bounds are then
//   gathered block-wide. Warps take the queued rows: L = min(P, 32) lanes
//   a row, P / L candidates a lane in registers (two rows a warp at
//   P = 16), exchanged by warp shuffles. A row whose two sides are sorted
//   runs (the join of two canonical slot lists, survivors compacted
//   first) takes a bitonic merge of log2 P stages, any other the full
//   bitonic sort, chosen per warp. The second sort is replaced by
//   ballots: the kept slots stay sorted and every blank is one value, so
//   each kept slot goes to its rank among the kept, moved past the blanks
//   when it ranks after a blank.
// * sort_slots_block_kernel<false>, 256 < W <= 8192: a block of P / 8
//   threads per row, the row in shared memory (16 bytes a candidate;
//   8192 x 16 B is the largest power-of-two row in a block's 227 KB), a
//   bitonic sort, then the same placement by a block scan of three counts.
// * sort_slots_block_kernel<true>, W > 8192: the same with the row in a
//   device scratch of chunk_rows x P slots that the caller allocates;
//   rows go in chunks of chunk_rows, one launch each. Every index within a
//   row is an int: W <= 2^30.
//
// Bound on the H100: bytes. At the replay's shapes (N = 32 x 100k rows,
// M = 4 per side, D = 32) the fused call reads 6 x N x 4 int32 of slots and
// the N x 32 int32 tombstone table (0.72 GB) and writes 3 x N x 4 int32
// plus N int32 (0.17 GB): about 0.26 ms at 3.35 TB/s. A row whose
// candidates all have ts <= 0 reads no tombstone sector at all, so the
// bound that counts only the 32-byte sectors its live candidates need is
// lower (chip_smoke.py computes both). The sorts are O(P log^2 P)
// compare-exchanges per row of a few integer operations, far below the
// card's integer rate.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "tile_copy.cuh"

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

// Candidate i of a row: side a's slots, then side b's, then virtual ones
// (live = -1, ranked last); fused, the add-wins filter is applied here.
__device__ __forceinline__ Slot load_candidate(
    int i, int64_t row, const int32_t* __restrict__ a_s,
    const int32_t* __restrict__ a_d, const int32_t* __restrict__ a_t, int wa,
    const int32_t* __restrict__ b_s, const int32_t* __restrict__ b_d,
    const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D) {
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
  if (rmv_vc != nullptr && x.live == 1) {
    int32_t dom = 0;
    if (x.d >= 0 && x.d < D) dom = max(rmv_vc[row * D + x.d], 0);
    if (!(x.t > dom)) {
      x.s = NEG_INF;
      x.d = 0;
      x.t = 0;
      x.live = 0;
    }
  }
  return x;
}

// x is an exact duplicate of its sorted predecessor p, with ts > 0.
__device__ __forceinline__ bool is_dup(const Slot& x, const Slot& p) {
  return x.s == p.s && x.t == p.t && x.d == p.d && x.t > 0;
}

// Batcher odd-even mergesort for 8 inputs: the JAX package's
// oddeven_network(8) (ops/pallas_kernels.py:65), pair for pair.
#define NET8(X)                                                            \
  X(0, 1) X(2, 3) X(0, 2) X(1, 3) X(1, 2) X(4, 5) X(6, 7) X(4, 6) X(5, 7) \
  X(5, 6) X(0, 4) X(2, 6) X(2, 4) X(1, 5) X(3, 7) X(3, 5) X(1, 2) X(3, 4) \
  X(5, 6)
#define CMPX(i, j) cmpx(v[i], v[j]);

template <int P>
__global__ void sort_slots_kernel(
    const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_d,
    const int32_t* __restrict__ a_t, int wa, const int32_t* __restrict__ b_s,
    const int32_t* __restrict__ b_d, const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D, int32_t* __restrict__ o_s,
    int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t N, int m_keep) {
  static_assert(P == 8, "the register network is the 8-input one");
  int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const bool fused = rmv_vc != nullptr;
  Slot v[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    v[i] = load_candidate(i, row, a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D);
  NET8(CMPX)
  // Equal triples are adjacent now; compare each with its predecessor
  // before that one is touched (top down), as the TPU kernel does.
#pragma unroll
  for (int i = P - 1; i > 0; --i) {
    if (is_dup(v[i], v[i - 1])) {
      v[i].s = NEG_INF;
      v[i].d = 0;
      v[i].t = 0;
      v[i].live = fused ? 0 : 1;
    }
  }
  NET8(CMPX)
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

// --- warp path: 8 < W <= 256 ---------------------------------------------
//
// A candidate is three ints ordered by (s desc, t desc, d asc) alone; the
// liveness key goes into the values. Fused, a dead candidate (and a blank)
// is held as (INT32_MIN, 0, 0): it ranks after every survivor, whose ts is
// > 0, even one of score INT32_MIN, and it is written as (NEG_INF, 0, 0).
// A virtual candidate past W is (INT32_MIN, INT32_MIN, INT32_MAX), after
// every real one; only a real candidate equal to it ties, and the two are
// the same values.

struct Cand {
  int32_t s, t, d;
};

__device__ __forceinline__ bool cbetter(const Cand& a, const Cand& b) {
  if (a.s != b.s) return a.s > b.s;
  if (a.t != b.t) return a.t > b.t;
  return a.d < b.d;
}

__device__ __forceinline__ bool csame(const Cand& a, const Cand& b) {
  return a.s == b.s && a.t == b.t && a.d == b.d;
}

constexpr int32_t I32_MIN = -2147483647 - 1;
constexpr int32_t I32_MAX = 2147483647;
__device__ __forceinline__ Cand dead_cand() { return {I32_MIN, 0, 0}; }
__device__ __forceinline__ Cand virtual_cand() { return {I32_MIN, I32_MIN, I32_MAX}; }

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ Cand shfl_xor_c(const Cand& x, int m) {
  return {__shfl_xor_sync(FULL, x.s, m), __shfl_xor_sync(FULL, x.t, m),
          __shfl_xor_sync(FULL, x.d, m)};
}

// Each candidate's predecessor in row order i = e * L + l (the value at
// i = 0 is garbage; callers test i >= 1).
template <int L, int E>
__device__ __forceinline__ void predecessors(const Cand (&x)[E], Cand (&p)[E], int l) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    Cand up = {__shfl_up_sync(FULL, x[e].s, 1, L), __shfl_up_sync(FULL, x[e].t, 1, L),
               __shfl_up_sync(FULL, x[e].d, 1, L)};
    const Cand& w = x[e > 0 ? e - 1 : 0];
    Cand wrap = {__shfl_sync(FULL, w.s, L - 1, L), __shfl_sync(FULL, w.t, L - 1, L),
                 __shfl_sync(FULL, w.d, L - 1, L)};
    p[e] = l == 0 ? wrap : up;
  }
}

// Bitonic network over the row's P = E * L candidates, best first, from
// merge size K0: K0 = 2 sorts any row; K0 = P only merges, which sorts a
// bitonic row (such as a non-increasing run followed by a non-decreasing
// one). Partner i ^ j is a register of the same lane for j >= L and a lane
// of the same row (a shuffle) for j < L.
template <int P, int L, int K0>
__device__ __forceinline__ void bitonic(Cand (&x)[P / L], int l) {
  constexpr int E = P / L;
#pragma unroll
  for (int k = K0; k <= P; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= L) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int je = j / L;
          if ((e & je) != 0) continue;
          const bool desc = ((e * L) & k) == 0;
          Cand& a = x[e];
          Cand& b = x[e | je];
          if (desc ? cbetter(b, a) : cbetter(a, b)) {
            const Cand tmp = a;
            a = b;
            b = tmp;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * L + l;
          const Cand y = shfl_xor_c(x[e], j);
          const bool want_better = ((i & j) == 0) == ((i & k) == 0);
          if (want_better == cbetter(y, x[e])) x[e] = y;
        }
      }
    }
  }
}

// Sizes from a sweep on the H100 at batch_merge's W = 13 and W = 26.
constexpr int WARP_BLOCK = 128;             // threads of a warp-path block
constexpr int WARP_MIN_BLOCKS = 5;          // blocks an SM must hold (caps registers)
constexpr int WARP_TILE_BYTES = 40 * 1024;  // shared memory of a block's rows

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

// A block's staged input rows: side a's three columns, then side b's.
struct InTile {
  int32_t *as, *ad, *at, *bs, *bd, *bt;
};

// Shared-memory layout of a warp-path block of RB rows (int32 cells, each
// region 16-byte aligned): two input tiles (one filled while the other is
// read), the three output tiles and n_live, the queue of the rows that
// need a sort and its length, per warp max(P, 32) cells of compaction
// scratch and, fused, each candidate's tombstone bound.
struct WarpTile {
  InTile in0, in1;
  int32_t *os, *od, *ot, *nl, *queue, *qn, *idx, *doma, *domb;
};

__host__ __device__ __forceinline__ int warp_tile_cells(int RB, int wa, int wb, int m, int P,
                                                        bool fused) {
  return 6 * up4(RB * wa) + 6 * up4(RB * wb) + 3 * up4(RB * m) + 2 * up4(RB) + 4 +
         (WARP_BLOCK / 32) * (P < 32 ? 32 : P) + (fused ? up4(RB * wa) + up4(RB * wb) : 0);
}

__device__ __forceinline__ InTile carve_in(int32_t*& p, int RB, int wa, int wb) {
  InTile t;
  t.as = p; p += up4(RB * wa);
  t.ad = p; p += up4(RB * wa);
  t.at = p; p += up4(RB * wa);
  t.bs = p; p += up4(RB * wb);
  t.bd = p; p += up4(RB * wb);
  t.bt = p; p += up4(RB * wb);
  return t;
}

__device__ __forceinline__ WarpTile carve(int32_t* p, int RB, int wa, int wb, int m, int P) {
  WarpTile t;
  t.in0 = carve_in(p, RB, wa, wb);
  t.in1 = carve_in(p, RB, wa, wb);
  t.os = p; p += up4(RB * m);
  t.od = p; p += up4(RB * m);
  t.ot = p; p += up4(RB * m);
  t.nl = p; p += up4(RB);
  t.queue = p; p += up4(RB);
  t.qn = p; p += 4;
  t.idx = p; p += (WARP_BLOCK / 32) * (P < 32 ? 32 : P);
  t.doma = p; p += up4(RB * wa);
  t.domb = p;
  return t;
}

// n int32 cells from device memory to shared memory by the whole block, as
// asynchronous copies (cp.async): 16 bytes each where both ends are 16-byte
// aligned, 4 bytes otherwise. The caller commits and waits.
__device__ __forceinline__ void copy_async(int32_t* dst, const int32_t* src, int n) {
  int i0 = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    i0 = n4 << 2;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// Persistent: block b takes tiles b, b + gridDim.x, ... of RB rows, and
// loads the next tile while it works on the current one. Per tile:
//   1-2. a thread a row finds whether the row may need a sort: fused,
//      some candidate has ts > 0 (no other can survive); unfused, some
//      candidate differs from the row's first or that one has ts > 0. A
//      row that needs none gets m_keep copies (of (NEG_INF, 0, 0) fused,
//      of the first candidate unfused) and n_live = 0; the others are
//      queued, and fused, their candidates' tombstone bounds gathered;
//   3. the warps take the queued rows, L lanes a row (merge or sort);
//   4. the output tiles go out with 16-byte streaming stores.
template <int P, bool kFused>
__global__ void __launch_bounds__(WARP_BLOCK, WARP_MIN_BLOCKS) sort_slots_warp_kernel(
    const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_d,
    const int32_t* __restrict__ a_t, int wa, const int32_t* __restrict__ b_s,
    const int32_t* __restrict__ b_d, const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D, int32_t* __restrict__ o_s,
    int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t N, int m_keep, int RB) {
  constexpr int L = P < 32 ? P : 32;  // lanes per row
  constexpr int E = P / L;            // candidates per lane
  constexpr int RPW = 32 / L;         // rows per warp pass
  constexpr int NW = WARP_BLOCK / 32;
  extern __shared__ __align__(16) int32_t warp_smem[];
  const WarpTile tl = carve(warp_smem, RB, wa, wb, m_keep, P);
  const int W = wa + wb;
  const int64_t T = (N + RB - 1) / RB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane & (L - 1);
  const int seg = lane & (32 - L);  // first lane of this row's segment
  const unsigned lt = (1u << l) - 1u;
  int32_t* idx = tl.idx + warp * (P < 32 ? 32 : P) + (seg / L) * P;

  auto tile_rows = [&](int64_t tile) -> int {
    const int64_t left = N - tile * RB;
    return left < RB ? (int)left : RB;
  };
  auto load = [&](int64_t tile, const InTile& b) {
    if (tile >= T) return;
    const int64_t row0 = tile * RB;
    const int rows = tile_rows(tile);
    copy_async(b.as, a_s + row0 * wa, rows * wa);
    copy_async(b.ad, a_d + row0 * wa, rows * wa);
    copy_async(b.at, a_t + row0 * wa, rows * wa);
    if (wb > 0) {
      copy_async(b.bs, b_s + row0 * wb, rows * wb);
      copy_async(b.bd, b_d + row0 * wb, rows * wb);
      copy_async(b.bt, b_t + row0 * wb, rows * wb);
    }
  };
  // Ballot of this row's lanes, as bits 0..L-1.
  auto row_ballot = [&](bool pred) -> unsigned {
    const unsigned b = __ballot_sync(FULL, pred);
    return L == 32 ? b : (b >> seg) & ((1u << (L & 31)) - 1u);
  };

  if (threadIdx.x == 0) *tl.qn = 0;
  int64_t tile = blockIdx.x;
  load(tile, tl.in0);
  __pipeline_commit();
  for (int k = 0; tile < T; ++k, tile += gridDim.x) {
    load(tile + gridDim.x, (k & 1) ? tl.in0 : tl.in1);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const InTile in = (k & 1) ? tl.in1 : tl.in0;
    const int64_t row0 = tile * RB;
    const int rows = tile_rows(tile);
    // Candidate c of row r: side a's slot c for c < wa, side b's slot
    // c - wa otherwise.
    auto staged = [&](int r, int c) -> Cand {
      if (c < wa) {
        const int o = r * wa + c;
        return {in.as[o], in.at[o], in.ad[o]};
      }
      const int o = r * wb + (c - wa);
      return {in.bs[o], in.bt[o], in.bd[o]};
    };

    // 1-2. A thread a row: whether it needs a sort; m_keep copies and
    //      n_live = 0 if not, else a place in the queue (one atomic a warp).
    for (int r0 = 0; r0 < rows; r0 += WARP_BLOCK) {
      const int r = r0 + threadIdx.x;
      bool needs = false;
      if (r < rows) {
        Cand f = staged(r, 0);
        if (kFused) {
          for (int c = 0; c < W; ++c) needs |= staged(r, c).t > 0;
          f = Cand{NEG_INF, 0, 0};
        } else {
          needs = f.t > 0;
          for (int c = 1; c < W; ++c) needs |= !csame(staged(r, c), f);
        }
        if (!needs) {
          for (int p = 0; p < m_keep; ++p) {
            tl.os[r * m_keep + p] = f.s;
            tl.od[r * m_keep + p] = f.d;
            tl.ot[r * m_keep + p] = f.t;
          }
          tl.nl[r] = 0;
        }
      }
      const unsigned want = __ballot_sync(FULL, needs);
      int at = 0;
      if (lane == 0 && want != 0u) at = atomicAdd(tl.qn, __popc(want));
      at = __shfl_sync(FULL, at, 0);
      if (needs) tl.queue[at + __popc(want & ((1u << lane) - 1u))] = r;
    }
    __syncthreads();
    const int nq = *tl.qn;
    if (kFused && nq > 0) {
      // The queued rows' tombstone bounds, eight gathers in flight a
      // thread: max(rmv_vc[row, dc], 0) where ts > 0 and 0 <= dc < D, else
      // 0 (so a candidate survives iff ts > its bound).
      const int n = nq * W;
      for (int base = threadIdx.x; base < n; base += WARP_BLOCK * 8) {
        int32_t v[8], rr[8], cc[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int q = base + u * WARP_BLOCK;
          v[u] = 0;
          rr[u] = -1;
          cc[u] = 0;
          if (q >= n) continue;
          rr[u] = tl.queue[q / W];
          cc[u] = q - (q / W) * W;
          const Cand x = staged(rr[u], cc[u]);
          if (x.t > 0 && x.d >= 0 && x.d < D) v[u] = __ldg(rmv_vc + (row0 + rr[u]) * D + x.d);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (rr[u] < 0) continue;
          if (cc[u] < wa)
            tl.doma[rr[u] * wa + cc[u]] = max(v[u], 0);
          else
            tl.domb[rr[u] * wb + cc[u] - wa] = max(v[u], 0);
        }
      }
      __syncthreads();
    }

    // 3. The queued rows, RPW a warp at a time.
    for (int qb = warp * RPW; qb < nq; qb += NW * RPW) {
      const int qi = qb + seg / L;
      const bool valid = qi < nq;
      const int r = valid ? tl.queue[qi] : 0;
      // Position i holds side a's slot i for i < wa and side b's slot
      // P - 1 - i above (side b reversed, then virtual candidates), so two
      // sorted sides make a bitonic row.
      Cand x[E];
      bool surv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = e * L + l;
        const int j = P - 1 - i;
        const bool real = valid && (i < wa || j < wb);
        x[e] = real ? staged(r, i < wa ? i : wa + j) : virtual_cand();
        surv[e] = real;
        if (kFused && real) {
          surv[e] = x[e].t > (i < wa ? tl.doma[r * wa + i] : tl.domb[r * wb + j]);
          if (!surv[e]) x[e] = dead_cand();
        }
      }

      if (kFused) {
        // Compact each side's survivors to the front of its run (side b's
        // run is read backwards); the dead fill the rest of each run.
        unsigned ma[E], mb[E];
        int na_ = 0, nb_ = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * L + l;
          ma[e] = row_ballot(surv[e] && i < wa);
          mb[e] = row_ballot(surv[e] && i >= wa);
          na_ += __popc(ma[e]);
          nb_ += __popc(mb[e]);
        }
        __syncwarp();
        int pa = 0, pb = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * L + l;
          if (surv[e]) {
            if (i < wa)
              idx[pa + __popc(ma[e] & lt)] = i;
            else  // side b's slot P - 1 - i, ranked by slot index
              idx[wa + nb_ - 1 - (pb + __popc(mb[e] & lt))] = wa + (P - 1 - i);
          }
          pa += __popc(ma[e]);
          pb += __popc(mb[e]);
        }
        __syncwarp();
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int i = e * L + l;
          const int j = P - 1 - i;
          if (!valid) continue;
          if (i < wa)
            x[e] = i < na_ ? staged(r, idx[i]) : dead_cand();
          else
            x[e] = j < nb_ ? staged(r, idx[wa + j]) : (j < wb ? dead_cand() : virtual_cand());
        }
      }

      // Merge when every row of the warp is two sorted runs, else sort.
      Cand pv[E];
      predecessors<L, E>(x, pv, l);
      bool unsorted = false;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = e * L + l;
        if (i >= 1 && i < wa) unsorted |= cbetter(x[e], pv[e]);
        if (i > wa) unsorted |= cbetter(pv[e], x[e]);
      }
      if (__any_sync(FULL, unsorted))
        bitonic<P, L, 2>(x, l);
      else
        bitonic<P, L, P>(x, l);

      // Blank duplicates and place: kept slot with kept-rank c goes to c,
      // or to c + n_blank when it ranks after a blank.
      predecessors<L, E>(x, pv, l);
      const Cand blank = kFused ? dead_cand() : Cand{NEG_INF, 0, 0};
      unsigned mk[E];
      bool kept[E];
      int n_kept = 0, above = 0, nl = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = e * L + l;
        kept[e] = !(i >= 1 && csame(x[e], pv[e]) && x[e].t > 0);
        mk[e] = row_ballot(kept[e]);
        n_kept += __popc(mk[e]);
        above += __popc(row_ballot(kept[e] && cbetter(x[e], blank)));
        nl += __popc(row_ballot(kept[e] && x[e].t > 0));
      }
      const int n_blank = P - n_kept;
      if (valid) {
        int c0 = 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int c = c0 + __popc(mk[e] & lt);
          const int pos = c < above ? c : c + n_blank;
          if (kept[e] && pos < m_keep) {
            const bool out_blank = kFused && x[e].t <= 0;
            tl.os[r * m_keep + pos] = out_blank ? NEG_INF : x[e].s;
            tl.od[r * m_keep + pos] = out_blank ? 0 : x[e].d;
            tl.ot[r * m_keep + pos] = out_blank ? 0 : x[e].t;
          }
          c0 += __popc(mk[e]);
        }
        const int hi = min(above + n_blank, m_keep);
        for (int q = above + l; q < hi; q += L) {
          tl.os[r * m_keep + q] = NEG_INF;
          tl.od[r * m_keep + q] = 0;
          tl.ot[r * m_keep + q] = 0;
        }
        if (l == 0) tl.nl[r] = nl;
      }
    }
    __syncthreads();

    // 4. Out, and empty the queue for the next tile.
    copy_cells<true>(o_s + row0 * m_keep, tl.os, (int64_t)rows * m_keep);
    copy_cells<true>(o_d + row0 * m_keep, tl.od, (int64_t)rows * m_keep);
    copy_cells<true>(o_t + row0 * m_keep, tl.ot, (int64_t)rows * m_keep);
    copy_cells<true>(n_live + row0, tl.nl, (int64_t)rows);
    if (threadIdx.x == 0) *tl.qn = 0;
  }
  __pipeline_wait_prior(0);
}

template <int P, bool kFused>
static int launch_warp(const int32_t* a_s, const int32_t* a_d, const int32_t* a_t, int wa,
                       const int32_t* b_s, const int32_t* b_d, const int32_t* b_t, int wb,
                       const int32_t* rmv_vc, int D, int32_t* o_s, int32_t* o_d,
                       int32_t* o_t, int32_t* n_live, int64_t N, int m_keep,
                       cudaStream_t s) {
  // Rows per tile: as many as the budget holds, a multiple of 8 (so that
  // every tile starts 16-byte aligned); one block per SM slot, each
  // walking over tiles.
  const int W = wa + wb;
  const int row_bytes = 4 * (6 * W + 3 * m_keep + 2 + (kFused ? W : 0));
  int RB = WARP_TILE_BYTES / row_bytes / 8 * 8;
  if (RB < 8) RB = 8;
  const size_t smem = sizeof(int32_t) * (size_t)warp_tile_cells(RB, wa, wb, m_keep, P, kFused);
  auto kernel = sort_slots_warp_kernel<P, kFused>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, WARP_BLOCK, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t tiles = (N + RB - 1) / RB;
  const int64_t slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks = (unsigned int)(tiles < slots ? tiles : slots);
  kernel<<<blocks, WARP_BLOCK, smem, s>>>(a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D,
                                          o_s, o_d, o_t, n_live, N, m_keep, RB);
  return (int)cudaGetLastError();
}

template <int P>
static int launch_warp_p(const int32_t* a_s, const int32_t* a_d, const int32_t* a_t, int wa,
                         const int32_t* b_s, const int32_t* b_d, const int32_t* b_t, int wb,
                         const int32_t* rmv_vc, int D, int32_t* o_s, int32_t* o_d,
                         int32_t* o_t, int32_t* n_live, int64_t N, int m_keep,
                         cudaStream_t s) {
  return rmv_vc != nullptr
             ? launch_warp<P, true>(a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s,
                                    o_d, o_t, n_live, N, m_keep, s)
             : launch_warp<P, false>(a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s,
                                     o_d, o_t, n_live, N, m_keep, s);
}

// --- block paths: 256 < W -------------------------------------------------

constexpr int BLOCK_SMEM_MAX_P = 8192;  // 8192 x 16 B of shared memory per row

__device__ __forceinline__ int3 add3(int3 a, int3 b) {
  return make_int3(a.x + b.x, a.y + b.y, a.z + b.z);
}

// Inclusive scan of x over the block's threads, in thread order; *total is
// the block's sum. scratch holds one value per warp.
__device__ __forceinline__ int3 block_scan3(int3 x, int3* scratch, int3* total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int3 y = make_int3(__shfl_up_sync(FULL, x.x, o), __shfl_up_sync(FULL, x.y, o),
                       __shfl_up_sync(FULL, x.z, o));
    if (lane >= o) x = add3(x, y);
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int3 w = lane < nw ? scratch[lane] : make_int3(0, 0, 0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int3 y = make_int3(__shfl_up_sync(FULL, w.x, o), __shfl_up_sync(FULL, w.y, o),
                         __shfl_up_sync(FULL, w.z, o));
      if (lane >= o) w = add3(w, y);
    }
    if (lane < nw) scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x = add3(x, scratch[warp - 1]);
  *total = scratch[nw - 1];
  return x;
}

// One block per row: row row_base + blockIdx.x. kGlobal keeps the row's P
// slots in scratch[blockIdx.x * P ...] (device memory), else in shared
// memory.
template <bool kGlobal>
__global__ void __launch_bounds__(1024) sort_slots_block_kernel(
    const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_d,
    const int32_t* __restrict__ a_t, int wa, const int32_t* __restrict__ b_s,
    const int32_t* __restrict__ b_d, const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D, int32_t* __restrict__ o_s,
    int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t row_base, int m_keep, int P,
    Slot* scratch) {
  extern __shared__ __align__(16) unsigned char block_smem[];
  Slot* v = kGlobal ? scratch + (int64_t)blockIdx.x * P : reinterpret_cast<Slot*>(block_smem);
  int3* scan_scratch =
      reinterpret_cast<int3*>(block_smem + (kGlobal ? 0 : (size_t)P * sizeof(Slot)));
  const int tpr = (int)blockDim.x;
  const int lane = (int)threadIdx.x;
  const int64_t row = row_base + blockIdx.x;

  for (int i = lane; i < P; i += tpr)
    v[i] = load_candidate(i, row, a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D);
  __syncthreads();

  // Bitonic sort, best first: pair q compares i (bit j clear) with i + j;
  // blocks with bit k of i clear sort best first, the others worst first.
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int q = lane; q < (P >> 1); q += tpr) {
        const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        Slot x = v[i], y = v[i + j];
        if ((i & k) == 0 ? better(y, x) : better(x, y)) {
          v[i] = y;
          v[i + j] = x;
        }
      }
      __syncthreads();
    }
  }

  // Each thread owns a chunk of E consecutive sorted slots and counts its
  // kept slots, those better than a blank, and those with ts > 0.
  const Slot blank = {NEG_INF, 0, 0, rmv_vc != nullptr ? 0 : 1};
  const int E = P / tpr;
  const int lo = lane * E;
  int3 cnt = make_int3(0, 0, 0);
  for (int i = lo; i < lo + E; ++i) {
    const Slot x = v[i];
    if (i > 0 && is_dup(x, v[i - 1])) continue;
    cnt = add3(cnt, make_int3(1, better(x, blank) ? 1 : 0, x.t > 0 ? 1 : 0));
  }
  int3 total;
  const int3 incl = block_scan3(cnt, scan_scratch, &total);
  const int n_kept = total.x, above = total.y;
  const int n_blank = P - n_kept;
  // The kept slots better than a blank are the first `above` of them.
  int c = incl.x - cnt.x;
  const int64_t ob = row * m_keep;
  for (int i = lo; i < lo + E; ++i) {
    const Slot x = v[i];
    if (i > 0 && is_dup(x, v[i - 1])) continue;
    const int pos = c < above ? c : c + n_blank;
    if (pos < m_keep) {
      o_s[ob + pos] = x.s;
      o_d[ob + pos] = x.d;
      o_t[ob + pos] = x.t;
    }
    ++c;
  }
  for (int q = above + lane; q < above + n_blank && q < m_keep; q += tpr) {
    o_s[ob + q] = blank.s;
    o_d[ob + q] = blank.d;
    o_t[ob + q] = blank.t;
  }
  if (lane == 0) n_live[row] = total.z;
}

static int next_pow2(int w, int lo) {
  int P = lo;
  while (P < w) P <<= 1;
  return P;
}

// 16 < W = wa + wb <= 8192 and 1 <= m_keep <= W are checked by the caller.
extern "C" int sort_slots_wide(const int32_t* a_s, const int32_t* a_d,
                               const int32_t* a_t, int wa, const int32_t* b_s,
                               const int32_t* b_d, const int32_t* b_t, int wb,
                               const int32_t* rmv_vc, int D, int32_t* o_s,
                               int32_t* o_d, int32_t* o_t, int32_t* n_live,
                               int64_t N, int m_keep, void* stream) {
  const int P = next_pow2(wa + wb, 32);
  if (P > BLOCK_SMEM_MAX_P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define WARP_ARGS a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t, n_live, N, m_keep, s
  switch (P) {
    case 32: return launch_warp_p<32>(WARP_ARGS);
    case 64: return launch_warp_p<64>(WARP_ARGS);
    case 128: return launch_warp_p<128>(WARP_ARGS);
    case 256: return launch_warp_p<256>(WARP_ARGS);
    default: break;
  }
  const int threads = P / 8 < 1024 ? P / 8 : 1024;
  const size_t smem = (size_t)P * sizeof(Slot) + 32 * sizeof(int3);
  cudaError_t e = cudaFuncSetAttribute(
      sort_slots_block_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sort_slots_block_kernel<false><<<(unsigned int)N, threads, smem, s>>>(
      a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t, n_live, 0, m_keep, P,
      nullptr);
  return (int)cudaGetLastError();
}

// 8192 < W = wa + wb <= 2^30 and 1 <= m_keep <= W are checked by the
// caller, which passes a scratch of chunk_rows x next_pow2(W) Slots.
extern "C" int sort_slots_global(const int32_t* a_s, const int32_t* a_d,
                                 const int32_t* a_t, int wa, const int32_t* b_s,
                                 const int32_t* b_d, const int32_t* b_t, int wb,
                                 const int32_t* rmv_vc, int D, int32_t* o_s,
                                 int32_t* o_d, int32_t* o_t, int32_t* n_live,
                                 int64_t N, int m_keep, void* scratch,
                                 int64_t chunk_rows, void* stream) {
  const int P = next_pow2(wa + wb, 32);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = 32 * sizeof(int3);
  for (int64_t r0 = 0; r0 < N; r0 += chunk_rows) {
    const int64_t n = N - r0 < chunk_rows ? N - r0 : chunk_rows;
    sort_slots_block_kernel<true><<<(unsigned int)n, 1024, smem, s>>>(
        a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t, n_live, r0, m_keep,
        P, reinterpret_cast<Slot*>(scratch));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// W = wa + wb <= 16 and 1 <= m_keep <= W are checked by the caller.
extern "C" int sort_slots(const int32_t* a_s, const int32_t* a_d,
                          const int32_t* a_t, int wa, const int32_t* b_s,
                          const int32_t* b_d, const int32_t* b_t, int wb,
                          const int32_t* rmv_vc, int D, int32_t* o_s,
                          int32_t* o_d, int32_t* o_t, int32_t* n_live,
                          int64_t N, int m_keep, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (wa + wb > 8) return launch_warp_p<16>(WARP_ARGS);
  const int threads = 256;
  unsigned int blocks = (unsigned int)((N + threads - 1) / threads);
  sort_slots_kernel<8><<<blocks, threads, 0, s>>>(
      a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t,
      n_live, N, m_keep);
  return (int)cudaGetLastError();
}
