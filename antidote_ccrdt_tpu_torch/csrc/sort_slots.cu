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
// Three paths compute the same function; the caller picks one by W:
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
// * the row paths, W > 256 (sort_slots_rows; the block path up to 8192
//   and the global path above, in the caller's counts): a chain of kernels
//   over tiles of T = 2^k candidates, many blocks a row (see "row paths"
//   below). Each tile's survivors are merged when both of its sides are
//   sorted runs and sorted otherwise; a row of several tiles is
//   merged run by run through a device scratch, and its epilogue runs
//   across blocks. A row that fits one tile takes one launch and no
//   scratch. Every index within a row is an int: W <= 2^30.
//
// Bound on the H100: bytes. At the replay's shapes (N = 32 x 100k rows,
// M = 4 per side, D = 32) the fused call reads 6 x N x 4 int32 of slots and
// the N x 32 int32 tombstone table (0.72 GB) and writes 3 x N x 4 int32
// plus N int32 (0.17 GB): about 0.26 ms at 3.35 TB/s. A row whose
// candidates all have ts <= 0 reads no tombstone sector at all, so the
// bound that counts only the 32-byte sectors its live candidates need is
// lower (chip_smoke.py computes both). What the inputs need of comparisons
// is W a row for two sorted sides and W log2 W for a raw row, far below
// the card's integer rate; the wide rows' calls are few rows, so there the
// launches and the chain's dependent steps bound the time.
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

// --- row paths: 256 < W <= 2^30 -------------------------------------------
//
// A row is cut into tiles of T = 2^k candidates (the caller picks T: the
// whole row while it fits one block, which is one launch with no scratch).
// Candidates are Cands as on the warp path: fused, a dead one is
// (INT32_MIN, 0, 0).
//
//   tile kernel, a block a tile (grid: rows x tiles): load the tile with
//      the filter, then split it in its two pieces (side a's slots, side
//      b's); each piece's survivors are compacted ahead of its dead by a
//      block scan. If each piece is then sorted (two canonical sides: the
//      fold, merge and apply_ops joins) the two pieces are merged: each
//      thread finds where its E outputs start on the merge path (a binary
//      search for how many of them come from either piece; on a tie side
//      a's comes first) and merges them sequentially. Otherwise (raw rows)
//      each warp sorts chunks of 128 in registers (the warp path's bitonic
//      network) and the chunks are merged pairwise the same way in shared
//      memory. A one-tile row goes on to the epilogue in the same block; a
//      wider row's sorted tiles go to a device scratch of 16-byte cells;
//   merge kernel, once per doubling of the run length L from T to W: each
//      thread writes MERGE_SPAN consecutive outputs of a merged pair of
//      runs, found by one binary search on the merge path and a
//      sequential merge (the grid over rows x W / MERGE_SPAN). The last
//      pass also sums, per block of outputs, the candidates kept (not an
//      exact duplicate with ts > 0 of its predecessor), those better than
//      a blank and those with ts > 0;
//   place kernel, the epilogue across blocks: the row's earlier blocks'
//      sums plus a block scan give each kept slot its place among the
//      first m_keep (after the blanks when it ranks after a blank); it
//      writes the kept slots, the blanks and n_live.
//
// What bounds it: phase 8's calls are 12-24 rows, so the bytes (a few MB)
// and comparisons are microseconds of work; the launches of the chain and
// the dependent steps inside a block (barriers, binary searches) set the
// time. Merging instead of sorting two sorted sides, merge paths in place
// of a search per candidate, and the epilogue's count folded into the last
// merge pass each cut those. A row of several tiles on one thread-block
// cluster, merged through distributed shared memory in one launch, was
// slower at those shapes than the chain (PERF.md) and is not kept.

constexpr int ROW_TILE_MAX = 8192;  // 2 x 8192 x 12 B of a tile block's shared memory
constexpr int PASS_BLOCK = 256;     // threads of a merge or place block

__device__ __forceinline__ int3 add3(int3 a, int3 b) {
  return make_int3(a.x + b.x, a.y + b.y, a.z + b.z);
}

// Inclusive scan of x over the block's threads, in thread order; *total is
// the block's sum. scratch holds one value per warp. Every thread of the
// block calls it; it may be called again right after.
__device__ __forceinline__ int3 block_scan3(int3 x, int3* scratch, int3* total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int3 y = make_int3(__shfl_up_sync(FULL, x.x, o), __shfl_up_sync(FULL, x.y, o),
                       __shfl_up_sync(FULL, x.z, o));
    if (lane >= o) x = add3(x, y);
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  __syncthreads();  // an earlier call's readers are done with scratch
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

__device__ __forceinline__ Cand cell(const int4& v) { return {v.x, v.y, v.z}; }

// A call's inputs and outputs, as the row paths' tile kernel takes them.
struct RowArgs {
  const int32_t *a_s, *a_d, *a_t;
  int wa;
  const int32_t *b_s, *b_d, *b_t;
  int wb;
  const int32_t* rmv_vc;
  int D;
  int32_t *o_s, *o_d, *o_t, *n_live;
  int m_keep;
};

// Candidate c of a row, as on the warp path: fused, a candidate that the
// filter kills is dead_cand(); one with ts <= 0 dies whatever its tombstone,
// so its tombstone is not read.
__device__ __forceinline__ Cand row_candidate(const RowArgs& g, int c, int64_t row) {
  Cand x;
  if (c < g.wa) {
    const int64_t o = row * g.wa + c;
    x = {g.a_s[o], g.a_t[o], g.a_d[o]};
  } else {
    const int64_t o = row * g.wb + (c - g.wa);
    x = {g.b_s[o], g.b_t[o], g.b_d[o]};
  }
  if (g.rmv_vc != nullptr) {
    int32_t dom = 0;
    if (x.t > 0 && x.d >= 0 && x.d < g.D) dom = max(__ldg(g.rmv_vc + row * g.D + x.d), 0);
    if (!(x.t > dom)) x = dead_cand();
  }
  return x;
}

// The counts of sorted candidate x with predecessor p (has_p false for the
// row's first): (kept, kept and better than a blank, kept with ts > 0).
template <bool kFused>
__device__ __forceinline__ int3 keep_counts(const Cand& x, const Cand& p, bool has_p) {
  const Cand blank = kFused ? dead_cand() : Cand{NEG_INF, 0, 0};
  if (has_p && csame(x, p) && x.t > 0) return make_int3(0, 0, 0);
  return make_int3(1, cbetter(x, blank) ? 1 : 0, x.t > 0 ? 1 : 0);
}

// Writes kept slot x at its place. Fused, a dead slot is written as the
// blank (NEG_INF, 0, 0).
template <bool kFused>
__device__ __forceinline__ void put_slot(int32_t* o_s, int32_t* o_d, int32_t* o_t, int64_t o,
                                         const Cand& x) {
  const bool blank = kFused && x.t <= 0;
  o_s[o] = blank ? NEG_INF : x.s;
  o_d[o] = blank ? 0 : x.d;
  o_t[o] = blank ? 0 : x.t;
}

// Outputs [d0, d0 + cnt) of the merge of sorted runs a[0, la) and b[0,
// lb), side a's first on a tie, passed to put(position, candidate): one
// binary search for the split of the first d0 outputs between the runs
// (merge path), then cnt steps of a sequential merge. With kPred, *pred
// is output d0 - 1 (when d0 > 0), the later of the last candidate each
// run gave to the first d0.
template <bool kPred = false, typename LoadA, typename LoadB, typename Put>
__device__ __forceinline__ void merge_span(int d0, int cnt, int la, int lb, LoadA a, LoadB b,
                                           Put put, Cand* pred = nullptr) {
  int lo = max(0, d0 - lb), hi = min(d0, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!cbetter(b(d0 - mid - 1), a(mid)))
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = d0 - lo;
  if (kPred && d0 > 0) {
    if (i == 0 || j == 0) {
      *pred = i == 0 ? b(j - 1) : a(i - 1);
    } else {
      const Cand pa = a(i - 1), pb = b(j - 1);
      *pred = cbetter(pb, pa) ? pa : pb;
    }
  }
  Cand x = i < la ? a(i) : virtual_cand(), y = j < lb ? b(j) : virtual_cand();
  for (int k = 0; k < cnt; ++k) {
    if (j >= lb || (i < la && !cbetter(y, x))) {
      put(d0 + k, x);
      if (++i < la) x = a(i);
    } else {
      put(d0 + k, y);
      if (++j < lb) y = b(j);
    }
  }
}

// Tile [base, base + n) of `row`, sorted into A or B (the one returned), by
// the whole block; T = E x blockDim.x, A and B hold T candidates each.
template <bool kFused>
__device__ const Cand* sort_tile(const RowArgs& g, int64_t row, int base, int n, int T, Cand* A,
                                 Cand* B, int3* scan) {
  const int NT = blockDim.x, tid = threadIdx.x;
  const int E = T / NT;
  const int na = min(max(g.wa - base, 0), n);  // tile positions [0, na) are side a's
  const int lo = tid * E, hi = min(lo + E, n);

  // 1. Load with the filter (coalesced), then each thread counts the
  //    survivors of its E consecutive positions in either piece.
  for (int i0 = tid; i0 < n; i0 += 4 * NT) {  // four candidates in flight a thread
    Cand x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * NT < n)
        x[u] = row_candidate(g, base + i0 + u * NT, row);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i0 + u * NT < n) A[i0 + u * NT] = x[u];
  }
  __syncthreads();
  int3 cnt = make_int3(0, 0, 0);
  for (int i = lo; i < hi; ++i) {
    const bool s = !kFused || A[i].t > 0;  // fused, a survivor has ts >= 1
    if (i < na)
      cnt.x += s;
    else
      cnt.y += s;
  }
  int3 tot;
  const int3 incl = block_scan3(cnt, scan, &tot);
  // 2. Each piece's survivors in order, then its dead, into B.
  int pa = incl.x - cnt.x, pb = incl.y - cnt.y;
  for (int i = lo; i < hi; ++i) {
    const Cand x = A[i];
    const bool s = !kFused || x.t > 0;
    int pos;
    if (i < na)
      pos = s ? pa++ : tot.x + (i - pa);
    else
      pos = na + (s ? pb++ : tot.y + (i - na - pb));
    B[pos] = x;
  }
  __syncthreads();
  // 3. Merge when both pieces are sorted runs, else sort.
  bool unsorted = false;
  for (int i = max(lo, 1); i < hi; ++i)
    if (i != na) unsorted |= cbetter(B[i], B[i - 1]);
  unsorted = __syncthreads_or(unsorted);
  const Cand* S;
  if (!unsorted) {
    if (lo < hi)
      merge_span(lo, hi - lo, na, n - na, [&](int k) { return B[k]; },
                 [&](int k) { return B[na + k]; }, [&](int p, const Cand& x) { A[p] = x; });
    S = A;
  } else {
    // Sort: each warp sorts chunks of 128 in registers (the warp path's
    // bitonic network, no block barrier), then the chunks are merged
    // pairwise on the merge path between B and A, a barrier a pass.
    for (int i = n + tid; i < T; i += NT) B[i] = virtual_cand();
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int c = warp * 128; c < T; c += NT * 4) {
      Cand x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = B[c + e * 32 + lane];
      bitonic<128, 32, 2>(x, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) B[c + e * 32 + lane] = x[e];
    }
    __syncthreads();
    Cand *src = B, *dst = A;
    for (int L = 128; L < T; L <<= 1) {
      const int ps = lo & ~(2 * L - 1);  // this thread's E outputs lie in one pair of runs
      merge_span(lo - ps, E, L, L, [&](int k) { return src[ps + k]; },
                 [&](int k) { return src[ps + L + k]; }, [&](int p, const Cand& x) { dst[ps + p] = x; });
      __syncthreads();
      Cand* tmp = src;
      src = dst;
      dst = tmp;
    }
    S = src;
  }
  __syncthreads();
  return S;
}

// Block b sorts tile b % ntiles of row row0 + b / ntiles. A row of one
// tile goes on to the epilogue in this block; a wider row's sorted tile
// goes to its place in the runs (W cells a row), the chain's first step.
template <bool kFused>
__global__ void __launch_bounds__(1024, 1) sort_slots_row_tile_kernel(RowArgs g, int64_t row0, int T,
                                                                      int ntiles, int4* __restrict__ runs) {
  extern __shared__ __align__(16) unsigned char row_smem[];
  Cand* A = reinterpret_cast<Cand*>(row_smem);
  int3* scan = reinterpret_cast<int3*>(A + 2 * T);
  const int W = g.wa + g.wb;
  const int64_t local = blockIdx.x / ntiles;
  const int64_t row = row0 + local;
  const int base = (int)(blockIdx.x - local * ntiles) * T;
  const int n = min(T, W - base);
  const Cand* S = sort_tile<kFused>(g, row, base, n, T, A, A + T, scan);
  const int tid = threadIdx.x, NT = blockDim.x;
  if (ntiles > 1) {
    int4* dst = runs + local * W + base;
    for (int i = tid; i < n; i += NT) dst[i] = make_int4(S[i].s, S[i].t, S[i].d, 0);
    return;
  }
  // The epilogue of a one-tile row: the kept slots' places by a block scan.
  const int E = T / NT, lo = tid * E, hi = min(lo + E, n);
  int3 c3 = make_int3(0, 0, 0);
  for (int i = lo; i < hi; ++i)
    c3 = add3(c3, keep_counts<kFused>(S[i], S[i > 0 ? i - 1 : 0], i > 0));
  int3 tot;
  const int3 incl = block_scan3(c3, scan, &tot);
  const int above = tot.y, n_blank = n - tot.x;
  int c = incl.x - c3.x;
  const int64_t ob = row * g.m_keep;
  for (int i = lo; i < hi; ++i) {
    if (keep_counts<kFused>(S[i], S[i > 0 ? i - 1 : 0], i > 0).x == 0) continue;
    const int pos = c < above ? c : c + n_blank;
    if (pos < g.m_keep) put_slot<kFused>(g.o_s, g.o_d, g.o_t, ob + pos, S[i]);
    ++c;
  }
  for (int q = above + tid; q < above + n_blank && q < g.m_keep; q += NT) {
    g.o_s[ob + q] = NEG_INF;
    g.o_d[ob + q] = 0;
    g.o_t[ob + q] = 0;
  }
  if (tid == 0) g.n_live[row] = tot.z;
}

constexpr int MERGE_SPAN = 4;  // sorted positions a thread of the merge and place kernels

// Runs of L sorted candidates, pairwise merged into runs of 2L; a thread
// writes MERGE_SPAN consecutive outputs, a block PASS_BLOCK x MERGE_SPAN
// (tpr blocks a row). kCount, on the last pass (one pair, the whole row):
// each block also writes the epilogue's sums over its outputs, the kept
// ones, those better than a blank and those with ts > 0.
template <bool kFused, bool kCount>
__global__ void __launch_bounds__(PASS_BLOCK) sort_slots_row_merge_kernel(
    const int4* __restrict__ src, int4* __restrict__ dst, int W, int L, int tpr,
    int4* __restrict__ sums) {
  __shared__ int3 scan[32];
  const int64_t r = blockIdx.x / tpr;
  const int o = ((int)(blockIdx.x - r * tpr) * PASS_BLOCK + threadIdx.x) * MERGE_SPAN;
  int3 c = make_int3(0, 0, 0);
  if (o < W) {
    const int4* row = src + r * W;
    int4* out = dst + r * W;
    const int ps = o & ~(2 * L - 1);  // < 2^31: L < W <= 2^30
    const int la = min(L, W - ps), lb = max(0, min(L, W - ps - L));
    Cand prev = virtual_cand();
    merge_span<kCount>(
        o - ps, min(MERGE_SPAN, W - o), la, lb, [&](int k) { return cell(row[ps + k]); },
        [&](int k) { return cell(row[ps + L + k]); },
        [&](int p, const Cand& x) {
          out[ps + p] = make_int4(x.s, x.t, x.d, 0);
          if (kCount) {
            c = add3(c, keep_counts<kFused>(x, prev, ps + p > 0));
            prev = x;
          }
        },
        &prev);
  }
  if (kCount) {
    int3 tot;
    block_scan3(c, scan, &tot);
    if (threadIdx.x == 0) sums[blockIdx.x] = make_int4(tot.x, tot.y, tot.z, 0);
  }
}

// The epilogue's placement, MERGE_SPAN sorted candidates a thread: the
// row's sums before this block and in all, then a block scan of the kept
// candidates.
template <bool kFused>
__global__ void __launch_bounds__(PASS_BLOCK) sort_slots_row_place_kernel(
    const int4* __restrict__ sorted, int W, int tpr, const int4* __restrict__ sums,
    int32_t* __restrict__ o_s, int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t row0, int m_keep) {
  __shared__ int3 scan[32];
  const int64_t r = blockIdx.x / tpr;
  const int t = (int)(blockIdx.x - r * tpr);
  const int o = (t * PASS_BLOCK + threadIdx.x) * MERGE_SPAN;
  int3 before = make_int3(0, 0, 0), all = make_int3(0, 0, 0);
  for (int k = threadIdx.x; k < tpr; k += PASS_BLOCK) {
    const int4 v = sums[r * tpr + k];
    const int3 v3 = make_int3(v.x, v.y, v.z);
    all = add3(all, v3);
    if (k < t) before = add3(before, v3);
  }
  block_scan3(before, scan, &before);
  block_scan3(all, scan, &all);
  const int above = all.y, n_blank = W - all.x;
  const int4* row = sorted + r * W;
  Cand x[MERGE_SPAN];
  Cand prev = o > 0 && o < W ? cell(row[o - 1]) : virtual_cand();
  int3 c = make_int3(0, 0, 0);
  unsigned kept = 0;
#pragma unroll
  for (int k = 0; k < MERGE_SPAN; ++k) {
    if (o + k >= W) break;
    x[k] = cell(row[o + k]);
    const int3 v = keep_counts<kFused>(x[k], prev, o + k > 0);
    kept |= (unsigned)v.x << k;
    c = add3(c, v);
    prev = x[k];
  }
  int3 tot;
  const int3 incl = block_scan3(c, scan, &tot);
  const int64_t ob = (row0 + r) * m_keep;
  int rank = before.x + incl.x - c.x;  // the kept rank of this thread's first kept slot
#pragma unroll
  for (int k = 0; k < MERGE_SPAN; ++k) {
    const int q = o + k;
    if (q >= W) break;
    if (kept >> k & 1u) {
      const int pos = rank < above ? rank : rank + n_blank;
      if (pos < m_keep) put_slot<kFused>(o_s, o_d, o_t, ob + pos, x[k]);
      ++rank;
    }
    if (q >= above && q < above + n_blank && q < m_keep) {
      o_s[ob + q] = NEG_INF;
      o_d[ob + q] = 0;
      o_t[ob + q] = 0;
    }
  }
  if (o == 0) n_live[row0 + r] = all.z;
}

template <bool kFused>
static int launch_rows(const RowArgs& g, int64_t N, int T, int4* scratch, int64_t chunk_rows,
                       cudaStream_t s) {
  const int W = g.wa + g.wb;
  const int ntiles = (W + T - 1) / T;
  const int threads = T >= 4096 ? 1024 : T / 4;
  const size_t smem = 2 * (size_t)T * sizeof(Cand) + 32 * sizeof(int3);
  auto tile = sort_slots_row_tile_kernel<kFused>;
  // The largest shared memory granted so far, per device: raised when a
  // call needs more, not set again on every call.
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || (int)smem > granted[dev]) {
    e = cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = (int)smem;
  }
  if (ntiles == 1) chunk_rows = 1 << 30;  // no scratch: only the grid bounds a launch
  const int tpr = (W + PASS_BLOCK * MERGE_SPAN - 1) / (PASS_BLOCK * MERGE_SPAN);
  int4* run0 = scratch;
  int4* run1 = ntiles > 1 ? scratch + chunk_rows * W : nullptr;
  int4* sums = ntiles > 1 ? scratch + 2 * chunk_rows * W : nullptr;
  for (int64_t r0 = 0; r0 < N; r0 += chunk_rows) {
    const int64_t n = N - r0 < chunk_rows ? N - r0 : chunk_rows;
    tile<<<(unsigned int)(n * ntiles), threads, smem, s>>>(g, r0, T, ntiles, run0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (ntiles == 1) continue;
    const unsigned int grid = (unsigned int)(n * tpr);
    int4 *src = run0, *dst = run1;
    for (int L = T; L < W; L <<= 1) {
      if (2 * L < W)
        sort_slots_row_merge_kernel<kFused, false><<<grid, PASS_BLOCK, 0, s>>>(src, dst, W, L, tpr, sums);
      else
        sort_slots_row_merge_kernel<kFused, true><<<grid, PASS_BLOCK, 0, s>>>(src, dst, W, L, tpr, sums);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      int4* tmp = src;
      src = dst;
      dst = tmp;
    }
    sort_slots_row_place_kernel<kFused><<<grid, PASS_BLOCK, 0, s>>>(src, W, tpr, sums, g.o_s, g.o_d,
                                                                   g.o_t, g.n_live, r0, g.m_keep);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return 0;
}

// 16 < W = wa + wb <= 256 and 1 <= m_keep <= W are checked by the caller.
extern "C" int sort_slots_wide(const int32_t* a_s, const int32_t* a_d,
                               const int32_t* a_t, int wa, const int32_t* b_s,
                               const int32_t* b_d, const int32_t* b_t, int wb,
                               const int32_t* rmv_vc, int D, int32_t* o_s,
                               int32_t* o_d, int32_t* o_t, int32_t* n_live,
                               int64_t N, int m_keep, void* stream) {
  int P = 32;
  while (P < wa + wb) P <<= 1;
  cudaStream_t s = (cudaStream_t)stream;
#define WARP_ARGS a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t, n_live, N, m_keep, s
  switch (P) {
    case 32: return launch_warp_p<32>(WARP_ARGS);
    case 64: return launch_warp_p<64>(WARP_ARGS);
    case 128: return launch_warp_p<128>(WARP_ARGS);
    case 256: return launch_warp_p<256>(WARP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 256 < W = wa + wb <= 2^30 and 1 <= m_keep <= W are checked by the
// caller, which picks the tile T (a power of two, 128 <= T <=
// ROW_TILE_MAX) and, when W > T, passes a scratch of chunk_rows x (2W +
// ceil(W / (PASS_BLOCK x MERGE_SPAN))) 16-byte cells; rows go in chunks of
// chunk_rows.
extern "C" int sort_slots_rows(const int32_t* a_s, const int32_t* a_d,
                               const int32_t* a_t, int wa, const int32_t* b_s,
                               const int32_t* b_d, const int32_t* b_t, int wb,
                               const int32_t* rmv_vc, int D, int32_t* o_s,
                               int32_t* o_d, int32_t* o_t, int32_t* n_live,
                               int64_t N, int m_keep, int tile, void* scratch,
                               int64_t chunk_rows, void* stream) {
  if (tile < 128 || tile > ROW_TILE_MAX || (tile & (tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (wa + wb > tile && (scratch == nullptr || chunk_rows < 1)) return (int)cudaErrorInvalidValue;
  const RowArgs g = {a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t, n_live, m_keep};
  cudaStream_t s = (cudaStream_t)stream;
  int4* cells = reinterpret_cast<int4*>(scratch);
  return rmv_vc != nullptr ? launch_rows<true>(g, N, tile, cells, chunk_rows, s)
                           : launch_rows<false>(g, N, tile, cells, chunk_rows, s);
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
