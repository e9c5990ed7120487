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
// Two paths compute the same function:
//
// * sort_slots, W <= 16 (the main path's 2M = 8): one thread per row, the
//   candidates and their liveness in registers, an odd-even network whose
//   indices are compile-time constants. Virtual candidates beyond W carry
//   live = -1 and sort last, so the 8-input network serves every W <= 8 and
//   the 16-input one every W <= 16. The TPU kernel's [tile, W] -> [W, tile]
//   transposes in VMEM have no counterpart: a thread owns its row.
// * sort_slots_wide, 16 < W <= 8192 (batch_merge sizes M to the largest
//   union of live adds of one id, and joins at W = 2M): one group of
//   threads per row, the row's P = next_pow2(W) candidates in shared
//   memory (16 bytes each; P = 8192 is the largest power of two whose row
//   fits a block's 227 KB). The group is a warp (eight rows a block) up to
//   P = 256 and a block of P / 8 threads above. A bitonic sort with the
//   same comparator replaces the network; the second sort becomes a scan:
//   the slots that are not duplicates stay sorted, and every blanked
//   duplicate is one value B = (NEG_INF, 0, 0, live of a blank), so the
//   final row is the kept slots with the blanks inserted after those kept
//   slots that are better than B. One scan of packed counts gives each
//   kept slot its place, and only the first m_keep places are written.
//
// Bound on the H100: bytes. At the main path's shapes (N = 32 x 100k rows,
// M = 4 per side, D = 32) the fused call reads 6 x N x 4 int32 of slots and
// the N x 32 int32 tombstone table (0.72 GB) and writes 3 x N x 4 int32
// plus N int32 (0.17 GB): about 0.26 ms at 3.35 TB/s. The two networks are
// 38 compare-exchanges of a few integer operations per row, far below the
// card's integer rate. The wide path's bitonic sort is O(P log^2 P)
// compare-exchanges through shared memory per row, which the group's
// threads share.
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
// Batcher odd-even mergesort for 16 inputs: oddeven_network(16).
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
  for (int i = 0; i < P; ++i)
    v[i] = load_candidate(i, row, a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D);
  network<P>(v);
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

// --- wide path: 16 < W <= 8192 --------------------------------------------

constexpr int WIDE_WARP_MAX_P = 256;   // a warp owns a row up to this width
constexpr int WIDE_ROWS_PER_BLOCK = 8; // rows (warps) per block on the warp path
constexpr int WIDE_MAX_P = 8192;       // 8192 x 16 B of shared memory per row

template <bool kBlock>
__device__ __forceinline__ void group_sync() {
  if (kBlock)
    __syncthreads();
  else
    __syncwarp();
}

// Inclusive scan of x over the group's threads, in thread order; *total
// is the group's sum. Block path: scratch holds one value per warp.
template <bool kBlock>
__device__ __forceinline__ unsigned long long group_scan(
    unsigned long long x, unsigned long long* scratch,
    unsigned long long* total) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    unsigned long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (!kBlock) {
    *total = __shfl_sync(0xffffffffu, x, 31);
    return x;
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < nw ? scratch[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      unsigned long long y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < nw) scratch[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += scratch[warp - 1];
  *total = scratch[nw - 1];
  return x;
}

// Counts packed 16 bits each (P <= 8192 < 2^16, so no field carries):
// kept slots, kept slots better than a blank, kept slots with ts > 0.
#define KEPT 1ull
#define ABOVE_BLANK (1ull << 16)
#define LIVE_TS (1ull << 32)

template <bool kBlock>
__global__ void __launch_bounds__(1024) sort_slots_wide_kernel(
    const int32_t* __restrict__ a_s, const int32_t* __restrict__ a_d,
    const int32_t* __restrict__ a_t, int wa, const int32_t* __restrict__ b_s,
    const int32_t* __restrict__ b_d, const int32_t* __restrict__ b_t, int wb,
    const int32_t* __restrict__ rmv_vc, int D, int32_t* __restrict__ o_s,
    int32_t* __restrict__ o_d, int32_t* __restrict__ o_t,
    int32_t* __restrict__ n_live, int64_t N, int m_keep, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Slot* smem = reinterpret_cast<Slot*>(smem_raw);
  const int tpr = kBlock ? (int)blockDim.x : 32;
  const int lane = kBlock ? (int)threadIdx.x : (int)(threadIdx.x & 31);
  const int g = kBlock ? 0 : (int)(threadIdx.x >> 5);
  const int64_t row =
      kBlock ? (int64_t)blockIdx.x
             : (int64_t)blockIdx.x * WIDE_ROWS_PER_BLOCK + g;
  if (row >= N) return;  // the whole group leaves together
  Slot* v = smem + (int64_t)g * P;
  unsigned long long* scratch = reinterpret_cast<unsigned long long*>(smem + P);

  for (int i = lane; i < P; i += tpr)
    v[i] = load_candidate(i, row, a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D);
  group_sync<kBlock>();

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
      group_sync<kBlock>();
    }
  }

  // Each thread owns a chunk of E consecutive sorted slots.
  const Slot blank = {NEG_INF, 0, 0, rmv_vc != nullptr ? 0 : 1};
  const int E = P / tpr;
  const int lo = lane * E;
  unsigned long long cnt = 0;
  for (int i = lo; i < lo + E; ++i) {
    const Slot x = v[i];
    if (i > 0 && is_dup(x, v[i - 1])) continue;
    cnt += KEPT + (better(x, blank) ? ABOVE_BLANK : 0ull) +
           (x.t > 0 ? LIVE_TS : 0ull);
  }
  unsigned long long total;
  const unsigned long long incl = group_scan<kBlock>(cnt, scratch, &total);
  const int n_kept = (int)(total & 0xffff);
  const int above = (int)((total >> 16) & 0xffff);
  const int n_blank = P - n_kept;
  // The kept slots better than a blank are the first `above` of them.
  int c = (int)((incl - cnt) & 0xffff);
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
  if (lane == 0) n_live[row] = (int32_t)((total >> 32) & 0xffff);
}

// 16 < W = wa + wb <= 8192 and 1 <= m_keep <= W are checked by the caller.
extern "C" int sort_slots_wide(const int32_t* a_s, const int32_t* a_d,
                               const int32_t* a_t, int wa, const int32_t* b_s,
                               const int32_t* b_d, const int32_t* b_t, int wb,
                               const int32_t* rmv_vc, int D, int32_t* o_s,
                               int32_t* o_d, int32_t* o_t, int32_t* n_live,
                               int64_t N, int m_keep, void* stream) {
  int P = 32;
  while (P < wa + wb) P <<= 1;
  if (P > WIDE_MAX_P) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (P <= WIDE_WARP_MAX_P) {
    const size_t smem = (size_t)WIDE_ROWS_PER_BLOCK * P * sizeof(Slot);
    const unsigned int blocks =
        (unsigned int)((N + WIDE_ROWS_PER_BLOCK - 1) / WIDE_ROWS_PER_BLOCK);
    sort_slots_wide_kernel<false><<<blocks, 32 * WIDE_ROWS_PER_BLOCK, smem, s>>>(
        a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t,
        n_live, N, m_keep, P);
  } else {
    const int threads = P / 8 < 1024 ? P / 8 : 1024;
    const size_t smem = (size_t)P * sizeof(Slot) + 32 * sizeof(unsigned long long);
    cudaError_t e = cudaFuncSetAttribute(
        sort_slots_wide_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sort_slots_wide_kernel<true><<<(unsigned int)N, threads, smem, s>>>(
        a_s, a_d, a_t, wa, b_s, b_d, b_t, wb, rmv_vc, D, o_s, o_d, o_t,
        n_live, N, m_keep, P);
  }
  return (int)cudaGetLastError();
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
