"""The port's CUDA kernels on the card: each against its plain PyTorch
version (which tests/test_torch_kernels.py holds against the JAX
package), and the engine and replay on the card against the same run on
the CPU, bit for bit.

Every test here is marked `cuda` and skips without a card. This module
imports neither jax nor the JAX package, so it runs where only the port
is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from antidote_ccrdt_tpu_torch import batch_merge, convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
from antidote_ccrdt_tpu_torch.harness.scalar_states import (
    seeded_effects,
    seeded_states,
    topk_rmv_capacity_states,
    topk_rmv_effects,
    topk_rmv_set_join,
)
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvDenseState
from antidote_ccrdt_tpu_torch.ops import kernels
from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place, delta_place_plain
from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF, scatter_max_rows

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def k1_inputs(seed, R=3, T=24, D=5, B=20, vmax=2**31 - 1):
    rng = np.random.default_rng(seed)
    table = rng.integers(0, vmax, (R, T, D), dtype=np.int64).astype(np.int32)
    rows = rng.integers(-3, T + 2, (R, B)).astype(np.int32)  # some dropped
    rows[:, ::4] = rows[:, :1]  # duplicate runs
    upd = rng.integers(0, vmax, (R, B, D), dtype=np.int64).astype(np.int32)
    upd[0, 0, 0] = I32_MAX
    return table, rows, upd


def k2_inputs(seed):
    """A sorted add stream with duplicate kid runs, keep gaps, dead
    sentinels and full-range signed scores/ts (as the Pallas test)."""
    rng = np.random.default_rng(200 + seed)
    R, T, M, D, B = 2, 37, 3, 9, 90
    kid = np.sort(rng.integers(0, T + 1, (R, B)).astype(np.int32), axis=1)
    rank = np.full((R, B), M, np.int32)
    keep = np.zeros((R, B), bool)
    for r in range(R):
        prev, cnt = -1, 0
        for j in range(B):
            k = kid[r, j]
            cnt = cnt + 1 if k == prev else 0
            prev = k
            if k < T and cnt < M and rng.random() > 0.25:
                rank[r, j], keep[r, j] = cnt, True
    score = rng.integers(I32_MIN + 2, I32_MAX, (R, B)).astype(np.int32)
    ts = rng.integers(I32_MIN + 2, I32_MAX, (R, B)).astype(np.int32)
    dc = rng.integers(0, D, (R, B)).astype(np.int32)
    return score, ts, dc, kid, rank, keep, T, M, D


def k2_stream(seed, case):
    """A sorted stream as the engine hands K2 (kid nondecreasing; ranks
    counted within each kid run, exact duplicates not ranked and not
    kept; invalid entries under the sentinel T at the tail), shaped to
    reach the kernel's edges: "hot", a kid run longer than one tile of
    256 ids x M cells; "invalid", a replica with no valid entry; "sparse",
    kids in a few ids of a large T, so most tiles find an empty range;
    "ragged", T not a multiple of the tile."""
    rng = np.random.default_rng(400 + seed)
    R, M, B = 3, 4, 3000
    T = {"hot": 1024, "invalid": 700, "sparse": 20_000, "ragged": 1000}[case]
    kid = rng.integers(0, T + 1, (R, B)).astype(np.int32)
    if case == "hot":
        kid[:, : 2 * 256 * M] = 517
    if case == "sparse":
        kid = np.where(kid < T, kid % 9 + 3 * (kid % 5) * 1000, kid).astype(np.int32)
    if case == "invalid":
        kid[1] = T
    kid = np.sort(kid, axis=1)
    rank = np.zeros((R, B), np.int32)
    live = (kid < T) & (rng.random((R, B)) >= 0.2)  # the rest: duplicates, sentinels
    for r in range(R):
        seen = {}
        for j in np.flatnonzero(live[r]):
            rank[r, j] = seen.get(kid[r, j], 0)
            seen[kid[r, j]] = rank[r, j] + 1
    keep = live & (rank < M)
    score = rng.integers(I32_MIN, I32_MAX, (R, B), dtype=np.int64).astype(np.int32)
    score[0, 0] = I32_MAX
    ts = rng.integers(1, I32_MAX, (R, B)).astype(np.int32)
    dc = rng.integers(0, 32, (R, B)).astype(np.int32)
    return score, ts, dc, kid, rank, keep, T, M


SCORES = np.array([I32_MIN, NEG_INF, -3, 0, 1, 2, 5, I32_MAX], np.int32)


def raw_slots(rng, shape, D):
    """Candidates with many empties and exact duplicates, INT32_MIN and
    NEG_INF scores, and dcs outside [0, D)."""
    ts = rng.integers(0, 4, shape).astype(np.int32)
    score = np.where(ts == 0, NEG_INF, SCORES[rng.integers(0, len(SCORES), shape)]).astype(np.int32)
    dc = np.where(ts == 0, 0, rng.integers(-1, D + 1, shape)).astype(np.int32)
    return score, dc, ts


def canonical_side(rng, shape, D):
    """A slot list that keeps the engine's invariant: live slots (ts > 0)
    first, best-first by the direct (score desc, ts desc, dc asc) order,
    no exact duplicates; then holes (NEG_INF, 0, 0)."""
    s, d, tt = raw_slots(rng, shape, D)
    M = shape[-1]
    out = [np.full(shape, NEG_INF, np.int32), np.zeros(shape, np.int32), np.zeros(shape, np.int32)]
    for idx in np.ndindex(*shape[:-1]):
        live = sorted(
            {(int(s[idx][m]), int(tt[idx][m]), int(d[idx][m])) for m in range(M) if tt[idx][m] > 0},
            key=lambda x: (-x[0], -x[1], x[2]),
        )
        for m, (sc, ts_, dc_) in enumerate(live):
            out[0][idx][m], out[2][idx][m], out[1][idx][m] = sc, ts_, dc_
    return tuple(out)


# --- kernels against their plain versions ----------------------------------


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda):
    # The in-place K1; the main path's out-of-place form is K1c below.
    table, rows, upd = k1_inputs(0, R=4, T=1000, D=32, B=512)
    n0 = kernels.scatter_max_rows_.launches
    got = kernels.scatter_max_rows_(t(table).to(cuda), t(rows).to(cuda), t(upd).to(cuda))
    torch.cuda.synchronize()
    assert kernels.scatter_max_rows_.launches == n0 + 1
    assert torch.equal(got.cpu(), kernels.scatter_max_rows_plain_(t(table), t(rows), t(upd)))


@pytest.mark.cuda
@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("T,D", [(1000, 32), (777, 5), (300, 33), (40, 8192)])
def test_k1c_kernel_matches_plain_on_card(cuda, T, D, view):
    # T not a multiple of the tile (8192 / D rows), D whose rows break
    # 16-byte alignment, duplicate and out-of-range rows, INT32_MAX
    # updates; the table contiguous or a stride-0 broadcast view.
    table, rows, upd = k1_inputs(1, R=4, T=T, D=D, B=512)
    tab = t(table).to(cuda)
    if view:
        tab = tab[:1].expand(tab.shape)
    before = tab.clone()
    n0 = kernels.scatter_max_rows_copy.launches
    got = scatter_max_rows(tab, t(rows).to(cuda), t(upd).to(cuda))
    torch.cuda.synchronize()
    assert kernels.scatter_max_rows_copy.launches == n0 + 1
    assert torch.equal(tab, before)
    want = kernels.scatter_max_rows_copy_plain(tab.cpu(), t(rows), t(upd))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_k2_kernel_matches_plain_on_card(cuda, seed):
    score, ts, dc, kid, rank, keep, T, M, _ = k2_inputs(seed)
    args = [t(x) for x in (score, ts, dc, kid, rank, keep)]
    n0 = delta_place.launches
    got = delta_place(*(x.to(cuda) for x in args), T, M)
    torch.cuda.synchronize()
    assert delta_place.launches == n0 + 1
    for g, w in zip(got, delta_place_plain(*args, T, M)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hot", "invalid", "sparse", "ragged"])
def test_k2_kernel_edge_streams_on_card(cuda, case):
    score, ts, dc, kid, rank, keep, T, M = k2_stream(0, case)
    args = [t(x) for x in (score, ts, dc, kid, rank, keep)]
    n0 = delta_place.launches
    got = delta_place(*(x.to(cuda) for x in args), T, M)
    torch.cuda.synchronize()
    assert delta_place.launches == n0 + 1
    for g, w in zip(got, delta_place_plain(*args, T, M)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("w,m,fused", [(8, 4, True), (8, 4, False), (6, 3, False), (16, 8, True)])
def test_k3_kernel_matches_plain_on_card(cuda, w, m, fused):
    rng = np.random.default_rng(w + m)
    D = 3
    k = w // 2
    a = canonical_side(rng, (3, 2, 129, k), D)
    b = canonical_side(rng, (3, 2, 129, w - k), D)
    rmv_vc = t(rng.integers(0, 4, (3, 2, 129, D)).astype(np.int32)) if fused else None
    sides = [tuple(map(t, a)), tuple(map(t, b))]
    n0 = kernels.sort_slots.launches
    got = kernels.sort_slots(
        [tuple(x.to(cuda) for x in s) for s in sides], m,
        rmv_vc=None if rmv_vc is None else rmv_vc.to(cuda),
    )
    torch.cuda.synchronize()
    assert kernels.sort_slots.launches == n0 + 1
    for g, x in zip(got, kernels.sort_slots_plain(sides, m, rmv_vc)):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [9, 13, 16])
def test_k3_register_network_on_raw_rows_on_card(cuda, w):
    # batch_merge's canonicalising call: one side of raw host-order rows,
    # unfused, at W = M (a half-warp a row for 8 < W <= 16).
    rng = np.random.default_rng(100 + w)
    side = tuple(map(t, raw_slots(rng, (2, 1, 301, w), 3)))
    n0 = kernels.sort_slots.launches
    got = kernels.sort_slots([tuple(x.to(cuda) for x in side)], w)
    torch.cuda.synchronize()
    assert kernels.sort_slots.launches == n0 + 1
    for g, x in zip(got, kernels.sort_slots_plain([side], w)):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("two_sides", [False, True])
@pytest.mark.parametrize("w", [17, 24, 40, 256, 300, kernels.WIDE_MAX_SLOTS])
def test_k3_wide_kernel_matches_plain_on_card(cuda, w, two_sides, fused):
    # W > MAX_SLOTS: the warp path (P <= 256) and the block path (P = 512,
    # and the shared-memory maximum); raw candidates with many exact
    # duplicates, INT32_MIN / NEG_INF scores and dcs outside [0, D).
    rng = np.random.default_rng(w + 2 * two_sides + fused)
    D = 3
    lead = (2, 3, 37) if w <= 300 else (2, 3)
    k = w // 2 if two_sides else w
    sides = [tuple(map(t, raw_slots(rng, lead + (k,), D)))]
    if two_sides:
        sides.append(tuple(map(t, raw_slots(rng, lead + (w - k,), D))))
    rmv_vc = t(rng.integers(0, 4, lead + (D,)).astype(np.int32)) if fused else None
    m = w - w // 3
    n0, w0 = kernels.sort_slots.launches, kernels.sort_slots.wide_launches
    got = kernels.sort_slots(
        [tuple(x.to(cuda) for x in s) for s in sides], m,
        rmv_vc=None if rmv_vc is None else rmv_vc.to(cuda),
    )
    torch.cuda.synchronize()
    assert (kernels.sort_slots.launches, kernels.sort_slots.wide_launches) == (n0, w0 + 1)
    for g, x in zip(got, kernels.sort_slots_plain(sides, m, rmv_vc)):
        assert torch.equal(g.cpu(), x)


def mixed_rows(rng, n, wa, wb, D):
    """n rows whose kind changes from row to row, so inside one block:
    canonical sides (the merge path), raw sides (the full sort), rows of
    the fill (NEG_INF, 0, 0) in every slot, canonical sides where side b
    repeats side a's first slots (cross-side duplicates), and sorted side
    a against raw side b. Scores include INT32_MIN and NEG_INF, dcs lie
    in [-1, D]."""
    kind = rng.integers(0, 5, n)
    canon = [canonical_side(rng, (n, w), D) for w in (wa, wb)]
    raw = [raw_slots(rng, (n, w), D) for w in (wa, wb)]
    a = tuple(np.where((kind == 1)[:, None], r, c) for c, r in zip(canon[0], raw[0]))
    b = tuple(np.where(np.isin(kind, (1, 4))[:, None], r, c) for c, r in zip(canon[1], raw[1]))
    k = min(wa, wb)
    for x, y, f in zip(a, b, (NEG_INF, 0, 0)):
        x[kind == 2], y[kind == 2] = f, f
        y[kind == 3, :k], y[kind == 3, k:] = x[kind == 3, :k], f
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("two_sides", [False, True])
@pytest.mark.parametrize("w", [9, 13, 16, 17, 26, 32, 33, 64, 256])
def test_k3_mixed_rows_match_plain_on_card(cuda, w, two_sides, fused):
    # The three per-row paths of the warp kernel (no sort, merge, full
    # sort) side by side in one block; fused, the filter kills some
    # candidates (rmv_vc in [0, 4), ts in [0, 4)) and every candidate of
    # the rows whose tombstones are all 2^30.
    rng = np.random.default_rng(1000 + 4 * w + 2 * two_sides + fused)
    D, n = 3, 301
    wa = (w + 1) // 2 if two_sides else w
    a, b = mixed_rows(rng, n, wa, w - wa, D)
    sides = [tuple(map(t, a))] + ([tuple(map(t, b))] if two_sides else [])
    rmv_vc = None
    if fused:
        vc = rng.integers(0, 4, (n, D)).astype(np.int32)
        vc[rng.random(n) < 0.2] = 1 << 30
        rmv_vc = t(vc)
    m = wa
    counter = "launches" if w <= kernels.MAX_SLOTS else "wide_launches"
    n0 = getattr(kernels.sort_slots, counter)
    got = kernels.sort_slots([tuple(x.to(cuda) for x in s) for s in sides], m,
                             rmv_vc=None if rmv_vc is None else rmv_vc.to(cuda))
    torch.cuda.synchronize()
    assert getattr(kernels.sort_slots, counter) == n0 + 1
    for g, x in zip(got, kernels.sort_slots_plain(sides, m, rmv_vc)):
        assert torch.equal(g.cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("two_sides", [False, True])
@pytest.mark.parametrize("w", [kernels.WIDE_MAX_SLOTS + 1, 16_800])
def test_k3_wider_than_shared_memory_matches_plain_on_card(cuda, w, two_sides, fused):
    # W > WIDE_MAX_SLOTS: one block a row, the row in a device scratch.
    rng = np.random.default_rng(w + 2 * two_sides + fused)
    D, lead = 3, (3,)
    k = w // 2 if two_sides else w
    sides = [tuple(map(t, raw_slots(rng, lead + (k,), D)))]
    if two_sides:
        sides.append(tuple(map(t, raw_slots(rng, lead + (w - k,), D))))
    rmv_vc = t(rng.integers(0, 4, lead + (D,)).astype(np.int32)) if fused else None
    m = w - w // 3
    counters = ("launches", "wide_launches", "global_launches")
    before = [getattr(kernels.sort_slots, c) for c in counters]
    got = kernels.sort_slots([tuple(x.to(cuda) for x in s) for s in sides], m,
                             rmv_vc=None if rmv_vc is None else rmv_vc.to(cuda))
    torch.cuda.synchronize()
    assert [getattr(kernels.sort_slots, c) for c in counters] == [before[0], before[1], before[2] + 1]
    for g, x in zip(got, kernels.sort_slots_plain(sides, m, rmv_vc)):
        assert torch.equal(g.cpu(), x)


def row_path_call(rng, W, N, kind, dev):
    """K3's row-path inputs on the card: "canonical" (fused, two sides
    that keep the slot invariant, side b repeating some of side a's
    candidates, so that duplicates meet across the sides), "raw" (fused,
    two sides of raw host-order candidates), "mixed" (fused, side a
    canonical, side b raw), "unfused" (one raw side, the converter's
    call) or "sorted" (unfused, two canonical sides). Scores include INT32_MIN and NEG_INF and dcs lie in [-1, D];
    fused, a fifth of the rows have every candidate dead."""
    D = 3
    wa = W if kind == "unfused" else W // 2 + W % 7
    raw = [tuple(torch.from_numpy(x).to(dev) for x in raw_slots(rng, (N, w), D)) for w in (wa, W - wa) if w]
    if kind in ("canonical", "sorted"):
        k = min(wa, W - wa) // 3
        raw[1] = tuple(torch.cat([y[:, :k], x[:, k:]], -1) for x, y in zip(raw[1], raw[0]))
    if kind in ("canonical", "mixed", "sorted"):
        raw[0] = kernels.sort_slots_plain([raw[0]], wa)[:3]
    if kind in ("canonical", "sorted"):
        raw[1] = kernels.sort_slots_plain([raw[1]], W - wa)[:3]
    if kind in ("unfused", "sorted"):
        return raw, None
    vc = rng.integers(0, 4, (N, D)).astype(np.int32)
    vc[rng.random(N) < 0.2] = 1 << 30
    return raw, torch.from_numpy(vc).to(dev)


def assert_row_path(sides, m, rmv_vc, W):
    """One K3 call on the card equals the plain K3 on the same card
    inputs, and counts one launch in its W range only."""
    counters = ("launches", "wide_launches", "block_launches", "global_launches")
    before = {c: getattr(kernels.sort_slots, c) for c in counters}
    got = kernels.sort_slots(sides, m, rmv_vc=rmv_vc)
    want = kernels.sort_slots_plain(sides, m, rmv_vc)
    torch.cuda.synchronize()
    block = W <= kernels.WIDE_MAX_SLOTS
    assert {c: getattr(kernels.sort_slots, c) - before[c] for c in counters} == {
        "launches": 0, "wide_launches": int(block), "block_launches": int(block), "global_launches": int(not block)}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["canonical", "raw", "mixed", "unfused"])
@pytest.mark.parametrize("N", [1, 12, 300])
@pytest.mark.parametrize("W", [257, 511, 2000, 4000, 8192, 8193, 16_800, 40_000])
def test_k3_row_paths_match_plain_on_card(cuda, W, N, kind):
    # 256 < W: the tiles of a row over many blocks, merged when both sides
    # are sorted runs and sorted otherwise; 300 rows is more than the
    # card's SMs. m_keep cycles through 1, W / 2 and W over the cases.
    k = ["canonical", "raw", "mixed", "unfused"].index(kind) + [1, 12, 300].index(N)
    rng = np.random.default_rng(W + 7 * N + k)
    sides, vc = row_path_call(rng, W, N, kind, cuda)
    assert_row_path(sides, [1, W // 2, W][k % 3], vc, W)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["canonical", "raw", "unfused", "sorted"])
@pytest.mark.parametrize("tile", [128, 512, 1024, kernels.ROW_TILE_MAX])
@pytest.mark.parametrize("W", [257, 2000, 8193])
def test_k3_row_paths_at_any_tile_on_card(cuda, monkeypatch, W, tile, kind):
    # Whatever tile the wrapper picks, the row paths give the plain K3's
    # rows: from one tile a row to 65 tiles and 7 merge passes.
    rng = np.random.default_rng(3 * W + tile)
    sides, vc = row_path_call(rng, W, 5, kind, cuda)
    monkeypatch.setattr(kernels, "row_tile", lambda w: tile)
    assert_row_path(sides, W - W // 3, vc, W)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [2000, 16_800])
def test_k3_row_paths_over_scratch_chunks_on_card(cuda, monkeypatch, W):
    # Tiles of 128, and a scratch that holds three rows: 12 rows go in
    # four chunks.
    rng = np.random.default_rng(W)
    sides, vc = row_path_call(rng, W, 12, "canonical", cuda)
    monkeypatch.setattr(kernels, "row_tile", lambda w: 128)
    monkeypatch.setattr(kernels, "GLOBAL_SCRATCH_BYTES", 3 * 16 * (2 * W + -(-W // kernels.ROW_SPAN)))
    assert_row_path(sides, W // 2, vc, W)


@pytest.mark.cuda
def test_batch_merge_past_shared_memory_on_card(cuda):
    # M = 8400: the converter's K3 call at W = 8400 and the fold's at
    # W = 16 800 both take the global-scratch path.
    states = topk_rmv_capacity_states(8400)
    n0 = kernels.sort_slots.global_launches
    assert batch_merge("topk_rmv", states, device=cuda) == topk_rmv_set_join(states)
    assert kernels.sort_slots.global_launches >= n0 + 3


@pytest.mark.cuda
def test_engine_wide_slots_on_card_matches_cpu(cuda):
    # slots_per_id=12: apply_ops and merge join at W = 24, the wide path.
    out = {}
    for dev in ("cpu", cuda):
        dense = registry.make_dense("topk_rmv", n_ids=60, n_dcs=4, size=20, slots_per_id=12, device=dev)
        gen = TopkRmvEffectGen(Workload(4, 60, zipf_a=1.2, score_max=50, seed=3), device=dev)
        st = dense.init(4, 1)
        for _ in range(3):
            st, _ = dense.apply_ops(st, gen.next_batch(300, 20))
        flipped = TopkRmvDenseState(**{k: v.flip(0) for k, v in vars(st).items()})
        merged = dense.merge(st, flipped)
        out[str(dev)] = (convert.to_numpy(st), convert.to_numpy(merged))
    assert_trees_equal(out["cpu"], out[str(cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topk_rmv", "topk", "leaderboard", "wordcount", "average"])
def test_batch_merge_on_card_matches_cpu(cuda, name):
    states = seeded_states(name, n_states=6, seed=5)
    n0 = kernels.sort_slots.wide_launches
    assert batch_merge(name, states, device=cuda) == batch_merge(name, states, device="cpu")
    if name == "topk_rmv":
        assert kernels.sort_slots.wide_launches > n0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [False, "table", True])
def test_engine_on_card_matches_cpu(cuda, mode):
    out = {}
    for dev in ("cpu", cuda):
        dense = registry.make_dense("topk_rmv", n_ids=300, n_dcs=4, size=20, slots_per_id=4, device=dev)
        gen = TopkRmvEffectGen(Workload(4, 300, zipf_a=1.2, score_max=50, seed=2), device=dev)
        st = dense.init(4, 1)
        for _ in range(3):
            st, ex = dense.apply_ops(st, gen.next_batch(200, 20), collect_dominated=mode,
                                     collect_promotions=mode is True)
        merged = dense.merge(st, dense.init(4, 1))
        out[str(dev)] = (convert.to_numpy(st), convert.to_numpy(ex), convert.to_numpy(merged),
                         convert.to_numpy(dense.observe(st)))
    assert_trees_equal(out["cpu"], out[str(cuda)])


@pytest.mark.cuda
def test_replay_on_card_matches_cpu(cuda):
    out = {}
    for dev in ("cpu", cuda):
        dense = registry.make_dense("topk_rmv", n_ids=500, n_dcs=4, size=20, slots_per_id=4, device=dev)
        rp = DenseReplay(dense, 4)
        gen = TopkRmvEffectGen(Workload(4, 500, score_max=100, seed=4), device=dev)
        for rnd in range(4):
            rp.apply(gen.next_batch(300, 30))
            rp.sync([1, 1, 3] if rnd == 1 else None)
        out[str(dev)] = (convert.to_numpy(rp.state), convert.to_numpy(rp.observe()))
        assert rp.converged()
    assert_trees_equal(out["cpu"], out[str(cuda)])


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert np.array_equal(a, b)


# --- compaction and the MONOID engines ------------------------------------------


@pytest.mark.cuda
def test_coalesced_apply_launches_the_kernels_and_matches_cpu(cuda):
    out = {}
    for dev in ("cpu", cuda):
        dense = registry.make_dense("topk_rmv", n_ids=400, n_dcs=4, size=20, slots_per_id=4, device=dev)
        gen = TopkRmvEffectGen(Workload(4, 400, zipf_a=1.2, score_max=50, seed=6), device=dev)
        rp = DenseReplay(dense, 4)
        before = (kernels.scatter_max_rows_copy.launches, delta_place.launches, kernels.sort_slots.launches)
        rp.apply_coalesced([gen.next_batch(300, 20) for _ in range(4)])
        after = (kernels.scatter_max_rows_copy.launches, delta_place.launches, kernels.sort_slots.launches)
        if str(dev) != "cpu":
            torch.cuda.synchronize()
            assert all(a > b for a, b in zip(after, before))
        out[str(dev)] = (convert.to_numpy(rp.state), dict(rp.metrics.counters))
    assert out["cpu"][1] == out[str(cuda)][1]
    assert_trees_equal(out["cpu"][0], out[str(cuda)][0])


@pytest.mark.cuda
def test_monoid_engines_on_card_match_cpu(cuda):
    from antidote_ccrdt_tpu_torch.models import average as av
    from antidote_ccrdt_tpu_torch.models import wordcount as wc

    out = {}
    for dev in ("cpu", cuda):
        rng = np.random.default_rng(9)
        avg = registry.make_dense("average", device=dev)
        ops = av.AverageOps(key=t(rng.integers(-5, 40, (3, 500)).astype(np.int32)).to(dev),
                            value=t(rng.choice([2**30, -7, 99], (3, 500)).astype(np.int32)).to(dev),
                            count=t(rng.integers(0, 3, (3, 500)).astype(np.int32)).to(dev))
        a_st, _ = avg.apply_ops(avg.init(3, 32), ops)
        words = registry.make_dense("wordcount", n_buckets=256, device=dev)
        w_st, _ = words.apply_ops(words.init(3, 2), wc.WordcountOps(
            key=t(rng.integers(-2, 2, (3, 900)).astype(np.int32)).to(dev),
            token=t(rng.integers(-1, 270, (3, 900)).astype(np.int32)).to(dev)))
        uniq = t(rng.integers(0, 300, (3, 400)).astype(np.int32)).to(dev)
        lens = t(rng.integers(0, 30, (3, 20)).astype(np.int32)).to(dev)
        counts = t(np.array([400, 250, 0], np.int32)).to(dev)
        table = t(rng.integers(0, 256, 280).astype(np.int32)).to(dev)
        d_st, _ = words.apply_doc_ops_compact(words.init(3, 2), uniq, lens, counts, table, key=1)
        out[str(dev)] = [convert.to_numpy(x) for x in (a_st, avg.merge(a_st, a_st), w_st, d_st)] + [
            avg.observe(a_st).cpu().numpy().view(np.int32)]
    assert_trees_equal(out["cpu"], out[str(cuda)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["topk_rmv", "average", "topk", "leaderboard", "wordcount", "worddocumentcount"])
def test_compact_effect_ops_on_card_matches_cpu(cuda, name):
    from antidote_ccrdt_tpu_torch.ops.compaction import compact_effect_ops

    if name == "topk_rmv":
        effects = [e for es in topk_rmv_effects(3, 40, 60, 6, seed=4) for e in es]
    else:
        effects = [e for es in seeded_effects(name, 3, seed=4) for e in es]
    assert compact_effect_ops(name, effects, device=cuda) == compact_effect_ops(name, effects, device="cpu")


# --- the durable host path on the card ----------------------------------------------


def durable_run(device, root, steps=4, R=4, I=96, D=4, M=4, K=8):
    """A seeded topk_rmv run on `device`, each step logged to an ElasticWal
    under `root` (4 partitions, a checkpoint after step 1), the log then
    dropped without a close; -> (engine, [state after each step])."""
    from antidote_ccrdt_tpu_torch.harness.wal import ElasticWal

    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device=device)
    gen = TopkRmvEffectGen(Workload(R, I, zipf_a=1.1, score_max=300, seed=11), device=device)
    wal = ElasticWal(str(root), "w0", dense, "topk_rmv", partitions=4, durability="group")
    states = [dense.init(R, 1)]
    for step in range(steps):
        states.append(dense.apply_ops(states[-1], gen.next_batch(24, 4), collect_dominated=False)[0])
        wal.log_step(step, list(range(R)), states[-2], states[-1])
        wal.flush()
        if step == 1:
            wal.checkpoint(states[-1], step)
    return dense, states


def same_leaves(a, b):
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(leaves(a), leaves(b)))


@pytest.mark.cuda
def test_wal_recover_on_card_equals_cpu(cuda, tmp_path):
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.harness.wal import ElasticWal

    out = {}
    for name, device in (("cpu", "cpu"), ("card", cuda)):
        dense, states = durable_run(device, tmp_path / name)
        before = kernels.sort_slots.launches
        wal = ElasticWal(str(tmp_path / name), "w0", dense, "topk_rmv", partitions=4)
        rec, last_step, owned = wal.recover(dense.init(4, 1))
        wal.close()
        assert last_step == 3 and owned == {0, 1, 2, 3}
        assert same_leaves(rec, states[-1])
        if name == "card":
            assert rec.slot_score.is_cuda and kernels.sort_slots.launches > before
        out[name] = (rec, pt.state_digests(rec, 4))
    assert same_leaves(out["cpu"][0], out["card"][0])
    assert np.array_equal(out["cpu"][1], out["card"][1])


@pytest.mark.cuda
def test_psnap_repair_on_card_equals_cpu(cuda, tmp_path):
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.core import serial
    from antidote_ccrdt_tpu_torch.parallel.delta import like_delta_for

    out = {}
    for name, device in (("cpu", "cpu"), ("card", cuda)):
        dense, states = durable_run(device, tmp_path / name)
        lagging, live = states[2], states[-1]
        fixed, blobs = lagging, []
        for part in pt.divergent_parts(pt.state_digests(lagging, 4), pt.state_digests(live, 4)):
            payload = serial.dumps_dense("topk_rmv_psnap", pt.restrict_psnap(dense, live, part, 4))
            blobs.append(pt.encode_psnap_blob(3, part, payload))
            _name, psnap = serial.loads_dense(pt.decode_psnap_blob(blobs[-1])[2], like_delta_for(dense, live))
            fixed = pt.apply_psnap(dense, fixed, psnap)
        assert same_leaves(fixed, dense.merge(lagging, live))
        out[name] = (fixed, blobs)
    assert out["cpu"][1] == out["card"][1] and len(out["cpu"][1]) > 1
    assert same_leaves(out["cpu"][0], out["card"][0])


@pytest.mark.cuda
def test_native_drain_on_card_equals_cpu(cuda):
    from antidote_ccrdt_tpu_torch.harness import native_host as nh

    assert nh.available(), nh.build_error()
    rng = np.random.default_rng(2)
    hosts = {"cpu": nh.NativeHost(3), "card": nh.NativeHost(3)}
    for origin in range(3):
        ids, scores = rng.integers(0, 50, 40), rng.integers(1, 900, 40)
        vcs = rng.integers(0, 30, (6, 3)).astype(np.int32)
        rids = rng.integers(0, 50, 6)
        for h in hosts.values():
            h.submit_batch(origin, np.zeros(40, np.int32), None, ids, scores)
            h.submit_batch(origin, np.full(6, nh.KIND_RMV, np.int32), None, rids, vcs=vcs)
    for r in range(3):
        cpu_ops, na, nr = hosts["cpu"].drain_topk_rmv_ops(r, 64, 8, device="cpu")
        card_ops, ca, cr = hosts["card"].drain_topk_rmv_ops(r, 64, 8, device=cuda)
        assert (na, nr) == (ca, cr) and na > 0 and nr > 0
        for f in type(cpu_ops).__dataclass_fields__:
            got = getattr(card_ops, f)
            assert got.is_cuda and torch.equal(got.cpu(), getattr(cpu_ops, f)), f
    for h in hosts.values():
        h.close()



@pytest.mark.cuda
def test_chaos_drill_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 12's chaos drill at its reduced width
    (``GOSSIP_SMALL``) ends, member for member, in the states of the same
    drill on the CPU, with the same fault counters and sweeps; the
    sweeps' joins launched K3 on the card."""
    import chip_smoke

    wrappers = {"sort_slots": kernels.sort_slots}
    cpu = chip_smoke.run_gossip(torch, "cpu", chip_smoke.GOSSIP_SMALL)
    card = chip_smoke.run_gossip(torch, cuda.type, chip_smoke.GOSSIP_SMALL, launches=wrappers)
    assert card["counters"] == cpu["counters"] and card["sweeps"] == cpu["sweeps"]
    assert all(s["skipped"] == 0 for s in card["sweeps"]) and sum(s["deltas"] for s in card["sweeps"]) > 0
    for c in ("net.sim_lost", "net.sim_duplicated", "net.sim_unreachable", "net.dead_events"):
        assert card["counters"].get(c, 0) > 0, c
    assert card["covered"] and all(d == card["ref"] for d in card["digests"].values())
    assert sorted(card["states"]) == sorted(cpu["states"])
    for m, st in card["states"].items():
        assert st.slot_score.is_cuda and same_leaves(st, cpu["states"][m]), m
    assert card["sweep_launches"]["sort_slots"] > 0


@pytest.mark.cuda
def test_served_fleet_on_card_equals_cpu(cuda):
    """chip_smoke.py phase 13's served fleet at its reduced width
    (``FLEET_SMALL``; no client threads, no faults, frozen clocks): every
    gate of the drill holds on both devices, the card's answer bytes,
    read-backs, certificates and digests equal the CPU run's, and the card
    run launched K1c, K2 and K3."""
    import json

    import chip_smoke
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place

    wrappers = {"K1c": kernels.scatter_max_rows_copy, "K2": delta_place, "K3": kernels.sort_slots}
    runs, launched = {}, {}
    for dev in ("cpu", cuda.type):
        before = {n: w.launches for n, w in wrappers.items()}
        with chip_smoke.frozen_wall_clock():
            runs[dev] = chip_smoke.run_fleet(torch, dev, chip_smoke.FLEET_SMALL, storm=False)
        chip_smoke.check_fleet(runs[dev], dev, storm=False)
        launched[dev] = {n: w.launches - before[n] for n, w in wrappers.items()}
    cpu, card = runs["cpu"], runs[cuda.type]
    assert not any(launched["cpu"].values()) and all(launched[cuda.type].values()), launched
    for key in ("answers", "digests", "ref"):
        assert card[key] == cpu[key], key
    for key in ("wcert", "scert"):
        assert json.dumps(card[key], sort_keys=True) == json.dumps(cpu[key], sort_keys=True), key
    assert [st["read_docs"] for st in card["stats"]] == [st["read_docs"] for st in cpu["stats"]]


def _paged_topk_rmv(dev, seed=11, R=3, I=256, D=3, M=4, K=8, B=48, steps=3):
    """An engine on `dev` and a seeded state (adds and removals)."""
    dense = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device=dev)
    gen = TopkRmvEffectGen(Workload(n_replicas=R, n_ids=I, zipf_a=1.1, score_max=500, seed=seed), device=dev)
    state = dense.init(R, 1)
    for _ in range(steps):
        state = dense.apply_ops(state, gen.next_batch(B, 8), collect_dominated=False)[0]
    return dense, state


@pytest.mark.cuda
def test_pager_round_trip_on_card_with_a_pinned_substrate(cuda):
    """Demoting half the partitions of a card state moves them to a pinned
    CPU substrate (stored payloads, cached digests); hydrating them all
    back (the slice joins launch K3) gives the never-demoted state, and
    `full_state` in between equals it too."""
    from antidote_ccrdt_tpu_torch.core import pager as pg
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    dense, state = _paged_topk_rmv(cuda.type)
    ref = [x.clone() for x in leaves(state)]
    pager = pg.PartitionPager(dense, state, P=8, name="topk_rmv")
    for p in range(0, 8, 2):
        state = pager.demote(state, p)
    assert all(x.device.type == "cpu" and x.is_pinned() for x in leaves(pager._cold))
    assert all(x.is_cuda for x in leaves(state))
    assert np.array_equal(pager.digest_vector(state), pt.state_digests(pager.full_state(state), 8))
    assert all(torch.equal(x, y) for x, y in zip(leaves(pager.full_state(state)), ref))
    before = kernels.sort_slots.launches
    for p in sorted(pager.cold_parts()):
        state = pager.hydrate(state, p)
    assert kernels.sort_slots.launches > before and not pager.has_cold()
    assert all(torch.equal(x, y) for x, y in zip(leaves(state), ref))


@pytest.mark.cuda
def test_pager_absorb_and_full_state_on_card_equal_cpu(cuda):
    """The same pager life on the card and on the CPU — demotions, a peer
    delta split hot/cold, a peer's whole state absorbed, `full_state` —
    gives equal device states, substrates, payloads and digests."""
    from antidote_ccrdt_tpu_torch.core import pager as pg
    from antidote_ccrdt_tpu_torch.parallel.delta import make_delta

    runs = {}
    for dev in ("cpu", cuda.type):
        dense, state = _paged_topk_rmv(dev)
        _, peer = _paged_topk_rmv(dev, seed=12)
        pager = pg.PartitionPager(dense, state, P=8, name="topk_rmv")
        for p in (1, 2, 5, 6):
            state = pager.demote(state, p)
        state = pager.apply_delta(state, make_delta(dense, dense.init(3, 1), peer))
        state = dense.merge(state, pager.absorb_peer(peer))
        runs[dev] = (state, pager._cold, [pager._load_payload(p) for p in sorted(pager.cold_parts())],
                     pager.digest_vector(state).tolist(), pager.full_state(state),
                     {k: v for k, v in pager.metrics.counters.items()})
    cpu, card = runs["cpu"], runs[cuda.type]
    assert same_leaves(card[0], cpu[0]) and same_leaves(card[1], cpu[1]) and same_leaves(card[4], cpu[4])
    assert card[2] == cpu[2] and card[3] == cpu[3] and card[5] == cpu[5]
    assert card[5]["pager.cold_folds"] > 0


@pytest.mark.cuda
def test_drain_into_folds_three_staged_windows_on_card(cuda, tmp_path):
    """Three chained deltas prefetched, expanded onto the card and folded
    by one `drain_into` (a `fold_states` of the state and the windows)
    equal the serial merges of the same windows, and the CPU's fold."""
    from antidote_ccrdt_tpu_torch.parallel.delta import expand_delta, make_delta
    from antidote_ccrdt_tpu_torch.parallel.elastic import DeltaPublisher, GossipStore
    from antidote_ccrdt_tpu_torch.parallel.overlap import OverlapPipeline

    got = {}
    for dev in ("cpu", cuda.type):
        dense = registry.make_dense("topk_rmv", n_ids=256, n_dcs=3, size=8, slots_per_id=4, device=dev)
        gen = TopkRmvEffectGen(Workload(n_replicas=3, n_ids=256, zipf_a=1.1, score_max=500, seed=4), device=dev)
        root = str(tmp_path / dev)
        a, b = GossipStore(root, "a"), GossipStore(root, "b")
        pub = DeltaPublisher(a, dense, name="topk_rmv", full_every=100)
        states = [dense.init(3, 1)]
        for _ in range(4):
            states.append(dense.apply_ops(states[-1], gen.next_batch(48, 8), collect_dominated=False)[0])
            pub.publish(states[-1])
        mine = dense.apply_ops(dense.init(3, 1), gen.next_batch(48, 8), collect_dominated=False)[0]
        ovl = OverlapPipeline(b, dense, mine, depth=8, fold_cap=4, start_thread=False)
        assert ovl.prefetch.poll() == 4  # the anchor and 3 deltas
        entries = list(ovl.apq._q)
        assert all(x.device.type == dev for e in entries for x in leaves_of(e.merged))
        folded = ovl.drain_into(mine)
        serial = dense.merge(mine, states[1])
        for k in (2, 3, 4):
            serial = dense.merge(serial, expand_delta(dense, make_delta(dense, states[k - 1], states[k])))
        assert same_leaves(folded, serial)
        assert ovl.metrics.counters["overlap.folds"] == 1 and ovl.metrics.counters["overlap.folded_windows"] == 4
        ovl.close(folded)
        got[dev] = folded
    assert same_leaves(got[cuda.type], got["cpu"])


def leaves_of(state):
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    return leaves(state)


@pytest.mark.cuda
def test_phase_14_reduced_flows_on_card_equal_cpu(cuda):
    """chip_smoke.py phase 14's reduced flows: the overlapped drill and the
    working-set drill at R = 4 give equal states, digests and counters on
    the card and the CPU, and meet their gates."""
    import chip_smoke

    runs = {dev: chip_smoke.run_gossip(torch, dev, chip_smoke.OVERLAP_SMALL, overlap=True) for dev in ("cpu", cuda.type)}
    assert runs["cpu"]["counters"] == runs[cuda.type]["counters"]
    assert runs["cpu"]["digests"] == runs[cuda.type]["digests"]
    for m, st in runs[cuda.type]["states"].items():
        assert st.slot_score.is_cuda and same_leaves(st, runs["cpu"]["states"][m]), m
    ws = {dev: chip_smoke.run_working_set(torch, dev, chip_smoke.WS_SMALL) for dev in ("cpu", cuda.type)}
    for dev, out in ws.items():
        chip_smoke.check_working_set(out, dev)
    for key in ("digest_vector", "observable", "counters", "hit_rates"):
        assert ws["cpu"][key] == ws[cuda.type][key], key
    assert ws[cuda.type]["cold_tier_pinned"]


# --- the bridge server on the card (bridge/server.py) ------------------------

from bridge_ops import TYPES as BRIDGE_TYPES  # noqa: E402


def _bridge_replies(dev, ops, setup=None):
    """The reply frames a BridgeServer on `dev` writes for `ops`, as bytes
    (`setup(server)` first)."""
    from antidote_ccrdt_tpu_torch.bridge import BridgeServer
    from bridge_ops import Raw

    with BridgeServer(device=dev) as srv:
        if setup:
            setup(srv)
        conn = Raw(srv.address)
        try:
            return [conn.ask(op, i) for i, op in enumerate(ops)]
        finally:
            conn.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", BRIDGE_TYPES)
def test_bridge_card_server_equals_cpu_server(cuda, name):
    """One seeded script of a grid's whole surface (tuple, packed,
    packed-multi and extras applies, merge_all, applies on the broadcast
    state, observes, snapshots, error frames): a server on the card writes
    the CPU server's reply frames byte for byte."""
    from bridge_ops import grid_script

    ops = grid_script(name, np.random.default_rng(BRIDGE_TYPES.index(name)))
    assert _bridge_replies(cuda, ops) == _bridge_replies("cpu", ops)


@pytest.mark.cuda
@pytest.mark.parametrize("packed_ids_limit", [2**31, 0], ids=["packed_ids", "eight_planes"])
def test_bridge_multi_equals_sequential_on_card(cuda, monkeypatch, packed_ids_limit):
    """grid_apply_packed_multi of 4 batches on the card: the dominated
    count and the snapshot of 4 sequential grid_apply_packed calls, for
    every type (topk_rmv with and without the packed-ids upload)."""
    from antidote_ccrdt_tpu_torch.bridge import server as server_mod
    from antidote_ccrdt_tpu_torch.core import etf
    from bridge_ops import A, GEOMETRY, NK, R, packed, tuple_ops

    monkeypatch.setattr(server_mod, "_PACKED_IDS_LIMIT", packed_ids_limit)
    for name in BRIDGE_TYPES:
        rng = np.random.default_rng(40 + BRIDGE_TYPES.index(name))
        batches = [packed(name, tuple_ops(name, rng, 10)) for _ in range(4)]
        geo = {A(k): v for k, v in dict(n_replicas=R, n_keys=NK, **GEOMETRY[name]).items()}
        multi = _bridge_replies(cuda, [(A("grid_new"), b"m", A(name), geo), (A("grid_apply_packed_multi"), b"m", batches),
                                       (A("grid_to_binary"), b"m")])
        seq = _bridge_replies(cuda, [(A("grid_new"), b"m", A(name), geo)] + [
            (A("grid_apply_packed"), b"m", b) for b in batches] + [(A("grid_to_binary"), b"m")])
        result = [etf.decode(f[4:])[2][1] for f in seq]
        assert etf.decode(multi[1][4:])[2][1] == sum(result[1:-1]), name
        assert etf.decode(multi[-1][4:])[2][1] == result[-1], name


@pytest.mark.cuda
def test_bridge_merge_all_broadcast_then_apply_on_card(cuda):
    """merge_all leaves a JOIN grid as a stride-0 broadcast of the fold;
    the next apply (K1c on that table, K3 on its slots) reads it without
    writing into it, and the grid ends as the CPU server's does."""
    from antidote_ccrdt_tpu_torch.utils.tree import leaves
    from bridge_ops import A, GEOMETRY, NK, R, tuple_ops

    rng = np.random.default_rng(7)
    b0, b1 = tuple_ops("topk_rmv", rng, 12), tuple_ops("topk_rmv", rng, 12)
    geo = {A(k): v for k, v in dict(n_replicas=R, n_keys=NK, **GEOMETRY["topk_rmv"]).items()}
    ops = [(A("grid_new"), b"g", A("topk_rmv"), geo), (A("grid_apply"), b"g", b0), (A("grid_merge_all"), b"g")]
    seen = {}

    def check_broadcast(srv):
        grid_state = srv._grids[b"g"].state
        if grid_state.slot_score.device.type == "cuda":
            seen["strides"] = [x.stride(0) for x in leaves(grid_state)]
            seen["before"] = [x.clone() for x in leaves(grid_state)]
            seen["leaves"] = leaves(grid_state)

    rest = [(A("grid_apply_extras"), b"g", b1), (A("grid_merge_all"), b"g"), (A("grid_to_binary"), b"g")]
    from antidote_ccrdt_tpu_torch.bridge import BridgeServer
    from bridge_ops import Raw

    frames = {}
    for dev in ("cpu", cuda):
        with BridgeServer(device=dev) as srv:
            conn = Raw(srv.address)
            frames[str(dev)] = [conn.ask(op, i) for i, op in enumerate(ops)]
            check_broadcast(srv)
            frames[str(dev)] += [conn.ask(op, len(ops) + i) for i, op in enumerate(rest)]
            conn.close()
    assert seen["strides"] == [0] * 6
    assert all(torch.equal(x, y) for x, y in zip(seen["leaves"], seen["before"]))
    assert frames["cpu"] == frames[str(cuda)]


# --- the single-process mesh plane -------------------------------------------

MESH_SMALL = (4, 512, 128, 16)  # (R, I, B, Br): rows divide dc, ids divide key


@pytest.mark.cuda
def test_mesh_reduce_on_card_equals_cpu(cuda, monkeypatch):
    """chip_smoke.py's 16a at a small width: the dc all-reduce of the
    same divergent-rows state on a (2, 4) plan over eight logical devices
    of the card is the CPU's bit for bit, and its joins launched K3."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "K", 8)
    got = {d: chip_smoke.run_mesh_reduce(torch, d, MESH_SMALL, checks=False) for d in ("cpu", cuda)}
    for key in ("state", "reduced"):
        assert chip_smoke._same(torch, got["cpu"][key], got[cuda][key]), key
    assert got[cuda]["launches"]["sort_slots"] >= 2 * chip_smoke.MESH_DC * chip_smoke.MESH_KEY
    assert got[cuda]["reduced"].slot_score.sharding.mesh.device.type == "cuda"


@pytest.mark.cuda
def test_mesh_id_sharded_apply_on_card_equals_cpu(cuda, monkeypatch):
    """chip_smoke.py's 16b at a small width: IdShardedTopkRmv's rounds,
    observe and merge_replicas on the card are the CPU's bit for bit (each
    run holds them against the unsharded engine), and every block's apply
    launched K1c, K2 and K3."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "K", 8)
    got = {d: chip_smoke.run_id_sharded(torch, d, MESH_SMALL) for d in ("cpu", cuda)}
    for key in ("state", "merged", "observed"):
        assert chip_smoke._same(torch, got["cpu"][key], got[cuda][key]), key
    blocks = chip_smoke.MESH_DC * chip_smoke.MESH_KEY * chip_smoke.MESH_ID_ROUNDS
    assert all(got[cuda]["launches"][n] >= blocks for n in ("scatter_max_rows_copy", "delta_place", "sort_slots"))


@pytest.mark.cuda
def test_mesh_chaos_and_sharded_engines_on_card_equal_cpu(cuda):
    """chip_smoke.py's 16c: tests/test_mesh.py's chaos drill and the
    sharded leaderboard, topk and wordcount give the CPU's states,
    digests and counters on the card."""
    import chip_smoke

    cpu, card = chip_smoke.run_mesh_chaos(torch, "cpu"), chip_smoke.run_mesh_chaos(torch, cuda)
    assert cpu["digests"] == card["digests"] and cpu["counters"] == card["counters"]
    assert all(d == cpu["ref"] for d in cpu["digests"].values())
    small = {d: chip_smoke.run_sharded_small(torch, d) for d in ("cpu", cuda)}
    for name in small["cpu"]:
        assert all(chip_smoke._same(torch, x, y) for x, y in zip(small["cpu"][name], small[cuda][name])), name


def _multihost_world(tmp, device, nproc, local, backend):
    """A world of the port's multihost workers at the JAX test's shapes:
    the reconciled global state, each process's block in turn."""
    import os

    from antidote_ccrdt_tpu_torch.scripts.multihost_demo import run_world

    tag = f"{device}-{backend}-{nproc}"
    got = run_world(nproc, lambda pid: ["--device", device, "--backend", backend, "--local", str(local),
                                        "--report", os.path.join(str(tmp), f"{tag}-{pid}.json")], timeout_s=300)
    for pid, (rc, out) in enumerate(got):
        assert rc == 0 and f"MULTIHOST-OK {pid}" in out, out
    blocks = [dict(np.load(os.path.join(str(tmp), f"{tag}-{pid}.json.npz"))) for pid in range(nproc)]
    return {p: np.concatenate([b[p] for b in blocks]) for p in blocks[0]}


@pytest.mark.cuda
def test_multihost_gloo_world_on_card_equals_cpu(cuda, tmp_path):
    """2 processes x 4 logical devices of the card over gloo (card blocks
    staged through pinned host memory) reconcile to the CPU world's state."""
    card, cpu = _multihost_world(tmp_path, "cuda", 2, 4, "gloo"), _multihost_world(tmp_path, "cpu", 2, 4, "gloo")
    for p in cpu:
        assert card[p].dtype == cpu[p].dtype and np.array_equal(card[p], cpu[p]), p


@pytest.mark.cuda
def test_multihost_nccl_world_of_one_process_on_card_equals_cpu(cuda, tmp_path):
    """One process of 8 logical devices under nccl (two ranks cannot share
    one card under NCCL): the same state as the CPU's 2 x 4 world."""
    card, cpu = _multihost_world(tmp_path, "cuda", 1, 8, "nccl"), _multihost_world(tmp_path, "cpu", 2, 4, "gloo")
    for p in cpu:
        assert card[p].dtype == cpu[p].dtype and np.array_equal(card[p], cpu[p]), p


@pytest.mark.cuda
def test_multihost_dcp_round_trip_of_a_card_state(cuda, tmp_path):
    """A card state (bool masks included) saved with DCP, waited and async,
    restores onto the card, onto a mesh layout of the card and onto the
    CPU, bit for bit."""
    from antidote_ccrdt_tpu_torch.harness.orbax_ckpt import DenseCheckpointManager
    from antidote_ccrdt_tpu_torch.parallel import dist
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    dense = registry.make_dense("topk_rmv", n_ids=4_096, n_dcs=4, size=8, slots_per_id=2, device=cuda)
    gen = TopkRmvEffectGen(Workload(4, 4_096, zipf_a=1.2, score_max=1_000, seed=3), device=cuda)
    state = dense.apply_ops(dense.init(4, 1), gen.next_batch(512, 64), collect_dominated=False)[0]
    assert state.lossy.dtype == torch.bool and bool(state.lossy.any())  # a bool leaf, set
    sh = dist.NamedSharding(dist.make_mesh(2, 1, devices=[cuda] * 2), dist.P("dc", "key"))
    with DenseCheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2) as mgr:
        mgr.save(1, state)
        mgr.save(2, tree_map(lambda a: dist.device_put(a, sh), state), wait=False)
        assert mgr.all_steps() == [1, 2]
        on_card = mgr.restore(tree_map(torch.zeros_like, state), step=1)
        placed = mgr.restore(tree_map(lambda a: dist.ShapeDtypeStruct(a.shape, a.dtype, sharding=sh), state))
        on_cpu = mgr.restore(tree_map(lambda a: torch.zeros_like(a, device="cpu"), state))
    for got in (on_card, placed, on_cpu):
        assert all(g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()) for g, w in zip(leaves(got), leaves(state)))
    assert all(a.is_cuda for a in leaves(on_card)) and not any(a.is_cuda for a in leaves(on_cpu))
    assert all(a.is_cuda and a.sharding == sh for a in leaves(placed))


def _elastic_fleet(tmp, device):
    """elastic_demo's crash drill (3 port workers at its width, w1 dying at
    step 4) as real processes on `device`: the survivors' final documents."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    procs = {m: subprocess.Popen([sys.executable, "-m", "antidote_ccrdt_tpu_torch.scripts.elastic_demo",
                                  "--root", str(tmp), "--member", m, "--n-members", "3", "--device", device,
                                  *(["--die-at", "4"] if m == "w1" else [])],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
             for m in ("w0", "w1", "w2")}
    try:
        outs = {m: p.communicate(timeout=240)[0] for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert procs["w1"].returncode == 1, outs["w1"]
    finals = {}
    for m in ("w0", "w2"):
        assert procs[m].returncode == 0, outs[m]
        with open(os.path.join(str(tmp), f"final-{m}.json")) as f:
            finals[m] = json.load(f)
    return finals


@pytest.mark.cuda
def test_elastic_crash_fleet_on_card_converges_to_the_card_reference(cuda, tmp_path):
    """Three elastic_demo workers on the card, w1 crashing (os._exit) at
    step 4: the survivors adopt its replicas and reach the sequential
    reference computed on the card, which is the CPU's."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest

    ref = [list(p) for p in reference_digest("topk_rmv", device=cuda)]
    assert ref and ref == [list(p) for p in reference_digest("topk_rmv", device="cpu")]
    for m, final in _elastic_fleet(tmp_path, "cuda").items():
        assert final["digest"] == ref, m
        assert "w1" not in final["alive"]
