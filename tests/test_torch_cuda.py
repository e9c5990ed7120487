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
