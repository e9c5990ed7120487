"""The port's dense topk_rmv engine against the JAX engine, bit for bit.

The same numpy ops go through both engines (`device="cpu"` for the
port, which then runs every kernel's plain version): multi-round
`apply_ops` in all three `collect_dominated` modes and with
`collect_promotions`, `merge`, `observe`, `value` and `equal`, plus the
scenarios of tests/test_topk_rmv_dense.py. Every leaf is int32 or bool,
so equality is exact. Shapes are shared so the JAX side compiles little.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.models import topk_rmv_dense as jmod
from antidote_ccrdt_tpu.ops import dense_table as jdt
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.models import topk_rmv_dense as pmod
from antidote_ccrdt_tpu_torch.ops import dense_table as pdt
from antidote_ccrdt_tpu_torch.ops.kernels import sort_slots

I32_MIN = int(np.iinfo(np.int32).min)
NEG_INF = pdt.NEG_INF
R, NK, I, D, K, B, BR = 2, 2, 16, 3, 5, 24, 6

# One engine pair per capacity, shared by every test (the JAX engine's
# jit caches key on the instance).
ENGINES = {
    m: (
        jmod.make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=m),
        registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=m, device="cpu"),
    )
    for m in (4, 2, 12)
}
OPS_FIELDS = [f.name for f in dataclasses.fields(pmod.TopkRmvOps)]


def both_ops(arrs):
    """numpy op dict -> (JAX TopkRmvOps, port TopkRmvOps)."""
    j = jmod.TopkRmvOps(**{k: jnp.asarray(arrs[k]) for k in OPS_FIELDS})
    return j, convert.from_numpy(pmod.TopkRmvOps, arrs, "cpu")


def assert_same(port_obj, jax_obj, what=""):
    got = convert.to_numpy(port_obj)
    for name, g in got.items():
        w = getattr(jax_obj, name)
        if g is None or w is None:
            assert g is None and w is None, (what, name)
        elif isinstance(g, dict):
            assert_same(getattr(port_obj, name), w, f"{what}.{name}")
        else:
            assert np.array_equal(g, np.asarray(w)), (what, name)


def pack(effects, b=B, br=BR):
    """Effects, the same at every replica, into one op dict:
    ("add", key, id, score, dc, ts) and ("rmv", key, id, {dc: ts})."""
    a = {k: np.zeros((R, b), np.int32) for k in ("add_key", "add_id", "add_score", "add_dc", "add_ts")}
    r = {"rmv_key": np.zeros((R, br), np.int32), "rmv_id": np.full((R, br), -1, np.int32),
         "rmv_vc": np.zeros((R, br, D), np.int32)}
    adds = [e for e in effects if e[0] == "add"]
    rmvs = [e for e in effects if e[0] == "rmv"]
    for j, (_, key, id_, score, dc, ts) in enumerate(adds):
        a["add_key"][:, j], a["add_id"][:, j], a["add_score"][:, j] = key, id_, score
        a["add_dc"][:, j], a["add_ts"][:, j] = dc, ts
    for j, (_, key, id_, vc) in enumerate(rmvs):
        r["rmv_key"][:, j], r["rmv_id"][:, j] = key, id_
        for dc, ts in vc.items():
            r["rmv_vc"][:, j, dc] = ts
    return {**a, **r}


def random_ops(rng):
    """Adds and removals with out-of-range fields, padding, intra-batch
    duplicates, tied scores and INT32_MIN / NEG_INF scores."""
    scores = np.array([I32_MIN, NEG_INF, 1, 2, 3, 5, 8, 2**31 - 1], np.int32)
    ops = {
        "add_key": rng.integers(-1, NK + 1, (R, B)),
        "add_id": rng.integers(-1, I + 1, (R, B)),
        "add_score": scores[rng.integers(0, len(scores), (R, B))],
        "add_dc": rng.integers(-1, D + 1, (R, B)),
        "add_ts": rng.integers(-1, 30, (R, B)),
        "rmv_key": rng.integers(-1, NK + 1, (R, BR)),
        "rmv_id": rng.integers(-2, I + 1, (R, BR)),
        "rmv_vc": rng.integers(0, 25, (R, BR, D)),
    }
    # In-range fields most of the time, and exact duplicate deliveries.
    for k, hi in (("add_key", NK), ("add_id", I), ("add_dc", D)):
        ops[k] = np.where(rng.random((R, B)) < 0.85, np.clip(ops[k], 0, hi - 1), ops[k])
    ops["add_id"] = np.where(rng.random((R, B)) < 0.5, ops["add_id"] % 4, ops["add_id"])  # crowd few ids
    for f in ("add_key", "add_id", "add_score", "add_dc", "add_ts"):
        ops[f][:, 1::5] = ops[f][:, 0::5][:, : ops[f][:, 1::5].shape[1]]
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in ops.items()}


def run_both(m, batches, **kw):
    """Fold the batches through both engines from init, comparing state
    and extras after every batch; returns the final (port, jax) states."""
    je, pe = ENGINES[m]
    js, ps = je.init(R, NK), pe.init(R, NK)
    for i, arrs in enumerate(batches):
        jo, po = both_ops(arrs)
        js, jx = je.apply_ops(js, jo, **kw)
        ps, px = pe.apply_ops(ps, po, **kw)
        assert_same(ps, js, f"state {i}")
        assert_same(px, jx, f"extras {i}")
    return ps, js


@pytest.mark.parametrize(
    "mode,promotions", [(False, False), ("table", False), (True, True)]
)
def test_multi_round_apply_matches_jax(mode, promotions):
    rng = np.random.default_rng(7)
    ps, js = run_both(
        4, [random_ops(rng) for _ in range(4)],
        collect_dominated=mode, collect_promotions=promotions,
    )
    je, pe = ENGINES[4]
    assert_same(pe.observe(ps), je.observe(js), "observe")
    assert pe.value(ps) == je.value(js)


def test_wide_slots_apply_and_merge_match_jax():
    """slots_per_id=12: every join runs at W = 2M = 24, past the width of
    K3's register network; on a card the wide path takes it (the CPU pin of
    the W > 16 fault, which raised at the first merge)."""
    je, pe = ENGINES[12]
    rng = np.random.default_rng(12)
    crowd = []
    for _ in range(3):
        ops = random_ops(rng)
        ops["add_id"] = np.where(rng.random((R, B)) < 0.8, 1, ops["add_id"]).astype(np.int32)
        ops["add_ts"] = np.where(ops["add_ts"] > 0, rng.integers(1, 10**6, (R, B)), ops["add_ts"]).astype(np.int32)
        crowd.append(ops)
    a_p, a_j = run_both(12, crowd[:2], collect_dominated="table")
    b_p, b_j = run_both(12, crowd[2:], collect_dominated=True, collect_promotions=True)
    assert int((a_p.slot_ts > 0).sum(-1).max()) > 8  # more than half the slots live
    assert_same(pe.merge(a_p, b_p), je.merge(a_j, b_j), "merge")
    assert_same(pe.observe(pe.merge(b_p, a_p)), je.observe(je.merge(b_j, a_j)), "observe")


@pytest.mark.parametrize("seed", range(3))
def test_add_stream_kid_is_sorted_and_agrees_with_kid3(seed):
    # The delta placement (K2) searches each replica's stream by `kid`, so
    # it must be nondecreasing; kid3 marks dropped duplicates with the
    # sentinel mid-stream. Both agree on every live (and so every kept) entry.
    _, pe = ENGINES[4]
    ops = both_ops(random_ops(np.random.default_rng(40 + seed)))[1]
    st = pe.add_stream(ops, NK)
    assert bool((st.kid[:, 1:] >= st.kid[:, :-1]).all())
    live = st.kid3 < NK * I
    assert torch.equal(st.kid[live], st.kid3[live])
    assert bool((st.keep <= live).all()) and bool(st.keep.any())
    assert bool(((st.kid3 != st.kid) & (st.kid < NK * I)).any())


def test_merge_observe_value_equal_match_jax():
    je, pe = ENGINES[4]
    rng = np.random.default_rng(11)
    a_p, a_j = run_both(4, [random_ops(rng) for _ in range(2)], collect_dominated=False)
    b_p, b_j = run_both(4, [random_ops(rng) for _ in range(2)], collect_dominated=False)
    m_p, m_j = pe.merge(a_p, b_p), je.merge(a_j, b_j)
    assert_same(m_p, m_j, "merge")
    assert_same(pe.merge(b_p, a_p), je.merge(b_j, a_j), "merge ba")
    assert_same(pe.observe(m_p), je.observe(m_j), "observe")
    assert pe.value(m_p) == je.value(m_j)
    for x_p, x_j, y_p, y_j in ((a_p, a_j, b_p, b_j), (m_p, m_j, pe.merge(m_p, a_p), je.merge(m_j, a_j))):
        assert pe.equal(x_p, y_p) == je.equal(x_j, y_j)
    # The lattice laws hold observably on the port, as in JAX.
    assert pe.equal(pe.merge(m_p, m_p), m_p)
    assert pe.equal(pe.merge(m_p, pe.init(R, NK)), m_p)


def test_union_join_matches_pairwise_join():
    """The port's union join (K3 fused) is slot-for-slot the independent
    pairwise `_join_slots`, and JAX's `_join_slots_union`."""
    je, pe = ENGINES[4]
    rng = np.random.default_rng(3)
    base_p, _ = run_both(4, [random_ops(rng)], collect_dominated=False)
    for seed in range(3):
        a_p, _ = pe.apply_ops(base_p, both_ops(random_ops(rng))[1], collect_dominated=False)
        b_p, _ = pe.apply_ops(base_p, both_ops(random_ops(rng))[1], collect_dominated=False)
        rmv = torch.maximum(a_p.rmv_vc, b_p.rmv_vc)
        sa = (a_p.slot_score, a_p.slot_dc, a_p.slot_ts)
        sb = (b_p.slot_score, b_p.slot_dc, b_p.slot_ts)
        got = sort_slots([sa, sb], 4, rmv_vc=rmv)
        pair = pmod._join_slots(sa, sb, rmv, 4)
        union = jmod._join_slots_union(
            tuple(jnp.asarray(x.numpy()) for x in sa),
            tuple(jnp.asarray(x.numpy()) for x in sb),
            jnp.asarray(rmv.numpy()), 4,
        )
        for g, p_, u in zip(got, pair, union):
            assert torch.equal(g, p_), seed
            assert np.array_equal(g.numpy(), np.asarray(u)), seed


# --- scenarios of tests/test_topk_rmv_dense.py, through both engines ---------


SCENARIOS = {
    "simple_adds": [[("add", 0, 1, 50, 0, 1), ("add", 0, 2, 30, 0, 2), ("add", 1, 3, 99, 1, 1)]],
    "add_wins_delete": [
        [("add", 0, 1, 45, 0, 1), ("add", 0, 1, 50, 0, 2)],
        [("rmv", 0, 1, {0: 2})],
        [("add", 0, 1, 10, 0, 3)],
        [("add", 0, 1, 45, 0, 1)],  # dominated re-delivery
    ],
    "vc_advances_on_dominated_add": [[("rmv", 0, 1, {0: 5})], [("add", 0, 1, 7, 0, 3)]],
    "out_of_range_adds": [[
        ("add", 0, 16, 99, 0, 5), ("add", 0, -3, 98, 0, 6), ("add", 1, 2, 50, 1, 7),
        ("add", 1, 9, 97, 3, 8), ("add", 2, 1, 9, 0, 9), ("add", -1, 1, 9, 0, 9),
        ("add", 0, 4, 9, -1, 9), ("add", 0, 5, 9, 0, 0), ("add", 0, 6, 9, 0, -4),
    ]],
    "out_of_range_rmvs": [
        [("add", 1, 2, 50, 0, 5)],
        [("rmv", 0, 18, {0: 99, 1: 99}), ("rmv", 9, 1, {0: 99}), ("rmv", -1, 2, {0: 99}),
         ("rmv", 1, -1, {0: 99})],
    ],
    "dominated_table": [
        [("rmv", 0, 1, {0: 5})],
        [("add", 0, 1, 7, 0, 3), ("add", 0, 2, 9, 1, 1)],
    ],
    "extreme_scores": [
        [("add", 0, 1, I32_MIN, 0, 1), ("add", 0, 2, NEG_INF, 1, 2), ("add", 0, 3, 4, 2, 3),
         ("add", 0, 1, NEG_INF, 2, 4), ("add", 0, 4, 2**31 - 1, 0, 5), ("add", 0, 5, NEG_INF, 0, 6)],
        [("rmv", 0, 3, {2: 3}), ("add", 0, 6, I32_MIN, 1, 7)],
    ],
    "all_padding": [[]],
}


@pytest.mark.parametrize("mode", [True, "table"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenarios_match_jax(name, mode):
    ps, js = run_both(4, [pack(b) for b in SCENARIOS[name]],
                      collect_dominated=mode, collect_promotions=mode is True)
    je, pe = ENGINES[4]
    assert_same(pe.observe(ps), je.observe(js), "observe")
    assert pe.value(ps) == je.value(js)


def test_scenario_semantics_on_port():
    _, pe = ENGINES[4]
    st = pe.init(R, NK)
    batches = [pack(b) for b in SCENARIOS["add_wins_delete"]]
    st, _ = pe.apply_ops(st, both_ops(batches[0])[1])
    assert pe.value(st)[0][0] == [(1, 50)]
    st, _ = pe.apply_ops(st, both_ops(batches[1])[1])
    assert pe.value(st)[0][0] == []
    st, ex = pe.apply_ops(st, both_ops(batches[2])[1])
    assert pe.value(st)[0][0] == [(1, 10)] and not bool(ex.dominated.any())
    st2, ex = pe.apply_ops(st, both_ops(batches[3])[1])
    assert bool(ex.dominated[0, 0]) and ex.dominated_vc[0, 0].tolist() == [2, 0, 0]
    assert pe.value(st2)[0][0] == [(1, 10)]
    # Out-of-range fields are dropped whole, not aliased.
    st, _ = pe.apply_ops(pe.init(R, NK), both_ops(pack(SCENARIOS["out_of_range_adds"][0]))[1])
    assert pe.value(st)[0] == [[], [(2, 50)]]
    assert int(st.vc[0, 1, 1]) == 7 and int(st.vc[0, 0].sum()) == 0


def test_promotions_collected():
    """Removing an observed id uncovers a masked one (board of K=5 full)."""
    je, pe = ENGINES[4]
    adds = [("add", 0, i, 10 + i, 0, i + 1) for i in range(6)]  # id 0 masked
    run_both(4, [pack(adds), pack([("rmv", 0, 5, {0: 6})])], collect_promotions=True)
    st, _ = pe.apply_ops(pe.init(R, NK), both_ops(pack(adds))[1])
    st, ex = pe.apply_ops(st, both_ops(pack([("rmv", 0, 5, {0: 6})]))[1], collect_promotions=True)
    p = ex.promoted
    got = [(int(p.ids[0, 0, j]), int(p.scores[0, 0, j])) for j in range(K) if bool(p.valid[0, 0, j])]
    assert got == [(0, 10)]


def test_lossy_overflow_and_intra_batch_duplicates_match_jax():
    # M = 2: three live adds on one id overflow; a duplicated add must not
    # consume a rank.
    a, b = ("add", 0, 0, 30, 0, 1), ("add", 0, 0, 10, 0, 2)
    ps, js = run_both(2, [pack([("add", 0, 0, 10, 0, 1), ("add", 0, 0, 20, 0, 2),
                               ("add", 0, 0, 30, 0, 3)])])
    assert bool(ps.lossy[0, 0]) and not bool(ps.lossy[0, 1])
    ps_dup, _ = run_both(2, [pack([a, a, b]), pack([("rmv", 0, 0, {0: 1})])])
    ps_ref, _ = run_both(2, [pack([a, b]), pack([("rmv", 0, 0, {0: 1})])])
    assert torch.equal(ps_dup.slot_ts, ps_ref.slot_ts) and not bool(ps_dup.lossy.any())
    _, pe = ENGINES[2]
    assert pe.value(ps_dup)[0][0] == [(0, 10)]


@pytest.mark.parametrize("P,k", [(9000, 100), (9000, 7), (300, 50), (40, 100)])
def test_masked_topk_matches_jax(P, k):
    # P > 4096 runs JAX's hierarchical chunked selection.
    rng = np.random.default_rng(P + k)
    vals = np.array([I32_MIN, NEG_INF, 0, 1, 2, 3, 2**31 - 1], np.int32)
    scores = np.where(rng.random((2, 1, P)) < 0.6, vals[rng.integers(0, len(vals), (2, 1, P))],
                      rng.integers(-1000, 1000, (2, 1, P))).astype(np.int32)
    got = pdt.masked_topk(torch.from_numpy(scores), k)
    want = jdt.masked_topk(jnp.asarray(scores), k)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_observables_equal_matches_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 4, (2, 1, 6)).astype(np.int32)
    sc = rng.integers(0, 3, (2, 1, 6)).astype(np.int32)
    va = rng.random((2, 1, 6)) < 0.5
    for other in (ids, (ids + 1).astype(np.int32)):
        a = (ids, sc, va)
        b = (other, sc, va)
        got = pdt.observables_equal(tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
        want = jdt.observables_equal(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
        assert got == want
