"""The port's dense topk and leaderboard engines against the JAX engines,
bit for bit: the same seeded numpy op batches (with out-of-range and
negative keys and ids, padding and tied scores) through `apply_ops`,
`merge`, `observe`, `value`, `equal` and leaderboard's promotions. Every
leaf is int32 or bool, so equality is exact."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from antidote_ccrdt_tpu.models import leaderboard as jlb
from antidote_ccrdt_tpu.models import topk as jtk
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.models import leaderboard as plb
from antidote_ccrdt_tpu_torch.models import topk as ptk
from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF

R, NK, P, K, B = 3, 2, 24, 5, 40
SCORES = np.array([NEG_INF + 1, -7, 0, 1, 2, 3, 50, 2**31 - 1], np.int32)

J_TOPK, P_TOPK = jtk.make_dense(n_ids=P, size=K), registry.make_dense("topk", n_ids=P, size=K, device="cpu")
J_LB = jlb.make_dense(n_players=P, size=K)
P_LB = registry.make_dense("leaderboard", n_players=P, size=K, device="cpu")


def both(jcls, pcls, arrs):
    fields = [f.name for f in dataclasses.fields(pcls)]
    return jcls(**{k: jnp.asarray(arrs[k]) for k in fields}), convert.from_numpy(pcls, arrs, "cpu")


def assert_same(port_obj, jax_obj):
    if isinstance(port_obj, tuple):
        for p, j in zip(port_obj, jax_obj):
            assert_same(p, j)
        return
    got = convert.to_numpy(port_obj) if dataclasses.is_dataclass(port_obj) else {"x": port_obj.numpy()}
    want = {k: np.asarray(getattr(jax_obj, k)) for k in got} if dataclasses.is_dataclass(port_obj) \
        else {"x": np.asarray(jax_obj)}
    for k in got:
        assert np.array_equal(got[k], want[k]), k


def keys_ids(rng, shape):
    """Keys and ids mostly in range; some negative within [-n, 0) (JAX's
    drop-mode scatter wraps those), some below -n or at n and above (dropped)."""
    key = np.where(rng.random(shape) < 0.8, rng.integers(0, NK, shape), rng.integers(-NK - 2, NK + 2, shape))
    id_ = np.where(rng.random(shape) < 0.8, rng.integers(0, P, shape), rng.integers(-P - 3, P + 3, shape))
    return key.astype(np.int32), id_.astype(np.int32)


def topk_ops(rng):
    key, id_ = keys_ids(rng, (R, B))
    return {"key": key, "id": id_, "score": SCORES[rng.integers(0, len(SCORES), (R, B))],
            "valid": rng.random((R, B)) < 0.85}


def lb_ops(rng, bb=6):
    ak, ai = keys_ids(rng, (R, B))
    bk, bi = keys_ids(rng, (R, bb))
    return {"add_key": ak, "add_id": ai, "add_score": SCORES[rng.integers(0, len(SCORES), (R, B))],
            "add_valid": rng.random((R, B)) < 0.85,
            "ban_key": bk, "ban_id": bi, "ban_valid": rng.random((R, bb)) < 0.8}


@pytest.mark.parametrize("seed", range(3))
def test_topk_apply_merge_observe_match_jax(seed):
    rng = np.random.default_rng(seed)
    js, ps = J_TOPK.init(R, NK), P_TOPK.init(R, NK)
    states = []
    for _ in range(3):
        jo, po = both(jtk.TopkOps, ptk.TopkOps, topk_ops(rng))
        js, jx = J_TOPK.apply_ops(js, jo)
        ps, px = P_TOPK.apply_ops(ps, po)
        assert px is None and jx is None
        assert_same(ps, js)
        states.append((ps, js))
    (a_p, a_j), (b_p, b_j) = states[0], states[2]
    assert_same(P_TOPK.merge(a_p, b_p), J_TOPK.merge(a_j, b_j))
    assert_same(P_TOPK.observe(ps), J_TOPK.observe(js))
    assert P_TOPK.value(ps) == J_TOPK.value(js)
    assert P_TOPK.equal(a_p, b_p) == J_TOPK.equal(a_j, b_j)
    assert P_TOPK.equal(ps, P_TOPK.merge(ps, a_p))


def test_topk_negative_ids_wrap_and_far_ids_drop():
    # The JAX scatter's mode="drop" wraps an index in [-n, 0) and drops
    # one outside [-n, n); the port does the same on purpose.
    arrs = {"key": np.array([[0, -1, 0, 0, -3]], np.int32), "id": np.array([[1, 2, -1, P, -P - 1]], np.int32),
            "score": np.array([[10, 20, 30, 40, 50]], np.int32), "valid": np.ones((1, 5), bool)}
    jo, po = both(jtk.TopkOps, ptk.TopkOps, arrs)
    js, _ = J_TOPK.apply_ops(J_TOPK.init(1, NK), jo)
    ps, _ = P_TOPK.apply_ops(P_TOPK.init(1, NK), po)
    assert_same(ps, js)
    assert P_TOPK.value(ps) == [[[(P - 1, 30), (1, 10)], [(2, 20)]]]


@pytest.mark.parametrize("promotions", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_leaderboard_apply_merge_observe_match_jax(seed, promotions):
    rng = np.random.default_rng(10 + seed)
    js, ps = J_LB.init(R, NK), P_LB.init(R, NK)
    history = []
    for _ in range(3):
        jo, po = both(jlb.LeaderboardOps, plb.LeaderboardOps, lb_ops(rng))
        js, jx = J_LB.apply_ops(js, jo, promotions)
        ps, px = P_LB.apply_ops(ps, po, promotions)
        assert_same(ps, js)
        if promotions:
            assert_same(px, jx)
        else:
            assert px is None and jx is None
        history.append((ps, js))
    (a_p, a_j), (b_p, b_j) = history[0], history[1]
    assert_same(P_LB.merge(a_p, b_p), J_LB.merge(a_j, b_j))
    assert_same(P_LB.observe(ps), J_LB.observe(js))
    assert P_LB.value(ps) == J_LB.value(js)
    assert P_LB.equal(a_p, b_p) == J_LB.equal(a_j, b_j)


def test_leaderboard_ban_promotes_a_masked_player():
    adds = {"add_key": np.zeros((1, 7), np.int32), "add_id": np.arange(7, dtype=np.int32)[None],
            "add_score": np.arange(10, 17, dtype=np.int32)[None], "add_valid": np.ones((1, 7), bool),
            "ban_key": np.zeros((1, 1), np.int32), "ban_id": np.zeros((1, 1), np.int32),
            "ban_valid": np.zeros((1, 1), bool)}
    ban = dict(adds, add_valid=np.zeros((1, 7), bool), ban_id=np.array([[6]], np.int32),
               ban_valid=np.ones((1, 1), bool))
    js, ps = J_LB.init(1, 1), P_LB.init(1, 1)
    for arrs in (adds, ban):
        jo, po = both(jlb.LeaderboardOps, plb.LeaderboardOps, arrs)
        js, jx = J_LB.apply_ops(js, jo, True)
        ps, px = P_LB.apply_ops(ps, po, True)
        assert_same(px, jx)
    ids, scores, keep = px
    assert [(int(i), int(s)) for i, s, k in zip(ids[0, 0], scores[0, 0], keep[0, 0]) if k] == [(1, 11)]
    assert P_LB.value(ps) == J_LB.value(js) == [[[(5, 15), (4, 14), (3, 13), (2, 12), (1, 11)]]]


def test_dense_states_cross_as_numpy():
    rng = np.random.default_rng(4)
    jo, po = both(jlb.LeaderboardOps, plb.LeaderboardOps, lb_ops(rng))
    js, _ = J_LB.apply_ops(J_LB.init(R, NK), jo)
    back = convert.from_numpy(plb.LeaderboardDenseState, js, "cpu")
    assert_same(back, js)
    rebuilt = jlb.LeaderboardDenseState(**{k: jnp.asarray(v) for k, v in convert.to_numpy(back).items()})
    assert_same(back, rebuilt)
