"""The port's `batch_merge` against the JAX package's, for all six type
names: the scenarios of tests/test_batch_merge.py (partial states built
through the real downstream/update pipeline), mixed live, framework-blob
and reference-ETF inputs, a single state, the empty and size-mismatch
rejections, and topk_rmv at capacities M of 4, 9, 20 and 8400 (the fold's
joins at W = 2M). The port runs with ``device="cpu"`` (every kernel's plain
version); both packages must return `==` states, and the same
`to_binary` bytes.

Also: the fold helpers against JAX's, and the seeded state constructors and the
independent set join that ``chip_smoke.py`` checks the card against.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antidote_ccrdt_tpu.core import batch_merge as jbm
from antidote_ccrdt_tpu.core import wire as jwire
from antidote_ccrdt_tpu.core.behaviour import registry as jreg
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtrd

from antidote_ccrdt_tpu_torch import batch_merge, convert, make_contexts, registry
from antidote_ccrdt_tpu_torch.core import batch_merge as pbm
from antidote_ccrdt_tpu_torch.core import wire as pwire
from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvDenseState

TYPES = ["average", "wordcount", "worddocumentcount", "topk", "leaderboard", "topk_rmv"]


def both(name, states):
    """The port's merge and JAX's, which must be `==` with equal bytes."""
    got = batch_merge(name, states, device="cpu")
    want = jbm.batch_merge(name, states)
    assert got == want
    eng = registry.scalar(name)
    assert eng.to_binary(got) == jreg.scalar(name).to_binary(want)
    return got


def apply_all(name, state, effects):
    return ss.apply_effects(name, state, effects)


def test_average():
    eng = registry.scalar("average")
    effects = [("add", (v, 1)) for v in (5, 10, -3, 8, 9)]
    parts = [apply_all("average", eng.new(), effects[i::3]) for i in range(3)]
    assert both("average", parts) == apply_all("average", eng.new(), effects)


@pytest.mark.parametrize("name", ["wordcount", "worddocumentcount"])
def test_wordcounts(name):
    eng = registry.scalar(name)
    effects = [("add", d) for d in ["a b b c", "b d", "a a\nc d d", "", "x  y"]]
    parts = [apply_all(name, eng.new(), effects[i::2]) for i in range(2)]
    assert both(name, parts) == apply_all(name, eng.new(), effects)


def test_topk():
    eng = registry.scalar("topk")
    rng = np.random.default_rng(0)
    effects = [("add", (int(rng.integers(0, 40)), int(rng.integers(1, 1000)))) for _ in range(200)]
    parts = [apply_all("topk", eng.new(8), effects[i::4]) for i in range(4)]
    assert eng.equal(both("topk", parts), apply_all("topk", eng.new(8), effects))


def test_leaderboard():
    eng = registry.scalar("leaderboard")
    rng = np.random.default_rng(1)
    effects = [("add", (int(rng.integers(0, 30)), int(rng.integers(1, 10_000)))) for _ in range(150)]
    effects += [("ban", pid) for pid in (3, 7, 11)]
    parts = [apply_all("leaderboard", eng.new(5), effects[i::3]) for i in range(3)]
    merged = both("leaderboard", parts)
    ref = apply_all("leaderboard", eng.new(5), effects)
    assert eng.value(merged) == eng.value(ref) and merged.bans == ref.bans and merged.min == ref.min


def test_topk_rmv():
    eng = registry.scalar("topk_rmv")
    ctxs = make_contexts(3)
    rng = np.random.default_rng(2)
    staging, effects = eng.new(6), []
    for step in range(120):
        origin = step % 3
        if rng.random() < 0.15 and staging.observed:
            target = list(staging.observed)[int(rng.integers(0, len(staging.observed)))]
            eff = eng.downstream(("rmv", target), staging, ctxs[origin])
        else:
            op = ("add", (int(rng.integers(0, 25)), int(rng.integers(1, 5000))))
            eff = eng.downstream(op, staging, ctxs[origin])
        if eff is None:
            continue
        effects.append(eff)
        staging = apply_all("topk_rmv", staging, [eff])
    parts = [apply_all("topk_rmv", eng.new(6), effects[i::4]) for i in range(4)]
    merged = both("topk_rmv", parts)
    assert merged == apply_all("topk_rmv", eng.new(6), effects)
    assert merged == ss.topk_rmv_set_join(parts)


@pytest.mark.parametrize("m", [4, 9, 20, 8400])
def test_topk_rmv_capacity(m):
    """M = the largest union of live adds of one id: the canonicalising
    K3 call runs at W = M and the fold's joins at W = 2M (past 16 for M of
    9 and 20; past the 8192 that one block's shared memory holds, the
    card's global-scratch path, for M = 8400). At M = 8400, two states of
    two ids: JAX's union join holds [rows, 2M, 2M] compare planes, about
    1.8 GB a row."""
    n, ids = (2, 2) if m > 4096 else (4, 6)
    states = ss.topk_rmv_capacity_states(m, n=n, n_ids=ids)
    merged = both("topk_rmv", states)
    assert merged == ss.topk_rmv_set_join(states)
    dense, batch, _, _ = pbm.topk_rmv_to_dense(states, "cpu")
    assert dense.M == m and tuple(batch.slot_ts.shape) == (n, 1, ids, m)
    assert len(merged.masked[0]) == m


def test_topk_rmv_one_slot_and_a_removal():
    # M = 1: K3 canonicalises at W = 1 and the fold joins at W = 2; the
    # removal on the other state wins over the add.
    eng = registry.scalar("topk_rmv")
    a = eng.update(("add", (7, 50, ("dc1", 1))), eng.new(100))[0]
    b = eng.update(("rmv", (7, {"dc1": 1})), eng.new(100))[0]
    c = eng.update(("add", (8, 40, ("dc2", 3))), eng.new(100))[0]
    merged = both("topk_rmv", [a, eng.to_binary(b), c])
    assert merged.masked == {8: frozenset({(40, 8, ("dc2", 3))})}
    assert merged.removals == {7: {"dc1": 1}} and merged.vc == {"dc1": 1, "dc2": 3}


def test_accepts_binary_blobs():
    eng = registry.scalar("average")
    a = apply_all("average", eng.new(), [("add", (5, 1))])
    b = apply_all("average", eng.new(), [("add", (7, 2))])
    assert both("average", [eng.to_binary(a), b]) == (12, 3)


@pytest.mark.parametrize("name", TYPES)
def test_mixed_live_framework_and_reference_inputs(name):
    states = ss.seeded_states(name, 3, seed=6)
    eng = registry.scalar(name)
    mixed = [states[0], eng.to_binary(states[1]), pwire.to_reference_binary(name, states[2])]
    assert pwire.to_reference_binary(name, states[2]) == jwire.to_reference_binary(name, states[2])
    got = both(name, mixed)
    assert got == batch_merge(name, states, device="cpu")


@pytest.mark.parametrize("name", TYPES)
def test_single_state_passes_through(name):
    st = ss.seeded_states(name, 1, seed=3)[0]
    assert batch_merge(name, [st], device="cpu") is st
    assert both(name, [registry.scalar(name).to_binary(st)]) == st


@pytest.mark.parametrize("name", TYPES)
def test_empty_rejected(name):
    with pytest.raises(ValueError):
        batch_merge(name, [], device="cpu")


@pytest.mark.parametrize("name", ["topk", "leaderboard", "topk_rmv"])
def test_size_mismatch_rejected(name):
    eng = registry.scalar(name)
    for fn in (lambda s: batch_merge(name, s, device="cpu"), lambda s: jbm.batch_merge(name, s)):
        with pytest.raises(ValueError):
            fn([eng.new(4), eng.new(8)])


@pytest.mark.parametrize("name", ["topk", "leaderboard", "topk_rmv", "wordcount"])
def test_empty_states_merge(name):
    eng = registry.scalar(name)
    both(name, [eng.new(3) if name != "wordcount" else eng.new() for _ in range(3)])


def test_out_of_range_values_rejected():
    eng = registry.scalar("topk")
    low = eng.update(("add", (1, -(2**31 - 1))), eng.new(3))[0]
    with pytest.raises(ValueError, match="sentinel"):
        batch_merge("topk", [low, eng.new(3)], device="cpu")


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_merge("average", [(1, 1), (2, 1)])


# --- the fold helpers ----------------------------------------------------------


def seeded_dense_states(n, seed, m=3):
    rng = np.random.default_rng(seed)
    je = jtrd.make_dense(n_ids=7, n_dcs=3, size=4, slots_per_id=m)
    out = []
    for _ in range(n):
        ts = rng.integers(0, 30, (1, 1, 7, 2 * m)).astype(np.int32)
        sc = np.where(ts > 0, rng.integers(1, 9, ts.shape), -(2**31 - 1)).astype(np.int32)
        dc = np.where(ts > 0, rng.integers(0, 3, ts.shape), 0).astype(np.int32)
        s_, d_, t_, _ = jtrd._sort_slots(jnp.asarray(sc), jnp.asarray(dc), jnp.asarray(ts), m)
        out.append(jtrd.TopkRmvDenseState(
            slot_score=s_, slot_dc=d_, slot_ts=t_,
            rmv_vc=jnp.asarray(rng.integers(0, 20, (1, 1, 7, 3)).astype(np.int32)),
            vc=jnp.asarray(rng.integers(0, 30, (1, 1, 3)).astype(np.int32)),
            lossy=jnp.zeros((1, 1), bool),
        ))
    return je, out


def same(port_state, jax_state):
    got = convert.to_numpy(port_state)
    for k, v in got.items():
        assert np.array_equal(v, np.asarray(getattr(jax_state, k))), k


@pytest.mark.parametrize("n", [1, 2, 5])
def test_fold_states_matches_jax(n):
    je, jstates = seeded_dense_states(n, seed=n)
    pe = registry.make_dense("topk_rmv", n_ids=7, n_dcs=3, size=4, slots_per_id=3, device="cpu")
    pstates = [convert.from_numpy(TopkRmvDenseState, s, "cpu") for s in jstates]
    same(pbm.fold_states(pe.merge, pstates), jbm.fold_states(je.merge, jstates))
    with pytest.raises(ValueError):
        pbm.fold_states(pe.merge, [])


def test_merge_into_host_merge_snapshot_and_nbytes():
    je, (ja, jb) = seeded_dense_states(2, seed=9)
    pe = registry.make_dense("topk_rmv", n_ids=7, n_dcs=3, size=4, slots_per_id=3, device="cpu")
    pa, pb = (convert.from_numpy(TopkRmvDenseState, s, "cpu") for s in (ja, jb))
    keep = pbm.snapshot_state(pa)
    same(pbm.merge_into(pe.merge, pa, pb), jbm.merge_into(je.merge, ja, jb, donate_incoming=False))
    same(pbm.host_merge_into(pe.merge, pa, pb), jbm.host_merge_into(je.merge, ja, jb, donate_incoming=False))
    same(keep, ja)  # merges write no input; the snapshot is a copy
    assert keep.slot_ts.data_ptr() != pa.slot_ts.data_ptr()
    assert pbm.tree_nbytes(pa) == jbm.tree_nbytes(ja)
    staged = pbm.stage_to_device(pa, "cpu")
    same(staged, ja)


def test_prewarm_runs_the_ladder():
    assert pbm.prewarm_topk_rmv(13, n_ids=1, n_dcs=3, max_slots=13, device="cpu") == \
        jbm.prewarm_topk_rmv(13, n_ids=1, n_dcs=3, max_slots=13)


# --- the state constructors chip_smoke.py uses -----------------------------------


def test_direct_states_equal_update_and_set_join_equals_jax():
    effects = ss.topk_rmv_effects(6, n_ids=300, n_adds=400, n_rmvs=40, seed=1)
    eng = registry.scalar("topk_rmv")
    by_update = [ss.apply_effects("topk_rmv", eng.new(20), e) for e in effects]
    direct = [ss.topk_rmv_direct(e, 20) for e in effects]
    assert by_update == direct
    # JAX's scalar model gives the same states from the same ops.
    jeng = jreg.scalar("topk_rmv")
    for e, st in zip(effects, direct):
        js = jeng.new(20)
        for eff in e:
            js, extras = jeng.update(eff, js)
            for x in extras:
                js, _ = jeng.update(x, js)
        assert js == st
    joined = both("topk_rmv", direct)
    assert joined == ss.topk_rmv_set_join(direct)
    assert any(len(v) > 1 for v in joined.removals.values())  # vcs span DCs
    # The removals' vcs cover other states' adds, so the join filters adds
    # that some input still holds.
    assert sum(map(len, joined.masked.values())) < len(set().union(*(
        e for st in direct for e in st.masked.values())))


def test_jax_array_leaves_convert():
    je, (js,) = seeded_dense_states(1, seed=2)
    back = convert.from_numpy(TopkRmvDenseState, js, "cpu")
    assert all(isinstance(x, torch.Tensor) for x in vars(back).values())
    assert jax.tree_util.tree_structure(js).num_leaves == len(vars(back))
