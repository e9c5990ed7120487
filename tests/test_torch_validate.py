"""The port's ``utils/validate.py`` and ``DenseReplay.apply(report_drops=
True)`` against the JAX package's, on the same seeded inputs: the checks
pass and fail together with the same error and message, and the drop
reports and replay counters are equal, dict keys included."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antidote_ccrdt_tpu.core.behaviour import registry as jreg
from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay
from antidote_ccrdt_tpu.harness.opgen import TopkRmvEffectGen as JaxGen
from antidote_ccrdt_tpu.harness.opgen import Workload as JaxWorkload
from antidote_ccrdt_tpu.utils import validate as jv
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
from antidote_ccrdt_tpu_torch.utils import validate as pv
from antidote_ccrdt_tpu_torch.utils.tree import flatten_with_path, leaves, map_with_path

R, NK, I, K, M = 3, 2, 40, 6, 4
D = R  # the generator gives one DC a replica
ENGINES = {
    "topk_rmv": dict(n_ids=I, n_dcs=D, size=K, slots_per_id=M),
    "topk": dict(n_ids=I, size=K),
    "leaderboard": dict(n_players=I, size=K),
    "average": {},
    "wordcount": dict(n_buckets=64),
}


def engines(name):
    return jreg.make_dense(name, **ENGINES[name]), registry.make_dense(name, device="cpu", **ENGINES[name])


def _jax_tree(tree, like):
    """The port tree's twin in the JAX package's structure `like`: the
    same leaves, in the same order, as jnp arrays."""
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(like),
                                        [jnp.asarray(x.numpy()) for x in leaves(tree)])


def outcome(fn, *args):
    """What a check does: None, or its exception's type and message."""
    try:
        fn(*args)
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def same_outcome(jax_fn, jax_args, port_fn, port_args):
    got, want = outcome(port_fn, *port_args), outcome(jax_fn, *jax_args)
    assert got == want
    return got


def ops_pair(seed, B=30, Br=6):
    args = dict(n_replicas=R, n_ids=I, zipf_a=1.2, score_max=50, seed=seed)
    return JaxGen(JaxWorkload(**args)).next_batch(B, Br), TopkRmvEffectGen(Workload(**args), device="cpu").next_batch(B, Br)


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_check_state_passes_on_init_and_catches_bad_shapes(name):
    je, pe = engines(name)
    js, ps = je.init(R, NK), pe.init(R, NK)
    assert same_outcome(jv.check_state, (je, js), pv.check_state, (pe, ps)) is None
    # Every leaf cut by one on its last axis, one leaf at a time.
    for k, (path, _) in enumerate(flatten_with_path(ps)):
        def cut(p, x, k=k):
            return x[..., :-1] if p == path else x
        bad = map_with_path(cut, ps)
        assert same_outcome(jv.check_state, (je, _jax_tree(bad, js)), pv.check_state, (pe, bad)) is not None


def test_check_state_rejects_dtype_and_missing_batch_axes():
    je, pe = engines("topk_rmv")
    js, ps = je.init(R, NK), pe.init(R, NK)
    floaty = copy.copy(ps)
    floaty.slot_score = ps.slot_score.float()
    flat = map_with_path(lambda _p, x: x[0, 0], ps)  # no [R, NK] axes
    for bad in (floaty, flat):
        got = same_outcome(jv.check_state, (je, _jax_tree(bad, js)), pv.check_state, (pe, bad))
        assert got is not None


def test_check_tree_dtype_matches_jax():
    _, pops = ops_pair(1)
    jops, _ = ops_pair(1)
    assert same_outcome(jv.check_tree_dtype, (jops, "ops"), pv.check_tree_dtype, (pops, "ops")) is None
    bad = copy.copy(pops)
    bad.add_score = pops.add_score.float()
    got = same_outcome(jv.check_tree_dtype, (_jax_tree(bad, jops), "ops"), pv.check_tree_dtype, (bad, "ops"))
    assert got[0] == "TypeError" and ".add_score: dtype float32, expected int32" in got[1]
    masks = {"keep": torch.ones(3, dtype=torch.bool), "n": torch.zeros(3, dtype=torch.int32)}
    assert same_outcome(jv.check_tree_dtype, (_jax_tree(masks, masks), "m"), pv.check_tree_dtype, (masks, "m")) is None


def test_check_ops_matches_jax():
    je, pe = engines("topk_rmv")
    jops, pops = ops_pair(2)
    js, ps = je.init(R, NK), pe.init(R, NK)
    for args in ((R,), (js,), (R, je)):
        port_args = tuple(ps if a is js else pe if a is je else a for a in args)
        assert same_outcome(jv.check_ops, (args[0], jops) + args[1:], pv.check_ops,
                            (port_args[0], pops) + port_args[1:]) is None
    short = copy.copy(pops)
    short.rmv_id = pops.rmv_id[:2]
    assert same_outcome(jv.check_ops, (R, _jax_tree(short, jops)), pv.check_ops, (R, short))[0] == "ValueError"
    assert same_outcome(jv.check_ops, (R + 1, jops), pv.check_ops, (R + 1, pops))[0] == "ValueError"
    wide = copy.copy(pops)
    wide.rmv_vc = torch.cat([pops.rmv_vc, pops.rmv_vc[..., :1]], -1)
    got = same_outcome(jv.check_ops, (R, _jax_tree(wide, jops), je), pv.check_ops, (R, wide, pe))
    assert got == ("ValueError", f"ops.rmv_vc DC width {D + 1} != engine n_dcs {D}")


def garbage_ops(seed):
    """A seeded batch with padding and out-of-range keys, ids and dcs."""
    rng = np.random.default_rng(seed)
    jops, pops = ops_pair(seed, B=200, Br=40)
    out = {}
    for name, lo, hi in (("add_key", -2, NK + 2), ("add_id", -3, I + 3), ("add_dc", -1, D + 2),
                         ("add_ts", -2, 50), ("rmv_key", -1, NK + 1), ("rmv_id", -4, I + 4)):
        shape = tuple(getattr(pops, name).shape)
        out[name] = rng.integers(lo, hi, shape).astype(np.int32)
    for name, arr in out.items():
        setattr(pops, name, torch.from_numpy(arr))
    jops = type(jops)(**{f: jnp.asarray(out[f]) if f in out else getattr(jops, f)
                         for f in jops.__dataclass_fields__})
    return jops, pops


@pytest.mark.parametrize("seed", range(4))
def test_drop_report_matches_jax(seed):
    je, pe = engines("topk_rmv")
    jops, pops = garbage_ops(seed)
    got = pv.topk_rmv_drop_report(pe, pe.init(R, NK), pops)
    want = jv.topk_rmv_drop_report(je, je.init(R, NK), jops)
    assert got == want and list(got) == list(want)
    assert got["add_dropped_out_of_range"] > 0 and got["add_padding"] > 0 and got["rmv_padding"] > 0


def test_replay_report_drops_counts_match_jax():
    je, pe = engines("topk_rmv")
    jr, pr = JaxReplay(je, R, n_keys=NK), DenseReplay(pe, R, n_keys=NK)
    for seed in range(3):
        jops, pops = garbage_ops(10 + seed)
        jr.apply(jops, report_drops=True)
        pr.apply(pops, report_drops=True)
        for name, arr in convert.to_numpy(pr.state).items():
            assert np.array_equal(arr, np.asarray(getattr(jr.state, name))), name
    keys = ("ops_dropped_out_of_range", "ops_padding", "rounds")
    assert {k: pr.metrics.counters[k] for k in keys} == {k: jr.metrics.counters[k] for k in keys}
    assert pr.metrics.counters["ops_dropped_out_of_range"] > 0
    # Off by default: no counter is touched.
    quiet = DenseReplay(pe, R, n_keys=NK)
    quiet.apply(garbage_ops(20)[1])
    assert "ops_padding" not in quiet.metrics.counters
