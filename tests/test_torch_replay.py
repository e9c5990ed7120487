"""The port's effect-op generator and DenseReplay against the JAX ones.

One seed drives both generators; the port's batches must equal the JAX
batches array for array, and a DenseReplay of the port (on the CPU, plain
kernel versions) must hold the same state as the JAX DenseReplay after
every apply and sync — including syncs whose contributors repeat or omit
replicas, and a total loss.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay
from antidote_ccrdt_tpu.harness.opgen import TopkRmvEffectGen as JaxGen
from antidote_ccrdt_tpu.harness.opgen import Workload as JaxWorkload
from antidote_ccrdt_tpu.models.topk_rmv_dense import make_dense as jax_make_dense
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay, fold_rows
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload

R, I, D, K, M, B, BR = 4, 48, 4, 6, 4, 40, 6

JAX_ENGINE = jax_make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M)
PORT_ENGINE = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")


def workloads(seed, zipf_a=1.2):
    args = dict(n_replicas=R, n_ids=I, zipf_a=zipf_a, score_max=30, seed=seed)
    return JaxWorkload(**args), Workload(**args)


def assert_same(port_obj, jax_obj):
    for name, g in convert.to_numpy(port_obj).items():
        assert np.array_equal(g, np.asarray(getattr(jax_obj, name))), name


@pytest.mark.parametrize("zipf_a", [1.2, 1.0])
def test_effect_gen_emits_the_jax_batches(zipf_a):
    jw, pw = workloads(3, zipf_a=zipf_a)
    jg, pg = JaxGen(jw), TopkRmvEffectGen(pw, device="cpu")
    for b, br in ((B, BR), (B, 0), (7, 3)):
        assert_same(pg.next_batch(b, br), jg.next_batch(b, br))


def test_replay_apply_sync_observe_match_jax():
    jw, pw = workloads(5)
    jg, pg = JaxGen(jw), TopkRmvEffectGen(pw, device="cpu")
    jr, pr = JaxReplay(JAX_ENGINE, R), DenseReplay(PORT_ENGINE, R)
    schedule = [None, [0, 0, 2], [1], [], [3, 1, 3, 2, 0]]
    for contributors in schedule:
        for _ in range(2):
            jo, po = jg.next_batch(B, BR), pg.next_batch(B, BR)
            jx, px = jr.apply(jo), pr.apply(po)
            assert_same(pr.state, jr.state)
            assert np.array_equal(px.dominated_tbl.numpy(), np.asarray(jx.dominated_tbl))
        jr.sync(contributors)
        pr.sync(contributors)
        assert_same(pr.full_state(), jr.full_state())
        assert_same(pr.observe(), jr.observe())
        assert pr.converged() == jr.converged()
    assert pr.converged()
    assert pr.metrics.counters["rounds"] == 2 * len(schedule)
    assert pr.metrics.counters["syncs"] == len(schedule)


def test_fold_rows_with_repeats_matches_jax():
    jw, pw = workloads(9)
    jr, pr = JaxReplay(JAX_ENGINE, R), DenseReplay(PORT_ENGINE, R)
    jr.apply(JaxGen(jw).next_batch(B, BR))
    pr.apply(TopkRmvEffectGen(pw, device="cpu").next_batch(B, BR))
    from antidote_ccrdt_tpu.harness.dense_replay import fold_rows as jax_fold_rows

    for contributors in ([2], [1, 1], [3, 0, 2]):
        assert_same(
            fold_rows(PORT_ENGINE, pr.state, contributors),
            jax_fold_rows(JAX_ENGINE, jr.state, contributors),
        )


def test_convert_round_trips_jax_state():
    jw, _ = workloads(1)
    jr = JaxReplay(JAX_ENGINE, R)
    jr.apply(JaxGen(jw).next_batch(B, BR))
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvDenseState

    port = convert.from_numpy(TopkRmvDenseState, jr.state, "cpu")
    assert_same(port, jr.state)
    back = type(jr.state)(**{k: jnp.asarray(v) for k, v in convert.to_numpy(port).items()})
    for f in dataclasses.fields(back):
        assert np.array_equal(np.asarray(getattr(back, f.name)), np.asarray(getattr(jr.state, f.name)))
