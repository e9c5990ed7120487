"""The port's scalar replay host (``harness/replay.py``: ``ScalarReplay``,
``FaultInjector``, ``check_convergence``) against the JAX package's.

Every case of ``tests/test_harness.py`` runs again through the port, and
each scenario there runs through both packages from the same seeds:
states, values, convergence flags, counters and the fault injector's
drop and duplicate decisions must be equal."""

import numpy as np
import pytest

from antidote_ccrdt_tpu.harness import opgen as jopgen
from antidote_ccrdt_tpu.harness import replay as jreplay
from antidote_ccrdt_tpu.models import average as jav
from antidote_ccrdt_tpu.models import leaderboard as jlb
from antidote_ccrdt_tpu.models import topk as jtk
from antidote_ccrdt_tpu.models import topk_rmv as jtr
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu_torch.harness import opgen as popgen
from antidote_ccrdt_tpu_torch.harness import replay as preplay
from antidote_ccrdt_tpu_torch.models import average as pav
from antidote_ccrdt_tpu_torch.models import leaderboard as plb
from antidote_ccrdt_tpu_torch.models import topk as ptk
from antidote_ccrdt_tpu_torch.models import topk_rmv as ptr
from antidote_ccrdt_tpu_torch.models import wordcount as pwc
from torch_twins import port_copy

globals().update(port_copy("test_harness.py"))

TYPES = {
    "topk_rmv": (jtr.TopkRmvScalar, ptr.TopkRmvScalar),
    "leaderboard": (jlb.LeaderboardScalar, plb.LeaderboardScalar),
    "topk": (jtk.TopkScalar, ptk.TopkScalar),
    "average": (jav.AverageScalar, pav.AverageScalar),
    "wordcount": (jwc.WordcountScalar, pwc.WordcountScalar),
}


def both(name, n, new_args=(), faults=None, chunks=1, stream=None):
    """(JAX replay, port replay) after the same submissions and syncs."""
    out = []
    for side, (replay, opgen) in enumerate(((jreplay, jopgen), (preplay, popgen))):
        inj = replay.FaultInjector(**faults) if faults else None
        rp = replay.ScalarReplay(TYPES[name][side](), n, new_args=new_args, faults=inj)
        ops = list(opgen.prepare_stream(opgen.Workload(**stream), 150)) if stream else []
        for chunk in (np.array_split(np.arange(len(ops)), chunks) if ops else []):
            for j in chunk:
                rp.submit(*ops[j])
            rp.sync()
        out.append(rp)
    return out


def assert_same(jr, pr):
    assert pr.states == jr.states
    assert pr.values() == jr.values()
    assert pr.converged() == jr.converged()
    assert pr.ops_applied == jr.ops_applied
    assert pr.metrics.counters == jr.metrics.counters


@pytest.mark.parametrize("name,new_args,rmv_frac,rmv_kind", [
    ("topk_rmv", (5,), 0.25, "rmv"),
    ("topk_rmv", (3,), 0.5, "rmv"),
    ("leaderboard", (5,), 0.1, "ban"),
    ("topk", (5,), 0.0, "rmv"),
])
@pytest.mark.parametrize("chunks", [1, 5])
def test_replays_match_jax(name, new_args, rmv_frac, rmv_kind, chunks):
    stream = dict(n_replicas=4, n_ids=30, rmv_frac=rmv_frac, rmv_kind=rmv_kind, seed=42)
    jr, pr = both(name, 4, new_args, stream=stream, chunks=chunks)
    assert_same(jr, pr)
    assert pr.converged()


@pytest.mark.parametrize("faults,converges", [
    (dict(dup_prob=0.5, seed=2), True),
    (dict(drop_prob=0.7, seed=4), False),
    (dict(drop_prob=0.2, dup_prob=0.3, reorder_window=4, seed=9), None),
])
def test_fault_injected_replays_match_jax(faults, converges):
    stream = dict(n_replicas=3, n_ids=15, rmv_frac=0.3, seed=3)
    jr, pr = both("topk_rmv", 3, (4,), faults=faults, stream=stream, chunks=3)
    assert_same(jr, pr)
    if converges is not None:
        assert pr.converged() == converges


@pytest.mark.parametrize("kw", [dict(drop_prob=0.3, seed=1), dict(dup_prob=0.4, seed=5),
                                dict(drop_prob=0.1, dup_prob=0.2, reorder_window=3, seed=8)])
def test_fault_injector_outcomes_match_jax(kw):
    pi, ji = preplay.FaultInjector(**kw), jreplay.FaultInjector(**kw)
    for n in (0, 1, 7, 40, 40):
        deliveries = list(range(n))
        assert pi.transform(deliveries) == ji.transform(deliveries)


@pytest.mark.parametrize("name,ops,dup", [
    ("average", [(0, ("add", 4)), (1, ("add", 8)), (0, ("add", 6))], False),
    ("average", [(0, ("add", 10))], True),
    ("wordcount", [(0, ("add", "a b")), (1, ("add", "b c"))], False),
])
def test_monoid_replays_match_jax(name, ops, dup):
    faults = dict(dup_prob=1.0, seed=1) if dup else None
    jr, pr = both(name, 2 if name == "average" else 3, faults=faults)
    for rp in (jr, pr):
        for origin, op in ops:
            rp.submit(origin, op)
        rp.sync()
    assert_same(jr, pr)
    assert pr.converged() == (not dup)
    assert preplay.check_convergence(pr.crdt, pr.states) == jreplay.check_convergence(jr.crdt, jr.states)
