"""The port's delta-state replication (topk_rmv, table and lifted-monoid
deltas), `coalesce_deltas`, the MONOID lift and the merge-law checker
against the JAX package's, bit for bit on seeded inputs (CPU); dense blobs
of the new states cross-loading between the packages; and one seeded
mixed replay of the whole slice through both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.core import serial as jserial
from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay
from antidote_ccrdt_tpu.harness.opgen import TopkRmvEffectGen as JaxGen
from antidote_ccrdt_tpu.harness.opgen import Workload as JaxWorkload
from antidote_ccrdt_tpu.models import average as jav
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu.ops import compaction as jc
from antidote_ccrdt_tpu.ops import laws as jlaws
from antidote_ccrdt_tpu.parallel import delta as jdelta
from antidote_ccrdt_tpu.parallel import monoid as jmon
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.core import serial as pserial
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
from antidote_ccrdt_tpu_torch.models import average as pav
from antidote_ccrdt_tpu_torch.models import wordcount as pwc
from antidote_ccrdt_tpu_torch.ops import compaction as pc
from antidote_ccrdt_tpu_torch.ops import laws as plaws
from antidote_ccrdt_tpu_torch.parallel import delta as pdelta
from antidote_ccrdt_tpu_torch.parallel import monoid as pmon


def assert_tree(port, jax_value, path="root"):
    """The same structure, dict keys, shapes, dtypes and values."""
    if isinstance(port, dict):
        assert isinstance(jax_value, dict) and sorted(port) == sorted(jax_value), path
        for k in port:
            assert_tree(port[k], jax_value[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(port):
        assert type(port).__name__ == type(jax_value).__name__, path
        for f in dataclasses.fields(port):
            assert_tree(getattr(port, f.name), getattr(jax_value, f.name), f"{path}.{f.name}")
    elif isinstance(port, torch.Tensor):
        got, want = port.numpy(), np.asarray(jax_value)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert port == jax_value, path


def to_jax(port):
    """A port state (dataclass or dict of tensors, nested) as the JAX
    package's twin."""
    if isinstance(port, dict):
        return {k: to_jax(v) for k, v in port.items()}
    if isinstance(port, torch.Tensor):
        return jnp.asarray(port.numpy())
    twin = {
        "AverageState": jav.AverageState, "WordcountDenseState": jwc.WordcountDenseState,
        "TopkRmvDenseState": jtkr.TopkRmvDenseState, "LiftedMonoidState": jmon.LiftedMonoidState,
        "TopkRmvDelta": jdelta.TopkRmvDelta,
    }[type(port).__name__]
    return twin(**{f.name: (to_jax(getattr(port, f.name)) if not f.metadata.get("static") else getattr(port, f.name))
                   for f in dataclasses.fields(port)})


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- topk_rmv deltas ------------------------------------------------------------

R, I, D, M, K = 3, 64, 3, 4, 8


def topk_rmv_chain(seed):
    """(prev, cur) of a port replay and of a JAX replay fed the same ops."""
    args = dict(n_replicas=R, n_ids=I, zipf_a=1.2, score_max=500, seed=seed)
    jd = jtkr.make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    pd = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")
    jg, pg = JaxGen(JaxWorkload(**args)), TopkRmvEffectGen(Workload(**args), device="cpu")
    jr, pr = JaxReplay(jd, R), DenseReplay(pd, R)
    jr.apply(jg.next_batch(20, 3))
    pr.apply(pg.next_batch(20, 3))
    jr.sync()
    pr.sync()
    jprev, pprev = jr.state, pr.state
    jr.apply(jg.next_batch(6, 2))
    pr.apply(pg.next_batch(6, 2))
    return (jd, jprev, jr.state), (pd, pprev, pr.state)


def test_topk_rmv_delta_round_trip_matches_jax():
    (jd, jprev, jcur), (pd, pprev, pcur) = topk_rmv_chain(3)
    jdl, pdl = jdelta.make_delta(jd, jprev, jcur), pdelta.make_delta(pd, pprev, pcur)
    assert_tree(pdl, jdl)
    assert 0 < pdl.rows.numel() < R * I
    back = pdelta.apply_any_delta(pd, pprev, pdl)
    assert_tree(back, jcur)
    assert pdelta.delta_nbytes(pdl) == jdelta.delta_nbytes(jdl)
    assert pdelta.delta_in_bounds(pd, pcur, pdl)
    bad = dataclasses.replace(pdl, rows=pdl.rows + R * I)
    assert not pdelta.delta_in_bounds(pd, pcur, bad)
    assert_tree(pdelta.like_delta_for(pd, pcur), jdelta.like_delta_for(jd, jcur))


def test_coalesce_topk_rmv_deltas_matches_jax():
    (jd, jprev, jcur), (pd, pprev, pcur) = topk_rmv_chain(4)
    pmid = pd.merge(pprev, pcur)
    jmid = jd.merge(jprev, jcur)
    pds = [pdelta.make_delta(pd, pprev, pmid), pdelta.make_delta(pd, pmid, pcur)]
    jds = [jdelta.make_delta(jd, jprev, jmid), jdelta.make_delta(jd, jmid, jcur)]
    assert_tree(pc.coalesce_deltas(pd, pds), jc.coalesce_deltas(jd, jds))


# --- table deltas ---------------------------------------------------------------


def table_engines(name):
    if name == "average":
        return jav.AverageDense(), registry.make_dense("average", device="cpu")
    return jwc.make_dense(16), registry.make_dense(name, n_buckets=16, device="cpu")


def table_batches(name, seed, n=3, R=2, NK=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "average":
            cols = dict(key=rng.integers(0, NK, (R, 10)).astype(np.int32),
                        value=rng.integers(-20, 40, (R, 10)).astype(np.int32),
                        count=rng.integers(0, 3, (R, 10)).astype(np.int32))
            out.append((jav.AverageOps(**{k: jnp.asarray(v) for k, v in cols.items()}),
                        convert.from_numpy(pav.AverageOps, cols, "cpu")))
        else:
            cols = dict(key=rng.integers(0, NK, (R, 10)).astype(np.int32),
                        token=rng.integers(-1, 20, (R, 10)).astype(np.int32))
            out.append((jwc.WordcountOps(**{k: jnp.asarray(v) for k, v in cols.items()}),
                        convert.from_numpy(pwc.WordcountOps, cols, "cpu")))
    return out


@pytest.mark.parametrize("name", ["average", "wordcount"])
def test_table_deltas_and_coalesce_match_jax(name):
    jd, pd = table_engines(name)
    js, ps = [jd.init(2, 3)], [pd.init(2, 3)]
    for jo, po in table_batches(name, 9):
        js.append(jd.apply_ops(js[-1], jo)[0])
        ps.append(pd.apply_ops(ps[-1], po)[0])
    jds = [jdelta.make_delta(jd, a, b) for a, b in zip(js, js[1:])]
    pds = [pdelta.make_delta(pd, a, b) for a, b in zip(ps, ps[1:])]
    for p, j in zip(pds, jds):
        assert_tree(p, j)  # the dict keys too: ".counts", ".lost", ".sum", ".num"
    whole = pdelta.make_delta(pd, ps[0], ps[-1])
    fused = pc.coalesce_deltas(pd, pds)
    assert_tree(fused, jc.coalesce_deltas(jd, jds))
    assert_tree(pdelta.apply_any_delta(pd, ps[0], fused), js[-1])
    assert_tree(pdelta.apply_any_delta(pd, ps[0], whole), js[-1])
    assert pdelta.delta_in_bounds(pd, ps[-1], fused)
    assert_tree(pdelta.like_delta_for(pd, ps[-1]), jdelta.like_delta_for(jd, js[-1]))


# --- the MONOID lift ------------------------------------------------------------


def lifted_pair():
    jl, pl = jmon.MonoidLift(jav.AverageDense()), pmon.MonoidLift(registry.make_dense("average", device="cpu"))
    return jl, pl


def test_monoid_lift_laws_guard_and_row_deltas_match_jax():
    jl, pl = lifted_pair()
    # Batch k writes only row k % 3 (count 0 elsewhere): the lift's
    # single-writer, write-once contract.
    rng = np.random.default_rng(11)
    batches = []
    for k in range(4):
        cols = dict(key=rng.integers(0, 3, (3, 10)).astype(np.int32),
                    value=rng.integers(-20, 40, (3, 10)).astype(np.int32),
                    count=rng.integers(1, 3, (3, 10)).astype(np.int32))
        cols["count"][np.arange(3) != k % 3] = 0
        batches.append((jav.AverageOps(**{n: jnp.asarray(v) for n, v in cols.items()}),
                        convert.from_numpy(pav.AverageOps, cols, "cpu")))
    js, ps = jl.init(3, 3), pl.init(3, 3)
    jsts, psts = [js], [ps]
    for k, (jo, po) in enumerate(batches):
        owned = [k % 3]
        js = jl.apply_ops(js, jo, owned=owned)[0]
        ps = pl.apply_ops(ps, po, owned=owned)[0]
        jsts.append(js)
        psts.append(ps)
        assert_tree(ps, js)
    a, b, c = psts[1], psts[2], psts[3]
    ja, jb, jc_ = jsts[1], jsts[2], jsts[3]
    assert_tree(pl.merge(a, b), jl.merge(ja, jb))
    for x, y in ((pl.merge(a, b), pl.merge(b, a)), (pl.merge(pl.merge(a, b), c), pl.merge(a, pl.merge(b, c))),
                 (pl.merge(a, a), dataclasses.replace(a, swept=True))):
        assert_tree(x, to_jax(y))
    with pytest.raises(ValueError, match="swept"):
        pl.apply_ops(pl.merge(a, b), batches[0][1])
    pl.apply_ops(pl.merge(a, b), batches[0][1], allow_swept=True)
    assert_tree(pl.total(ps), jl.total(js))

    dl, jdl = pdelta.make_delta(pl, psts[1], psts[4]), jdelta.make_delta(jl, jsts[1], jsts[4])
    assert_tree(dl, jdl)
    back = pdelta.apply_any_delta(pl, psts[1], dl)
    assert back.swept and torch.equal(back.ver, psts[4].ver)
    assert_tree(back, jdelta.apply_any_delta(jl, jsts[1], jdl))
    assert pdelta.delta_in_bounds(pl, ps, dl)
    assert not pdelta.delta_in_bounds(pl, ps, dict(dl, rows=torch.tensor([0, 0, 1], dtype=torch.int32)))
    assert pc.coalesce_deltas(pl, [dl, dl]) is None
    assert_tree(pdelta.like_delta_for(pl, ps), jdelta.like_delta_for(jl, js))

    contrib = pmon.MonoidContributor(pl, 3, 3)
    contrib.apply(batches[0][1], owned=[1])
    contrib.absorb(psts[2])
    assert contrib.view.swept and not contrib.own.swept


# --- the law checker ------------------------------------------------------------

FIXTURES = ["topk", "leaderboard", "wordcount", "worddocumentcount", "average", "topk_rmv"]


@pytest.mark.parametrize("name", FIXTURES)
def test_law_fixtures_and_reports_match_jax(name):
    from antidote_ccrdt_tpu.core.behaviour import registry as jregistry

    pfx = registry.law_fixture(name)(2, 6, device="cpu")
    jfx = jregistry.law_fixture(name)(2, 6)
    for p, j in zip(pfx["states"] + list(pfx["chain"]), jfx["states"] + list(jfx["chain"])):
        for f in dataclasses.fields(p):
            assert np.array_equal(getattr(p, f.name).numpy(), np.asarray(getattr(j, f.name))), f.name
    report = plaws.check_engine_laws(pfx["dense"], pfx["states"], pfx["chain"])
    assert report == jlaws.check_engine_laws(jfx["dense"], jfx["states"], jfx["chain"])
    assert report["ok"]


def test_broken_merge_fixture_is_caught_like_jax():
    pfx, jfx = plaws.broken_merge_fixture(0, 5, device="cpu"), jlaws.broken_merge_fixture(0, 5)
    report = plaws.check_engine_laws(pfx["dense"], pfx["states"], pfx["chain"])
    assert report == jlaws.check_engine_laws(jfx["dense"], jfx["states"], jfx["chain"])
    assert not report["laws"]["commutativity"]["ok"] and not report["laws"]["associativity"]["ok"]
    assert report["laws"]["idempotence"]["ok"] and not report["ok"]
    assert plaws.tree_equal(pfx["states"][0], pfx["states"][0])
    assert not plaws.tree_equal(pfx["states"][0], pfx["states"][1])


# --- dense blobs ----------------------------------------------------------------


def blob_states():
    """(name, port state, JAX twin) for every new state and delta kind."""
    jl, pl = lifted_pair()
    (jo, po), = table_batches("average", 12, n=1, R=3)
    ps = pl.apply_ops(pl.init(3, 3), po, owned=[0])[0]
    js = jl.apply_ops(jl.init(3, 3), jo, owned=[0])[0]
    wj, wp = table_engines("wordcount")
    (wjo, wpo), = table_batches("wordcount", 13, n=1, R=2)
    wps, wjs = wp.apply_ops(wp.init(2, 3), wpo)[0], wj.apply_ops(wj.init(2, 3), wjo)[0]
    (jd, jprev, jcur), (pd, pprev, pcur) = topk_rmv_chain(5)
    return [
        ("average", ps.inner, js.inner),
        ("wordcount", wps, wjs),
        ("average", ps, js),
        ("average", pl.merge(ps, ps), jl.merge(js, js)),
        ("wordcount", pdelta.make_delta(wp, wp.init(2, 3), wps), jdelta.make_delta(wj, wj.init(2, 3), wjs)),
        ("average", pdelta.make_delta(pl, pl.init(3, 3), ps), jdelta.make_delta(jl, jl.init(3, 3), js)),
        ("topk_rmv", pdelta.make_delta(pd, pprev, pcur), jdelta.make_delta(jd, jprev, jcur)),
    ]


def test_dense_blobs_of_the_new_states_cross_load_both_ways():
    for name, port, twin in blob_states():
        got_name, from_port = jserial.loads_dense(pserial.dumps_dense(name, port), twin)
        assert got_name == name
        assert_tree(port, from_port)
        got_name, from_jax = pserial.loads_dense(jserial.dumps_dense(name, twin), port)
        assert got_name == name
        assert_tree(from_jax, twin)


def test_convert_carries_the_new_states():
    jl, pl = lifted_pair()
    (jo, po), = table_batches("average", 12, n=1, R=3)
    port = pl.apply_ops(pl.init(3, 3), po, owned=[0])[0]
    twin = jl.apply_ops(jl.init(3, 3), jo, owned=[0])[0]
    back = convert.from_numpy(pmon.LiftedMonoidState, twin, "cpu", nested={"inner": pav.AverageState})
    assert_tree(back, twin)
    d = convert.to_numpy(port)
    assert d["swept"] is False and set(d["inner"]) == {"sum", "num"}
    log = pc.TopkRmvLog(*(torch.arange(4, dtype=torch.int32) for _ in range(6)), torch.zeros((4, 2), dtype=torch.int32))
    assert_tree(convert.from_numpy(pc.TopkRmvLog, convert.to_numpy(log), "cpu"), log)


# --- the slice, end to end ------------------------------------------------------


def test_slice_mixed_replay_matches_jax():
    """A coalesced topk_rmv round, then average and wordcount rounds with a
    duplicated sync, through both packages; every state equal, the
    coalesced round's delta round-trips, and each engine's laws hold."""
    args = dict(n_replicas=R, n_ids=I, zipf_a=1.2, score_max=500, seed=21)
    jd = jtkr.make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    pd = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")
    jg, pg = JaxGen(JaxWorkload(**args)), TopkRmvEffectGen(Workload(**args), device="cpu")
    jr, pr = JaxReplay(jd, R), DenseReplay(pd, R)
    jr.apply(jg.next_batch(16, 2))
    pr.apply(pg.next_batch(16, 2))
    jprev, pprev = jr.state, pr.state
    jr.apply_coalesced([jg.next_batch(16, 3) for _ in range(3)])
    pr.apply_coalesced([pg.next_batch(16, 3) for _ in range(3)])
    assert_tree(pr.state, jr.state)
    assert_tree(pdelta.apply_any_delta(pd, pprev, pdelta.make_delta(pd, pprev, pr.state)), jr.state)
    jr.sync([0, 0, 2])
    pr.sync([0, 0, 2])
    assert_tree(pr.full_state(), jr.full_state())

    for name in ("average", "wordcount"):
        jdn, pdn = table_engines(name)
        jrp, prp = JaxReplay(jdn, 2, n_keys=3), DenseReplay(pdn, 2, n_keys=3)
        for k, (jo, po) in enumerate(table_batches(name, 30, n=4)):
            jrp.apply(jo)
            prp.apply(po)
            if k == 1:
                jrp.sync([0, 0, 1])
                prp.sync([0, 0, 1])
        jrp.sync()
        prp.sync()
        assert_tree(prp.base, jrp.base)
        assert_tree(prp.full_state(), jrp.full_state())
        assert np.array_equal(prp.observe().numpy(), np.asarray(jrp.observe()))
    for name in ("topk_rmv", "average", "wordcount"):
        fx = registry.law_fixture(name)(1, 4, device="cpu")
        assert plaws.check_engine_laws(fx["dense"], fx["states"], fx["chain"])["ok"]
