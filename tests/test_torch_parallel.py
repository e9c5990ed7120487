"""The port's id-space-sharded engines and collectives
(``parallel/sharded.py``, ``parallel/dist.py``) against the JAX package's.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on 8
logical CPU devices; the same op batches (``tests/test_parallel.py``'s
generators and seeds) go through both, and every leaf of every state and
every ``Observed`` must be equal, bit for bit. The collectives are held
with a combiner that is neither commutative nor associative
(``3a + b`` in wrapping int32), so that the pairing order and the fold
order must be JAX's too.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as JP

from antidote_ccrdt_tpu.parallel import dist as jdist
from antidote_ccrdt_tpu.parallel import sharded as jsh
from antidote_ccrdt_tpu.utils.jaxcompat import shard_map
from antidote_ccrdt_tpu_torch import convert
from antidote_ccrdt_tpu_torch.models.leaderboard import LeaderboardOps
from antidote_ccrdt_tpu_torch.models.topk import TopkOps
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
from antidote_ccrdt_tpu_torch.models.wordcount import WordcountOps
from antidote_ccrdt_tpu_torch.parallel import dist
from antidote_ccrdt_tpu_torch.parallel import sharded as psh
from antidote_ccrdt_tpu_torch.parallel.dist import P
from torch_twins import assert_tree

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_parallel import D_DCS, I_GLOBAL, K, M, R, _lb_ops, gen_ops  # noqa: E402

CPU8 = ["cpu"] * 8


def port_ops(cls, jax_ops):
    """The port's twin of a JAX op batch, on the CPU."""
    return convert.from_numpy(cls, jax_ops, "cpu")


def tuple_equal(got, want):
    for g, w in zip(got, want):
        a, b = g.cpu().numpy(), np.asarray(w)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _topk_rmv_pair():
    jm, pm = jdist.make_mesh(n_dc=2, n_key=2), dist.make_mesh(n_dc=2, n_key=2, devices=CPU8)
    kw = dict(size=K, slots_per_id=M, n_replicas=R)
    return (jsh.make_id_sharded_topk_rmv(jm, I_GLOBAL, D_DCS, **kw),
            psh.make_id_sharded_topk_rmv(pm, I_GLOBAL, D_DCS, **kw))


@pytest.mark.parametrize("seed,rounds", [(0, 3), (1, 2)])
def test_id_sharded_topk_rmv_equals_jax(seed, rounds):
    """`test_parallel.py`'s apply and merge_replicas seeds: the sharded
    tables, `observe` (every leaf of `Observed`) and the merged state."""
    js_eng, ps_eng = _topk_rmv_pair()
    js, ps = js_eng.init(), ps_eng.init()
    assert_tree(ps, js)
    for ops in gen_ops(np.random.default_rng(seed), rounds):
        js = js_eng.apply_ops(js, ops)
        ps = ps_eng.apply_ops(ps, port_ops(TopkRmvOps, ops))
        assert_tree(ps, js)
    tuple_equal(ps_eng.observe(ps), js_eng.observe(js))
    js, ps = js_eng.merge_replicas(js), ps_eng.merge_replicas(ps)
    assert_tree(ps, js)
    tuple_equal(ps_eng.observe(ps), js_eng.observe(js))
    assert {leaf.sharding.spec for leaf in (ps.slot_score, ps.vc)} == {P("dc", None, "key"), P("dc", "key")}


def test_id_sharded_removal_crossing_shards_equals_jax():
    """A removal of id 40 (shard 1's range): the states and observables
    after the add and after the removal are JAX's."""
    js_eng, ps_eng = _topk_rmv_pair()
    z = np.zeros((R, 1), np.int32)
    add = dict(add_key=z, add_id=z + 40, add_score=z + 9, add_dc=z, add_ts=z + 1, rmv_key=z, rmv_id=z - 1,
               rmv_vc=np.zeros((R, 1, D_DCS), np.int32))
    rmv = dict(add_key=z, add_id=z, add_score=z, add_dc=z, add_ts=z, rmv_key=z, rmv_id=z + 40,
               rmv_vc=np.ones((R, 1, D_DCS), np.int32))
    js, ps = js_eng.init(), ps_eng.init()
    for cols in (add, rmv):
        js = js_eng.apply_ops(js, jsh.TopkRmvOps(**{k: jnp.asarray(v) for k, v in cols.items()}))
        ps = ps_eng.apply_ops(ps, convert.from_numpy(TopkRmvOps, cols, "cpu"))
        assert_tree(ps, js)
        tuple_equal(ps_eng.observe(ps), js_eng.observe(js))
    assert not bool(ps_eng.observe(ps).valid.any())


def _score_table_run(kind, seed):
    """(JAX engine, state, observe), (port ...) after 3 seeded rounds and
    merge_replicas, `test_parallel.py`'s shapes."""
    rng = np.random.default_rng(seed)
    jm, pm = jsh.make_mesh2(1, 4, 2), psh.make_mesh2(1, 4, 2, devices=CPU8)
    if kind == "leaderboard":
        je, pe = (jsh.make_id_sharded_leaderboard(jm, n_players_global=64, size=4),
                  psh.make_id_sharded_leaderboard(pm, n_players_global=64, size=4))
    else:
        je, pe = jsh.make_id_sharded_topk(jm, n_ids_global=64, size=4), psh.make_id_sharded_topk(pm, n_ids_global=64, size=4)
    js, ps = je.init(), pe.init()
    for _ in range(3):
        if kind == "leaderboard":
            ops = _lb_ops(rng)
            pops = port_ops(LeaderboardOps, ops)
        else:
            from antidote_ccrdt_tpu.models.topk import TopkOps as JaxTopkOps

            ops = JaxTopkOps(key=jnp.zeros((4, 24), jnp.int32),
                             id=jnp.asarray(rng.integers(0, 64, (4, 24)).astype(np.int32)),
                             score=jnp.asarray(rng.integers(1, 900, (4, 24)).astype(np.int32)),
                             valid=jnp.ones((4, 24), bool))
            pops = port_ops(TopkOps, ops)
        js, ps = je.apply_ops(js, ops), pe.apply_ops(ps, pops)
        assert_tree(ps, js)
    tuple_equal(pe.observe(ps), je.observe(js))
    js, ps = je.merge_replicas(js), pe.merge_replicas(ps)
    assert_tree(ps, js)
    tuple_equal(pe.observe(ps), je.observe(js))


@pytest.mark.parametrize("kind,seed", [("leaderboard", 0), ("leaderboard", 1), ("leaderboard", 2),
                                       ("topk", 0), ("topk", 1)])
def test_score_table_engines_equal_jax(kind, seed):
    _score_table_run(kind, seed)


@pytest.mark.parametrize("seed", range(2))
def test_vocab_sharded_wordcount_equals_jax(seed):
    """Global-token batches (padding and an out-of-range token): the
    sharded counts and the psum reconciliation are JAX's."""
    from antidote_ccrdt_tpu.models.wordcount import WordcountOps as JaxOps

    rng = np.random.default_rng(seed)
    V_g, Rw = 64, 4
    je = jsh.make_vocab_sharded_wordcount(jsh.make_mesh2(1, 4, 2), n_buckets_global=V_g)
    pe = psh.make_vocab_sharded_wordcount(psh.make_mesh2(1, 4, 2, devices=CPU8), n_buckets_global=V_g)
    js, ps = je.init(), pe.init()
    for _ in range(3):
        tok = rng.integers(0, V_g, (Rw, 32)).astype(np.int32)
        tok[:, :3] = -1
        tok[0, 3] = V_g + 5
        key = np.zeros((Rw, 32), np.int32)
        js = je.apply_ops(js, JaxOps(key=jnp.asarray(key), token=jnp.asarray(tok)))
        ps = pe.apply_ops(ps, convert.from_numpy(WordcountOps, dict(key=key, token=tok), "cpu"))
        assert_tree(ps, js)
    got, want = pe.global_counts(ps), je.global_counts(js)
    assert_tree(got, want)
    assert int(got.lost.sum()) == 3


def _nc(a, b):
    """Neither commutative nor associative; wraps in int32 in both
    packages."""
    return a * 3 + b


@pytest.mark.parametrize("n", [2, 4, 3])
def test_lattice_all_reduce_equals_jax(n):
    """Recursive doubling at n = 2 and 4, the gather-reduce fallback at
    n = 3: each block's result is what JAX's device holds."""
    x = np.random.default_rng(n).integers(-2**31, 2**31 - 1, (n, 2, 4), dtype=np.int64).astype(np.int32)
    jmesh = JaxMesh(np.asarray(jax.devices()[: 2 * n]).reshape(n, 2), ("dc", "key"))
    want = jax.jit(shard_map(lambda v: jdist.lattice_all_reduce(v, "dc", _nc, n), mesh=jmesh,
                             in_specs=JP("dc", "key"), out_specs=JP("dc", "key"), check_vma=False))(jnp.asarray(x))
    mesh = dist.make_mesh(n, 2, devices=CPU8)
    got = dist.shard_map(lambda g: dist.along(g, mesh, "dc", lambda col: dist.lattice_all_reduce(col, _nc)),
                         mesh, (P("dc", "key"),), P("dc", "key"))(torch.from_numpy(x))
    tuple_equal([got], [want])
    assert got.sharding == dist.NamedSharding(mesh, P("dc", "key"))


def test_hierarchical_all_reduce_equals_jax():
    """A (2, 2, 2) (dcn, dc, key) mesh: "dc" first, then "dcn"."""
    x = np.random.default_rng(5).integers(-1000, 1000, (2, 2, 2, 3)).astype(np.int32)
    jmesh = jsh.make_mesh2(n_dcn=2, n_dc=2, n_key=2)
    spec = ("dcn", "dc", "key")
    want = jax.jit(shard_map(lambda v: jsh.hierarchical_all_reduce(v, _nc, jmesh), mesh=jmesh,
                             in_specs=JP(*spec), out_specs=JP(*spec), check_vma=False))(jnp.asarray(x))
    mesh = psh.make_mesh2(2, 2, 2, devices=CPU8)
    got = dist.shard_map(lambda g: psh.hierarchical_all_reduce(g, _nc, mesh), mesh, (P(*spec),), P(*spec))(
        torch.from_numpy(x))
    tuple_equal([got], [want])


def test_placement_and_the_one_physical_device_rule():
    """`shard_state`/`shard_ops` tag the specs JAX's give; a placed leaf
    is an alias, the caller's tensor untouched; a mesh over two physical
    devices raises."""
    mesh = dist.make_mesh(n_dc=4, n_key=2, devices=CPU8)
    state, ops = {"t": torch.zeros((4, 2, 8), dtype=torch.int32)}, {"a": torch.zeros((4, 16), dtype=torch.int32)}
    st, op = dist.shard_state(state, mesh), dist.shard_ops(ops, mesh)
    jm = jdist.make_mesh(n_dc=4, n_key=2)
    jst = jdist.shard_state({"t": jnp.zeros((4, 2, 8), jnp.int32)}, jm)
    assert st["t"].sharding == dist.replica_sharding(mesh)
    assert tuple(st["t"].sharding.spec) == tuple(jst["t"].sharding.spec) == ("dc", "key")
    assert tuple(op["a"].sharding.spec) == ("dc",)
    assert len(st["t"].sharding.device_set) == len(jst["t"].sharding.device_set) == 8
    assert st["t"] is not state["t"] and getattr(state["t"], "sharding", None) is None
    assert st["t"].data_ptr() == state["t"].data_ptr()
    with pytest.raises(NotImplementedError, match="physical devices"):
        dist.make_mesh(2, 1, devices=["cpu", "meta"])
