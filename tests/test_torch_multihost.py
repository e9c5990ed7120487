"""The port's multi-process plane (``parallel/multihost.py`` over
``torch.distributed``, its worker
``antidote_ccrdt_tpu_torch/scripts/multihost_demo.py``) against the JAX
package's (``jax.distributed``, ``scripts/multihost_demo.py``).

Real separate OS processes on the CPU over ``gloo``, as
``tests/test_multihost.py`` runs JAX's:

* ``test_multihost_convergence``: 2 processes of 4 logical devices, each
  printing ``MULTIHOST-OK``;
* each process's reconciled block equals JAX's
  ``multihost.hierarchical_reconcile`` of the same ops on a hand-built
  (dcn, dc, key) mesh over the conftest's virtual devices, leaf for leaf:
  (2, 4, 1), (3, 2, 1) (the non-power-of-two fallback across processes)
  and (2, 2, 2) through ``process_local_shards``;
* the R != n_dcn * n_dc error is JAX's, type and message;
* a world's port lies below the kernel's range of ephemeral ports;
* chip_smoke.py's phase 17 at small shapes on the CPU.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from antidote_ccrdt_tpu_torch.parallel import multihost as pmh
from antidote_ccrdt_tpu_torch.parallel.dist import logical_devices
from antidote_ccrdt_tpu_torch.scripts import multihost_demo as demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One thread a worker: several worlds may run at once under xdist.
WORKER_ENV = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def run_cpu_world(tmp, nproc, local, n_key=1, extra=()):
    """A world of the port's workers on the CPU (gloo): each worker's
    output, report and reconciled block."""
    tmp = str(tmp)
    got = demo.run_world(nproc, lambda pid: ["--device", "cpu", "--local", str(local), "--n-key", str(n_key),
                                             "--report", os.path.join(tmp, f"w{pid}.json"), *extra],
                         timeout_s=240, env=WORKER_ENV)
    out = []
    for pid, (rc, text) in enumerate(got):
        assert rc == 0, f"worker {pid} failed:\n{text}"
        assert f"MULTIHOST-OK {pid}" in text, f"worker {pid} output:\n{text}"
        path = os.path.join(tmp, f"w{pid}.json")
        with open(path) as f:
            report = json.load(f)
        out.append((text, report, dict(np.load(path + ".npz"))))
    return out


@functools.lru_cache(maxsize=None)
def jax_reconciled(nproc, local, n_key=1):
    """JAX's hierarchical_reconcile of the demo's workload on a hand-built
    (nproc, local / n_key, n_key) mesh of this process's virtual devices:
    {leaf path: the global array}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP

    from antidote_ccrdt_tpu.models.topk_rmv_dense import TopkRmvOps, make_dense
    from antidote_ccrdt_tpu.parallel import multihost as jmh

    n_dc = local // n_key
    R = nproc * n_dc
    devs = np.asarray(jax.devices()[: nproc * local]).reshape(nproc, n_dc, n_key)
    mesh = Mesh(devs, ("dcn", "dc", "key"))
    D = make_dense(n_ids=demo.I, n_dcs=demo.DCS, size=demo.K, slots_per_id=demo.M)
    state = jax.device_put(D.init(n_replicas=R, n_keys=n_key), jmh.state_sharding(mesh))
    every = [demo.replica_ops(r, demo.DCS, n_key) for r in range(R)]
    op_sh = NamedSharding(mesh, JP(("dcn", "dc")))
    ops = TopkRmvOps(**{k: jax.device_put(jnp.asarray(np.concatenate([o[k] for o in every])), op_sh)
                        for k in every[0]})
    state = D.apply_ops(state, ops, collect_dominated=False)[0]
    out = jmh.hierarchical_reconcile(state, D.merge, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(out)
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in flat}


def assert_blocks_equal_jax(world, want, rows):
    for pid, (_text, report, block) in enumerate(world):
        assert report["block_rows"] == [pid * rows, (pid + 1) * rows]
        assert sorted(block) == sorted(want)
        for path, a in want.items():
            mine = block[path]
            assert mine.dtype == a.dtype, path
            assert np.array_equal(mine, a[pid * rows:(pid + 1) * rows]), (pid, path)


@pytest.fixture(scope="module")
def world_2x4(tmp_path_factory):
    """The JAX test's world (2 processes x 4 devices), saving its state."""
    tmp = tmp_path_factory.mktemp("world_2x4")
    return run_cpu_world(tmp, 2, 4, extra=["--ckpt", str(tmp / "ckpt")]), tmp


def test_multihost_convergence(world_2x4):
    world, _tmp = world_2x4
    for pid, (text, report, _block) in enumerate(world):
        assert f"MULTIHOST-OK {pid}" in text
        assert (report["backend"], report["device"], report["local"]) == ("gloo", "cpu", 4)
        assert report["dcn_bytes"] > 0 and report["valid_observed"] > 0


def test_reconciled_blocks_equal_jax_2x4(world_2x4):
    assert_blocks_equal_jax(world_2x4[0], jax_reconciled(2, 4), 4)


def test_world_checkpoint_restores_whole_to_jax(world_2x4):
    """The world's collective DCP save, restored whole by this process,
    is JAX's reconciled global state (each process wrote its block)."""
    from antidote_ccrdt_tpu_torch.harness.orbax_ckpt import DenseCheckpointManager
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense
    from antidote_ccrdt_tpu_torch.utils.tree import flatten_with_path

    _world, tmp = world_2x4
    D = make_dense(n_ids=demo.I, n_dcs=demo.DCS, size=demo.K, slots_per_id=demo.M, device="cpu")
    with DenseCheckpointManager(str(tmp / "ckpt")) as mgr:
        assert mgr.all_steps() == [0]
        got = mgr.restore(D.init(8, 1))
    want = jax_reconciled(2, 4)
    for path, leaf in flatten_with_path(got):
        assert np.array_equal(leaf.numpy(), want[path]), path


def test_three_processes_fall_back_to_a_gather_like_jax(tmp_path):
    """3 processes of 2 devices: the dcn axis is not a power of two, so
    both packages gather every process's block and fold them in order."""
    world = run_cpu_world(tmp_path, 3, 2)
    assert all(r["dcn_bytes"] > 0 for _t, r, _b in world)
    assert_blocks_equal_jax(world, jax_reconciled(3, 2), 2)


def test_key_axis_of_two_through_process_local_shards(tmp_path):
    """(dcn, dc, key) = (2, 2, 2): two instances, the key axis inside each
    process; every process's block (its replica rows, every instance)
    equals JAX's process-local region."""
    world = run_cpu_world(tmp_path, 2, 4, n_key=2)
    want = jax_reconciled(2, 4, n_key=2)
    assert want[".slot_score"].shape[:2] == (4, 2)
    assert_blocks_equal_jax(world, want, 2)


def test_world_port_lies_below_the_ephemeral_range(monkeypatch, tmp_path):
    """A world's port is free and, where the kernel names its ephemeral
    range, below it, where no other process's outgoing connection takes
    it before rank 0 binds it; without that file the system picks."""
    import socket

    ports = [demo.free_port() for _ in range(16)]
    for port in ports:
        with socket.socket() as s:
            s.bind(("localhost", port))
    if os.path.exists(demo.EPHEMERAL_RANGE):
        with open(demo.EPHEMERAL_RANGE) as f:
            low = int(f.read().split()[0])
        assert low <= 10_000 or all(10_000 <= p < low for p in ports), (low, ports)
    monkeypatch.setattr(demo, "EPHEMERAL_RANGE", str(tmp_path / "absent"))
    assert 0 < demo.free_port() < 65_536


def test_replica_count_error_is_jax_s():
    import jax
    from jax.sharding import Mesh

    from antidote_ccrdt_tpu.models.topk_rmv_dense import make_dense as jax_make_dense
    from antidote_ccrdt_tpu.parallel import multihost as jmh
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense

    D = make_dense(n_ids=16, n_dcs=2, size=2, slots_per_id=2, device="cpu")
    with host_device(), logical_devices(["cpu"] * 4):
        mesh = pmh.global_replica_mesh()
        assert mesh.shape == {"dcn": 1, "dc": 4, "key": 1}
        state = pmh.init_global_state(lambda: D.init(n_replicas=8, n_keys=1), mesh)
        with pytest.raises(ValueError) as got:
            pmh.hierarchical_reconcile(state, D.merge, mesh)
    jd = jax_make_dense(n_ids=16, n_dcs=2, size=2, slots_per_id=2)
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(1, 4, 1), ("dcn", "dc", "key"))
    jstate = jax.device_put(jd.init(n_replicas=8, n_keys=1), jmh.state_sharding(jmesh))
    with pytest.raises(ValueError) as want:
        jmh.hierarchical_reconcile(jstate, jd.merge, jmesh)
    assert str(got.value) == str(want.value)


def test_one_process_mesh_and_tags():
    """Outside a world the mesh is one process over the logical devices;
    a global leaf is the whole state, tagged; the (2, 4) dc reduce in one
    process equals the port's single-process mesh reduce."""
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense
    from antidote_ccrdt_tpu_torch.parallel import dist
    from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map

    D = make_dense(n_ids=demo.I, n_dcs=demo.DCS, size=demo.K, slots_per_id=demo.M, device="cpu")
    _eng, ops, _geo = demo.workload("small", 4, "cpu")
    with host_device(), logical_devices(["cpu"] * 4):
        mesh = pmh.global_replica_mesh()
        state = pmh.init_global_state(lambda: D.init(n_replicas=4, n_keys=1), mesh)
        assert all(a.global_shape == a.shape and a.sharding == pmh.state_sharding(mesh) for a in leaves(state))
        applied = D.apply_ops(state, ops, collect_dominated=False)[0]
        got = pmh.hierarchical_reconcile(applied, D.merge, mesh)
        plain = dist.make_mesh(4, 1)
        spec = tree_map(lambda _a: dist.P("dc", "key"), applied)
        want = dist.shard_map(lambda g: dist.along(g, plain, "dc", lambda col: dist.lattice_all_reduce(col, D.merge)),
                              plain, (spec,), spec)(applied)
    assert all(torch.equal(x, y) for x, y in zip(leaves(got), leaves(want)))
    assert all(x.sharding == pmh.state_sharding(mesh) for x in leaves(got))
    assert all(np.array_equal(x, y.numpy()) for x, y in zip(leaves(pmh.process_local_shards(got)), leaves(got)))


def test_chip_smoke_multihost_phase_holds_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 17 at small shapes on the CPU: 17a's world
    restored from DCP equals the single-process hierarchical reduce, 17b's
    worlds agree, 17c's sites converge, skip via the cursor and keep
    their layouts."""

    from antidote_ccrdt_tpu_torch.utils import benchtime

    src = os.path.join(REPO, "chip_smoke.py")
    ns = {"__name__": "chip_smoke_cpu", "__file__": src}
    with open(src) as f:
        exec(compile(f.read(), src, "exec"), ns)
    for name, v in dict(R=4, I=256, B=32, BR=8, M=4, K=8, MULTIHOST_LOCAL=2).items():
        monkeypatch.setitem(ns, name, v)
    monkeypatch.setitem(ns, "WORKER_ENV", WORKER_ENV)
    monkeypatch.setattr(benchtime, "sync", lambda: None)

    got = ns["phase_multihost"](torch, "cpu", ns["run_worlds"]("cpu", str(tmp_path)), dev="cpu")
    assert set(got) >= {"scatter_max_rows_copy", "delta_place", "sort_slots"}
