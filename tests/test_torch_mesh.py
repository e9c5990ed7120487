"""The port's single-process mesh plane (``mesh/``, ``parallel/dist.py``)
against the JAX package's.

* Every case of ``tests/test_mesh.py`` runs again through the port, with
  the plan over 8 logical CPU devices (``parallel.dist.logical_devices``)
  in place of the conftest's 8 virtual JAX devices, and the drills of
  ``torch_twins`` in place of scripts/elastic_demo.py's.
* The same seeded state goes through both packages: the reduced leaves,
  the stitched digests, the psnap blobs, the ``save_mesh_checkpoint``
  directories and a planned WAL (each package recovering the other's)
  are equal byte for byte; ``run_mesh_chaos(seed=3)`` gives JAX's digests
  and counters; ``ReadReplica``'s ``serve.replica_shards`` gauge reads the
  placed state's logical devices as JAX's reads its devices.
"""

import os
import sys

import numpy as np
import pytest
import torch

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from antidote_ccrdt_tpu_torch.parallel.dist import logical_devices
from torch_twins import port_copy

_MESH = port_copy("test_mesh.py", replace=[
    ("import jax\n", "from torch_twins import torch_mesh_jax as jax\n"),
    ("from antidote_ccrdt_tpu import mesh as mesh_mod", "from antidote_ccrdt_tpu_torch import mesh as mesh_mod"),
    ("from elastic_demo import DRILLS, R, STEPS, reference_digest",
     "from torch_twins import DEMO_DRILLS as DRILLS, R, STEPS, reference_digest"),
    ("lambda full, one, r=r: full.at[r : r + 1].set(one)", "lambda full, one, r=r: jax.set_rows(full, r, one)"),
], helpers=["run_mesh_chaos"])
port_run_mesh_chaos = _MESH.pop("run_mesh_chaos")
globals().update(_MESH)


@pytest.fixture(autouse=True)
def _mesh_of_eight_cpu_devices():
    """Entry points called without a device run their plain path, and a
    mesh built without devices spans 8 logical CPU devices."""
    with host_device(), logical_devices(["cpu"] * 8):
        yield


# --- the two packages side by side -------------------------------------------

import jax  # noqa: E402

from antidote_ccrdt_tpu.core import partition as jpt  # noqa: E402
from antidote_ccrdt_tpu.harness import checkpoint as jck  # noqa: E402
from antidote_ccrdt_tpu.harness import wal as jwal  # noqa: E402
from antidote_ccrdt_tpu.mesh import MeshPlan as JaxPlan  # noqa: E402
from antidote_ccrdt_tpu.mesh import gossip as jgossip  # noqa: E402
from antidote_ccrdt_tpu.mesh import reduce as jreduce  # noqa: E402
from antidote_ccrdt_tpu.serve.replica import ReadReplica as JaxReplica  # noqa: E402
from antidote_ccrdt_tpu.utils.metrics import Metrics as JaxMetrics  # noqa: E402
from antidote_ccrdt_tpu_torch.harness import checkpoint as pck  # noqa: E402
from antidote_ccrdt_tpu_torch.harness import wal as pwal  # noqa: E402
from antidote_ccrdt_tpu_torch.mesh import MeshPlan  # noqa: E402
from antidote_ccrdt_tpu_torch.mesh import gossip as pgossip  # noqa: E402
from antidote_ccrdt_tpu_torch.mesh import reduce as preduce  # noqa: E402
from antidote_ccrdt_tpu_torch.serve.replica import ReadReplica  # noqa: E402
from antidote_ccrdt_tpu_torch.utils.metrics import Metrics  # noqa: E402
from torch_twins import DR, TopkRmvDrill, leaf_bytes  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_mesh import run_mesh_chaos as jax_run_mesh_chaos  # noqa: E402

P = 8


def _plans(n_dc=2, n_key=4):
    return JaxPlan.build(n_dc=n_dc, n_key=n_key, partitions=P), MeshPlan.build(n_dc=n_dc, n_key=n_key, partitions=P)


def _states(steps=3, per_row=True):
    """(jax drill, engine, state), (port drill, engine, state) of the same
    op stream; with `per_row` each row saw only its own replica's ops."""
    out = []
    for pkg in ("jax", "torch"):
        drill = TopkRmvDrill(pkg)
        dense = drill.make_engine()
        state = drill.init(dense)
        for s in range(steps):
            for r in (range(DR) if per_row else [range(DR)]):
                state = drill.apply(dense, state, s, [r] if per_row else r)
        out.append((drill, dense, state))
    return out


def _files(root):
    return {fn: open(os.path.join(root, fn), "rb").read() for fn in sorted(os.listdir(root))}


@pytest.mark.parametrize("n_dc,n_key", [(2, 4), (4, 2), (1, 8)])
def test_ici_reduce_leaves_equal_jax(n_dc, n_key):
    """The dc all-reduce of one divergent-rows state: every leaf of the
    port's result is JAX's, bit for bit (lossy and vc included), and so
    is `psum_reduce` of its int32 tables."""
    jplan, pplan = _plans(n_dc, n_key)
    (_, jd, js), (_, pd, ps) = _states()
    got = preduce.ici_reduce(pd, pplan, pplan.place(ps))
    want = jreduce.ici_reduce(jd, jplan, jplan.place(js))
    assert leaf_bytes(got) == leaf_bytes(want)
    assert (leaf_bytes(got) != leaf_bytes(ps)) == (n_dc > 1)  # one dc block: the identity
    tables = {"t": ps.slot_ts, "v": ps.rmv_vc}
    got = preduce.psum_reduce(pplan, tables)
    want = jreduce.psum_reduce(jplan, {"t": js.slot_ts, "v": js.rmv_vc})
    assert leaf_bytes(got) == leaf_bytes(want)


def test_digests_psnaps_and_checkpoints_are_byte_equal_to_jax(tmp_path):
    jplan, pplan = _plans()
    (_, jd, js), (_, pd, ps) = _states(steps=4, per_row=False)
    assert np.array_equal(pgossip.sharded_digest_vector(ps, pplan), jgossip.sharded_digest_vector(js, jplan))
    assert np.array_equal(pgossip.sharded_digest_vector(pplan.place(ps), pplan), jpt.state_digests(js, P))
    for shard in range(pplan.n_key):
        got = pgossip.shard_psnap_blobs("topk_rmv", ps, 7, pd, pplan, shard)
        want = jgossip.shard_psnap_blobs("topk_rmv", js, 7, jd, jplan, shard)
        assert got == want and got
    pck.save_mesh_checkpoint(str(tmp_path / "port"), "topk_rmv", ps, pd, 4, pplan)
    jck.save_mesh_checkpoint(str(tmp_path / "jax"), "topk_rmv", js, jd, 4, jplan)
    port, jax_ = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port == jax_ and len(port) == P + 2  # P + 1 shards and the manifest


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_recovers_the_others_mesh_wal(tmp_path, writer):
    """A WAL routed by a (2, 4) plan (a stream per key shard) written by
    one package: the same files as the other's, and the other recovers it
    to the writer's state."""
    jplan, pplan = _plans()
    logs = {}
    for pkg, mod, plan in (("torch", pwal, pplan), ("jax", jwal, jplan)):
        drill = TopkRmvDrill(pkg)
        dense = drill.make_engine()
        wal = mod.ElasticWal(str(tmp_path / pkg), "w0", dense, "topk_rmv", partitions=P, mesh_plan=plan)
        assert wal.nstreams == 4
        prev = st = drill.init(dense)
        for s in range(4):
            st = drill.apply(dense, st, s, [0, 1])
            wal.log_step(s, [0, 1], prev, st)
            prev = st
        wal.close()
        logs[pkg] = st
    walk = {pkg: {os.path.relpath(os.path.join(d, f), tmp_path / pkg): open(os.path.join(d, f), "rb").read()
                  for d, _, fs in os.walk(tmp_path / pkg) for f in fs} for pkg in logs}
    assert walk["torch"] == walk["jax"]
    wpkg, rpkg, rmod, rplan = ("torch", "jax", jwal, jplan) if writer == "port" else ("jax", "torch", pwal, pplan)
    drill = TopkRmvDrill(rpkg)
    dense = drill.make_engine()
    reader = rmod.ElasticWal(str(tmp_path / wpkg), "w0", dense, "topk_rmv", partitions=P, mesh_plan=rplan)
    state, last_step, owned = reader.recover(drill.init(dense))
    reader.close()
    assert (last_step, owned) == (3, {0, 1})
    assert leaf_bytes(state) == leaf_bytes(logs[wpkg])


def test_mesh_chaos_seed_3_gives_jax_digests_and_counters():
    """The port's copy of the drill gives JAX's digests and counters, and
    so does chip_smoke.py's `run_mesh_chaos` (phase 16c's drill)."""
    import chip_smoke

    got_d, got_c, _ = port_run_mesh_chaos(seed=3)
    want_d, want_c, _ = jax_run_mesh_chaos(seed=3)
    assert got_d == want_d
    assert got_c == want_c
    assert got_c.get("mesh.ici_reduces", 0) > 0 and got_c.get("mesh.cross_slice_fetches", 0) > 0
    smoke = chip_smoke.run_mesh_chaos(torch, "cpu", seed=3)
    assert smoke["digests"] == want_d and smoke["counters"] == want_c


def test_chip_smoke_mesh_phase_holds_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 16 at a small width on the CPU, on one real
    device (so the (1, 1) plan and the disarmed `install_from_env` gates
    see one device, as the card does): every gate holds, and the held
    calls saw every K3 join of the reduce and every block's K1c, K2 and
    K3 of one id-sharded round."""
    import chip_smoke

    for name, v in dict(R=4, I=256, B=64, BR=8, K=8, M=4).items():
        monkeypatch.setattr(chip_smoke, name, v)
    with logical_devices(["cpu"]):
        held = {}
        a = chip_smoke.run_mesh_reduce(torch, "cpu", (4, 256, 64, 8), held=held)
        b = chip_smoke.run_id_sharded(torch, "cpu", (4, 256, 64, 8), held=held)
        assert a["real_plan"]["devices"] == 1 and a["psnap_blobs"] == P + 1 and a["checkpoint_files"] == P + 2
        assert {k.split()[0]: v["calls"] for k, v in held.items()} == {"K3": 16, "K1c": 8, "K2": 8}
        assert b["valid_observed"] == 4 * 8
        assert chip_smoke.phase_mesh(torch, "cpu", dev="cpu") == {
            "scatter_max_rows_copy": 0, "delta_place": 0, "sort_slots": 0}  # the CPU wrappers count nothing


def test_replica_shards_gauge_equals_jax():
    """`serve.replica_shards` of a swapped state: the 8 logical devices
    of a placed state, 1 for an unsharded one, as JAX's gauge reads."""
    jplan, pplan = _plans()
    (_, _, js), (_, _, ps) = _states(steps=1, per_row=False)
    for jstate, pstate, want in ((jplan.place(js), pplan.place(ps), 8.0), (js, ps, 1.0)):
        jm, pm = JaxMetrics(), Metrics()
        JaxReplica(metrics=jm).swap(jstate, seq=1)
        ReadReplica(metrics=pm).swap(pstate, seq=1)
        assert pm.counters["serve.replica_shards"] == jm.counters["serve.replica_shards"] == want
    assert len(jax.devices()) == 8
