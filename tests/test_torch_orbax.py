"""The port's checkpoint manager and checkpoint gossip
(``harness/orbax_ckpt.py`` and ``parallel/orbax_gossip.py``, over
``torch.distributed.checkpoint``) against the JAX package's (over Orbax).

* Every case of ``tests/test_orbax_ckpt.py`` and
  ``tests/test_orbax_gossip.py`` runs again through the port
  (``torch_twins.torch_orbax_jax`` for the ``jax`` calls: 8 logical CPU
  devices, ``parallel.dist`` meshes and shardings, its
  ``ShapeDtypeStruct``).
* The same seeded state goes through both packages: round trips give
  equal leaves, the same saves give equal step lists under retention with
  and without a reload, an empty directory raises ``FileNotFoundError`` in
  both, a restore onto another mesh equals JAX's, and the two-site sweep
  gives JAX's leaves, cursors and counts for topk_rmv and the lifted
  average.
* The collective save of a global state by a 2-process ``gloo`` world
  (each process its block), restored whole by the test process, is in
  ``tests/test_torch_multihost.py``, beside the world that writes it.
"""

import os

import numpy as np
import pytest
import torch

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from antidote_ccrdt_tpu_torch.parallel.dist import logical_devices
from torch_twins import port_copies

_JAX_SHARDING = "from jax.sharding import Mesh, NamedSharding, PartitionSpec as P"
_PORT_SHARDING = "from antidote_ccrdt_tpu_torch.parallel.dist import Mesh, NamedSharding, PartitionSpec as P"
_TWINS = [
    ("import jax\n", "from torch_twins import torch_orbax_jax as jax\n"),
    ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp"),
    (_JAX_SHARDING, _PORT_SHARDING),
]
with host_device():  # test_orbax_gossip.py builds its engine at import
    globals().update(port_copies(
        ("test_orbax_ckpt.py", dict(replace=_TWINS)),
        ("test_orbax_gossip.py", dict(replace=_TWINS + [("leaf.devices()", "jax.leaf_devices(leaf)")])),
    ))


@pytest.fixture(autouse=True)
def _cpu_engines_and_eight_logical_devices():
    """Entry points called without a device run their plain path, and a
    mesh built without devices spans 8 logical CPU devices."""
    with host_device(), logical_devices(["cpu"] * 8):
        yield


# --- the two packages side by side -------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402
from jax.sharding import NamedSharding as JaxSharding  # noqa: E402
from jax.sharding import PartitionSpec as JaxP  # noqa: E402

from antidote_ccrdt_tpu.harness import orbax_ckpt as jck  # noqa: E402
from antidote_ccrdt_tpu.parallel.orbax_gossip import OrbaxGossip as JaxGossip  # noqa: E402
from antidote_ccrdt_tpu_torch.harness import orbax_ckpt as pck  # noqa: E402
from antidote_ccrdt_tpu_torch.parallel import dist  # noqa: E402
from antidote_ccrdt_tpu_torch.parallel.orbax_gossip import OrbaxGossip as PortGossip  # noqa: E402
from antidote_ccrdt_tpu_torch.utils.tree import leaves, tree_map  # noqa: E402
from torch_twins import assert_tree, leaf_bytes, lifted_pair, topk_rmv_pair  # noqa: E402


def _zeros_like(state):
    if isinstance(leaves(state)[0], torch.Tensor):
        return tree_map(torch.zeros_like, state)
    return jax.tree.map(jnp.zeros_like, state)


@pytest.mark.parametrize("kind", ["topk_rmv", "average_lifted"])
def test_round_trip_leaves_equal_jax(tmp_path, kind):
    """The same seeded state saved and restored by each package: equal
    leaves (bool masks keep their dtype), also through an async save."""
    if kind == "topk_rmv":
        (_jd, js), (_pd, ps) = topk_rmv_pair(3)
    else:
        (_jd, js), (_pd, ps) = lifted_pair(3)
    js, ps = js[-1], ps[-1]
    assert leaf_bytes(ps) == leaf_bytes(js)
    with jck.DenseCheckpointManager(str(tmp_path / "j")) as jm, pck.DenseCheckpointManager(str(tmp_path / "p")) as pm:
        jm.save(4, js)
        pm.save(4, ps)
        pm.save(5, ps, wait=False)
        jr, pr = jm.restore(_zeros_like(js)), pm.restore(_zeros_like(ps))
        assert pm.all_steps() == [4, 5]
        pr4 = pm.restore(_zeros_like(ps), step=4)
    assert leaf_bytes(pr) == leaf_bytes(pr4) == leaf_bytes(jr) == leaf_bytes(js)
    assert_tree(pr, jr)


@pytest.mark.parametrize("reload", [False, True])
def test_step_lists_under_retention_equal_jax(tmp_path, reload):
    """One save sequence (a step not past the latest is skipped in both)
    under max_to_keep=2: the writers' step lists, and a reader's that does
    or does not reload, are JAX's after every save."""
    (_jd, js), (_pd, ps) = topk_rmv_pair(4, rounds=1)
    js, ps = js[-1], ps[-1]
    jw = jck.DenseCheckpointManager(str(tmp_path / "j"), max_to_keep=2)
    pw = pck.DenseCheckpointManager(str(tmp_path / "p"), max_to_keep=2)
    jw.save(1, js)
    pw.save(1, ps)
    jr = jck.DenseCheckpointManager(str(tmp_path / "j"), max_to_keep=10**6)
    pr = pck.DenseCheckpointManager(str(tmp_path / "p"), max_to_keep=10**6)
    for step in (2, 2, 1, 5, 7):
        jw.save(step, js)
        pw.save(step, ps)
        if reload:
            jr.reload()
            pr.reload()
        for j, p in ((jw, pw), (jr, pr)):
            assert (p.all_steps(), p.latest_step()) == (j.all_steps(), j.latest_step()), step
    assert pw.all_steps() == [5, 7]
    assert pr.all_steps() == ([5, 7] if reload else [1])
    assert sorted(os.listdir(tmp_path / "p")) == ["5", "7"]
    for m in (jw, pw, jr, pr):
        m.close()


def test_empty_directory_and_missing_step_raise_in_both(tmp_path):
    (_jd, js), (_pd, ps) = topk_rmv_pair(5, rounds=1)
    js, ps = js[-1], ps[-1]
    with jck.DenseCheckpointManager(str(tmp_path / "j")) as jm, pck.DenseCheckpointManager(str(tmp_path / "p")) as pm:
        for m, like in ((jm, _zeros_like(js)), (pm, _zeros_like(ps))):
            with pytest.raises(FileNotFoundError, match="no checkpoint steps in directory"):
                m.restore(like)
        jm.save(1, js)
        pm.save(1, ps)
        for m, like, d in ((jm, _zeros_like(js), "j"), (pm, _zeros_like(ps), "p")):
            with pytest.raises(FileNotFoundError, match=f"Checkpoint at .*{d}/2 not found"):
                m.restore(like, step=2)


def test_restore_onto_another_mesh_equals_jax(tmp_path):
    """A state saved from a (4, 2) mesh restores onto a 2-device replica
    axis in both packages: equal leaves, each tagged with the new layout."""
    (_jd, js), (_pd, ps) = topk_rmv_pair(6, R=4, D=4)
    js, ps = js[-1], ps[-1]
    devs = jax.devices()
    jsh = JaxSharding(JaxMesh(np.asarray(devs).reshape(4, 2), ("dc", "extra")), JaxP("dc"))
    jsh2 = JaxSharding(JaxMesh(np.asarray(devs[:2]).reshape(2), ("dc",)), JaxP("dc"))
    psh = dist.NamedSharding(dist.Mesh(dist.device_array(["cpu"] * 8, (4, 2)), ("dc", "extra")), dist.P("dc"))
    psh2 = dist.NamedSharding(dist.Mesh(dist.device_array(["cpu"] * 2, (2,)), ("dc",)), dist.P("dc"))
    with jck.DenseCheckpointManager(str(tmp_path / "j")) as jm, pck.DenseCheckpointManager(str(tmp_path / "p")) as pm:
        jm.save(3, jax.tree.map(lambda x: jax.device_put(x, jsh), js))
        pm.save(3, tree_map(lambda x: dist.device_put(x, psh), ps))
        jr = jm.restore(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=jsh2), js))
        pr = pm.restore(tree_map(lambda x: dist.ShapeDtypeStruct(x.shape, x.dtype, sharding=psh2), ps))
    assert leaf_bytes(pr) == leaf_bytes(jr) == leaf_bytes(js)
    assert all(a.sharding == psh2 and a.sharding.mesh.shape == {"dc": 2} for a in leaves(pr))
    assert all(a.sharding.mesh.shape == {"dc": 2} for a in jax.tree.leaves(jr))


def _site_states(kind):
    """(JAX engine, [site A, site B, A's next]), (port engine, the same)."""
    if kind == "topk_rmv":
        pairs = [topk_rmv_pair(seed) for seed in (11, 12, 13)]
        (jd, _), (pd, _) = pairs[0]
        return (jd, [p[0][1][-1] for p in pairs]), (pd, [p[1][1][-1] for p in pairs])
    (jl, js), (pl, ps) = lifted_pair(7, steps=6)
    return (jl.inner, [js[2], js[4], js[6]]), (pl.inner, [ps[2], ps[4], ps[6]])


@pytest.mark.parametrize("kind", ["topk_rmv", "average_lifted"])
def test_two_site_sweep_equals_jax(tmp_path, kind):
    """Two sites per package exchange through the store: after each
    exchange the port's states are JAX's, leaf for leaf, with the same
    merge counts and cursors (for the lifted average the raw engine is
    lifted by the sweep, as in JAX)."""
    (jd, jst), (pd, pst) = _site_states(kind)
    runs = {}
    for pkg, G, d, (a, b, a_next) in (("jax", JaxGossip, jd, jst), ("port", PortGossip, pd, pst)):
        root = str(tmp_path / pkg)
        os.makedirs(root)
        with G(root, "site-a") as ga, G(root, "site-b") as gb:
            ga.publish(a, step=1)
            gb.publish(b, step=1)
            a2, n_a = ga.sweep(d, a)
            b2, n_b = gb.sweep(d, b)
            lift = {"jax": _jax_lift, "port": _lift}[pkg]
            ga.publish((d if kind == "topk_rmv" else lift(d)).merge(a2, a_next), step=2)
            cursors = {}
            b3, n1 = gb.sweep(d, b2, cursors)
            b4, n2 = gb.sweep(d, b3, cursors)
            runs[pkg] = dict(states=(a2, b2, b3, b4), counts=(n_a, n_b, n1, n2), cursors=cursors,
                             steps=ga._mgr.all_steps())
    assert runs["port"]["counts"] == runs["jax"]["counts"] == (1, 1, 1, 0)
    assert runs["port"]["cursors"] == runs["jax"]["cursors"] == {"site-a": 2}
    assert runs["port"]["steps"] == runs["jax"]["steps"]
    for p, j in zip(runs["port"]["states"], runs["jax"]["states"]):
        assert_tree(p, j)


def _lift(dense):
    from antidote_ccrdt_tpu_torch.parallel.monoid import MonoidLift

    return MonoidLift(dense)


def _jax_lift(dense):
    from antidote_ccrdt_tpu.parallel.monoid import MonoidLift

    return MonoidLift(dense)
