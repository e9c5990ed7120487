"""The port's gossip plane (``parallel/elastic.py`` over ``net/``) against
the JAX package's.

* Every case of ``tests/test_net_chaos.py`` and ``tests/test_topo_chaos.py``
  and the in-process cases of ``tests/test_elastic.py`` run again through
  the port, with the drills of ``torch_twins`` (scripts/elastic_demo.py's
  op streams, adoption and digests, built for the port) in place of
  elastic_demo's. Left out here: ``test_elastic.py``'s five real-process
  drills, which ``test_torch_elastic_worker.py`` runs with the port's
  worker (``antidote_ccrdt_tpu_torch/scripts/elastic_demo.py``), so that
  each case runs once.
  ``test_topo_matches_full_mesh_digests`` compares the port's zone fleet
  with the JAX package's own full-mesh run.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

_DEMO = ("from elastic_demo import DRILLS, R, STEPS, reference_digest",
         "from torch_twins import DEMO_DRILLS as DRILLS, R, STEPS, reference_digest")
_REAL_PROCESS = ["test_real_process_crash_recovery", "test_real_process_scale_up_late_joiner",
                 "test_real_process_crash_recovery_delta_gossip", "test_real_process_crash_recovery_monoid",
                 "test_real_process_late_joiner_monoid_delta"]

globals().update(port_copies(
    ("test_net_chaos.py", dict(replace=[_DEMO], helpers=["run_chaos"])),
    ("test_topo_chaos.py", dict(replace=[_DEMO])),
    ("test_elastic.py", dict(skip=_REAL_PROCESS, replace=[
        ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp"),
        (".repeat(2, 0)", ".repeat_interleave(2, 0)"),
    ])),
))
port_run_chaos = globals().pop("run_chaos")


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages side by side -------------------------------------------

import os  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from antidote_ccrdt_tpu.net.transport import GossipNode as JaxNode  # noqa: E402
from antidote_ccrdt_tpu.parallel import elastic as jel  # noqa: E402
from antidote_ccrdt_tpu_torch.net.transport import GossipNode  # noqa: E402
from antidote_ccrdt_tpu_torch.parallel import elastic as pel  # noqa: E402
from torch_twins import STEPS, demo_drills, leaf_bytes, leaves_of, reference_digest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_net_chaos import run_chaos as jax_run_chaos  # noqa: E402


@pytest.mark.parametrize("type_name,seed,delta", [("topk_rmv", 7, True), ("average", 11, False),
                                                  ("topk_rmv", 2, False), ("wordcount", 5, False)])
def test_same_chaos_seed_gives_jax_digests_and_fault_counters(type_name, seed, delta):
    """The simulator draws from its one seeded RNG in JAX's order: the
    same run gives the same digests and every counter (losses,
    duplicates, unreachable sends, deaths, bytes) equal."""
    got_d, got_c = port_run_chaos(type_name, seed, delta=delta)
    want_d, want_c = jax_run_chaos(type_name, seed, delta=delta)
    assert got_d == want_d
    assert got_c == want_c
    assert got_c.get("net.sim_lost", 0) > 0 and got_c.get("net.sim_duplicated", 0) > 0
    assert all(d == reference_digest(type_name) for d in got_d.values())


def _recorded(node):
    """Every blob `node`'s medium is handed, in order: [(kind, key, bytes)]."""
    log, t = [], node.transport
    for kind in ("publish", "publish_delta", "publish_digest", "publish_psnap"):
        inner = getattr(t, kind)

        def rec(*a, _inner=inner, _kind=kind, **kw):
            log.append((_kind, a[:-1], bytes(a[-1])))
            return _inner(*a, **kw)

        setattr(t, kind, rec)
    return log


def _publish_run(mod, node_cls, root, drill, steps=10):
    """One member applying `drill`'s ops for every replica, publishing each
    step through `mod.DeltaPublisher` (anchors every 4 with 4 partition
    digests and psnaps; every third window deferred, so coalesced range
    frames ship too) -> the blobs its medium got."""
    dense = drill.make_engine()
    state = drill.init(dense)
    node = mod.GossipStore(root, "w0")
    log = _recorded(node)
    pub = mod.DeltaPublisher(node, dense, name=drill.publish_name, full_every=4,
                             partitions=4 if drill.name == "topk_rmv" else None)
    for step in range(steps):
        state = drill.apply(dense, state, step, range(4))
        pub.publish(drill.pub_state(dense, state), defer=step % 3 == 1)
    pub.flush_wire()
    return log


@pytest.mark.parametrize("type_name", ["topk_rmv", "average", "wordcount"])
def test_published_blobs_are_byte_equal_to_jax(tmp_path, type_name):
    """Snapshot, chained delta, CCRF range-frame, digest and psnap blobs
    of the same op stream are the JAX package's bytes."""
    got = _publish_run(pel, GossipNode, str(tmp_path / "port"), demo_drills("torch")[type_name])
    want = _publish_run(jel, JaxNode, str(tmp_path / "jax"), demo_drills("jax")[type_name])
    kinds = {k for k, _, _ in got}
    assert {"publish", "publish_delta"} <= kinds
    if type_name == "topk_rmv":
        assert {"publish_digest", "publish_psnap"} <= kinds
        assert any(b[:4] == b"CCRF" for k, _, b in got if k == "publish_delta")
    assert [(k, key) for k, key, _ in got] == [(k, key) for k, key, _ in want]
    for (k, key, g), (_, _, w) in zip(got, want):
        assert g == w, (k, key)


def _gossip_round(mods, nodes, pubs, drills, engines, states, cursors, stats):
    for m in sorted(nodes):
        drill, dense = drills[m], engines[m]
        pubs[m].publish(drill.pub_state(dense, states[m]))
        swept, st = mods[m].sweep_deltas(nodes[m], dense, drill.pub_state(dense, states[m]), cursors[m])
        states[m] = drill.set_view(dense, states[m], swept)
        for k, v in st.items():
            stats[m][k] = stats[m].get(k, 0) + v


def test_mixed_fleet_over_one_directory_converges(tmp_path):
    """Two JAX members and two port members gossip chained deltas and
    anchors through one FsTransport directory, each applying its own
    replica's op stream: all four reach one digest, the sequential
    reference's, and each package applied the other's deltas."""
    names = ["j0", "j1", "p0", "p1"]
    pkg = {m: "jax" if m[0] == "j" else "torch" for m in names}
    mods = {m: jel if pkg[m] == "jax" else pel for m in names}
    drills = {m: demo_drills(pkg[m])["topk_rmv"] for m in names}
    engines = {m: drills[m].make_engine() for m in names}
    states = {m: drills[m].init(engines[m]) for m in names}
    nodes = {m: mods[m].GossipStore(str(tmp_path), m) for m in names}
    pubs = {m: mods[m].DeltaPublisher(nodes[m], engines[m], name="topk_rmv", full_every=4) for m in names}
    cursors = {m: {} for m in names}
    stats = {m: {} for m in names}
    for step in range(STEPS):
        for r, m in enumerate(names):
            states[m] = drills[m].apply(engines[m], states[m], step, [r])
        if step % 2 == 0:
            _gossip_round(mods, nodes, pubs, drills, engines, states, cursors, stats)
    for _ in range(3):
        _gossip_round(mods, nodes, pubs, drills, engines, states, cursors, stats)
    digests = {m: drills[m].digest(engines[m], states[m]) for m in names}
    assert all(d == reference_digest("topk_rmv") for d in digests.values()), digests
    assert leaf_bytes(states["j0"]) == leaf_bytes(states["p0"])
    for m in names:
        assert stats[m]["deltas"] > 0 and stats[m]["fulls"] > 0 and stats[m]["skipped"] == 0, (m, stats[m])
        assert {c for c in cursors[m]} == set(names) - {m}


def test_partial_anti_entropy_repairs_like_jax(tmp_path):
    """A lagging member repaired through digests and psnaps of only its
    divergent partitions ends in the JAX package's state, with the same
    sweep stats and counters."""
    out = {}
    for mod, pkg in ((pel, "torch"), (jel, "jax")):
        drill = demo_drills(pkg)["topk_rmv"]
        dense = drill.make_engine()
        root = str(tmp_path / pkg)
        src, dst = mod.GossipStore(root, "a"), mod.GossipStore(root, "b")
        pub = mod.DeltaPublisher(src, dense, name="topk_rmv", full_every=4, keep=1, partitions=8)
        state = drill.init(dense)
        for step in range(6):
            state = drill.apply(dense, state, step, [0, 2])
            pub.publish(state)
        lag = drill.apply(dense, drill.init(dense), 0, [0, 2])
        cursors = {"a": 0}
        partial = mod.PartialAntiEntropy(dst, partitions=8)
        fixed, st = mod.sweep_deltas(dst, dense, lag, cursors, partial=partial)
        out[pkg] = (leaf_bytes(fixed), st, dict(cursors), dict(dst.metrics.counters))
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["partials"] == 1 and out["torch"][1]["fulls"] == 0


def test_sweeps_decode_onto_the_state_device(tmp_path):
    """A fetched snapshot and a fetched delta land on the device of the
    state they are decoded against (here the CPU, as a card state's land
    on the card), and `sweep_deltas` keeps the caller's leaves there."""
    drill = demo_drills("torch")["topk_rmv"]
    dense = drill.make_engine()
    a, b = pel.GossipStore(str(tmp_path), "a"), pel.GossipStore(str(tmp_path), "b")
    pub = pel.DeltaPublisher(a, dense, name="topk_rmv", full_every=4)
    st = drill.init(dense)
    for step in range(3):
        st = drill.apply(dense, st, step, [1])
        pub.publish(st)
    got, stats = pel.sweep_deltas(b, dense, drill.init(dense), {})
    assert stats == {"deltas": 2, "fulls": 1, "skipped": 0}
    assert leaf_bytes(got) == leaf_bytes(dense.merge(drill.init(dense), st))
    assert {leaf.device.type for leaf in leaves_of(got)} == {"cpu"}


def test_chip_smoke_gossip_drill_converges_on_the_cpu():
    """chip_smoke.py phase 12's drill (`run_gossip`) at a tiny width on
    the CPU: every survivor reaches the sequential reference's digest
    after adopting the victim's replicas, every fault fires and no sweep
    skips, as phase 12 requires on the card."""
    import chip_smoke

    out = chip_smoke.run_gossip(torch, "cpu", (4, 64, 32, 8))
    assert out["covered"] and out["ref"] and all(d == out["ref"] for d in out["digests"].values())
    assert sorted(out["digests"]) == ["m0", "m1", "m2"] and out["tail_rounds"] < chip_smoke.GOSSIP_TAIL
    assert all(sw["skipped"] == 0 for sw in out["sweeps"])
    for c in ("net.sim_lost", "net.sim_duplicated", "net.sim_unreachable", "net.dead_events"):
        assert out["counters"].get(c, 0) > 0, c
