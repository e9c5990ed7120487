"""The port's elastic drill worker (``scripts/elastic_demo.py``,
``net_gossip_demo.py`` and ``crash_recovery_demo.py`` of
``antidote_ccrdt_tpu_torch``) run as real processes on the CPU.

* ``tests/test_elastic.py``'s five real-process drills (seven cases) run
  again with the port's worker (``--device cpu``) in place of the JAX
  package's; their reference stays JAX's ``reference_digest``, so every
  port survivor is held against the JAX package's sequential truth.
* ``tests/test_crash_recovery.py``'s four SIGKILL drills run through the
  port's supervisor (marked slow there, and so here).
* The port's drills give JAX's op streams draw for draw and JAX's
  reference digests; a fleet of a JAX worker and two port workers
  converges; a worker, or the supervisor, started without ``--device`` on
  a machine without a card exits non-zero naming the card.

``test_torch_topo_net.py`` runs ``test_net_tcp.py``'s real-process TCP
drill and ``test_torch_overlap.py`` ``test_overlap.py``'s SIGKILL drill
through the port, both slow.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from antidote_ccrdt_tpu_torch.scripts import elastic_demo as pe
from torch_twins import demo_drills, leaf_bytes, port_copy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = os.path.join(REPO, "antidote_ccrdt_tpu_torch", "scripts")

_REAL_PROCESS = ["test_real_process_crash_recovery", "test_real_process_scale_up_late_joiner",
                 "test_real_process_crash_recovery_delta_gossip", "test_real_process_crash_recovery_monoid",
                 "test_real_process_late_joiner_monoid_delta"]
_IN_PROCESS = ["test_owners_deterministic_and_total", "test_failure_detector_and_ownership_shift",
               "test_heartbeat_mtime_fallback", "test_gossip_sweep_merges_peer_snapshots",
               "test_ownership_grows_covers_every_step_under_view_flaps"]

globals().update(port_copy("test_elastic.py", skip=_IN_PROCESS, replace=[
    ('DEMO = os.path.join(REPO, "scripts", "elastic_demo.py")',
     'DEMO = os.path.join(REPO, "antidote_ccrdt_tpu_torch", "scripts", "elastic_demo.py")'),
    ('"--n-members", str(n_members), "--type", type_name, *extra]',
     '"--n-members", str(n_members), "--type", type_name, "--device", "cpu", *extra]'),
]))
globals().update(port_copy("test_crash_recovery.py", imports=False, replace=[
    ('DEMO = os.path.join(REPO, "scripts", "crash_recovery_demo.py")',
     'DEMO = os.path.join(REPO, "antidote_ccrdt_tpu_torch", "scripts", "crash_recovery_demo.py")'),
    ('[sys.executable, DEMO, "--mode", mode, "--durability", durability]',
     '[sys.executable, DEMO, "--mode", mode, "--durability", durability, "--device", "cpu"]'),
]))
assert set(_REAL_PROCESS) <= set(globals())


@pytest.fixture(autouse=True)
def _one_thread_a_worker(monkeypatch):
    """Each worker process computes on one CPU thread (three or four of
    them share the machine with the other test processes)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_demo():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import elastic_demo

    return elastic_demo


@pytest.mark.parametrize("type_name", ["topk_rmv", "average", "wordcount"])
def test_reference_digest_equals_jax(type_name):
    want = json.loads(json.dumps(_jax_demo().reference_digest(type_name)))
    assert json.loads(json.dumps(pe.reference_digest(type_name, device="cpu"))) == want
    assert want


@pytest.mark.parametrize("type_name", ["topk_rmv", "average", "wordcount"])
def test_op_streams_equal_jax_draw_for_draw(type_name):
    """Each (step, owned set) gives the JAX worker's ops, and those of
    ``torch_twins``' drills, leaf for leaf."""
    port = pe.drills("cpu")[type_name]
    twin = demo_drills("torch")[type_name]
    jax_drill = _jax_demo().DRILLS[type_name]
    for step, owned in ((0, range(4)), (3, [1, 2]), (9, [3]), (5, [])):
        got = leaf_bytes(port.gen_ops(step, owned))
        assert got == leaf_bytes(twin.gen_ops(step, owned))
        assert got == leaf_bytes(jax_drill.gen_ops(step, owned))


def test_main_width_stream_is_the_gossip_phases():
    """The ``--shape`` stream: Zipf(1.2) ids folded onto the id space and
    elastic_demo's seeds, as chip_smoke.py's gossip phase draws them."""
    geo = pe.parse_shape("8,1000,64,16,4,10")
    assert geo == pe.Geometry(8, 1, 1000, 8, 10, 4, 64, 16, True) and pe.parse_shape("main") == pe.MAIN
    cols = pe.drills("cpu", geo)["topk_rmv"].op_columns(2, [5])
    rng = np.random.default_rng(10_000 * 3 + 5)
    ids = ((rng.zipf(1.2, 64) - 1) % 1000).astype(np.int32)
    assert np.array_equal(cols["add_id"][5], ids)
    assert np.array_equal(cols["add_score"][5], rng.integers(1, 500, 64))
    assert np.array_equal(cols["rmv_id"][5], rng.integers(0, 1000, 16))
    assert np.array_equal(cols["rmv_vc"][5, :, 5], rng.integers(1, 2 * 64 + 1, 16))
    assert not cols["add_ts"][:5].any() and (cols["rmv_id"][6:] == -1).all()


def _spawn(cmd, env):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True, cwd=REPO)


def test_mixed_jax_and_port_fleet_converges(tmp_path):
    """A JAX worker w0 and port workers w1 (the victim, dying at step 4)
    and w2 gossip through one directory (delta chains and anchors cross
    the packages) and the survivors reach JAX's reference."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    common = ["--root", str(tmp_path), "--n-members", "3", "--type", "topk_rmv", "--delta"]
    procs = {
        "w0": _spawn([sys.executable, os.path.join(REPO, "scripts", "elastic_demo.py"), "--member", "w0", *common],
                     env),
        "w1": _spawn([sys.executable, os.path.join(PORT_SCRIPTS, "elastic_demo.py"), "--member", "w1", *common,
                      "--device", "cpu", "--die-at", "4"], env),
        "w2": _spawn([sys.executable, os.path.join(PORT_SCRIPTS, "elastic_demo.py"), "--member", "w2", *common,
                      "--device", "cpu"], env),
    }
    rcs, outs = {}, {}
    for m, p in procs.items():
        try:
            outs[m] = p.communicate(timeout=180)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            pytest.fail(f"worker {m} timed out:\n{p.communicate()[0]}")
        rcs[m] = p.returncode
    assert rcs["w1"] == 1, outs["w1"]
    ref = [list(t) for t in _jax_demo().reference_digest("topk_rmv")]
    for m in ("w0", "w2"):
        assert rcs[m] == 0, outs[m]
        with open(tmp_path / f"final-{m}.json") as f:
            got = json.load(f)
        assert got["digest"] == ref, (m, outs[m])
        assert "w1" not in got["alive"]
    assert any(f.startswith("delta-w2") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("module,extra", [
    ("elastic_demo", ["--root", "R", "--member", "w0", "--n-members", "1"]),
    ("net_gossip_demo", ["--root", "R", "--member", "w0", "--n-members", "1"]),
    ("crash_recovery_demo", ["--mode", "wal", "--durability", "group"]),
])
def test_without_a_device_the_worker_names_the_missing_card(tmp_path, module, extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    args = [str(tmp_path) if a == "R" else a for a in extra]
    p = subprocess.run([sys.executable, "-m", f"antidote_ccrdt_tpu_torch.scripts.{module}", *args],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr, p.stderr[-2000:]
    assert not os.path.exists(tmp_path / "final-w0.json")


def test_chip_smoke_elastic_phase_holds_on_the_cpu(tmp_path):
    """chip_smoke.py's phase 18 at a small width on the CPU: 18a's crash
    drill at ``--shape 4,256,32,8,4,8`` (survivors at the independent
    sequential reference, their first kernel calls held, the span plane
    and the device observatory spilling into the kept root), 18b's wal and
    adopt arms, 18c's TCP drill with its net counters."""
    import runpy

    import torch

    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    ns["phase_elastic"].__globals__.update(ELASTIC_SHAPE="4,256,32,8,4,8",
                                           WORKER_ENV=dict(os.environ, OMP_NUM_THREADS="1"))
    launches, drill = ns["phase_elastic"](torch, "cpu", str(tmp_path / "a"), ns["elastic_references"](torch, "cpu"),
                                          dev="cpu")
    assert set(launches) == set(ns["SOURCES"])  # the CPU's plain versions count nothing
    assert drill["root"] == str(tmp_path / "a") and sorted(drill["reports"]) == ["w0", "w2"]
    spills = os.listdir(drill["obs"])
    assert any(f.startswith("spans-") for f in spills) and any(f.startswith("flight-") for f in spills)
