"""The port's mesh-sharded multichip drill (``antidote_ccrdt_tpu_torch/
scripts/multichip_demo.py``), the worker's ``--local`` logical devices,
and chip_smoke.py's phase 21 on the CPU.

* Phase A at the JAX drill's geometry: the port's ``phase_a`` on 8
  logical CPU devices reports what JAX's ``phase_a`` reports on the
  conftest's 8 virtual devices (every key but the timings
  ``ici_reduce_ms_p50`` and ``mesh_merges_per_sec``), with the same
  failures (none).
* Phase B on the CPU: three port ``elastic_demo`` workers with
  ``--local 8`` and ``CCRDT_MESH=1``, w1 SIGKILLed mid-load; every check
  holds against JAX's ``reference_digest``.
* Phase B at a width other than the demo's: the workers get it as
  ``--shape`` with the slowed failure detector and ``--hold``; every
  check holds against the port's reference at that width, and each
  survivor's first K1c, K2 and K3 call equals its plain version.
* ``--local 1`` (the default) leaves ``mesh.install_from_env`` at None;
  ``--local 8`` arms a (2, 4) plan.
* The worker's threads do not see its logical devices (a context
  variable), so it builds its ``MeshPlan`` once, in its main thread, and
  hands the plan to the stages on other threads: a worker run with the
  overlapped pipeline asks for the mesh's devices only from its main
  thread, and its host stage publishes per-shard digest slices.
* Phase 21 of chip_smoke.py with ``dev="cpu"`` at the demo's width.
"""

import contextvars
import importlib.util
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

from antidote_ccrdt_tpu_torch import mesh
from antidote_ccrdt_tpu_torch.parallel import dist
from antidote_ccrdt_tpu_torch.scripts import elastic_demo, multichip_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMINGS = ("ici_reduce_ms_p50", "mesh_merges_per_sec")
# A one-member mesh-armed worker whose calls of parallel.dist.mesh_devices
# are recorded (was the caller the main thread; how many devices) into
# the file argv[1]; the worker's own arguments follow.
RECORDING_WORKER = (
    "import atexit, json, sys, threading\n"
    "from antidote_ccrdt_tpu_torch.parallel import dist\n"
    "calls, mesh_devices = [], dist.mesh_devices\n"
    "def record():\n"
    "    got = mesh_devices()\n"
    "    calls.append([threading.current_thread() is threading.main_thread(), len(got)])\n"
    "    return got\n"
    "dist.mesh_devices = record\n"
    "out = sys.argv[1]\n"
    "atexit.register(lambda: json.dump(calls, open(out, 'w')))\n"
    "from antidote_ccrdt_tpu_torch.scripts import elastic_demo\n"
    "elastic_demo.main(sys.argv[2:])\n"
)


@pytest.fixture(autouse=True)
def _one_thread_a_worker(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_multichip_demo():
    spec = importlib.util.spec_from_file_location("jax_multichip_demo",
                                                  os.path.join(REPO, "scripts", "multichip_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_phase_a_reports_what_jax_reports():
    jax_report, port_report = {}, {}
    jax_bad = _jax_multichip_demo().phase_a(jax_report)
    port_bad = multichip_demo.phase_a(port_report, "cpu")
    assert port_bad == jax_bad == []
    assert set(port_report) == set(jax_report)
    for key in jax_report:
        if key not in TIMINGS:
            assert port_report[key] == jax_report[key], key
    assert port_report["bytes_ratio"] >= multichip_demo.MIN_RATIO


def test_phase_b_with_local_8_holds_against_jax_reference(monkeypatch, tmp_path):
    import importlib

    jax_ref = importlib.import_module("scripts.elastic_demo").reference_digest("topk_rmv")
    monkeypatch.setattr(elastic_demo, "reference_digest", lambda *a, **kw: jax_ref)
    report = {}
    bad = multichip_demo.phase_b(report, 240.0, "cpu", str(tmp_path / "reports"))
    assert bad == [], report
    assert all(multichip_demo.checks_of(bad).values())
    assert 3 <= report["kill_seq"] < 8 and report["victim_rc"] == -9
    assert report["zones_reported"] == {"w0": "slice0", "w2": "slice1"}
    for m, counters in report["survivor_counters"].items():
        assert counters["mesh.n_dc"] == 2 and counters["mesh.n_key"] == 4, m
        assert counters["mesh.ici_reduces"] > 0 and counters["mesh.shard_digest_slices"] > 0, m
    assert sorted(os.listdir(tmp_path / "reports")) == ["report-w0.json", "report-w2.json"]


def test_phase_b_at_a_wider_shape_holds_each_workers_first_calls(tmp_path):
    shape = "4,512,32,8,2,8"
    args = multichip_demo.worker_args("root", "w0", "cpu", shape, str(tmp_path), hold=True)
    assert args[args.index("--shape") + 1] == shape and "--hold" in args
    assert " ".join(multichip_demo.WIDE_WORKER_ARGS) in " ".join(args)
    assert not set(multichip_demo.WIDE_WORKER_ARGS[::2]) & set(multichip_demo.worker_args("root", "w0", "cpu"))
    report = {}
    bad = multichip_demo.phase_b(report, 240.0, "cpu", str(tmp_path / "reports"), shape, hold=True)
    assert bad == [], report
    assert report["worker_shape"] == shape and 3 <= report["kill_seq"] < 8
    for m, counters in report["survivor_counters"].items():
        assert counters["mesh.ici_reduces"] > 0 and counters["mesh.shard_digest_slices"] > 0, m
    for name in ("report-w0.json", "report-w2.json"):
        with open(tmp_path / "reports" / name) as f:
            held = json.load(f)["held"]
        assert set(held) == {"K1c", "K2", "K3"}, held
        assert all(v["equal"] and v["max_abs_err"] == 0 for v in held.values()), held


def test_local_1_leaves_the_mesh_unarmed_and_local_8_arms_it():
    ap = elastic_demo.argparse.ArgumentParser()
    elastic_demo.add_port_args(ap)
    assert ap.parse_args([]).local == 1
    dev = torch.device("cpu")
    dense = elastic_demo.drills(dev)["topk_rmv"].make_engine()
    with elastic_demo.on_device(dev, 1):
        assert mesh.install_from_env(dense, partitions=8, override=True) is None
    with elastic_demo.on_device(dev, 8):
        plan = mesh.install_from_env(dense, partitions=8, override=True)
        assert (plan.n_dc, plan.n_key, plan.P) == (2, 4, 8)
        assert plan.mesh.device == dev and plan.mesh.devices.size == 8


def test_a_thread_does_not_see_the_logical_devices_so_the_worker_plans_in_its_main_thread(tmp_path):
    dev = torch.device("cpu")
    seen = {}

    def ask(key):
        try:
            seen[key] = len(dist.mesh_devices())
        except RuntimeError as e:  # outside the region, on a machine without a card
            seen[key] = str(e)

    with elastic_demo.on_device(dev, 8):
        ask("main")
        plain = threading.Thread(target=ask, args=("thread",))
        copied = threading.Thread(target=contextvars.copy_context().run, args=(ask, "copied context"))
        for t in (plain, copied):
            t.start()
            t.join(30)
            assert not t.is_alive()
    assert seen["main"] == 8 and seen["copied context"] == 8
    assert seen["thread"] != 8

    calls = tmp_path / "calls.json"
    root = tmp_path / "fleet"
    env = dict(os.environ, PYTHONPATH=REPO, CCRDT_MESH="1", CCRDT_OVERLAP="1")
    p = subprocess.run([sys.executable, "-c", RECORDING_WORKER, str(calls), "--root", str(root), "--member", "w0",
                        "--n-members", "1", "--delta", "--partitions", "8", "--publish-every", "1",
                        "--device", "cpu", "--local", "8"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=240)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    recorded = json.loads(calls.read_text())
    assert recorded and all(main and n == 8 for main, n in recorded), recorded
    with open(root / "final-w0.json") as f:
        counters = json.load(f)["metrics"]
    assert counters["mesh.ici_reduces"] > 0 and counters["mesh.shard_digest_slices"] > 0
    # The host stage ran the publishes, each anchor's psnaps per shard.
    assert counters["overlap.host_tasks"] > 0 and counters["net.psnap_publishes"] > 0
    assert "mesh.reduce_failures" not in counters


def test_chip_smoke_certified_convergence_phase_holds_on_the_cpu(monkeypatch, tmp_path, capsys):
    import runpy

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    ns["phase_certified"].__globals__.update(CERT_SHAPE="demo", MULTICHIP_SHAPE="demo", CERT_TIMEOUT_S=240.0)
    reference = elastic_demo.reference_digest("topk_rmv", device="cpu")
    def no_reference(*args, **kw):
        raise AssertionError("a sequential reference ran in the fleets' process")

    with monkeypatch.context() as m:
        # The fleets run beside other phases' counts: their references are
        # `reference`, made beforehand, and none runs in this process.
        m.setattr(elastic_demo, "reference_digest", no_reference)
        fleets = ns["run_cert_fleets"]("cpu", reference)
    launches = ns["phase_certified"](torch, "cpu", fleets, dev="cpu")
    assert launches == {n: 0 for n in ns["SOURCES"]}  # the CPU's plain versions count nothing
    lines = {ln.split("] ", 1)[0][1:]: json.loads(ln.split("] ", 1)[1])
             for ln in capsys.readouterr().out.splitlines() if ln.startswith("[21")}
    assert set(lines) == {"21a divergent", "21a divergent demo width", "21a laws", "21a healthy", "21a durability",
                          "21b phase B", "21b phase A", "21b phase A demo width"}
    assert lines["21a healthy"]["wedge_alarms"] == 0 and lines["21a durability"]["fabricated_flagged"]
    assert all(lines["21b phase B"]["checks"].values()) and all(lines["21b phase A"]["checks"].values())
    assert lines["21b phase A demo width"]["digest_vectors"] > 0
