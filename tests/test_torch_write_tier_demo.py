"""The port's fleet write-tier drill (``antidote_ccrdt_tpu_torch/scripts/
write_tier_demo.py``) against the JAX package's ``scripts/write_tier_demo.py``,
on the CPU.

* The shed arm: the port's ``_shed_arm()`` and JAX's come back
  ``overloaded`` with the plane's ``retry_after_ms`` (350) and one shed
  return each.
* The violating arm: under a frozen wall clock the port's certificate is
  byte-equal to JAX's, signature included, and so are the router's
  outputs and the plane's unsafe-ack count.
* The fleet: four port ``net_gossip_demo`` workers at the demo's width,
  JAX's flags shortened, pass all 17 checks; the report's keys and check
  names are those of the committed ``WRITETIER_r01.json``; JAX's
  ``certify_writes`` over the honest arm's logs (the workers' spill and
  the client's events) gives the port's ``ok``, ``n_acks`` and
  ``origins``.
* The width: ``--shape`` reaches every worker, multichip_demo's
  ``WIDE_WORKER_ARGS`` only off the demo's width, and the default
  ``--out`` is not the committed carrier.
"""

import importlib.util
import json
import os
import runpy
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

from antidote_ccrdt_tpu_torch.scripts import multichip_demo, write_tier_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN_T = 1_700_000_000.0
# JAX's 24 steps with the kill at 13 and 1 s between steps, shortened for
# the CPU: the storm keeps a pre-kill and a post-kill window.
SHORT = dict(steps=20, kill_at_step=10, step_sleep=0.5)


def _jax_write_tier_demo():
    spec = importlib.util.spec_from_file_location("jax_write_tier_demo",
                                                  os.path.join(REPO, "scripts", "write_tier_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread_a_worker(monkeypatch):
    """Each worker process computes on one CPU thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def frozen_clocks():
    """Both packages' certifiers and flight recorders read one fixed wall
    clock: the port's through chip_smoke.py's ``frozen_wall_clock``, JAX's
    the same way."""
    from antidote_ccrdt_tpu.obs import audit as jax_audit, events as jax_events

    frozen_wall_clock = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))["frozen_wall_clock"]
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    fake.time = lambda: FROZEN_T
    saved = [(mod, mod.time) for mod in (jax_audit, jax_events)]
    with frozen_wall_clock(FROZEN_T):
        try:
            for mod, _ in saved:
                mod.time = fake
            yield
        finally:
            for mod, real in saved:
                mod.time = real


def test_shed_arm_equals_jax():
    want_out, want_s, want_returns = _jax_write_tier_demo()._shed_arm()
    got_out, got_s, got_returns = write_tier_demo._shed_arm()
    assert got_out == want_out == {"error": "overloaded", "retry_after_ms": 350}
    assert got_returns == want_returns == 1
    assert got_s < 5.0 and want_s < 5.0


def test_violating_arm_certificate_is_byte_equal_to_jax(frozen_clocks):
    want_cert, want_outs, want_unsafe = _jax_write_tier_demo()._violating_arm()
    got_cert, got_outs, got_unsafe = write_tier_demo._violating_arm()
    assert json.dumps(got_cert, sort_keys=True) == json.dumps(want_cert, sort_keys=True)
    assert got_cert["t"] == FROZEN_T and got_cert["ok"] is False
    assert got_outs == want_outs and all(o["level"] == "durable" for o in got_outs)
    assert got_unsafe == want_unsafe == 3
    (lost,) = got_cert["counterexample"]["acked_but_lost"]
    assert lost["origin"] == "v0" and lost["uncovered"] == [8, 20] and lost["lost_write_ids"]


def test_fleet_passes_every_check_and_certifies_as_jax(monkeypatch, tmp_path):
    """The drill on the CPU at the demo's width, its honest arm's
    certificate held against JAX's certifier on the same logs."""
    from antidote_ccrdt_tpu.obs.audit import certify_writes as jax_certify_writes
    from antidote_ccrdt_tpu_torch.obs import audit as port_audit

    honest = {}
    port_certify_writes = port_audit.certify_writes

    def recording(logs, meta=None, **kw):
        cert = port_certify_writes(logs=logs, meta=meta, **kw)
        if (meta or {}).get("arm") == "honest":
            honest.update(logs=logs, cert=cert)
        return cert

    monkeypatch.setattr(port_audit, "certify_writes", recording)
    failures = []
    report = write_tier_demo.run_fleet(device="cpu", report_dir=str(tmp_path), failures=failures, **SHORT)
    assert failures == [] and report["pass"], {k: v for k, v in report["checks"].items() if not v}
    assert all(report["checks"].values())
    with open(os.path.join(REPO, "WRITETIER_r01.json")) as f:
        carrier = json.load(f)
    assert set(report) == set(carrier)
    assert set(report["checks"]) == set(carrier["checks"]) and len(report["checks"]) == 17
    victim = report["killed"]
    assert victim == write_tier_demo.MEMBERS[2] and report["outcomes"]["victim_hard"] > 0
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"report-{m}.json" for m in write_tier_demo.MEMBERS if m != victim] + ["supervisor.json"])
    with open(tmp_path / "supervisor.json") as f:
        supervisor = json.load(f)
    assert supervisor["victim"] == victim and supervisor["kill_step"] >= SHORT["kill_at_step"]
    want = jax_certify_writes(logs=honest["logs"], meta={"arm": "honest"})
    got = honest["cert"]
    assert got["ok"] and got["n_acks"] > 0
    for key in ("ok", "n_acks", "origins"):
        assert got[key] == want[key], key


def test_width_reaches_every_worker_and_the_default_out_is_not_the_carrier(monkeypatch, tmp_path):
    started = []

    class Recorded:
        def __init__(self, cmd, **kw):
            started.append((cmd, kw))

    monkeypatch.setattr(subprocess, "Popen", Recorded)
    wide = "4,512,32,8,2,8"
    write_tier_demo._spawn_fleet(str(tmp_path), "obs", 14, 0.5, 1.0, "cpu", wide, str(tmp_path / "rep"), True)
    assert len(started) == len(write_tier_demo.MEMBERS)
    for (cmd, kw), m in zip(started, write_tier_demo.MEMBERS):
        assert cmd[:3] == [sys.executable, "-m", write_tier_demo.WORKER] and kw["start_new_session"]
        assert cmd[cmd.index("--shape") + 1] == wide and cmd[cmd.index("--member") + 1] == m
        assert " ".join(multichip_demo.WIDE_WORKER_ARGS) in " ".join(cmd) and "--hold" in cmd
        assert cmd[cmd.index("--report") + 1] == str(tmp_path / "rep" / f"report-{m}.json")
        # The slowed detector overrides JAX's --timeout: argparse keeps the last.
        assert cmd[len(cmd) - cmd[::-1].index("--timeout")] == "8.0"
        # The workers' environment is this process's with the demo's planes
        # and faults: no JAX platform or XLA flag is set or taken away.
        changed = {k for k, v in kw["env"].items() if os.environ.get(k) != v}
        assert set(os.environ) <= set(kw["env"]) and changed <= {
            "PYTHONPATH", "CCRDT_OBS_DIR", "CCRDT_SERVE", "CCRDT_INGEST", "CCRDT_INGEST_ACK_TIMEOUT_S", "CCRDT_FAULTS"}
        assert kw["env"]["CCRDT_INGEST_ACK_TIMEOUT_S"] == "8"
    demo = write_tier_demo.worker_cmd("root", "w0", 24, 0.5, 1.0, "cpu")
    assert demo[demo.index("--shape") + 1] == "demo" and "--hold" not in demo and "--report" not in demo
    assert not set(multichip_demo.WIDE_WORKER_ARGS[::2]) - {"--timeout"} & set(demo)
    assert demo[demo.index("--timeout") + 1] == "0.5"
    args = write_tier_demo.build_parser().parse_args([])
    assert args.out == "WRITETIER_torch_r01.json" and not os.path.isabs(args.out)
    assert (args.steps, args.kill_at_step, args.step_sleep, args.timeout, args.shape) == (24, 13, 1.0, 0.5, "demo")
    jax_args = ["--timeout", "--step-sleep", "--steps", "--kill-at-step", "--min-writes", "--max-p99-ms",
                "--max-blip-ms", "--worker-timeout", "--out"]
    got = {a.option_strings[0] for a in write_tier_demo.build_parser()._actions if a.option_strings}
    assert got >= set(jax_args) | {"--device", "--shape", "--report-dir", "--hold"}


def test_chip_smoke_write_tier_phase_holds_on_the_cpu(monkeypatch, tmp_path, capsys):
    """chip_smoke.py's phase 22 with ``dev="cpu"`` at the demo's width: the
    demo as a subprocess, every gate of the phase."""
    import torch

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    ns["phase_write_tier"].__globals__.update(WRITE_SHAPE="demo", WRITE_STEPS=SHORT["steps"],
                                              WRITE_KILL_AT=SHORT["kill_at_step"],
                                              WRITE_STEP_SLEEP=SHORT["step_sleep"])
    with ThreadPoolExecutor(1) as pool:
        launches = ns["phase_write_tier"](torch, "cpu", ns["start_write_tier"](torch, pool, "cpu"))
    assert launches == {n: 0 for n in ns["SOURCES"]}  # the CPU's plain versions count nothing
    (line,) = [json.loads(ln.split("] ", 1)[1]) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[22 write tier]")]
    assert len(line["checks"]) == 17 and all(line["checks"].values())
    assert line["killed"] == "w2" and line["kill_step"] >= SHORT["kill_at_step"]
    assert sorted(line["per_worker"]) == ["w0", "w1", "w3"] and line["outcomes"]["victim_hard"] > 0
    assert all(set(h) == {"K1c", "K2", "K3"} for h in line["held"].values())
    assert [e["uncovered"] for e in line["violating_arm"]["counterexample"]] == [[8, 20]]
