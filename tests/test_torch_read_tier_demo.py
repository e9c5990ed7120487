"""The port's fleet read-tier drill (``antidote_ccrdt_tpu_torch/scripts/
read_tier_demo.py``) against the JAX package's ``scripts/read_tier_demo.py``,
on the CPU.

* The violating arm: under a frozen wall clock the port's certificate is
  byte-equal to JAX's, signature included, and so is the router's answer.
* The fleet: four port ``net_gossip_demo`` workers at the demo's width
  and pacing, run once for the module (a shorter storm can end with no
  hedge launched, and ``router_counters_lit`` then fails). The eight
  checks that read no throughput or timing hold, ``zero_unavailable``
  among them; the three that do are computed (the card holds them at
  JAX's bounds: chip_smoke.py's phase 23; here they would read the load
  of the other test processes). The report's keys and check names are
  those of the committed ``READTIER_r01.json``; JAX's
  ``certify_sessions`` over the clean arm's events gives the port's
  certificate.
* The reference's fault behind JAX's ``zero_unavailable`` misses: a
  session whose floor only one live peer covers sends every retry round
  to that peer, so three transient faults of it in a row end JAX's read
  ``unavailable``; the port's router waits within the session wait
  instead.
* The width: ``--shape`` reaches every worker, multichip_demo's
  ``WIDE_WORKER_ARGS`` only off the demo's width, and the default ``--out``
  is not the committed carrier.
"""

import importlib
import importlib.util
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

from antidote_ccrdt_tpu_torch.scripts import multichip_demo, read_tier_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN_T = 1_700_000_000.0
TIMED = ("reads_per_sec_ge_min", "read_p99_under_slo", "failover_blip_bounded")


def _jax_read_tier_demo():
    spec = importlib.util.spec_from_file_location("jax_read_tier_demo",
                                                  os.path.join(REPO, "scripts", "read_tier_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """One drill on the CPU at the demo's width: its report, its failures,
    the clean arm's certificate and logs, and the supervisor's record."""
    from antidote_ccrdt_tpu_torch.obs import audit as port_audit

    got = {"clean": None}
    real_certify = port_audit.certify_sessions

    def certify(logs, meta=None, **kw):
        cert = real_certify(logs=logs, meta=meta, **kw)
        if (meta or {}).get("arm") == "enforce":
            got["clean"] = dict(logs=logs, cert=cert)
        return cert

    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")  # each worker process computes on one CPU thread
    mp.setattr(port_audit, "certify_sessions", certify)
    rep_dir = tmp_path_factory.mktemp("read-tier-reports")
    failures = []
    try:
        report = read_tier_demo.run_fleet(device="cpu", report_dir=str(rep_dir), failures=failures)
    finally:
        mp.undo()
    with open(rep_dir / "supervisor.json") as f:
        supervisor = json.load(f)
    return dict(got, report=report, failures=failures, rep_dir=rep_dir, supervisor=supervisor)


def test_violating_arm_certificate_is_byte_equal_to_jax(frozen_clocks):
    want_cert, want_out = _jax_read_tier_demo()._violating_arm()
    got_cert, got_out = read_tier_demo._violating_arm()
    assert json.dumps(got_cert, sort_keys=True) == json.dumps(want_cert, sort_keys=True)
    assert got_cert["t"] == FROZEN_T and got_cert["ok"] is False
    assert got_out == want_out and got_out["peer"] == "stale"
    (cx,) = got_cert["counterexample"].values()
    assert (cx["session"], cx["origin"]) == ("demo-violating", "w0") and cx["have"] < cx["want"]


def test_fleet_holds_every_check_that_reads_no_clock(fleet):
    report = fleet["report"]
    untimed = {k: v for k, v in report["checks"].items() if k not in TIMED}
    assert sorted(untimed) == sorted(["zero_hung_queries", "zero_unavailable", "zero_bound_violations",
                                      "router_counters_lit", "router_route_faults_fired", "survivors_converged",
                                      "clean_sessions_certified", "violating_arm_caught"])
    assert fleet["failures"] == [], fleet["failures"][:1]
    assert all(untimed.values()), (untimed, fleet["supervisor"]["unavailable"])
    assert report["outcomes"]["unavailable"] == 0 and fleet["supervisor"]["unavailable"] == []
    victim = report["killed"]
    assert victim == read_tier_demo.MEMBERS[2] == fleet["supervisor"]["victim"]
    assert fleet["supervisor"]["kill_step"] >= 5 and fleet["supervisor"]["done"]
    assert sorted(os.listdir(fleet["rep_dir"])) == sorted(
        [f"report-{m}.json" for m in read_tier_demo.MEMBERS if m != victim] + ["supervisor.json"])


def test_fleet_computes_the_timed_checks(fleet):
    """The three checks that read the run's throughput and timing are
    computed from the storm (held at JAX's bounds on the card only)."""
    report = fleet["report"]
    assert all(isinstance(report["checks"][k], bool) for k in TIMED)
    assert report["reads"] > 0 and report["load_s"] > 0
    assert report["checks"]["reads_per_sec_ge_min"] == (report["fleet_reads_per_sec"] >= 300.0)
    assert report["checks"]["read_p99_under_slo"] == (report["read_p99_ms"] <= 1500.0)
    assert report["checks"]["failover_blip_bounded"] == (report["failover_blip_ms"] <= 5000.0)
    assert 0 <= report["read_p99_ms"] <= report["read_max_ms"]


def test_fleet_report_has_the_carriers_keys_and_check_names(fleet):
    with open(os.path.join(REPO, "READTIER_r01.json")) as f:
        carrier = json.load(f)
    report = fleet["report"]
    assert set(report) == set(carrier)
    assert set(report["checks"]) == set(carrier["checks"]) and len(report["checks"]) == 11
    for key in ("outcomes", "session_certificate", "violating_arm"):
        assert set(report[key]) == set(carrier[key]), key
    assert (report["fleet"], report["clients"], report["query_batch"]) == (
        carrier["fleet"], carrier["clients"], carrier["query_batch"])


def test_fleet_clean_certificate_equals_jax(fleet):
    from antidote_ccrdt_tpu.obs.audit import certify_sessions as jax_certify_sessions

    clean = fleet["clean"]
    want = jax_certify_sessions(logs=clean["logs"], meta={"arm": "enforce", "drill": "read_tier_demo"})
    got = clean["cert"]
    assert got["ok"] and got["n_reads"] > 0 and got["n_writes"] > 0
    for key in ("ok", "n_sessions", "n_reads", "n_writes", "n_violations"):
        assert got[key] == want[key] == fleet["report"]["session_certificate"][key], key


def _pinned_session_router(package, w0_failures, breaker_failures=6):
    """A router over w0 and w1 that has learned w1's watermarks (w1 lags
    w0's stream), a session whose floor only w0 covers, and a w0 whose
    first `w0_failures` replies a worker's tcp.send drop loses: (the
    read's answer, the peers asked, the router's counters)."""
    serve = importlib.import_module(f"{package}.serve")
    metrics = importlib.import_module(f"{package}.utils.metrics")
    attempts = []

    def qfn(peer, payload, timeout_s, cancel):
        attempts.append(peer)
        if peer == "w0" and attempts.count("w0") <= w0_failures:
            raise ConnectionError("query connection closed before reply")  # as net.tcp.query_peer raises it
        return (json.dumps({"member": peer, "n": 1, "watermarks": {"w0": 9 if peer == "w0" else 1, "w1": 9},
                            "results": [{"value": [], "as_of_seq": 1, "staleness_bound_s": 0.0}]}) + "\n").encode()

    m = metrics.Metrics()
    r = serve.FleetRouter(["w0", "w1"], qfn, metrics=m, hedge=False, retries=2, backoff_base_s=0.0,
                          session_wait_s=0.5, session_poll_s=0.01, poll_s=0.001,
                          breaker_failures=breaker_failures, seed=1)
    r._learn_watermarks("w1", {"w0": 1, "w1": 9})
    sess = serve.ClientSession("pinned")
    sess.note_write("w0", 5)  # a floor only w0 can cover
    out = r.query([{"op": "value", "key": 0}], key="k0", session=sess)
    return out, attempts, m.snapshot()["counters"]


@pytest.mark.parametrize("package", ["antidote_ccrdt_tpu", "antidote_ccrdt_tpu_torch"])
def test_a_session_only_one_failing_peer_covers_ends_unavailable(package):
    """A floor that only w0 covers, and a w0 that never answers (its
    breaker never opens, so that the retries alone decide): both packages'
    routers end the read ``unavailable`` and never ask w1. JAX's spends
    its three rounds on w0 at once; the port's first waits out the session
    wait, asking w0 again each poll."""
    out, attempts, counters = _pinned_session_router(package, w0_failures=10**6, breaker_failures=10**6)
    assert out["error"] == "unavailable" and out["detail"] == "w0: query connection closed before reply"
    assert set(attempts) == {"w0"} and counters.get("router.exhausted", 0) == 1
    if package == "antidote_ccrdt_tpu":
        assert len(attempts) == 3 and counters.get("router.session_waits", 0) == 0
    else:
        assert len(attempts) > 3 and counters["router.session_waits"] == 1


@pytest.mark.parametrize("package", ["antidote_ccrdt_tpu", "antidote_ccrdt_tpu_torch"])
def test_three_faults_of_the_one_covering_peer_end_the_read_only_in_jax(package):
    """The reference's fault behind JAX's zero_unavailable misses (it
    missed in both of JAX's CPU runs): three transient faults in a row of
    the one peer that covers a session's floor end JAX's read
    ``unavailable``. The port's router waits within the session wait
    instead of spending its rounds, and its fourth ask is answered."""
    out, attempts, counters = _pinned_session_router(package, w0_failures=3)
    if package == "antidote_ccrdt_tpu":
        assert out["error"] == "unavailable" and attempts == ["w0"] * 3
    else:
        assert "error" not in out and out["peer"] == "w0" and attempts == ["w0"] * 4
        assert counters["router.session_waits"] == 1 and counters.get("router.exhausted", 0) == 0


def test_width_reaches_every_worker_and_the_default_out_is_not_the_carrier(monkeypatch, tmp_path):
    started = []

    class Recorded:
        def __init__(self, cmd, **kw):
            started.append((cmd, kw))

    monkeypatch.setattr(subprocess, "Popen", Recorded)
    wide = "32,10000,32768,2048,4,100"
    read_tier_demo._spawn_fleet(str(tmp_path), "obs", 0.5, 1.0, "cpu", wide, str(tmp_path / "rep"), True)
    assert len(started) == len(read_tier_demo.MEMBERS)
    for (cmd, kw), m in zip(started, read_tier_demo.MEMBERS):
        assert cmd[:3] == [sys.executable, "-m", read_tier_demo.WORKER] and kw["start_new_session"]
        assert cmd[cmd.index("--shape") + 1] == wide and cmd[cmd.index("--member") + 1] == m
        assert " ".join(multichip_demo.WIDE_WORKER_ARGS) in " ".join(cmd) and "--hold" in cmd
        assert cmd[cmd.index("--report") + 1] == str(tmp_path / "rep" / f"report-{m}.json")
        # JAX's worker flags: its own 10 steps, a publish every step, no WAL.
        assert "--steps" not in cmd and "--wal-dir" not in cmd
        assert cmd[cmd.index("--publish-every") + 1] == "1" and "--delta" in cmd
        # The slowed detector overrides JAX's --timeout: argparse keeps the last.
        assert cmd[len(cmd) - cmd[::-1].index("--timeout")] == "8.0"
        # The workers' environment is this process's with the serve plane
        # and the faults: no JAX platform or XLA flag is set or taken away.
        changed = {k for k, v in kw["env"].items() if os.environ.get(k) != v}
        assert set(os.environ) <= set(kw["env"]) and changed <= {
            "PYTHONPATH", "CCRDT_OBS_DIR", "CCRDT_SERVE", "CCRDT_FAULTS"}
    demo = read_tier_demo.worker_cmd("root", "w0", 0.5, 1.0, "cpu")
    assert demo[demo.index("--shape") + 1] == "demo" and "--hold" not in demo and "--report" not in demo
    assert not set(multichip_demo.WIDE_WORKER_ARGS[::2]) - {"--timeout"} & set(demo)
    assert demo[demo.index("--timeout") + 1] == "0.5"
    args = read_tier_demo.build_parser().parse_args([])
    assert args.out == "READTIER_torch_r01.json" and not os.path.isabs(args.out)
    assert (args.timeout, args.step_sleep, args.kill_at_step, args.min_reads, args.max_p99_ms, args.max_blip_ms,
            args.worker_timeout, args.shape) == (0.5, 1.0, 5, 300.0, 1500.0, 5000.0, 240.0, "demo")
    jax_args = ["--out", "--timeout", "--step-sleep", "--kill-at-step", "--min-reads", "--max-p99-ms",
                "--max-blip-ms", "--worker-timeout"]
    got = {a.option_strings[0] for a in read_tier_demo.build_parser()._actions if a.option_strings}
    assert got >= set(jax_args) | {"--device", "--shape", "--report-dir", "--hold"}
    jax = _jax_read_tier_demo()
    assert (read_tier_demo.MEMBERS, read_tier_demo.CLIENTS, read_tier_demo.QUERY_BATCH,
            read_tier_demo.MAX_STALENESS_S, read_tier_demo.HARD_LATENCY_CEILING_S,
            read_tier_demo.WORKER_FAULTS, read_tier_demo.ROUTER_FAULTS) == (
        jax.MEMBERS, jax.CLIENTS, jax.QUERY_BATCH, jax.MAX_STALENESS_S, jax.HARD_LATENCY_CEILING_S,
        jax.WORKER_FAULTS, jax.ROUTER_FAULTS)


def test_chip_smoke_read_tier_phase_holds_on_the_cpu(monkeypatch, tmp_path, capsys):
    """chip_smoke.py's phase 23 with ``dev="cpu"`` at the demo's width: the
    demo as a subprocess, every gate of the phase, with bounds for the
    three timed checks that the CPU under the other test processes can
    meet (the card's are JAX's, READ_BOUNDS)."""
    import torch

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the phase's directories, and no other's
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    assert ns["READ_BOUNDS"] == (300.0, 1500.0, 5000.0)  # JAX's defaults
    ns["phase_read_tier"].__globals__.update(READ_SHAPE="demo", READ_BOUNDS=(0.0, 1e9, 1e9))
    with ThreadPoolExecutor(1) as pool:
        demo = ns["start_read_tier"](torch, pool, "cpu")
        ns["storm_over"](demo)
        assert os.path.exists(os.path.join(demo["rep_dir"], "supervisor.json"))
        launches = ns["phase_read_tier"](torch, "cpu", demo)
    assert launches == {n: 0 for n in ns["SOURCES"]}  # the CPU's plain versions count nothing
    assert not os.path.exists(demo["tmp"].name)
    (line,) = [json.loads(ln.split("] ", 1)[1]) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("[23 read tier]")]
    assert len(line["checks"]) == 11 and all(line["checks"].values()) and line["outcomes"]["unavailable"] == 0
    assert line["killed"] == "w2" and line["kill_step"] >= ns["READ_KILL_AT"]
    assert sorted(line["per_worker"]) == ["w0", "w1", "w3"] and line["storm_end_to_exit_s"] > 0
    assert all(set(h) == {"K1c", "K2", "K3"} for h in line["held"].values())
    assert line["session_certificate"]["ok"] and line["violating_arm"]["ok"] is False
