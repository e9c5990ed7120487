"""The port's request-tracing drill (``antidote_ccrdt_tpu_torch/scripts/
rtrace_demo.py``) against the JAX package's ``scripts/rtrace_demo.py``, on
the CPU.

* The overhead estimate: on one scripted stub router and a stepped
  ``time.monotonic``, with stalls in either arm and failed reads, the
  port's ``_measure_overhead`` gives JAX's ``(on_rps, off_rps)``.
* The fleet: chip_smoke.py's phase 24 at the demo's width on the CPU
  (four port ``net_gossip_demo`` workers at JAX's depth and pacing, the
  demo as a subprocess), run once for the module. Its ten checks that read
  no clock hold; the four that do (overhead, coverage at p50 and p99, the
  blip) are computed and reported, with bounds the CPU under the other
  test processes can meet (the card holds them at JAX's). The report's
  keys and check names are those of the committed ``RTRACE_r01.json``,
  and the port's and JAX's ``ccrdt_rtrace`` print the same bytes over the
  run's kept spill.
* The width: ``--shape`` reaches every worker, multichip_demo's
  ``WIDE_WORKER_ARGS`` only off the demo's width, ``CCRDT_RTRACE=1`` and
  ``CCRDT_SERVE_LINGER_S=60`` ride every worker's environment, and the
  default ``--out`` is not the committed carrier.
"""

import contextlib
import importlib.util
import io
import json
import os
import random
import runpy
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from antidote_ccrdt_tpu_torch.obs import rtrace
from antidote_ccrdt_tpu_torch.scripts import ccrdt_rtrace, multichip_demo, rtrace_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = ("overhead_under_budget", "attribution_p50_covered", "attribution_p99_covered", "failover_blip_bounded")
# Phase 24's bounds on the CPU: JAX's share of complete waterfalls, and
# bounds for the four timed checks that hold under any load.
CPU_BOUNDS = (1e9, 0.0, 0.99, 1e9)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _SteppedClock:
    """A ``time.monotonic`` that moves only when the stub router serves a
    read (by that read's scripted latency) or when it is read (1 µs)."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 1e-6
        return self.t


class _Plane:
    """The two calls `_measure_overhead` makes of the rtrace module."""

    ENV = "CCRDT_RTRACE"

    def __init__(self):
        self.armed = False

    def install(self, member, sample=1.0, metrics=None):
        self.armed = True

    def uninstall(self):
        self.armed = False


class _ScriptedRouter:
    """Reads whose latency is scripted from a seed: a traced read costs
    `extra_s` more; about one read in eight (of either arm) stalls 3-6x;
    one in forty fails, which drops its pair."""

    def __init__(self, clock, plane, seed, extra_s=0.00012):
        self.clock, self.plane, self.rng, self.extra_s = clock, plane, random.Random(seed), extra_s
        self.keys = []

    def query(self, qs, key, max_staleness_s):
        assert len(qs) == rtrace_demo.QUERY_BATCH and max_staleness_s == rtrace_demo.MAX_STALENESS_S
        self.keys.append(key)
        lat = 0.0025 * (1.0 + 0.2 * self.rng.random())
        if self.rng.random() < 0.125:
            lat *= self.rng.uniform(3.0, 6.0)
        if self.plane.armed:
            lat += self.extra_s
        self.clock.t += lat
        if self.rng.random() < 0.025:
            return {"error": "unavailable"}
        return {"peer": "w0", "results": []}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_measure_overhead_equals_jax_on_scripted_latencies(monkeypatch, seed):
    jax_demo = _jax_script("rtrace_demo")
    got = {}
    for name, fn in (("jax", jax_demo._measure_overhead), ("port", rtrace_demo._measure_overhead)):
        clock, plane = _SteppedClock(), _Plane()
        monkeypatch.setattr(time, "monotonic", clock)
        router = _ScriptedRouter(clock, plane, seed)
        got[name] = (fn(router, plane, 6.0), router.keys)
        assert os.environ.get(plane.ENV) is None and not plane.armed  # the kill switch is taken away
    (want, want_keys), (have, have_keys) = got["jax"], got["port"]
    assert have == want and have_keys == want_keys and len(have_keys) > 1000
    on_rps, off_rps = have
    assert 0.0 < on_rps < off_rps  # the traced arm's 120 µs a read shows through the stalls and the trim

    # The pairs the port hands back are those the estimate was made from.
    clock, plane = _SteppedClock(), _Plane()
    monkeypatch.setattr(time, "monotonic", clock)
    pairs = []
    assert rtrace_demo._measure_overhead(_ScriptedRouter(clock, plane, seed), plane, 6.0, into=pairs) == want
    calm = rtrace_demo.calm_pairs(pairs)
    assert 0 < len(calm) < len(pairs) and all(p in pairs for p in calm)


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    """chip_smoke.py's phase 24 on the CPU at the demo's width, once: the
    phase's log line and launches, the demo's run, report and
    supervisor.json, its workers' reports, and a copy of its report
    directory (the obs spill included) taken before the phase removes it."""
    import torch

    base = tmp_path_factory.mktemp("rtrace-phase")
    kept = str(base / "kept")
    mp = pytest.MonkeyPatch()
    mp.setattr(tempfile, "tempdir", str(base))  # the phase's directories, and no other's
    mp.setenv("OMP_NUM_THREADS", "1")
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    got = {"bounds": ns["RTRACE_BOUNDS"], "windows": ns["RTRACE_WINDOWS"], "steps": ns["RTRACE_STEPS"]}
    real_finish, real_readings = ns["finish_tier_demo"], ns["rtrace_readings"]

    def finish(demo):
        run, report, sup, workers = real_finish(demo)
        got.update(run=run, report=report, supervisor=sup, workers=workers)
        return run, report, sup, workers

    def readings(rep, rep_dir, victim, survivors):
        shutil.copytree(rep_dir, kept)
        return real_readings(rep, rep_dir, victim, survivors)

    g = ns["phase_rtrace"].__globals__
    g.update(RTRACE_SHAPE="demo", RTRACE_BOUNDS=CPU_BOUNDS, finish_tier_demo=finish, rtrace_readings=readings)
    out = io.StringIO()
    try:
        with ThreadPoolExecutor(1) as pool:
            demo = ns["start_rtrace"](torch, pool, "cpu")
            got["storm_over_returned"] = ns["storm_over"](demo)
            with contextlib.redirect_stdout(out):
                got["launches"] = ns["phase_rtrace"](torch, "cpu", demo)
        got["tmp_removed"] = not os.path.exists(demo["tmp"].name)
    finally:
        mp.undo()
    (line,) = [json.loads(ln.split("] ", 1)[1]) for ln in out.getvalue().splitlines()
               if ln.startswith("[24 request tracing]")]
    return dict(got, line=line, kept=kept, sources=ns["SOURCES"])


def test_chip_smoke_rtrace_phase_holds_on_the_cpu(phase):
    """Phase 24's gates with ``dev="cpu"``: every check (the four timed ones
    at CPU_BOUNDS), the SIGKILL with the probe in flight, the three
    survivors' reports with their held calls, and the port's ccrdt_rtrace
    over the kept spill, whose waterfall shows the dead_reroute at the
    victim and then a survivor's answer."""
    assert phase["bounds"] == (5.0, 0.9, 0.99, 5000.0) and phase["windows"] == (2.0, 4.0, 6.0)
    assert phase["steps"] == 14  # JAX's depth, bounds and windows
    assert phase["launches"] == {n: 0 for n in phase["sources"]}  # the CPU's plain versions count nothing
    storm = phase["storm_over_returned"]  # supervisor.json as the storm stopped
    assert storm["victim"] == "w2" and storm["storm_t0"] < storm["kill_t"] < storm["storm_t1"]
    assert "overhead_t0" not in storm and phase["tmp_removed"]
    line = phase["line"]
    assert len(line["checks"]) == 14 and all(line["checks"].values())
    assert line["killed"] == "w2" and line["outcomes"]["unavailable"] == 0
    assert sorted(line["per_worker"]) == ["w0", "w1", "w3"] and line["storm_end_to_exit_s"] > 0
    assert all(set(h) == {"K1c", "K2", "K3"} for h in line["held"].values())
    assert 0 < line["overhead_calm_pairs"] <= line["overhead_pairs"]
    assert line["storm_s"]["start"] < line["storm_s"]["end"] <= line["overhead_window_s"]["start"]
    assert line["overhead_window_s"]["start"] < line["overhead_window_s"]["end"]
    assert ["dead_reroute", "w2"] in line["cli_report_waterfall"]
    fall = line["cli_failover_waterfall"]
    at = fall.index(["dead_reroute", "w2"])
    assert any(row[0] == "attempt" and row[1] in ("w0", "w1", "w3") for row in fall[at + 1:])
    assert line["failover_traces"] >= 1 and line["failover_trace_id"]
    assert line["cli_p99_dominant_bucket"] == phase["report"]["p99_dominant_bucket"]
    assert set(line["buckets_ms_p50"]) == set(line["buckets_ms_p99"]) == set(rtrace.BUCKETS)


def test_fleet_holds_every_check_that_reads_no_clock(phase):
    report, sup = phase["report"], phase["supervisor"]
    untimed = {k: v for k, v in report["checks"].items() if k not in TIMED}
    assert sorted(untimed) == sorted([
        "zero_unavailable", "waterfalls_complete", "exemplar_resolves", "dead_reroute_traced", "probe_failed_over",
        "rtrace_counters_lit", "clock_offsets_learned", "route_faults_fired", "survivors_converged",
        "zero_hung_queries"])
    assert all(untimed.values()), untimed
    assert report["pass"] and phase["run"]["rc"] == 0
    assert report["complete_frac"] >= 0.99 and report["n_sampled_ok"] > 0 and report["n_incomplete"] == 0
    assert report["killed"] == sup["victim"] == rtrace_demo.MEMBERS[2]
    assert sup["done"] and sup["storm_t0"] < sup["kill_t"] < sup["storm_t1"] < sup["overhead_t0"] < sup["overhead_t1"]
    assert "SIGKILL -> w2 (probe in flight)" in phase["run"]["out"]
    assert sorted(os.listdir(phase["kept"])) == sorted(
        [f"report-{m}.json" for m in rtrace_demo.MEMBERS if m != "w2"] + ["supervisor.json", "obs"])


def test_fleet_computes_the_timed_checks(phase):
    """The four checks that read the wall clock are computed from the run
    (against the bounds it was given) and their numbers reported; the
    card holds them at JAX's bounds (chip_smoke.py's phase 24)."""
    report = phase["report"]
    max_pct, min_cov, _, max_blip_ms = CPU_BOUNDS
    assert all(isinstance(report["checks"][k], bool) for k in TIMED)
    assert report["checks"]["overhead_under_budget"] == (report["overhead_pct"] <= max_pct)
    assert report["checks"]["attribution_p50_covered"] == (report["coverage_p50"] >= min_cov)
    assert report["checks"]["attribution_p99_covered"] == (report["coverage_p99_req"] >= min_cov)
    assert report["checks"]["failover_blip_bounded"] == (report["failover_blip_ms"] <= max_blip_ms)
    assert 0.0 < report["traced_reads_per_sec"] and 0.0 < report["untraced_reads_per_sec"]
    assert 0.0 < report["coverage_p50"] <= 1.0 and 0.0 < report["coverage_p99_req"] <= 1.0


def test_fleet_report_has_the_carriers_keys_and_check_names(phase):
    with open(os.path.join(REPO, "RTRACE_r01.json")) as f:
        carrier = json.load(f)
    report = phase["report"]
    assert set(report) == set(carrier)
    assert set(report["checks"]) == set(carrier["checks"]) and len(report["checks"]) == 14
    assert set(report["outcomes"]) == set(carrier["outcomes"])
    assert set(report["rtrace_counters"]) >= {"minted", "sampled", "committed", "slow_kept"}
    assert (report["fleet"], report["clients"], report["sample"]) == (
        carrier["fleet"], carrier["clients"], carrier["sample"])


@pytest.mark.parametrize("which", ["attribute", "waterfall"])
def test_ccrdt_rtrace_prints_jaxs_bytes_over_the_ports_spill(phase, capsys, which):
    obs = os.path.join(phase["kept"], "obs")
    args = {"attribute": ["attribute", obs, "--json"],
            "waterfall": ["waterfall", obs, "--trace", phase["report"]["dead_reroute_trace_id"], "--json"]}[which]
    jax_cli = _jax_script("ccrdt_rtrace")
    capsys.readouterr()
    assert jax_cli.main(args) == 0
    want = capsys.readouterr()
    assert ccrdt_rtrace.main(args) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err and got.out.strip()
    doc = json.loads(got.out)
    if which == "waterfall":
        assert any(r["name"] == "dead_reroute" and r["peer"] == "w2" for r in doc["waterfall"])
    else:
        assert doc["p99_dominant_bucket"] and doc["n"] > 0


def test_width_reaches_every_worker_and_the_default_out_is_not_the_carrier(monkeypatch, tmp_path):
    started = []

    class Recorded:
        def __init__(self, cmd, **kw):
            started.append((cmd, kw))

    monkeypatch.setattr(subprocess, "Popen", Recorded)
    wide = "32,10000,32768,2048,4,100"
    rtrace_demo._spawn_fleet(str(tmp_path), "obs", 0.5, 1.4, 14, "cpu", wide, str(tmp_path / "rep"), True)
    assert len(started) == len(rtrace_demo.MEMBERS)
    for (cmd, kw), m in zip(started, rtrace_demo.MEMBERS):
        assert cmd[:3] == [sys.executable, "-m", rtrace_demo.WORKER] and kw["start_new_session"]
        assert cmd[cmd.index("--shape") + 1] == wide and cmd[cmd.index("--member") + 1] == m
        assert " ".join(multichip_demo.WIDE_WORKER_ARGS) in " ".join(cmd) and "--hold" in cmd
        assert cmd[cmd.index("--report") + 1] == str(tmp_path / "rep" / f"report-{m}.json")
        # JAX's worker flags: its 14 steps at 1.4 s, a publish every step, no WAL.
        assert cmd[cmd.index("--steps") + 1] == "14" and cmd[cmd.index("--step-sleep") + 1] == "1.4"
        assert cmd[cmd.index("--publish-every") + 1] == "1" and "--delta" in cmd and "--wal-dir" not in cmd
        # The slowed detector overrides JAX's --timeout: argparse keeps the last.
        assert cmd[len(cmd) - cmd[::-1].index("--timeout")] == "8.0"
        env = kw["env"]
        assert (env["CCRDT_RTRACE"], env["CCRDT_SERVE_LINGER_S"], env["CCRDT_SERVE"]) == ("1", "60", "1")
        # No JAX platform or XLA flag is set or taken away.
        changed = {k for k, v in env.items() if os.environ.get(k) != v}
        assert set(os.environ) <= set(env) and changed <= {
            "PYTHONPATH", "CCRDT_OBS_DIR", "CCRDT_SERVE", "CCRDT_FAULTS", "CCRDT_RTRACE", "CCRDT_SERVE_LINGER_S"}
    demo = rtrace_demo.worker_cmd("root", "w0", 0.5, 1.4, 14, "cpu")
    assert demo[demo.index("--shape") + 1] == "demo" and "--hold" not in demo and "--report" not in demo
    assert not set(multichip_demo.WIDE_WORKER_ARGS[::2]) - {"--timeout"} & set(demo)
    assert demo[demo.index("--timeout") + 1] == "0.5"
    args = rtrace_demo.build_parser().parse_args([])
    assert args.out == "RTRACE_torch_r01.json" and not os.path.isabs(args.out)
    assert (args.timeout, args.step_sleep, args.steps, args.overhead_window_s, args.storm_prekill_s,
            args.storm_postkill_s, args.max_overhead_pct, args.min_coverage, args.min_complete_frac,
            args.max_blip_ms, args.worker_timeout, args.shape) == (
        0.5, 1.4, 14, 6.0, 2.0, 4.0, 5.0, 0.9, 0.99, 5000.0, 240.0, "demo")
    jax = _jax_script("rtrace_demo")
    assert (rtrace_demo.MEMBERS, rtrace_demo.CLIENTS, rtrace_demo.QUERY_BATCH, rtrace_demo.MAX_STALENESS_S,
            rtrace_demo.HARD_LATENCY_CEILING_S, rtrace_demo.WORKER_FAULTS, rtrace_demo.ROUTER_FAULTS) == (
        jax.MEMBERS, jax.CLIENTS, jax.QUERY_BATCH, jax.MAX_STALENESS_S, jax.HARD_LATENCY_CEILING_S,
        jax.WORKER_FAULTS, jax.ROUTER_FAULTS)
