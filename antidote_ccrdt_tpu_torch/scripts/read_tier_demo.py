"""Fleet read tier acceptance drill (serve/router.py tentpole gate).

Four real worker processes (scripts/net_gossip_demo.py, CCRDT_SERVE=1)
gossip the topk_rmv drill over TCP under seeded chaos (tcp.send drops +
serve.query delays inside the workers, router.route drops in the
supervisor) while client threads route batched reads through a
`serve.FleetRouter` — HRW candidate order, per-peer circuit breakers,
bounded retries, forced hedging on one client, and per-client
`ClientSession` tokens (read-your-writes + monotonic-reads). One
serving worker is SIGKILLed mid-load. The gate holds the read tier to
its whole contract at once:

* **degrade, never hang** — every routed query completes or errors
  honestly (ok / overloaded / session_unsatisfiable); zero
  ``unavailable`` results, and no query exceeds a hard latency ceiling
  even across the kill;
* **honesty** — zero served results whose ``staleness_bound_s`` exceeds
  the requested ``max_staleness_s`` (the plane enforces; the client
  re-checks);
* **SLOs under chaos** — fleet reads/sec and client-observed p99 stay
  inside bounds, and the post-kill failover blip (the longest gap
  between consecutive successful responses around the SIGKILL) is
  bounded;
* **observability** — the `router.*` counters the dashboard renders are
  actually lit (queries, successes, failovers, hedges), and the seeded
  ``router.route`` fault point demonstrably fired;
* **certified sessions** — `obs.audit.certify_sessions` replays the
  supervisor's flight log and signs a clean certificate (zero
  violations, nonzero reads AND writes), while a deliberately
  token-violating arm (`session_mode="ignore"` routed at a stale stub
  peer) must FAIL certification with a minimal counterexample.

A session whose guarantees die with the killed origin is surfaced as
``session_unsatisfiable`` (honest refusal); the client then opens a
fresh session — counted, never hidden.

Port of ``scripts/read_tier_demo.py``: the same constants, fault plans,
seeds, router arguments, client mix, flags and defaults, printed text,
report keys, checks and exit codes, over this package's serve, audit,
topo and transport modules, with the port's ``net_gossip_demo``
workers::

    python -m antidote_ccrdt_tpu_torch.scripts.read_tier_demo [--out FILE] [--kill-at-step N]
        [--device cpu|cuda] [--shape demo|R,I,B,BR,M,K] [--report-dir DIR] [--hold]

Each worker is ``python -m antidote_ccrdt_tpu_torch.scripts.net_gossip_demo``
in a session of its own, and on every way out of the drill every process
group of the fleet is killed. Options of the port only, as
write_tier_demo's:

* ``--device`` (default: the card; without one it raises) holds every
  worker's engine and serve plane.
* ``--shape`` is the workers' width (elastic_demo's ``--shape``; ``demo``
  is the JAX drill's). At any width but the demo's, the workers run with
  multichip_demo's ``WIDE_WORKER_ARGS`` (8 s failure detector, 0.25 s
  heartbeat, 60 s barrier window), so that an anchor publish is not taken
  for a death. Over TCP an anchor must fit ``MAX_FRAME``: 40 000 ids at
  R = 32 (225 MB) is the widest.
* ``--report-dir DIR``: each worker writes its ``--report`` there as
  ``report-<member>.json``, and the supervisor writes ``supervisor.json``
  (the victim, the wall time and step of its SIGKILL, the storm's span,
  the detail of each ``unavailable`` result), once when the storm stops
  and again at the end.
* ``--hold``: each worker's first K1c, K2 and K3 call is held against its
  plain version.

The report goes to ``--out`` (default ``READTIER_torch_r01.json`` in the
current directory), never to the committed ``READTIER_r01.json``.
`run_fleet` runs the drill without the CLI and returns the report.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.scripts import elastic_demo as ed  # noqa: E402  (the workers' width, the device)
from antidote_ccrdt_tpu_torch.scripts.multichip_demo import WIDE_WORKER_ARGS  # noqa: E402
from antidote_ccrdt_tpu_torch.scripts.write_tier_demo import (  # noqa: E402  (the same four workers' plumbing)
    _kill_group,
    _step_of,
    _wait_addrs,
    _wait_step,
    _write_json,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"

MEMBERS = ["w0", "w1", "w2", "w3"]
CLIENTS = 3           # client 2 runs the forced-hedge router
QUERY_BATCH = 8
MAX_STALENESS_S = 5.0
HARD_LATENCY_CEILING_S = 10.0   # "zero hangs" — nothing may exceed this

# Worker-side chaos (rides CCRDT_FAULTS into every worker).
WORKER_FAULTS = {
    "tcp.send": [{"action": "drop", "rate": 0.02}],
    "serve.query": [{"action": "delay", "rate": 0.01, "delay_s": 0.002}],
}
# Supervisor-side chaos: the router's own fault point.
ROUTER_FAULTS = {"router.route": [{"action": "drop", "rate": 0.03}]}


def worker_cmd(root: str, member: str, timeout: float, step_sleep: float, dev: str,
               shape: str = "demo", report_dir=None, hold: bool = False) -> list:
    """One worker's command line: JAX's arguments (the worker's own 10
    steps), then the port's (the device, the width, WIDE_WORKER_ARGS off
    the demo's width, the report, the held first calls)."""
    wide = list(WIDE_WORKER_ARGS) if ed.parse_shape(shape) != ed.DEMO else []
    report = ["--report", os.path.join(report_dir, f"report-{member}.json")] if report_dir else []
    return [
        sys.executable, "-m", WORKER, "--root", root, "--member", member,
        "--n-members", str(len(MEMBERS)), "--type", "topk_rmv",
        "--delta", "--publish-every", "1",
        "--timeout", str(timeout),
        "--step-sleep", str(step_sleep),
        "--device", dev, "--shape", shape, *wide, *report, *(["--hold"] if hold else []),
    ]


def _spawn_fleet(root: str, obs_dir: str, timeout: float, step_sleep: float, dev: str,
                 shape: str, report_dir, hold: bool) -> dict:
    from antidote_ccrdt_tpu_torch.utils import faults as faults_mod

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_SERVE"] = "1"
    env["CCRDT_FAULTS"] = faults_mod.plan_to_env(WORKER_FAULTS, seed=11)
    procs = {}
    for member in MEMBERS:
        procs[member] = subprocess.Popen(
            worker_cmd(root, member, timeout, step_sleep, dev, shape, report_dir, hold),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO, start_new_session=True,
        )
    return procs


def _drop_router_status(root: str, router) -> None:
    """obs-router.json: the dashboard's router column-group feed, same
    atomic-replace convention as the workers' obs-<member>.json."""
    doc = {"member": "router", "t": time.time(), "router": router.status()}
    path = os.path.join(root, "obs-router.json")
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _violating_arm():
    """The audit layer's negative control, in-process: a router in
    ``session_mode="ignore"`` routed at a stale stub peer must produce a
    flight log that FAILS `certify_sessions` with a counterexample."""
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs.audit import certify_sessions
    from antidote_ccrdt_tpu_torch.serve import ClientSession, FleetRouter
    from antidote_ccrdt_tpu_torch.topo import rendezvous_order
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics

    wms = {"stale": {"w0": 1, "w1": 1}, "fresh": {"w0": 9, "w1": 9}}

    def qfn(peer, payload, timeout_s, cancel):
        return (json.dumps({
            "member": peer, "n": 1, "watermarks": wms[peer],
            "results": [{"value": [], "as_of_seq": 1,
                         "staleness_bound_s": 0.0}],
        }) + "\n").encode()

    # A key whose HRW head is the stale peer, so ignore-mode routing
    # deterministically serves the violating answer.
    vkey = next(k for k in (f"v{i}" for i in range(64))
                if rendezvous_order(k, ["stale", "fresh"])[0] == "stale")
    n0 = len(obs_events.events())
    r = FleetRouter(["stale", "fresh"], qfn, metrics=Metrics(),
                    hedge=False, retries=0, poll_s=0.001,
                    session_mode="ignore")
    sess = ClientSession("demo-violating")
    sess.note_write("w0", 7)  # the floor the stale answer cannot cover
    out = r.query([{"op": "value", "key": 0}], key=vkey, session=sess)
    evs = obs_events.events()[n0:]
    cert = certify_sessions(
        logs={"violating-arm": evs},
        meta={"arm": "session_mode=ignore", "drill": "read_tier_demo"},
    )
    return cert, out


def run_fleet(  # noqa: PLR0915 — one linear acceptance drill
    timeout: float = 0.5, step_sleep: float = 1.0, kill_at_step: int = 5, min_reads: float = 300.0,
    max_p99_ms: float = 1500.0, max_blip_ms: float = 5000.0, worker_timeout: float = 240.0,
    device=None, shape: str = "demo", report_dir=None, hold: bool = False, failures=None,
) -> dict:
    """The drill without the CLI: the fleet on `device` (the card by
    default; raises without one) at elastic_demo's width `shape`, the
    storm, the kill, the certificates. Returns the report; the failures
    that are no check (a worker's exit code, a missed kill step) are
    appended to `failures` and make ``report["pass"]`` false. Every
    process group of the fleet is killed on the way out."""
    import random

    from antidote_ccrdt_tpu_torch.net.tcp import query_peer
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs.audit import certify_sessions, verify_certificate
    from antidote_ccrdt_tpu_torch.serve import (
        ClientSession, FleetRouter, request_bytes, tcp_query_fn,
    )
    from antidote_ccrdt_tpu_torch.topo import rendezvous_order
    from antidote_ccrdt_tpu_torch.utils import faults
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics

    dev = ed.resolve_worker_device(device)  # raises without a card unless the CPU is asked for
    ed.parse_shape(shape)  # a bad width fails before any worker starts
    failures = [] if failures is None else failures
    n_failures0 = len(failures)
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    # Session events are request-plane (per-kind rings in obs/events.py)
    # so the query storm can no longer evict the early session.write
    # evidence the certifier replays — a default recorder suffices.
    obs_events.reset("router")

    victim = rendezvous_order("k0", MEMBERS)[0]
    dead: set = set()
    metrics = Metrics()
    supervisor = {"victim": victim, "kill_t": None, "kill_step": None}

    with tempfile.TemporaryDirectory(prefix="read-tier-") as tmp:
        root = os.path.join(tmp, "fleet")
        obs_dir = os.path.join(tmp, "obs")
        os.makedirs(root)
        print(f"== read tier: {len(MEMBERS)}-worker TCP fleet, "
              f"SIGKILL {victim} at step {kill_at_step} ==", flush=True)
        procs = _spawn_fleet(root, obs_dir, timeout, step_sleep, str(dev), shape, report_dir, hold)
        try:
            addrs = _wait_addrs(root, 60.0)
            for m in MEMBERS:
                if not _wait_step(root, m, 1, 120.0):
                    raise RuntimeError(f"{m} never reached step 1")

            # Warm every worker's serve path (first query pays the
            # fold/value kernels) so the measured storm sees steady state.
            # Concurrently — a serial warm-up would eat the workers'
            # whole 10-step run before the load even starts.
            warm_errs: list = []

            def _warm(m: str) -> None:
                try:
                    query_peer(addrs[m],
                               request_bytes([{"op": "value", "key": 0}]),
                               timeout=30.0)
                except Exception as e:  # noqa: BLE001 — gate below
                    warm_errs.append(f"{m}: {e}")

            warmers = [
                threading.Thread(target=_warm, args=(m,), daemon=True)
                for m in MEMBERS
            ]
            for t in warmers:
                t.start()
            for t in warmers:
                t.join(60.0)
            if warm_errs:
                raise RuntimeError(
                    f"serve warm-up failed: {'; '.join(warm_errs)}")

            def verdict(p: str) -> str:
                return "dead" if p in dead else "alive"

            faults.install(ROUTER_FAULTS, seed=7)
            r_main = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=metrics,
                verdict_fn=verdict, hedge=False, timeout_s=0.6,
                retries=2, backoff_base_s=0.02, session_wait_s=0.5,
                session_poll_s=0.05, poll_s=0.002, seed=1,
                # Injected route drops concentrate on a session's single
                # covering peer; the default threshold of 3 would open
                # its breaker on chaos alone and starve the session.
                breaker_failures=6,
            )
            r_hedge = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=metrics,
                verdict_fn=verdict, hedge=True, hedge_after_s=0.001,
                timeout_s=0.6, retries=2, backoff_base_s=0.02,
                session_wait_s=0.5, session_poll_s=0.05, poll_s=0.002,
                seed=2, breaker_failures=6,
            )

            n_load0 = len(obs_events.events())
            stop = threading.Event()
            stats = [
                {"lat": [], "ok_t": [], "reads": 0, "stale": 0,
                 "bound_violations": 0, "unavailable": 0, "shed": 0,
                 "unsatisfiable": 0, "resets": 0, "unavailable_details": []}
                for _ in range(CLIENTS)
            ]

            def client(ci: int) -> None:
                rng = random.Random(100 + ci)
                router = r_hedge if ci == CLIENTS - 1 else r_main
                sess = ClientSession(f"demo-c{ci}-0")
                st = stats[ci]
                while not stop.is_set():
                    qs = []
                    for _ in range(QUERY_BATCH):
                        pick = rng.random()
                        if pick < 0.7:
                            qs.append({"op": "value", "key": 0})
                        elif pick < 0.9:
                            qs.append({"op": "topk", "key": 0, "k": 5})
                        else:
                            qs.append({"op": "range", "key": 0,
                                       "lo": 100, "hi": 400})
                    # ~20% of queries ride session-less: they route over
                    # the full candidate list (tokens shrink it), so
                    # injected route drops exercise same-pass failover.
                    use_sess = rng.random() < 0.8
                    t0 = time.monotonic()
                    out = router.query(
                        qs, key=f"k{rng.randrange(32)}",
                        max_staleness_s=MAX_STALENESS_S,
                        session=sess if use_sess else None,
                    )
                    st["lat"].append(time.monotonic() - t0)
                    if "peer" in out and "error" not in out:
                        st["ok_t"].append(time.monotonic())
                        for res in out.get("results", []):
                            if res.get("error") == "stale":
                                st["stale"] += 1
                            elif "error" not in res:
                                st["reads"] += 1
                                if (res.get("staleness_bound_s", 0.0)
                                        > MAX_STALENESS_S + 1e-9):
                                    st["bound_violations"] += 1
                        # Read-your-writes food: claim one served seq of
                        # a live origin as "our write"; later reads must
                        # keep covering it.
                        wm = out.get("watermarks") or {}
                        m = out.get("member")
                        if (rng.random() < 0.05 and m and m != victim
                                and m in wm):
                            sess.note_write(m, int(wm[m]))
                    elif out.get("error") == "session_unsatisfiable":
                        # Honest refusal (e.g. the killed origin's
                        # stream can no longer be proven covered):
                        # surface it, open a fresh session.
                        st["unsatisfiable"] += 1
                        st["resets"] += 1
                        sess = ClientSession(
                            f"demo-c{ci}-{st['resets']}")
                    elif out.get("error") == "overloaded":
                        st["shed"] += 1
                        time.sleep(
                            out.get("retry_after_ms", 50) / 1e3)
                    else:
                        st["unavailable"] += 1
                        st["unavailable_details"].append(out.get("detail"))

            threads = [
                threading.Thread(target=client, args=(i,), daemon=True)
                for i in range(CLIENTS)
            ]
            t_load0 = time.monotonic()
            supervisor["storm_t0"] = time.time()
            for t in threads:
                t.start()

            # Stage the kill mid-load.
            t_kill = None
            if _wait_step(root, victim, kill_at_step, 60.0):
                supervisor["kill_step"] = _step_of(root, victim)
                _kill_group(procs[victim])
                dead.add(victim)
                t_kill = time.monotonic()
                supervisor["kill_t"] = time.time()
                print(f"   SIGKILL -> {victim} (mid-load)", flush=True)
            else:
                failures.append(
                    f"{victim} never reached step {kill_at_step}")
                _kill_group(procs[victim])
                dead.add(victim)

            # Keep the storm running through failover until a survivor
            # nears its final step; stop the clients BEFORE the workers
            # enter teardown so nothing races a closing socket.
            survivor = next(m for m in MEMBERS if m != victim)
            deadline = time.time() + 90.0
            while time.time() < deadline:
                _drop_router_status(root, r_main)
                if _step_of(root, survivor) >= 9:
                    break
                time.sleep(0.25)
            if t_kill is not None:  # ensure a post-kill observation window
                time.sleep(max(0.0, 2.0 - (time.monotonic() - t_kill)))
            stop.set()
            for t in threads:
                t.join(HARD_LATENCY_CEILING_S + 5.0)
            t_load = time.monotonic() - t_load0
            supervisor["storm_t1"] = time.time()
            supervisor["unavailable"] = [d for st in stats for d in st["unavailable_details"]]
            if report_dir:  # the storm is over: what runs now reads no clock of the gates
                _write_json(os.path.join(report_dir, "supervisor.json"), supervisor)
            hung_threads = [t for t in threads if t.is_alive()]
            _drop_router_status(root, r_main)
            n_load1 = len(obs_events.events())
            route_faults = [
                e for e in faults.trace() if e[0] == "router.route"]
            faults.uninstall()

            # -- reap the fleet --------------------------------------------
            outs = {}
            for m, p in procs.items():
                try:
                    out, _ = p.communicate(timeout=worker_timeout)
                    outs[m] = (p.returncode, out)
                except subprocess.TimeoutExpired:
                    _kill_group(p)
                    out, _ = p.communicate()
                    outs[m] = (None, out)
            for m, (rc, out) in outs.items():
                if m != victim and rc != 0:
                    failures.append(f"worker {m} rc={rc}:\n{out}")
            digests = {}
            for path in glob.glob(os.path.join(root, "final-*.json")):
                try:
                    with open(path) as f:
                        doc = json.load(f)
                    digests[doc["member"]] = doc["digest"]
                except (OSError, ValueError, KeyError):
                    continue
            survivors = [m for m in MEMBERS if m != victim]
            converged = sorted(digests) == survivors and len(
                {json.dumps(d, sort_keys=True) for d in digests.values()}
            ) == 1
            if not converged:
                failures.append(
                    "survivors did not all converge to one digest "
                    f"(finals from {sorted(digests)})")

            # -- audit the storm -------------------------------------------
            lat = sorted(x for st in stats for x in st["lat"])
            ok_t = sorted(x for st in stats for x in st["ok_t"])
            reads = sum(st["reads"] for st in stats)
            agg = {
                k: sum(st[k] for st in stats)
                for k in ("stale", "bound_violations", "unavailable",
                          "shed", "unsatisfiable", "resets")
            }
            p99_ms = (lat[int(0.99 * (len(lat) - 1))] * 1e3) if lat else None
            max_ms = (lat[-1] * 1e3) if lat else None
            reads_per_sec = reads / max(t_load, 1e-9)

            # Failover blip: the longest gap between consecutive
            # successful responses in the window around the kill.
            blip_ms = 0.0
            if t_kill is not None and ok_t:
                window = [t_kill - 0.5] + [
                    t for t in ok_t
                    if t_kill - 0.5 <= t <= t_kill + 4.0
                ]
                gaps = [b - a for a, b in zip(window, window[1:])]
                blip_ms = max(gaps) * 1e3 if gaps else (
                    4.5e3)  # no successes in the window at all
            counters = {
                k: int(v)
                for k, v in metrics.snapshot()["counters"].items()
                if k.startswith("router.")
            }

            # -- certify the clean arm, then the violating arm -------------
            clean_evs = obs_events.events()[n_load0:n_load1]
            cert = certify_sessions(
                logs={"router": clean_evs},
                meta={"arm": "enforce", "drill": "read_tier_demo"},
            )
            bad_cert, bad_out = _violating_arm()
            cx = bad_cert.get("counterexample") or {}

            checks = {
                "zero_hung_queries": not hung_threads
                and (max_ms is None
                     or max_ms <= HARD_LATENCY_CEILING_S * 1e3),
                "zero_unavailable": agg["unavailable"] == 0,
                "zero_bound_violations": agg["bound_violations"] == 0,
                "reads_per_sec_ge_min": reads_per_sec >= min_reads,
                "read_p99_under_slo": p99_ms is not None
                and p99_ms <= max_p99_ms,
                "failover_blip_bounded": blip_ms <= max_blip_ms,
                "router_counters_lit": all(
                    counters.get(k, 0) > 0
                    for k in ("router.queries", "router.successes",
                              "router.attempts", "router.failovers",
                              "router.hedges")
                ),
                "router_route_faults_fired": len(route_faults) > 0,
                "survivors_converged": converged,
                "clean_sessions_certified": bool(cert.get("ok"))
                and verify_certificate(cert)
                and cert.get("n_reads", 0) > 0
                and cert.get("n_writes", 0) > 0
                and cert.get("n_violations", 0) == 0,
                "violating_arm_caught": bad_cert.get("ok") is False
                and verify_certificate(bad_cert)
                and bool(cx)
                and any(
                    v.get("session") == "demo-violating"
                    and v.get("origin") == "w0"
                    and v.get("have", 9) < v.get("want", -1)
                    for v in cx.values()
                ),
            }
            report = {
                "drill": "read_tier_demo",
                "fleet": MEMBERS,
                "killed": victim,
                "clients": CLIENTS,
                "query_batch": QUERY_BATCH,
                "load_s": round(t_load, 3),
                "fleet_reads_per_sec": round(reads_per_sec, 1),
                "read_p99_ms": None if p99_ms is None else round(p99_ms, 3),
                "read_max_ms": None if max_ms is None else round(max_ms, 3),
                "failover_blip_ms": round(blip_ms, 3),
                "reads": reads,
                "outcomes": agg,
                "route_faults_fired": len(route_faults),
                "counters": dict(sorted(counters.items())),
                "session_certificate": {
                    "ok": cert.get("ok"),
                    "n_sessions": cert.get("n_sessions"),
                    "n_reads": cert.get("n_reads"),
                    "n_writes": cert.get("n_writes"),
                    "n_violations": cert.get("n_violations"),
                },
                "violating_arm": {
                    "ok": bad_cert.get("ok"),
                    "served_by": bad_out.get("peer"),
                    "counterexample": cx,
                },
                "checks": checks,
                "pass": all(checks.values()) and len(failures) == n_failures0,
            }
            if report_dir:
                _write_json(os.path.join(report_dir, "supervisor.json"), dict(supervisor, done=True))
            return report
        finally:
            faults.uninstall()
            for p in procs.values():
                _kill_group(p)
            for p in procs.values():
                with contextlib.suppress(subprocess.TimeoutExpired):
                    p.wait(timeout=30.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="READTIER_torch_r01.json",
                    help="the report (default: READTIER_torch_r01.json in the current directory)")
    ap.add_argument("--timeout", type=float, default=0.5,
                    help="worker SWIM timeout")
    ap.add_argument("--step-sleep", type=float, default=1.0)
    ap.add_argument("--kill-at-step", type=int, default=5)
    ap.add_argument("--min-reads", type=float, default=300.0)
    ap.add_argument("--max-p99-ms", type=float, default=1500.0)
    ap.add_argument("--max-blip-ms", type=float, default=5000.0)
    ap.add_argument("--worker-timeout", type=float, default=240.0)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="the workers' width: demo or R,I,B,BR,M,K (elastic_demo's)")
    ap.add_argument("--report-dir", default="", help="the workers write their --report files here")
    ap.add_argument("--hold", action="store_true",
                    help="hold each worker's first K1c, K2 and K3 call against its plain version")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    def _terminate(signum, frame):
        raise SystemExit(128 + signum)  # the drill's `finally` kills the fleet

    saved = signal.signal(signal.SIGTERM, _terminate)
    failures: list = []
    try:
        report = run_fleet(
            timeout=args.timeout, step_sleep=args.step_sleep, kill_at_step=args.kill_at_step,
            min_reads=args.min_reads, max_p99_ms=args.max_p99_ms, max_blip_ms=args.max_blip_ms,
            worker_timeout=args.worker_timeout, device=args.device, shape=args.shape,
            report_dir=args.report_dir or None, hold=args.hold, failures=failures,
        )
    finally:
        signal.signal(signal.SIGTERM, saved)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps(report, indent=2, sort_keys=True))
    if failures:
        print("FAIL:")
        for f in failures:
            print(f"  - {f}")
        return 1
    checks = report["checks"]
    if not report["pass"]:
        bad = [k for k, ok in checks.items() if not ok]
        print(f"FAIL: {', '.join(bad)}", file=sys.stderr)
        return 1
    reads, reads_per_sec = report["reads"], report["fleet_reads_per_sec"]
    p99_ms, blip_ms = report["read_p99_ms"], report["failover_blip_ms"]
    print(
        f"PASS: {reads} reads at {reads_per_sec:,.0f}/s "
        f"(p99 {p99_ms:.1f}ms, blip {blip_ms:.0f}ms) across "
        f"{report['killed']}'s SIGKILL; sessions certified clean, "
        f"violating arm convicted"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
