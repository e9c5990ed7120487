"""Request-tracing acceptance drill (obs/rtrace.py tentpole gate).

Four real worker processes (scripts/net_gossip_demo.py, CCRDT_SERVE=1)
serve the topk_rmv drill over TCP under seeded chaos (tcp.send drops +
serve.query stalls inside the workers, router.route drops in the
supervisor) while traced client threads — one of them hedging — route
batched reads through a `serve.FleetRouter` with the rtrace plane
armed at sample=1.0. One serving worker is SIGKILLed mid-load while a
probe request is held in flight at it, so the SWIM flip lands as a
``dead_reroute`` hop inside a stored waterfall. The gate holds the
tracing plane to its whole contract at once:

* **gap-free waterfalls** — every sampled completed request in the
  trace ring reassembles end-to-end (dense hop sequence, route
  decision, winning attempt, server echo) on the ClockSync-aligned
  timeline; zero orphan hops tolerated beyond 1%;
* **attribution** — the route / backoff / wire / queue_wait / kernel /
  ack_probe buckets sum to >= 90% of client-observed latency at the
  median AND at the p99 request — latency the plane cannot explain is
  latency nobody can fix;
* **exemplars** — the OpenMetrics exemplar on the read-latency
  histogram resolves to a real stored trace whose dominant bucket the
  report names (the scrape-to-trace pivot actually pivots);
* **failover evidence** — the mid-load SIGKILL renders as a
  ``dead_reroute`` hop in a stored trace and the post-kill success gap
  stays bounded;
* **overhead** — sampled-on tracing costs <= 5% of serve reads/sec
  against this same fleet's own ``CCRDT_RTRACE=0`` kill-switch windows
  (interleaved on/off measurement, same router, same workers).

Port of ``scripts/rtrace_demo.py``: the same constants, fault plans,
seeds, router arguments, client mix, held probe, overhead estimate,
flags and defaults, printed text, report keys, checks and exit codes,
over this package's serve, rtrace, topo and transport modules, with the
port's ``net_gossip_demo`` workers::

    python -m antidote_ccrdt_tpu_torch.scripts.rtrace_demo [--out FILE] [--steps N]
        [--device cpu|cuda] [--shape demo|R,I,B,BR,M,K] [--report-dir DIR] [--hold]

Each worker is ``python -m antidote_ccrdt_tpu_torch.scripts.net_gossip_demo``
in a session of its own, and on every way out of the drill every process
group of the fleet is killed. Options of the port only, as
read_tier_demo's:

* ``--device`` (default: the card; without one it raises) holds every
  worker's engine and serve plane.
* ``--shape`` is the workers' width (elastic_demo's ``--shape``; ``demo``
  is the JAX drill's). At any width but the demo's, the workers run with
  multichip_demo's ``WIDE_WORKER_ARGS`` (8 s failure detector, 0.25 s
  heartbeat, 60 s barrier window). The routers read the supervisor's own
  dead set, so the slowed detector moves only the survivors' adoption
  and their final barrier.
* ``--report-dir DIR``: each worker writes its ``--report`` there as
  ``report-<member>.json``; the supervisor writes ``supervisor.json``
  (the victim, the wall time of its SIGKILL, a survivor's step then, the
  storm's span), once when the storm stops and again at the end, and
  copies the run's obs directory (``flight-router.jsonl`` and the
  workers' spills, which ``ccrdt_rtrace`` reads) to ``DIR/obs``.
* ``--hold``: each worker's first K1c, K2 and K3 call is held against its
  plain version.

The report goes to ``--out`` (default ``RTRACE_torch_r01.json`` in the
current directory), never to the committed ``RTRACE_r01.json``.
`run_fleet` runs the drill without the CLI and returns the report.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import re
import shutil
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
HARD_LATENCY_CEILING_S = 10.0

# Worker-side chaos (rides CCRDT_FAULTS into every worker).
WORKER_FAULTS = {
    "tcp.send": [{"action": "drop", "rate": 0.02}],
    "serve.query": [{"action": "delay", "rate": 0.01, "delay_s": 0.002}],
}
# Supervisor-side chaos: the router's own fault point.
ROUTER_FAULTS = {"router.route": [{"action": "drop", "rate": 0.03}]}


def worker_cmd(root: str, member: str, timeout: float, step_sleep: float, steps: int, dev: str,
               shape: str = "demo", report_dir=None, hold: bool = False) -> list:
    """One worker's command line: JAX's arguments, then the port's (the
    device, the width, WIDE_WORKER_ARGS off the demo's width, the report,
    the held first calls)."""
    wide = list(WIDE_WORKER_ARGS) if ed.parse_shape(shape) != ed.DEMO else []
    report = ["--report", os.path.join(report_dir, f"report-{member}.json")] if report_dir else []
    return [
        sys.executable, "-m", WORKER, "--root", root, "--member", member,
        "--n-members", str(len(MEMBERS)), "--type", "topk_rmv",
        "--delta", "--publish-every", "1",
        "--timeout", str(timeout),
        "--step-sleep", str(step_sleep),
        "--steps", str(steps),
        "--device", dev, "--shape", shape, *wide, *report, *(["--hold"] if hold else []),
    ]


def _spawn_fleet(root: str, obs_dir: str, timeout: float, step_sleep: float, steps: int, dev: str,
                 shape: str, report_dir, hold: bool) -> dict:
    from antidote_ccrdt_tpu_torch.utils import faults as faults_mod

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_SERVE"] = "1"
    # Workers echo server-side hop timings for any traced request
    # (server_trace is stateless), but arming their planes exercises
    # the install_from_env propagation path and lights their obs-
    # <member>.json rtrace block for the dashboard column.
    env["CCRDT_RTRACE"] = "1"
    env["CCRDT_FAULTS"] = faults_mod.plan_to_env(WORKER_FAULTS, seed=11)
    # Survivors linger serving after their final barrier so the
    # overhead A/B runs against a QUIESCED fleet (no stepping, no
    # per-step first calls); the supervisor drops <root>/serve-stop to
    # release them.
    env["CCRDT_SERVE_LINGER_S"] = "60"
    procs = {}
    for member in MEMBERS:
        procs[member] = subprocess.Popen(
            worker_cmd(root, member, timeout, step_sleep, steps, dev, shape, report_dir, hold),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO, start_new_session=True,
        )
    return procs


def _drop_router_status(root: str, router, rtrace_mod) -> None:
    """obs-router.json: the dashboard's router + rtrace column feeds,
    same atomic-replace convention as the workers' obs-<member>.json."""
    doc = {
        "member": "router", "t": time.time(), "router": router.status(),
        "rtrace": rtrace_mod.counters(),
    }
    path = os.path.join(root, "obs-router.json")
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
    except OSError:
        pass


def _measure_overhead(router, rtrace_mod, seconds: float, into=None) -> tuple:
    """Paired-difference overhead measurement on the live fleet.

    A sequential off-window/on-window split bills the fleet's drift
    over the window (state growth, first calls, gossip load) to
    whichever arm ran second, and even per-request interleaving with
    per-ARM medians wobbles by whole percents between runs: the fleet's
    latency is regime-shaped (a first call or gossip storm parks it
    hundreds of µs higher for stretches), and each arm's median moves
    with the regime mix it happened to draw. So instead:

    * requests run in kill-switch/traced PAIRS ~5 ms apart — both
      members of a pair land in the same regime, so their difference
      cancels the regime level;
    * the order within each pair alternates (off,on then on,off), so
      monotone drift inside a regime cancels across pairs instead of
      always charging the second slot;
    * pairs where EITHER slot landed in a stall (beyond 1.5x its own
      arm's median) are dropped before estimating — symmetrically, so
      the trim is unbiased: dropping only control-arm stalls would
      remove the negative outliers while keeping the positive ones and
      inflate the contrast;
    * the estimate is the MEDIAN of the surviving (calm, calm) paired
      deltas: the plane's fixed per-request cost measured in the calm
      regime, which is what the budget is about.

    Returns (on_reads_per_sec, off_reads_per_sec) built from the
    off-arm median latency and the paired-delta median on top of it.
    The (off_s, on_s) pairs are appended to `into` when it is a list."""
    import random

    rng = random.Random(1000)
    pairs = [] if into is None else into  # (off_s, on_s)
    flip = False
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        flip = not flip
        pair = {}
        for armed in ((False, True) if flip else (True, False)):
            if armed:
                os.environ.pop(rtrace_mod.ENV, None)
                rtrace_mod.install("router", sample=1.0, metrics=None)
            else:
                os.environ[rtrace_mod.ENV] = "0"   # the kill switch
                rtrace_mod.uninstall()
            t0 = time.monotonic()
            out = router.query(
                [{"op": "value", "key": 0} for _ in range(QUERY_BATCH)],
                key=f"k{rng.randrange(32)}",
                max_staleness_s=MAX_STALENESS_S,
            )
            dt = time.monotonic() - t0
            if "error" not in out:
                pair[armed] = dt
        if len(pair) == 2:
            pairs.append((pair[False], pair[True]))
    rtrace_mod.uninstall()
    os.environ.pop(rtrace_mod.ENV, None)

    if not pairs:
        return 0.0, 0.0
    calm = calm_pairs(pairs)
    deltas = sorted(p[1] - p[0] for p in calm)
    calm_offs = sorted(p[0] for p in calm)
    off_med = calm_offs[len(calm_offs) // 2]
    delta_med = deltas[len(deltas) // 2]
    off_rps = QUERY_BATCH / max(off_med, 1e-9)
    on_rps = QUERY_BATCH / max(off_med + max(delta_med, 0.0), 1e-9)
    return on_rps, off_rps


def calm_pairs(pairs: list) -> list:
    """The (off_s, on_s) pairs `_measure_overhead` estimates from: those
    where neither slot is beyond 1.5x its own arm's median (all of them
    if none is)."""
    off_med = sorted(p[0] for p in pairs)[len(pairs) // 2]
    on_med = sorted(p[1] for p in pairs)[len(pairs) // 2]
    return [p for p in pairs if p[0] <= 1.5 * off_med and p[1] <= 1.5 * on_med] or pairs


def run_fleet(  # noqa: PLR0915 — one linear acceptance drill
    timeout: float = 0.5, step_sleep: float = 1.4, steps: int = 14, overhead_window_s: float = 6.0,
    storm_prekill_s: float = 2.0, storm_postkill_s: float = 4.0, max_overhead_pct: float = 5.0,
    min_coverage: float = 0.9, min_complete_frac: float = 0.99, max_blip_ms: float = 5000.0,
    worker_timeout: float = 240.0, device=None, shape: str = "demo", report_dir=None, hold: bool = False,
    failures=None,
) -> dict:
    """The drill without the CLI: the fleet on `device` (the card by
    default; raises without one) at elastic_demo's width `shape`, the
    traced storm, the held probe and the kill, the overhead window on the
    quiesced survivors. Returns the report; the failures that are no check
    (a worker's exit code) are appended to `failures` and make
    ``report["pass"]`` false. With `report_dir`, the last
    ``supervisor.json`` also holds the attribution report, the overhead
    window's span and its pairs before and after the trim. Every process
    group of the fleet is killed on the way out."""
    import random

    from antidote_ccrdt_tpu_torch.net.tcp import query_peer
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs import export as obs_export
    from antidote_ccrdt_tpu_torch.obs import rtrace
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
    obs_events.reset("router")
    os.environ.pop(rtrace.ENV, None)  # a stale kill switch would void the drill

    victim = rendezvous_order("k0", MEMBERS)[0]
    dead: set = set()
    metrics = Metrics()
    supervisor = {"victim": victim, "kill_t": None, "kill_step": None}

    with tempfile.TemporaryDirectory(prefix="rtrace-") as tmp:
        root = os.path.join(tmp, "fleet")
        obs_dir = os.path.join(tmp, "obs")
        os.makedirs(root)
        print(f"== rtrace drill: {len(MEMBERS)}-worker TCP fleet, "
              f"SIGKILL {victim} mid-load, sample=1.0 ==", flush=True)
        procs = _spawn_fleet(root, obs_dir, timeout, step_sleep, steps, str(dev), shape, report_dir, hold)
        try:
            addrs = _wait_addrs(root, 60.0)
            for m in MEMBERS:
                if not _wait_step(root, m, 1, 120.0):
                    raise RuntimeError(f"{m} never reached step 1")

            # Warm every worker's serve path concurrently (first query
            # pays the fold/value kernels' first calls).
            warm_errs: list = []

            def _warm(m: str) -> None:
                try:
                    query_peer(addrs[m],
                               request_bytes([{"op": "value", "key": 0}]),
                               timeout=30.0)
                except Exception as e:  # noqa: BLE001 — gate below
                    warm_errs.append(f"{m}: {e}")

            warmers = [threading.Thread(target=_warm, args=(m,), daemon=True)
                       for m in MEMBERS]
            for t in warmers:
                t.start()
            for t in warmers:
                t.join(60.0)
            if warm_errs:
                raise RuntimeError(
                    f"serve warm-up failed: {'; '.join(warm_errs)}")

            def verdict(p: str) -> str:
                return "dead" if p in dead else "alive"

            # -- the traced chaos storm --------------------------------------
            rtrace.install("router", sample=1.0, ring=1 << 14,
                           metrics=metrics)
            faults.install(ROUTER_FAULTS, seed=7)
            r_main = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=metrics,
                verdict_fn=verdict, hedge=False, timeout_s=0.6,
                retries=3, backoff_base_s=0.02, session_wait_s=0.5,
                session_poll_s=0.05, poll_s=0.002, seed=1,
                breaker_failures=6,
            )
            r_hedge = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=metrics,
                verdict_fn=verdict, hedge=True, hedge_after_s=0.001,
                timeout_s=0.6, retries=3, backoff_base_s=0.02,
                session_wait_s=0.5, session_poll_s=0.05, poll_s=0.002,
                seed=2, breaker_failures=6,
            )

            stop = threading.Event()
            stats = [
                {"lat": [], "ok_t": [], "reads": 0, "unavailable": 0,
                 "shed": 0, "unsatisfiable": 0, "resets": 0}
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
                        st["reads"] += sum(
                            1 for r in out.get("results", [])
                            if "error" not in r
                        )
                        wm = out.get("watermarks") or {}
                        m = out.get("member")
                        if (rng.random() < 0.05 and m and m != victim
                                and m in wm):
                            sess.note_write(m, int(wm[m]))
                    elif out.get("error") == "session_unsatisfiable":
                        st["unsatisfiable"] += 1
                        st["resets"] += 1
                        sess = ClientSession(f"demo-c{ci}-{st['resets']}")
                    elif out.get("error") == "overloaded":
                        st["shed"] += 1
                        time.sleep(out.get("retry_after_ms", 50) / 1e3)
                    else:
                        st["unavailable"] += 1

            threads = [threading.Thread(target=client, args=(i,),
                                        daemon=True)
                       for i in range(CLIENTS)]
            t_load0 = time.monotonic()
            supervisor["storm_t0"] = time.time()
            for t in threads:
                t.start()
            time.sleep(storm_prekill_s)

            # -- the staged dead_reroute + SIGKILL ---------------------------
            # A probe request is held in flight at the victim (the
            # wrapper stalls only pre-kill victim sends), then the SWIM
            # verdict flips and the process dies: the router must cancel
            # the in-flight attempt, record the `dead_reroute` hop, and
            # fail over — all inside ONE stored waterfall.
            base_qfn = tcp_query_fn(addrs)

            def probe_qfn(peer, payload, timeout_s, cancel):
                if peer == victim and victim not in dead:
                    # Stall until the ROUTER cancels the attempt: ending
                    # the stall on the verdict flip itself would race the
                    # router's poll loop (the attempt could settle as a
                    # plain failure before the loop sees the flip and
                    # records the dead_reroute hop).
                    for _ in range(600):
                        if cancel.is_set():
                            raise TimeoutError("probe attempt cancelled")
                        time.sleep(0.01)
                    raise TimeoutError("probe stall expired")
                return base_qfn(peer, payload, timeout_s, cancel)

            r_probe = FleetRouter(
                MEMBERS, probe_qfn, metrics=metrics, verdict_fn=verdict,
                hedge=False, timeout_s=5.0, retries=2,
                backoff_base_s=0.02, poll_s=0.002, seed=4,
                breaker_failures=6,
            )
            probe_out: dict = {}

            def probe() -> None:
                probe_out.update(r_probe.query(
                    [{"op": "value", "key": 0}], key="k0",
                    max_staleness_s=MAX_STALENESS_S,
                ))

            survivor = next(m for m in MEMBERS if m != victim)
            probe_thread = threading.Thread(target=probe, daemon=True)
            probe_thread.start()
            time.sleep(0.15)           # the probe attempt is in flight
            dead.add(victim)           # SWIM verdict flips first...
            time.sleep(0.05)           # ...and the poll loop observes it
            _kill_group(procs[victim])
            t_kill = time.monotonic()
            supervisor["kill_t"] = time.time()
            supervisor["kill_step"] = _step_of(root, survivor)
            print(f"   SIGKILL -> {victim} (probe in flight)", flush=True)
            probe_thread.join(15.0)

            # Keep the storm running through failover; stop the clients
            # BEFORE the workers enter teardown.
            deadline = time.time() + storm_postkill_s
            while time.time() < deadline \
                    and _step_of(root, survivor) < steps - 3:
                _drop_router_status(root, r_main, rtrace)
                time.sleep(0.25)
            stop.set()
            for t in threads:
                t.join(HARD_LATENCY_CEILING_S + 5.0)
            t_load = time.monotonic() - t_load0
            supervisor["storm_t1"] = time.time()
            if report_dir:  # the storm is over
                _write_json(os.path.join(report_dir, "supervisor.json"), supervisor)
            hung_threads = [t for t in threads if t.is_alive()]
            _drop_router_status(root, r_main, rtrace)
            route_faults = [
                e for e in faults.trace() if e[0] == "router.route"]
            faults.uninstall()

            # -- reassemble the evidence BEFORE teardown ---------------------
            offs = rtrace.offsets()
            trs = rtrace.traces("read")
            sampled_ok = [t for t in trs
                          if t["outcome"] == "ok" and t.get("sampled")]
            incomplete = [(t, rtrace.complete(t)[1]) for t in sampled_ok]
            incomplete = [(t, why) for t, why in incomplete if why]
            complete_frac = (
                (len(sampled_ok) - len(incomplete)) / len(sampled_ok)
                if sampled_ok else 0.0
            )
            rep = rtrace.attribution_report(sampled_ok, offs)
            print(rtrace.format_report(rep), flush=True)

            # The p99 exemplar on the scrape surface must resolve to a
            # real stored trace.
            scrape = obs_export.prometheus_text(metrics)
            ex_m = re.search(
                r'ccrdt_router_read_seconds[^\n]*trace_id="([^"]+)"',
                scrape)
            ex_trace = rtrace.find(ex_m.group(1)) if ex_m else None
            ex_dom = None
            if ex_trace is not None:
                attr = rtrace.attribute(ex_trace, offs)
                ex_dom = max(
                    (b for b in rtrace.BUCKETS if b != "hedge_overlap"),
                    key=lambda b: attr.get(b, 0.0),
                )

            # The dead_reroute hop must have landed in a stored trace.
            reroute_traces = [
                t for t in trs
                if any(h.get("k") == "dead_reroute"
                       for h in t.get("hops", ()))
            ]
            if reroute_traces:
                print("   dead_reroute waterfall "
                      f"({reroute_traces[-1]['id']}):")
                for row in rtrace.waterfall(reroute_traces[-1], offs):
                    print(f"     {row['name']:<13} {row['t0_ms']:>9.3f} -> "
                          f"{row['t1_ms']:>9.3f}ms "
                          f"{row.get('peer', '')}")

            counters = rtrace.counters()
            rc_router = {
                k: int(v)
                for k, v in metrics.snapshot()["counters"].items()
                if k.startswith("router.")
            }
            obs_events.dump(os.path.join(obs_dir, "flight-router.jsonl"))
            rtrace.uninstall()

            # -- overhead: kill-switch (off) vs traced (on), paired per
            # request against the QUIESCED survivors — they finished
            # stepping and are lingering in serve-only mode, so neither
            # arm can land inside a step's first calls or a gossip
            # stall. No supervisor faults: the only variable is the
            # plane. ---------------------------------------------------------
            survivors_set = {m for m in MEMBERS if m != victim}
            fin_deadline = time.time() + 120.0
            while time.time() < fin_deadline:
                done = {
                    os.path.basename(p)[len("final-"):-len(".json")]
                    for p in glob.glob(os.path.join(root, "final-*.json"))
                }
                if survivors_set <= done:
                    break
                time.sleep(0.2)
            r_ovh = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=Metrics(),
                verdict_fn=verdict, hedge=False, timeout_s=0.6,
                retries=2, backoff_base_s=0.02, poll_s=0.002, seed=3,
                breaker_failures=6,
            )
            pairs: list = []
            supervisor["overhead_t0"] = time.time()
            on_rps, off_rps = _measure_overhead(r_ovh, rtrace, overhead_window_s, into=pairs)
            supervisor["overhead_t1"] = time.time()
            overhead_pct = max(0.0, (off_rps - on_rps) / max(off_rps, 1e-9)
                               * 100.0)
            print(f"   overhead: traced {on_rps:,.0f} reads/s vs "
                  f"CCRDT_RTRACE=0 {off_rps:,.0f} reads/s "
                  f"({overhead_pct:.2f}%) on the quiesced survivors", flush=True)
            with open(os.path.join(root, "serve-stop"), "w") as f:
                f.write("done\n")

            # -- reap the fleet ----------------------------------------------
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

            # -- audit the storm ---------------------------------------------
            lat = sorted(x for st in stats for x in st["lat"])
            ok_t = sorted(x for st in stats for x in st["ok_t"])
            reads = sum(st["reads"] for st in stats)
            agg = {k: sum(st[k] for st in stats)
                   for k in ("unavailable", "shed", "unsatisfiable",
                             "resets")}
            max_ms = (lat[-1] * 1e3) if lat else None
            blip_ms = 0.0
            if ok_t:
                window = [t_kill - 0.5] + [
                    t for t in ok_t if t_kill - 0.5 <= t <= t_kill + 4.0
                ]
                gaps = [b - a for a, b in zip(window, window[1:])]
                blip_ms = max(gaps) * 1e3 if gaps else 4.5e3

            checks = {
                "zero_hung_queries": not hung_threads
                and (max_ms is None
                     or max_ms <= HARD_LATENCY_CEILING_S * 1e3),
                "zero_unavailable": agg["unavailable"] == 0,
                "waterfalls_complete": bool(sampled_ok)
                and complete_frac >= min_complete_frac,
                "attribution_p50_covered": rep.get("coverage_p50", 0.0)
                >= min_coverage,
                "attribution_p99_covered": rep.get("coverage_p99_req", 0.0)
                >= min_coverage,
                "exemplar_resolves": ex_trace is not None
                and ex_dom is not None,
                "dead_reroute_traced": bool(reroute_traces)
                and rc_router.get("router.dead_reroutes", 0) > 0,
                "probe_failed_over": probe_out.get("error") is None
                and probe_out.get("peer") in survivors,
                "failover_blip_bounded": blip_ms <= max_blip_ms,
                "overhead_under_budget": overhead_pct
                <= max_overhead_pct,
                "rtrace_counters_lit": all(
                    counters.get(k, 0) > 0
                    for k in ("minted", "sampled", "committed",
                              "slow_kept")
                ),
                "clock_offsets_learned": len(offs) > 0,
                "route_faults_fired": len(route_faults) > 0,
                "survivors_converged": converged,
            }
            report = {
                "drill": "rtrace_demo",
                "fleet": MEMBERS,
                "killed": victim,
                "clients": CLIENTS,
                "sample": 1.0,
                "load_s": round(t_load, 3),
                "traced_reads_per_sec": round(on_rps, 1),
                "untraced_reads_per_sec": round(off_rps, 1),
                "overhead_pct": round(overhead_pct, 3),
                "storm_reads": reads,
                "outcomes": agg,
                "n_sampled_ok": len(sampled_ok),
                "n_incomplete": len(incomplete),
                "complete_frac": round(complete_frac, 4),
                "incomplete_reasons": sorted(
                    {why for _t, why in incomplete})[:5],
                "coverage_p50": rep.get("coverage_p50", 0.0),
                "coverage_p99_req": rep.get("coverage_p99_req", 0.0),
                "p99_trace_id": rep.get("p99_trace_id"),
                "p99_dominant_bucket": rep.get("p99_dominant_bucket"),
                "exemplar_trace_id": ex_m.group(1) if ex_m else None,
                "exemplar_dominant_bucket": ex_dom,
                "dead_reroute_trace_id": (
                    reroute_traces[-1]["id"] if reroute_traces else None
                ),
                "failover_blip_ms": round(blip_ms, 3),
                "route_faults_fired": len(route_faults),
                "rtrace_counters": {
                    k: int(v) for k, v in sorted(counters.items())},
                "checks": checks,
                "pass": all(checks.values()) and len(failures) == n_failures0,
            }
            if report_dir:
                shutil.copytree(obs_dir, os.path.join(report_dir, "obs"), dirs_exist_ok=True)
                _write_json(os.path.join(report_dir, "supervisor.json"), dict(
                    supervisor, done=True, attribution=rep, pairs=len(pairs),
                    calm_pairs=len(calm_pairs(pairs)) if pairs else 0))
            return report
        finally:
            faults.uninstall()
            rtrace.uninstall()
            os.environ.pop("CCRDT_RTRACE", None)
            for p in procs.values():
                _kill_group(p)
            for p in procs.values():
                with contextlib.suppress(subprocess.TimeoutExpired):
                    p.wait(timeout=30.0)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="RTRACE_torch_r01.json",
                    help="the report (default: RTRACE_torch_r01.json in the current directory)")
    ap.add_argument("--timeout", type=float, default=0.5,
                    help="worker SWIM timeout")
    ap.add_argument("--step-sleep", type=float, default=1.4,
                    help="worker inter-step idle: big enough that the "
                         "serve path sees calm stretches between the "
                         "steps")
    ap.add_argument("--steps", type=int, default=14,
                    help="worker step count (sets the serving window)")
    ap.add_argument("--overhead-window-s", type=float, default=6.0,
                    help="total per-request-interleaved overhead window")
    ap.add_argument("--storm-prekill-s", type=float, default=2.0)
    ap.add_argument("--storm-postkill-s", type=float, default=4.0)
    ap.add_argument("--max-overhead-pct", type=float, default=5.0)
    ap.add_argument("--min-coverage", type=float, default=0.9)
    ap.add_argument("--min-complete-frac", type=float, default=0.99)
    ap.add_argument("--max-blip-ms", type=float, default=5000.0)
    ap.add_argument("--worker-timeout", type=float, default=240.0)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="the workers' width: demo or R,I,B,BR,M,K (elastic_demo's)")
    ap.add_argument("--report-dir", default="",
                    help="the workers write their --report files here; supervisor.json and the obs spill too")
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
            timeout=args.timeout, step_sleep=args.step_sleep, steps=args.steps,
            overhead_window_s=args.overhead_window_s, storm_prekill_s=args.storm_prekill_s,
            storm_postkill_s=args.storm_postkill_s, max_overhead_pct=args.max_overhead_pct,
            min_coverage=args.min_coverage, min_complete_frac=args.min_complete_frac,
            max_blip_ms=args.max_blip_ms, worker_timeout=args.worker_timeout, device=args.device,
            shape=args.shape, report_dir=args.report_dir or None, hold=args.hold, failures=failures,
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
    rep_ok = report["complete_frac"]
    print(
        f"PASS: {report['n_sampled_ok']} waterfalls "
        f"({rep_ok:.1%} gap-free), coverage p50 "
        f"{report['coverage_p50']:.1%} / p99 "
        f"{report['coverage_p99_req']:.1%}, exemplar -> "
        f"{report['exemplar_dominant_bucket']}, dead_reroute traced across {report['killed']}'s "
        f"SIGKILL (blip {report['failover_blip_ms']:.0f}ms), overhead "
        f"{report['overhead_pct']:.2f}%"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
