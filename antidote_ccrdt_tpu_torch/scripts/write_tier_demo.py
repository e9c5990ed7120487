"""Fleet write tier acceptance drill (serve/ingest.py tentpole gate).

Four real worker processes (scripts/net_gossip_demo.py, CCRDT_SERVE=1 +
CCRDT_INGEST=1, per-worker crash WAL) gossip the topk_rmv drill over
TCP under seeded chaos (tcp.send drops + serve.write delays inside the
workers, router.write drops in the supervisor) while writer threads
push client effect bursts through `serve.WriteSession` ->
`serve.WriteRouter` — pre-wire ops/compaction (one CCRF range frame per
burst), HRW owner-first routing, shared circuit breakers, bounded
retries, tiered acks (`durable` pinned to the owner's
`wal.durable_seq`, `replicated_to_k` certified client-side by peer
watermark probes). The partition owner of the hot key is SIGKILLed
mid-load. The gate holds the write tier to its whole contract at once:

* **degrade, never hang** — every routed write completes or errors
  honestly (ack / overloaded+retry_after_ms / unavailable); zero
  ``unavailable`` results, zero silent drops, and no write exceeds a
  hard latency ceiling even across the kill;
* **tiered acks for real** — nonzero ``durable`` AND
  ``replicated_to_k`` acks land during the storm, including hard acks
  from the victim before its SIGKILL (the contract under test);
* **read-your-writes across tiers** — each acked write teaches its
  `ClientSession` the ``(origin, seq)`` it landed at, and a follow-up
  read through the READ tier (`serve.FleetRouter`, same session) must
  cover that floor — across the owner's death via survivor delta
  cursors, or refuse honestly (``session_unsatisfiable``);
* **admission honesty** — a shed-arm probe against an overloaded
  in-process plane returns ``overloaded`` with the plane's own
  ``retry_after_ms`` hint, promptly, with the
  ``router.write_shed_returns`` counter lit;
* **observability** — the ``router.write*`` / ``write_session.*``
  counters the dashboard renders are actually lit, and the seeded
  ``router.write`` fault point demonstrably fired;
* **certified durability** — `obs.audit.certify_writes` replays the
  client's ``ingest.ack`` flight events against the fleet's spilled
  durability evidence (victim ``wal.durable`` watermarks, survivor
  ``delta.apply`` cursors) and signs a certificate of ZERO
  acked-but-lost writes across the SIGKILL, while a deliberately
  violating arm (`ack_before_fsync=True`) must FAIL certification
  with a counterexample naming the lost seq range and write_ids.

Port of ``scripts/write_tier_demo.py``: the same constants, fault plans,
seeds, flags and defaults, printed text, report keys, checks and exit
codes, over this package's serve, ingest, audit and transport modules,
with the port's ``net_gossip_demo`` workers::

    python -m antidote_ccrdt_tpu_torch.scripts.write_tier_demo [--out FILE] [--steps N] [--kill-at-step N]
        [--device cpu|cuda] [--shape demo|R,I,B,BR,M,K] [--report-dir DIR] [--hold]

Each worker is ``python -m antidote_ccrdt_tpu_torch.scripts.net_gossip_demo``
in a session of its own, and on every way out of the drill every process
group of the fleet is killed. Options of the port only:

* ``--device`` (default: the card; without one it raises) holds every
  worker's engine and the supervisor's write sessions' compaction.
* ``--shape`` is the workers' width (elastic_demo's ``--shape``; ``demo``
  is the JAX drill's). At any width but the demo's, the workers run with
  multichip_demo's ``WIDE_WORKER_ARGS`` (8 s failure detector, 0.25 s
  heartbeat, 60 s barrier window), so that an anchor publish is not taken
  for a death. Over TCP an anchor must fit ``MAX_FRAME``: 40 000 ids at
  R = 32 (225 MB) is the widest, ``main`` (563 MB) is past it.
* ``--report-dir DIR``: each worker writes its ``--report`` there as
  ``report-<member>.json``, and the supervisor writes ``supervisor.json``
  (the victim, the wall time and step of its SIGKILL, the storm's span),
  once when the storm stops and again at the end.
* ``--hold``: each worker's first K1c, K2 and K3 call is held against its
  plain version.

The report goes to ``--out`` (default ``WRITETIER_torch_r01.json`` in the
current directory), never to the committed ``WRITETIER_r01.json``.
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

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"

MEMBERS = ["w0", "w1", "w2", "w3"]
WRITERS = 3           # writer WRITERS-1 demands replicated_to_k acks
DCS = 4               # elastic_demo topk_rmv geometry (dc = writer % DCS)
IDS_PER_BURST = 3     # 4 adds per id, m_keep=2 -> steady 2.0 coalesce
ADDS_PER_ID = 4       # ...and ONE wire shape (no per-burst JIT churn)
M_KEEP = 2            # == the model's slots_per_id: extras are wire waste
MAX_STALENESS_S = 30.0
HARD_LATENCY_CEILING_S = 30.0   # "zero hangs" — nothing may exceed this
HARD_LEVELS = ("durable", "replicated_to_k")

# Counters that MUST be nonzero after the storm — the write tier going
# silently dark fails the leg even if every burst seems acked (the same
# contract scripts/chaos_gate.py REQUIRED_NONZERO enforces for gossip).
WRITE_REQUIRED_NONZERO = (
    "router.writes",
    "router.write_successes",
    "router.write_failovers",
    "write_session.flushes",
    "write_session.staged_ops",
)

# Worker-side chaos (rides CCRDT_FAULTS into every worker).
WORKER_FAULTS = {
    "tcp.send": [{"action": "drop", "rate": 0.02}],
    "serve.write": [{"action": "delay", "rate": 0.05, "delay_s": 0.002}],
}
# Supervisor-side chaos: the write router's own fault point — injected
# attempt drops force real owner failovers and retries during the storm.
ROUTER_FAULTS = {"router.write": [{"action": "drop", "rate": 0.05}]}


def worker_cmd(root: str, member: str, steps: int, timeout: float, step_sleep: float, dev: str,
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
        "--wal-dir", os.path.join(root, f"wal-{member}"),
        "--steps", str(steps),
        "--timeout", str(timeout),
        "--step-sleep", str(step_sleep),
        "--device", dev, "--shape", shape, *wide, *report, *(["--hold"] if hold else []),
    ]


def _spawn_fleet(root: str, obs_dir: str, steps: int, timeout: float, step_sleep: float, dev: str,
                 shape: str, report_dir, hold: bool) -> dict:
    from antidote_ccrdt_tpu_torch.utils import faults as faults_mod

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_SERVE"] = "1"
    env["CCRDT_INGEST"] = "1"
    # A write is folded at the NEXT step boundary; on a contended host
    # (4 workers sharing cores) a step can take several seconds, so the
    # default 2s ack deadline would time out honest writes. The router's
    # attempt timeout stays above this.
    env["CCRDT_INGEST_ACK_TIMEOUT_S"] = "8"
    env["CCRDT_FAULTS"] = faults_mod.plan_to_env(WORKER_FAULTS, seed=11)
    procs = {}
    for member in MEMBERS:
        procs[member] = subprocess.Popen(
            worker_cmd(root, member, steps, timeout, step_sleep, dev, shape, report_dir, hold),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO, start_new_session=True,
        )
    return procs


def _kill_group(p) -> None:
    """SIGKILL every process of `p`'s session (its process group)."""
    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(p.pid, signal.SIGKILL)


def _wait_addrs(root: str, timeout: float) -> dict:
    """Wait for every worker's addr-<member> rendezvous file."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        addrs = {}
        for m in MEMBERS:
            try:
                with open(os.path.join(root, f"addr-{m}")) as f:
                    hostport = f.read().split()[0]
                host, port = hostport.rsplit(":", 1)
                addrs[m] = (host, int(port))
            except (OSError, ValueError, IndexError):
                break
        if len(addrs) == len(MEMBERS):
            return addrs
        time.sleep(0.05)
    raise RuntimeError("workers never published their addresses")


def _step_of(root: str, member: str) -> int:
    try:
        with open(os.path.join(root, f"obs-{member}.json")) as f:
            return int(json.load(f).get("step", -1))
    except (OSError, ValueError):
        return -1


def _wait_step(root: str, member: str, step: int, timeout: float) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if _step_of(root, member) >= step:
            return True
        time.sleep(0.05)
    return False


def _shed_arm():
    """Admission-control honesty, in-process: a `WriteRouter` walked
    into a plane whose pressure probe sheds must come back PROMPTLY
    with ``overloaded`` and the plane's own retry_after_ms hint — no
    hang, no silent drop, and the shed-return counter lit."""
    from antidote_ccrdt_tpu_torch.serve.ingest import IngestPlane, WriteRouter
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics

    plane = IngestPlane(
        "shed0", metrics=Metrics(),
        pressure_fns=(lambda: 350,), poll_s=0.001,
    )

    def wfn(peer, payload, timeout_s, cancel):
        return plane.handle(payload, surface="local")

    m = Metrics()
    r = WriteRouter(
        ["shed0"], wfn, member="shed-probe", metrics=m, retries=1,
        backoff_base_s=0.0, backoff_max_s=0.0, poll_s=0.001,
    )
    t0 = time.monotonic()
    out = r.write([["add", [1, 5, [0, 2_000_001]]]], key="k0")
    dt_s = time.monotonic() - t0
    shed_returns = int(
        m.snapshot()["counters"].get("router.write_shed_returns", 0)
    )
    return out, dt_s, shed_returns


def _violating_arm():
    """The audit layer's negative control, in-process: a plane armed
    with ``ack_before_fsync=True`` acks ``durable`` the moment the fold
    lands, while its (truthful) origin log shows the fsync watermark
    never passed. `certify_writes` must FAIL with a counterexample
    naming the lost seq range and the acked write_ids inside it."""
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs.audit import certify_writes
    from antidote_ccrdt_tpu_torch.serve.ingest import (
        ACK_DURABLE, IngestPlane, WriteRouter,
    )
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics

    n0 = len(obs_events.events())
    pm = Metrics()
    plane = IngestPlane(
        "v0", metrics=pm, durable_fn=lambda: -1,
        ack_before_fsync=True, poll_s=0.001,
    )
    stop = threading.Event()

    def drain_loop():
        while not stop.is_set():
            plane.drain(20, lambda ops: None)
            time.sleep(0.002)

    th = threading.Thread(target=drain_loop, daemon=True)
    th.start()

    def wfn(peer, payload, timeout_s, cancel):
        return plane.handle(payload, surface="local")

    r = WriteRouter(
        ["v0"], wfn, member="v-probe", metrics=Metrics(),
        retries=0, poll_s=0.001,
    )
    outs = [
        r.write([["add", [i, 5, [0, 3_000_000 + i]]]],
                key="k0", ack=ACK_DURABLE)
        for i in range(3)
    ]
    stop.set()
    th.join(1.0)
    evs = obs_events.events()[n0:]
    # The arm's origin log records the truth the plane ignored: the
    # fsync watermark stalled at 7 while seq-20 folds were acked.
    logs = {
        "client-varm": evs,
        "flight-v0": [
            {"member": "v0", "kind": "wal.durable", "through": 7},
        ],
    }
    cert = certify_writes(
        logs=logs,
        meta={"arm": "ack_before_fsync", "drill": "write_tier_demo"},
    )
    unsafe = int(
        pm.snapshot()["counters"].get("ingest.unsafe_acks", 0)
    )
    return cert, outs, unsafe


def _write_json(path: str, doc: dict) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def run_fleet(  # noqa: PLR0915 — one linear acceptance drill
    steps: int = 24, kill_at_step: int = 13, timeout: float = 0.5, step_sleep: float = 1.0,
    min_writes: float = 6.0, max_p99_ms: float = 15000.0, max_blip_ms: float = 15000.0,
    worker_timeout: float = 240.0, device=None, shape: str = "demo", report_dir=None, hold: bool = False,
    failures=None,
) -> dict:
    """The drill without the CLI: the fleet on `device` (the card by
    default; raises without one) at elastic_demo's width `shape`, the
    storm, the kill, the arms and the certificates. Returns the report;
    the failures that are no check (a worker's exit code, a missed kill
    step) are appended to `failures` and make ``report["pass"]`` false.
    Every process group of the fleet is killed on the way out."""
    import random

    from antidote_ccrdt_tpu_torch.net.tcp import query_peer, write_peer
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs.audit import (
        certify_sessions, certify_writes, verify_certificate,
    )
    from antidote_ccrdt_tpu_torch.serve import (
        ClientSession, FleetRouter, request_bytes, tcp_query_fn,
    )
    from antidote_ccrdt_tpu_torch.serve.ingest import (
        ACK_DURABLE, ACK_REPLICATED, WriteRouter, tcp_write_fn,
    )
    from antidote_ccrdt_tpu_torch.serve.plane import encode
    from antidote_ccrdt_tpu_torch.serve.write_session import (
        WriteSession, effect_to_wire,
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
    # Ack/session/fold events are request-plane (per-kind rings in
    # obs/events.py) so the write storm can no longer evict the early
    # acks the durability certifier replays — a default recorder
    # suffices.
    obs_events.reset("writer")

    victim = rendezvous_order("k0", MEMBERS)[0]
    dead: set = set()
    metrics = Metrics()
    supervisor = {"victim": victim, "kill_t": None, "kill_step": None}

    with tempfile.TemporaryDirectory(prefix="write-tier-") as tmp:
        root = os.path.join(tmp, "fleet")
        obs_dir = os.path.join(tmp, "obs")
        os.makedirs(root)
        print(f"== write tier: {len(MEMBERS)}-worker TCP fleet (WAL + "
              f"ingest), SIGKILL owner {victim} at step "
              f"{kill_at_step} ==", flush=True)
        procs = _spawn_fleet(root, obs_dir, steps, timeout, step_sleep, str(dev), shape, report_dir, hold)
        try:
            addrs = _wait_addrs(root, 60.0)
            for m in MEMBERS:
                if not _wait_step(root, m, 1, 120.0):
                    raise RuntimeError(f"{m} never reached step 1")

            # Warm every worker's write AND read paths (the first fold
            # of the storm's wire shape pays the first kernel loads; the
            # first query pays the serve fold). Concurrently — serial
            # warm-up would eat the workers' 10-step run.
            warm_errs: list = []

            def _warm(wi: int, m: str) -> None:
                ops = [
                    effect_to_wire(
                        ("add", (40 + j // M_KEEP,
                                 1 + j,
                                 (wi % DCS,
                                  900_000 + wi * 100 + j)))
                    )
                    for j in range(IDS_PER_BURST * M_KEEP)
                ]
                for attempt in range(3):
                    try:
                        write_peer(
                            addrs[m],
                            encode({"write_id": f"warm:{m}.{attempt}",
                                    "ops": ops, "ack": "applied",
                                    "type": "topk_rmv"}),
                            timeout=30.0,
                        )
                        query_peer(
                            addrs[m],
                            request_bytes([{"op": "value", "key": 0}]),
                            timeout=30.0)
                        return
                    except Exception as e:  # noqa: BLE001 — gate below
                        if attempt == 2:
                            warm_errs.append(f"{m}: {e}")
                        else:
                            time.sleep(0.5)

            warmers = [
                threading.Thread(target=_warm, args=(i, m), daemon=True)
                for i, m in enumerate(MEMBERS)
            ]
            for t in warmers:
                t.start()
            for t in warmers:
                t.join(90.0)
            if warm_errs:
                raise RuntimeError(
                    f"ingest warm-up failed: {'; '.join(warm_errs)}")

            def verdict(p: str) -> str:
                return "dead" if p in dead else "alive"

            faults.install(ROUTER_FAULTS, seed=7)
            r_read = FleetRouter(
                MEMBERS, tcp_query_fn(addrs), metrics=metrics,
                verdict_fn=verdict, hedge=False, timeout_s=1.0,
                retries=2, backoff_base_s=0.02, session_wait_s=3.5,
                session_poll_s=0.05, poll_s=0.002, seed=1,
                breaker_failures=6,
            )

            n_load0 = len(obs_events.events())
            stop = threading.Event()
            ts_lock = threading.Lock()
            ts_cell = [0]  # distinct client (dc, ts) stamps: join dedups
            stats = [
                {"lat": [], "ok_t": [], "acked": 0, "levels": {},
                 "downgrades": 0, "victim_hard": 0, "shed": 0,
                 "unavailable": 0, "ryw_ok": 0, "ryw_unsat": 0,
                 "ryw_shed": 0, "ryw_other": 0, "results": 0,
                 "raw": 0, "shipped": 0, "err_samples": []}
                for _ in range(WRITERS)
            ]

            def writer(ci: int) -> None:
                rng = random.Random(200 + ci)
                sess = ClientSession(f"demo-w{ci}")
                wrouter = WriteRouter(
                    MEMBERS, tcp_write_fn(addrs), member=f"c{ci}",
                    metrics=metrics, verdict_fn=verdict, timeout_s=10.0,
                    retries=2, backoff_base_s=0.02,
                    replication_wait_s=6.0, probe_timeout_s=1.0,
                    poll_s=0.002, seed=ci,
                    # Injected attempt drops would open the default
                    # 3-failure breaker on chaos alone mid-storm.
                    breaker_failures=6,
                )
                ack = ACK_REPLICATED if ci == WRITERS - 1 else ACK_DURABLE
                ws = WriteSession(
                    wrouter, "topk_rmv", session=sess,
                    session_id=f"demo-w{ci}", batch_max=999, ack=ack,
                    k=2, m_keep=M_KEEP, metrics=metrics, device=dev,
                )
                st = stats[ci]
                n_burst = 0
                while not stop.is_set():
                    # One burst = one key = ONE range frame on the wire:
                    # 4 adds per id, top-2 survive compaction — a steady
                    # 2.0 coalesce ratio and a single wire shape. The
                    # FIRST burst always targets "k0" — the victim is
                    # chosen as k0's partition owner, so the
                    # victim_acked_hard_writes claim cannot starve on an
                    # unlucky key draw before the SIGKILL lands.
                    key = "k0" if n_burst == 0 else f"k{rng.randrange(6)}"
                    n_burst += 1
                    for id_ in rng.sample(range(40), IDS_PER_BURST):
                        for _ in range(ADDS_PER_ID):
                            with ts_lock:
                                ts_cell[0] += 1
                                ts = 1_000_000 + ts_cell[0]
                            ws.stage(key, (
                                "add",
                                (id_, rng.randrange(1, 1000),
                                 (ci % DCS, ts)),
                            ))
                    t0 = time.monotonic()
                    results = ws.flush()
                    dt = time.monotonic() - t0
                    for out in results:
                        st["results"] += 1
                        st["lat"].append(dt)
                        st["raw"] += int(out.get("raw_ops", 0))
                        st["shipped"] += int(out.get("shipped_ops", 0))
                        if out.get("error") is None:
                            st["ok_t"].append(time.monotonic())
                            st["acked"] += 1
                            lvl = str(out.get("level"))
                            st["levels"][lvl] = (
                                st["levels"].get(lvl, 0) + 1)
                            req = out.get("requested")
                            if req and req != lvl:
                                st["downgrades"] += 1
                            if (out.get("origin") == victim
                                    and lvl in HARD_LEVELS):
                                st["victim_hard"] += 1
                            # Cross-tier read-your-writes: the ack
                            # taught `sess` its (origin, seq); a READ
                            # through the read tier must cover it (or
                            # refuse honestly once the origin is dead
                            # and no survivor cursor reaches it yet).
                            rd = r_read.query(
                                [{"op": "value", "key": 0}],
                                key=out["key"],
                                max_staleness_s=MAX_STALENESS_S,
                                session=sess,
                            )
                            if "peer" in rd and "error" not in rd:
                                st["ryw_ok"] += 1
                            elif (rd.get("error")
                                    == "session_unsatisfiable"):
                                st["ryw_unsat"] += 1
                            elif rd.get("error") == "overloaded":
                                st["ryw_shed"] += 1
                                time.sleep(min(
                                    rd.get("retry_after_ms", 50),
                                    500) / 1e3)
                            else:
                                st["ryw_other"] += 1
                        elif out.get("error") == "overloaded":
                            # Honest shed: back off by the hint.
                            st["shed"] += 1
                            time.sleep(min(
                                out.get("retry_after_ms", 50),
                                500) / 1e3)
                        else:
                            st["unavailable"] += 1
                            if len(st["err_samples"]) < 3:
                                st["err_samples"].append(
                                    str(out.get("detail"))[:200])

            threads = [
                threading.Thread(target=writer, args=(i,), daemon=True)
                for i in range(WRITERS)
            ]
            t_load0 = time.monotonic()
            supervisor["storm_t0"] = time.time()
            print("   storm start: steps "
                  + " ".join(f"{m}={_step_of(root, m)}" for m in MEMBERS)
                  + " alive "
                  + " ".join(m for m, p in procs.items()
                             if p.poll() is None), flush=True)
            for t in threads:
                t.start()

            # Stage the kill mid-load: the hot key's HRW owner dies.
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

            # Keep the storm running through failover, but stop the
            # writers a couple of steps BEFORE the survivors' final
            # step: a write parked after the last drain would time out
            # as an honest `unavailable`, which this gate forbids.
            survivor = next(m for m in MEMBERS if m != victim)
            deadline = time.time() + 150.0
            stop_at = max(2, steps - 3)
            while time.time() < deadline:
                if _step_of(root, survivor) >= stop_at:
                    break
                time.sleep(0.25)
            if t_kill is not None:  # ensure a post-kill observation window
                time.sleep(max(0.0, 2.0 - (time.monotonic() - t_kill)))
            print("   storm stop: steps "
                  + " ".join(f"{m}={_step_of(root, m)}" for m in MEMBERS)
                  + " alive "
                  + " ".join(m for m, p in procs.items()
                             if p.poll() is None), flush=True)
            stop.set()
            for t in threads:
                t.join(HARD_LATENCY_CEILING_S + 10.0)
            t_load = time.monotonic() - t_load0
            supervisor["storm_t1"] = time.time()
            if report_dir:  # the storm is over: what runs now reads no clock of the gates
                _write_json(os.path.join(report_dir, "supervisor.json"), supervisor)
            hung_threads = [t for t in threads if t.is_alive()]
            n_load1 = len(obs_events.events())
            write_faults = [
                e for e in faults.trace() if e[0] == "router.write"]
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
            acked = sum(st["acked"] for st in stats)
            results_n = sum(st["results"] for st in stats)
            levels: dict = {}
            for st in stats:
                for lvl, n in st["levels"].items():
                    levels[lvl] = levels.get(lvl, 0) + n
            agg = {
                k: sum(st[k] for st in stats)
                for k in ("downgrades", "victim_hard", "shed",
                          "unavailable", "ryw_ok", "ryw_unsat",
                          "ryw_shed", "ryw_other")
            }
            p99_ms = (lat[int(0.99 * (len(lat) - 1))] * 1e3) if lat else None
            max_ms = (lat[-1] * 1e3) if lat else None
            writes_per_sec = acked / max(t_load, 1e-9)
            raw_ops = sum(st["raw"] for st in stats)
            shipped_ops = sum(st["shipped"] for st in stats)
            coalesce = raw_ops / shipped_ops if shipped_ops else 1.0

            # Failover blip: the longest gap between consecutive acked
            # writes in the window around the kill.
            blip_ms = 0.0
            if t_kill is not None and ok_t:
                window = [t_kill - 0.5] + [
                    t for t in ok_t
                    if t_kill - 0.5 <= t <= t_kill + 6.0
                ]
                gaps = [b - a for a, b in zip(window, window[1:])]
                blip_ms = max(gaps) * 1e3 if gaps else (
                    6.5e3)  # no acks in the window at all
            counters = {
                k: int(v)
                for k, v in metrics.snapshot()["counters"].items()
                if k.startswith("router.write")
                or k.startswith("write_session.")
            }
            # -- certify the clean arm, then the negative controls ---------
            clean_evs = obs_events.events()[n_load0:n_load1]
            merged = obs_events.scan_dir(obs_dir)
            merged["client-writes"] = clean_evs
            wcert = certify_writes(
                logs=merged,
                meta={"arm": "honest", "drill": "write_tier_demo",
                      "killed": victim},
            )
            scert = certify_sessions(
                logs={"writer": clean_evs},
                meta={"arm": "cross-tier-ryw",
                      "drill": "write_tier_demo"},
            )
            shed_out, shed_dt_s, shed_returns = _shed_arm()
            bad_cert, bad_outs, unsafe_acks = _violating_arm()
            cx = (bad_cert.get("counterexample") or {}).get(
                "acked_but_lost") or []

            checks = {
                "zero_hung_writes": not hung_threads
                and (max_ms is None
                     or max_ms <= HARD_LATENCY_CEILING_S * 1e3),
                "zero_unavailable": agg["unavailable"] == 0,
                "zero_silent_drops": results_n == len(lat)
                and acked + agg["shed"] + agg["unavailable"] == results_n,
                "writes_ge_min": acked >= min_writes,
                "write_p99_under_slo": p99_ms is not None
                and p99_ms <= max_p99_ms,
                "failover_blip_bounded": blip_ms <= max_blip_ms,
                "hard_ack_levels_exercised":
                    levels.get("durable", 0) > 0
                    and levels.get("replicated_to_k", 0) > 0,
                "victim_acked_hard_writes": agg["victim_hard"] > 0,
                # 4 adds per id, top-2 kept: the steady-state ratio is
                # 2.0; 1.5 tolerates a partial first/last burst.
                "coalesce_ratio_ge": raw_ops > 0 and coalesce >= 1.5,
                "ryw_reads_verified": agg["ryw_ok"] > 0
                and agg["ryw_other"] == 0,
                "retry_hints_honest":
                    shed_out.get("error") == "overloaded"
                    and int(shed_out.get("retry_after_ms", -1)) == 350
                    and shed_dt_s < 5.0 and shed_returns >= 1,
                "write_counters_lit": all(
                    counters.get(k, 0) > 0
                    for k in WRITE_REQUIRED_NONZERO
                ),
                "router_write_faults_fired": len(write_faults) > 0,
                "survivors_converged": converged,
                "writes_certified": bool(wcert.get("ok"))
                and verify_certificate(wcert)
                and wcert.get("n_acks", 0) > 0
                and not (wcert.get("counterexample") or {}).get(
                    "acked_but_lost"),
                "sessions_certified": bool(scert.get("ok"))
                and verify_certificate(scert)
                and scert.get("n_writes", 0) > 0
                and scert.get("n_reads", 0) > 0
                and scert.get("n_violations", 0) == 0,
                "violating_arm_caught": bad_cert.get("ok") is False
                and verify_certificate(bad_cert)
                and all(o.get("level") == "durable" for o in bad_outs)
                and unsafe_acks >= len(bad_outs)
                and any(
                    e.get("origin") == "v0"
                    and e.get("uncovered") == [8, 20]
                    and e.get("lost_write_ids")
                    for e in cx
                ),
            }
            report = {
                "drill": "write_tier_demo",
                "fleet": MEMBERS,
                "killed": victim,
                "writers": WRITERS,
                "load_s": round(t_load, 3),
                "fleet_writes_per_sec": round(writes_per_sec, 3),
                "fleet_ops_per_sec": round(
                    raw_ops / max(t_load, 1e-9), 1),
                "write_p99_ms": None if p99_ms is None
                else round(p99_ms, 3),
                "write_max_ms": None if max_ms is None
                else round(max_ms, 3),
                "failover_blip_ms": round(blip_ms, 3),
                "writes_acked": acked,
                "acks_by_level": dict(sorted(levels.items())),
                "raw_ops": raw_ops,
                "shipped_ops": shipped_ops,
                "coalesce_ratio": round(coalesce, 3),
                "error_samples": [
                    s for st in stats for s in st["err_samples"]][:6],
                "outcomes": agg,
                "write_faults_fired": len(write_faults),
                "counters": dict(sorted(counters.items())),
                "write_certificate": {
                    "ok": wcert.get("ok"),
                    "n_acks": wcert.get("n_acks"),
                    "acks_by_level": wcert.get("acks_by_level"),
                    "origins": wcert.get("origins"),
                },
                "session_certificate": {
                    "ok": scert.get("ok"),
                    "n_sessions": scert.get("n_sessions"),
                    "n_reads": scert.get("n_reads"),
                    "n_writes": scert.get("n_writes"),
                    "n_violations": scert.get("n_violations"),
                },
                "shed_arm": {
                    "error": shed_out.get("error"),
                    "retry_after_ms": shed_out.get("retry_after_ms"),
                    "elapsed_s": round(shed_dt_s, 4),
                },
                "violating_arm": {
                    "ok": bad_cert.get("ok"),
                    "unsafe_acks": unsafe_acks,
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
    ap.add_argument("--out", default="WRITETIER_torch_r01.json",
                    help="the report (default: WRITETIER_torch_r01.json in the current directory)")
    ap.add_argument("--timeout", type=float, default=0.5,
                    help="worker SWIM timeout")
    ap.add_argument("--step-sleep", type=float, default=1.0)
    ap.add_argument("--steps", type=int, default=24,
                    help="per-worker step count: startup + warm-up eat "
                    "the first ~6 steps on a contended host, and the "
                    "storm needs a pre-kill AND a post-kill window")
    ap.add_argument("--kill-at-step", type=int, default=13)
    ap.add_argument("--min-writes", type=float, default=6.0,
                    help="minimum acked write bursts across the storm")
    ap.add_argument("--max-p99-ms", type=float, default=15000.0)
    ap.add_argument("--max-blip-ms", type=float, default=15000.0)
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
            steps=args.steps, kill_at_step=args.kill_at_step, timeout=args.timeout, step_sleep=args.step_sleep,
            min_writes=args.min_writes, max_p99_ms=args.max_p99_ms, max_blip_ms=args.max_blip_ms,
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
    p99_ms, blip_ms = report["write_p99_ms"], report["failover_blip_ms"]
    print(
        f"PASS: {report['writes_acked']} write bursts acked "
        f"({report['raw_ops']} staged ops) across {report['killed']}'s SIGKILL "
        f"(p99 {p99_ms:.0f}ms, blip {blip_ms:.0f}ms); "
        f"zero acked-but-lost certified, violating arm "
        f"convicted, sheds honest"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
