"""Live terminal dashboard over a gossip fleet + propagation-path proof.

Two ways to run it:

* **Attach** to a running shared-directory fleet::

      python -m antidote_ccrdt_tpu_torch.scripts.obs_dashboard --root /tmp/gossip-root \
          [--obs-dir $CCRDT_OBS_DIR] [--interval 0.5] [--frames N | --once]

  Each frame shows, per member: heartbeat age and the derived
  ALIVE/SUSPECT/DEAD state, published snapshot step, visible delta
  window, replication lag (ops and seconds, from the worker's own
  ``obs-<member>.json`` status drops), TCP send-queue depths, and the
  WAL durable watermark.

* **Demo** (`make obs-demo`): ``--demo`` spawns a 3-worker
  `net_gossip_demo` TCP fleet in delta mode with the full observability
  plane enabled (``CCRDT_OBS_DIR`` + ``CCRDT_METRICS_DIR`` +
  ``CCRDT_HTTP_PORT=0`` + ``CCRDT_PROFILE=1`` + ``CCRDT_SPANS=1``),
  renders live frames while it runs, and — while the workers are still
  alive — scrapes them over BOTH live surfaces (each worker's HTTP
  ``/metrics`` endpoint and the in-band TCP ``{metrics_req}`` frame),
  requiring lag gauges, profile.dispatch histogram buckets, AND
  round-phase span histograms (`obs.spans`' ``span.round.*`` latency
  mirror) in the response. After the fleet
  exits it prints the merged Prometheus snapshot, RECONSTRUCTS one
  delta's end-to-end propagation path (publish -> medium write/send ->
  apply on every peer) from the flight logs, and smoke-runs the trace
  CLI (``ccrdt_trace.py summary --require-complete`` + ``path``) over
  the same spill dir — exiting nonzero if any check fails.

Port of ``scripts/obs_dashboard.py``: the same frames, checks, printed text
and exit codes. ``--demo`` starts this package's ``net_gossip_demo`` workers
and runs this package's ``ccrdt_trace``. Options of the port only, for
``--demo``: ``--device`` (cpu or cuda; default: the card, and without one it
raises) is every worker's device, and ``--report-dir DIR`` has each worker
write its ``--report`` (timings, kernel launches) there as
``report-<member>.json``. Attaching to a fleet touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import events as obs_events  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"

# SWIM-ish thresholds for the fs medium (display only — workers make
# their own liveness calls; these just color the dashboard).
SUSPECT_S = 0.4
DEAD_S = 0.8


# -- fs-medium scraping ------------------------------------------------------


def hb_age(root: str, member: str) -> Optional[float]:
    """Seconds since `member`'s heartbeat (FsTransport timestamp payload,
    mtime fallback) — same read the transport itself performs."""
    p = os.path.join(root, f"hb-{member}")
    try:
        with open(p, "rb") as f:
            payload = f.read(8)
        if len(payload) == 8:
            return time.time() - struct.unpack("<d", payload)[0]
        return time.time() - os.path.getmtime(p)
    except OSError:
        return None


def scrape_root(root: str) -> Dict[str, Dict[str, Any]]:
    """One pass over the shared gossip dir -> {member: row}."""
    rows: Dict[str, Dict[str, Any]] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return rows

    def row(m: str) -> Dict[str, Any]:
        return rows.setdefault(m, {"snap": None, "deltas": []})

    for fn in names:
        if ".tmp" in fn:
            continue
        if fn.startswith("hb-"):
            row(fn[3:])
        elif fn.startswith("snap-"):
            m = fn[5:]
            try:
                with open(os.path.join(root, fn), "rb") as f:
                    hdr = f.read(8)
                if len(hdr) == 8:
                    row(m)["snap"] = struct.unpack("<Q", hdr)[0]
            except OSError:
                pass
        elif fn.startswith("delta-"):
            m, _, seq = fn[len("delta-"):].rpartition("-")
            try:
                row(m)["deltas"].append(int(seq))
            except ValueError:
                pass
        elif fn.startswith("obs-") and fn.endswith(".json"):
            try:
                with open(os.path.join(root, fn)) as f:
                    row(fn[4:-5])["status"] = json.load(f)
            except (OSError, ValueError):
                pass
    for m, r in rows.items():
        age = hb_age(root, m)
        r["hb_age"] = age
        r["state"] = (
            "?" if age is None
            else "alive" if age <= SUSPECT_S
            else "suspect" if age <= DEAD_S
            else "dead"
        )
        r["deltas"].sort()
    return rows


# -- rendering ---------------------------------------------------------------


def _fmt_lag(status: Optional[Dict[str, Any]]) -> str:
    if not status or not status.get("lag"):
        return "-"
    return " ".join(
        f"{p}:{r['lag_ops']}/{r['lag_s']:.2f}s"
        for p, r in sorted(status["lag"].items())
    )


def _fmt_wal(status: Optional[Dict[str, Any]]) -> str:
    """WAL column group: durability mode, appended vs durable watermark,
    and the exposure lag between them (PR 11 group/async commit — a
    nonzero lag in async mode is the published-before-fsync window the
    certifier audits; in group mode it is at most one staged batch)."""
    st = status or {}
    last = st.get("wal_last_seq")
    if last is None:
        return "-"
    mode = str(st.get("wal_durability") or "?")[:1]  # s/g/a
    durable = st.get("wal_durable_seq")
    lag = st.get("wal_durability_lag")
    out = f"{mode}:{int(last)}"
    if durable is not None:
        out += f"/{int(durable)}"
    if lag:
        out += f" +{int(lag)}"
    return out


def _fmt_sendq(status: Optional[Dict[str, Any]]) -> str:
    q = (status or {}).get("sendq") or {}
    if not q:
        return "-"
    return " ".join(f"{p}:{int(v)}" for p, v in sorted(q.items()))


# QPS needs a rate, and status drops carry cumulative counters — so the
# renderer keeps the previous frame's (time, serve.queries) per member.
# Module state, same lifetime as the watch loop that calls render_frame.
_SERVE_PREV: Dict[str, Any] = {}


def _fmt_serve(status: Optional[Dict[str, Any]], member: str) -> str:
    """Serving column group: query rate since the previous frame, cache
    hit rate, client-visible read p99, and the p99 of the advertised
    staleness bounds — all from the worker's serve.* metrics."""
    sv = (status or {}).get("serve") or {}
    if not sv:
        return "-"
    now = time.time()
    q = float(sv.get("queries", 0))
    prev = _SERVE_PREV.get(member)
    _SERVE_PREV[member] = (now, q)
    qps = "-"
    if prev and now > prev[0]:
        qps = f"{max(0.0, (q - prev[1]) / (now - prev[0])):,.0f}"
    hits = float(sv.get("cache_hits", 0))
    misses = float(sv.get("cache_misses", 0))
    hit = f"{hits / (hits + misses):.0%}" if hits + misses else "-"
    p99 = sv.get("read_p99_ms")
    sp99 = sv.get("staleness_p99_s")
    return (
        f"q/s {qps} hit {hit} "
        f"p99 {'-' if p99 is None else format(p99, '.1f') + 'ms'} "
        f"stale99 {'-' if sp99 is None else format(sp99 * 1e3, '.1f') + 'ms'}"
    )


def _fmt_pager(status: Optional[Dict[str, Any]]) -> str:
    """Pager column group (out-of-core residency, core/pager.py):
    resident/total partitions, resident item bytes, and the page-in hit
    rate — from the worker's pager block (pager.status_fields()). "-"
    means paging is off (all-resident legacy)."""
    pg = (status or {}).get("pager") or {}
    if not pg:
        return "-"
    res = int(pg.get("resident_parts", 0))
    tot = int(pg.get("total_parts", 0))
    nbytes = float(pg.get("resident_bytes", 0))
    hit = pg.get("hit_rate")
    unit = "b"
    for u in ("k", "m", "g"):
        if nbytes < 1024:
            break
        nbytes /= 1024.0
        unit = u
    out = f"r:{res}/{tot} {nbytes:.0f}{unit}"
    if hit is not None:
        out += f" hit {float(hit):.0%}"
    return out


def _fmt_audit(status: Optional[Dict[str, Any]]) -> str:
    """Audit column group: divergence-watchdog verdict, how long the
    worst divergence has been open, and the time-to-agreement p50 — from
    the watchdog block elastic_demo's status drops carry (fed by the
    audit.* gauges every scrape surface also exports)."""
    au = (status or {}).get("audit") or {}
    if not au:
        return "-"
    state = str(au.get("state", "?"))
    age = au.get("age_s")
    tta = au.get("tta_p50_ms")
    cert = au.get("cert_ok")
    out = (
        f"{state} age {'-' if age is None else format(age, '.1f') + 's'} "
        f"tta50 {'-' if tta is None else format(tta, '.0f') + 'ms'}"
    )
    if cert is not None:
        out += f" cert {'ok' if cert else 'FAIL'}"
    return out


# Same rate trick as _SERVE_PREV: the router's status drop carries
# cumulative counters, so the renderer keeps the previous frame's
# (time, router.queries) per member to show a routed-QPS rate.
_ROUTER_PREV: Dict[str, Any] = {}


def _fmt_router(status: Optional[Dict[str, Any]], member: str) -> str:
    """Router column group (serve/router.py, from the obs-router.json
    drop read_tier_demo publishes): routed query rate, per-peer breaker
    state (only non-closed peers are listed — "ok" means every breaker
    is closed), failovers, hedge rate, and session waits. "-" means no
    router is publishing into this obs dir."""
    rt = (status or {}).get("router") or {}
    c = rt.get("counters") or {}
    if not c:
        return "-"
    now = time.time()
    q = float(c.get("router.queries", 0))
    prev = _ROUTER_PREV.get(member)
    _ROUTER_PREV[member] = (now, q)
    qps = "-"
    if prev and now > prev[0]:
        qps = f"{max(0.0, (q - prev[1]) / (now - prev[0])):,.0f}"
    brs = rt.get("breakers") or {}
    tripped = " ".join(
        f"{p}:{str(s)[:4]}" for p, s in sorted(brs.items()) if s != "closed"
    )
    hedges = float(c.get("router.hedges", 0))
    hrate = f"{hedges / q:.0%}" if q else "-"
    return (
        f"q/s {qps} br {tripped or 'ok'} "
        f"fo {int(c.get('router.failovers', 0))} hdg {hrate} "
        f"sw {int(c.get('router.session_waits', 0))}"
    )


def _fmt_rtrace(status: Optional[Dict[str, Any]]) -> str:
    """Request-tracing column group (obs/rtrace.py): traces minted /
    committed this process, forced commits (shed / failed / deadline —
    always stored regardless of sampling), and degraded traces (the
    ``rtrace.record`` fault point fired — tracing dropped out, the
    request itself survived). "-" means the plane is dark (CCRDT_RTRACE
    unset/0) or this process routes nothing."""
    rt = (status or {}).get("rtrace") or {}
    if not rt:
        return "-"
    out = (
        f"mint {int(rt.get('minted', 0))} "
        f"com {int(rt.get('committed', 0))} "
        f"fc {int(rt.get('forced', 0))}"
    )
    deg = int(rt.get("degraded", 0))
    if deg:
        out += f" DEG {deg}"
    return out


def _fmt_devprof(status: Optional[Dict[str, Any]]) -> str:
    """Device-observatory column group (obs/devprof.py): recompiles
    over the trailing minute, the worst churn site (basename'd to keep
    the column narrow), and pager HBM occupancy vs budget. "-" means
    the plane is dark (CCRDT_DEVPROF=0) or no status dump yet."""
    dv = (status or {}).get("devprof") or {}
    if not dv:
        return "-"
    worst = str(dv.get("worst_site") or "-")
    if "." in worst:
        worst = worst.rsplit(".", 1)[-1]
    out = (
        f"rc/m {dv.get('recompiles_per_min', 0):.0f} "
        f"{worst}:{int(dv.get('worst_site_compiles', 0))}"
    )
    occ = dv.get("hbm_occupancy")
    if isinstance(occ, (int, float)) and occ > 0:
        out += f" hbm {occ:.0%}"
    return out


def render_frame(root: str, clear: bool = True) -> str:
    rows = scrape_root(root)
    lines = []
    if clear:
        lines.append("\x1b[2J\x1b[H")
    lines.append(f"== ccrdt gossip dashboard  root={root}  t={time.time():.2f}")
    hdr = (
        f"{'member':<10}{'zone':<6}{'hb-age':>8} {'state':<9}{'snap':>5} "
        f"{'delta-window':<14}{'wal m:last/dur':>14}  {'sendq':<16}"
        f"{'lag (peer:ops/secs)':<26}  {'serving':<34}  "
        f"{'pager':<18}  {'audit':<32}  {'router':<42}  {'rtrace':<24}  "
        f"{'devprof'}"
    )
    lines.append(hdr)
    lines.append("-" * len(hdr))

    def zone_of(m: str) -> str:
        return str(((rows[m].get("status") or {}).get("zone")) or "?")

    # Rows grouped by zone (topo/ fleets), members sorted within; a
    # flat fleet is one "?" group with no visible change but the column.
    ordered = sorted(rows, key=lambda m: (zone_of(m), m))
    zones = sorted({zone_of(m) for m in rows})
    multi_zone = len(zones) > 1
    prev_zone = None
    for m in ordered:
        r = rows[m]
        z = zone_of(m)
        if multi_zone and z != prev_zone:
            states = [rows[n]["state"] for n in ordered if zone_of(n) == z]
            tally = " ".join(
                f"{states.count(s)} {s}"
                for s in ("alive", "suspect", "dead", "?")
                if states.count(s)
            )
            lines.append(f"-- zone {z}: {tally}")
            prev_zone = z
        st = r.get("status")
        age = "-" if r["hb_age"] is None else f"{r['hb_age']:.2f}s"
        d = r["deltas"]
        window = f"{d[0]}..{d[-1]}" if d else "-"
        lines.append(
            f"{m:<10}{z:<6}{age:>8} {r['state']:<9}"
            f"{'-' if r['snap'] is None else r['snap']:>5} "
            f"{window:<14}{_fmt_wal(st):>14}  "
            f"{_fmt_sendq(st):<16}{_fmt_lag(st):<26}  "
            f"{_fmt_serve(st, m):<34}  {_fmt_pager(st):<18}  "
            f"{_fmt_audit(st):<32}  {_fmt_router(st, m):<42}  "
            f"{_fmt_rtrace(st):<24}  {_fmt_devprof(st)}"
        )
    return "\n".join(lines)


# -- propagation-path reconstruction ----------------------------------------


def reconstruct_paths(obs_dir: str) -> Dict[str, Any]:
    """Group every traced delta by (origin, dseq) and classify coverage.
    A path is COMPLETE when the delta shows a publish, reached the medium
    (fs write or tcp frame send), and was applied by every OTHER member
    seen in the flight logs."""
    logs = obs_events.scan_dir(obs_dir)
    members = {evs[0]["member"] for evs in logs.values() if evs}
    paths = obs_events.delta_paths(logs)
    out: Dict[str, Any] = {"members": sorted(members), "deltas": {}}
    for (origin, dseq), stages in sorted(paths.items()):
        appliers = sorted({e["member"] for e in stages.get("apply", [])})
        expect = sorted(members - {origin})
        out["deltas"][f"{origin}#{dseq}"] = {
            "origin": origin,
            "dseq": dseq,
            "stages": sorted(stages),
            "appliers": appliers,
            "complete": (
                "publish" in stages
                and ("write" in stages or "send" in stages)
                and bool(expect)
                and appliers == expect
            ),
        }
    return out


def print_path_timeline(obs_dir: str, origin: str, dseq: int) -> None:
    """Human-readable end-to-end timeline for one delta, merged across
    every member's flight log, ordered by wall time."""
    logs = obs_events.scan_dir(obs_dir)
    hops = []
    for evs in logs.values():
        for e in evs:
            if e.get("origin") == origin and e.get("dseq") == dseq:
                hops.append(e)
    hops.sort(key=lambda e: e["t"])
    t0 = hops[0]["t"] if hops else 0.0
    print(f"-- propagation of delta {origin}#{dseq} "
          f"({len(hops)} events) --")
    for e in hops:
        extra = "".join(
            f" {k}={e[k]}" for k in ("peer", "fkind", "bytes") if k in e
        )
        print(
            f"  +{e['t'] - t0:8.4f}s  {e['member']:<8} {e['kind']:<22}{extra}"
        )


# -- demo mode ---------------------------------------------------------------

# What a live scrape must prove (acceptance for `make obs-demo`): lag
# gauges, profile.dispatch histogram buckets, and round-phase span
# histograms (obs/spans.py's metrics mirror), in valid exposition text,
# read from a RUNNING worker.
_LAG_RE = re.compile(r"^ccrdt_lag_\w+(?:\{[^}]*\})? ", re.M)
_BUCKET_RE = re.compile(
    r'^ccrdt_profile_dispatch_\w+_seconds_bucket\{[^}]*le="', re.M
)
_SPAN_RE = re.compile(
    r'^ccrdt_span_round_\w+_seconds_bucket\{[^}]*le="', re.M
)


def _scrape_proves_live(text: str) -> bool:
    return (
        "# TYPE " in text
        and bool(_LAG_RE.search(text))
        and bool(_BUCKET_RE.search(text))
        and bool(_SPAN_RE.search(text))
    )


def _http_metrics(addr, timeout: float = 2.0) -> str:
    import urllib.request

    with urllib.request.urlopen(
        f"http://{addr[0]}:{addr[1]}/metrics", timeout=timeout
    ) as resp:
        return resp.read().decode("utf-8")


def _gossip_addrs(root: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for fn in names:
        if not fn.startswith("addr-") or ".tmp" in fn:
            continue
        try:
            with open(os.path.join(root, fn)) as f:
                host, port = f.read().strip().rsplit(":", 1)
            out[fn[len("addr-"):]] = (host, int(port))
        except (OSError, ValueError):
            continue
    return out


def run_demo(frames_interval: float = 0.5, device: Optional[str] = None,
             report_dir: str = "") -> int:
    """Spawn a 3-worker TCP gossip fleet on `device` with the full obs
    plane on (flight recorder, metrics dumps, live HTTP endpoints,
    profiler), scrape it over BOTH surfaces while it runs, then verify the
    flight logs with the trace CLI. Returns the process exit code."""
    from antidote_ccrdt_tpu_torch.obs import export as obs_export
    from antidote_ccrdt_tpu_torch.obs import http as obs_http
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import resolve_worker_device

    dev = str(resolve_worker_device(device))  # the card unless "cpu"; raises without one
    root = tempfile.mkdtemp(prefix="obs-demo-")
    obs_dir = os.path.join(root, "obs")
    metrics_dir = os.path.join(root, "metrics")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_METRICS_DIR"] = metrics_dir
    env["CCRDT_HTTP_PORT"] = "0"  # every worker serves /metrics (any port)
    env["CCRDT_PROFILE"] = "1"  # arm the XLA hot-path profiler
    env["CCRDT_SPANS"] = "1"  # arm round-phase span tracing (obs/spans.py)
    members = ["w0", "w1", "w2"]
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", WORKER, "--root", root, "--member", m,
             "--n-members", str(len(members)), "--delta",
             "--step-sleep", "0.25", "--device", dev,
             *(["--report", os.path.join(report_dir, f"report-{m}.json")]
               if report_dir else [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO,
        )
        for m in members
    ]
    http_live: Optional[tuple] = None  # (member, text) while fleet ran
    tcp_live: Optional[tuple] = None
    last_frame = 0.0
    try:
        while any(p.poll() is None for p in procs):
            if time.time() - last_frame >= frames_interval:
                print(render_frame(root))
                last_frame = time.time()
            if http_live is None:
                for m, addr in sorted(obs_http.read_addr_files(root).items()):
                    try:
                        text = _http_metrics(addr)
                    except OSError:
                        continue
                    if _scrape_proves_live(text):
                        http_live = (m, text)
                        break
            if tcp_live is None:
                from antidote_ccrdt_tpu_torch.net.tcp import scrape_metrics

                for m, addr in sorted(_gossip_addrs(root).items()):
                    try:
                        member, text = scrape_metrics(addr, timeout=2.0)
                    except (OSError, ValueError):
                        continue
                    if _scrape_proves_live(text):
                        tcp_live = (member, text)
                        break
            time.sleep(0.2)
    finally:
        outs = {}
        for m, p in zip(members, procs):
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs[m] = out
    print(render_frame(root, clear=False))
    bad = [m for m, p in zip(members, procs) if p.returncode != 0]
    if bad:
        for m in bad:
            print(f"-- worker {m} failed --\n{outs[m][-2000:]}")
        return 1

    print("\n== live scrapes (taken while the fleet was running) ==")
    for label, got in (("HTTP /metrics", http_live),
                       ("in-band TCP {metrics_req}", tcp_live)):
        if got is None:
            print(f"FAIL: no {label} scrape with lag gauges + "
                  "profile.dispatch buckets + round-phase span buckets "
                  "succeeded while the fleet ran")
            return 1
        m, text = got
        keep = [ln for ln in text.splitlines()
                if _LAG_RE.match(ln) or _BUCKET_RE.match(ln)
                or _SPAN_RE.match(ln)]
        print(f"[{label}] worker {m}: {len(text.splitlines())} lines, "
              f"proof series:")
        for ln in keep[:6]:
            print(f"    {ln}")

    print("\n== fleet-merged Prometheus snapshot (exit dumps) ==")
    merged, dumped = obs_export.merge_dir(metrics_dir)
    print(obs_export.prometheus_text(merged), end="")
    print(f"# merged from: {sorted(dumped)}")

    print("\n== delta propagation paths (from flight logs) ==")
    rec = reconstruct_paths(obs_dir)
    complete = [d for d in rec["deltas"].values() if d["complete"]]
    for key, d in rec["deltas"].items():
        mark = "OK " if d["complete"] else "..."
        print(f"  [{mark}] {key}: stages={d['stages']} "
              f"applied-by={d['appliers']}")
    if not complete:
        print("FAIL: no delta shows a complete publish->medium->apply-"
              "on-every-peer path")
        return 1
    pick = complete[0]
    print()
    print_path_timeline(obs_dir, pick["origin"], pick["dseq"])

    print("\n== trace CLI (scripts/ccrdt_trace.py) ==")
    trace_cli = ["-m", "antidote_ccrdt_tpu_torch.scripts.ccrdt_trace"]
    for cmd in (
        [sys.executable, *trace_cli, "summary", obs_dir, "--require-complete"],
        [sys.executable, *trace_cli, "path", obs_dir,
         str(pick["origin"]), str(pick["dseq"])],
    ):
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                           env=env, cwd=REPO)
        print(r.stdout, end="")
        if r.returncode != 0:
            print(f"FAIL: {' '.join(cmd[2:])} exited {r.returncode}\n"
                  f"{r.stderr[-2000:]}")
            return 1

    print(f"\nOK: {len(complete)}/{len(rec['deltas'])} traced deltas fully "
          f"propagated across {rec['members']}; live HTTP + in-band TCP "
          "scrapes carried lag gauges, profile.dispatch histograms, and "
          "round-phase span histograms")
    return 0


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", help="shared gossip dir of a running fleet")
    ap.add_argument("--obs-dir", default=os.environ.get(obs_events.ENV_DIR),
                    help="flight-log spill dir (for path reconstruction)")
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="render a single frame without clearing and exit")
    ap.add_argument("--demo", action="store_true",
                    help="spawn a 3-worker fleet and run the full check")
    ap.add_argument("--device", default=None,
                    help="--demo: the workers' device, cpu or cuda (default: "
                    "the card; raises without one)")
    ap.add_argument("--report-dir", default="",
                    help="--demo: the workers write their --report files here")
    args = ap.parse_args(argv)

    if args.demo:
        sys.exit(run_demo(frames_interval=args.interval, device=args.device,
                          report_dir=args.report_dir))
    if not args.root:
        ap.error("--root is required unless --demo")
    if args.once:
        print(render_frame(args.root, clear=False))
        return
    n = 0
    try:
        while args.frames <= 0 or n < args.frames:
            print(render_frame(args.root, clear=n > 0))
            n += 1
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    if args.obs_dir:
        rec = reconstruct_paths(args.obs_dir)
        print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
