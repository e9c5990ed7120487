"""Span-tracing demo/gate: a real 3-worker TCP fleet on one timeline.

`make spans-demo` runs this. It spawns three `net_gossip_demo` workers
(real localhost sockets, delta gossip, WAL armed) with the span plane on
(``CCRDT_SPANS=1`` + ``CCRDT_OBS_DIR``), NTP-probes each worker's clock
over the in-band ``{metrics_req, T1}`` frame while the fleet is alive,
and after the workers exit:

1. merges every worker's span spill into ONE Perfetto/Chrome trace-event
   JSON via `scripts/ccrdt_spans.py merge` — three processes, one
   clock-aligned timeline (the artifact path is printed; load it in
   ui.perfetto.dev);
2. prints the dispatch-gap attribution report (`ccrdt_spans.py
   attribute`);
3. FAILS (exit 1) unless: every worker recorded `round.e2e` rounds, all
   nine load-bearing phases (`obs.spans.PHASES`) are lit somewhere in
   the fleet, at least one cross-worker clock offset was captured (the
   alignment is real, not a fallback), and the phases' serial union
   explains at least ``MIN_COVERAGE`` of the measured round wall time —
   the "attribution sums reconcile against e2e" acceptance.

This is the span plane's end-to-end proof, the analogue of what
`make obs-demo` is for the flight recorder.

Port of ``scripts/spans_demo.py``: the same fleet, gates, printed text and
exit codes, over this package's ``net_gossip_demo`` workers, ``net/tcp.py``
probe and ``ccrdt_spans``::

    python -m antidote_ccrdt_tpu_torch.scripts.spans_demo [--device cpu|cuda] [--report-dir DIR]

``--device`` (default: the card; without one it raises) is every worker's
device; ``--report-dir DIR`` has each worker write its ``--report``
(timings, kernel launches) there as ``report-<member>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import spans as obs_spans  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"
SPANS_CLI = ["-m", "antidote_ccrdt_tpu_torch.scripts.ccrdt_spans"]
MEMBERS = ("w0", "w1", "w2")

# Fleet-p50 fraction of round.e2e wall the serial phase union must
# explain. The TCP drill's rounds carry real untraced slack (SWIM
# bookkeeping, status drops, scheduler noise between phases), so this is
# looser than chaos_gate's in-process drill — but low coverage still
# means the load-bearing spans went dark.
MIN_COVERAGE = 0.5


def _gossip_addrs(root: str) -> Dict[str, Tuple[str, int]]:
    out: Dict[str, Tuple[str, int]] = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for fn in names:
        if not fn.startswith("addr-") or ".tmp" in fn:
            continue
        try:
            with open(os.path.join(root, fn)) as f:
                hostport = f.read().strip().split(" ")[0]
            host, port = hostport.rsplit(":", 1)
            out[fn[len("addr-"):]] = (host, int(port))
        except (OSError, ValueError):
            continue
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="span-tracing demo and gate")
    ap.add_argument("--device", default=None,
                    help="the workers' device, cpu or cuda (default: the "
                    "card; raises without one)")
    ap.add_argument("--report-dir", default="",
                    help="the workers write their --report files here")
    args = ap.parse_args(argv)

    from antidote_ccrdt_tpu_torch.net.tcp import probe_clock
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import resolve_worker_device

    dev = str(resolve_worker_device(args.device))  # the card unless "cpu"; raises without one
    root = tempfile.mkdtemp(prefix="spans-demo-")
    obs_dir = os.path.join(root, "obs")
    trace_out = os.path.join(root, "spans_trace.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_SPANS"] = "1"
    if args.report_dir:
        os.makedirs(args.report_dir, exist_ok=True)
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", WORKER, "--root", root, "--member", m,
             "--n-members", str(len(MEMBERS)), "--delta",
             "--wal-dir", os.path.join(root, "wal"),
             "--step-sleep", "0.2", "--device", dev,
             *(["--report", os.path.join(args.report_dir, f"report-{m}.json")]
               if args.report_dir else [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO,
        )
        for m in MEMBERS
    ]
    # While the fleet runs, take one NTP-style probe per worker from THIS
    # process — the same exchange the workers ride on their hellos,
    # exercised over the operator surface.
    probes: Dict[str, Tuple[float, float]] = {}
    outs: Dict[str, str] = {}
    try:
        while any(p.poll() is None for p in procs):
            for m, addr in sorted(_gossip_addrs(root).items()):
                if m in probes:
                    continue
                try:
                    member, off, rtt = probe_clock(addr, timeout=1.0)
                    probes[member] = (off, rtt)
                except (OSError, ValueError, ConnectionError):
                    continue
            time.sleep(0.2)
    finally:
        for m, p in zip(MEMBERS, procs):
            try:
                out, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs[m] = out
    bad = [m for m, p in zip(MEMBERS, procs) if p.returncode != 0]
    if bad:
        for m in bad:
            print(f"-- worker {m} failed --\n{outs[m][-2000:]}")
        return 1

    print("== NTP probes (operator -> worker, monotonic-clock offset) ==")
    for m, (off, rtt) in sorted(probes.items()):
        print(f"  {m}: offset {off * 1e3:+.3f}ms rtt {rtt * 1e3:.3f}ms")

    print("\n== merged Perfetto trace (scripts/ccrdt_spans.py merge) ==")
    r = subprocess.run(
        [sys.executable, *SPANS_CLI, "merge", obs_dir, "-o", trace_out],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    print(r.stdout, end="")
    if r.returncode != 0:
        print(f"FAIL: merge exited {r.returncode}\n{r.stderr[-2000:]}")
        return 1

    print("\n== dispatch-gap attribution (scripts/ccrdt_spans.py attribute) ==")
    r = subprocess.run(
        [sys.executable, *SPANS_CLI, "attribute", obs_dir],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO,
    )
    print(r.stdout, end="")
    if r.returncode != 0:
        print(f"FAIL: attribute exited {r.returncode}\n{r.stderr[-2000:]}")
        return 1

    # -- acceptance: the plane measured a real fleet, end to end ----------
    by_member = obs_spans.scan_dir(obs_dir)
    att = obs_spans.attribute(by_member)
    with open(trace_out) as f:
        trace = json.load(f)
    n_events = len([
        e for e in trace.get("traceEvents", []) if e.get("ph") == "X"
    ])
    offsets = obs_spans.clock_offsets(by_member)

    missing_members = sorted(set(MEMBERS) - set(att["members"]))
    if missing_members:
        print(f"FAIL: no round.e2e spans from {missing_members}")
        return 1
    lit = set(att["fleet"]["phases_ms_total"])
    dark = sorted(set(obs_spans.PHASES) - lit)
    if dark:
        print(f"FAIL: load-bearing phases recorded no time: {dark}")
        return 1
    if not n_events:
        print("FAIL: merged trace holds no span events")
        return 1
    if not offsets:
        print("FAIL: no cross-worker clock offsets captured — the merged "
              "timeline is NOT aligned (hello/metrics clock echo dark)")
        return 1
    cov = att["fleet"]["coverage_p50"]
    if cov < MIN_COVERAGE:
        print(f"FAIL: phase spans explain only {cov:.1%} of round wall "
              f"(need >= {MIN_COVERAGE:.0%}) — attribution no longer "
              f"reconciles against round.e2e")
        return 1
    print(f"\nOK: {len(att['members'])} workers, "
          f"{att['fleet']['rounds']} rounds, all {len(obs_spans.PHASES)} "
          f"phases lit, {n_events} spans on one aligned timeline "
          f"({sum(len(v) for v in offsets.values())} offset edges), "
          f"coverage {cov:.1%}")
    print(f"perfetto trace: {trace_out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
