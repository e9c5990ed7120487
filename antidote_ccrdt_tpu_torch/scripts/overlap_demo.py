"""Overlap demo/gate: the round pipeline's perf claim, on a real fleet.

``make overlap-demo`` runs this. It launches the same 3-worker TCP
gossip fleet (`scripts/net_gossip_demo.py`: real localhost sockets,
chained-delta gossip, WAL armed, publish every step) TWICE — once with
the serial round loop forced (``CCRDT_OVERLAP=0``) and once with the
overlapped pipeline (``CCRDT_OVERLAP=1``, `parallel/overlap.py`) — with
the span plane on in both runs, and after the workers exit:

1. prints both runs' dispatch-gap attribution
   (`obs.spans.attribute`) side by side — serial mode shows
   wal_append/delta_encode/gossip on the round thread, overlap mode
   shows the same phases re-threaded onto the pipeline;
2. FAILS (exit 1) unless
   - every worker in BOTH runs converged to the same digest — overlap
     on/off must be bit-identical (the pipeline changes scheduling,
     never values), and that digest is the sequential reference;
   - the overlap run's fleet-p50 ``round.e2e`` is at least
     ``MIN_REDUCTION`` below the serial run's — the PR's headline: host
     phases off the round thread must actually shorten the round;
   - the overlap run billed its own counters (``overlap.host_tasks``,
     ``overlap.windows`` in the workers' final metrics) — the speedup
     must come from the pipeline, not from a silent serial fallback.

This is the pipeline's end-to-end proof on real sockets, the analogue
of what `make spans-demo` is for the span plane; the sim-chaos and
bit-identity unit legs live in tests/test_overlap.py.

Port of ``scripts/overlap_demo.py``: the same two fleets, gates, printed
text and exit codes, over this package's ``net_gossip_demo`` workers, with
this package's ``elastic_demo.reference_digest`` (on the workers' device)
as the reference::

    python -m antidote_ccrdt_tpu_torch.scripts.overlap_demo [--device cpu|cuda] [--report-dir DIR]

``--device`` (default: the card; without one it raises) is every worker's
device; ``--report-dir DIR`` has each worker write its ``--report``
(timings, kernel launches) there as ``report-<arm>-<member>.json``.
`run_arms` and `check_convergence` are the fleets and the digest and
counter gates without the timing bar.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional, Tuple

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import spans as obs_spans  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"
MEMBERS = ("w0", "w1", "w2")

# Required fleet-p50 round.e2e reduction, overlap vs serial. The serial
# round carries WAL append + delta encode + socket sends inline at
# publish-every-1, all of which the pipeline moves off-thread, so the
# healthy margin is far above this bar (the tiny in-process drill
# measures ~45%); 0.30 is the acceptance floor, with slack for CI noise.
MIN_REDUCTION = 0.30


def _run_fleet(label: str, overlap: bool, device: str,
               report_dir: str = "") -> Tuple[dict, Dict[str, dict]]:
    """One 3-worker TCP run on `device`; returns (span attribution,
    final-*.json per member)."""
    root = tempfile.mkdtemp(prefix=f"overlap-demo-{label}-")
    obs_dir = os.path.join(root, "obs")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    env["CCRDT_SPANS"] = "1"
    env["CCRDT_OVERLAP"] = "1" if overlap else "0"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", WORKER, "--root", root, "--member", m,
             "--n-members", str(len(MEMBERS)), "--delta",
             "--wal-dir", os.path.join(root, "wal"),
             "--publish-every", "1", "--step-sleep", "0.2", "--device", device,
             *(["--report", os.path.join(report_dir, f"report-{label}-{m}.json")]
               if report_dir else [])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO,
        )
        for m in MEMBERS
    ]
    outs: Dict[str, str] = {}
    for m, p in zip(MEMBERS, procs):
        try:
            out, _ = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs[m] = out
    bad = [m for m, p in zip(MEMBERS, procs) if p.returncode != 0]
    if bad:
        for m in bad:
            print(f"-- {label} worker {m} failed --\n{outs[m][-2000:]}")
        raise SystemExit(1)
    finals = {}
    for m in MEMBERS:
        with open(os.path.join(root, f"final-{m}.json")) as f:
            finals[m] = json.load(f)
    att = obs_spans.attribute(obs_spans.scan_dir(obs_dir))
    return att, finals


def run_arms(device: str, report_dir: str = "") -> Dict[str, tuple]:
    """The serial and the overlapped fleet on `device`, each attribution
    printed: {label: (attribution, finals)}."""
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    runs = {}
    for label, overlap in (("serial", False), ("overlap", True)):
        print(f"== {label} run (CCRDT_OVERLAP={int(overlap)}, 3 TCP "
              "workers, publish every step) ==")
        att, finals = _run_fleet(label, overlap, device, report_dir)
        print(obs_spans.format_report(att))
        print()
        runs[label] = (att, finals)
    return runs


def check_convergence(runs: Dict[str, tuple], device: str) -> int:
    """The digest and counter gates: 0 when every digest of both arms is
    the sequential reference and the overlap arm billed its counters."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest

    # -- bit-identical convergence, overlap on/off ------------------------
    ref = json.loads(json.dumps(reference_digest("topk_rmv", device=device)))
    digests = {
        (label, m): runs[label][1][m]["digest"]
        for label in runs for m in MEMBERS
    }
    wrong = sorted(k for k, d in digests.items() if d != ref)
    if wrong:
        print(f"FAIL: digests diverged from the sequential reference: "
              f"{wrong}")
        return 1
    print(f"OK: all {len(digests)} worker digests bit-identical across "
          "overlap on/off (== sequential reference)")

    # -- the pipeline actually ran ----------------------------------------
    ovl_finals = runs["overlap"][1]
    for name in ("overlap.host_tasks", "overlap.windows"):
        total = sum(
            ovl_finals[m]["metrics"].get(name, 0) for m in MEMBERS
        )
        if not total:
            print(f"FAIL: {name} is zero across the overlap fleet — the "
                  "run silently fell back to the serial path")
            return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="overlap demo and gate")
    ap.add_argument("--device", default=None,
                    help="the workers' device, cpu or cuda (default: the "
                    "card; raises without one)")
    ap.add_argument("--report-dir", default="",
                    help="the workers write their --report files here")
    args = ap.parse_args(argv)

    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import resolve_worker_device

    device = str(resolve_worker_device(args.device))  # the card unless "cpu"; raises without one
    runs = run_arms(device, args.report_dir)
    rc = check_convergence(runs, device)
    if rc:
        return rc

    # -- the perf claim ----------------------------------------------------
    e2e = {
        label: runs[label][0]["fleet"]["e2e_ms_p50"] for label in runs
    }
    reduction = 1.0 - e2e["overlap"] / e2e["serial"]
    verdict = (
        f"round.e2e fleet p50: serial {e2e['serial']:.2f}ms -> overlap "
        f"{e2e['overlap']:.2f}ms ({reduction:+.1%} vs the "
        f"-{MIN_REDUCTION:.0%} bar)"
    )
    if reduction < MIN_REDUCTION:
        print(f"FAIL: {verdict} — the pipeline no longer takes the host "
              "phases off the round thread")
        return 1
    print(f"OK: {verdict}")
    gaps = {
        label: runs[label][0]["fleet"]["gap_ms_p50"] for label in runs
    }
    print(f"dispatch gap fleet p50: serial {gaps['serial']:.2f}ms -> "
          f"overlap {gaps['overlap']:.2f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
