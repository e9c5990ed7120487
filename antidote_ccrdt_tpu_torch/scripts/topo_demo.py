"""Two-zone TCP fleet demo: the topo/ hierarchy against real sockets.

Supervises the real-process gossip drill (scripts/net_gossip_demo.py)
twice over six localhost workers split into two zones (za: w0-w2,
zb: w3-w5):

1. **topo run** — routers installed (`--topo`), chained-delta gossip,
   and the za ANCHOR (computed with the same rendezvous hash the fleet
   uses) SIGKILLed mid-run. Survivors must fail over to the runner-up
   anchor, keep relaying across the zone boundary, and converge to the
   sequential single-process reference digest.
2. **baseline run** — the same fleet full-mesh (no router), as the
   traffic yardstick and the bit-identical-convergence witness.

Acceptance (exit 0 only if ALL hold):

* every surviving worker's digest == the sequential reference, in BOTH
  runs (topology is state-transparent);
* the survivors' merged `topo.cross_zone.frames` counter is nonzero and
  the flight logs contain a `topo.anchor_change` event moving off the
  killed anchor (failover actually happened, observably);
* cross-DCN economy: counting `frame.send` events whose sender and
  receiver zones differ — the same measurement applied to both runs'
  flight logs — the topo fleet crosses the zone boundary at most half
  as often as the full mesh (in practice ~O(zones)/O(peers), printed).

Port of ``scripts/topo_demo.py``: the same two fleets, gates, printed
text and exit codes, over this package's ``net_gossip_demo`` workers,
``obs/events.py``, ``topo.rendezvous_anchor`` and
``elastic_demo.reference_digest`` (on the workers' device)::

    python -m antidote_ccrdt_tpu_torch.scripts.topo_demo [--device cpu|cuda] [--report-dir DIR] [--hold]
        [--out FILE|auto]

Options of the port only: ``--device`` (default: the card; without one
it raises) is every worker's device; ``--report-dir DIR`` has each
worker write its ``--report`` (timings, kernel launches) there as
``report-<leg>-<member>.json`` (legs ``topo`` and ``mesh``; the killed
anchor writes none); ``--hold`` holds each worker's first K1c, K2 and K3
call against its plain version. ``--out FILE`` also writes the round
document there; ``--out auto`` picks the next ``TOPO_torch_rNN.json`` in
the current directory, never a ``TOPO_r*.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"

ZONES = {
    "w0": "za", "w1": "za", "w2": "za",
    "w3": "zb", "w4": "zb", "w5": "zb",
}


def _spawn_fleet(root: str, obs_dir: str, topo: bool, args, dev: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_OBS_DIR"] = obs_dir
    leg = "topo" if topo else "mesh"
    procs = {}
    for member, zone in ZONES.items():
        cmd = [
            sys.executable, "-m", WORKER, "--root", root, "--member", member,
            "--n-members", str(len(ZONES)), "--type", args.type,
            "--zone", zone, "--delta",
            "--timeout", str(args.timeout),
            "--step-sleep", str(args.step_sleep),
            "--device", dev,
        ]
        if topo:
            cmd += ["--topo", "--lag-anchor-ops", str(args.lag_anchor_ops)]
        if args.report_dir:
            cmd += ["--report", os.path.join(args.report_dir, f"report-{leg}-{member}.json")]
        if args.hold:
            cmd += ["--hold"]
        procs[member] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env, text=True, cwd=REPO,
        )
    return procs


def _wait_step(root: str, member: str, step: int, timeout: float) -> bool:
    """Poll the worker's obs-<member>.json status drop until it reports
    `step` (or the deadline passes)."""
    path = os.path.join(root, f"obs-{member}.json")
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            with open(path) as f:
                if json.load(f).get("step", -1) >= step:
                    return True
        except (OSError, ValueError):
            pass
        time.sleep(0.05)
    return False


def _reap(procs: dict, timeout: float) -> dict:
    outs = {}
    for member, p in procs.items():
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            outs[member] = (None, out)  # hung — degrade-never-hang violated
            continue
        outs[member] = (p.returncode, out)
    return outs


def _finals(root: str) -> dict:
    out = {}
    for path in glob.glob(os.path.join(root, "final-*.json")):
        try:
            with open(path) as f:
                doc = json.load(f)
            out[doc["member"]] = doc
        except (OSError, ValueError, KeyError):
            continue
    return out


def _cross_zone_sends(obs_dir: str) -> int:
    """Count frame.send events whose sender and receiver live in
    different zones — the topology-independent cross-DCN yardstick."""
    from antidote_ccrdt_tpu_torch.obs import events as obs_events

    n = 0
    for evs in obs_events.scan_dir(obs_dir).values():
        for ev in evs:
            if ev.get("kind") != "frame.send":
                continue
            src = ZONES.get(ev.get("member", ""))
            dst = ZONES.get(ev.get("peer", ""))
            if src and dst and src != dst:
                n += 1
    return n


def _failover_events(obs_dir: str, victim: str) -> list:
    from antidote_ccrdt_tpu_torch.obs import events as obs_events

    logs = obs_events.scan_dir(obs_dir)
    return [
        ev for ev in obs_events.iter_kinds(logs, "topo.anchor_change")
        if ev.get("old") == victim and ev.get("new") != victim
        and ev.get("member") != victim
    ]


def _next_round_path() -> str:
    taken = [
        int(m.group(1))
        for p in glob.glob("TOPO_torch_r*.json")
        if (m := re.search(r"TOPO_torch_r(\d+)\.json$", os.path.basename(p)))
    ]
    return os.path.abspath(f"TOPO_torch_r{max(taken, default=0) + 1:02d}.json")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--type", default="topk_rmv")
    ap.add_argument("--timeout", type=float, default=0.5)
    ap.add_argument("--step-sleep", type=float, default=0.15)
    ap.add_argument("--kill-at-step", type=int, default=3,
                    help="SIGKILL the za anchor once it reports this step")
    ap.add_argument("--lag-anchor-ops", type=float, default=8.0)
    ap.add_argument("--worker-timeout", type=float, default=240.0)
    ap.add_argument("--out", default="",
                    help="also write a TOPO_torch_rNN.json round artifact "
                    "('auto' picks the next free round number in the current directory)")
    ap.add_argument("--device", default=None,
                    help="the workers' device, cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--report-dir", default="", help="the workers write their --report files here")
    ap.add_argument("--hold", action="store_true",
                    help="each worker holds its first K1c, K2 and K3 call against its plain version")
    args = ap.parse_args(argv)

    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest, resolve_worker_device
    from antidote_ccrdt_tpu_torch.topo import rendezvous_anchor

    dev = resolve_worker_device(args.device)  # the card unless "cpu"; raises without one
    if args.report_dir:
        os.makedirs(args.report_dir, exist_ok=True)
    # JSON-normalize (tuples -> lists) to match the workers' final-json
    # round-trip, exactly as the slow TCP test compares digests.
    ref = json.loads(json.dumps(reference_digest(args.type, device=dev)))
    dev = str(dev)
    za_members = sorted(m for m, z in ZONES.items() if z == "za")
    victim = rendezvous_anchor("za", za_members)
    failures = []

    with tempfile.TemporaryDirectory(prefix="topo-demo-") as tmp:
        # -- leg 1: the zone topology, anchor killed mid-run ----------------
        t_root = os.path.join(tmp, "topo")
        t_obs = os.path.join(tmp, "topo-obs")
        os.makedirs(t_root)
        print(f"== topo run: 2 zones x 3 workers, killing za anchor "
              f"{victim} at step {args.kill_at_step} ==", flush=True)
        t_leg = time.perf_counter()
        procs = _spawn_fleet(t_root, t_obs, topo=True, args=args, dev=dev)
        if _wait_step(t_root, victim, args.kill_at_step, 120.0):
            procs[victim].send_signal(signal.SIGKILL)
            print(f"   SIGKILL -> {victim}", flush=True)
        else:
            failures.append(f"{victim} never reached step "
                            f"{args.kill_at_step} — cannot stage the kill")
            procs[victim].kill()
        outs = _reap(procs, args.worker_timeout)
        topo_s = time.perf_counter() - t_leg
        for member, (rc, out) in outs.items():
            if member != victim and rc != 0:
                failures.append(f"topo worker {member} rc={rc}:\n{out}")

        finals = _finals(t_root)
        survivors = sorted(m for m in ZONES if m != victim)
        topo_digests = {}
        merged: dict = {}
        for m in survivors:
            doc = finals.get(m)
            if doc is None:
                failures.append(f"topo worker {m} left no final json")
                continue
            topo_digests[m] = doc["digest"]
            if doc["digest"] != ref:
                failures.append(
                    f"topo {m} diverged from the sequential reference")
            for k, v in doc.get("metrics", {}).items():
                merged[k] = merged.get(k, 0) + v
        cross_frames = merged.get("topo.cross_zone.frames", 0)
        cross_bytes = merged.get("topo.cross_zone.bytes", 0)
        if not cross_frames:
            failures.append("topo.cross_zone.frames == 0 — the hierarchy "
                            "never crossed the DCN")
        if not merged.get("topo.relays", 0):
            failures.append("topo.relays == 0 — anchors never relayed")
        failovers = _failover_events(t_obs, victim)
        if not failovers:
            failures.append(f"no topo.anchor_change away from {victim} in "
                            "the flight logs — failover unobserved")
        topo_cross_sends = _cross_zone_sends(t_obs)
        print(f"   survivors converged: "
              f"{sorted(m for m, d in topo_digests.items() if d == ref)}")
        print(f"   topo.cross_zone.frames={cross_frames} "
              f"bytes={cross_bytes} relays={merged.get('topo.relays', 0)} "
              f"anchor_changes={merged.get('topo.anchor_changes', 0)}")
        print(f"   failover events (old={victim}): {len(failovers)}")
        print(f"   codec: zlib_frames={merged.get('net.codec_zlib_frames', 0)} "
              f"saved_bytes={merged.get('net.codec_saved_bytes', 0)} "
              f"lag_anchor_cuts={merged.get('net.lag_anchor_cuts', 0)}")
        print(f"   leg seconds: {topo_s:.3f}", flush=True)

        # -- leg 2: full-mesh baseline, same fleet shape --------------------
        b_root = os.path.join(tmp, "mesh")
        b_obs = os.path.join(tmp, "mesh-obs")
        os.makedirs(b_root)
        print("== baseline run: same fleet, full mesh ==", flush=True)
        t_leg = time.perf_counter()
        outs = _reap(_spawn_fleet(b_root, b_obs, topo=False, args=args, dev=dev),
                     args.worker_timeout)
        mesh_s = time.perf_counter() - t_leg
        for member, (rc, out) in outs.items():
            if rc != 0:
                failures.append(f"baseline worker {member} rc={rc}:\n{out}")
        base_digests = {
            m: doc["digest"] for m, doc in _finals(b_root).items()
        }
        for m, d in sorted(base_digests.items()):
            if d != ref:
                failures.append(f"baseline {m} diverged from the reference")
        if topo_digests and base_digests and not failures:
            # Both fleets equal the reference => bit-identical to each
            # other; said explicitly because it is the headline claim.
            print("   topo and full-mesh digests are bit-identical "
                  "(both == sequential reference)")
        base_cross_sends = _cross_zone_sends(b_obs)
        print(f"   leg seconds: {mesh_s:.3f}")

        ratio = (topo_cross_sends / base_cross_sends
                 if base_cross_sends else float("inf"))
        print(f"== cross-DCN economy: topo={topo_cross_sends} "
              f"mesh={base_cross_sends} frame sends "
              f"(ratio {ratio:.2f}) ==")
        if not topo_cross_sends:
            failures.append("topo run shows zero cross-zone frame.send "
                            "events — nothing crossed at all?")
        elif topo_cross_sends * 2 > base_cross_sends:
            failures.append(
                f"topo fleet crossed the DCN {topo_cross_sends} times vs "
                f"full mesh {base_cross_sends} — expected at most half "
                "(O(zones), not O(peers))")

        if args.out:
            path = (_next_round_path() if args.out == "auto"
                    else args.out)
            doc = {
                "demo": "topo_demo",
                "type": args.type,
                "fleet": ZONES,
                "killed_anchor": victim,
                "converged": sorted(
                    m for m, d in topo_digests.items() if d == ref),
                "baseline_converged": sorted(
                    m for m, d in base_digests.items() if d == ref),
                "counters": merged,
                "cross_zone": {
                    "topo_frame_sends": topo_cross_sends,
                    "mesh_frame_sends": base_cross_sends,
                    "ratio": ratio,
                    "frames": cross_frames,
                    "bytes": cross_bytes,
                },
                "failover_events": failovers[:8],
                "ok": not failures,
            }
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
            print(f"   round artifact -> {path}")

    if failures:
        print("FAIL:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"OK: 2-zone fleet survived anchor SIGKILL ({victim}), "
          f"converged bit-identically with full mesh, and crossed the "
          f"DCN {topo_cross_sends}x vs {base_cross_sends}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
