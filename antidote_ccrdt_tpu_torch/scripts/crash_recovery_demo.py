"""Real-process crash/recovery drill: SIGKILL a WAL-backed worker mid-run.

    python -m antidote_ccrdt_tpu_torch.scripts.crash_recovery_demo [--mode wal|adopt|both]
        [--durability sync|group|async|all] [--type topk_rmv] [--device cpu|cuda] [--report-dir DIR]

Port of ``scripts/crash_recovery_demo.py``. Supervises a 3-member elastic
gossip fleet (``elastic_demo.py`` workers of this package, shared-directory
transport) with the crash-consistent WAL enabled (--wal-dir). Once the
victim has published a couple of steps it is SIGKILLed — no cleanup, torn
WAL tail possible — then restarted, and every member's final digest must
equal the sequential single-process reference.

* ``wal``   — the victim restarts with its WAL intact: it must recover
  state = checkpoint ⊔ WAL suffix (``wal.recovered_records > 0`` in its
  final metrics) and resume AFTER its last durable step instead of
  regenerating history.
* ``adopt`` — same crash, but the victim's WAL directory is deleted before
  the restart and the restart is delayed past failure detection: recovery
  must fall back to the deterministic-regeneration/adoption path and still
  converge.

Both modes run under every WAL durability discipline (``--durability
sync|group|async|all``, exported to the workers as
``CCRDT_WAL_DURABILITY``). Per-mode checks, all post-mortem from the
flight logs:

* sync/group — durable-before-visible: the restarted victim's
  ``wal.recover`` must reach at least the seq the victim had PUBLISHED at
  kill time.
* async — recovery == watermark truncation: recover.last_step must be
  bracketed by the killed incarnation's last ``wal.durable`` watermark and
  its last ``wal.append``, and the obs/audit certifier's
  ``durability_watermark`` check must pass.

The port's own options: ``--device`` (default: the card; without one the
workers raise) is passed to every worker and is the reference's device;
``--report-dir DIR`` has each worker write its ``--report`` there as
``<mode>-<durability>-<member>-<incarnation>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

WORKER = "antidote_ccrdt_tpu_torch.scripts.elastic_demo"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MEMBERS = ("w0", "w1", "w2")
VICTIM = "w1"


def _env(root: str, durability: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    # Observability plane: continuous flight-recorder spill (survives the
    # SIGKILL — that is the point) + exit-time metrics snapshots.
    env["CCRDT_OBS_DIR"] = os.path.join(root, "obs")
    env["CCRDT_METRICS_DIR"] = os.path.join(root, "metrics")
    env["CCRDT_WAL_DURABILITY"] = durability
    return env


def _launch(root: str, member: str, type_name: str, wal_dir: str, durability: str, device=None, report=None):
    extra = (["--device", device] if device else []) + (["--report", report] if report else [])
    return subprocess.Popen(
        [sys.executable, "-m", WORKER, "--root", root, "--member", member,
         "--n-members", str(len(MEMBERS)), "--type", type_name, "--wal-dir", wal_dir, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=_env(root, durability), text=True, cwd=ROOT,
    )


def _snap_seq(root: str, member: str):
    """The 8-byte step header of `member`'s published snapshot, or None."""
    try:
        with open(os.path.join(root, f"snap-{member}"), "rb") as f:
            hdr = f.read(8)
    except OSError:
        return None
    if len(hdr) != 8:
        return None
    return struct.unpack("<Q", hdr)[0]


def run_scenario(
    mode: str, type_name: str, timeout: float, durability: str = "group", device=None, report_dir=None,
    reference=None,
) -> dict:
    """One kill/restart drill; returns a verdict dict (ok + evidence). The
    sequential reference runs on `device` unless `reference`
    (``elastic_demo.reference_digest``'s digest) is given."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest

    root = tempfile.mkdtemp(prefix=f"crash-{mode}-{durability}-")
    wal_dir = os.path.join(root, "wal")
    incarnations = dict.fromkeys(MEMBERS, 0)

    def launch(m):
        report = None
        if report_dir:
            report = os.path.join(report_dir, f"{mode}-{durability}-{m}-{incarnations[m]}.json")
        incarnations[m] += 1
        return _launch(root, m, type_name, wal_dir, durability, device, report)

    procs = {m: launch(m) for m in MEMBERS}
    try:
        # Wait for the victim to have durable, published progress (a couple
        # of steps in the WAL AND visible to peers), then SIGKILL it.
        deadline = time.time() + timeout
        while time.time() < deadline:
            seq = _snap_seq(root, VICTIM)
            if seq is not None and 2 <= seq < 8:
                break
            if procs[VICTIM].poll() is not None:
                raise RuntimeError(f"victim exited before the kill point:\n{procs[VICTIM].communicate()[0]}")
            time.sleep(0.01)
        else:
            raise RuntimeError("victim never reached the kill window")
        kill_seq = seq
        victim_pid = procs[VICTIM].pid
        procs[VICTIM].kill()  # SIGKILL: no atexit, no flush, torn tail possible
        procs[VICTIM].wait()

        if mode == "adopt":
            # Destroy the durable path entirely and hold the restart past
            # failure detection: survivors must adopt, the restarted victim
            # must self-regenerate — convergence without WAL recovery.
            shutil.rmtree(os.path.join(wal_dir, f"wal-{VICTIM}"), ignore_errors=True)
            time.sleep(1.0)
        procs[VICTIM] = launch(VICTIM)
        restart_pid = procs[VICTIM].pid

        rcs, outs = {}, {}
        for m, p in procs.items():
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            rcs[m], outs[m] = p.returncode, out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()

    # JSON round-trip: digests come back from the workers' final-*.json as
    # lists, the in-process reference may hold tuples.
    ref = json.loads(json.dumps(reference_digest(type_name, device=device) if reference is None else reference))
    finals, bad = {}, []
    for m in MEMBERS:
        path = os.path.join(root, f"final-{m}.json")
        if not os.path.exists(path):
            bad.append(f"{m}: no final (rc={rcs[m]})\n{outs[m][-2000:]}")
            continue
        with open(path) as f:
            finals[m] = json.load(f)
        if finals[m]["digest"] != ref:
            bad.append(f"{m}: digest != reference")

    recovered = int(finals.get(VICTIM, {}).get("metrics", {}).get("wal.recovered_records", 0))
    if mode == "wal" and recovered <= 0:
        bad.append("victim converged without WAL recovery (recovered_records=0)")
    if mode == "adopt" and recovered > 0:
        bad.append(f"adopt mode unexpectedly recovered {recovered} WAL records")

    # Flight-recorder post-mortem: the SIGKILLed incarnation must have left
    # a spill, identifiable by the ABSENCE of a proc.exit trailer, and its
    # last durable step must sit at/just past the kill point.
    from antidote_ccrdt_tpu_torch.obs import events as obs_events

    killed_log = obs_events.read_log(os.path.join(root, "obs", f"flight-{VICTIM}-{victim_pid}.jsonl"))
    flight_last_step = max((int(e["wseq"]) for e in killed_log if e.get("kind") == "wal.append"), default=None)
    if not killed_log:
        bad.append("no flight-recorder dump for the SIGKILLed incarnation")
    elif any(e.get("kind") == "proc.exit" for e in killed_log):
        bad.append("killed incarnation's flight log has a clean proc.exit")
    elif flight_last_step is not None and flight_last_step > kill_seq + 2:
        bad.append(f"flight log claims step {flight_last_step}, but the victim was killed at published seq {kill_seq}")

    # Durability-mode post-mortem: the killed incarnation's last acked
    # watermark (wal.durable) vs where the restarted incarnation's
    # wal.recover actually landed.
    flight_durable = max((int(e["through"]) for e in killed_log if e.get("kind") == "wal.durable"), default=-1)
    restart_log = obs_events.read_log(os.path.join(root, "obs", f"flight-{VICTIM}-{restart_pid}.jsonl"))
    recover_ev = next((e for e in restart_log if e.get("kind") == "wal.recover"), None)
    recovered_last = None if recover_ev is None else int(recover_ev["last_step"])
    if mode == "wal" and recover_ev is None:
        bad.append("restarted victim emitted no wal.recover event")
    elif mode == "wal" and durability in ("sync", "group"):
        # Durable-before-visible: anything the victim had PUBLISHED was
        # fsync-acked first, so recovery must reach the kill seq.
        if recovered_last < kill_seq:
            bad.append(f"{durability}: recovered last_step {recovered_last} < published seq {kill_seq} at kill — "
                       "acked record lost")
    elif mode == "wal" and durability == "async":
        # Recovery == watermark truncation: bracketed by the killed
        # incarnation's last ack and its last append.
        if recovered_last < flight_durable:
            bad.append(f"async: recovered last_step {recovered_last} < durable watermark {flight_durable} — "
                       "acked record lost")
        if flight_last_step is not None and recovered_last > flight_last_step:
            bad.append(f"async: recovered last_step {recovered_last} > last appended {flight_last_step} — "
                       "recovery past the log")

    # Certifier reconciliation over the whole fleet's flight logs: any
    # records the crash dropped past the watermark must be audited as
    # covered by the successor incarnation — zero unaudited loss.
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit

    cert = obs_audit.certify(obs_dir=os.path.join(root, "obs"))
    if durability in ("group", "async") and "durability_watermark" not in cert["checks"]:
        bad.append(f"{durability}: certifier durability check never activated")
    if cert["checks"].get("durability_watermark") is False:
        bad.append("certifier durability_watermark FAILED: " + json.dumps(cert["durability"].get("exposed", [])))

    verdict = {
        "mode": mode,
        "durability": durability,
        "type": type_name,
        "ok": not bad,
        "problems": bad,
        "victim_recovered_records": recovered,
        "victim_resume_step": finals.get(VICTIM, {}).get("metrics", {}).get("wal.resume_step"),
        "kill_seq": kill_seq,
        "victim_flight_events": len(killed_log),
        "victim_flight_last_step": flight_last_step,
        "victim_flight_durable": flight_durable,
        "victim_recover_last_step": recovered_last,
        "certifier_checks": cert["checks"],
        "returncodes": rcs,
        "root": root,
    }
    if not bad:
        shutil.rmtree(root, ignore_errors=True)
        verdict.pop("root")
    return verdict


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="both", choices=("wal", "adopt", "both"))
    ap.add_argument("--durability", default="all", choices=("sync", "group", "async", "all"),
                    help="WAL durability discipline for the fleet (all = drill each)")
    ap.add_argument("--type", default="topk_rmv")
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--device", default=None, help="the workers' and the reference's device (default: the card)")
    ap.add_argument("--report-dir", default="", help="the workers write their --report files here")
    args = ap.parse_args(argv)

    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import resolve_worker_device

    device = str(resolve_worker_device(args.device))  # raises without a card unless --device cpu
    if args.report_dir:
        os.makedirs(args.report_dir, exist_ok=True)
    modes = ("wal", "adopt") if args.mode == "both" else (args.mode,)
    durabilities = ("sync", "group", "async") if args.durability == "all" else (args.durability,)
    # The wal-mode drill runs under EVERY durability discipline (its checks
    # differ per mode); adopt deletes the WAL outright, so one
    # representative durability is enough.
    plan = []
    if "wal" in modes:
        plan += [("wal", d) for d in durabilities]
    if "adopt" in modes:
        plan.append(("adopt", "group" if "group" in durabilities else durabilities[0]))
    verdicts = [
        run_scenario(m, args.type, args.timeout, durability=d, device=device, report_dir=args.report_dir or None)
        for m, d in plan
    ]
    print(json.dumps(verdicts, indent=2), flush=True)
    if not all(v["ok"] for v in verdicts):
        sys.exit(1)


if __name__ == "__main__":
    main()
