"""Certified-convergence demo/gate (obs/audit.py).

Three legs, each a different verdict surface of the audit plane:

* **laws** — the lattice-law property checker over every registered op
  type (merge commutativity/associativity/idempotence + the
  delta-composition law, batched on-device), plus the negative
  selftest: the committed non-commutative fixture
  (`ops.laws.BrokenMergeDense`) MUST be flagged — a checker that waves
  a broken merge through is itself broken.

* **healthy** — a seeded-chaos 3-worker REAL-PROCESS TCP fleet
  (scripts/net_gossip_demo.py: delta gossip, partition plane +
  divergence watchdog armed, deterministic `tcp.send` drops from
  utils/faults.py). After convergence the supervisor replay-certifies
  the run: flight-log spill (causal delivery + op-count
  reconciliation) + per-worker digests vs the sequential reference →
  a signed convergence certificate, written to ``--out``. The
  healthy arm must certify OK with ZERO wedge alarms (no false
  alarms under injected-but-healing faults).

* **divergent** — the fault-injected arm, in-process and fully
  deterministic: a twin state gets one surgical extra op confined to
  one known partition (`core.partition.part_of`). The watchdog must
  flag the divergence on the FIRST digest exchange (within one
  round), escalate to a wedged alarm once the clock passes the bound
  with no repair, and close the episode with a time-to-agreement
  sample when the twin heals. Certification of the divergent digests
  must FAIL with a counterexample naming the diverging partition.

Port of ``scripts/audit_demo.py``: the same legs, report keys, printed
text and exit codes over this package's ``obs/audit.py``,
``ops.laws.broken_merge_fixture``, ``net_gossip_demo`` workers,
``elastic_demo`` drills and ``crash_recovery_demo.run_scenario``::

    python -m antidote_ccrdt_tpu_torch.scripts.audit_demo [--root DIR] [--pairs N] [--out FILE] [--json]
        [--device cpu|cuda] [--shape demo|main|R,I,B,BR,M,K] [--report-dir DIR] [--hold]

Options of the port only:

* ``--device`` (default: the card; without one it raises) holds the law
  fixtures, the divergent arm's states and every worker's engine.
* ``--shape`` is the divergent arm's width (elastic_demo's ``--shape``:
  ``demo`` is the JAX arm's, ``main`` the main path's).
* ``--report-dir DIR`` has each healthy-fleet worker write its
  ``--report`` there as ``report-<member>.json``.
* ``--hold`` holds each worker's first K1c, K2 and K3 call against its
  plain version.

The healthy certificate goes to ``--out`` (default ``AUDIT_torch_r01.json``
in the current directory), never to the committed ``AUDIT_r01.json``.
`run_durability` is the durability-watermark leg the chaos gate adds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.scripts.elastic_demo import DEMO, STEPS, Geometry, resolve_worker_device  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.net_gossip_demo"
N_WORKERS = 3
PARTITIONS = 8
SEED = 7
WORKER_TIMEOUT_S = 240


def _crc(digest) -> int:
    """Canonical scalar digest over an arbitrary JSON-able observable
    digest (the topk_rmv drill digest is a nested list — the certificate
    layer compares exact ints, so hash the canonical JSON)."""
    return zlib.crc32(
        json.dumps(digest, sort_keys=True).encode("utf-8")
    ) & 0xFFFFFFFF


def run_laws(pairs: int = 32, seed: int = 0, device=None) -> dict:
    """Leg 1: every registered type passes its laws AND the committed
    broken fixture is caught. The fixtures' states live on `device` (the
    card by default; raises without one)."""
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit
    from antidote_ccrdt_tpu_torch.ops.laws import broken_merge_fixture

    dev = resolve_worker_device(device)
    report = obs_audit.LawChecker(seed=seed, pairs=pairs, device=dev).run()
    broken = obs_audit.LawChecker(
        types=["broken_merge_fixture"], seed=seed, pairs=pairs,
        extra_fixtures={"broken_merge_fixture": broken_merge_fixture}, device=dev,
    ).run()
    laws = broken["types"]["broken_merge_fixture"]["laws"]
    selftest_caught = (
        not laws["commutativity"]["ok"]
        and not laws["associativity"]["ok"]
        # 2a-b is idempotent (2a-a == a): the checker must report the
        # laws INDEPENDENTLY, not fail everything wholesale.
        and laws["idempotence"]["ok"]
    )
    return {
        "ok": bool(report["ok"]) and selftest_caught,
        "registry_ok": bool(report["ok"]),
        "selftest_caught": selftest_caught,
        "n_types": report["n_types"],
        "n_law_checks": report["n_law_checks"],
        "n_law_failures": report["n_law_failures"],
        "unaudited": report["unaudited"],
    }


def run_healthy(root: str | None = None, keep: bool = False, device=None, report_dir: str | None = None,
                hold: bool = False, reference=None) -> dict:
    """Leg 2: real-process seeded-chaos fleet -> signed certificate. The
    workers run on `device`, and so does the sequential reference unless
    `reference` (``elastic_demo.reference_digest``'s digest) is given;
    with `report_dir` each worker writes its ``--report`` there, with
    `hold` its first kernel calls are held against the plain versions."""
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest
    from antidote_ccrdt_tpu_torch.utils.faults import plan_to_env

    dev = str(resolve_worker_device(device))
    own_root = root is None
    root = root or tempfile.mkdtemp(prefix="ccrdt-audit-")
    obs_dir = os.path.join(root, "obs")
    os.makedirs(obs_dir, exist_ok=True)
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)

    procs = []
    try:
        for i in range(N_WORKERS):
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
            env["CCRDT_OBS_DIR"] = obs_dir
            # Seeded chaos, healing by construction: a handful of dropped
            # TCP frames at fixed per-worker hit ordinals (past the hello
            # exchange). Lost deltas force real digest-vector resyncs —
            # the watchdog rides those — and the retry/final-convergence
            # machinery repairs everything, so certification must still
            # pass with zero wedge alarms.
            env["CCRDT_FAULTS"] = plan_to_env(
                {"tcp.send": [
                    {"action": "drop", "at": [9 + 4 * i, 21 + 3 * i],
                     "max_fires": 2},
                ]},
                seed=SEED + i,
            )
            cmd = [
                sys.executable, "-m", WORKER,
                "--root", root, "--member", f"w{i}",
                "--n-members", str(N_WORKERS),
                "--type", "topk_rmv", "--delta", "--no-overlap",
                "--partitions", str(PARTITIONS), "--device", dev,
            ]
            if report_dir:
                cmd += ["--report", os.path.join(report_dir, f"report-w{i}.json")]
            if hold:
                cmd += ["--hold"]
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, cwd=REPO,
            ))
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
                outs.append(out)
        except subprocess.TimeoutExpired:
            raise RuntimeError("audit_demo: fleet wedged (worker timeout)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"audit_demo: worker w{i} rc={p.returncode}\n"
                + outs[i][-4000:]
            )

    finals = {}
    for i in range(N_WORKERS):
        with open(os.path.join(root, f"final-w{i}.json")) as f:
            finals[f"w{i}"] = json.load(f)
    digests = {m: _crc(doc["digest"]) for m, doc in finals.items()}
    reference = _crc(reference_digest("topk_rmv", device=dev) if reference is None else reference)

    cert = obs_audit.certify(
        obs_dir=obs_dir, digests=digests, reference=reference,
        meta={
            "arm": "healthy", "workers": sorted(finals),
            "faults": "tcp.send deterministic drops (seeded chaos)",
            "partitions": PARTITIONS,
        },
    )
    verified = obs_audit.verify_certificate(cert)

    counters: dict = {}
    for doc in finals.values():
        for k, v in doc["metrics"].items():
            if k.startswith(("audit.", "net.partition", "net.psnap",
                             "net.dig_")):
                counters[k] = counters.get(k, 0) + v
    result = {
        "ok": bool(cert["ok"]) and verified
        and counters.get("audit.wedge_alarms", 0) == 0,
        "cert": cert,
        "verified": verified,
        "digests": digests,
        "reference": reference,
        "wedge_alarms": int(counters.get("audit.wedge_alarms", 0)),
        "counters": counters,
        "root": root,
    }
    if own_root and not keep:
        shutil.rmtree(root, ignore_errors=True)
    return result


def run_divergent(device=None, geo: Geometry = DEMO) -> dict:
    """Leg 3: deterministic divergence — watchdog detection within one
    digest exchange, wedge alarm, heal, and a FAILED certificate whose
    counterexample names the partition. The drill's states live on
    `device` at width `geo` (elastic_demo's geometry)."""
    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import drills, on_device
    from antidote_ccrdt_tpu_torch.utils.metrics import Metrics

    dev = resolve_worker_device(device)
    with on_device(dev):
        drill = drills(dev, geo)["topk_rmv"]
        dense = drill.make_engine()
        good = drill.init(dense)
        for step in range(3):
            good = drill.apply(dense, good, step, range(geo.R))

        # The twin takes ONE extra add on a single known id — so exactly
        # that id's partition (plus the meta partition: the add bumps
        # whole-instance leaves) may diverge.
        id_star = 17
        p_star = int(pt.part_of([id_star], PARTITIONS)[0])
        twin, _ = dense.apply_ops(
            good, _single_add_ops(id_star, STEPS * geo.B + 1000, geo, dev),
            collect_dominated=False,
        )

        va = [int(x) for x in pt.state_digests(good, PARTITIONS)]
        vb = [int(x) for x in pt.state_digests(twin, PARTITIONS)]
    div = pt.divergent_parts(va, vb)

    clock = {"t": 0.0}
    metrics = Metrics()
    wd = obs_audit.DivergenceWatchdog(
        "probe", wedge_after_s=2.0, mono=lambda: clock["t"],
        metrics=metrics,
    )
    s_agree = wd.observe_peer("twin", va, va, seq=1)
    s_first = wd.observe_peer("twin", va, vb, seq=2)   # one exchange
    clock["t"] += 3.0                                   # past the bound
    s_wedged = wd.observe_peer("twin", va, vb, seq=3)
    clock["t"] += 0.5
    s_healed = wd.observe_peer("twin", vb, vb, seq=4)   # twin adopted

    cert = obs_audit.certify(
        digests={"w_good": va, "w_twin": vb}, reference=va,
        meta={"arm": "divergent", "id_star": id_star, "p_star": p_star},
    )
    wd.note_certificate(cert)
    counters = metrics.snapshot()["counters"]
    counterexample_parts = cert.get("counterexample", {}).get(
        "divergent_parts", []
    )
    ok = (
        bool(div) and p_star in div
        and s_agree == wd.STATE_OK
        and s_first == wd.STATE_DIVERGED    # flagged within one round
        and s_wedged == wd.STATE_WEDGED
        and s_healed == wd.STATE_OK
        and not cert["ok"]
        and obs_audit.verify_certificate(cert)
        and p_star in counterexample_parts
        and counterexample_parts == div
    )
    return {
        "ok": ok,
        "p_star": p_star,
        "divergent_parts": div,
        "counterexample_parts": counterexample_parts,
        "states": {
            "agree": s_agree, "first": s_first,
            "wedged": s_wedged, "healed": s_healed,
        },
        "tta_p50_s": wd.tta_p50_s(),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith("audit.")},
        "cert": cert,
    }


def fabricated_loss_certificate() -> dict:
    """The certificate of a synthesized crashed-incarnation flight log
    that appended through seq 9 but acked durability only through 5, with
    no successor incarnation anywhere."""
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit

    evs = [{"kind": "proc.start", "member": "wX", "t": 1.0, "pid": 1, "seq": 0}]
    evs += [
        {"kind": "wal.append", "member": "wX", "t": 1.0 + 0.01 * i,
         "wseq": i, "bytes": 64, "seq": 1 + i}
        for i in range(10)
    ]
    evs.append({"kind": "wal.durable", "member": "wX", "t": 1.06,
                "through": 5, "group": 6, "seq": 11})
    # No proc.exit (crashed), no successor log (nothing re-derived
    # seqs 6..9): this loss is real and must be flagged.
    return obs_audit.certify(
        logs={"flight-wX-1.jsonl": evs},
        meta={"arm": "fabricated-pre-fsync-loss"},
    )


def run_durability(timeout: float = 240.0, device=None, report_dir: str | None = None, reference=None) -> dict:
    """The durability leg: the durability-watermark axis of the certifier, both
    directions.

    * **fleet arm** — the real-process SIGKILL crash drill re-run under
      ``CCRDT_WAL_DURABILITY=async`` (gossip may publish ahead of the
      fsync): the restarted victim re-derives whatever the crash dropped
      past the watermark, and `certify()`'s ``durability_watermark``
      check must ACTIVATE and pass — relaxed-durability speed with zero
      unaudited loss.

    * **fabricated arm** — a synthesized crashed-incarnation flight log
      that appended through seq 9 but acked durability only through 5,
      with no successor incarnation anywhere: certification must FAIL
      with a counterexample naming exactly the uncovered range [6, 9].
      A certifier that waves provable pre-fsync loss through is itself
      broken (the negative selftest, mirroring the laws leg's
      broken-merge fixture).

    The fleet's workers run on `device`; with `report_dir` each writes
    its ``--report`` there; `reference` is as `run_healthy`'s."""
    from antidote_ccrdt_tpu_torch.scripts.crash_recovery_demo import run_scenario

    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    fleet = run_scenario("wal", "topk_rmv", timeout, durability="async", device=str(resolve_worker_device(device)),
                         report_dir=report_dir, reference=reference)

    cert = fabricated_loss_certificate()
    exposures = cert.get("counterexample", {}).get("durability_exposures", [])
    fabricated_flagged = (
        not cert["ok"]
        and cert["checks"].get("durability_watermark") is False
        and any(
            x.get("member") == "wX" and x.get("uncovered") == [6, 9]
            for x in exposures
        )
    )
    fleet_certified = (
        bool(fleet["ok"])
        and fleet["certifier_checks"].get("durability_watermark") is True
    )
    return {
        "ok": fleet_certified and fabricated_flagged,
        "fleet": {
            k: fleet.get(k)
            for k in (
                "ok", "problems", "durability", "kill_seq",
                "victim_flight_durable", "victim_flight_last_step",
                "victim_recover_last_step", "certifier_checks",
            )
        },
        "fabricated_flagged": fabricated_flagged,
        "fabricated_exposures": exposures,
        "fabricated_cert_ok": bool(cert["ok"]),
    }


def _single_add_ops(id_star: int, ts: int, geo: Geometry, device):
    """A TopkRmvOps batch that is all padding except one add of
    `id_star` on replica 0 (padding convention: add_ts=0 / rmv_id=-1,
    same as elastic_demo gen_ops), its columns on `device`."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

    R, B, Br, DCS = geo.R, geo.B, geo.Br, geo.DCS
    cols = dict(
        add_key=np.zeros((R, B), np.int32), add_id=np.zeros((R, B), np.int32),
        add_score=np.zeros((R, B), np.int32), add_dc=np.zeros((R, B), np.int32),
        add_ts=np.zeros((R, B), np.int32), rmv_key=np.zeros((R, Br), np.int32),
        rmv_id=np.full((R, Br), -1, np.int32), rmv_vc=np.zeros((R, Br, DCS), np.int32),
    )
    cols["add_id"][0, 0], cols["add_score"][0, 0], cols["add_ts"][0, 0] = id_star, 499, ts
    return convert.from_numpy(TopkRmvOps, cols, device)


def run_all(pairs: int = 32, root: str | None = None, device=None, geo: Geometry = DEMO,
            report_dir: str | None = None, hold: bool = False) -> dict:
    return {
        "laws": run_laws(pairs=pairs, device=device),
        "healthy": run_healthy(root=root, device=device, report_dir=report_dir, hold=hold),
        "divergent": run_divergent(device=device, geo=geo),
    }


def main(argv=None) -> int:
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import parse_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="fleet scratch dir (default: tmp)")
    ap.add_argument("--pairs", type=int, default=32,
                    help="law-check instance pairs per dispatch")
    ap.add_argument("--out", default="AUDIT_torch_r01.json",
                    help="where to write the healthy-arm certificate (default: AUDIT_torch_r01.json in the "
                    "current directory)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="the divergent arm's width: demo, main or R,I,B,BR,M,K")
    ap.add_argument("--report-dir", default="", help="the healthy fleet's workers write their --report files here")
    ap.add_argument("--hold", action="store_true",
                    help="hold each worker's first K1c, K2 and K3 call against its plain version")
    args = ap.parse_args(argv)

    device = resolve_worker_device(args.device)  # raises without a card unless --device cpu
    res = run_all(pairs=args.pairs, root=args.root, device=device, geo=parse_shape(args.shape),
                  report_dir=args.report_dir or None, hold=args.hold)
    laws, healthy, divergent = (
        res["laws"], res["healthy"], res["divergent"]
    )
    with open(args.out, "w") as f:
        json.dump(healthy["cert"], f, indent=2, sort_keys=True)
        f.write("\n")

    if args.json:
        print(json.dumps({
            "laws": laws,
            "healthy": {k: v for k, v in healthy.items() if k != "cert"},
            "divergent": {
                k: v for k, v in divergent.items() if k != "cert"
            },
        }, sort_keys=True, default=str))
    else:
        print("== certified convergence (obs/audit.py) ==")
        print(
            f"laws      : {'ok' if laws['ok'] else 'FAIL'} "
            f"({laws['n_law_checks']} checks / {laws['n_types']} types, "
            f"{laws['n_law_failures']} failures, broken fixture "
            f"{'caught' if laws['selftest_caught'] else 'MISSED'})"
        )
        cert = healthy["cert"]
        print(
            f"healthy   : cert {'OK' if cert['ok'] else 'FAILED'} "
            f"(signature {'valid' if healthy['verified'] else 'INVALID'}, "
            f"{cert['n_flight_logs']} flight logs, "
            f"wedge alarms {healthy['wedge_alarms']}) -> {args.out}"
        )
        print(
            f"divergent : watchdog "
            f"{divergent['states']} parts={divergent['divergent_parts']} "
            f"p*={divergent['p_star']} cert FAILED as required, "
            f"counterexample names {divergent['counterexample_parts']}"
        )
    ok = laws["ok"] and healthy["ok"] and divergent["ok"]
    print("audit-demo:", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
