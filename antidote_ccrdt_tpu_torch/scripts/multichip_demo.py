"""Mesh-sharded multichip acceptance drill (mesh/ tentpole gate).

Two phases over 8 logical devices:

* Phase A (in-process, real FS-transport pair): a mesh-sharded anchor
  (`MeshPlan` (2,4), per-shard digest slices + psnap blobs) diverges on
  ONE partition; the peer repairs through the mesh-grouped
  `PartialAntiEntropy`. Gated: cross-slice anti-entropy ships only
  shard-local psnap slices — >= 5x fewer bytes than the whole-instance
  snapshot the legacy path would pull — and the repaired digest vector
  is BIT-IDENTICAL to the producer's. Also times the ICI JOIN
  all-reduce (`mesh/reduce.py`) for the carrier metrics.

* Phase B (real processes): a 2-slice fleet of 3 mesh-sharded
  elastic_demo workers (CCRDT_MESH=1, CCRDT_ZONE=slice<i>, each with
  its own 8 logical devices) gossips through a shared directory;
  one worker is SIGKILLed mid-load and NOT restarted. Gated: the
  survivors adopt its replicas and converge BIT-IDENTICALLY to the
  unsharded sequential reference, every survivor ran ICI reduces, and
  the replay certificate verifies over the sharded flight logs.

Port of ``scripts/multichip_demo.py``: the same phases, checks, report
keys, printed text and exit codes over this package's mesh plane. JAX's
8 forced host devices become 8 logical devices of one device
(``parallel.dist.logical_devices``): phase A runs inside such a region,
and each phase-B worker gets one through elastic_demo's ``--local 8``::

    python -m antidote_ccrdt_tpu_torch.scripts.multichip_demo [--out FILE] [--timeout S]
        [--device cpu|cuda] [--shape demo|main|R,I,B,BR,M,K] [--report-dir DIR]

Options of the port only: ``--device`` (default: the card; without one
it raises) holds phase A's engine and states and every worker's;
``--shape`` is both phases' width: phase A's is partition_demo's
geometry (uniform ids), phase B's workers get the same text as
elastic_demo's ``--shape`` (Zipf ids). ``demo`` is the JAX drill's,
``main`` the main path's R = D = 32, 100 000 ids, K = 100, M = 4, 32 768
adds and 2 048 removals a replica and step. At any width but the demo's,
phase B's workers run with a slowed failure detector (WIDE_WORKER_ARGS).
``--report-dir DIR`` has each phase-B worker write its ``--report``
there as ``report-<member>.json``. The report goes to ``--out`` (default ``MULTICHIP_torch_r01.json`` in
the current directory), never to the committed ``MULTICHIP_r*.json``.
`phase_a` and `phase_b` run without the CLI; `checks_of` names their
failures as the report's checks.
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
import zlib

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.scripts import partition_demo as pd  # noqa: E402  (geometry + op streams)
from antidote_ccrdt_tpu_torch.scripts import elastic_demo as ed  # noqa: E402  (the phase-B workers, the device)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER = "antidote_ccrdt_tpu_torch.scripts.elastic_demo"
P = 8
N_DEVICES = 8  # the logical devices of phase A and of each phase-B worker
MIN_RATIO = 5.0  # the gate: the partial repair moves at least 5x fewer bytes
MEMBERS = ("w0", "w1", "w2")
SLICE_OF = {"w0": 0, "w1": 0, "w2": 1}  # 2 slices; w1 shares slice0
VICTIM = "w1"
# A phase-B worker wider than the demo's publishes anchors of up to
# hundreds of MB, seconds of host work: its failure detector is slowed
# from elastic_demo's 0.4 s timeout and 0.05 s heartbeat, and its final
# barrier waits up to 60 s for progress (10 s), so that a publish is not
# taken for a death.
WIDE_WORKER_ARGS = ("--timeout", "8.0", "--hb-interval", "0.25", "--settle-s", "60")


def phase_a(report: dict, device=None, geo: pd.Geometry = pd.DEMO) -> list:
    """Shard-local anti-entropy byte gate + the ICI reduce microbench, on
    8 logical devices of `device` (the card by default; raises without
    one) at width `geo`. Mutates `report`, returns the list of failed
    check names."""
    dev = ed.resolve_worker_device(device)
    with ed.on_device(dev, N_DEVICES):
        return _phase_a(report, dev, geo)


def _phase_a(report: dict, dev, g: pd.Geometry) -> list:
    import math

    import numpy as np
    import torch

    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.mesh import MeshPlan
    from antidote_ccrdt_tpu_torch.mesh import reduce as mesh_reduce
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense
    from antidote_ccrdt_tpu_torch.net.transport import FsTransport, GossipNode
    from antidote_ccrdt_tpu_torch.parallel.elastic import (
        DeltaPublisher, PartialAntiEntropy, sweep_deltas,
    )
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    dense = make_dense(n_ids=g.I, n_dcs=g.DCS, size=g.K, slots_per_id=g.M, device=dev)
    plan = MeshPlan.build(n_dc=2, n_key=4, partitions=P)
    part_map = pt.part_of(np.arange(g.I), P)
    p_star = int(np.bincount(part_map, minlength=P).argmax())
    ids_p = np.arange(g.I, dtype=np.int32)[part_map == p_star]
    all_ids = np.arange(g.I, dtype=np.int32)

    def apply(st, step, pool):
        st, _ = dense.apply_ops(
            st, pd.gen_ops(g, step, range(g.R), pool, dev), collect_dominated=False
        )
        return st

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    bad = []
    root = tempfile.mkdtemp(prefix="multichip-a-")
    try:
        a = GossipNode(FsTransport(root, "a"))
        b = GossipNode(FsTransport(root, "b"))
        a.heartbeat(), b.heartbeat()
        pub = DeltaPublisher(
            a, dense, name="topk_rmv", full_every=1, keep=1, partitions=P,
            mesh_plan=plan,
        )
        pae = PartialAntiEntropy(b, partitions=P, mesh_plan=plan)
        curs = {}

        # Shared prefix over the whole id space, one ICI reduce at the
        # publish boundary (the mesh loop's shape), then the peer
        # ingests the anchor.
        st_a = plan.place(dense.init(g.R, g.NK))
        for step in range(3):
            st_a = apply(st_a, step, all_ids)
        st_a = mesh_reduce.ici_reduce(dense, plan, st_a, metrics=a.metrics)
        pub.publish(st_a)
        st_b, _ = sweep_deltas(
            b, dense, plan.place(dense.init(g.R, g.NK)), curs, partial=pae
        )
        if not np.array_equal(
            pt.state_digests(st_b, P), pt.state_digests(st_a, P)
        ):
            bad.append("phase_a_prefix_converged")

        # The divergence: one step confined to p*'s ids (the reduce
        # joins rows, but the new content lives only in p*'s id slice,
        # so the digest gap stays {p*, meta}).
        st_a = apply(st_a, 3, ids_p)
        st_a = mesh_reduce.ici_reduce(dense, plan, st_a, metrics=a.metrics)
        pub.publish(st_a)

        raw_whole = b.transport.fetch("a")
        whole_bytes = len(raw_whole) if raw_whole else 0
        del raw_whole
        raw_dig = b.transport.fetch_digest("a")
        dig_bytes = len(raw_dig) if raw_dig else 0
        c0 = dict(b.metrics.counters)
        st_b, _ = sweep_deltas(b, dense, st_b, curs, partial=pae)
        c1 = dict(b.metrics.counters)
        psnap_bytes = int(
            c1.get("net.psnap_bytes", 0) - c0.get("net.psnap_bytes", 0)
        )
        partial_bytes = psnap_bytes + dig_bytes
        ratio = whole_bytes / max(1, partial_bytes)
        repair_identical = bool(np.array_equal(
            pt.state_digests(st_b, P), pt.state_digests(st_a, P)
        ))
        cross_fetches = int(c1.get("mesh.cross_slice_fetches", 0))
        cross_bytes = int(c1.get("mesh.cross_slice_bytes", 0))
        wasted = int(c1.get("net.psnap_wasted", 0))
        shard_slices = int(a.metrics.counters.get("mesh.shard_digest_slices", 0))
        del st_b

        # Microbench: the reduce on the placed, row-divergent state (the
        # boundary reduces above were the warm calls — time steady-state
        # latency, the device synchronized after each call).
        iters = 20
        times = []
        sync()
        t_all0 = time.perf_counter()
        for _ in range(iters):
            t0 = time.perf_counter()
            mesh_reduce.ici_reduce(dense, plan, st_a)
            sync()
            times.append((time.perf_counter() - t0) * 1000.0)
        elapsed = time.perf_counter() - t_all0
        elems = sum(int(leaf.numel()) for leaf in leaves(st_a))
        stages = max(1, math.ceil(math.log2(plan.n_dc)))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    if ratio < MIN_RATIO:
        bad.append("phase_a_partial_ge_5x_smaller")
    if not repair_identical:
        bad.append("phase_a_repair_digests_bit_identical")
    if cross_fetches <= 0 or cross_bytes <= 0:
        bad.append("phase_a_cross_slice_counters_lit")
    if wasted != 0:
        bad.append("phase_a_no_wasted_psnaps")
    if shard_slices < plan.n_key:
        bad.append("phase_a_anchor_published_per_shard")

    report.update({
        "mesh": {"n_dc": plan.n_dc, "n_key": plan.n_key},
        "p_star": p_star,
        "p_star_ids": int(len(ids_p)),
        "whole_resync_bytes": whole_bytes,
        "partial_resync_bytes": {
            "psnaps": psnap_bytes, "digests": dig_bytes,
            "total": partial_bytes,
        },
        "bytes_ratio": round(ratio, 3),
        "min_ratio": MIN_RATIO,
        "cross_slice_bytes": cross_bytes,
        "cross_slice_fetches": cross_fetches,
        "shard_digest_slices": shard_slices,
        "ici_reduce_ms_p50": round(sorted(times)[len(times) // 2], 3),
        "mesh_merges_per_sec": round(
            elems * stages * iters / max(elapsed, 1e-9), 1
        ),
    })
    return bad


def _worker_env(root: str, member: str) -> dict:
    """One mesh-sharded worker's environment, zone-labeled by its mesh
    slice, the repository on the path."""
    from antidote_ccrdt_tpu_torch.topo import zones

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    env["CCRDT_MESH"] = "1"
    env[zones.ENV_ZONE] = zones.slice_zone(SLICE_OF[member])
    env["CCRDT_OBS_DIR"] = os.path.join(root, "obs")
    env["CCRDT_METRICS_DIR"] = os.path.join(root, "metrics")
    return env


def worker_args(root: str, member: str, dev: str, shape: str = "demo", report_dir=None,
                hold: bool = False) -> list:
    """One phase-B worker's elastic_demo arguments: JAX's, then the
    port's (the device, its 8 logical devices, the width; a wider one
    with WIDE_WORKER_ARGS)."""
    report = ["--report", os.path.join(report_dir, f"report-{member}.json")] if report_dir else []
    wide = list(WIDE_WORKER_ARGS) if ed.parse_shape(shape) != ed.DEMO else []
    return ["--root", root, "--member", member, "--n-members", str(len(MEMBERS)), "--type", "topk_rmv",
            "--delta", "--partitions", str(P), "--publish-every", "1",
            "--device", dev, "--local", str(N_DEVICES), "--shape", shape, *wide, *report,
            *(["--hold"] if hold else [])]


def _launch(root: str, member: str, dev: str, shape: str, report_dir, hold: bool):
    return subprocess.Popen(
        [sys.executable, "-m", WORKER, *worker_args(root, member, dev, shape, report_dir, hold)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_worker_env(root, member), text=True, cwd=REPO,
    )


def _snap_seq(root: str, member: str):
    """The 8-byte step header of `member`'s published anchor, or None."""
    try:
        with open(os.path.join(root, f"snap-{member}"), "rb") as f:
            hdr = f.read(8)
    except OSError:
        return None
    if len(hdr) != 8:
        return None
    return struct.unpack("<Q", hdr)[0]


def phase_b(report: dict, timeout: float, device=None, report_dir=None, shape: str = "demo",
            hold: bool = False) -> list:
    """The real-process 2-slice fleet with a mid-load SIGKILL, every
    worker on `device` (the card by default; raises without one) with 8
    logical devices, at elastic_demo's width `shape`; with `report_dir`
    each writes its ``--report`` there, with `hold` each holds its first
    kernel calls. Mutates `report`, returns the list of failed check
    names."""
    dev = str(ed.resolve_worker_device(device))
    if report_dir:
        os.makedirs(report_dir, exist_ok=True)
    bad = []
    root = tempfile.mkdtemp(prefix="multichip-b-")
    procs = {m: _launch(root, m, dev, shape, report_dir, hold) for m in MEMBERS}
    try:
        # Kill window: the victim has published mid-load progress (anchors
        # land every 4th publish with --publish-every 1, so seq 4 of 10
        # steps) but the run is far from done.
        kill_seq = None
        deadline = time.time() + timeout
        while time.time() < deadline:
            seq = _snap_seq(root, VICTIM)
            if seq is not None and 3 <= seq < 8:
                kill_seq = seq
                break
            if procs[VICTIM].poll() is not None:
                bad.append("phase_b_victim_alive_at_kill_point")
                break
            time.sleep(0.01)
        if kill_seq is None and not bad:
            bad.append("phase_b_victim_reached_kill_window")
        if not bad:
            procs[VICTIM].kill()  # SIGKILL: no atexit, no flush
            procs[VICTIM].wait()

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

    survivors = [m for m in MEMBERS if m != VICTIM]
    ref = json.loads(json.dumps(ed.reference_digest("topk_rmv", device=dev, geo=ed.parse_shape(shape))))
    finals = {}
    for m in survivors:
        path = os.path.join(root, f"final-{m}.json")
        if not os.path.exists(path):
            bad.append(f"phase_b_final_{m}")
            print(
                f"  {m}: no final (rc={rcs[m]})\n{outs[m][-2000:]}",
                file=sys.stderr,
            )
            continue
        with open(path) as f:
            finals[m] = json.load(f)
        if finals[m]["digest"] != ref:
            bad.append(f"phase_b_digest_{m}")
    if os.path.exists(os.path.join(root, f"final-{VICTIM}.json")):
        bad.append("phase_b_victim_stayed_dead")

    ici_per_worker = {
        m: int(finals.get(m, {}).get("metrics", {}).get("mesh.ici_reduces", 0))
        for m in survivors
    }
    if not all(v > 0 for v in ici_per_worker.values()):
        bad.append("phase_b_every_survivor_ran_ici_reduces")

    # The replay certificate over the SHARDED fleet's flight logs (the killed
    # incarnation's spill included) + the survivors' final digests vs
    # the unsharded sequential reference.
    from antidote_ccrdt_tpu_torch.obs import audit as obs_audit

    # The topk drill digest is a nested list of [id, score] pairs; the
    # certifier's agreement probe compares exact ints, so hand it the
    # canonical-JSON CRC of each observable (same scalarization as
    # scripts/audit_demo.py).
    def _crc(digest) -> int:
        return zlib.crc32(
            json.dumps(digest, sort_keys=True).encode("utf-8")
        )

    cert = obs_audit.certify(
        obs_dir=os.path.join(root, "obs"),
        digests={m: _crc(finals[m]["digest"]) for m in finals},
        reference=_crc(ref),
    )
    if not cert.get("ok"):
        bad.append("phase_b_certificate_verifies")

    report.update({
        "worker_shape": shape,
        "victim": VICTIM,
        "kill_seq": kill_seq,
        "victim_rc": rcs.get(VICTIM),
        "slices": {m: SLICE_OF[m] for m in MEMBERS},
        "zones_reported": {
            m: finals.get(m, {}).get("zone") for m in survivors
        },
        "survivor_ici_reduces": ici_per_worker,
        "survivor_counters": {
            m: {
                k: int(v)
                for k, v in sorted(
                    finals.get(m, {}).get("metrics", {}).items()
                )
                if k.startswith("mesh.")
            }
            for m in survivors
        },
        "certifier_checks": cert.get("checks", {}),
    })
    if not bad:
        shutil.rmtree(root, ignore_errors=True)
    else:
        report["phase_b_root"] = root
    return bad


def checks_of(failed: list) -> dict:
    """The report's named checks from the failures of both phases."""
    return {
        "partial_ge_5x_smaller": "phase_a_partial_ge_5x_smaller" not in failed,
        "repair_digests_bit_identical": (
            "phase_a_repair_digests_bit_identical" not in failed
        ),
        "shard_local_slices_only": all(
            f not in failed
            for f in ("phase_a_cross_slice_counters_lit",
                      "phase_a_no_wasted_psnaps",
                      "phase_a_anchor_published_per_shard")
        ),
        "survivors_match_sequential_reference": not any(
            f.startswith("phase_b_digest") or f.startswith("phase_b_final")
            for f in failed
        ),
        "every_survivor_ran_ici_reduces": (
            "phase_b_every_survivor_ran_ici_reduces" not in failed
        ),
        "certificate_verifies": "phase_b_certificate_verifies" not in failed,
        "kill_landed_mid_load": not any(
            f in failed
            for f in ("phase_b_victim_alive_at_kill_point",
                      "phase_b_victim_reached_kill_window")
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="MULTICHIP_torch_r01.json",
                    help="the report (default: MULTICHIP_torch_r01.json in the current directory)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="both phases' width: demo, main or R,I,B,BR,M,K")
    ap.add_argument("--report-dir", default="", help="phase B's workers write their --report files here")
    args = ap.parse_args(argv)

    dev = ed.resolve_worker_device(args.device)  # raises without a card unless --device cpu
    geo = pd.parse_shape(args.shape)
    report = {
        "drill": "multichip_demo",
        "n_devices": N_DEVICES,
        "geometry": {
            "R": geo.R, "NK": geo.NK, "I": geo.I, "DCS": geo.DCS, "K": geo.K,
            "M": geo.M, "B": geo.B, "Br": geo.Br,
        },
        "partitions": P,
    }
    t0 = time.time()
    failed = phase_a(report, dev, geo)
    print(
        f"phase A: {report['bytes_ratio']:.1f}x fewer anti-entropy bytes "
        f"({report['partial_resync_bytes']['total']} vs "
        f"{report['whole_resync_bytes']} whole), ici p50 "
        f"{report['ici_reduce_ms_p50']}ms"
    )
    failed += phase_b(report, args.timeout, dev, args.report_dir or None, args.shape)
    report["storm_s"] = round(time.time() - t0, 3)

    report["checks"] = checks_of(failed)
    report["pass"] = report["ok"] = not failed
    report["rc"] = 0 if not failed else 1
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps(report, indent=2, sort_keys=True))
    if failed:
        print(f"FAIL: {', '.join(sorted(set(failed)))}", file=sys.stderr)
        return 1
    print(
        f"PASS: mesh-sharded fleet survived a mid-load SIGKILL of "
        f"{VICTIM} (2 slices, seq {report['kill_seq']}), converged "
        f"bit-identically, certificate ok; shard-local anti-entropy "
        f"{report['bytes_ratio']:.1f}x smaller than whole-instance"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
