"""Partition-plane acceptance drill (core/partition.py tentpole gate).

Three workers gossip the topk_rmv grid over real TCP sockets
(net/tcp.py) with the partition plane on: every full anchor publishes
the P+1-entry digest vector plus per-partition psnaps, and every gap
repair goes through `PartialAntiEntropy` (parallel/elastic.py).

The drill manufactures exactly ONE divergent partition: during an
outage window, worker w2 stops gossiping (publish + sweep) while every
replica's ops are confined to ids that hash into a single partition
`p*`. When w2 comes back its delta chains have been pruned, so the
classic path would pull each peer's WHOLE snapshot; the partition path
compares digest vectors, sees divergence only on {p*, meta}, and
fetches just those psnaps.

Both repairs are run on the same pre-resync state and compared:

* bytes:  whole-instance snapshot blobs vs digest vector + fetched
  psnaps — the gate requires the partial path to move >= 5x fewer
  bytes;
* result: the post-repair per-partition digest vectors must be
  BIT-IDENTICAL between the two paths (partial resync is a pure
  bandwidth optimization, never a semantic one);
* fleet:  after the remaining steps + a convergence tail, all three
  workers' digest vectors agree and the observable top-k matches the
  sequential single-process reference bit-for-bit.

Port of ``scripts/partition_demo.py``: the same drill, gates, report,
printed text and exit codes over this package's engine, partition plane,
``TcpTransport`` and ``PartialAntiEntropy``::

    python -m antidote_ccrdt_tpu_torch.scripts.partition_demo [--partitions P] [--out FILE]
        [--device cpu|cuda] [--shape demo|main|R,I,B,BR,M,K] [--send-timeout S]

Options of the port only:

* ``--device`` (default: the card; without one it raises) holds the
  engine, every state and every op batch.
* ``--shape``: ``demo`` (default) is the JAX drill's geometry (R = D = 4,
  256 ids, K = 8, M = 2, 32 adds and 8 removals a replica and step);
  ``main`` the main path's (R = D = 32, 100 000 ids, K = 100, M = 4,
  32 768 adds and 2 048 removals), whose 563 MB anchor is past the
  frame limit over TCP; ``R,I,B,BR,M,K`` is the same uniform draw at
  another width, with D = R. Replica r belongs to member ``r % 3``: at R = 4 that is the
  JAX drill's map (w0: 0 and 3, w1: 1, w2: 2), and at any R every replica
  has an owner, so the fleet computes what the sequential reference does.
* ``--send-timeout``: the ``TcpTransport`` send timeout (2.0 s, the
  transport's default, as the JAX drill uses); a 225 MB anchor at
  40 000 ids needs more.

The report goes to ``--out`` (default ``PART_torch_r01.json`` in the
current directory), never to the committed ``PART_r01.json``.
`run_drill` is the drill without the CLI: it returns the report (its
``steps`` shortens the steps after the outage).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.scripts.elastic_demo import Geometry  # noqa: E402

# Drill geometry. I is deliberately larger than elastic_demo's so one
# partition holds a meaningful slice (~I/P ids) and the byte comparison
# is not dominated by fixed per-blob overheads.
R, NK, I, DCS, K, M, B, Br = 4, 1, 256, 4, 8, 2, 32, 8
DEMO = Geometry(R, NK, I, DCS, K, M, B, Br, False)
# The main path's width (bench.py main()) with the drill's uniform ids.
MAIN = Geometry(32, 1, 100_000, 32, 100, 4, 32_768, 2_048, False)
STEPS = 12
# Steps in [OUTAGE_LO, OUTAGE_HI): w2 neither publishes nor sweeps, and
# every replica's ops touch only ids from partition p* — the window
# that manufactures the single divergent partition.
OUTAGE_LO, OUTAGE_HI = 4, 9

MIN_RATIO = 5.0  # the gate: the partial repair moves at least 5x fewer bytes

MEMBERS = ("w0", "w1", "w2")
SEND_TIMEOUT = 2.0  # TcpTransport's own default
# The entries of the report's `counters_w2` that hang on thread timing: a
# sweep of the tail that runs before a peer's digest or psnap reply has
# landed fetches, asks and is served once more. Two runs of one drill may
# differ in these and in nothing else.
TIMING_COUNTERS = ("net.dig_fetches", "net.psnap_bytes", "net.psnap_fetches", "net.psnap_reqs_recv",
                   "net.psnap_reqs_sent", "net.psnap_serves")


class DrillError(RuntimeError):
    """The drill could not reach its gates (a barrier, a fetch or a
    resync failed); the message is the JAX drill's FAIL text."""


def parse_shape(text: str) -> Geometry:
    """``demo``, ``main`` or ``R,I,B,BR,M,K`` (D = R, one key, uniform ids)."""
    if text in ("", "demo"):
        return DEMO
    if text == "main":
        return MAIN
    r, ids, b, br, m, k = (int(x) for x in text.split(","))
    return Geometry(r, 1, ids, r, k, m, b, br, False)


def owned_replicas(n_replicas: int) -> dict:
    """Replica r belongs to member ``r % 3`` (at R = 4 the JAX drill's
    ``{"w0": [0, 3], "w1": [1], "w2": [2]}``)."""
    return {m: [r for r in range(n_replicas) if r % len(MEMBERS) == i] for i, m in enumerate(MEMBERS)}


def gen_ops(geo: Geometry, step: int, owned, pool, device):
    """Deterministic [R, ...] batch like elastic_demo's drill, except
    add/rmv ids are drawn from `pool` (all ids normally, the single
    partition p*'s ids inside the outage window). Drawn with numpy as the
    JAX drill draws them (replicas outside `owned` are padding), then each
    column moved to `device` once."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

    pool = np.asarray(pool, np.int32)
    g = geo
    cols = dict(
        add_key=np.zeros((g.R, g.B), np.int32), add_id=np.zeros((g.R, g.B), np.int32),
        add_score=np.zeros((g.R, g.B), np.int32), add_dc=np.zeros((g.R, g.B), np.int32),
        add_ts=np.zeros((g.R, g.B), np.int32), rmv_key=np.zeros((g.R, g.Br), np.int32),
        rmv_id=np.full((g.R, g.Br), -1, np.int32), rmv_vc=np.zeros((g.R, g.Br, g.DCS), np.int32),
    )
    for r in sorted(set(owned)):  # each replica's draws are its own stream
        rng = np.random.default_rng(77_000 * (step + 1) + r)
        cols["add_id"][r] = pool[rng.integers(0, len(pool), g.B)]
        cols["add_score"][r] = rng.integers(1, 500, g.B)
        cols["add_dc"][r] = r % g.DCS
        cols["add_ts"][r] = step * g.B + np.arange(g.B) + 1
        cols["rmv_id"][r] = pool[rng.integers(0, len(pool), g.Br)]
        cols["rmv_vc"][r, :, r % g.DCS] = rng.integers(1, max(2, step * g.B + 1), g.Br)
    return convert.from_numpy(TopkRmvOps, cols, device)


def step_pool(geo: Geometry, step: int, ids_p):
    import numpy as np

    if OUTAGE_LO <= step < OUTAGE_HI:
        return ids_p
    return np.arange(geo.I, dtype=np.int32)


def apply_step(dense, geo: Geometry, state, step: int, owned, ids_p, device):
    state, _ = dense.apply_ops(
        state, gen_ops(geo, step, owned, step_pool(geo, step, ids_p), device),
        collect_dominated=False,
    )
    return state


def observable(dense, geo: Geometry, state):
    from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows

    obs = dense.value(fold_rows(dense, state, range(geo.R)))[0][0]
    return sorted((int(i), int(s)) for (i, s) in obs)


def sequential_reference(dense, geo: Geometry, ids_p, device, steps: int = STEPS):
    state = dense.init(geo.R, geo.NK)
    for step in range(steps):
        state = apply_step(dense, geo, state, step, range(geo.R), ids_p, device)
    return observable(dense, geo, state)


def run_drill(device=None, geo: Geometry = DEMO, partitions: int = 8, send_timeout: float = SEND_TIMEOUT,
              steps: int = STEPS) -> dict:
    """The drill on `device` (the card by default; raises without one) at
    width `geo` with `partitions` partitions over `steps` steps (at least
    OUTAGE_HI; the JAX drill's 12 by default): the JAX drill's report
    (`checks`, `pass`). Raises `DrillError` where the JAX drill prints a
    FAIL line and exits 1 before its gates."""
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import on_device, resolve_worker_device

    if steps < OUTAGE_HI:
        raise ValueError(f"the drill needs at least {OUTAGE_HI} steps, not {steps}")
    dev = resolve_worker_device(device)
    with on_device(dev):
        return _drill(dev, geo, partitions, send_timeout, steps)


def _drill(dev, geo: Geometry, P: int, send_timeout: float, steps: int) -> dict:
    import numpy as np

    from antidote_ccrdt_tpu_torch.core import partition as pt
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.parallel.elastic import (
        DeltaPublisher, PartialAntiEntropy, sweep_deltas,
    )

    g = geo
    dense = make_dense(n_ids=g.I, n_dcs=g.DCS, size=g.K, slots_per_id=g.M, device=dev)

    # Pick p* = the best-populated partition; its id roster is the op
    # pool inside the outage window.
    part_map = pt.part_of(np.arange(g.I), P)
    p_star = int(np.bincount(part_map, minlength=P).argmax())
    ids_p = np.arange(g.I, dtype=np.int32)[part_map == p_star]
    meta = pt.meta_part(P)

    members = list(MEMBERS)
    owned = owned_replicas(g.R)
    transports = {m: TcpTransport(m, send_timeout=send_timeout) for m in members}
    try:
        for m in members:
            for n in members:
                if n != m:
                    transports[m].add_peer(n, transports[n].address)
        stores = {m: GossipNode(transports[m]) for m in members}
        pubs = {
            m: DeltaPublisher(
                stores[m], dense, name="topk_rmv",
                full_every=2, keep=2, partitions=P,
            )
            for m in members
        }
        partials = {
            m: PartialAntiEntropy(stores[m], partitions=P, max_tries=12)
            for m in members
        }
        states = {m: dense.init(g.R, g.NK) for m in members}
        cursors = {m: {} for m in members}

        # Start barrier: TCP membership is heard-from evidence.
        deadline = time.time() + 10.0
        while any(len(stores[m].members()) < len(members) for m in members):
            for m in members:
                stores[m].heartbeat()
            if time.time() > deadline:
                raise DrillError("start barrier timed out")
            time.sleep(0.05)

        def round_of(step, fleet):
            for m in fleet:
                stores[m].heartbeat()
                pubs[m].publish(states[m])
            time.sleep(0.06)
            for m in fleet:
                states[m], _ = sweep_deltas(
                    stores[m], dense, states[m], cursors[m],
                    partial=partials[m],
                )

        # Phase 1: steps up to the end of the outage. w2 applies its own
        # ops every step (it is slow, not dead) but stops gossiping.
        for step in range(OUTAGE_HI):
            for m in members:
                states[m] = apply_step(dense, g, states[m], step, owned[m], ids_p, dev)
            fleet = members if step < OUTAGE_LO else ["w0", "w1"]
            round_of(step, fleet)

        # Phase 2: the resync moment. w2's delta chains were pruned
        # (keep=2), so both repair paths start from the same gap. Run the
        # whole-instance repair on a clone for the byte/digest baseline,
        # then the partial repair on the live state.
        pre_state = states["w2"]
        peers = ["w0", "w1"]

        whole_bytes = 0
        whole_state = pre_state
        for m in peers:
            raw = transports["w2"].fetch(m)
            if raw is None:
                raise DrillError(f"no snapshot from {m} at resync")
            whole_bytes += len(raw)
            del raw
            got = stores["w2"].fetch(m, pre_state, dense=dense)
            if got is None:
                raise DrillError(f"snapshot from {m} undecodable")
            whole_state = dense.merge(whole_state, got[1])

        c0 = dict(stores["w2"].metrics.counters)
        dig_bytes = 0
        div_seen = set()
        part_state = pre_state
        for m in peers:
            raw = transports["w2"].fetch_digest(m)
            if raw is not None:
                dig_bytes += len(raw)
            got = stores["w2"].fetch_digests(m)
            if got is not None:
                div_seen.update(
                    int(p) for p in pt.divergent_parts(
                        pt.state_digests(part_state, P), got[1]
                    )
                )
            cur = cursors["w2"].get(m, -1)
            for _ in range(40):
                part_state, cur2, handled = partials["w2"].try_resync(
                    m, dense, part_state, cur
                )
                if not handled:
                    raise DrillError(f"partial resync fell back to full snap ({m})")
                if cur2 > cur:
                    cur = cur2
                    break
                time.sleep(0.05)  # psnap replies in flight
            else:
                raise DrillError(f"partial resync stalled ({m})")
            cursors["w2"][m] = cur
        c1 = dict(stores["w2"].metrics.counters)
        psnap_bytes = int(c1.get("net.psnap_bytes", 0) - c0.get("net.psnap_bytes", 0))
        partial_bytes = psnap_bytes + dig_bytes
        resyncs = int(
            c1.get("net.partition_resyncs", 0) - c0.get("net.partition_resyncs", 0)
        )
        wasted = int(c1.get("net.psnap_wasted", 0))

        vec_whole = pt.state_digests(whole_state, P)
        vec_part = pt.state_digests(part_state, P)
        repair_identical = bool(np.array_equal(vec_whole, vec_part))
        del whole_state
        states["w2"] = part_state

        # Phase 3: remaining steps with everyone gossiping, then a
        # convergence tail until the digest vectors agree fleet-wide.
        for step in range(OUTAGE_HI, steps):
            for m in members:
                states[m] = apply_step(dense, g, states[m], step, owned[m], ids_p, dev)
            round_of(step, members)
        agree = False
        for _ in range(80):
            vecs = [pt.state_digests(states[m], P) for m in members]
            if all(np.array_equal(vecs[0], v) for v in vecs[1:]):
                agree = True
                break
            round_of(steps, members)

        ref = sequential_reference(dense, g, ids_p, dev, steps)
        finals = {m: observable(dense, g, states[m]) for m in members}
        ref_match = all(finals[m] == ref for m in members)
        ratio = whole_bytes / max(1, partial_bytes)

        checks = {
            "partial_ge_5x_smaller": ratio >= MIN_RATIO,
            "repair_digests_bit_identical": repair_identical,
            "fleet_digest_vectors_agree": agree,
            "matches_sequential_reference": ref_match,
            "divergence_confined_to_pstar_meta": div_seen <= {p_star, meta}
            and p_star in div_seen,
            "partition_resyncs_counted": resyncs >= 1,
            "no_wasted_psnaps": wasted == 0,
        }
        return {
            "drill": "partition_demo",
            "geometry": {
                "R": g.R, "NK": g.NK, "I": g.I, "DCS": g.DCS, "K": g.K, "M": g.M,
                "B": g.B, "Br": g.Br, "steps": steps,
            },
            "partitions": P,
            "p_star": p_star,
            "p_star_ids": int(len(ids_p)),
            "outage_steps": [OUTAGE_LO, OUTAGE_HI],
            "divergent_parts": sorted(div_seen),
            "whole_resync_bytes": whole_bytes,
            "partial_resync_bytes": {
                "psnaps": psnap_bytes, "digests": dig_bytes,
                "total": partial_bytes,
            },
            "bytes_ratio": round(ratio, 3),
            "min_ratio": MIN_RATIO,
            "counters_w2": {
                k: int(v)
                for k, v in sorted(stores["w2"].metrics.counters.items())
                if k.startswith(("net.psnap", "net.partition", "net.dig"))
            },
            "checks": checks,
            "pass": all(checks.values()),
        }
    finally:
        for t in transports.values():
            t.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--out", default="PART_torch_r01.json",
                    help="the report (default: PART_torch_r01.json in the current directory)")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="the drill's width: demo, main or R,I,B,BR,M,K (D = R)")
    ap.add_argument("--send-timeout", type=float, default=SEND_TIMEOUT,
                    help="the TCP transports' send timeout in seconds")
    args = ap.parse_args(argv)

    try:
        report = run_drill(args.device, parse_shape(args.shape), args.partitions, args.send_timeout)
    except DrillError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=2, sort_keys=True)
        fh.write("\n")
    print(json.dumps(report, indent=2, sort_keys=True))
    checks = report["checks"]
    if not report["pass"]:
        failed = [k for k, ok in checks.items() if not ok]
        print(f"FAIL: {', '.join(failed)}", file=sys.stderr)
        return 1
    partial_bytes = report["partial_resync_bytes"]["total"]
    whole_bytes = report["whole_resync_bytes"]
    ratio = whole_bytes / max(1, partial_bytes)
    print(
        f"PASS: partial anti-entropy moved {partial_bytes} bytes vs "
        f"{whole_bytes} whole-instance ({ratio:.1f}x reduction), "
        f"digests bit-identical"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
