"""Trace query CLI over a fleet's flight-recorder logs.

`obs.events.delta_paths` groups every delta trace event by its
(origin, dseq) context; this tool turns that raw grouping into the
questions an operator actually asks of a ``CCRDT_OBS_DIR`` full of
``flight-*.jsonl`` spills::

    # Fleet-wide overview: deltas seen, complete paths, never-applied
    # deltas, p50/p99 propagation latency per origin->applier pair.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_trace summary /path/to/obs-dir

    # One delta's full journey, hop by hop, with per-hop latency:
    # publish -> send/write -> recv/fetch -> apply on each peer.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_trace path /path/to/obs-dir w0 3

    # Deltas whose propagation took >= factor x the fleet median.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_trace stragglers /path/to/obs-dir --factor 3

    # Causal-order audit: per (process incarnation, origin), delta.apply
    # dseqs must advance contiguously from the first-seen baseline, with
    # snap.apply the only legitimate jump. A gap-skip or double-apply
    # here means the sweep cursor machinery broke.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_trace audit /path/to/obs-dir

`summary` and `stragglers` take ``--json`` for machine-readable output
(the obs-demo and tests consume it).

Exit codes: 0 on success; `summary --require-complete` exits 1 when no
delta shows a complete publish->apply path (the obs-demo smoke gate);
`path` exits 1 when the requested delta left no events; `audit` exits 1
on any ordering violation.

All timestamps are the emitting process's wall clock (`time.time()`),
so cross-host latencies inherit clock skew — on one box (the drills)
they are exact; across hosts read them as approximate.

Port of ``scripts/ccrdt_trace.py``: the same subcommands, flags, printed
text and exit codes over the port's ``obs/events.py`` and
``obs/audit.py::audit_apply_order``. It reads the flight logs a fleet of
either package writes (``CCRDT_OBS_DIR``) and touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import events as obs_events  # noqa: E402
from antidote_ccrdt_tpu_torch.obs.audit import audit_apply_order  # noqa: E402,F401
# audit_apply_order moved to obs/audit.py (the certifier reuses it);
# re-exported here because `audit` below and the trace-CLI tests call it
# under this module's name. obs.audit stays stdlib-only at import time.

# Display order of a delta's lifecycle stages (fs medium uses write/
# fetch, tcp uses send/recv — a path holds whichever its medium emitted;
# relay = a topo/ zone anchor forwarding a routed frame across/inside a
# zone, so hierarchical paths read leaf -> anchor -> anchor -> leaf).
STAGE_ORDER = ("publish", "write", "send", "recv", "relay", "fetch", "apply")


def load_paths(obs_dir: str) -> Dict[tuple, Dict[str, List[Dict[str, Any]]]]:
    """{(origin, dseq): {stage: [events]}} for every flight log in a dir."""
    return obs_events.delta_paths(obs_events.scan_dir(obs_dir))


def fleet_members(obs_dir: str) -> List[str]:
    """Every member that wrote at least one flight event."""
    out = set()
    for evs in obs_events.scan_dir(obs_dir).values():
        for ev in evs:
            m = ev.get("member")
            if m:
                out.add(str(m))
    return sorted(out)


def path_timeline(
    stages: Dict[str, List[Dict[str, Any]]]
) -> List[Dict[str, Any]]:
    """One delta's events as a single time-ordered hop list. Each entry
    carries stage/member/t plus `hop_ms` (latency since the previous
    hop) and `total_ms` (since publish, when a publish exists)."""
    evs: List[Tuple[float, str, Dict[str, Any]]] = []
    for stage in STAGE_ORDER:
        for ev in stages.get(stage, []):
            evs.append((float(ev.get("t", 0.0)), stage, ev))
    evs.sort(key=lambda e: (e[0], STAGE_ORDER.index(e[1])))
    t_pub: Optional[float] = None
    if stages.get("publish"):
        t_pub = min(float(e.get("t", 0.0)) for e in stages["publish"])
    out: List[Dict[str, Any]] = []
    prev_t: Optional[float] = None
    for t, stage, ev in evs:
        out.append(
            {
                "stage": stage,
                "member": str(ev.get("member", "?")),
                "t": t,
                "hop_ms": None if prev_t is None else (t - prev_t) * 1e3,
                "total_ms": None if t_pub is None else (t - t_pub) * 1e3,
                "bytes": ev.get("bytes"),
            }
        )
        prev_t = t
    return out


def is_complete(stages: Dict[str, List[Dict[str, Any]]]) -> bool:
    """Complete = the delta was published AND applied somewhere else."""
    return bool(stages.get("publish")) and bool(stages.get("apply"))


def apply_latencies(
    paths: Dict[tuple, Dict[str, List[Dict[str, Any]]]]
) -> List[Dict[str, Any]]:
    """One row per (delta, applier): publish->apply propagation latency.
    Deltas without a publish event (foreign/pre-spill) are skipped."""
    rows: List[Dict[str, Any]] = []
    for (origin, dseq), stages in sorted(paths.items()):
        if not stages.get("publish"):
            continue
        t_pub = min(float(e.get("t", 0.0)) for e in stages["publish"])
        for ev in stages.get("apply", []):
            rows.append(
                {
                    "origin": str(origin),
                    "dseq": int(dseq),
                    "applier": str(ev.get("member", "?")),
                    "latency_ms": (float(ev.get("t", 0.0)) - t_pub) * 1e3,
                }
            )
    return rows


def _pctl(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[int(i)]


def pair_stats(
    rows: List[Dict[str, Any]]
) -> Dict[Tuple[str, str], Dict[str, float]]:
    """{(origin, applier): {n, p50_ms, p99_ms, max_ms}} propagation
    latency per peer-pair."""
    by_pair: Dict[Tuple[str, str], List[float]] = {}
    for r in rows:
        by_pair.setdefault((r["origin"], r["applier"]), []).append(
            r["latency_ms"]
        )
    out: Dict[Tuple[str, str], Dict[str, float]] = {}
    for pair, vals in sorted(by_pair.items()):
        vals.sort()
        out[pair] = {
            "n": float(len(vals)),
            "p50_ms": _pctl(vals, 0.50),
            "p99_ms": _pctl(vals, 0.99),
            "max_ms": vals[-1],
        }
    return out


def never_applied(
    paths: Dict[tuple, Dict[str, List[Dict[str, Any]]]]
) -> List[tuple]:
    """Published deltas with NO apply event anywhere — lost on the wire,
    stuck behind a gap, or pruned before any peer chained them."""
    return sorted(
        key
        for key, stages in paths.items()
        if stages.get("publish") and not stages.get("apply")
    )


def find_stragglers(
    rows: List[Dict[str, Any]], factor: float = 3.0
) -> Tuple[float, List[Dict[str, Any]]]:
    """(fleet median latency, rows at >= factor x that median). With
    fewer than 2 applies there is no meaningful baseline: no stragglers."""
    if len(rows) < 2:
        return 0.0, []
    vals = sorted(r["latency_ms"] for r in rows)
    med = _pctl(vals, 0.50)
    if med <= 0:
        return med, []
    return med, [r for r in rows if r["latency_ms"] >= factor * med]


# -- rendering ---------------------------------------------------------------


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:9.3f}ms"


def cmd_summary(args: argparse.Namespace) -> int:
    paths = load_paths(args.obs_dir)
    if not paths:
        if args.json:
            print(json.dumps({"deltas_traced": 0, "complete_paths": 0}))
        else:
            print(f"no delta trace events under {args.obs_dir}")
        return 1 if args.require_complete else 0
    complete = sorted(k for k, st in paths.items() if is_complete(st))
    rows = apply_latencies(paths)
    lost = never_applied(paths)
    if args.json:
        doc = {
            "deltas_traced": len(paths),
            "complete_paths": len(complete),
            "apply_samples": len(rows),
            "never_applied": [[o, d] for o, d in lost],
            "pairs": {
                f"{o}->{a}": s for (o, a), s in pair_stats(rows).items()
            },
        }
        print(json.dumps(doc))
        if args.require_complete and not complete:
            return 1
        return 0
    print(f"deltas traced   : {len(paths)}")
    print(f"complete paths  : {len(complete)} (publish -> apply)")
    print(f"apply samples   : {len(rows)}")
    print(f"never applied   : {len(lost)}"
          + (f"  {lost[:8]}" if lost else ""))
    # topo/ hierarchy: anchor relays and the hop depth of routed frames
    # (a flat mesh shows zero relays and no hop stamps).
    relays = [e for st in paths.values() for e in st.get("relay", [])]
    if relays:
        cross = sum(1 for e in relays if e.get("cross_zone"))
        hops = sorted(
            int(e["hops"])
            for st in paths.values()
            for e in st.get("recv", [])
            if e.get("hops") is not None
        )
        print(f"anchor relays   : {len(relays)} ({cross} cross-zone)")
        if hops:
            print(f"routed hop depth: max={hops[-1]} "
                  f"p50={hops[len(hops) // 2]} over {len(hops)} frames")
    stats = pair_stats(rows)
    if stats:
        print("propagation latency per origin->applier pair:")
        for (origin, applier), s in stats.items():
            print(
                f"  {origin:>8} -> {applier:<8} n={int(s['n']):<4} "
                f"p50={_fmt_ms(s['p50_ms'])} p99={_fmt_ms(s['p99_ms'])} "
                f"max={_fmt_ms(s['max_ms'])}"
            )
    if complete:
        origin, dseq = complete[0]
        print(f"example complete path: {origin}/{dseq} "
              f"(ccrdt_trace.py path {args.obs_dir} {origin} {dseq})")
    if args.require_complete and not complete:
        print("FAIL: no delta shows a complete publish->apply path")
        return 1
    return 0


def cmd_path(args: argparse.Namespace) -> int:
    paths = load_paths(args.obs_dir)
    key = (args.origin, args.dseq)
    stages = paths.get(key)
    if not stages:
        print(f"no events for delta {args.origin}/{args.dseq}")
        return 1
    print(f"delta {args.origin}/{args.dseq}:")
    for hop in path_timeline(stages):
        extra = f" bytes={hop['bytes']}" if hop.get("bytes") else ""
        print(
            f"  t={hop['t']:.6f} {hop['stage']:>7} @ {hop['member']:<8} "
            f"hop={_fmt_ms(hop['hop_ms'])} total={_fmt_ms(hop['total_ms'])}"
            f"{extra}"
        )
    if not is_complete(stages):
        print("  (path incomplete: no apply event recorded)")
    return 0


def cmd_stragglers(args: argparse.Namespace) -> int:
    rows = apply_latencies(load_paths(args.obs_dir))
    med, slow = find_stragglers(rows, factor=args.factor)
    if args.json:
        print(json.dumps(
            {
                "apply_samples": len(rows),
                "median_ms": med,
                "factor": args.factor,
                "stragglers": slow,
            }
        ))
        return 0
    print(f"apply samples: {len(rows)}, fleet median {med:.3f}ms, "
          f"threshold {args.factor:g}x")
    if not slow:
        print("no stragglers")
        return 0
    for r in slow:
        print(
            f"  {r['origin']}/{r['dseq']} -> {r['applier']}: "
            f"{r['latency_ms']:.3f}ms ({r['latency_ms'] / med:.1f}x median)"
        )
    return 0


def cmd_audit(args: argparse.Namespace) -> int:
    logs = obs_events.scan_dir(args.obs_dir)
    n_apply = sum(
        1 for evs in logs.values() for e in evs
        if e.get("kind") == "delta.apply"
    )
    violations = audit_apply_order(logs)
    if args.json:
        print(json.dumps(
            {
                "logs": len(logs),
                "apply_events": n_apply,
                "violations": violations,
            }
        ))
        return 1 if violations else 0
    print(f"audited {n_apply} delta.apply events across {len(logs)} "
          f"flight logs")
    if not violations:
        print("OK: every apply stream is contiguous per (incarnation, "
              "origin) — no gap-skips, no double-applies")
        return 0
    for v in violations:
        print(
            f"  {v['kind']:>12}: {v['applier']} applied {v['origin']}/"
            f"{v['dseq']} after cursor {v['prev_dseq']} "
            f"(seq={v['seq']}, {v['log']})"
        )
    print(f"FAIL: {len(violations)} apply-order violation(s) — the sweep "
          f"cursor machinery broke causal delivery")
    return 1


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="query a fleet's flight-recorder delta traces"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="fleet-wide propagation overview")
    s.add_argument("obs_dir")
    s.add_argument(
        "--require-complete",
        action="store_true",
        help="exit 1 unless at least one complete publish->apply path exists",
    )
    s.add_argument("--json", action="store_true", help="machine-readable")
    s.set_defaults(fn=cmd_summary)

    p = sub.add_parser("path", help="one delta's hop-by-hop journey")
    p.add_argument("obs_dir")
    p.add_argument("origin")
    p.add_argument("dseq", type=int)
    p.set_defaults(fn=cmd_path)

    g = sub.add_parser("stragglers", help="slow applies vs fleet median")
    g.add_argument("obs_dir")
    g.add_argument("--factor", type=float, default=3.0)
    g.add_argument("--json", action="store_true", help="machine-readable")
    g.set_defaults(fn=cmd_stragglers)

    a = sub.add_parser(
        "audit", help="per-origin dseq apply-order audit (exit 1 on violation)"
    )
    a.add_argument("obs_dir")
    a.add_argument("--json", action="store_true", help="machine-readable")
    a.set_defaults(fn=cmd_audit)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
