"""Request-trace CLI over the rtrace plane (obs/rtrace.py).

Three subcommands over a finished run's obs spill dir (the
``flight-*.jsonl`` streams every worker and client drops on exit —
each committed trace rides a ``rtrace.trace`` event verbatim)::

    # Render one request's waterfall: every client hop (route decision,
    # attempt launch->settle, backoff, ack probe) and every server
    # stage (enqueue->drain->kernel fold / stage->fold->durable) as
    # ordered [t0_ms, t1_ms] segments on the request's own timeline.
    # Picks the slowest stored trace unless --trace names one.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_rtrace waterfall /path/to/obs-dir \
        --trace w0-1a2b-3

    # Fleet-level tail attribution: decompose completed requests into
    # route / backoff / wire / queue_wait / kernel / ack_probe /
    # hedge_overlap milliseconds at p50 and p99, and name the p99
    # request's dominant bucket — "where did the tail go".
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_rtrace attribute /path/to/obs-dir --json

    # The N slowest stored traces (slow ring + sampled commits), one
    # line each: id, kind, outcome, total ms, hop count, completeness.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_rtrace slowest /path/to/obs-dir -n 10

Offline scans have no live ClockSync, so server stages are anchored on
each attempt's midpoint (the same fallback the in-process waterfall
uses before the first offset sample); client-side hops are exact.

Port of ``scripts/ccrdt_rtrace.py`` over the port's ``obs/rtrace.py``: the
same subcommands, flags, printed text and exit codes. The traces ride the
``flight-*.jsonl`` spills (``CCRDT_OBS_DIR``) of processes run with
``CCRDT_RTRACE`` set; no device is touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import rtrace  # noqa: E402


def _load(obs_dir: str) -> List[Dict[str, Any]]:
    trs = rtrace.scan_traces(obs_dir)
    if not trs:
        print(f"no stored traces under {obs_dir}", file=sys.stderr)
        raise SystemExit(1)
    # One request can commit on the client AND spill through a slow
    # ring re-emit; keep the last doc per id (most hops absorbed).
    by_id: Dict[str, Dict[str, Any]] = {}
    for t in trs:
        by_id[str(t.get("id"))] = t
    return list(by_id.values())


def _fmt_waterfall(tr: Dict[str, Any]) -> str:
    rows = rtrace.waterfall(tr, offs={})
    ok, why = rtrace.complete(tr)
    end = max((r["t1_ms"] for r in rows), default=0.0)
    span = max(end, float(tr.get("ms", 0.0)), 1e-9)
    width = 40
    lines = [
        f"trace {tr.get('id')}  kind={tr.get('kind')} "
        f"key={tr.get('key')!r} outcome={tr.get('outcome')} "
        f"total={float(tr.get('ms', 0.0)):.3f}ms "
        f"{'complete' if ok else 'INCOMPLETE: ' + why}"
    ]
    for r in rows:
        a, b = r["t0_ms"], r["t1_ms"]
        lo = max(0, min(width - 1, int(a / span * width)))
        hi = max(lo + 1, min(width, int(b / span * width) + 1))
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        extra = " ".join(
            f"{k}={v}" for k, v in r.items()
            if k not in ("name", "t0_ms", "t1_ms") and not isinstance(
                v, (list, dict))
        )
        lines.append(
            f"  {r['name']:<12} |{bar}| {a:>9.3f} -> {b:>9.3f}ms  {extra}"
        )
    return "\n".join(lines)


def cmd_waterfall(args: argparse.Namespace) -> int:
    trs = _load(args.obs_dir)
    if args.trace:
        match = [t for t in trs if t.get("id") == args.trace]
        if not match:
            print(f"trace {args.trace!r} not found "
                  f"({len(trs)} stored)", file=sys.stderr)
            return 1
        tr = match[0]
    else:
        tr = max(trs, key=lambda t: float(t.get("ms", 0.0)))
    if args.json:
        print(rtrace.to_json(
            {"trace": tr, "waterfall": rtrace.waterfall(tr, offs={})}
        ))
    else:
        print(_fmt_waterfall(tr))
    return 0


def cmd_attribute(args: argparse.Namespace) -> int:
    trs = _load(args.obs_dir)
    rep = rtrace.attribution_report(trs, offs={})
    if args.json:
        print(rtrace.to_json(rep))
    else:
        print(rtrace.format_report(rep))
    return 0


def cmd_slowest(args: argparse.Namespace) -> int:
    trs = _load(args.obs_dir)
    trs.sort(key=lambda t: float(t.get("ms", 0.0)), reverse=True)
    picked = trs[: args.n]
    if args.json:
        print(json.dumps(picked, indent=2))
        return 0
    for t in picked:
        ok, why = rtrace.complete(t)
        attr = rtrace.attribute(t, offs={})
        dom = max(
            (b for b in rtrace.BUCKETS if b != "hedge_overlap"),
            key=lambda b: attr.get(b, 0.0),
        )
        print(
            f"{float(t.get('ms', 0.0)):>10.3f}ms  {t.get('id'):<24} "
            f"{t.get('kind'):<5} {str(t.get('outcome')):<9} "
            f"hops={len(t.get('hops', ()))} "
            f"dominant={dom}:{attr.get(dom, 0.0):.3f}ms "
            f"{'' if ok else '[incomplete: ' + why + ']'}"
        )
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ccrdt_rtrace", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("waterfall", help="render one request's waterfall")
    p.add_argument("obs_dir")
    p.add_argument("--trace", help="trace id (default: the slowest)")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_waterfall)

    p = sub.add_parser("attribute", help="fleet tail-attribution report")
    p.add_argument("obs_dir")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_attribute)

    p = sub.add_parser("slowest", help="the N slowest stored traces")
    p.add_argument("obs_dir")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_slowest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
