"""Device-observatory CLI over the devprof plane (obs/devprof.py).

Four subcommands over a finished run's obs spill dir (the
``flight-*.jsonl`` streams every worker drops on exit — each compile
the observatory attributed rides a ``devprof.compile`` event carrying
its site, full abstract signature, and the structural diff vs the
site's previous signature)::

    # Top-N churn sites: compiles, total compile ms, deepest jit
    # cache, and the latest changed axis per site — "who is paying
    # the XLA tax, and which shape axis keeps moving".
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_devprof churn /path/to/obs-dir -n 10

    # One site's shape-growth timeline: every compile in order with
    # its changed axis, compile ms, and cache depth — the recompile
    # storm rendered as the axis walk that caused it.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_devprof timeline /path/to/obs-dir \
        --site batch_merge.fold

    # Device-memory watermark report: live-buffer and pager HBM
    # gauges (vs CCRDT_PAGER_HBM_BUDGET) with high-watermarks, from
    # the workers' final scrape snapshots when present.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_devprof watermarks /path/to/obs-dir

    # Run-vs-run diff of two committed DEVPROF_r*.json carriers:
    # steady-state recompiles, compile-ms share, overhead, and which
    # checks flipped.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_devprof diff DEVPROF_r01.json DEVPROF_r02.json

Port of ``scripts/ccrdt_devprof.py`` over the port's ``obs/events.py``: the
same subcommands, flags, printed text and exit codes. The port has no jit
cache: its "compile" event is a kernel's first load in a process (the
build cache of ``ops/_build.py`` growing inside an observed dispatch,
``obs/devprof.py``), so a compile's ms is that first launch's, a site's
cache depth counts the kernel entry points loaded, and on the CPU, where no
kernel is loaded, a run records no compile and `churn` and `timeline` exit
1. The events ride the workers' ``flight-*.jsonl`` spills (``CCRDT_OBS_DIR``;
the observatory is on unless ``CCRDT_DEVPROF=0``); `watermarks` reads the
``obs-<member>.json`` status drops in a fleet's result directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import events  # noqa: E402


def _compiles(obs_dir: str) -> List[Dict[str, Any]]:
    logs = events.scan_dir(obs_dir)
    out: List[Dict[str, Any]] = []
    for member in sorted(logs):
        for e in logs[member]:
            if e.get("kind") == "devprof.compile":
                e = dict(e)
                e.setdefault("member", member)
                out.append(e)
    if not out:
        print(f"no devprof.compile events under {obs_dir}", file=sys.stderr)
        raise SystemExit(1)
    return out


def _by_site(evs: List[Dict[str, Any]]) -> Dict[str, List[Dict[str, Any]]]:
    sites: Dict[str, List[Dict[str, Any]]] = {}
    for e in evs:
        sites.setdefault(str(e.get("site", "?")), []).append(e)
    return sites


def cmd_churn(args) -> int:
    sites = _by_site(_compiles(args.obs_dir))
    rows = []
    for site, evs in sites.items():
        ms = sum(float(e.get("ms", 0.0)) for e in evs)
        depth = max(int(e.get("cache_depth", 0) or 0) for e in evs)
        rows.append({
            "site": site,
            "compiles": len(evs),
            "compile_ms": round(ms, 3),
            "max_cache_depth": depth,
            "last_axis": evs[-1].get("axis", "?"),
        })
    rows.sort(key=lambda r: (-r["compiles"], -r["compile_ms"]))
    rows = rows[: args.n]
    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    total = sum(r["compiles"] for r in rows)
    print(f"top {len(rows)} churn sites ({total} compiles):")
    for r in rows:
        print(
            f"  {r['site']:<28} {r['compiles']:>4} compiles "
            f"{r['compile_ms']:>9.1f}ms  depth {r['max_cache_depth']:>3}  "
            f"last: {r['last_axis']}"
        )
    return 0


def cmd_timeline(args) -> int:
    sites = _by_site(_compiles(args.obs_dir))
    evs = sites.get(args.site)
    if evs is None:
        print(
            f"site {args.site!r} has no compiles; sites: "
            f"{', '.join(sorted(sites))}",
            file=sys.stderr,
        )
        return 1
    evs.sort(key=lambda e: float(e.get("mono", 0.0)))
    if args.json:
        print(json.dumps(evs, indent=1))
        return 0
    print(f"{args.site}: {len(evs)} compiles")
    for i, e in enumerate(evs):
        print(
            f"  #{i:<3} {float(e.get('ms', 0.0)):>8.2f}ms  "
            f"depth {int(e.get('cache_depth', 0) or 0):>3}  "
            f"{e.get('axis', '?')}"
        )
    return 0


def _gauge(snap: Dict[str, Any], name: str) -> Optional[float]:
    v = snap.get(name)
    return float(v) if isinstance(v, (int, float)) else None


_WATERMARK_KEYS = (
    "live_buffer_bytes",
    "live_buffer_peak_bytes",
    "hbm_used_bytes",
    "hbm_budget_bytes",
    "hbm_peak_bytes",
    "hbm_occupancy",
)


def cmd_watermarks(args) -> int:
    # The workers' periodic status dumps (obs-<member>.json, atomic
    # replace) carry a "devprof" block; raw metrics dumps carry the
    # gauges flat under their devprof.* scrape names. Accept both.
    rows = []
    for name in sorted(os.listdir(args.obs_dir)):
        if not (name.startswith("obs-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(args.obs_dir, name)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        block = doc.get("devprof") or {}
        flat = doc.get("counters", doc)
        row: Dict[str, Any] = {"member": name[4:-5]}
        for k in _WATERMARK_KEYS:
            v = block.get(k)
            if not isinstance(v, (int, float)):
                v = _gauge(flat, f"devprof.{k}")
            row[k] = v
        if any(v is not None for k, v in row.items() if k != "member"):
            rows.append(row)
    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    if not rows:
        print(
            f"no devprof gauges in obs-*.json under {args.obs_dir}",
            file=sys.stderr,
        )
        return 1
    print("device-memory watermarks:")
    for r in rows:
        def b(v):
            return "-" if v is None else f"{v:,.0f}B"
        occ = (
            "-" if r["hbm_occupancy"] is None
            else f"{r['hbm_occupancy']:.1%}"
        )
        print(
            f"  {r['member']:<10} live {b(r['live_buffer_bytes'])} "
            f"(peak {b(r['live_buffer_peak_bytes'])})  "
            f"hbm {b(r['hbm_used_bytes'])}/{b(r['hbm_budget_bytes'])} "
            f"= {occ} (peak {b(r['hbm_peak_bytes'])})"
        )
    return 0


def cmd_diff(args) -> int:
    docs = []
    for p in (args.a, args.b):
        with open(p) as f:
            docs.append(json.load(f))
    a, b = docs
    keys = (
        "recompiles_per_100_rounds",
        "compile_ms_share_pct",
        "overhead_pct",
        "storm_cut_factor",
    )
    out: Dict[str, Any] = {"a": args.a, "b": args.b, "metrics": {}}
    for k in keys:
        va, vb = a.get(k), b.get(k)
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            out["metrics"][k] = {
                "a": va, "b": vb, "delta": round(vb - va, 3)
            }
    flips = {}
    for name in sorted(set(a.get("checks", {})) | set(b.get("checks", {}))):
        ca, cb = a.get("checks", {}).get(name), b.get("checks", {}).get(name)
        if ca != cb:
            flips[name] = {"a": ca, "b": cb}
    out["check_flips"] = flips
    out["pass"] = {"a": a.get("pass"), "b": b.get("pass")}
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    print(f"{os.path.basename(args.a)} -> {os.path.basename(args.b)}:")
    for k, d in out["metrics"].items():
        print(f"  {k:<28} {d['a']:>9} -> {d['b']:>9}  ({d['delta']:+})")
    if flips:
        for name, d in flips.items():
            print(f"  check {name}: {d['a']} -> {d['b']}")
    else:
        print("  no check flips")
    print(f"  pass: {out['pass']['a']} -> {out['pass']['b']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="device-observatory CLI (compile churn, shape "
        "timelines, memory watermarks, run-vs-run diff)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("churn", help="top-N compile-churn sites")
    p.add_argument("obs_dir")
    p.add_argument("-n", type=int, default=10)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_churn)

    p = sub.add_parser("timeline", help="one site's shape-growth timeline")
    p.add_argument("obs_dir")
    p.add_argument("--site", required=True)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("watermarks", help="device-memory watermark report")
    p.add_argument("obs_dir")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_watermarks)

    p = sub.add_parser("diff", help="run-vs-run DEVPROF carrier diff")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
