"""Span-trace CLI: merge a fleet's span spills and attribute round time.

`obs.spans` has every worker spill phase spans (`round.*`) plus NTP-style
clock-offset samples into ``CCRDT_OBS_DIR``; this tool turns a directory
of ``spans-*.jsonl`` files into the two artifacts an operator wants::

    # One Perfetto/Chrome trace-event JSON with every worker's spans on
    # a single clock-aligned timeline (load in ui.perfetto.dev).
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_spans merge /path/to/obs-dir -o trace.json

    # Dispatch-gap attribution: per round, how much host time each phase
    # accounts for, what was serial vs overlappable (other threads), and
    # the residue no span owns — reconciled against the measured
    # round.e2e wall time.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_spans attribute /path/to/obs-dir

Exit codes: 0 on success; both subcommands exit 1 when the directory
holds no span records. `attribute --min-coverage F` exits 1 when the
fleet p50 serial coverage falls below F (the spans-demo smoke gate).

Alignment: offsets are RTT-halved estimates piggybacked on live frames
({hello}/{metrics_req}); members unreachable in the offset graph render
unshifted and are listed in the merge report.

Port of ``scripts/ccrdt_spans.py`` over the port's ``obs/spans.py``: the
same subcommands, flags, printed text, output file and exit codes. It reads
the ``spans-*.jsonl`` spills workers write with ``CCRDT_SPANS=1`` and
``CCRDT_OBS_DIR``, and touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import spans as obs_spans  # noqa: E402


def cmd_merge(args: argparse.Namespace) -> int:
    by_member = obs_spans.scan_dir(args.obs_dir)
    n_spans = sum(
        1 for recs in by_member.values() for r in recs if r.get("k") == "span"
    )
    if not n_spans:
        print(f"no span records under {args.obs_dir}")
        return 1
    offsets = obs_spans.clock_offsets(by_member)
    shifts = obs_spans.align_offsets(offsets, by_member.keys())
    trace = obs_spans.to_chrome_trace(by_member, shifts=shifts)
    with open(args.out, "w") as f:
        json.dump(trace, f)
    ref = sorted(by_member)[0] if by_member else "?"
    # A member with no offset edge renders unshifted — call that out
    # rather than let a skewed lane masquerade as aligned.
    unaligned = sorted(
        m for m in by_member
        if m != ref and shifts.get(m, 0.0) == 0.0
        and m not in offsets
        and not any(m in peers for peers in offsets.values())
    )
    print(f"members : {len(by_member)} ({', '.join(sorted(by_member))})")
    print(f"spans   : {n_spans}")
    print(f"aligned : ref={ref} shifts=" + " ".join(
        f"{m}:{shifts.get(m, 0.0) * 1e3:+.3f}ms" for m in sorted(by_member)
    ))
    if unaligned:
        print(f"warning : no clock-offset path to {unaligned}; "
              f"their lanes are unshifted")
    print(f"wrote   : {args.out} ({len(trace['traceEvents'])} trace events; "
          f"load in ui.perfetto.dev)")
    return 0


def cmd_attribute(args: argparse.Namespace) -> int:
    by_member = obs_spans.scan_dir(args.obs_dir)
    att = obs_spans.attribute(by_member)
    if not att["fleet"]["rounds"]:
        print(f"no round.e2e spans under {args.obs_dir} "
              f"(did the workers run with CCRDT_SPANS=1?)")
        return 1
    if args.json:
        print(json.dumps(att))
    else:
        print(obs_spans.format_report(att))
    cov = att["fleet"]["coverage_p50"]
    if args.min_coverage is not None and cov < args.min_coverage:
        print(f"FAIL: fleet serial coverage p50 {cov:.1%} < "
              f"required {args.min_coverage:.1%} — load-bearing phases "
              f"are dark or the gap grew")
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="merge and attribute a fleet's round-phase span traces"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser(
        "merge", help="merge spills into one aligned Perfetto trace JSON"
    )
    m.add_argument("obs_dir")
    m.add_argument("-o", "--out", default="spans_trace.json")
    m.set_defaults(fn=cmd_merge)

    a = sub.add_parser(
        "attribute", help="per-round critical path and dispatch-gap report"
    )
    a.add_argument("obs_dir")
    a.add_argument("--json", action="store_true", help="machine-readable")
    a.add_argument(
        "--min-coverage",
        type=float,
        default=None,
        help="exit 1 if fleet p50 serial coverage falls below this fraction",
    )
    a.set_defaults(fn=cmd_attribute)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
