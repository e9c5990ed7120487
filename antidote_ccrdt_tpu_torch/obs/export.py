"""Metrics export: Prometheus text + JSONL, and cross-process merge.

`utils.metrics.Metrics` is process-local by design; a drill fleet is
many processes. This module closes both gaps:

* **Formats** — `prometheus_text()` renders a `Metrics.snapshot()` in
  Prometheus/OpenMetrics exposition format (names `ccrdt_`-prefixed,
  dots to underscores, HELP/TYPE lines, latencies as CUMULATIVE
  histograms: per-bucket `_bucket{le="..."}` counts over a fixed
  exponential-ish bound ladder plus `_sum`/`_count`); `jsonl_lines()`
  renders the same snapshot one-metric-per-line for log pipelines.
  Histograms (not summaries) because a real Prometheus scraping many
  workers must be able to AGGREGATE latency across the fleet — bucket
  counts sum across scrape targets, per-worker quantiles do not.

* **Aggregation** — workers dump a snapshot at exit to
  ``$CCRDT_METRICS_DIR/metrics-<member>-<pid>.json``
  (`install_atexit_dump`, gated on the env var exactly like
  `utils.faults`' ``CCRDT_FAULTS``), and the supervising parent folds
  every dump into one fleet-wide `Metrics` via `merge_dir` — counters
  sum, latency samples concatenate, so fleet percentiles are computed
  over the union of samples rather than averaging per-worker
  percentiles (which would be wrong).
"""

from __future__ import annotations

import atexit
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.metrics import Metrics

ENV_DIR = "CCRDT_METRICS_DIR"

# Histogram bucket upper bounds, in seconds. Spans a sub-millisecond jit
# cache hit through a multi-second convergence round; the ladder is fixed
# (not data-derived) so bucket counts from different workers and different
# scrapes of the same worker line up and can be summed by Prometheus.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _san(name: str, prefix: str) -> str:
    return f"{prefix}_{_NAME_RE.sub('_', name)}"


def _labels(labels: Optional[Dict[str, str]], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted((labels or {}).items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _as_snapshot(src: Any) -> Dict[str, Any]:
    return src.snapshot() if isinstance(src, Metrics) else src


def prometheus_text(
    src: Any,
    prefix: str = "ccrdt",
    labels: Optional[Dict[str, str]] = None,
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
    exemplars: Optional[Dict[str, Tuple[str, float]]] = None,
) -> str:
    """Render a `Metrics` (or a `snapshot()` dict) as Prometheus
    exposition text. Counters/gauges share one value dict upstream, so
    every scalar is exported as a gauge (monotonic-by-construction names
    still read correctly; Prometheus treats TYPE as advisory). Latency
    series become cumulative histograms: `_bucket{le="..."}` counts over
    `buckets` (each bucket includes everything at or below its bound,
    `+Inf` always equals `_count`), plus `_sum`/`_count` — derived from
    the raw samples `Metrics` keeps, so fleet aggregation can sum bucket
    counts across workers.

    `exemplars` maps a latency family name to ``(trace_id, ms)``; each
    gets an OpenMetrics exemplar (`` # {trace_id="..."} value``) on the
    bucket its value falls in, so a dashboard's p99 panel links to the
    STORED request trace that latency came from (``scripts/
    ccrdt_rtrace.py waterfall <id>`` decomposes it). By default the live
    rtrace plane's exemplars are used — dark plane, no exemplars, and
    the output is byte-identical to the pre-exemplar format."""
    if exemplars is None:
        from . import rtrace

        exemplars = rtrace.exemplars()
    snap = _as_snapshot(src)
    lines: List[str] = []
    for name in sorted(snap.get("counters", {})):
        m = _san(name, prefix)
        lines.append(f"# HELP {m} ccrdt counter/gauge {name}")
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{_labels(labels)} {_num(snap['counters'][name])}")
    for name in sorted(snap.get("latencies", {})):
        samples = snap["latencies"][name]
        m = _san(name, prefix) + "_seconds"
        lines.append(f"# HELP {m} ccrdt latency {name}")
        lines.append(f"# TYPE {m} histogram")
        if samples:
            a = np.sort(np.asarray(samples, dtype=float))
            # Cumulative count at each bound: index of the first sample
            # strictly above it (le is inclusive).
            cum = np.searchsorted(a, np.asarray(buckets), side="right")
            total, count = float(a.sum()), int(a.size)
        else:
            cum = np.zeros(len(buckets), dtype=int)
            total, count = 0.0, 0
        ex = (exemplars or {}).get(name)
        ex_s = float(ex[1]) / 1e3 if ex else None  # exemplar ms -> s
        ex_bucket = None
        if ex_s is not None:
            # The exemplar annotates the first bucket that contains its
            # value (OpenMetrics requires value <= le); past the ladder
            # it rides +Inf.
            ex_bucket = next(
                (le for le in buckets if ex_s <= le), "+Inf"
            )
        for le, c in zip(buckets, cum):
            ll = 'le="%g"' % le
            suffix = ""
            if ex_bucket == le:
                suffix = f' # {{trace_id="{ex[0]}"}} {_num_f(ex_s)}'
            lines.append(f"{m}_bucket{_labels(labels, ll)} {int(c)}{suffix}")
        inf = 'le="+Inf"'
        suffix = ""
        if ex_bucket == "+Inf":
            suffix = f' # {{trace_id="{ex[0]}"}} {_num_f(ex_s)}'
        lines.append(f"{m}_bucket{_labels(labels, inf)} {count}{suffix}")
        lines.append(f"{m}_sum{_labels(labels)} {_num(total)}")
        lines.append(f"{m}_count{_labels(labels)} {count}")
    return "\n".join(lines) + "\n"


def _num_f(v: float) -> str:
    return "%g" % float(v)


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def jsonl_lines(
    src: Any, member: Optional[str] = None
) -> List[str]:
    """One JSON object per metric — counters as {"metric", "value"},
    latencies as {"metric", "summary": {...percentiles...}}."""
    snap = _as_snapshot(src)
    base: Dict[str, Any] = {} if member is None else {"member": member}
    out: List[str] = []
    for name in sorted(snap.get("counters", {})):
        out.append(json.dumps(
            {**base, "metric": name, "value": snap["counters"][name]}
        ))
    for name in sorted(snap.get("latencies", {})):
        samples = snap["latencies"][name]
        summ: Dict[str, Any] = {"n": len(samples)}
        if samples:
            a = np.asarray(samples, dtype=float)
            summ.update(
                p50_ms=float(np.percentile(a, 50) * 1e3),
                p90_ms=float(np.percentile(a, 90) * 1e3),
                p99_ms=float(np.percentile(a, 99) * 1e3),
                total_s=float(a.sum()),
            )
        out.append(json.dumps({**base, "metric": name, "summary": summ}))
    return out


# -- cross-process aggregation (CCRDT_METRICS_DIR) ---------------------------


def dump_snapshot(
    metrics: Metrics, member: str, metrics_dir: str
) -> str:
    """Write this process's snapshot to
    ``<dir>/metrics-<member>-<pid>.json``; returns the path. Write is
    atomic (tmp + replace) so a parent merging mid-dump never reads a
    torn file."""
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, f"metrics-{member}-{os.getpid()}.json")
    doc = {"member": member, "pid": os.getpid(), "t": time.time()}
    doc.update(metrics.snapshot())
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def install_atexit_dump(
    metrics: Metrics, member: str, env: Optional[Dict[str, str]] = None
) -> bool:
    """Register an atexit snapshot dump iff ``CCRDT_METRICS_DIR`` is set
    (same supervisor->worker env propagation as ``CCRDT_FAULTS``).
    Returns whether a dump was armed. A SIGKILLed worker leaves no
    metrics dump — by design; its flight-recorder spill (obs.events) is
    the crash-durable record."""
    d = (env if env is not None else os.environ).get(ENV_DIR)
    if not d:
        return False
    atexit.register(lambda: dump_snapshot(metrics, member, d))
    return True


def load_snapshots(metrics_dir: str) -> Dict[str, Dict[str, Any]]:
    """{filename: snapshot-doc} for every metrics dump in a dir."""
    out: Dict[str, Dict[str, Any]] = {}
    try:
        names = sorted(os.listdir(metrics_dir))
    except OSError:
        return out
    for fn in names:
        if fn.startswith("metrics-") and fn.endswith(".json"):
            try:
                with open(os.path.join(metrics_dir, fn)) as f:
                    out[fn] = json.load(f)
            except (OSError, ValueError):
                continue
    return out


def merge_dir(metrics_dir: str) -> Tuple[Metrics, List[str]]:
    """Fold every worker dump in `dir` into one fleet-wide `Metrics`.
    Returns (merged, member-names-merged)."""
    merged = Metrics()
    members: List[str] = []
    for doc in load_snapshots(metrics_dir).values():
        merged.merge(doc)
        members.append(str(doc.get("member", "?")))
    return merged, members
