"""Cluster observability plane: tracing, lag, export, live scraping and
the device observatory (port of ``antidote_ccrdt_tpu/obs/``).

* `obs.events` — structured flight-recorder ring + crash-durable JSONL
  spill (``CCRDT_OBS_DIR``); delta trace-context for end-to-end
  propagation-path reconstruction.
* `obs.lag` — per-peer replication lag (ops + seconds) from delta-seq
  watermarks, and the fleet digest-agreement probe.
* `obs.export` — Prometheus/JSONL rendering of `Metrics` snapshots
  (latencies as cumulative histograms) and cross-process aggregation
  (``CCRDT_METRICS_DIR``).
* `obs.http` — per-worker OpenMetrics HTTP endpoint (``/metrics`` +
  ``/healthz``, gated on ``CCRDT_HTTP_PORT``).
* `obs.rtrace` — request-scoped hop records, their wire encodings and
  the tail attribution; `export.prometheus_text` reads its exemplars.
* `obs.profile` and `obs.devprof` — the dispatch profiler and the
  device observatory over `core.batch_merge` and the elastic sweeps
  (``CCRDT_PROFILE``, ``CCRDT_DEVPROF``); the port's compile is a
  kernel's first load (``ops/_build.py``).
* `obs.spans` — round-phase span tracer (``CCRDT_SPANS``): begin/end
  monotonic spans over the worker-round phases, NTP-style per-peer
  clock offsets for fleet-wide timeline alignment, Perfetto/Chrome
  trace-event export, and dispatch-gap attribution.

`obs.events` and `obs.spans` stay stdlib-only so transports, the WAL,
the checkpoint journal and the fault registry can import them without
cycles; the other modules may import package code and are pulled in
lazily by the layers that need them. Their ``ACTIVE`` flags, rings and
spill files belong to this package: arming the JAX package's recorder,
tracer or profiler does not arm these, nor the reverse.
* `obs.audit` — the certified-convergence plane: the causal apply-order
  audit, op-count and durability reconciliation, signed convergence,
  session and write certificates (byte-equal to the JAX package's, so
  each verifies the other's), the lattice-law checker over `ops.laws`
  and the divergence watchdog.
"""

from . import events  # noqa: F401  (stdlib-only, safe for all importers)
from . import spans  # noqa: F401  (stdlib-only, safe for all importers)

__all__ = ["events", "lag", "export", "http", "rtrace", "profile", "devprof", "spans", "audit"]
