"""Cluster observability plane: the flight-event log and the span tracer.

* `obs.events` — structured flight-recorder ring + crash-durable JSONL
  spill (``CCRDT_OBS_DIR``); delta trace-context for end-to-end
  propagation-path reconstruction.
* `obs.spans` — round-phase span tracer (``CCRDT_SPANS``): begin/end
  monotonic spans over the worker-round phases, NTP-style per-peer
  clock offsets for fleet-wide timeline alignment, Perfetto/Chrome
  trace-event export, and dispatch-gap attribution.

Both stay stdlib-only so the WAL, the checkpoint journal and the fault
registry can import them without cycles. Their ``ACTIVE`` flags, rings
and spill files belong to this package: arming the JAX package's
recorder or tracer does not arm these, nor the reverse. The lag,
export, HTTP and profile layers of the JAX package's ``obs`` are not
ported yet (ROADMAP A9).
"""

from . import events  # noqa: F401  (stdlib-only, safe for all importers)
from . import spans  # noqa: F401  (stdlib-only, safe for all importers)

__all__ = ["events", "spans"]
