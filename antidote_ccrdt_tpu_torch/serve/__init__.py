"""serve/: the read-serving plane (port of ``antidote_ccrdt_tpu/serve/``).

Reads dwarf writes at the ROADMAP's "millions of users" scale, and until
now the only read path was calling `value()` in-process. This package
serves bounded-staleness reads off the elastic worker's replicated
state:

* `replica`  — device-resident double-buffered snapshots, swapped at
               publish boundaries so queries never race the donated
               merge slots;
* `kernels`  — per-type batched query answering: one fold+observe
               dispatch materializes every key, queries are gathers;
* `cache`    — hot-key answers that outlive swaps, bounded by LRU and
               the staleness-pedigree horizon;
* `plane`    — the `ServePlane` facade all three wire surfaces call
               (`net/tcp.py` `{query}` frame, bridge `{query}` op,
               `POST /query` on `obs/http.py`).

Workers opt in via ``CCRDT_SERVE=1`` (`install_from_env`, the same
env-propagation pattern as `utils.faults` / `obs.http`).

The WRITE tier: `ingest` (`IngestPlane` worker-side front
door + `WriteRouter` client-side owner routing over the shared
`routing_common` breakers) and `write_session` (`WriteSession` staging
+ pre-wire compaction). Workers opt in via ``CCRDT_INGEST=1``
(`install_ingest_from_env`).

Every module here is a copy of the JAX package's, with the same names,
wire bytes, counters and seeded draws; the planes serve from the device
of the state they are given (`kernels.materialize` folds and observes
there and pulls the observable to the host).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from .cache import HotKeyCache
from .kernels import SnapshotView, answer, answer_one, materialize, query_key
from .plane import (
    Overloaded,
    ServePlane,
    SessionUncovered,
    encode,
    request_bytes,
)
from .ingest import (
    ACK_APPLIED,
    ACK_DURABLE,
    ACK_REPLICATED,
    IngestPlane,
    WriteRouter,
    tcp_write_fn,
)
from .replica import ReadReplica, Snapshot
from .router import CircuitBreaker, FleetRouter, tcp_query_fn
from .routing_common import BreakerBoard, candidate_order
from .session import ClientSession, SessionToken, covers, session_doc
from .write_session import WriteSession, effect_from_wire, effect_to_wire

ENV_FLAG = "CCRDT_SERVE"
INGEST_ENV_FLAG = "CCRDT_INGEST"

_FALSE = {"", "0", "false", "no", "off"}

__all__ = [
    "ACK_APPLIED",
    "ACK_DURABLE",
    "ACK_REPLICATED",
    "ENV_FLAG",
    "INGEST_ENV_FLAG",
    "BreakerBoard",
    "CircuitBreaker",
    "ClientSession",
    "FleetRouter",
    "HotKeyCache",
    "IngestPlane",
    "Overloaded",
    "ReadReplica",
    "ServePlane",
    "SessionToken",
    "SessionUncovered",
    "Snapshot",
    "SnapshotView",
    "WriteRouter",
    "WriteSession",
    "answer",
    "answer_one",
    "candidate_order",
    "covers",
    "effect_from_wire",
    "effect_to_wire",
    "encode",
    "install_from_env",
    "install_ingest_from_env",
    "materialize",
    "query_key",
    "request_bytes",
    "session_doc",
    "tcp_query_fn",
    "tcp_write_fn",
]


def install_from_env(
    dense: Any,
    member: str,
    metrics: Any = None,
    lag_tracker: Any = None,
    env: Optional[dict] = None,
) -> Optional[ServePlane]:
    """Build a `ServePlane` iff ``CCRDT_SERVE`` is truthy — workers call
    this unconditionally, like `faults.install_from_env`. Returns None
    when serving is off (the default: pure write fleets pay nothing)."""
    raw = (env if env is not None else os.environ).get(ENV_FLAG, "")
    if raw.strip().lower() in _FALSE:
        return None
    return ServePlane(
        dense, member=member, metrics=metrics, lag_tracker=lag_tracker
    )


def install_ingest_from_env(
    member: str,
    metrics: Any = None,
    durable_fn: Any = None,
    watermarks_fn: Any = None,
    pressure_fns: Any = (),
    env: Optional[dict] = None,
) -> Optional[IngestPlane]:
    """Build an `IngestPlane` iff ``CCRDT_INGEST`` is truthy — the write
    tier's twin of `install_from_env`. ``CCRDT_ACK_BEFORE_FSYNC=1``
    arms the deliberately-violating ack-before-fsync mode (chaos drills
    only: `obs.audit.certify_writes` must convict it).
    ``CCRDT_INGEST_ACK_TIMEOUT_S`` stretches the ack deadline — a write
    is only applied at the NEXT step boundary, so the deadline must
    exceed the worker's step cadence (contended CPU hosts step slowly;
    the chaos drills raise it there)."""
    e = env if env is not None else os.environ
    raw = e.get(INGEST_ENV_FLAG, "")
    if raw.strip().lower() in _FALSE:
        return None
    unsafe = e.get("CCRDT_ACK_BEFORE_FSYNC", "").strip().lower() not in _FALSE
    try:
        ack_timeout_s = float(e.get("CCRDT_INGEST_ACK_TIMEOUT_S", "2.0"))
    except ValueError:
        ack_timeout_s = 2.0
    return IngestPlane(
        member,
        metrics=metrics,
        durable_fn=durable_fn,
        watermarks_fn=watermarks_fn,
        pressure_fns=tuple(pressure_fns),
        ack_timeout_s=ack_timeout_s,
        ack_before_fsync=unsafe,
    )
