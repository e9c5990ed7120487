"""`WriteSession`: the client-side staging + pre-wire batching half of
the fleet write tier.

Clients stage scalar effect ops per partition key; `flush()` compacts
each key's burst through `ops.compaction.compact_effect_ops` — the SAME
coalescing kernels the workers run, firing BEFORE the wire as the
CRDT scaling survey prescribes (delta compression at the edge) — and
ships the survivors as ONE ``CCRF`` range frame through `WriteRouter`.
The frame's ``[lo, hi]`` names the span of RAW staged ops the shipped
batch covers, so the wire itself records the coalescing provenance
(``hi - lo + 1`` raw ops entered, ``len(ops)`` survived).

The session also closes read-your-writes across tiers: every ack feeds
`ClientSession.note_write`, so the SAME token the read tier already
enforces (`session_gaps` in `serve.router`) now covers the client's own
writes — write through one tier, read through the other, never see
time go backwards.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..net.transport import encode_range_frame
from ..obs import rtrace
from ..utils.metrics import Metrics
from .ingest import ACK_DURABLE, WriteRouter
from .plane import encode
from .session import ClientSession


def effect_to_wire(effect: Tuple[str, Any]) -> List[Any]:
    """Effect tuple -> JSON-able form. Tuples become lists; a topk_rmv
    rmv vector-clock's int dc keys become strings (JSON object keys).
    The shape survives a round-trip through `effect_from_wire`."""

    def conv(x: Any) -> Any:
        if isinstance(x, tuple):
            return [conv(v) for v in x]
        if isinstance(x, dict):
            return {str(k): conv(v) for k, v in x.items()}
        return x

    kind, payload = effect
    return [str(kind), conv(payload)]


def effect_from_wire(doc: Any) -> Tuple[str, Any]:
    """Inverse of `effect_to_wire`: lists back to tuples, numeric dict
    keys back to ints — the scalar effect shape `ops.reference` /
    `compact_effect_ops` and the dense models' op constructors expect."""

    def conv(x: Any) -> Any:
        if isinstance(x, list):
            return tuple(conv(v) for v in x)
        if isinstance(x, dict):
            return {
                (int(k) if str(k).lstrip("-").isdigit() else k): conv(v)
                for k, v in x.items()
            }
        return x

    kind, payload = doc[0], doc[1]
    return (str(kind), conv(payload))


class WriteSession:
    """Per-client write front door: stage -> compact -> frame -> route.

    Staged effects accumulate per partition key and auto-flush at
    `batch_max`; an explicit `flush()` drains everything. Each key's
    flush is ONE router write (one wire frame, one write_id), so owner
    failover and client retries stay idempotent per burst. write_ids
    are ``{session_id}:{n}`` — stable across the retry storm inside one
    `WriteRouter.write` call by construction (the router reuses the id
    it was given)."""

    def __init__(
        self,
        router: WriteRouter,
        type_name: str,
        session: Optional[ClientSession] = None,
        session_id: str = "ws",
        batch_max: int = 64,
        ack: str = ACK_DURABLE,
        k: int = 2,
        m_keep: Optional[int] = None,
        metrics: Optional[Metrics] = None,
        device: DeviceLike = None,
    ):
        self.router = router
        # The device the pre-wire compaction runs on (default: the CUDA
        # card; raises without one, as every entry point of the port).
        self.device = resolve_device(device)
        self.type_name = str(type_name)
        self.session = session if session is not None else ClientSession()
        self.session_id = str(session_id)
        self.batch_max = max(1, int(batch_max))
        self.ack = ack
        self.k = int(k)
        # topk_rmv: bound surviving adds per id to the dense model's
        # slots_per_id — the fold keeps only the top-M slots anyway, so
        # shipping more than M adds for one id is pure wire waste.
        self.m_keep = m_keep
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._staged: Dict[str, List[Tuple[str, Any]]] = {}
        self._n_staged = 0
        self._wid_n = 0
        self.raw_ops = 0      # staged ops entering compaction
        self.shipped_ops = 0  # survivors that hit the wire

    # -- staging -------------------------------------------------------------

    def stage(
        self, key: str, effect: Tuple[str, Any]
    ) -> Optional[List[Dict[str, Any]]]:
        """Park one effect op for `key`. Returns flush results when the
        staging buffer crossed `batch_max` (auto-flush), else None."""
        with self._lock:
            self._staged.setdefault(str(key), []).append(effect)
            self._n_staged += 1
            full = self._n_staged >= self.batch_max
        self.metrics.count("write_session.staged_ops")
        if full:
            return self.flush()
        return None

    def pending(self) -> int:
        with self._lock:
            return self._n_staged

    # -- the burst -> wire path ----------------------------------------------

    def flush(self) -> List[Dict[str, Any]]:
        """Compact + ship every staged burst; one result doc per key
        (the router's ack or honest error — `flush` never raises and
        never silently drops: a failed burst comes back as its error
        doc and the caller decides whether to re-stage)."""
        with self._lock:
            staged, self._staged = self._staged, {}
            self._n_staged = 0
        results: List[Dict[str, Any]] = []
        for key, effects in staged.items():
            results.append(self._ship(key, effects))
        if staged:
            self.metrics.count("write_session.flushes")
        return results

    def _ship(self, key: str, effects: List[Tuple[str, Any]]) -> Dict[str, Any]:
        raw_n = len(effects)
        try:
            from ..ops.compaction import compact_effect_ops

            compacted = compact_effect_ops(
                self.type_name, effects, self.m_keep, device=self.device
            )
        except (ValueError, TypeError, KeyError, IndexError):
            # An unknown type or a malformed effect: ship raw. A device
            # or kernel failure (RuntimeError) is not caught.
            self.metrics.count("write_session.compact_fallbacks")
            compacted = list(effects)
        with self._lock:
            # Provenance counters advance under the SAME lock hold that
            # assigns the write_id and computes lo: concurrent flushes
            # (auto-flush racing an explicit flush()) get disjoint
            # [lo, hi] ranges and an exact coalesce_ratio.
            self.raw_ops += raw_n
            self.shipped_ops += len(compacted)
            self._wid_n += 1
            wid = f"{self.session_id}:{self._wid_n}"
            lo = self.raw_ops - raw_n
        wire_ops = [effect_to_wire(e) for e in compacted]
        doc = {
            "write_id": wid,
            "ops": wire_ops,
            "ack": self.ack,
            "type": self.type_name,
        }
        if self.ack == "replicated_to_k":
            doc["k"] = self.k
        # The trace context must ride INSIDE the CCRF frame (the plane
        # sees only the inner doc), so the session mints it here and
        # hands the Trace to the router for hop recording + commit.
        tr = rtrace.begin("write", key) if rtrace.ACTIVE else None
        if tr is not None:
            tr.t0 = self.router.mono()
            w = tr.wire()
            if w:
                doc["trace"] = w
        # The burst is ONE range frame: [lo, hi] spans the raw staged
        # ops this shipment covers — coalescing provenance on the wire.
        payload = encode_range_frame(lo, lo + raw_n - 1, encode(doc))
        out = self.router.write(
            wire_ops, key, ack=self.ack, k=self.k, session=self.session,
            write_id=wid, payload=payload, trace=tr,
        )
        if out.get("error") is not None:
            self.metrics.count("write_session.errors")
        else:
            self.metrics.count(f"write_session.acks.{out.get('level')}")
        out["key"] = key
        out["raw_ops"] = raw_n
        out["shipped_ops"] = len(compacted)
        return out

    # -- introspection -------------------------------------------------------

    def coalesce_ratio(self) -> float:
        """Raw staged ops per wire op — the client-edge twin of the
        worker-side ``coalesce_ratio`` bench metric."""
        return self.raw_ops / self.shipped_ops if self.shipped_ops else 1.0

    def status(self) -> Dict[str, Any]:
        return {
            "pending": self.pending(),
            "raw_ops": self.raw_ops,
            "shipped_ops": self.shipped_ops,
            "coalesce_ratio": round(self.coalesce_ratio(), 3),
            "counters": self.metrics.snapshot()["counters"],
        }
