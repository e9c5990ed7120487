"""Fleet write tier: `IngestPlane` (worker side) + `WriteRouter`
(client side) — the write-path twin of `serve.plane` + `serve.router`.

Reads have a fleet product (`serve.router`); writes used to enter through
whichever worker a client happened to hold, with no routing, no
batching, no durability contract, and no backpressure. This module
closes that gap:

* **Owner routing.** Every update routes to the partition-owning
  worker: the head of `topo.anchor.rendezvous_order(key, peers)` — the
  SAME ranking the read router and the anchor election use, so the
  fleet agrees on the owner without coordination and a reader's HRW
  walk lands on the replica its own writes went to (cache affinity +
  read-your-writes in one move). SWIM-``dead`` verdicts and the shared
  circuit breakers (`serve.routing_common`) fail writes over to the
  next candidate. Delivery semantics are explicit, not wishful:
  redelivery to the SAME plane is exactly-once — every write carries a
  client `write_id` the plane tracks from enqueue (in-flight registry)
  through fold (drain-time ack cache), so a retry attaches to the
  original or re-acks its ``(origin, seq)``, never re-folds. Failover
  to a DIFFERENT member is **at-least-once**: if the dead owner
  actually folded before its ack was lost (slow drain, killed after
  apply — its delta gossips or its WAL recovers), the successor folds
  the batch again under its own ``(origin, seq)``. The registered CRDT
  types absorb that duplicate under join (stamped adds dedup on merge);
  every fold emits an ``ingest.fold`` flight event carrying its
  write_id, so `obs.audit.certify_writes` reports cross-member
  duplicate applications and, with ``strict_exactly_once=True``,
  convicts them for deployments whose op streams are not
  duplicate-tolerant.
* **Pre-wire batching.** `WriteSession` (serve/write_session.py)
  compacts a staged burst through `ops.compaction.compact_effect_ops`
  and ships it as ONE `net.transport` ``CCRF`` range frame — the
  coalescing kernels firing BEFORE the wire, on the client, as the CRDT
  scaling survey frames delta compression at the edge.
* **Tiered durable acks.** ``applied`` = folded into the owner's
  in-memory state; ``durable`` = pinned to the
  ``wal.durable_seq`` watermark (the plane WAITS for the fsync
  watermark to pass the write's step before claiming it); and
  ``replicated_to_k`` = confirmed applied by k distinct members, which
  the ROUTER certifies by probing the replicas themselves (the owner
  cannot honestly attest what its peers hold). A level that cannot be
  reached inside the ack timeout is reported as the level actually
  achieved — never upgraded, so an ack is a contract, not a hope.
  ``ack_before_fsync=True`` deliberately breaks that contract (acks
  ``durable`` without waiting) — the violating arm
  `obs.audit.certify_writes` must convict.
* **Admission control.** The bounded ingest queue plus caller-injected
  pressure probes (WAL durability lag, overlap-queue depth, pager
  pressure) shed writers with an honest ``retry_after_ms`` derived from
  the observed drain rate — the write-side mirror of the read tier's
  `serve.queue_shed`, instead of queueing the overload invisibly.

Writes ride new ``{write}``/``{write_ack}`` frames on `net.tcp` +
`net.sim`, the bridge ``{write}`` op, and ``POST /write`` — the same
canonical JSON codec as the read tier, byte-identical on every surface.
The `utils.faults` point ``router.write`` fires per client attempt
(drop == connection loss, bills the breaker) and ``serve.write`` per
plane dispatch, so chaos drills can cut the write path at both ends.
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..net.transport import FRAME_MAGIC, decode_range_frame
from ..obs import devprof, events as obs_events, rtrace
from ..utils import faults
from ..utils.metrics import Metrics
from .plane import encode
from .routing_common import BreakerBoard, candidate_order
from .session import ClientSession

ACK_APPLIED = "applied"
ACK_DURABLE = "durable"
ACK_REPLICATED = "replicated_to_k"
_ACK_LEVELS = (ACK_APPLIED, ACK_DURABLE, ACK_REPLICATED)

# Idempotency window: acks remembered per write_id (insertion-ordered
# eviction). Sized like the sim transport's cancelled-qid window — a
# retry storm dedups, a week-long drill cannot leak memory.
_ACK_CACHE_MAX = 4096


class _PendingWrite:
    """One write parked between the transport thread that received it
    and the round loop that folds it at the next step boundary.

    `t_stage` / `t_fold` / `kernel_ms` are rtrace stage marks on the
    plane's monotonic clock (stage = parked, fold = drained+applied);
    they ride the response echo only when the request carried a trace
    context."""

    __slots__ = (
        "ops", "write_id", "done", "seq", "error",
        "t_stage", "t_fold", "kernel_ms",
    )

    def __init__(self, ops: List[Any], write_id: Optional[str]):
        self.ops = ops
        self.write_id = write_id
        self.done = threading.Event()
        self.seq = -1
        self.error: Optional[str] = None
        self.t_stage = 0.0
        self.t_fold = 0.0
        self.kernel_ms = 0.0


class IngestPlane:
    """Worker-side write front door. Transport threads `handle()` raw
    ``{write}`` payloads; the worker's round loop `drain()`s the queue
    at each step boundary, folding every parked write into the live
    state so a write's ``seq`` IS the step whose WAL record and gossip
    delta carry it — durability and replication watermarks come for
    free from the machinery that already tracks steps.

    Injected capabilities (all optional, degrade honestly when absent):

    durable_fn     () -> int: the WAL's fsync watermark
                   (`harness.wal.ElasticWal.durable_seq`). None = no WAL:
                   ``durable`` acks honestly downgrade to ``applied``.
    watermarks_fn  () -> {origin: seq}: this worker's applied
                   watermarks (`ServePlane.applied_watermarks` shape) —
                   rides every ack so routers learn, and answers the
                   replication probes `WriteRouter` certifies
                   ``replicated_to_k`` with.
    pressure_fns   iterable of () -> Optional[int]: admission probes
                   (WAL durability lag, overlap-queue depth, pager
                   pressure). A non-None return sheds the write with
                   that retry_after_ms hint.
    """

    def __init__(
        self,
        member: str,
        metrics: Optional[Metrics] = None,
        durable_fn: Optional[Callable[[], int]] = None,
        watermarks_fn: Optional[Callable[[], Dict[str, int]]] = None,
        pressure_fns: Tuple[Callable[[], Optional[int]], ...] = (),
        queue_max: int = 256,
        ack_timeout_s: float = 2.0,
        ack_before_fsync: bool = False,
        mono: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        poll_s: float = 0.005,
    ):
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        self.durable_fn = durable_fn
        self.watermarks_fn = watermarks_fn
        self.pressure_fns = tuple(pressure_fns)
        self.queue_max = max(1, int(queue_max))
        self.ack_timeout_s = float(ack_timeout_s)
        self.ack_before_fsync = bool(ack_before_fsync)
        self.mono = mono
        self.sleep = sleep
        self.poll_s = float(poll_s)
        self._lock = threading.Lock()
        self._pending: List[_PendingWrite] = []
        self._acked: Dict[str, Dict[str, Any]] = {}  # write_id -> ack doc
        # write_id -> its parked _PendingWrite, from enqueue until the
        # drain that folds it records the ack. A duplicate delivery in
        # this window attaches to the original instead of enqueueing a
        # second fold.
        self._inflight: Dict[str, _PendingWrite] = {}
        self._drain_rate = 0.0  # writes/s EWMA behind the shed hint

    # -- the round-loop side -------------------------------------------------

    def drain(self, seq: int, apply_fn: Callable[[List[Any]], None]) -> int:
        """Fold every parked write into the live state at step `seq`.
        ONE `apply_fn` call gets the whole drained batch (concatenated
        ops, arrival order) — the server-side half of the batching
        story. Each write is stamped ``(self.member, seq)``; transport
        threads blocked in `handle()` wake and build their acks. The
        write_id ack is recorded HERE, not in `handle()`: a write whose
        handler timed out before the fold still lands in the dedup
        cache, so a client retry re-acks instead of re-applying. A
        raising `apply_fn` fails the batch honestly (the writes were
        NOT applied and leave no dedup entry; callers see an error, and
        a retry legitimately re-applies)."""
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return 0
        t0 = self.mono()
        try:
            apply_fn([op for w in batch for op in w.ops])
        except Exception as e:  # noqa: BLE001 — surfaced per-writer
            with self._lock:
                for w in batch:
                    if w.write_id is not None:
                        self._inflight.pop(w.write_id, None)
            for w in batch:
                w.error = f"apply failed: {e}"
                w.done.set()
            self.metrics.count("ingest.apply_failures")
            return 0
        t_fold = self.mono()
        dt = max(1e-9, t_fold - t0)
        inst = len(batch) / dt
        self._drain_rate = (
            inst if self._drain_rate == 0.0
            else 0.8 * self._drain_rate + 0.2 * inst
        )
        with self._lock:
            for w in batch:
                w.seq = int(seq)
                w.t_fold = t_fold
                w.kernel_ms = dt * 1e3
                if w.write_id is None:
                    continue
                # Atomically retire the in-flight entry and record the
                # base ack: a duplicate delivery sees exactly one of
                # them, never a gap it could re-apply through.
                self._inflight.pop(w.write_id, None)
                self._acked[w.write_id] = {
                    "write_ack": True,
                    "member": self.member,
                    "origin": self.member,
                    "seq": int(seq),
                    "level": ACK_APPLIED,
                    "write_id": w.write_id,
                }
            while len(self._acked) > _ACK_CACHE_MAX:
                self._acked.pop(next(iter(self._acked)))
        for w in batch:
            w.done.set()
            if w.write_id is not None:
                # Fleet-visible fold evidence: certify_writes replays
                # these to surface a write_id folded by >1 member (the
                # at-least-once failover case).
                obs_events.emit(
                    "ingest.fold", member=self.member, wseq=int(seq),
                    write_id=w.write_id, n_ops=len(w.ops),
                )
        self.metrics.count("ingest.applied", len(batch))
        return len(batch)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def health_fields(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()["counters"]
        return {
            "ingest_queue_depth": self.depth(),
            "ingest_applied": int(snap.get("ingest.applied", 0)),
            "ingest_unsafe_acks": int(snap.get("ingest.unsafe_acks", 0)),
        }

    # -- the transport side --------------------------------------------------

    def handle(self, raw: bytes, surface: str = "local") -> bytes:
        """bytes -> canonical ack/error bytes, total: bad requests and
        shed decisions come back as honest error documents, never
        exceptions (the transport would close the connection and the
        writer could not tell a crash from a shed)."""
        self.metrics.count("ingest.writes")
        self.metrics.count(f"ingest.writes.{surface}")
        m_in = self.mono()
        try:
            faults.fire("serve.write")  # injected stall/raise per surface
            doc, framed = self._decode(raw)
        except faults.InjectedFault as e:
            return encode({"error": f"fault: {e}", "member": self.member})
        except ValueError as e:
            self.metrics.count("ingest.bad_requests")
            return encode(
                {"error": f"bad_request: {e}", "member": self.member}
            )
        probe = doc.get("probe")
        if probe is not None:
            return self._answer_probe(probe)
        ctx = rtrace.server_trace(doc)
        write_id = doc.get("write_id")
        ops = doc.get("ops")
        if not isinstance(ops, list) or not ops:
            self.metrics.count("ingest.bad_requests")
            return encode(
                {"error": "bad_request: no ops", "member": self.member}
            )
        level = str(doc.get("ack", ACK_DURABLE))
        if level not in _ACK_LEVELS:
            self.metrics.count("ingest.bad_requests")
            return encode(
                {"error": f"bad_request: unknown ack level {level!r}",
                 "member": self.member}
            )
        if framed:
            self.metrics.count("ingest.range_frames")
        wid = str(write_id) if write_id is not None else None
        deadline = self.mono() + self.ack_timeout_s
        # Pressure probes run OUTSIDE the lock (a probe may call back
        # into this plane's own introspection); the verdict is applied
        # under the lock below, after dedup has had first refusal.
        pressure = self._pressure_shed()
        w = _PendingWrite(ops, wid)
        w.t_stage = m_in
        prior: Optional[Dict[str, Any]] = None
        orig: Optional[_PendingWrite] = None
        shed: Optional[Dict[str, Any]] = None
        shed_kind = ""
        with self._lock:
            # Dedup first — a duplicate delivery (client retry, owner
            # redelivery racing the original) is re-acked or attached
            # to the in-flight original, NEVER shed and never enqueued
            # a second time.
            if wid is not None:
                prior = self._acked.get(wid)
                if prior is None:
                    orig = self._inflight.get(wid)
            if prior is None and orig is None:
                if pressure is not None:
                    shed, shed_kind = pressure, "pressure"
                elif len(self._pending) + 1 > self.queue_max:
                    # Bound check and append share this one lock hold:
                    # N racing handlers cannot all pass the depth test
                    # and push the queue past queue_max.
                    shed = self._queue_shed_doc(len(self._pending))
                    shed_kind = "queue"
                else:
                    self._pending.append(w)
                    if wid is not None:
                        self._inflight[wid] = w
        if prior is not None:
            return self._reack(prior, level, deadline, ctx, m_in)
        if orig is not None:
            return self._await_inflight(orig, level, deadline, ctx, m_in)
        if shed is not None:
            self.metrics.count(f"ingest.{shed_kind}_shed")
            self.metrics.count(f"ingest.shed.{surface}")
            return encode(self._attach_echo(shed, ctx, m_in, shed=True))
        w.done.wait(max(0.0, self.ack_timeout_s))
        if not w.done.is_set():
            # The round loop never drained us (worker wedged or dying):
            # fail honestly rather than hang the writer. The write may
            # still fold later — it stays registered in-flight, and the
            # drain records its ack, so a retry with this write_id
            # attaches or re-acks instead of re-applying.
            self.metrics.count("ingest.apply_timeouts")
            return encode(self._attach_echo(
                {"error": "unavailable: ingest apply timeout",
                 "member": self.member}, ctx, m_in,
            ))
        if w.error is not None:
            return encode(self._attach_echo(
                {"error": w.error, "member": self.member}, ctx, m_in,
            ))
        t_ba = self.mono()
        ack = self._build_ack(w.seq, w.write_id, level, deadline)
        dwait_ms = max(0.0, (self.mono() - t_ba) * 1e3)
        if w.write_id is not None:
            self._store_ack(w.write_id, ack)
        obs_events.emit(
            "ingest.write", wseq=w.seq, level=ack["level"],
            write_id=w.write_id or "", n_ops=len(ops),
        )
        # Per-tier time-to-ack histogram (receipt -> ack built, at the
        # tier actually ACHIEVED) — rides every scrape surface.
        self.metrics.observe(
            f"ingest.ack_ms.{ack['level']}",
            max(0.0, (self.mono() - m_in) * 1e3),
        )
        return encode(self._attach_echo(
            ack, ctx, m_in, w=w, durable_wait_ms=round(dwait_ms, 3),
        ))

    def handler_for(self, surface: str) -> Callable[[bytes], bytes]:
        """A bytes->bytes handler bound to one surface label, so the
        per-surface shed/write counters attribute correctly."""
        return lambda raw: self.handle(raw, surface=surface)

    # -- internals -----------------------------------------------------------

    def _decode(self, raw: bytes) -> Tuple[Dict[str, Any], bool]:
        """(request doc, was-CCRF-framed). A `WriteSession` burst
        arrives as one ``CCRF|lo|hi|payload`` range frame; bare JSON is
        the degenerate single-write frame."""
        blob = bytes(raw or b"")
        framed = blob[:4] == FRAME_MAGIC
        if framed:
            _lo, _hi, blob = decode_range_frame(blob, 0)
        try:
            doc = json.loads(blob.decode("utf-8"))
        except Exception as e:  # noqa: BLE001 — caller degrades
            raise ValueError(f"undecodable write: {e}") from e
        if not isinstance(doc, dict):
            raise ValueError("write payload must be a JSON object")
        return doc, framed

    def _answer_probe(self, probe: Any) -> bytes:
        """Replication probe: does THIS member's applied watermark cover
        ``(origin, seq)``? The router counts confirmations toward
        ``replicated_to_k`` — the replicas attest, not the owner."""
        self.metrics.count("ingest.probes")
        wm = self.watermarks_fn() if self.watermarks_fn is not None else {}
        doc: Dict[str, Any] = {
            "member": self.member,
            "watermarks": {str(o): int(s) for o, s in (wm or {}).items()},
        }
        if isinstance(probe, dict):
            o, s = str(probe.get("origin", "")), int(probe.get("seq", -1))
            doc["covers"] = bool(doc["watermarks"].get(o, -1) >= s >= 0)
        return encode(doc)

    def _pressure_shed(self) -> Optional[Dict[str, Any]]:
        """First non-None verdict from the injected pressure probes
        (WAL lag / overlap depth / pager) as an honest shed document;
        None = no pressure. Never called under the plane lock."""
        for fn in self.pressure_fns:
            try:
                hint = fn()
            except Exception:  # noqa: BLE001 — a broken probe never sheds
                continue
            if hint is not None:
                return {
                    "error": "overloaded: backpressure",
                    "member": self.member,
                    "retry_after_ms": max(1, min(5000, int(hint))),
                }
        return None

    def _queue_shed_doc(self, depth: int) -> Dict[str, Any]:
        """The queue-full shed document (retry_after from the observed
        drain rate). Caller holds the plane lock."""
        rate = self._drain_rate
        if rate <= 0.0:
            hint = 50
        else:
            hint = max(1, min(5000, int(1000.0 * (depth + 1) / rate)))
        return {
            "error": f"overloaded: ingest queue full ({depth} >= "
            f"{self.queue_max})",
            "member": self.member,
            "retry_after_ms": hint,
        }

    def _attach_echo(
        self,
        doc: Dict[str, Any],
        ctx: Optional[Dict[str, Any]],
        m_in: float,
        w: Optional[_PendingWrite] = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Attach the rtrace server echo to a response doc — only when
        the request carried a trace context (untraced responses stay
        byte-identical to the pre-trace wire format). Returns a COPY:
        the success ack is also cached for write_id dedup, and a stale
        echo must never ride a future re-ack."""
        if ctx is None:
            return doc
        marks: Dict[str, Any] = {"m_in": m_in, "m_out": self.mono()}
        if w is not None and w.t_fold > 0.0:
            marks["m_stage"] = w.t_stage
            marks["m_fold"] = w.t_fold
            extra.setdefault("kernel_ms", round(w.kernel_ms, 3))
        if devprof.ACTIVE:
            # Device-observatory compile time inside this hop's window —
            # the write path's kernel-bucket honesty sub-annotation.
            cms = devprof.compile_ms_in_window(m_in, marks["m_out"])
            if cms > 0.0:
                extra.setdefault("compile_ms", cms)
        out = dict(doc)
        out["rtrace"] = rtrace.server_echo(ctx, self.member, marks, **extra)
        return out

    def _store_ack(self, wid: str, ack: Dict[str, Any]) -> None:
        with self._lock:
            self._acked[wid] = ack
            while len(self._acked) > _ACK_CACHE_MAX:
                self._acked.pop(next(iter(self._acked)))

    def _reack(
        self, prior: Dict[str, Any], level: str, deadline: float,
        ctx: Optional[Dict[str, Any]] = None, m_in: float = 0.0,
    ) -> bytes:
        """Re-answer a duplicate delivery from the recorded ack — same
        ``(origin, seq)``, no second fold. A drain-time base ack sits at
        ``applied``; if this delivery asks for durability, wait the
        watermark out against the ORIGINAL fold's seq and upgrade the
        cached doc, so a retry after an ack timeout still gets the level
        it paid for."""
        self.metrics.count("ingest.duplicate_acks")
        ack = dict(prior)
        want = _ACK_LEVELS.index(level)
        have = _ACK_LEVELS.index(str(ack.get("level", ACK_APPLIED)))
        if want > have:
            ack = self._build_ack(
                int(ack["seq"]), str(ack.get("write_id") or "") or None,
                level, deadline,
            )
            if _ACK_LEVELS.index(ack["level"]) > have and ack.get("write_id"):
                self._store_ack(ack["write_id"], dict(ack))
        ack["duplicate"] = True
        if m_in > 0.0:
            self.metrics.observe(
                f"ingest.ack_ms.{ack.get('level', ACK_APPLIED)}",
                max(0.0, (self.mono() - m_in) * 1e3),
            )
        # Failover retries land here: a minimal dup echo keeps their
        # waterfalls complete even though this delivery never folded.
        return encode(self._attach_echo(ack, ctx, m_in, dup=True))

    def _await_inflight(
        self, orig: _PendingWrite, level: str, deadline: float,
        ctx: Optional[Dict[str, Any]] = None, m_in: float = 0.0,
    ) -> bytes:
        """A duplicate delivery racing its still-parked original: wait
        on the ORIGINAL's fold instead of enqueueing a second
        _PendingWrite (two concurrent deliveries must fold once)."""
        self.metrics.count("ingest.duplicate_acks")
        orig.done.wait(max(0.0, deadline - self.mono()))
        if not orig.done.is_set():
            self.metrics.count("ingest.apply_timeouts")
            return encode(self._attach_echo(
                {"error": "unavailable: ingest apply timeout",
                 "member": self.member}, ctx, m_in,
            ))
        if orig.error is not None:
            return encode(self._attach_echo(
                {"error": orig.error, "member": self.member}, ctx, m_in,
            ))
        ack = self._build_ack(orig.seq, orig.write_id, level, deadline)
        ack["duplicate"] = True
        if m_in > 0.0:
            self.metrics.observe(
                f"ingest.ack_ms.{ack['level']}",
                max(0.0, (self.mono() - m_in) * 1e3),
            )
        return encode(self._attach_echo(ack, ctx, m_in, w=orig, dup=True))

    def _build_ack(
        self, seq: int, write_id: Optional[str], level: str, deadline: float
    ) -> Dict[str, Any]:
        """The ack document at the HIGHEST level achieved by `deadline`,
        never above the requested one and never above the truth."""
        achieved = ACK_APPLIED
        want_durable = level in (ACK_DURABLE, ACK_REPLICATED)
        if want_durable and self.ack_before_fsync:
            # The deliberately-violating arm: claim durability the fsync
            # has not delivered. certify_writes must convict this.
            achieved = ACK_DURABLE
            self.metrics.count("ingest.unsafe_acks")
        elif want_durable and self.durable_fn is not None:
            while self.mono() < deadline:
                try:
                    if int(self.durable_fn()) >= seq:
                        achieved = ACK_DURABLE
                        self.metrics.count("ingest.durable_acks")
                        break
                except Exception:  # noqa: BLE001 — treat as not-yet-durable
                    pass
                self.sleep(self.poll_s)
            else:
                self.metrics.count("ingest.ack_downgrades")
        elif want_durable:
            # No WAL on this worker: durability is not on offer.
            self.metrics.count("ingest.ack_downgrades")
        ack: Dict[str, Any] = {
            "write_ack": True,
            "member": self.member,
            "origin": self.member,
            "seq": int(seq),
            "level": achieved,
            "requested": level,
        }
        if write_id is not None:
            ack["write_id"] = write_id
        if self.watermarks_fn is not None:
            try:
                ack["watermarks"] = {
                    str(o): int(s)
                    for o, s in (self.watermarks_fn() or {}).items()
                }
            except Exception:  # noqa: BLE001 — watermarks are advisory
                pass
        return ack


class _WriteAttempt:
    __slots__ = ("peer", "cancel", "done", "result", "error", "t0")

    def __init__(self, peer: str):
        self.peer = peer
        self.cancel = threading.Event()
        self.done = threading.Event()
        self.result: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self.t0 = 0.0


class WriteRouter:
    """Client-side write router: owner affinity, SWIM-verdict failover,
    shared circuit breakers, bounded retries, honest sheds — the write
    twin of `FleetRouter`, minus hedging (a write hedge lands on a
    SECOND member, where the per-plane write_id dedup cannot see the
    first delivery — a guaranteed duplicate fold; the failover walk
    covers the latency case without it).

    `write()` never raises and never hangs: every outcome is a decoded
    ack document (augmented with ``"peer"``) or an honest error
    document (``unavailable`` / ``overloaded`` + retry_after_ms).

    Pass the read tier's `BreakerBoard` as `breakers` to share failure
    evidence across both tiers of one client."""

    def __init__(
        self,
        peers: Any,
        write_fn: Callable[[str, bytes, float, threading.Event], bytes],
        member: str = "writer",
        metrics: Optional[Metrics] = None,
        verdict_fn: Optional[Callable[[str], str]] = None,
        timeout_s: float = 2.0,
        retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 1.0,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 2.0,
        replication_wait_s: float = 2.0,
        replication_poll_s: float = 0.05,
        probe_timeout_s: float = 0.5,
        mono: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        poll_s: float = 0.005,
        seed: int = 0,
        breakers: Optional[BreakerBoard] = None,
    ):
        self._peers_src = peers
        self.write_fn = write_fn
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        self.verdict_fn = verdict_fn
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.replication_wait_s = float(replication_wait_s)
        self.replication_poll_s = float(replication_poll_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.mono = mono
        self.sleep = sleep
        self.poll_s = float(poll_s)
        self._rng = random.Random(seed)
        self._board = (
            breakers
            if breakers is not None
            else BreakerBoard(breaker_failures, breaker_cooldown_s, mono)
        )
        self._wid_lock = threading.Lock()
        self._wid_n = 0

    # -- introspection -------------------------------------------------------

    def _peers(self) -> List[str]:
        src = self._peers_src
        out = src() if callable(src) else src
        return [str(p) for p in out]

    def breaker(self, peer: str):
        return self._board.get(peer)

    def route(self, key: str) -> List[str]:
        """Owner-first candidate list: plain HRW (no staleness demotion
        — owner affinity must not wobble with lag), dead peers and open
        breakers dropped read-only."""
        return candidate_order(
            key, self._peers(), verdict_fn=self.verdict_fn,
            breakers=self._board,
        )

    def status(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()["counters"]
        return {
            "breakers": self._board.states(),
            "counters": {
                k: v for k, v in snap.items()
                if k.startswith("router.write")
            },
        }

    # -- the write path ------------------------------------------------------

    def write(
        self,
        ops: List[Any],
        key: str,
        ack: str = ACK_DURABLE,
        k: int = 2,
        session: Optional[Any] = None,
        write_id: Optional[str] = None,
        payload: Optional[bytes] = None,
        trace: Optional[rtrace.Trace] = None,
    ) -> Dict[str, Any]:
        """Route one write (or one pre-framed burst via `payload` — a
        `WriteSession` CCRF range frame whose inner doc must carry the
        SAME write_id). Walks the HRW owner list with bounded retries;
        redelivery to the same plane is deduped by write_id, while
        failover to a different member is at-least-once (see
        `_run_pass`). On success teaches the session its own ``(origin,
        seq)`` and flight-records ``ingest.ack`` — the feed
        `obs.audit.certify_writes` replays. A `WriteSession` that
        pre-framed its burst mints the trace itself (the context must
        sit INSIDE the CCRF payload) and hands it over via `trace`."""
        t0 = self.mono()
        self.metrics.count("router.writes")
        if ack not in _ACK_LEVELS:
            return {"error": f"bad_request: unknown ack level {ack!r}"}
        if write_id is None:
            with self._wid_lock:
                self._wid_n += 1
                write_id = f"{self.member}:{self._wid_n}"
        tr = trace
        if tr is None and payload is None and rtrace.ACTIVE:
            tr = rtrace.begin("write", key, t0)
        if payload is None:
            doc: Dict[str, Any] = {
                "write_id": write_id, "ops": list(ops), "ack": ack,
            }
            if tr is not None:
                w = tr.wire()
                if w:
                    doc["trace"] = w
            payload = encode(doc)
        sess = session if isinstance(session, ClientSession) else None

        last_err: Optional[str] = None
        shed_hint: Optional[int] = None
        all_sheds = True
        round_i = 0
        first_route = True
        while round_i <= self.retries:
            # First route hop opens at t0: write_id mint + CCRF/JSON
            # payload build is route-bucket work, not a coverage gap.
            t_route = t0 if first_route else self.mono()
            first_route = False
            order = self.route(key)
            if tr is not None:
                tr.hop("route", t_route, self.mono(),
                       candidates=list(order),
                       breakers={p: s for p, s
                                 in self._board.states().items()
                                 if s != "closed"})
            if not order:
                last_err = last_err or "no eligible peers"
                all_sheds = False
                round_i += 1
                self._backoff(round_i, tr)
                continue
            outcome, detail = self._run_pass(order, payload, tr)
            if outcome == "ok":
                resp, peer = detail
                return self._finish_ok(
                    t0, resp, peer, ack, k, write_id, sess, tr
                )
            if outcome == "shed":
                shed_hint = max(shed_hint or 0, int(detail or 0))
                last_err = "overloaded"
            else:
                all_sheds = False
                last_err = str(detail)
            round_i += 1
            if round_i <= self.retries:
                self.metrics.count("router.write_retries")
                self._backoff(round_i, tr)
        if shed_hint is not None and all_sheds:
            self.metrics.count("router.write_shed_returns")
            return self._finish_error(
                t0, "overloaded", {"retry_after_ms": shed_hint}, tr=tr,
            )
        return self._finish_error(
            t0, "unavailable", {"detail": last_err},
            counter="router.write_exhausted", tr=tr,
        )

    # -- one pass over the owner list ----------------------------------------

    def _run_pass(
        self, order: List[str], payload: bytes,
        tr: Optional[rtrace.Trace] = None,
    ) -> Tuple[str, Any]:
        """("ok", (resp, peer)) | ("shed", retry_after_ms) |
        ("err", detail). A failed owner fails over to the next HRW
        candidate (`router.write_failovers`) with the SAME write_id.
        Redelivery to the same plane dedups (in-flight registry + ack
        cache); failover to a DIFFERENT member is at-least-once — if
        the first owner folded before dying, the successor re-applies
        under its own (origin, seq) and the CRDT join must absorb the
        duplicate (certify_writes surfaces it via ingest.fold
        evidence)."""
        shed_hint: Optional[int] = None
        saw_shed = False
        last_detail: Any = "no candidates"
        for idx, peer in enumerate(order):
            if idx:
                self.metrics.count("router.write_failovers")
            if faults.ACTIVE:
                try:
                    if faults.fire("router.write") == "drop":
                        raise ConnectionError("router.write: injected drop")
                except (faults.InjectedFault, ConnectionError) as e:
                    self._fail(peer, e)
                    last_detail = str(e)
                    continue
            verdict, detail = self._attempt(peer, payload, tr)
            if verdict != "ok":
                last_detail = detail
                continue
            resp, who, a0, a1 = detail
            kind, fine = self._classify(who, resp, tr, a0, a1)
            if kind == "ok":
                return ("ok", (fine, who))
            if kind == "shed":
                saw_shed = True
                shed_hint = max(shed_hint or 0, int(fine or 0))
                last_detail = "overloaded"
            else:
                last_detail = fine
        if saw_shed:
            return ("shed", shed_hint)
        return ("err", last_detail)

    def _attempt(
        self, peer: str, payload: bytes,
        tr: Optional[rtrace.Trace] = None,
    ) -> Tuple[str, Any]:
        """One write attempt on a worker thread; the main thread watches
        the SWIM verdict (dead -> cancel + fail over NOW, not at the
        timeout) and the deadline. Returns
        ("ok", (raw, peer, t_send, t_recv)) or ("fail", detail)."""
        t_entry = self.mono()
        self.metrics.count("router.write_attempts")
        self.breaker(peer).allow()  # reserve any half-open probe slot
        att = _WriteAttempt(peer)
        # Window opens at _attempt entry so breaker/thread setup lands
        # in the attempt (wire) bucket instead of escaping attribution.
        att.t0 = t_entry

        def run() -> None:
            try:
                att.result = self.write_fn(
                    peer, payload, self.timeout_s, att.cancel
                )
            except BaseException as e:  # noqa: BLE001 — surfaced via att.error
                att.error = e
            finally:
                att.done.set()

        threading.Thread(
            target=run, name=f"router-w-{peer}", daemon=True
        ).start()
        deadline = att.t0 + self.timeout_s
        while not att.done.is_set():
            now = self.mono()
            if now >= deadline:
                break
            if (
                self.verdict_fn is not None
                and self.verdict_fn(peer) == "dead"
            ):
                # SWIM buried the owner mid-write: the write may or may
                # not have folded — fail over and let the write_id dedup
                # disambiguate at the successor.
                att.cancel.set()
                self.metrics.count("router.write_dead_reroutes")
                self._fail(peer, TimeoutError("owner died mid-write"))
                if tr is not None:
                    tr.hop("dead_reroute", now, peer=peer)
                    tr.hop("attempt", att.t0, now, peer=peer, ok=False,
                           err="dead mid-write")
                return ("fail", f"{peer} dead mid-write")
            self.sleep(self.poll_s)
        now = self.mono()
        if att.done.is_set() and att.error is None:
            self._succeed(att)
            if tr is not None:
                tr.hop("attempt", att.t0, now, peer=peer, ok=True)
            return ("ok", (att.result, peer, att.t0, now))
        att.cancel.set()
        if att.done.is_set():
            self._fail(peer, att.error or TimeoutError("write failed"))
            if tr is not None:
                tr.hop("attempt", att.t0, now, peer=peer, ok=False,
                       err=str(att.error))
            return ("fail", f"{peer}: {att.error}")
        self.metrics.count("router.write_timeouts")
        self._fail(peer, TimeoutError("write deadline exceeded"))
        if tr is not None:
            tr.hop("attempt", att.t0, now, peer=peer, ok=False,
                   err="timeout")
        return ("fail", f"{peer}: timeout after {self.timeout_s}s")

    # -- response classification ---------------------------------------------

    def _classify(
        self, peer: str, raw: Optional[bytes],
        tr: Optional[rtrace.Trace] = None,
        t_send: Optional[float] = None, t_recv: Optional[float] = None,
    ) -> Tuple[str, Any]:
        try:
            resp = json.loads(bytes(raw or b"").decode("utf-8"))
        except Exception as e:  # noqa: BLE001 — garbage == peer failure
            self.metrics.count("router.write_errors")
            self._fail(peer, e)
            return ("err", f"{peer}: undecodable ack: {e}")
        echo = resp.pop("rtrace", None) if isinstance(resp, dict) else None
        if tr is not None and isinstance(echo, dict) \
                and t_send is not None and t_recv is not None:
            tr.absorb_echo(echo, t_send, t_recv)
        if tr is not None and t_recv is not None:
            # Ack decode/verdict time rides the route bucket (mirrors
            # the read router) so sub-ms writes keep full coverage.
            tr.hop("route", t_recv, self.mono(), step="classify",
                   peer=peer)
        err = resp.get("error")
        if err is not None:
            err_s = str(err)
            if err_s.startswith("overloaded"):
                # Admission control, not peer sickness: no breaker hit.
                self.metrics.count("router.write_sheds")
                return ("shed", resp.get("retry_after_ms", 0))
            self.metrics.count("router.write_errors")
            self._fail(peer, RuntimeError(err_s))
            return ("err", f"{peer}: {err_s}")
        if not resp.get("write_ack") or "seq" not in resp:
            self.metrics.count("router.write_errors")
            self._fail(peer, RuntimeError("malformed ack"))
            return ("err", f"{peer}: malformed ack")
        return ("ok", resp)

    # -- ack finishing -------------------------------------------------------

    def _finish_ok(
        self,
        t0: float,
        resp: Dict[str, Any],
        peer: str,
        requested: str,
        k: int,
        write_id: str,
        sess: Optional[ClientSession],
        tr: Optional[rtrace.Trace] = None,
    ) -> Dict[str, Any]:
        out = dict(resp)
        out["peer"] = peer
        origin = str(resp.get("origin", peer))
        seq = int(resp.get("seq", -1))
        if (
            requested == ACK_REPLICATED
            and str(out.get("level")) == ACK_DURABLE
        ):
            t_probe = self.mono()
            confirmed = self._confirm_replication(origin, seq, int(k), peer)
            if tr is not None:
                tr.hop("ack_probe", t_probe, self.mono(),
                       confirmed=int(confirmed), want=int(k))
            out["replication"] = {"confirmed": confirmed, "want": int(k)}
            if confirmed >= int(k):
                out["level"] = ACK_REPLICATED
                self.metrics.count("router.replicated_acks")
            else:
                self.metrics.count("router.replication_timeouts")
        self.metrics.count("router.write_successes")
        dt = max(0.0, self.mono() - t0)
        self.metrics.merge({"latencies": {"router.write": [dt]}})
        rtrace.commit(tr, "ok", dt * 1e3)
        # The certifier's feed: what the CLIENT was told it holds.
        obs_events.emit(
            "ingest.ack", peer=peer, origin=origin, wseq=seq,
            level=str(out.get("level", "")), write_id=write_id,
            requested=requested,
        )
        if sess is not None and seq >= 0:
            # Read-your-writes closes across tiers right here: the read
            # router now routes this session only to peers whose applied
            # watermarks cover (origin, seq).
            sess.note_write(origin, seq)
        return out

    def _confirm_replication(
        self, origin: str, seq: int, k: int, owner: str
    ) -> int:
        """Poll the replicas themselves until k distinct members
        (counting the owner) confirm their applied watermark covers
        ``(origin, seq)``, bounded by `replication_wait_s`.

        The peers are probed in PARALLEL (one thread each): with p
        replicas at probe RTT t, the serial walk cost O(p·t) per ack
        and a single slow replica stalled every probe behind it. Each
        thread re-polls only ITS peer until it confirms; the first k
        confirmations release the waiter immediately (`enough`), and
        stragglers are cancelled rather than waited out."""
        if seq < 0:
            return 0
        confirmed = {owner}
        if len(confirmed) >= k:
            return len(confirmed)
        lock = threading.Lock()
        enough = threading.Event()
        probe = encode({"probe": {"origin": origin, "seq": seq}})
        deadline = self.mono() + self.replication_wait_s
        cancel = threading.Event()

        def probe_peer(peer: str) -> None:
            while not enough.is_set() and self.mono() < deadline:
                if (
                    self.verdict_fn is not None
                    and self.verdict_fn(peer) == "dead"
                ):
                    self.sleep(self.replication_poll_s)
                    continue
                try:
                    raw = self.write_fn(
                        peer, probe, self.probe_timeout_s, cancel
                    )
                    resp = json.loads(bytes(raw).decode("utf-8"))
                except Exception:  # noqa: BLE001 — probe failure != write failure
                    self.sleep(self.replication_poll_s)
                    continue
                wm = resp.get("watermarks")
                if (
                    resp.get("covers")
                    or (isinstance(wm, dict)
                        and int(wm.get(origin, -1)) >= seq)
                ):
                    with lock:
                        confirmed.add(peer)
                        self.metrics.count("router.replication_confirms")
                        if len(confirmed) >= k:
                            enough.set()
                    return
                self.sleep(self.replication_poll_s)

        threads = [
            threading.Thread(
                target=probe_peer, args=(p,),
                name=f"router-probe-{p}", daemon=True,
            )
            for p in self._peers() if p != owner
        ]
        for t in threads:
            t.start()
        while (
            not enough.is_set()
            and self.mono() < deadline
            and any(t.is_alive() for t in threads)
        ):
            self.sleep(self.poll_s)
        enough.set()   # release pollers still sleeping out the deadline
        cancel.set()   # and any probe blocked in the transport
        with lock:
            return len(confirmed)

    def _finish_error(
        self,
        t0: float,
        error: str,
        extra: Dict[str, Any],
        counter: Optional[str] = None,
        tr: Optional[rtrace.Trace] = None,
    ) -> Dict[str, Any]:
        if counter:
            self.metrics.count(counter)
        dt = max(0.0, self.mono() - t0)
        self.metrics.merge({"latencies": {"router.write": [dt]}})
        obs_events.emit("router.write_give_up", error=error)
        if tr is not None:
            outcome = "shed" if error == "overloaded" else "failed"
            if outcome == "failed" \
                    and "timeout" in str(extra.get("detail", "")):
                outcome = "deadline"
            rtrace.commit(tr, outcome, dt * 1e3)
        out: Dict[str, Any] = {"error": error}
        out.update(extra)
        return out

    # -- bookkeeping ---------------------------------------------------------

    def _succeed(self, att: _WriteAttempt) -> None:
        if self.breaker(att.peer).record_success():
            self.metrics.count("router.write_breaker_closes")

    def _fail(self, peer: str, err: BaseException) -> None:
        if isinstance(err, TimeoutError) or "timed out" in str(err):
            self.metrics.count("router.write_peer_timeouts")
        if self.breaker(peer).record_failure():
            self.metrics.count("router.write_breaker_opens")

    def _backoff(
        self, round_i: int, tr: Optional[rtrace.Trace] = None
    ) -> None:
        base = min(
            self.backoff_max_s, self.backoff_base_s * (2 ** (round_i - 1))
        )
        a = self.mono()
        self.sleep(base * (0.5 + self._rng.random()))  # jitter in [0.5, 1.5)
        if tr is not None:
            tr.hop("backoff", a, self.mono(), round=round_i)


def tcp_write_fn(
    addrs: Any, connect_timeout_s: float = 0.5
) -> Callable[[str, bytes, float, threading.Event], bytes]:
    """Adapter: a `write_fn` over `net.tcp.write_peer` given `addrs` —
    a dict (or callable returning one) of peer -> (host, port). Raises
    KeyError for unknown peers (the router fails over)."""
    from ..net.tcp import write_peer

    def fn(
        peer: str, payload: bytes, timeout_s: float, cancel: threading.Event
    ) -> bytes:
        table = addrs() if callable(addrs) else addrs
        addr = table[peer]
        _member, resp = write_peer(
            tuple(addr), payload, timeout=timeout_s, cancel=cancel,
            connect_timeout=connect_timeout_s,
        )
        return resp

    return fn
