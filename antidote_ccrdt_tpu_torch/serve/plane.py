"""`ServePlane`: the query front-end every wire surface shares.

One plane per worker ties the pieces together:

* `ReadReplica` — double-buffered device snapshots, swapped at publish
  boundaries by the worker's round thread (`swap`);
* a **bounded batching queue** — concurrent listener threads enqueue
  their decoded queries and one drainer answers the whole accumulated
  batch against a single snapshot materialization (the "one dispatch,
  thousands of queries" shape). Overflow sheds loudly
  (`serve.queue_shed` + an ``overloaded`` error response) instead of
  queueing unboundedly;
* `HotKeyCache` — answers outlive swaps; the `max_staleness_s` request
  knob decides whether an aged entry still qualifies, falls through to
  the fresh replica, or rejects (`serve.stale_rejects`);
* the **staleness contract** — every served value carries
  ``(value, as_of_seq, staleness_bound_s)`` with
  ``bound = (now - swap_mono) + lag_bound_at_swap``, all differences of
  this worker's monotonic clock (skew-immune; rounded UP to the µs so
  formatting can never shave the bound below truth).

Wire surfaces call ONE method — ``handle(request_bytes) ->
response_bytes`` — and transport the bytes verbatim, which is what
makes the tri-surface parity test (`tests/test_serve_parity.py`)
byte-exact: the codec is canonical JSON (sorted keys, compact
separators), so identical questions at identical snapshots produce
identical bytes on the TCP frame, the bridge op, and POST /query.

Request:  ``{"queries": [{"op": "value"|"topk"|"range", "key": int,
            "k"?: int, "lo"?: int, "hi"?: int}, ...],
            "max_staleness_s"?: float,
            "session"?: {origin: seq}}``
Response: ``{"member": str, "n": int, "results": [
            {"value": ..., "as_of_seq": int, "staleness_bound_s": float}
            | {"error": ...}, ...],
            "watermarks": {origin: seq}}``

The ``watermarks`` field is the session-guarantee carrier: the
per-origin applied seqs of the snapshot the answers came from (captured
at swap time from `obs/lag.py`, conservatively the OLDEST snapshot any
result in the batch used). A request's ``session`` token — a
``{origin: seq}`` floor from `serve.session` — is enforced here as the
last line of defense: if the live snapshot's watermarks don't cover the
token, the plane answers ``session_uncovered`` (with its watermarks, so
the router learns how far behind this replica is) rather than serving a
token-violating value. Shed (``overloaded``) responses carry a
``retry_after_ms`` hint derived from current queue depth over the
drain-rate EWMA, and `handle` takes a ``surface`` label ("tcp" /
"bridge" / "http" / ...) so sheds are countable per surface
(``serve.queue_shed.<surface>``) without breaking the byte-identity
contract (the label never enters the response).

`utils.faults` point ``serve.query`` fires at the top of `handle` on
every surface, so injected stalls/raises exercise each listener's own
degrade path (connection close / error frame / HTTP 500 — never a
hang).
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..obs import devprof
from ..obs import events as obs_events
from ..obs import rtrace
from ..utils import faults
from ..utils.metrics import Metrics
from . import kernels
from .cache import HotKeyCache
from .replica import ReadReplica
from .session import gaps as session_gaps


class Overloaded(RuntimeError):
    """The bounded query queue is full; the caller is shed. Carries the
    `retry_after_ms` hint the shed response propagates fleet-wide."""

    def __init__(self, msg: str, retry_after_ms: int = 50):
        super().__init__(msg)
        self.retry_after_ms = int(retry_after_ms)


class SessionUncovered(RuntimeError):
    """The live snapshot's applied watermarks don't cover the request's
    session token — answering would violate the client's session
    guarantee. Carries this replica's watermarks so the router can
    learn and route elsewhere."""

    def __init__(self, msg: str, watermarks: Dict[str, int]):
        super().__init__(msg)
        self.watermarks = dict(watermarks)


def encode(doc: Dict[str, Any]) -> bytes:
    """Canonical response/request bytes: sorted keys, compact
    separators — the tri-surface byte-identity anchor."""
    return (json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n").encode(
        "utf-8"
    )


def request_bytes(
    queries: List[Dict[str, Any]],
    max_staleness_s: Optional[float] = None,
    session: Optional[Dict[str, int]] = None,
    trace: Optional[Dict[str, Any]] = None,
) -> bytes:
    doc: Dict[str, Any] = {"queries": list(queries)}
    if max_staleness_s is not None:
        doc["max_staleness_s"] = float(max_staleness_s)
    if session:
        doc["session"] = {str(o): int(s) for o, s in session.items()}
    if trace:
        # Request-scoped trace context (obs/rtrace.py): rides INSIDE the
        # canonical doc, so every transport carries it opaquely and a
        # legacy peer simply ignores the key.
        doc["trace"] = dict(trace)
    return encode(doc)


def _ceil6(x: float) -> float:
    """Round a staleness bound UP at µs precision — conservative by
    construction (a bound may only ever grow in transit)."""
    return math.ceil(max(0.0, x) * 1e6) / 1e6


class _Pending:
    __slots__ = (
        "queries", "max_staleness", "session", "done", "results", "error",
        "watermarks", "t_enq", "t_drain", "t_done",
    )

    def __init__(
        self,
        queries: List[Dict[str, Any]],
        max_staleness: Optional[float],
        session: Optional[Dict[str, int]] = None,
    ):
        self.queries = queries
        self.max_staleness = max_staleness
        self.session = session
        self.done = False
        self.results: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None
        # The applied-watermark claim for THIS caller's results: the wm
        # of the oldest snapshot any of its answers came from.
        self.watermarks: Optional[Dict[str, int]] = None
        # Stage marks on the plane's mono clock (enqueue -> drain ->
        # done), echoed to traced requests so the client waterfall can
        # split queue_wait from kernel time.
        self.t_enq = 0.0
        self.t_drain = 0.0
        self.t_done = 0.0


class _Batcher:
    """Bounded accumulate-and-drain queue. Any caller thread may become
    the drainer: the first arriver while no drain is running takes the
    whole pending list and answers it in one pass; threads that enqueued
    meanwhile wait on the condition and either find their result ready
    or become the next drainer. No dedicated thread, no idle latency —
    a lone request drains itself immediately, a burst coalesces."""

    def __init__(self, exec_batch: Callable[[List[_Pending]], None],
                 queue_max: int, metrics: Metrics,
                 mono: Callable[[], float] = time.monotonic):
        self._exec = exec_batch
        self.queue_max = max(1, int(queue_max))
        self.metrics = metrics
        self._mono = mono
        self._cv = threading.Condition()
        self._pending: List[_Pending] = []
        self._busy = False
        # Drain-rate EWMA (queries/s) behind the shed retry_after hint.
        self._drain_rate = 0.0

    def retry_after_ms(self, depth: int) -> int:
        """How long a shed caller should wait before retrying: the time
        the current backlog takes to drain at the observed rate, clamped
        to [1ms, 5s]. Before any drain has been timed, a flat 50ms."""
        rate = self._drain_rate
        if rate <= 0.0:
            return 50
        return max(1, min(5000, int(1000.0 * depth / rate)))

    def run(self, queries: List[Dict[str, Any]],
            max_staleness: Optional[float],
            session: Optional[Dict[str, int]] = None) -> _Pending:
        p = _Pending(queries, max_staleness, session)
        p.t_enq = self._mono()
        with self._cv:
            depth = sum(len(x.queries) for x in self._pending)
            if depth + len(queries) > self.queue_max:
                self.metrics.count("serve.queue_shed")
                raise Overloaded(
                    f"query queue full ({depth}+{len(queries)} > {self.queue_max})",
                    retry_after_ms=self.retry_after_ms(depth + len(queries)),
                )
            self._pending.append(p)
            while not p.done and self._busy:
                self._cv.wait(0.05)
            if not p.done:
                self._busy = True
                batch, self._pending = self._pending, []
        if not p.done:
            t0 = time.perf_counter()
            t_drain = self._mono()
            for x in batch:
                x.t_drain = t_drain
            try:
                self._exec(batch)
                t_done = self._mono()
                for x in batch:
                    x.t_done = t_done
                dt = time.perf_counter() - t0
                if dt > 0:
                    inst = sum(len(x.queries) for x in batch) / dt
                    self._drain_rate = (
                        inst if self._drain_rate == 0.0
                        else 0.8 * self._drain_rate + 0.2 * inst
                    )
            finally:
                # A drainer that died mid-batch must not strand followers.
                for x in batch:
                    if not x.done:
                        x.error = x.error or RuntimeError("batch aborted")
                        x.done = True
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()
        if p.error is not None:
            raise p.error
        return p


class ServePlane:
    """One worker's read-serving plane (see module docstring)."""

    def __init__(
        self,
        dense: Any,
        member: str = "?",
        metrics: Optional[Metrics] = None,
        lag_tracker: Any = None,
        mono: Callable[[], float] = time.monotonic,
        cache_cap: int = 1024,
        queue_max: int = 4096,
        meta_keep: int = 8,
        pager: Any = None,
    ):
        self.dense = dense
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        self.lag_tracker = lag_tracker
        # Out-of-core residency (core/pager.py): swaps resolve the
        # LOGICAL state (device ⊔ cold substrate) so reads never see a
        # demoted partition's hole, and answered row ids feed the
        # pager's recency clock — the serve plane IS the access stream
        # the eviction policy ranks partitions by.
        self.pager = pager
        self.mono = mono  # injectable: frozen in parity tests, virtual in sim
        self.replica = ReadReplica(metrics=self.metrics, mono=mono)
        self.cache = HotKeyCache(cap=cache_cap, metrics=self.metrics)
        self.meta_keep = max(1, int(meta_keep))
        # seq -> (swap_mono, lag_bound_s, watermarks): the staleness +
        # session pedigree window cached answers are bounded against.
        # Guarded: swap() runs on the round thread, _bound() /
        # _watermarks_at() on whichever listener thread drains.
        self._meta: "OrderedDict[int, Tuple[float, float, Dict[str, int]]]" = (
            OrderedDict()
        )
        self._meta_lock = threading.Lock()
        self._batcher = _Batcher(
            self._exec_batch, queue_max, self.metrics, mono=mono
        )

    # -- write side: the round thread ---------------------------------------

    def lag_bound_s(self) -> float:
        """How far behind the fleet's observed writes this worker could
        be right now: max over peers of (age of oldest unapplied delta +
        silence time). 0.0 with no tracker/peers (single-writer truth)."""
        lt = self.lag_tracker
        if lt is None:
            return 0.0
        rep = lt.report()
        return max(
            (r["lag_s"] + r["staleness_s"] for r in rep.values()), default=0.0
        )

    def applied_watermarks(self, seq: int) -> Dict[str, int]:
        """The per-origin applied watermarks a snapshot at `seq` covers:
        this worker's own stream through `seq`, plus — via the lag
        tracker — each peer's stream through what has been applied
        locally. This is the session-token coverage claim responses
        carry."""
        wm: Dict[str, int] = {self.member: int(seq)}
        lt = self.lag_tracker
        if lt is not None:
            for peer, r in lt.report().items():
                wm[str(peer)] = int(r.get("applied", -1))
        return wm

    def swap(self, state: Any, seq: int) -> None:
        """Publish-boundary hook: snapshot `state` as the live read
        replica at `seq`, stamped with the current lag bound and the
        applied watermarks (the session pedigree)."""
        resolve = None
        if self.pager is not None and self.pager.has_cold():
            resolve = self.pager.full_state
        snap = self.replica.swap(state, seq, self.lag_bound_s(), resolve=resolve)
        wm = self.applied_watermarks(snap.seq)
        with self._meta_lock:
            self._meta[snap.seq] = (snap.swap_mono, snap.lag_bound_s, wm)
            while len(self._meta) > self.meta_keep:
                self._meta.popitem(last=False)
            horizon = min(self._meta)
        self.cache.purge_below(horizon)

    # -- read side: listener threads ----------------------------------------

    def handle(self, raw: bytes, surface: str = "local") -> bytes:
        """The one entry point every wire surface calls; response bytes
        are carried verbatim (byte-identical across surfaces — `surface`
        only labels shed metrics, it never enters the response)."""
        if faults.ACTIVE:
            faults.fire("serve.query")  # injected stall/raise per surface
        t0 = time.perf_counter()
        m_in = self.mono()
        ctx = None  # request trace context (obs/rtrace.py), when carried
        self.metrics.count("serve.requests")

        def _echo(doc: Dict[str, Any], p: Optional[_Pending] = None,
                  **extra: Any) -> Dict[str, Any]:
            """Attach the server-side hop timings iff the request was
            traced — an untraced request's response stays byte-identical
            to the pre-trace wire format (tri-surface parity)."""
            if ctx is None:
                return doc
            marks = {"m_in": m_in, "m_out": self.mono()}
            if p is not None:
                marks.update(m_q=p.t_enq, m_drain=p.t_drain,
                             m_done=p.t_done)
            if devprof.ACTIVE:
                # Compile time the device observatory saw inside this
                # hop's window — the kernel bucket's honesty
                # sub-annotation (obs/rtrace.py attribute()).
                cms = devprof.compile_ms_in_window(m_in, marks["m_out"])
                if cms > 0.0:
                    extra.setdefault("compile_ms", cms)
            doc["rtrace"] = rtrace.server_echo(ctx, self.member, marks,
                                               **extra)
            return doc

        try:
            req = json.loads(bytes(raw).decode("utf-8"))
            ctx = rtrace.server_trace(req)
            queries = req["queries"]
            if not isinstance(queries, list) or not all(
                isinstance(q, dict) for q in queries
            ):
                raise ValueError("queries must be a list of objects")
            ms = req.get("max_staleness_s")
            ms = None if ms is None else float(ms)
            sess = req.get("session")
            if sess is not None:
                if not isinstance(sess, dict):
                    raise ValueError("session must be an {origin: seq} object")
                sess = {str(o): int(s) for o, s in sess.items()}
        except Exception as e:  # noqa: BLE001 — malformed input degrades
            self.metrics.count("serve.errors")
            return encode({"member": self.member, "error": f"bad request: {e}"})
        try:
            p = self._batcher.run(queries, ms, sess)
        except Overloaded as e:
            self.metrics.count(f"serve.queue_shed.{surface}")
            return encode(_echo({
                "member": self.member, "error": f"overloaded: {e}",
                "retry_after_ms": e.retry_after_ms,
            }))
        except SessionUncovered as e:
            # Honest refusal: serving would violate the session token.
            # The watermarks tell the router exactly how far behind we
            # are so it can route (or wait) intelligently.
            self.metrics.count("serve.session_uncovered")
            return encode(_echo({
                "member": self.member, "error": f"session_uncovered: {e}",
                "watermarks": e.watermarks,
            }))
        except Exception as e:  # noqa: BLE001 — the batch never hangs a caller
            self.metrics.count("serve.errors")
            return encode(_echo({"member": self.member, "error": str(e)}))
        results = p.results or []
        self.metrics.merge(
            {"latencies": {"serve.read": [time.perf_counter() - t0]}}
        )
        obs_events.emit("serve.query", n=len(queries), max_staleness_s=ms)
        doc: Dict[str, Any] = {
            "member": self.member, "n": len(results), "results": results,
        }
        if p.watermarks is not None:
            doc["watermarks"] = p.watermarks
        return encode(_echo(
            doc, p,
            kernel_ms=round(max(0.0, p.t_done - p.t_drain) * 1e3, 3),
            queued=len(queries),
        ))

    def handler_for(self, surface: str) -> Callable[[bytes], bytes]:
        """A `handle` bound to a surface label — what `install_serve`
        sites register so sheds are attributable per surface."""
        return lambda raw: self.handle(raw, surface=surface)

    def query(
        self,
        queries: List[Dict[str, Any]],
        max_staleness_s: Optional[float] = None,
        session: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Any]:
        """In-process convenience: encode, handle, decode."""
        return json.loads(
            self.handle(
                request_bytes(queries, max_staleness_s, session)
            ).decode("utf-8")
        )

    # -- batch execution (single drainer at a time) --------------------------

    def _bound(self, seq: int) -> Optional[float]:
        with self._meta_lock:
            meta = self._meta.get(seq)
        if meta is None:
            return None
        swap_mono, lag_bound = meta[0], meta[1]
        return (self.mono() - swap_mono) + lag_bound

    def _watermarks_at(self, seq: int) -> Optional[Dict[str, int]]:
        with self._meta_lock:
            meta = self._meta.get(seq)
        return dict(meta[2]) if meta is not None else None

    def _exec_batch(self, batch: List[_Pending]) -> None:
        nq = sum(len(p.queries) for p in batch)
        self.metrics.count("serve.batches")
        self.metrics.count("serve.queries", nq)
        live = self.replica.live()
        live_wm = (
            self._watermarks_at(live.seq) if live is not None else None
        )
        if live_wm is None and live is not None:
            live_wm = self.applied_watermarks(live.seq)
        bounds: List[float] = []
        for p in batch:
            if p.session:
                gp = session_gaps(live_wm or {}, p.session)
                if gp:
                    origin, (have, want) = next(iter(sorted(gp.items())))
                    p.error = SessionUncovered(
                        f"{origin} applied {have} < required {want}",
                        live_wm or {},
                    )
                    p.done = True
                    continue
            seqs: List[int] = []
            p.results = [self._one(q, p.max_staleness, live, bounds, seqs,
                                   p.session)
                         for q in p.queries]
            # The response-level coverage claim must hold for EVERY
            # result, so it is the wm of the OLDEST snapshot used —
            # watermarks are monotone in seq, so that is the pointwise
            # minimum (conservative for the rest).
            if seqs:
                p.watermarks = self._watermarks_at(min(seqs))
                if p.watermarks is None:
                    # Pedigree raced out of the window: claim only what
                    # is true by construction — our own stream.
                    p.watermarks = {self.member: int(min(seqs))}
            elif live_wm is not None:
                p.watermarks = dict(live_wm)
            p.done = True
        if bounds:
            self.metrics.merge({"latencies": {"serve.staleness_bound": bounds}})

    def _one(
        self,
        q: Dict[str, Any],
        ms: Optional[float],
        live: Any,
        bounds: List[float],
        seqs: Optional[List[int]] = None,
        session: Optional[Dict[str, int]] = None,
    ) -> Dict[str, Any]:
        try:
            kq = kernels.query_key(q)
        except Exception as e:  # noqa: BLE001 — one bad query, one error slot
            self.metrics.count("serve.errors")
            return {"error": f"bad query: {e}"}
        hit = self.cache.get(kq)
        if hit is not None:
            val, seq = hit
            b = self._bound(seq)
            if b is not None:
                b6 = _ceil6(b)
                # No knob: only the live seq's own memo qualifies (reads
                # default to the freshest snapshot). A knob explicitly
                # opts into any cached answer inside the bound.
                ok = (
                    b6 <= ms
                    if ms is not None
                    else (live is None or seq == live.seq)
                )
                if ok and session and not (live is None or seq == live.seq):
                    # An aged cached answer must ALSO cover the session
                    # token at ITS OWN snapshot — the batch-level check
                    # only vouched for the live one.
                    wm = self._watermarks_at(seq)
                    ok = wm is not None and not session_gaps(wm, session)
                if ok:
                    self.metrics.count("serve.cache_hits")
                    bounds.append(b6)
                    if seqs is not None:
                        seqs.append(int(seq))
                    return {"value": val, "as_of_seq": seq,
                            "staleness_bound_s": b6}
        # Fall through to the fresh replica.
        if live is None:
            self.metrics.count("serve.errors")
            return {"error": "no snapshot"}
        if live.view is None:
            live.view = kernels.materialize(self.dense, live.state)
        # Bound stamped AFTER materialization: the answer leaves the
        # plane no earlier than this instant, and a bound only ages —
        # stamping before a (possibly compiling) materialize would
        # under-report by its duration.
        b = self._bound(live.seq)
        if b is None:  # pedigree raced out of the window: recompute direct
            b = (self.mono() - live.swap_mono) + live.lag_bound_s
        b6 = _ceil6(b)
        if ms is not None and b6 > ms:
            self.metrics.count("serve.stale_rejects")
            return {"error": "stale", "staleness_bound_s": b6,
                    "max_staleness_s": ms}
        self.metrics.count("serve.cache_misses")
        try:
            val = kernels.answer_one(live.view, q)
        except ValueError as e:
            self.metrics.count("serve.errors")
            return {"error": str(e)}
        self._note_access(q, val)
        self.cache.put(kq, val, live.seq)
        bounds.append(b6)
        if seqs is not None:
            seqs.append(int(live.seq))
        return {"value": val, "as_of_seq": live.seq, "staleness_bound_s": b6}

    def _note_access(self, q: Dict[str, Any], val: Any) -> None:
        """Feed the pager's recency clock with the row ids this answer
        touched (topk/range answers are [id, score] pairs; a value query
        names its id directly)."""
        if self.pager is None:
            return
        try:
            ids: List[int] = []
            if q.get("op") == "value" and isinstance(q.get("key"), int):
                ids.append(int(q["key"]))
            if isinstance(val, list):
                ids.extend(
                    int(pair[0]) for pair in val
                    if isinstance(pair, (list, tuple)) and len(pair) >= 1
                )
            if ids:
                self.pager.note_ids(ids)
        except Exception:  # noqa: BLE001 — policy feed only, stay total
            pass

    # -- health --------------------------------------------------------------

    def health_fields(self) -> Dict[str, Any]:
        """Readiness view for /healthz: what seq the replica serves and
        how stale it could be — what an LB needs to drain stale replicas,
        plus the pager's residency picture when paging is on."""
        live = self.replica.live()
        if live is None:
            out: Dict[str, Any] = {
                "serve_seq": -1, "serve_staleness_bound_s": None,
                "serve_cache_entries": len(self.cache),
            }
        else:
            b = self._bound(live.seq)
            if b is None:
                b = (self.mono() - live.swap_mono) + live.lag_bound_s
            out = {
                "serve_seq": live.seq,
                "serve_staleness_bound_s": _ceil6(b),
                "serve_cache_entries": len(self.cache),
            }
        if self.pager is not None:
            out.update(self.pager.health_fields())
        if devprof.ACTIVE:
            out.update(devprof.health_fields())
        return out
