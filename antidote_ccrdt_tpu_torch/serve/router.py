"""`FleetRouter`: staleness-aware fleet query routing with failover.

One worker's `ServePlane` answers queries; a FLEET of them needs a
client-side router that decides *which* replica answers and what happens
when that replica is slow, stale, overloaded, or dead mid-query. This
module is that router, deliberately transport-agnostic: the caller
injects ``query_fn(peer, payload, timeout_s, cancel) -> bytes`` (TCP
`net.tcp.query_peer`, the sim transport, or direct in-process dispatch
in benches) and the router owns only the *policy*:

* **Candidate order** is `topo.anchor.rendezvous_order(key, peers)` —
  the same HRW ranking the anchor election uses, so every client walks
  the same preference list for the same key (cache affinity) and a
  peer's death never reorders the survivors. Peers whose observed
  staleness exceeds ``stale_soft_s`` are demoted to a second bucket
  (stable within each bucket): prefer fresh replicas, but a stale one
  still beats an error.
* **Degradation ladder — hedge → retry → failover → shed.** A request
  that runs past the peer's learned p99 latency gets a *hedged* twin on
  the next candidate (first success wins; the loser is cancelled and
  billed `router.hedge_wasted`). A failed attempt fails over to the
  next HRW candidate (`router.failovers`); a fully failed pass retries
  after jittered exponential backoff (`router.retries`, bounded). Only
  when every candidate sheds does the router return the shed — honestly,
  with the largest `retry_after_ms` hint the fleet offered — rather
  than queueing the overload somewhere invisible.
* **Mid-query failover** is idempotent by construction: responses carry
  ``(value, as_of_seq, staleness_bound_s)``, so re-asking another
  replica can only re-answer, never double-apply. A SWIM ``dead``
  verdict (injected `verdict_fn`) observed while an attempt is in
  flight cancels it and reroutes immediately — the router does not wait
  out the timeout of a peer the membership layer already buried.
* **Per-peer circuit breakers**: consecutive failures open the breaker
  (candidates are skipped while open); after ``breaker_cooldown_s`` one
  half-open probe is allowed through and either closes it or re-opens.
* **Session guarantees**: a query may carry a `serve.session` token
  (``{origin: seq}`` floor). The router routes only to peers whose
  last-learned applied watermarks cover the token (unknown peers are
  tried optimistically — the serving plane re-checks and answers
  ``session_uncovered``, teaching the router that peer's watermarks).
  If no live peer can cover the token the router waits up to
  ``session_wait_s`` (`router.session_waits`) and then fails honestly
  with ``session_unsatisfiable`` + the exact per-origin gaps, never
  silently serving a token-violating answer. A pass that failed on
  every covering peer, while the others were left out on coverage
  alone, waits the same way before it spends a retry round: the
  next round would only ask the same peers again. (JAX's router spends
  the round, so a floor that one peer covers ends ``unavailable`` after
  three transient faults of that peer in a row.) ``session_mode="ignore"``
  strips the token from the wire (while still flight-recording what the
  session *required*) — the deliberately-violating arm the audit layer
  (`obs.audit.certify_sessions`) must catch.

Every decision is metered (`router.*` counters below) into the shared
`Metrics` registry, so the counters ride all three scrape surfaces for
free, and `utils.faults` point ``router.route`` fires per attempt so
chaos drills can inject routing-layer drops/stalls/raises.
"""

from __future__ import annotations

import json
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..obs import events as obs_events, rtrace
from ..utils import faults
from ..utils.metrics import Metrics
from .routing_common import (  # noqa: F401 — CircuitBreaker + states
    CLOSED,
    HALF_OPEN,
    OPEN,
    BreakerBoard,
    CircuitBreaker,
    candidate_order,
)
from .session import ClientSession, gaps as session_gaps, session_doc


class _Attempt:
    """One in-flight query attempt on one peer, run on a worker thread
    so the router's main loop can watch verdicts / trigger hedges /
    enforce deadlines while the transport blocks."""

    __slots__ = ("peer", "cancel", "done", "result", "error", "t0")

    def __init__(self, peer: str):
        self.peer = peer
        self.cancel = threading.Event()
        self.done = threading.Event()
        self.result: Optional[bytes] = None
        self.error: Optional[BaseException] = None
        self.t0 = 0.0


class FleetRouter:
    """Client-side fleet query router (see module docstring).

    Parameters the policy hangs off:

    peers        iterable OR callable returning the current peer names
                 (callable = live view, e.g. SWIM alive set + self).
    query_fn     (peer, payload_bytes, timeout_s, cancel_event) -> bytes;
                 raises (TimeoutError / OSError / ...) on failure. MUST
                 eventually return or raise within ~timeout_s; `cancel`
                 being set asks it to abandon the attempt early.
    verdict_fn   peer -> "alive" | "suspect" | "dead" (SWIM `state_of`);
                 None = everyone alive. "dead" peers are skipped up
                 front AND reroute in-flight attempts.
    staleness_fn peer -> observed staleness seconds (fed from
                 `obs.lag.LagTracker.report`); peers beyond
                 `stale_soft_s` sort behind fresh ones.
    hedge_after_s  fixed hedge trigger; None = learned per-peer p99
                 (needs `hedge_min_samples` observations first, so cold
                 routers never hedge blindly).
    session_mode "enforce" (default) routes/verifies tokens;
                 "ignore" strips them from the wire while still
                 recording requirements — the audit layer's negative
                 control.
    """

    def __init__(
        self,
        peers: Any,
        query_fn: Callable[[str, bytes, float, threading.Event], bytes],
        member: str = "router",
        metrics: Optional[Metrics] = None,
        verdict_fn: Optional[Callable[[str], str]] = None,
        staleness_fn: Optional[Callable[[str], float]] = None,
        stale_soft_s: float = 1.0,
        timeout_s: float = 2.0,
        retries: int = 2,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 1.0,
        hedge: bool = True,
        hedge_after_s: Optional[float] = None,
        hedge_min_samples: int = 8,
        breaker_failures: int = 3,
        breaker_cooldown_s: float = 2.0,
        session_mode: str = "enforce",
        session_wait_s: float = 1.0,
        session_poll_s: float = 0.05,
        mono: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        poll_s: float = 0.005,
        seed: int = 0,
        breakers: Optional[BreakerBoard] = None,
    ):
        if session_mode not in ("enforce", "ignore"):
            raise ValueError("session_mode must be 'enforce' or 'ignore'")
        self._peers_src = peers
        self.query_fn = query_fn
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        self.verdict_fn = verdict_fn
        self.staleness_fn = staleness_fn
        self.stale_soft_s = float(stale_soft_s)
        self.timeout_s = float(timeout_s)
        self.retries = max(0, int(retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.hedge = bool(hedge)
        self.hedge_after_s = hedge_after_s
        self.hedge_min_samples = max(1, int(hedge_min_samples))
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.session_mode = session_mode
        self.session_wait_s = float(session_wait_s)
        self.session_poll_s = float(session_poll_s)
        self.mono = mono
        self.sleep = sleep
        self.poll_s = float(poll_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # Shared with the write tier when the caller passes one board:
        # a peer that fails writes is demoted for reads too.
        self._board = (
            breakers
            if breakers is not None
            else BreakerBoard(breaker_failures, breaker_cooldown_s, mono)
        )
        # peer -> last-learned applied watermarks {origin: seq}, taught
        # by every response (success OR session_uncovered rejection).
        self._peer_watermarks: Dict[str, Dict[str, int]] = {}
        # peer -> recent latency samples (seconds) for the p99 hedge
        # trigger; bounded so estimates track the peer's present.
        self._lat: Dict[str, deque] = {}

    # -- introspection -------------------------------------------------------

    def _peers(self) -> List[str]:
        src = self._peers_src
        out = src() if callable(src) else src
        return [str(p) for p in out]

    def breaker(self, peer: str) -> CircuitBreaker:
        return self._board.get(peer)

    def peer_watermarks(self, peer: str) -> Optional[Dict[str, int]]:
        with self._lock:
            wm = self._peer_watermarks.get(peer)
            return dict(wm) if wm is not None else None

    def _learn_watermarks(self, peer: str, wm: Any) -> None:
        if not isinstance(wm, dict):
            return
        try:
            clean = {str(o): int(s) for o, s in wm.items()}
        except (TypeError, ValueError):
            return
        with self._lock:
            # Pointwise max: watermarks only advance; a racing older
            # response must not regress what we know the peer covers.
            cur = self._peer_watermarks.setdefault(peer, {})
            for o, s in clean.items():
                if s > cur.get(o, -1):
                    cur[o] = s

    def status(self) -> Dict[str, Any]:
        """Dashboard feed: per-peer breaker state + learned watermark
        height, plus the counters the column group renders."""
        breakers = self._board.states()
        with self._lock:
            wms = {
                p: (max(wm.values()) if wm else -1)
                for p, wm in self._peer_watermarks.items()
            }
        snap = self.metrics.snapshot()["counters"]
        return {
            "breakers": breakers,
            "peer_wm_max": wms,
            "counters": {
                k: v for k, v in snap.items() if k.startswith("router.")
            },
        }

    # -- candidate selection -------------------------------------------------

    def route(
        self, key: str, token: Optional[Dict[str, int]] = None
    ) -> Tuple[List[str], bool]:
        """The eligible candidate list for `key`, in preference order,
        plus a flag: True iff peers were excluded ONLY by session
        coverage (so waiting could help). HRW order, fresh-staleness
        bucket first, dead peers and open breakers dropped — the shared
        walk (`routing_common.candidate_order`), then the read tier's
        session-coverage filter on top."""
        out, excluded = self._candidates(key, token)
        return out, excluded and not out

    def _candidates(
        self, key: str, token: Optional[Dict[str, int]] = None
    ) -> Tuple[List[str], bool]:
        """`route`'s walk: the candidates, plus a flag: True iff some live
        peer was left out on session coverage alone."""
        ordered = candidate_order(
            key,
            self._peers(),
            verdict_fn=self.verdict_fn,
            breakers=self._board,
            staleness_fn=self.staleness_fn,
            stale_soft_s=self.stale_soft_s if self.staleness_fn else -1.0,
        )
        out: List[str] = []
        session_starved = False
        enforce = token and self.session_mode == "enforce"
        for p in ordered:
            if enforce:
                wm = self.peer_watermarks(p)
                # Unknown peer: optimistic — the plane re-checks and a
                # session_uncovered reply teaches us its watermarks.
                if wm is not None and session_gaps(wm, token):
                    session_starved = True
                    continue
            out.append(p)
        return out, session_starved

    # -- the query path ------------------------------------------------------

    def query(
        self,
        queries: List[Dict[str, Any]],
        key: Optional[str] = None,
        max_staleness_s: Optional[float] = None,
        session: Optional[Any] = None,
    ) -> Dict[str, Any]:
        """Route one query batch. `key` picks the HRW affinity (defaults
        to the first query's key field); `session` is a ClientSession,
        SessionToken, or raw ``{origin: seq}`` dict. Returns the decoded
        response dict, augmented with ``"peer"`` (who answered). Never
        raises for routing-layer failures — errors come back as honest
        ``{"error": ...}`` documents (unavailable / overloaded /
        session_unsatisfiable), so callers cannot hang and cannot
        mistake a failure for a value."""
        t0 = self.mono()
        self.metrics.count("router.queries")
        sess = session if isinstance(session, ClientSession) else None
        token = session_doc(
            sess.requirement() if sess is not None else session
        ) or {}
        if key is None:
            key = str(queries[0].get("key", "")) if queries else ""
        tr = rtrace.begin("read", key, t0) if rtrace.ACTIVE else None
        doc: Dict[str, Any] = {"queries": list(queries)}
        if max_staleness_s is not None:
            doc["max_staleness_s"] = float(max_staleness_s)
        if token and self.session_mode == "enforce":
            doc["session"] = token
        if tr is not None:
            # Only head-sampled traces ride the wire (server echo cost
            # scales with the sample rate); the payload stays opaque to
            # every transport, so no frame format changes.
            w = tr.wire()
            if w:
                doc["trace"] = w
        payload = (
            json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"
        ).encode("utf-8")

        last_err: Optional[str] = None
        shed_hint: Optional[int] = None
        all_sheds = True  # falsified by any non-shed failure
        session_wait_deadline: Optional[float] = None
        round_i = 0
        first_route = True
        while round_i <= self.retries:
            # The first route hop opens at t0 so request prep (token +
            # payload build) lands in the route bucket instead of
            # leaking out of attribution coverage.
            t_route = t0 if first_route else self.mono()
            first_route = False
            order, excluded = self._candidates(key, token)
            starved = excluded and not order
            if tr is not None:
                # The route decision IS evidence: candidate order plus
                # the breaker verdicts that shaped it (closed breakers
                # shape nothing, so only open/half-open ride along).
                tr.hop("route", t_route, self.mono(),
                       candidates=list(order), starved=bool(starved),
                       breakers={p: s for p, s
                                 in self._board.states().items()
                                 if s != "closed"})
            if not order:
                if starved:
                    # Every live peer is excluded only by session
                    # coverage: wait for replication to catch up rather
                    # than burning retry rounds.
                    now = self.mono()
                    if session_wait_deadline is None:
                        session_wait_deadline = now + self.session_wait_s
                        self.metrics.count("router.session_waits")
                    if now < session_wait_deadline:
                        self.sleep(self.session_poll_s)
                        if tr is not None:
                            tr.hop("backoff", now, self.mono(),
                                   reason="session_wait")
                        continue
                    return self._finish_error(
                        t0, "session_unsatisfiable",
                        {"gaps": self._session_gaps(token)},
                        counter="router.session_unsatisfiable", tr=tr,
                    )
                last_err = last_err or "no eligible peers"
                all_sheds = False
                round_i += 1
                self._backoff(round_i, tr)
                continue
            outcome = self._run_pass(order, payload, token, tr)
            kind, detail = outcome[0], outcome[1]
            if kind == "ok":
                resp, peer = detail
                return self._finish_ok(t0, resp, peer, sess, token, tr)
            if kind == "uncovered":
                # Every candidate refused on session coverage (and
                # taught us its watermarks): this is replication lag,
                # not failure — wait it out, don't burn retry rounds.
                now = self.mono()
                if session_wait_deadline is None:
                    session_wait_deadline = now + self.session_wait_s
                    self.metrics.count("router.session_waits")
                if now >= session_wait_deadline:
                    return self._finish_error(
                        t0, "session_unsatisfiable",
                        {"gaps": self._session_gaps(token)},
                        counter="router.session_unsatisfiable", tr=tr,
                    )
                self.sleep(self.session_poll_s)
                if tr is not None:
                    tr.hop("backoff", now, self.mono(),
                           reason="session_wait")
                continue
            if kind == "err" and excluded:
                # Every peer that covers the token failed and the rest
                # lag it: another round would ask the same peers again.
                # Wait for them (or for replication) first.
                last_err, all_sheds = str(detail), False
                now = self.mono()
                if session_wait_deadline is None:
                    session_wait_deadline = now + self.session_wait_s
                    self.metrics.count("router.session_waits")
                if now < session_wait_deadline:
                    self.sleep(self.session_poll_s)
                    if tr is not None:
                        tr.hop("backoff", now, self.mono(),
                               reason="session_wait")
                    continue
            if kind == "shed":
                shed_hint = max(shed_hint or 0, int(detail or 0))
                last_err = "overloaded"
            else:
                all_sheds = False
                last_err = str(detail)
            round_i += 1
            if round_i <= self.retries:
                self.metrics.count("router.retries")
                self._backoff(round_i, tr)
        if shed_hint is not None and all_sheds:
            self.metrics.count("router.shed_returns")
            return self._finish_error(
                t0, "overloaded", {"retry_after_ms": shed_hint}, tr=tr,
            )
        return self._finish_error(
            t0, "unavailable", {"detail": last_err},
            counter="router.exhausted", tr=tr,
        )

    # -- one pass over the candidate list ------------------------------------

    def _run_pass(
        self, order: List[str], payload: bytes, token: Dict[str, int],
        tr: Optional[rtrace.Trace] = None,
    ) -> Tuple[str, Any]:
        """Walk `order` once. Returns ("ok", (resp, peer)) on success;
        ("uncovered", detail) when EVERY outcome was a session-coverage
        refusal (waiting can help); ("shed", retry_after_ms) when at
        least one peer shed and no one answered; ("err", detail)
        otherwise."""
        shed_hint: Optional[int] = None
        saw_shed = False
        saw_err = False
        saw_uncovered = False
        last_detail: Any = "no candidates"
        idx = 0
        while idx < len(order):
            peer = order[idx]
            if faults.ACTIVE:
                try:
                    if faults.fire("router.route") == "drop":
                        # Injected route loss == connection loss: bill a
                        # failover and walk on.
                        raise ConnectionError("router.route: injected drop")
                except faults.InjectedFault as e:
                    self._fail(peer, e)
                    last_detail = str(e)
                    saw_err = True
                    idx += 1
                    if idx < len(order):
                        self.metrics.count("router.failovers")
                    continue
                except ConnectionError as e:
                    self._fail(peer, e)
                    last_detail = str(e)
                    saw_err = True
                    idx += 1
                    if idx < len(order):
                        self.metrics.count("router.failovers")
                    continue
            hedge_peer = order[idx + 1] if idx + 1 < len(order) else None
            verdict, detail = self._attempt(peer, hedge_peer, payload, tr)
            if verdict == "ok":
                resp, who, a0, a1 = detail
                kind, fine = self._classify(who, resp, token, tr, a0, a1)
                if kind == "ok":
                    return ("ok", (fine, who))
                if kind == "shed":
                    saw_shed = True
                    shed_hint = max(shed_hint or 0, int(fine or 0))
                    last_detail = "overloaded"
                elif kind == "uncovered":
                    saw_uncovered = True
                    last_detail = fine
                else:
                    saw_err = True
                    last_detail = fine
                idx += 1
                if idx < len(order):
                    self.metrics.count("router.failovers")
                continue
            if verdict == "hedge_ok":
                # The hedge (order[idx+1]) answered; classify under ITS name.
                resp, who, a0, a1 = detail
                kind, fine = self._classify(who, resp, token, tr, a0, a1)
                if kind == "ok":
                    return ("ok", (fine, who))
                if kind == "shed":
                    saw_shed = True
                    shed_hint = max(shed_hint or 0, int(fine or 0))
                elif kind == "uncovered":
                    saw_uncovered = True
                    last_detail = fine
                else:
                    saw_err = True
                    last_detail = fine
                idx += 2  # both primary and hedge are spent
                if idx < len(order):
                    self.metrics.count("router.failovers")
                continue
            # dead / timeout / error on every leg of the attempt
            saw_err = True
            last_detail = detail
            idx += 1
            if idx < len(order):
                self.metrics.count("router.failovers")
        if saw_uncovered and not saw_err and not saw_shed:
            return ("uncovered", last_detail)
        if saw_shed:
            return ("shed", shed_hint)
        return ("err", last_detail)

    def _attempt(
        self, peer: str, hedge_peer: Optional[str], payload: bytes,
        tr: Optional[rtrace.Trace] = None,
    ) -> Tuple[str, Any]:
        """One (possibly hedged) attempt. Returns
        ("ok", (raw, peer, t_send, t_recv)),
        ("hedge_ok", (raw, hedge_peer, t_send, t_recv)), or
        ("fail", detail). The main thread watches: completion, the
        peer's SWIM verdict (dead -> cancel + reroute), the hedge
        trigger, and the deadline."""
        t_entry = self.mono()
        self.metrics.count("router.attempts")
        primary = self._launch(peer, payload)
        # The attempt window opens at _attempt entry: breaker/thread
        # launch setup is attempt cost, and the waterfall's wire bucket
        # (attempt union minus server time) must account for it.
        primary.t0 = t_entry
        hedge: Optional[_Attempt] = None
        deadline = primary.t0 + self.timeout_s
        hedge_at = self._hedge_at(peer, primary.t0, hedge_peer)
        primary_dead = False
        while True:
            if primary.done.is_set() and (
                primary.error is None or hedge is None or hedge.done.is_set()
            ):
                break
            if hedge is not None and hedge.done.is_set() and (
                hedge.error is None or primary.done.is_set()
            ):
                break
            now = self.mono()
            if now >= deadline:
                break
            if (
                not primary_dead
                and not primary.done.is_set()
                and self.verdict_fn is not None
                and self.verdict_fn(peer) == "dead"
            ):
                # SWIM buried the peer mid-query: stop waiting for it.
                # One-shot (guarded by `primary_dead`): later poll ticks
                # must not re-bill the same death.
                primary_dead = True
                primary.cancel.set()
                self.metrics.count("router.dead_reroutes")
                if tr is not None:
                    tr.hop("dead_reroute", now, peer=peer)
                if hedge is None:
                    self._fail(peer, TimeoutError("peer died mid-query"))
                    if tr is not None:
                        tr.hop("attempt", primary.t0, now, peer=peer,
                               ok=False, err="dead mid-query")
                    return ("fail", f"{peer} dead mid-query")
                # A hedge is still running — let it finish out the deadline.
                hedge_at = None
                deadline = min(deadline, now + self.timeout_s)
            if primary_dead and hedge is not None and hedge.done.is_set():
                return self._settle(primary, hedge, peer, dead=True, tr=tr)
            if (
                hedge is None
                and hedge_at is not None
                and now >= hedge_at
                and not primary.done.is_set()
            ):
                self.metrics.count("router.hedges")
                if tr is not None:
                    tr.hop("hedge_launch", now, peer=hedge_peer,
                           primary=peer)
                hedge = self._launch(hedge_peer, payload)  # type: ignore[arg-type]
            self.sleep(self.poll_s)
        return self._settle(primary, hedge, peer, dead=primary_dead, tr=tr)

    def _settle(
        self,
        primary: _Attempt,
        hedge: Optional[_Attempt],
        peer: str,
        dead: bool = False,
        tr: Optional[rtrace.Trace] = None,
    ) -> Tuple[str, Any]:
        """Pick the winner, cancel the loser, bill the hedge. Every
        attempt that LAUNCHED resolves its breaker here — success,
        failure, or an explicit `release_probe` for cancelled/undone
        attempts — so a half-open probe reservation can never leak."""
        now = self.mono()
        p_ok = primary.done.is_set() and primary.error is None
        h_ok = (
            hedge is not None and hedge.done.is_set() and hedge.error is None
        )

        def _att_hop(att: _Attempt, ok: bool, **f: Any) -> None:
            if tr is not None:
                tr.hop("attempt", att.t0, now, peer=att.peer, ok=ok, **f)

        if p_ok and not dead:
            if hedge is not None:
                hedge.cancel.set()
                self.metrics.count("router.hedge_wasted")
                self._abandon(hedge)
                _att_hop(hedge, False, hedge=True, wasted=True)
            self._succeed(primary)
            _att_hop(primary, True)
            return ("ok", (primary.result, primary.peer, primary.t0, now))
        if h_ok:
            primary.cancel.set()
            if p_ok:
                # SWIM-dead primary raced an answer in anyway; we chose
                # the hedge, so give back any probe the primary held
                # rather than billing a failure for a discarded success.
                self.breaker(peer).release_probe()
                _att_hop(primary, False, discarded="dead")
            else:
                self._fail(peer, primary.error or TimeoutError(
                    "peer died mid-query" if dead else "hedged out"
                ))
                _att_hop(primary, False,
                         err="dead mid-query" if dead else "hedged out")
            self.metrics.count("router.hedge_wins")
            self._succeed(hedge)  # type: ignore[arg-type]
            _att_hop(hedge, True, hedge=True)  # type: ignore[arg-type]
            return ("hedge_ok",  # type: ignore[union-attr]
                    (hedge.result, hedge.peer, hedge.t0, now))
        # Nobody won: cancel stragglers, bill the failure(s).
        primary.cancel.set()
        if hedge is not None:
            hedge.cancel.set()
            self._abandon(hedge)
            _att_hop(hedge, False, hedge=True)
        if primary.done.is_set() and primary.error is not None:
            self._fail(peer, primary.error)
            _att_hop(primary, False, err=str(primary.error))
            return ("fail", f"{peer}: {primary.error}")
        if p_ok:
            # (dead=True) The primary answered but SWIM buried it and no
            # hedge won: discard the answer, give the probe slot back.
            self.breaker(peer).release_probe()
            _att_hop(primary, False, discarded="dead")
            return ("fail", f"{peer} dead mid-query")
        self.metrics.count("router.timeouts")
        self._fail(peer, TimeoutError("query deadline exceeded"))
        _att_hop(primary, False, err="timeout")
        return ("fail", f"{peer}: timeout after {self.timeout_s}s")

    def _abandon(self, att: _Attempt) -> None:
        """Resolve the breaker for a cancelled/discarded attempt: bill
        what actually happened, or — if it never finished — just release
        the half-open probe slot it may be holding."""
        if att.done.is_set():
            if att.error is None:
                self._succeed(att)
            else:
                self._fail(att.peer, att.error)
        else:
            self.breaker(att.peer).release_probe()

    def _launch(self, peer: str, payload: bytes) -> _Attempt:
        # Reserve the half-open probe slot (if any) only now, when the
        # attempt actually goes out — `route()` filtered read-only, so
        # listed-but-untried candidates never consume it. `_settle`
        # guarantees the reservation is resolved or released.
        self.breaker(peer).allow()
        att = _Attempt(peer)
        att.t0 = self.mono()

        def run() -> None:
            try:
                att.result = self.query_fn(
                    peer, payload, self.timeout_s, att.cancel
                )
            except BaseException as e:  # noqa: BLE001 — surfaced via att.error
                att.error = e
            finally:
                att.done.set()

        threading.Thread(
            target=run, name=f"router-q-{peer}", daemon=True
        ).start()
        return att

    # -- response classification --------------------------------------------

    def _classify(
        self, peer: str, raw: Optional[bytes], token: Dict[str, int],
        tr: Optional[rtrace.Trace] = None,
        t_send: Optional[float] = None, t_recv: Optional[float] = None,
    ) -> Tuple[str, Any]:
        """("ok", resp_dict) | ("shed", retry_after_ms) |
        ("uncovered", detail) | ("err", detail)."""
        try:
            resp = json.loads(bytes(raw or b"").decode("utf-8"))
        except Exception as e:  # noqa: BLE001 — garbage == peer failure
            self.metrics.count("router.errors")
            self._fail(peer, e)
            return ("err", f"{peer}: undecodable response: {e}")
        echo = resp.pop("rtrace", None) if isinstance(resp, dict) else None
        if tr is not None and isinstance(echo, dict) \
                and t_send is not None and t_recv is not None:
            # (attempt send, server mid, attempt recv) is an NTP
            # exchange: absorb feeds the plane's ClockSync too.
            tr.absorb_echo(echo, t_send, t_recv)
        self._learn_watermarks(peer, resp.get("watermarks"))
        if tr is not None and t_recv is not None:
            # Decode + verdict classification is routing-plane work;
            # recording it keeps sub-ms requests' coverage honest.
            tr.hop("route", t_recv, self.mono(), step="classify",
                   peer=peer)
        err = resp.get("error")
        if err is not None:
            err_s = str(err)
            if err_s.startswith("overloaded"):
                # Admission control, not peer sickness: no breaker hit.
                self.metrics.count("router.sheds")
                return ("shed", resp.get("retry_after_ms", 0))
            if err_s.startswith("session_uncovered"):
                # The plane refused to violate the token; its watermarks
                # (just learned) steer the next candidate choice.
                self.metrics.count("router.session_uncovered")
                return ("uncovered", f"{peer}: session_uncovered")
            self.metrics.count("router.errors")
            self._fail(peer, RuntimeError(err_s))
            return ("err", f"{peer}: {err_s}")
        return ("ok", resp)

    # -- success / failure bookkeeping ---------------------------------------

    def _succeed(self, att: _Attempt) -> None:
        dt = max(0.0, self.mono() - att.t0)
        with self._lock:
            lat = self._lat.setdefault(att.peer, deque(maxlen=64))
            lat.append(dt)
        if self.breaker(att.peer).record_success():
            self.metrics.count("router.breaker_closes")

    def _fail(self, peer: str, err: BaseException) -> None:
        if isinstance(err, TimeoutError) or "timed out" in str(err):
            self.metrics.count("router.peer_timeouts")
        if self.breaker(peer).record_failure():
            self.metrics.count("router.breaker_opens")

    def _hedge_at(
        self, peer: str, t0: float, hedge_peer: Optional[str]
    ) -> Optional[float]:
        if not self.hedge or hedge_peer is None:
            return None
        if self.hedge_after_s is not None:
            return t0 + max(0.0, float(self.hedge_after_s))
        with self._lock:
            lat = self._lat.get(peer)
            if lat is None or len(lat) < self.hedge_min_samples:
                return None
            xs = sorted(lat)
        p99 = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        return t0 + p99

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

    def _session_gaps(self, token: Dict[str, int]) -> Dict[str, Any]:
        """Best-known per-origin (have, want) shortfall across peers —
        the honest detail on session_unsatisfiable."""
        best: Dict[str, int] = {}
        with self._lock:
            for wm in self._peer_watermarks.values():
                for o, s in wm.items():
                    if s > best.get(o, -1):
                        best[o] = s
        return {
            o: {"have": hv, "want": wt}
            for o, (hv, wt) in session_gaps(best, token).items()
        }

    # -- finishers -----------------------------------------------------------

    def _finish_ok(
        self,
        t0: float,
        resp: Dict[str, Any],
        peer: str,
        sess: Optional[ClientSession],
        token: Dict[str, int],
        tr: Optional[rtrace.Trace] = None,
    ) -> Dict[str, Any]:
        self.metrics.count("router.successes")
        dt = max(0.0, self.mono() - t0)
        self.metrics.merge({"latencies": {"router.read": [dt]}})
        rtrace.commit(tr, "ok", dt * 1e3)
        wm = resp.get("watermarks")
        if sess is not None and isinstance(wm, dict):
            # Flight-record the accepted read with the floor it HAD to
            # satisfy — certify_sessions replays exactly this feed. In
            # session_mode="ignore" the requirement was never sent, so a
            # watermark shortfall here is precisely the violation the
            # audit must catch.
            sess.note_read(
                resp.get("member", peer),
                {str(o): int(s) for o, s in wm.items()},
                required=token,
            )
        out = dict(resp)
        out["peer"] = peer
        return out

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
        self.metrics.merge({"latencies": {"router.read": [dt]}})
        obs_events.emit("router.give_up", error=error)
        if tr is not None:
            outcome = {
                "overloaded": "shed",
                "session_unsatisfiable": "uncovered",
            }.get(error, "failed")
            if outcome == "failed" \
                    and "timeout" in str(extra.get("detail", "")):
                outcome = "deadline"
            rtrace.commit(tr, outcome, dt * 1e3)
        out: Dict[str, Any] = {"error": error}
        out.update(extra)
        return out


def tcp_query_fn(
    addrs: Any, connect_timeout_s: float = 0.5
) -> Callable[[str, bytes, float, threading.Event], bytes]:
    """Adapter: a `query_fn` over `net.tcp.query_peer` given `addrs` —
    a dict (or callable returning one) of peer -> (host, port). Raises
    KeyError for unknown peers (the router treats it as a failure and
    fails over)."""
    from ..net.tcp import query_peer

    def fn(
        peer: str, payload: bytes, timeout_s: float, cancel: threading.Event
    ) -> bytes:
        table = addrs() if callable(addrs) else addrs
        addr = table[peer]
        _member, resp = query_peer(
            tuple(addr), payload, timeout=timeout_s, cancel=cancel,
            connect_timeout=connect_timeout_s,
        )
        return resp

    return fn
