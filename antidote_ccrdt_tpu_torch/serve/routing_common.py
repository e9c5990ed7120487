"""Routing policy shared by the fleet READ tier (`serve.router`) and the
fleet WRITE tier (`serve.ingest`).

Both tiers walk the same HRW candidate list (`topo.anchor.
rendezvous_order` — fleet-wide agreement with no coordination, and the
write tier's "partition owner" is by construction the head of the same
list every read-tier client prefers), skip SWIM-dead peers, and guard
every peer behind the same circuit breaker. These review semantics are
load-bearing and live here exactly once:

* `CircuitBreaker.would_allow()` is the READ-ONLY eligibility check the
  candidate filter uses; `allow()` RESERVES the single half-open probe
  and must be called only when an attempt actually launches.
* Every launched attempt must resolve its breaker — `record_success`,
  `record_failure`, or `release_probe` for cancelled/abandoned attempts
  — or the probe slot leaks and the peer is excluded from routing
  forever (a bug an earlier review found).

`serve.router` re-exports `CircuitBreaker` and the state constants, so
existing imports (tests, dashboards) keep working.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..topo.anchor import rendezvous_order

# Breaker states (exported for tests / the dashboard).
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-peer closed -> open -> half-open breaker on *consecutive*
    failures. Clock-injectable so tests drive transitions on a fake
    clock; thread-safe because hedged attempts record from worker
    threads."""

    def __init__(
        self,
        fail_threshold: int = 3,
        cooldown_s: float = 2.0,
        mono: Callable[[], float] = time.monotonic,
    ):
        self.fail_threshold = max(1, int(fail_threshold))
        self.cooldown_s = float(cooldown_s)
        self.mono = mono
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consec_failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and (
                self.mono() - self._opened_at >= self.cooldown_s
            ):
                return HALF_OPEN
            return self._state

    def allow(self) -> bool:
        """May an attempt go to this peer now? While open: no. After the
        cooldown: exactly ONE in-flight probe (half-open) until it
        reports success or failure — or explicitly releases the slot.
        RESERVES the probe slot: call only when the attempt actually
        launches; eligibility filtering must use `would_allow()`."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.mono() - self._opened_at < self.cooldown_s:
                    return False
                self._state = HALF_OPEN
            if self._probing:
                return False
            self._probing = True
            return True

    def would_allow(self) -> bool:
        """Read-only eligibility: the same verdict `allow()` would give,
        without reserving the half-open probe slot. Candidate filters
        use this — a candidate that is listed but never actually tried
        must not consume (and leak) the probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN and (
                self.mono() - self._opened_at < self.cooldown_s
            ):
                return False
            return not self._probing

    def release_probe(self) -> None:
        """Give back a reserved half-open probe without a verdict — for
        attempts that were cancelled or abandoned (a hedge loser reaped
        undone at the deadline, a discarded answer from a SWIM-dead
        peer). Without this the slot would leak and exclude the peer
        from routing forever."""
        with self._lock:
            self._probing = False

    def record_success(self) -> bool:
        """Returns True iff this success CLOSED a non-closed breaker."""
        with self._lock:
            closed_now = self._state != CLOSED
            self._state = CLOSED
            self._consec_failures = 0
            self._probing = False
            return closed_now

    def record_failure(self) -> bool:
        """Returns True iff this failure OPENED the breaker (threshold
        crossed, or a half-open probe failed)."""
        with self._lock:
            self._consec_failures += 1
            if self._state == HALF_OPEN or (
                self._state == CLOSED
                and self._consec_failures >= self.fail_threshold
            ):
                self._state = OPEN
                self._opened_at = self.mono()
                self._probing = False
                return True
            if self._state == OPEN:
                # Failure while open (e.g. a stale in-flight attempt):
                # restart the cooldown, it is evidence the peer is still bad.
                self._opened_at = self.mono()
            return False


class BreakerBoard:
    """Lazily-populated per-peer breaker registry with shared policy
    knobs. Both tiers of one client process can share a board, so a
    peer that fails writes is also demoted for reads (and vice versa) —
    connection loss is connection loss, whichever plane observed it."""

    def __init__(
        self,
        fail_threshold: int = 3,
        cooldown_s: float = 2.0,
        mono: Callable[[], float] = time.monotonic,
    ):
        self.fail_threshold = int(fail_threshold)
        self.cooldown_s = float(cooldown_s)
        self.mono = mono
        self._lock = threading.Lock()
        self._breakers: Dict[str, CircuitBreaker] = {}

    def get(self, peer: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(peer)
            if br is None:
                br = CircuitBreaker(
                    self.fail_threshold, self.cooldown_s, self.mono
                )
                self._breakers[peer] = br
            return br

    def states(self) -> Dict[str, str]:
        with self._lock:
            items = list(self._breakers.items())
        return {p: br.state for p, br in items}


def candidate_order(
    key: str,
    peers: List[str],
    verdict_fn: Optional[Callable[[str], str]] = None,
    breakers: Optional[BreakerBoard] = None,
    staleness_fn: Optional[Callable[[str], float]] = None,
    stale_soft_s: float = -1.0,
) -> List[str]:
    """The shared candidate walk: HRW rendezvous order on `key` (the
    head is the partition owner), peers beyond `stale_soft_s` demoted to
    a second bucket (stable within each — the read tier's staleness
    demotion; the write tier passes no staleness_fn, owner affinity must
    not wobble with lag), SWIM-``dead`` peers dropped, and open-breaker
    peers filtered READ-ONLY via `would_allow()` (probe reservation is
    the launcher's job)."""
    ordered = rendezvous_order(key, [str(p) for p in peers])
    if staleness_fn is not None and stale_soft_s >= 0:
        ordered = sorted(
            ordered,
            key=lambda p: 1 if (staleness_fn(p) or 0.0) > stale_soft_s else 0,
        )  # stable: HRW order preserved within each bucket
    out: List[str] = []
    for p in ordered:
        if verdict_fn is not None and verdict_fn(p) == "dead":
            continue
        if breakers is not None and not breakers.get(p).would_allow():
            continue
        out.append(p)
    return out
