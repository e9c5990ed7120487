"""SWIM-style membership: piggybacked heartbeats, suspect -> confirm-dead.

The failure-detector shape follows SWIM (Das et al.): liveness evidence
rides on the frames members already exchange (every snapshot/delta/ping
frame carries the sender's last-heard AGES for everyone it knows), so
detection latency is bounded by gossip traffic rather than by a separate
ping schedule, and evidence is TRANSITIVE — A can keep B alive in C's
view while C's direct link to B is down. A silent member degrades
through SUSPECT (still owns its replicas; transient stalls — GC pauses,
one dropped link — don't flap ownership) before CONFIRM-DEAD removes it
from the alive set that feeds `parallel.elastic.owners`.

Two deliberate simplifications vs full SWIM, safe because the consumer
is idempotent gossip rather than a routed overlay: no indirect
ping-req round (piggybacked ages already provide the indirection), and
no incarnation-number refutation (a falsely-suspected member's next
frame re-alives it; brief ownership overlap is harmless — the join
dedups, as documented in `parallel.elastic.owners`).

Ages (not timestamps) go on the wire, so members never need synchronized
clocks; each member timestamps evidence against its own monotonic `now`.
The clock source is injected — `net.sim` drives this class with a
virtual clock for deterministic chaos replay.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..obs import events as obs_events
from ..utils.metrics import Metrics

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"


class Membership:
    """Last-heard tracking + the SWIM state machine.

    `timeout_s` (passed per query, matching the `alive_members` surface
    the gossip tier already speaks) is the ALIVE horizon; a member goes
    SUSPECT past it and DEAD past ``confirm_factor * timeout_s``.
    SUSPECT members still count as alive for replica ownership — only
    confirm-dead shifts the `owners()` map."""

    def __init__(
        self,
        member: str,
        now: Callable[[], float] = time.monotonic,
        confirm_factor: float = 2.0,
        metrics: Optional[Metrics] = None,
    ):
        self.member = member
        self.now = now
        self.confirm_factor = confirm_factor
        self.metrics = metrics if metrics is not None else Metrics()
        self.last_heard: Dict[str, float] = {member: now()}
        # Members currently flagged suspect/dead, for edge-triggered
        # metrics (count transitions, not polls).
        self._suspected: set = set()
        self._dead: set = set()

    # -- evidence ----------------------------------------------------------

    def observe(self, member: str, age: float = 0.0) -> None:
        """Record evidence that `member` was alive `age` seconds ago
        (0 = we just heard from it directly). Stale evidence (older than
        what we already hold) is ignored; fresh evidence clears suspicion
        — the SWIM re-alive transition."""
        t = self.now() - age
        if t > self.last_heard.get(member, float("-inf")):
            self.last_heard[member] = t
            if member in self._suspected or member in self._dead:
                # Only a *recent* sighting refutes: letting any newer-but-
                # still-ancient gossip clear the flags would re-alive a
                # confirmed-dead member on every piggyback exchange.
                was = DEAD if member in self._dead else SUSPECT
                self._suspected.discard(member)
                self._dead.discard(member)
                obs_events.emit(
                    "peer.realive", peer=member, was=was, age=round(age, 6)
                )

    def heard_ages(self) -> Dict[str, float]:
        """Piggyback payload: member -> seconds since last heard (self is
        always 0). Receivers feed this to `absorb`."""
        now = self.now()
        out = {m: now - t for m, t in self.last_heard.items()}
        out[self.member] = 0.0
        return out

    def absorb(self, ages: Dict[str, float]) -> None:
        """Merge a peer's piggybacked `heard_ages` (transitive liveness)."""
        for m, age in ages.items():
            self.observe(m, age=float(age))

    # -- classification ----------------------------------------------------

    def state_of(self, member: str, timeout_s: float) -> str:
        if member == self.member:
            return ALIVE
        t = self.last_heard.get(member)
        if t is None:
            return DEAD
        age = self.now() - t
        if age <= timeout_s:
            return ALIVE
        if age <= self.confirm_factor * timeout_s:
            if member not in self._suspected:
                self._suspected.add(member)
                self.metrics.count("net.suspect_events")
                # Edge-triggered like the counter, but carrying the
                # evidence: the heartbeat age that crossed the horizon.
                obs_events.emit(
                    "peer.suspect",
                    peer=member,
                    age=round(age, 6),
                    timeout_s=timeout_s,
                )
            return SUSPECT
        if member not in self._dead:
            self._dead.add(member)
            self._suspected.discard(member)
            self.metrics.count("net.dead_events")
            obs_events.emit(
                "peer.dead",
                peer=member,
                age=round(age, 6),
                timeout_s=timeout_s,
            )
        return DEAD

    def members(self) -> List[str]:
        """Everyone ever heard of (including self, including the dead)."""
        return sorted(self.last_heard)

    def alive(self, timeout_s: float) -> List[str]:
        """The ownership-feeding alive set: ALIVE + SUSPECT members (a
        suspect keeps its replicas until confirmed dead). Self is always
        included — a member never suspects itself."""
        return sorted(
            m for m in self.last_heard if self.state_of(m, timeout_s) != DEAD
        )
