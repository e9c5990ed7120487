"""Zone-aware routing policy: who a member actually gossips with.

Replaces the transports' flat "send to every peer" loop:

* **Leaves** gossip only intra-zone (plus any peer whose zone is still
  unknown — full-mesh fallback, correctness never waits on discovery).
* **Anchors** (one per zone, `topo.anchor`) additionally send to the
  anchors of every remote zone, so each frame crosses the DCN O(zones)
  times instead of O(peers).
* **Relays**: a routed frame carries a `path` of (member, zone) hop
  stamps, origin first, appended at every hop. The origin-zone anchor
  relays cross-zone to anchors of zones not yet in the path; a remote-
  zone anchor fans the frame out to its own zone-mates and stops. Each
  zone therefore enters the path at most once — loop-freedom by
  construction — and the flight log can replay the stamps as
  `leaf -> anchor -> anchor -> leaf`.

Elections re-run on every routing decision against the CURRENT alive
view: the moment SWIM demotes an anchor to SUSPECT it drops out of the
pool and the rendezvous runner-up takes over (failover within one
membership round). A transient split view just means two anchors relay
for a round — duplicate joins are idempotent. Membership is duck-typed
(`state_of(member, timeout_s) -> "alive"|"suspect"|"dead"`) so this
module never imports `net/` — the transports import us.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..obs import events as obs_events
from .anchor import rendezvous_anchor
from .zones import UNKNOWN_ZONE, ZoneMap

# Local copies of the SWIM state strings (net.membership defines the
# same values; importing them would create the cycle this package bans).
_ALIVE = "alive"
_DEAD = "dead"

# path stamp: (member, zone)
Stamp = Tuple[str, str]
# routing decision: (peer, crosses_a_zone_boundary)
Target = Tuple[str, bool]


class ZoneRouter:
    """One member's routing policy over a shared `ZoneMap`.

    Stateless between calls except for the per-zone anchor cache, which
    exists only to make failovers observable (`topo.anchor_change`
    events + `topo.anchor_changes` counter) — routing itself always
    recomputes from the live view."""

    def __init__(
        self,
        member: str,
        zone: str,
        zones: ZoneMap,
        membership: Optional[Any] = None,
        timeout_s: float = 2.0,
        metrics: Optional[Any] = None,
    ):
        self.member = member
        self.zone = zone
        self.zones = zones
        self.membership = membership
        self.timeout_s = timeout_s
        self.metrics = metrics
        self._anchors: Dict[str, str] = {}

    # -- election ------------------------------------------------------------

    def _pool(self, zone: str, candidates: Iterable[str]) -> List[str]:
        """Election pool for `zone`: its members among `candidates`
        (self included for its own zone), preferring ALIVE, degrading to
        not-DEAD, then to everyone known — during bootstrap nobody has
        been heard yet and an empty pool would leave zones anchorless."""
        members = set(self.zones.members_of(zone, candidates))
        if zone == self.zone:
            members.add(self.member)
        if not members:
            return []
        if self.membership is None:
            return sorted(members)
        states = {
            m: (
                _ALIVE
                if m == self.member
                else self.membership.state_of(m, self.timeout_s)
            )
            for m in members
        }
        for keep in (
            lambda s: s == _ALIVE,
            lambda s: s != _DEAD,
            lambda s: True,
        ):
            pool = sorted(m for m, s in states.items() if keep(s))
            if pool:
                return pool
        return []

    def anchor_of(self, zone: str, candidates: Iterable[str]) -> Optional[str]:
        """Current anchor of `zone`, re-elected from the live view.
        Emits `topo.anchor_change` (and counts `topo.anchor_changes`)
        on first election and every failover."""
        anchor = rendezvous_anchor(zone, self._pool(zone, candidates))
        if anchor is not None and self._anchors.get(zone) != anchor:
            old = self._anchors.get(zone)
            self._anchors[zone] = anchor
            obs_events.emit(
                "topo.anchor_change",
                member=self.member,
                zone=zone,
                old=old,
                new=anchor,
            )
            if self.metrics is not None:
                self.metrics.count("topo.anchor_changes")
        return anchor

    def is_anchor(self, candidates: Iterable[str]) -> bool:
        """Is self the current anchor of its own zone?"""
        return self.anchor_of(self.zone, candidates) == self.member

    def anchors(self, candidates: Sequence[str]) -> Dict[str, str]:
        """{zone: anchor} over every zone visible in `candidates` + own."""
        out: Dict[str, str] = {}
        for z in sorted(set(self.zones.zones_of(candidates)) | {self.zone}):
            a = self.anchor_of(z, candidates)
            if a is not None:
                out[z] = a
        return out

    # -- routing -------------------------------------------------------------

    def send_targets(self, candidates: Sequence[str]) -> List[Target]:
        """Where one of self's OWN frames goes.

        Always: zone-mates and unknown-zone peers, direct. If self is
        its zone's anchor, additionally the anchor of every remote zone
        (the O(zones) cross-DCN component)."""
        out: List[Target] = []
        for peer in sorted(candidates):
            if peer == self.member:
                continue
            pz = self.zones.zone_of(peer)
            if pz == self.zone or pz == UNKNOWN_ZONE:
                out.append((peer, False))
        if self.is_anchor(candidates):
            for z, anchor in self.anchors(candidates).items():
                if z != self.zone and anchor != self.member:
                    out.append((anchor, True))
        return out

    def plan_relay(
        self,
        origin: str,
        path: Sequence[Stamp],
        candidates: Sequence[str],
    ) -> List[Target]:
        """Where a frame from `origin`, already stamped with `path`,
        goes next. The caller appends its own stamp when forwarding.

        Only anchors relay. The origin-zone anchor fans cross-zone to
        anchors of unvisited zones; a remote-zone anchor fans out to its
        zone-mates not already on the path, and stops."""
        if not self.is_anchor(candidates):
            return []
        visited_members = {m for m, _ in path} | {origin, self.member}
        visited_zones = {z for _, z in path if z != UNKNOWN_ZONE}
        visited_zones.add(self.zone)
        origin_zone = self.zones.zone_of(origin)
        out: List[Target] = []
        if origin_zone == self.zone:
            for z, anchor in self.anchors(candidates).items():
                if z not in visited_zones and anchor not in visited_members:
                    out.append((anchor, True))
        else:
            for peer in self.zones.members_of(self.zone, candidates):
                if peer not in visited_members:
                    out.append((peer, False))
        return out

    @staticmethod
    def loop_safe(path: Sequence[Stamp], member: str) -> bool:
        """May `member` accept/forward a frame with this path? False
        when its own stamp is already present (a routing loop — drop)."""
        return all(m != member for m, _ in path)
