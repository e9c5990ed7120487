"""Zone labels and the per-node map of who lives in which zone.

A zone is an opaque string naming a locality domain — a data center, a
device slice, a rack (`dc0`, `dc0/slice1`). Links inside a zone are cheap
(ICI/LAN); links between zones cross the DCN and are what `topo.router`
economizes. A member's own zone comes from explicit config or the
``CCRDT_ZONE`` env var (the same supervisor->worker propagation pattern
`CCRDT_FAULTS` / `CCRDT_OBS_DIR` use).

`ZoneMap` is deliberately LAST-WRITE-WINS and evidence-greedy: zones are
learned from static config (the demo's addr files), from `{hello}`
frames at link setup, and from the (member, zone) hop stamps on relayed
frames — whichever arrives first. A member whose zone is not (yet) known
maps to `UNKNOWN_ZONE`, and the router treats unknown-zone members as
LOCAL (direct gossip, full-mesh fallback): correctness must never wait
on zone discovery, only the traffic shape improves once it lands.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional

ENV_ZONE = "CCRDT_ZONE"
# Fleets that never configure zones all land here — one zone, so the
# router degenerates to exactly the old full-mesh behavior.
DEFAULT_ZONE = "z0"
# A member we have no zone evidence for. Routed as if local (see module
# docstring) and never counted as a zone of its own.
UNKNOWN_ZONE = "?"


def zone_from_env(
    env: Optional[Dict[str, str]] = None, default: str = DEFAULT_ZONE
) -> str:
    """This process's zone label from ``CCRDT_ZONE`` (or `default`)."""
    return (env if env is not None else os.environ).get(ENV_ZONE) or default


def slice_zone(index: int) -> str:
    """The canonical zone label for mesh slice `index` — how the mesh
    plane (mesh/) maps device-mesh slices onto the topo/ gossip
    topology: each mesh-sharded worker process is one slice, its
    CCRDT_ZONE is `slice_zone(i)`, and cross-slice anti-entropy rides
    the existing zone-aware routers (anchors, O(zones) crossings)
    unchanged. scripts/multichip_demo.py is the reference user."""
    return f"slice{int(index)}"


class ZoneMap:
    """member -> zone, shared by a transport and its router.

    Thread-safe: the TCP receive path learns zones from hello frames and
    path stamps on reader threads while the gossip loop routes on it."""

    def __init__(
        self,
        member: str,
        zone: str,
        zones: Optional[Dict[str, str]] = None,
    ):
        self.member = member
        self.zone = zone
        self._lock = threading.Lock()
        self._zones: Dict[str, str] = dict(zones or {})
        self._zones[member] = zone

    def learn(self, member: str, zone: str) -> bool:
        """Record that `member` lives in `zone`; returns True when this
        is new information. Self's zone is pinned at construction (a
        peer's claim about US is not evidence)."""
        if not member or not zone or zone == UNKNOWN_ZONE:
            return False
        if member == self.member:
            return False
        with self._lock:
            if self._zones.get(member) == zone:
                return False
            self._zones[member] = zone
            return True

    def zone_of(self, member: str) -> str:
        with self._lock:
            return self._zones.get(member, UNKNOWN_ZONE)

    def known(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._zones)

    def members_of(self, zone: str, candidates: Iterable[str]) -> List[str]:
        """`candidates` that live in `zone`, sorted."""
        with self._lock:
            return sorted(m for m in candidates if self._zones.get(m) == zone)

    def zones_of(self, candidates: Iterable[str]) -> List[str]:
        """Distinct known zones among `candidates` (self excluded unless
        listed), sorted. UNKNOWN members contribute no zone."""
        with self._lock:
            return sorted(
                {
                    z
                    for m in candidates
                    if (z := self._zones.get(m, UNKNOWN_ZONE)) != UNKNOWN_ZONE
                }
            )

    def group(self, members: Iterable[str]) -> Dict[str, List[str]]:
        """{zone: sorted members} over `members` (unknowns under '?')."""
        out: Dict[str, List[str]] = {}
        with self._lock:
            for m in members:
                out.setdefault(self._zones.get(m, UNKNOWN_ZONE), []).append(m)
        return {z: sorted(ms) for z, ms in sorted(out.items())}
