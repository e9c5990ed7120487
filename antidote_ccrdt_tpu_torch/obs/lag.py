"""Replication-lag tracking: how far behind is each peer's delta stream?

Delta gossip gives every replica a natural per-origin progress axis: the
publisher's delta sequence number. Each worker's sweep loop already
maintains two views of that axis per peer —

* the PUBLISHED watermark: the highest delta seq visible on the
  transport for that origin (the tip of what they have shipped), and
* the APPLIED cursor: the highest seq this process has merged
  (`sweep_deltas`' per-peer cursor).

`LagTracker` turns the pair into convergence lag in both units the
operator cares about:

* **ops**: `published - applied` — how many deltas of theirs we have
  not yet merged;
* **seconds**: age of the oldest unapplied seq, measured from when WE
  first saw it published (single-clock, so cross-host clock skew cannot
  manufacture lag);
* **staleness**: seconds since the peer last showed ANY progress
  evidence (a new published watermark or an apply) on OUR monotonic
  clock. Lag can read zero while a peer is silently wedged — caught up,
  then stopped publishing; staleness is the signal that catches that,
  and it is monotonic-clock-based so a wall-clock step (NTP slew,
  manual reset) cannot fake or hide a stall.

Peer death mid-window is explicit: `drop(peer)` freezes-and-forgets a
DEAD peer so its stale watermark stops inflating fleet lag (SWIM's DEAD
verdict, not silence, is the trigger — a slow peer still counts).

The fleet-wide `digest_agreement` probe answers the other convergence
question — "do we all hold the same state?" — by comparing per-member
payload digests (crc32 over the snapshot bytes after the 8-byte header,
the same digest `elastic_demo` verdicts use) and reporting the disagreeing
partitions, if any.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple


class LagTracker:
    """Per-peer delta-seq watermark vs applied-cursor lag, ops + seconds.

    Not thread-safe by design: it is fed from the single sweep loop of
    one worker (the same thread that owns the delta cursors)."""

    def __init__(
        self,
        member: str,
        clock: Callable[[], float] = time.time,
        mono: Callable[[], float] = time.monotonic,
    ):
        self.member = member
        self._clock = clock
        self._mono = mono  # staleness clock; injectable for tests
        self._published: Dict[str, int] = {}   # peer -> highest seq seen shipped
        self._applied: Dict[str, int] = {}     # peer -> highest seq merged here
        # peer -> {seq: first-seen t} for seqs published but not yet applied;
        # bounded: entries leave as soon as the applied cursor passes them.
        self._pending: Dict[str, Dict[int, float]] = {}
        # peer -> monotonic stamp of the last progress evidence (publish
        # watermark advance or apply) — the staleness baseline.
        self._last_update: Dict[str, float] = {}

    # -- feeding ------------------------------------------------------------

    def observe_published(self, peer: str, seq: int) -> None:
        """The transport shows `peer` has shipped deltas up through `seq`.
        Gaps are fine (anchors skip seqs): every seq in (old, seq] is
        stamped now so lag-seconds starts from first sighting."""
        if peer == self.member:
            return
        old = self._published.get(peer, -1)
        if seq <= old:
            return
        self._published[peer] = seq
        self._last_update[peer] = self._mono()
        pend = self._pending.setdefault(peer, {})
        now = self._clock()
        lo = max(old, self._applied.get(peer, -1))
        for s in range(lo + 1, seq + 1):
            pend.setdefault(s, now)

    def observe_applied(self, peer: str, seq: int) -> None:
        """This process has merged `peer`'s deltas up through `seq`
        (a full-snapshot adoption counts: pass the snapshot's seq)."""
        if peer == self.member:
            return
        old = self._applied.get(peer, -1)
        if seq <= old:
            return
        self._applied[peer] = seq
        self._last_update[peer] = self._mono()
        # published can never trail applied (an applied delta was shipped)
        if seq > self._published.get(peer, -1):
            self._published[peer] = seq
        pend = self._pending.get(peer)
        if pend:
            for s in [s for s in pend if s <= seq]:
                del pend[s]

    def drop(self, peer: str) -> None:
        """Forget a DEAD peer: its frozen watermark must not read as
        ever-growing lag. Re-observing the peer later re-creates it."""
        self._published.pop(peer, None)
        self._applied.pop(peer, None)
        self._pending.pop(peer, None)
        self._last_update.pop(peer, None)

    # -- reporting ----------------------------------------------------------

    def lag(self, peer: str) -> Tuple[int, float]:
        """(lag_ops, lag_seconds) for one peer; (0, 0.0) when caught up."""
        ops = max(0, self._published.get(peer, -1) - self._applied.get(peer, -1))
        pend = self._pending.get(peer)
        secs = (self._clock() - min(pend.values())) if pend else 0.0
        return ops, max(0.0, secs)

    def staleness(self, peer: str) -> float:
        """Seconds since `peer` last showed progress evidence (watermark
        advance or apply), on this process's monotonic clock. A peer that
        is caught up but has gone silent reads increasingly stale here
        while its lag reads zero — the wedged-peer signal. 0.0 for a
        peer never observed."""
        stamp = self._last_update.get(peer)
        if stamp is None:
            return 0.0
        return max(0.0, self._mono() - stamp)

    def report(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for peer in sorted(self._published):
            ops, secs = self.lag(peer)
            out[peer] = {
                "published": self._published.get(peer, -1),
                "applied": self._applied.get(peer, -1),
                "lag_ops": ops,
                "lag_s": round(secs, 6),
                "staleness_s": round(self.staleness(peer), 6),
            }
        return out

    def export_to(self, metrics: Any) -> None:
        """Mirror the current lag view into `Metrics` gauges so the
        Prometheus exporter picks it up: ``lag.<peer>.ops`` /
        ``lag.<peer>.seconds`` / ``lag.<peer>.staleness_seconds`` plus
        fleet maxima."""
        rep = self.report()
        worst_ops, worst_s, worst_stale = 0, 0.0, 0.0
        for peer, r in rep.items():
            metrics.set(f"lag.{peer}.ops", float(r["lag_ops"]))
            metrics.set(f"lag.{peer}.seconds", float(r["lag_s"]))
            metrics.set(
                f"lag.{peer}.staleness_seconds", float(r["staleness_s"])
            )
            worst_ops = max(worst_ops, r["lag_ops"])
            worst_s = max(worst_s, r["lag_s"])
            worst_stale = max(worst_stale, r["staleness_s"])
        metrics.set("lag.max_ops", float(worst_ops))
        metrics.set("lag.max_seconds", float(worst_s))
        metrics.set("lag.max_staleness_seconds", float(worst_stale))


# -- fleet digest agreement --------------------------------------------------


def payload_digest(blob: bytes) -> int:
    """crc32 over a gossip snapshot's payload (past the 8-byte length
    header) — the digest the drill verdicts already compare."""
    return zlib.crc32(blob[8:]) & 0xFFFFFFFF


def digest_agreement(
    digests: Dict[str, Any]
) -> Dict[str, Any]:
    """Fleet-wide convergence probe over per-member digests (None =
    member unreadable). Returns agreement plus the disagreeing groups so
    an operator can see WHICH members split, not just that they did.

    Values may be scalar whole-instance digests (legacy) or per-
    partition digest VECTORS (`core.partition.state_digests`). With
    vectors the report gains `divergent_parts`: the partition indices on
    which any two live members disagree — the exact set partial
    anti-entropy will transfer — so the probe answers "how big is the
    repair" and not just "are we split"."""
    groups: Dict[Any, List[str]] = {}
    vectors = False
    for m, d in sorted(digests.items()):
        if d is None:
            key: Any = None
        elif isinstance(d, (list, tuple)) or hasattr(d, "__len__"):
            key = tuple(int(x) for x in d)
            vectors = True
        else:
            key = int(d)
        groups.setdefault(key, []).append(m)
    live = {d: ms for d, ms in groups.items() if d is not None}

    def _label(d: Any) -> str:
        if isinstance(d, tuple):
            return "-".join("%08x" % e for e in d)
        return "%08x" % d

    out = {
        "agree": len(live) == 1 and len(groups) == len(live),
        "n_members": len(digests),
        "n_digests": len(live),
        "groups": {_label(d): ms for d, ms in live.items()},
        "unreadable": groups.get(None, []),
    }
    if vectors:
        vecs = [d for d in live if isinstance(d, tuple)]
        divergent: set = set()
        if vecs:
            width = max(len(v) for v in vecs)
            ref = vecs[0]
            for v in vecs[1:]:
                if len(v) != len(ref):
                    divergent.update(range(width))
                    break
                divergent.update(
                    i for i in range(width) if v[i] != ref[i]
                )
        if any(not isinstance(d, tuple) for d in live):
            # A scalar mixed in with vectors (mixed-version fleet):
            # incomparable shapes — every partition is suspect.
            divergent.update(range(max((len(v) for v in vecs), default=0)))
        out["divergent_parts"] = sorted(divergent)
    return out
