"""Deterministic per-zone anchor election via rendezvous (HRW) hashing.

One member per zone — the *anchor* — carries that zone's cross-DCN
traffic. The election needs three properties and nothing more:

* **Coordination-free.** Every member computes the anchor locally from
  its own alive view; two members with the same view always agree. No
  ballots, no terms, no leader lease — a transient view split just means
  two anchors relay for a round, and join-idempotence makes duplicate
  relays harmless.
* **Stable under churn.** Rendezvous hashing guarantees that removing a
  non-anchor never moves the anchor, and adding a member moves it only
  if the newcomer itself wins. Elections don't thrash while the fleet
  scales — only anchor death (or a bigger hash arriving) re-elects.
* **Fast failover.** The pool is the zone's ALIVE members, so the
  instant SWIM demotes the anchor to SUSPECT the runner-up takes over —
  within one membership round, well before DEAD is confirmed.

Scores are `sha1("zone|member")` — keyed by zone so a member that loses
the election in one zone layout isn't systematically unlucky elsewhere,
and stable across processes/runs (unlike `hash()`, which is salted).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List, Optional, Tuple


def anchor_rank(zone: str, member: str) -> Tuple[int, str]:
    """Rendezvous score of `member` for `zone`; max rank wins.

    The member name tie-breaks (sha1 collisions in 64 bits are
    negligible, but determinism must not hinge on that)."""
    h = hashlib.sha1(f"{zone}|{member}".encode("utf-8")).digest()
    return (int.from_bytes(h[:8], "big"), member)


def rendezvous_anchor(zone: str, members: Iterable[str]) -> Optional[str]:
    """The anchor for `zone` among `members`, or None if the pool is
    empty. Pure: same inputs, same anchor, on every node."""
    best: Optional[str] = None
    best_rank: Optional[Tuple[int, str]] = None
    for m in members:
        r = anchor_rank(zone, m)
        if best_rank is None or r > best_rank:
            best, best_rank = m, r
    return best


def rendezvous_order(key: str, members: Iterable[str]) -> List[str]:
    """The FULL rendezvous preference list for `key`: members sorted by
    descending HRW rank (so ``rendezvous_order(k, ms)[0] ==
    rendezvous_anchor(k, ms)``). This is the shared candidate ordering
    the serve-plane fleet router (`serve/router.py`) walks on failover:
    every client computes the same list from the same member set, and
    removing a dead candidate never reorders the survivors — the
    stability rendezvous hashing buys the anchor election buys query
    affinity too (the same key keeps hitting the same replica's hot-key
    cache until that replica actually dies)."""
    return sorted(members, key=lambda m: anchor_rank(key, m), reverse=True)
