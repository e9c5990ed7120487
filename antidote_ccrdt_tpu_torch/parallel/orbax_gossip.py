"""Checkpoint-backed gossip for mesh-sharded states: the geo-DR tier.

Port of ``antidote_ccrdt_tpu/parallel/orbax_gossip.py`` over the port's
``harness.orbax_ckpt`` (DCP-backed; the name is JAX's).

`parallel.elastic.GossipStore` ships host-local npz snapshots — right for
states that fit one host. A SITE in the multihost layout
(`parallel.multihost`) holds its state *sharded over a device mesh*; its
snapshots must be written shard-parallel (each process writes what it
owns) and restored onto a DIFFERENT site's mesh shape. That is what the
checkpoint manager does, so this module is the thin composition:

* publish  = a checkpoint save of the sharded state under
  `<root>/ckpt-<member>/` + the same mtime heartbeat files `GossipStore`
  uses (one failure detector across both tiers).
* fetch    = a restore of a PEER's latest step into THIS site's layout.
* sweep    = fold every peer's latest snapshot in with the engine join —
  identical semantics to the host-local tier: stale snapshots, repeated
  merges, and membership churn are all absorbed by join idempotence. The
  joined state keeps this site's layout (each leaf its sharding tag).

Cross-site anti-entropy over shared storage is the CRDT-native
disaster-recovery plane: no cross-site collectives, no coordinator, and a
site restored from the store is immediately mergeable.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

from ..harness import orbax_ckpt
from ..utils.tree import tree_map
from .elastic import GossipStore


def available() -> bool:
    return orbax_ckpt.available()


def _keep_layout(before: Any, after: Any) -> Any:
    """`after` with each leaf tagged as the same leaf of `before` was (a
    merge's output carries no tag; JAX's keeps the operands' sharding)."""
    from .dist import device_put

    def one(new, old):
        sharding = getattr(old, "sharding", None)
        return new if sharding is None or getattr(new, "sharding", None) is not None else device_put(new, sharding)

    return tree_map(one, after, before)  # static fields (a lift's `swept`) are the merge's


class OrbaxGossip:
    """Per-member checkpoint trees + shared heartbeat files.

    Layout: `<root>/hb-<member>` (heartbeats, via GossipStore) and
    `<root>/ckpt-<member>/<step>/` (manager-written, retention-pruned)."""

    def __init__(self, root: str, member: str, max_to_keep: int = 2):
        self.root = root
        self.member = member
        self._hb = GossipStore(root, member)  # heartbeat + liveness surface
        self._mgr = orbax_ckpt.DenseCheckpointManager(
            os.path.join(os.path.abspath(root), f"ckpt-{member}"),
            max_to_keep=max_to_keep,
        )
        self._peer_mgrs: Dict[str, Any] = {}

    # liveness delegates to the shared heartbeat files
    def heartbeat(self) -> None:
        self._hb.heartbeat()

    def members(self) -> List[str]:
        return self._hb.members()

    def alive_members(self, timeout_s: float) -> List[str]:
        return self._hb.alive_members(timeout_s)

    # -- snapshots ---------------------------------------------------------

    def publish(self, state: Any, step: int) -> None:
        """Shard-parallel save of this site's (possibly mesh-sharded)
        state; every process of the site calls this collectively."""
        self._mgr.save(step, state)
        self._hb.heartbeat()

    def _peer_mgr(self, member: str) -> Optional[Any]:
        d = os.path.join(os.path.abspath(self.root), f"ckpt-{member}")
        if not os.path.isdir(d):
            return None
        if member not in self._peer_mgrs:
            self._peer_mgrs[member] = orbax_ckpt.DenseCheckpointManager(
                d, max_to_keep=10**6  # reader: never prune a peer's steps
            )
        return self._peer_mgrs[member]

    def snapshot_members(self) -> List[str]:
        return sorted(
            d[len("ckpt-"):]
            for d in os.listdir(self.root)
            if d.startswith("ckpt-")
            and os.path.isdir(os.path.join(self.root, d))
        )

    def peer_latest_step(self, member: str) -> Optional[int]:
        """Peer's newest published step. A manager caches its step list at
        construction and only refreshes it on its OWN saves, so a reader
        MUST `reload()` before looking — without it, a cached peer manager
        pins the step it saw first, the owner's retention soon prunes that
        step, and every later fetch turns into a silent None: gossip stops
        converging after the first exchange."""
        try:
            mgr = self._peer_mgr(member)
            if mgr is None:
                return None
            mgr.reload()
            return mgr.latest_step()
        except Exception:  # noqa: BLE001 — deliberately total
            return None

    def fetch(self, member: str, like: Any) -> Optional[Tuple[int, Any]]:
        """Peer's latest snapshot restored INTO `like`'s layout (this
        site's mesh) — or None on any failure, same total-failure policy
        as the host-local tier (the next sweep retries)."""
        step = self.peer_latest_step(member)
        if step is None:
            return None
        try:
            return step, self._peer_mgr(member).restore(like, step=step)
        except Exception:  # noqa: BLE001 — deliberately total
            return None

    def sweep(
        self, dense: Any, state: Any, cursors: Optional[Dict[str, int]] = None
    ) -> Tuple[Any, int]:
        """Join every peer's latest snapshot into `state`. `cursors`
        (member -> last merged step, updated in place) skips peers whose
        publish has not advanced — a full cross-mesh restore of a large
        sharded state is the dominant cost of a sweep and is pure waste
        when the data is already reflected."""
        from .elastic import _resolve_monoid

        dense, state = _resolve_monoid(dense, state, "OrbaxGossip.sweep")
        n = 0
        for m in self.snapshot_members():
            if m == self.member:
                continue
            if cursors is not None:
                latest = self.peer_latest_step(m)
                if latest is None or latest <= cursors.get(m, -1):
                    continue
            got = self.fetch(m, state)
            if got is None:
                continue
            step, peer = got
            state = _keep_layout(state, dense.merge(state, peer))
            n += 1
            if cursors is not None:
                cursors[m] = step
        return state, n

    def close(self) -> None:
        self._mgr.close()
        for mgr in self._peer_mgrs.values():
            mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
