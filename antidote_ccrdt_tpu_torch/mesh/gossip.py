"""Cross-slice anti-entropy over the existing net/ + topo/ planes.

Port of ``antidote_ccrdt_tpu/mesh/gossip.py``: the same functions, blobs
and counters.

A *slice* is one mesh-sharded worker process (its own (dc, key) device
mesh); slices gossip exactly like unsharded workers — same transports,
same delta chains, same digest/psnap wire blobs — so mixed fleets
(sharded next to unsharded, mesh shape A next to shape B) interoperate
with no wire change. What the mesh adds:

* **per-shard production** — at anchor time each key shard produces the
  digest entries and psnap blobs for the partitions it owns
  (`MeshPlan.shard_of`), and `stitch_digests` reassembles the full
  P+1 vector. The stitched artifacts are byte-identical to the
  unsharded ones (`core.partition.digest_entries` is the same byte walk
  `state_digests` does), which tests/test_mesh.py pins
  (and tests/test_torch_mesh.py across the two packages).
* **per-shard fetch grouping** — `group_parts_by_shard` orders a
  divergent-partition fetch set shard by shard, so a repairing slice
  pulls only the shard-local psnap slices it is missing;
  `parallel.elastic.PartialAntiEntropy` uses it to stitch per-shard
  fetches back together and bills `mesh.cross_slice_fetches` /
  `mesh.cross_slice_bytes`.
* **resharded ingest** — a fetched snapshot (any origin shape) joins
  into the local state and the result is re-pinned onto the local plan
  (`MeshPlan.ensure_placed` re-tags the merge's untagged leaves), so
  mesh shape A → B rejoin works mid-flight.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..core import partition as pt


def shard_digest_entries(
    state: Any, plan: Any, shard: int, pager: Optional[Any] = None
) -> Dict[int, int]:
    """Digest entries for the partitions `shard` owns — the shard-local
    slice of the P+1 vector. With a pager, demoted partitions answer
    from their cached blob digests instead of the (cleared) device
    slices, so the stitched vector still describes the logical state."""
    owned = plan.owned_parts(shard)
    if pager is not None and pager.has_cold():
        return pager.digest_entries_for(state, owned)
    return pt.digest_entries(state, plan.P, owned)


def stitch_digests(plan: Any, entries: Dict[int, int]) -> np.ndarray:
    """Reassemble per-shard digest slices into the full ``uint32[P+1]``
    vector. Every partition must be covered exactly once (the ownership
    property the plan guarantees); a gap is a bug, not a degraded mode."""
    vec = np.zeros(plan.P + 1, np.uint32)
    seen = set()
    for part, crc in entries.items():
        p = int(part)
        if p in seen:
            raise ValueError(f"partition {p} stitched twice")
        seen.add(p)
        vec[p] = np.uint32(int(crc) & 0xFFFFFFFF)
    missing = [p for p in range(plan.P + 1) if p not in seen]
    if missing:
        raise ValueError(f"digest stitch missing partitions {missing}")
    return vec


def sharded_digest_vector(
    state: Any, plan: Any, metrics: Optional[Any] = None,
    pager: Optional[Any] = None,
) -> np.ndarray:
    """The full digest vector, produced shard by shard and stitched —
    bitwise equal to `core.partition.state_digests(state, P)` of the
    logical (pager-reassembled) state."""
    entries: Dict[int, int] = {}
    for s in range(plan.n_key):
        entries.update(shard_digest_entries(state, plan, s, pager=pager))
        if metrics is not None:
            metrics.count("mesh.shard_digest_slices")
    return stitch_digests(plan, entries)


def group_parts_by_shard(
    plan: Any, parts: Iterable[int]
) -> List[Tuple[int, List[int]]]:
    """[(shard, [parts…])…] in shard order — the fetch schedule for a
    divergent set: each tuple is one shard-local slice of the repair."""
    by: Dict[int, List[int]] = {}
    for p in parts:
        by.setdefault(plan.shard_of(int(p)), []).append(int(p))
    return [(s, sorted(by[s])) for s in sorted(by)]


def shard_psnap_blobs(
    name: str, state: Any, seq: int, dense: Any, plan: Any, shard: int,
    parts: Optional[Iterable[int]] = None, pager: Optional[Any] = None,
) -> List[Tuple[int, bytes]]:
    """[(part, CCPT blob)…] for the owned partitions of `shard` (or the
    subset `parts` ∩ owned). Same encode path as the unsharded anchor
    (`restrict_psnap` → `dumps_dense` → `encode_psnap_blob`), so the
    blobs are byte-identical to the whole-producer's. With a pager,
    demoted partitions are served straight from their stored payloads
    (transfer format is storage format — no hydration to publish)."""
    from ..core import serial

    owned = set(plan.owned_parts(shard))
    todo = sorted(owned if parts is None else owned & {int(p) for p in parts})
    out = []
    for part in todo:
        if pager is not None:
            out.append((part, pager.psnap_blob(state, seq, part)))
            continue
        payload = serial.dumps_dense(
            f"{name}_psnap", pt.restrict_psnap(dense, state, part, plan.P)
        )
        out.append((part, pt.encode_psnap_blob(seq, part, payload)))
    return out


# -- resharded snapshot ingest (mesh shape A -> B) ---------------------------


def reshard_state(state: Any, plan: Any) -> Any:
    """Re-pin a state pytree onto `plan`'s device layout — the ingest
    half of heterogeneous-fleet interop: a snapshot produced under any
    mesh shape (or none) lands on the local shape, each drifted leaf
    re-tagged."""
    return plan.ensure_placed(state)


def ingest_snapshot(
    dense: Any, state: Any, fetched: Any, plan: Any,
    metrics: Optional[Any] = None,
) -> Any:
    """Join a fetched whole snapshot into the local state and reshard
    the result onto the local plan. `fetched` may come from an
    unsharded worker or a slice with a different mesh shape — the join
    is layout-blind, and the re-pin restores the local layout."""
    from ..core import batch_merge

    merged = batch_merge.merge_into(dense.merge, state, fetched)
    if metrics is not None:
        metrics.count("mesh.resharded_ingests")
    return reshard_state(merged, plan)
