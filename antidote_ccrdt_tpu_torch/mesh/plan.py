"""`MeshPlan`: the partition→shard map and the device layout.

Port of ``antidote_ccrdt_tpu/mesh/plan.py``. The partition plane
(core/partition.py) made the PARTITION the unit of digests, psnaps, WAL
tags, and checkpoint shards. This module makes it the unit of
*placement*: a (dc, key) mesh (``parallel.dist.Mesh``, logical devices on
one physical device) where

* the **dc** axis shards the replica rows (axis 0 of every state leaf)
  — intra-slice reconciliation is a JOIN lattice all-reduce over this
  axis (mesh/reduce.py), the collective version of what gossip does
  between workers;
* the **key** axis shards the item axis of every item-indexed leaf
  (`core.partition._item_plan` names it per engine) — instances/ids are
  independent, so this axis needs no collectives.

Ownership vs placement: `shard_of(part) = part % n_key` assigns every
digest partition (including the meta partition P) to exactly one key
shard. It is a pure function of (P, n_key) — independent of member
names, device order, or the alive set — so it is stable under worker
churn by construction, and every anchor in a fleet agrees on it without
coordination. Hash partitions (Knuth `part_of`) interleave ids across
the item axis, so a key shard's *owned partitions* are not a contiguous
block of its *resident rows*; ownership governs which shard PRODUCES
and publishes each per-partition artifact (digest entry, psnap blob,
WAL stream, checkpoint shard), a host-side split of responsibility —
the artifacts themselves are byte-identical to the unsharded ones
because they are computed by the same partition-plane code from the
same (global) state values.

A placed leaf is a tensor on the mesh's device tagged with its
``parallel.dist.NamedSharding`` (``leaf.sharding``); `ensure_placed`
re-tags only the leaves whose tag drifted (a merge's output carries
none) and hands the others back as the same objects.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

from ..core import partition as pt
from ..parallel import dist
from ..utils.tree import tree_map

ENV_DC = "CCRDT_MESH_DC"
ENV_KEY = "CCRDT_MESH_KEY"


def _axis_factorization(n: int) -> tuple:
    """Default (n_dc, n_key) for n devices: the dc axis takes the largest
    power of two ≤ min(n, 2) — reconciliation cost grows with dc (log2
    rounds of full-state exchange) while the key axis is collective-free,
    so keep dc small and give the rest to key."""
    if n < 2:
        return 1, max(1, n)
    n_dc = 2
    return n_dc, n // n_dc


class MeshPlan:
    """Partitions pinned to key-axis shards of a (dc, key) mesh.

    `mesh` is a ``parallel.dist.Mesh`` with axes ("dc", "key"); `P` is the
    fleet partition count (a wire/digest parameter — every member must
    agree, same contract as `core.partition.n_partitions`)."""

    def __init__(self, mesh: Any, partitions: Optional[int] = None) -> None:
        self.mesh = mesh
        self.n_dc = int(mesh.shape["dc"])
        self.n_key = int(mesh.shape["key"])
        self.P = int(partitions) if partitions else pt.n_partitions()
        self._sharding_cache: Dict[Any, Any] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def build(
        cls,
        n_dc: Optional[int] = None,
        n_key: Optional[int] = None,
        partitions: Optional[int] = None,
        devices: Optional[List[Any]] = None,
    ) -> "MeshPlan":
        """A plan over `devices` (default ``parallel.dist.mesh_devices()``:
        the cards, or the logical devices of a `logical_devices` region)."""
        devs = devices if devices is not None else dist.mesh_devices()
        if n_dc is None and n_key is None:
            n_dc, n_key = _axis_factorization(len(devs))
        elif n_dc is None:
            n_dc = max(1, len(devs) // int(n_key))
        elif n_key is None:
            n_key = max(1, len(devs) // int(n_dc))
        return cls(dist.make_mesh(int(n_dc), int(n_key), devices=devs),
                   partitions=partitions)

    @classmethod
    def from_env(
        cls,
        partitions: Optional[int] = None,
        devices: Optional[List[Any]] = None,
    ) -> "MeshPlan":
        """Axis extents from `CCRDT_MESH_DC` / `CCRDT_MESH_KEY` (unset =
        the default factorization of the device count)."""
        def _env_int(name):
            try:
                v = int(os.environ.get(name, "0"))
            except ValueError:
                v = 0
            return v if v > 0 else None

        return cls.build(
            n_dc=_env_int(ENV_DC), n_key=_env_int(ENV_KEY),
            partitions=partitions, devices=devices,
        )

    # -- ownership (partition -> shard) -------------------------------------

    def shard_of(self, part: int) -> int:
        """The key shard that owns digest partition `part` (0..P, the
        meta partition P included). Pure in (part, n_key)."""
        if not (0 <= int(part) <= self.P):
            raise ValueError(f"partition {part} outside 0..{self.P}")
        return int(part) % self.n_key

    def owned_parts(self, shard: int) -> List[int]:
        """Every digest partition (including meta) owned by `shard`."""
        if not (0 <= int(shard) < self.n_key):
            raise ValueError(f"shard {shard} outside 0..{self.n_key - 1}")
        return [p for p in range(self.P + 1) if p % self.n_key == int(shard)]

    def owner_map(self) -> Dict[int, int]:
        return {p: self.shard_of(p) for p in range(self.P + 1)}

    # -- physical layout (NamedSharding per leaf) ----------------------------

    def specs(self, state: Any):
        """A tree of `PartitionSpec`s congruent with `state`: replica
        axis 0 over "dc", the engine's item axis over "key", everything
        else replicated. Axes that don't divide evenly stay replicated
        (correct, just less parallel) so odd geometries never crash."""
        items, _whole, _extent = pt._item_plan(state)
        item_axes = {id(leaf): axis for _path, leaf, axis in items}

        def spec_of(leaf):
            ndim = getattr(leaf, "ndim", 0)
            if not ndim:
                return dist.P()
            dims: List[Optional[str]] = [None] * ndim
            if leaf.shape[0] % self.n_dc == 0 and leaf.shape[0] > 0:
                dims[0] = "dc"
            axis = item_axes.get(id(leaf))
            if (
                axis is not None
                and axis != 0
                and leaf.shape[axis] % self.n_key == 0
                and leaf.shape[axis] > 0
            ):
                dims[axis] = "key"
            while dims and dims[-1] is None:
                dims.pop()
            return dist.P(*dims)

        return tree_map(spec_of, state)

    def shardings(self, state: Any):
        """`NamedSharding` tree for `state` (cached per spec)."""

        def sh(spec):
            hit = self._sharding_cache.get(spec)
            if hit is None:
                hit = self._sharding_cache[spec] = dist.NamedSharding(
                    self.mesh, spec
                )
            return hit

        return tree_map(sh, self.specs(state))

    def place(self, state: Any) -> Any:
        """Pin `state` onto the mesh (a tagged alias per leaf)."""
        return tree_map(dist.device_put, state, self.shardings(state))

    def ensure_placed(self, state: Any) -> Any:
        """Re-pin only the leaves whose sharding drifted (merges with
        host-materialized peers produce untagged outputs); leaves
        already on-plan pass through untouched — no copy, no alias."""

        def fix(leaf, sh):
            if getattr(leaf, "sharding", None) == sh:
                return leaf
            return dist.device_put(leaf, sh)

        return tree_map(fix, state, self.shardings(state))

    # -- out-of-core (core/pager.py) ----------------------------------------

    def build_pager(
        self, dense: Any, state: Any, shard: int, *,
        name: str = "state", metrics: Optional[Any] = None,
        spill_dir: Optional[str] = None,
    ) -> Optional[Any]:
        """A `PartitionPager` scoped to `shard`'s owned partitions — the
        per-shard hot/cold residency manager for this plan. Budgets come
        from `CCRDT_PAGER_HBM_BUDGET` / `CCRDT_PAGER_HOST_BUDGET`;
        returns None when paging is disabled, unconfigured, or the
        engine is unpageable (lifted rows / bare monoids)."""
        from ..core import pager as pg

        return pg.maybe_pager(
            dense, state, owned=self.owned_parts(shard), metrics=metrics,
            spill_dir=spill_dir, P=self.P, name=name,
        )

    # -- identity ------------------------------------------------------------

    def slot_key(self):
        """Hashable identity of the plan (the JAX package keys its jit
        slots on it)."""
        return (self.mesh, self.P, self.n_dc, self.n_key)

    def describe(self) -> Dict[str, Any]:
        return {
            "n_dc": self.n_dc,
            "n_key": self.n_key,
            "partitions": self.P,
            "devices": int(np.prod([self.mesh.shape[a] for a in ("dc", "key")])),
            "parts_per_shard": {
                s: len(self.owned_parts(s)) for s in range(self.n_key)
            },
        }

    def export_gauges(self, metrics: Any) -> None:
        """Per-shard gauges for the obs plane."""
        metrics.set("mesh.n_dc", float(self.n_dc))
        metrics.set("mesh.n_key", float(self.n_key))
        for s in range(self.n_key):
            metrics.set(
                f"mesh.shard{s:02d}.parts", float(len(self.owned_parts(s)))
            )
