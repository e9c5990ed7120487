"""Out-of-core partitions: the hot/cold partition pager.

At the ROADMAP's million-user scale the id space of one topk /
leaderboard / wordcount instance dwarfs the HBM budget; before this
module every partition of every instance was device-resident or
nothing. Big(ger) Sets (arxiv 1605.06424, PAPERS.md) solved the same
whole-state-round-trip problem in Riak by decomposing state so
operations touch only fragments — and with the mesh plane landed, the
paging unit is already in hand: the SHARD-LOCAL partition
(`core/partition.py`), serialized as a CCPT blob (the transfer format
IS the storage format) and billed by the serve plane's per-key access
stats.

Residency model
---------------
A `PartitionPager` splits one instance's partitions (only
`MeshPlan.owned_parts` under the mesh — each key shard pages its own
partitions independently) into two tiers:

* **hot** — resident in the device state exactly as before. Ops,
  merges, and serves against hot partitions run at device speed with
  zero pager involvement.
* **cold** — demoted out of the device state: the partition's id-slices
  are reset to the engine's join identity (``dense.init`` values) and
  the content lives host-side twice over — as the serialized psnap
  payload (the CCPT storage/transfer blob: RAM dict, spilling to disk
  past ``CCRDT_PAGER_HOST_BUDGET``) and joined into a CPU-backed
  "cold substrate" state used for host folds and digest recomputation.

The invariant the whole design hangs on: **logical state = device
state ⊔ cold substrate**, with the two disjoint along the item axis
(device is identity on cold slices, the substrate is identity on hot
slices and the meta leaves). Join semantics make the decomposition
exact — `full_state` reassembles the logical state bit-identically,
which the working-set drill pins against an all-resident reference.

The meta partition P (vc / lossy / whole leaves) is pinned resident and
never demoted. Lifted monoid states are not pageable (they partition by
replica row, not id) and bare MONOID engines are rejected for the same
reason `restrict_psnap` rejects them (re-merge double-counts).

Traffic that misses
-------------------
* **Ops / serves** call `ensure_resident` first: cold partitions
  hydrate on demand (decode the stored CCPT payload, one device join),
  billing `pager.hydrations` + a `pager.miss_ms` histogram sample and
  firing the `pager.hydrate` fault point.
* **Gossip / anti-entropy never block on a page-in**: a peer delta
  touching cold partitions is SPLIT (`partition.split_delta`) — the hot
  half joins on device, the cold half folds host-side through the same
  jitted merge slots compiled for CPU (`batch_merge.host_merge_into`),
  or, with ``CCRDT_PAGER_FOLD=0``, queues until hydration.
* **Digest / psnap requests** for cold partitions answer straight from
  the pager: cached crc entries and the stored CCPT payload — no
  hydration, no device work.

Promotion/demotion policy: clock (second-chance LRU) over the owned
partitions, fed by `note_ids` (the serve plane's per-key access
stream) and `touch` (op-path partition counters), bounded by
``CCRDT_PAGER_HBM_BUDGET`` bytes of resident item slices.
``CCRDT_PAGER=0`` is the kill-switch: `maybe_pager` returns None and
every integration point (all take ``pager=None``) stays the
bit-identical all-resident legacy path.

The port's tiers (this package): the budget is bytes of resident item
slices in CUDA memory, by the JAX package's arithmetic (per-id bytes x
ids of a partition), so evictions, hydrations, hits and misses equal
its own on the same stream; device tensors keep their full shape, a
cold partition's slices holding the join identity. The cold substrate
is a state of CPU tensors, pinned when the managed state lives on a
card (so its copy to the card is a straight DMA). For topk_rmv states
every join the pager makes itself (a hydration, a cold fold, the hot
half of a split delta, a queue drain) reads and writes only the id
slices the payload's rows name: the joined rows are gathered, joined by
the engine's merge (K3 on a card) against the payload's rows, and put
back. Every other row would be joined with the join identity, which
leaves a row the engine produced unchanged, so the result is the full
join's, bit for bit — the substrate's leaves, stored payloads and
cached digests are the JAX package's (tests/test_torch_pager.py).
Table engines join whole states, as the JAX package does.

Crash safety: spill files are strictly a cache of durable-elsewhere
content (WAL + checkpoints recover the logical state all-resident), so
a recovering process DISCARDS any spill left by a torn predecessor —
`discard_spill`, called from WAL recovery — rather than trusting a
blob that may be mid-write.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from . import partition as pt
from . import serial
from .batch_merge import host_device, merge_into
from ..obs import devprof, profile
from ..obs import spans as obs_spans
from ..utils import faults
from ..utils.metrics import Metrics
from ..utils.tree import leaves, tree_map

ENV_FLAG = "CCRDT_PAGER"  # "0"/"false"/"off" => kill-switch (all-resident)
ENV_HBM = "CCRDT_PAGER_HBM_BUDGET"  # bytes of resident item slices (0 = unbounded)
ENV_HOST = "CCRDT_PAGER_HOST_BUDGET"  # bytes of RAM-tier payloads before disk spill
ENV_FOLD = "CCRDT_PAGER_FOLD"  # "0" => queue cold deltas until hydration

# Conditional span, deliberately NOT in spans.PHASES (same contract as
# round.serve_swap): it only lights when a partition actually hydrates.
SPAN_HYDRATE = "round.pager_hydrate"

SPILL_PREFIX = "pagercold-"
_REF_CAP = 8  # clock counter ceiling: bounds the second chances a hot streak buys


def enabled(default: bool = True) -> bool:
    """The ``CCRDT_PAGER`` kill-switch (mirrors CCRDT_OVERLAP/CCRDT_MESH)."""
    v = os.environ.get(ENV_FLAG)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off", "no", "")


def _env_bytes(name: str, default: int = 0) -> int:
    """Parse a byte-count env knob; bare ints or k/m/g suffixes."""
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    mult = 1
    if raw[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[raw[-1]]
        raw = raw[:-1]
    try:
        return max(0, int(float(raw) * mult))
    except ValueError:
        return default


def hbm_budget(default: int = 0) -> int:
    return _env_bytes(ENV_HBM, default)


def host_budget(default: int = 0) -> int:
    return _env_bytes(ENV_HOST, default)


def fold_cold_default(default: bool = True) -> bool:
    v = os.environ.get(ENV_FOLD)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "off", "no")


def discard_spill(spill_dir: Optional[str]) -> int:
    """Delete every pager spill file under `spill_dir`. Called on pager
    construction AND from WAL recovery: spill blobs are a cache of
    state that is durable elsewhere, and a file left by a SIGKILLed
    predecessor may be torn mid-write — recovery must rebuild
    all-resident from WAL/checkpoint, never resurrect a spill blob."""
    if not spill_dir or not os.path.isdir(spill_dir):
        return 0
    n = 0
    for fn in os.listdir(spill_dir):
        if fn.startswith(SPILL_PREFIX):
            try:
                os.unlink(os.path.join(spill_dir, fn))
                n += 1
            except OSError:
                pass
    return n


def _part_ids(parts: Sequence[int], P: int, extent: int) -> np.ndarray:
    """The ids (item indices) of `parts` (the meta partition excluded)."""
    want = sorted(int(p) for p in parts if int(p) != P)
    if not want or not extent:
        return np.zeros(0, np.int64)
    return np.nonzero(np.isin(pt.part_of(np.arange(extent), P), np.asarray(want, np.int64)))[0]


def _clear_ids_(dense: Any, state: Any, idx: np.ndarray) -> None:
    """Write the engine's join identity (``dense.init`` values) into the
    id-slices `idx` of every item leaf of `state`, in place."""
    items, _whole, _extent = pt._item_plan(state)
    ident = dict((p, leaf) for p, leaf, _a in pt._item_plan(dense.init(1, 1))[0])
    for path, leaf, axis in items:
        at = torch.from_numpy(idx).to(leaf.device)
        src = ident[path].to(leaf.device).index_select(axis, at)
        leaf.index_copy_(axis, at, src.expand(leaf.shape[:2] + src.shape[2:]).contiguous())


def clear_parts(dense: Any, state: Any, parts: Sequence[int], P: int) -> Any:
    """Reset the id-slices of `parts` to the engine's join identity
    (``dense.init`` values) in every item leaf; whole leaves untouched.
    This is demotion's device-side half: after it, the device state is
    the join identity on those partitions, so joining the cold substrate
    back (`full_state`) reassembles the logical state exactly. Out of
    place, on the state's own device: the item leaves are copied, the
    whole leaves are shared with `state`."""
    _items, _whole, extent = pt._item_plan(state)
    idx = _part_ids(parts, P, extent)
    if idx.size == 0:
        return state
    item_ids = {id(leaf) for _p, leaf, _a in pt._item_plan(state)[0]}
    out = tree_map(lambda x: x.clone() if id(x) in item_ids else x, state)
    _clear_ids_(dense, out, idx)
    return out


def maybe_pager(
    dense: Any,
    like_state: Any,
    *,
    owned: Optional[Iterable[int]] = None,
    metrics: Optional[Metrics] = None,
    spill_dir: Optional[str] = None,
    P: Optional[int] = None,
    name: Optional[str] = None,
    require_budget: bool = True,
) -> Optional["PartitionPager"]:
    """Env-gated factory: a pager iff ``CCRDT_PAGER`` is not switched
    off, a ``CCRDT_PAGER_HBM_BUDGET`` is configured (unless
    `require_budget=False`), and the engine is pageable — None otherwise,
    which every integration point treats as the all-resident legacy."""
    if not enabled():
        return None
    hbm = hbm_budget()
    if require_budget and not hbm:
        return None
    try:
        return PartitionPager(
            dense,
            like_state,
            P=P,
            name=name,
            owned=owned,
            hbm_budget_bytes=hbm or None,
            host_budget_bytes=host_budget() or None,
            spill_dir=spill_dir,
            metrics=metrics,
        )
    except ValueError:
        return None  # unpageable engine (lifted / bare MONOID)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class PartitionPager:
    """Per-chip hot/cold residency manager for one instance's partitions.

    Thread discipline: same as the state it manages — all mutation from
    the owner's gossip/op loop. The metrics registry is the only member
    other threads read."""

    def __init__(
        self,
        dense: Any,
        like_state: Any,
        *,
        P: Optional[int] = None,
        name: Optional[str] = None,
        owned: Optional[Iterable[int]] = None,
        hbm_budget_bytes: Optional[int] = None,
        host_budget_bytes: Optional[int] = None,
        spill_dir: Optional[str] = None,
        metrics: Optional[Metrics] = None,
        fold_cold: Optional[bool] = None,
    ) -> None:
        from .behaviour import MergeKind

        if pt._is_lifted(like_state):
            raise ValueError(
                "pager does not support lifted monoid states (they "
                "partition by replica row, not id)"
            )
        if getattr(dense, "merge_kind", None) == MergeKind.MONOID:
            raise ValueError(
                "pager does not support bare MONOID engines (their "
                "psnaps are unsound — same restriction as restrict_psnap)"
            )
        self.dense = dense
        self.P = int(P) if P else pt.n_partitions()
        self.name = name or getattr(dense, "type_name", "dense")
        self.metrics = metrics if metrics is not None else Metrics()
        self.fold_cold = fold_cold_default() if fold_cold is None else bool(fold_cold)
        self.spill_dir = spill_dir
        discard_spill(spill_dir)

        items, whole, extent = pt._item_plan(like_state)
        self.extent = int(extent)
        first = leaves(like_state)[0]
        self._R, self._NK = (int(x) for x in first.shape[:2])
        # The managed state's device; the substrate is pinned for a card.
        self._device = first.device
        self._slices = pt._is_topk_rmv(like_state)
        per_id = 0
        for _p, leaf, axis in items:
            n_items = max(int(leaf.shape[axis]), 1)
            per_id += _nbytes(leaf) // n_items
        counts = (
            np.bincount(pt.part_of(np.arange(self.extent), self.P), minlength=self.P)
            if self.extent
            else np.zeros(self.P, np.int64)
        )
        self.part_bytes: Dict[int, int] = {
            p: per_id * int(counts[p]) for p in range(self.P)
        }
        self.meta_bytes = sum(_nbytes(l) for _p, l in whole)
        universe = sorted(
            int(p)
            for p in (owned if owned is not None else range(self.P))
            if 0 <= int(p) < self.P
        )
        self.universe: List[int] = universe
        self.resident: Set[int] = set(universe)
        self.hbm_budget = int(hbm_budget_bytes) if hbm_budget_bytes else 0
        self.host_budget = int(host_budget_bytes) if host_budget_bytes else 0

        from ..parallel.delta import like_delta_for

        self._like_delta = like_delta_for(dense, like_state)
        self._cold: Optional[Any] = None  # host substrate (identity except cold)
        self._payloads: Dict[int, bytes] = {}  # RAM tier: CCPT psnap payloads
        self._spilled: Dict[int, str] = {}  # disk tier: part -> spill path
        self._digests: Dict[int, int] = {}  # cached crc32 per cold part
        self._queued: List[Tuple[frozenset, Any]] = []  # (cold parts, delta)
        self._ref: Dict[int, int] = {p: 0 for p in universe}
        self._hand = 0
        self.hits = 0
        self.misses = 0
        self._export()

    # --- residency queries -------------------------------------------------

    def is_resident(self, part: int) -> bool:
        return int(part) == self.P or int(part) in self.resident

    def cold_parts(self) -> Set[int]:
        return set(self.universe) - self.resident

    def has_cold(self) -> bool:
        return len(self.resident) < len(self.universe)

    def resident_bytes(self) -> int:
        return self.meta_bytes + sum(self.part_bytes[p] for p in self.resident)

    def host_bytes(self) -> int:
        return sum(len(b) for b in self._payloads.values())

    def parts_for_ids(self, ids: Any) -> List[int]:
        a = np.asarray(ids)
        if a.size == 0:
            return []
        return [int(x) for x in np.unique(pt.part_of(a, self.P))]

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return (self.hits / total) if total else 1.0

    # --- access accounting (policy inputs) ---------------------------------

    def touch(self, parts: Iterable[int], weight: int = 1) -> None:
        """Op-path partition counters: bump clock recency."""
        for p in parts:
            p = int(p)
            if p in self._ref:
                self._ref[p] = min(self._ref[p] + weight, _REF_CAP)

    def note_ids(self, ids: Any) -> None:
        """Serve-plane per-key access stream (the answered row ids)."""
        self.touch(self.parts_for_ids(ids))

    # --- joins --------------------------------------------------------------

    def _join(self, state: Any, delta: Any, *, inplace: bool = False, site: Optional[str] = None) -> Any:
        """`state` joined with a delta-shaped payload on `state`'s device.
        A topk_rmv payload joins only the id-slices its rows name (see
        the module docstring); `inplace` writes those slices and the
        whole leaves into `state` (the substrate, which nothing else
        holds) instead of a copy. Any other payload goes through
        `apply_any_delta` (a whole-state join). `site` observes the
        merge as that dispatch (`core.batch_merge.merge_into`)."""
        from ..parallel.delta import TopkRmvDelta, apply_any_delta

        if not (self._slices and isinstance(delta, TopkRmvDelta)):
            return apply_any_delta(self.dense, state, delta)
        from ..models.topk_rmv_dense import TopkRmvDenseState
        from ..ops.dense_table import NEG_INF

        dev = state.slot_score.device
        R, NK, I, M = state.slot_score.shape
        D = state.rmv_vc.shape[-1]
        rows = delta.rows.to(dev).long()
        ids, local = torch.unique(rows % I, sorted=True, return_inverse=True)
        n = int(ids.numel())
        at = (rows // I) * n + local  # rows of the [R * NK * n] slice
        vc = torch.maximum(state.vc, delta.vc.to(dev))
        lossy = state.lossy | delta.lossy.to(dev)
        if n:
            sub = TopkRmvDenseState(
                slot_score=state.slot_score.index_select(2, ids),
                slot_dc=state.slot_dc.index_select(2, ids),
                slot_ts=state.slot_ts.index_select(2, ids),
                rmv_vc=state.rmv_vc.index_select(2, ids),
                vc=state.vc,
                lossy=state.lossy,
            )

            def place(fill, src, width):
                out = torch.full((R * NK * n, width), fill, dtype=torch.int32, device=dev)
                out[at] = src.to(dev)
                return out.view(R, NK, n, width)

            incoming = TopkRmvDenseState(
                slot_score=place(NEG_INF, delta.slot_score, M),
                slot_dc=place(0, delta.slot_dc, M),
                slot_ts=place(0, delta.slot_ts, M),
                rmv_vc=place(0, delta.rmv_vc, D),
                vc=delta.vc.to(dev),
                lossy=delta.lossy.to(dev),
            )
            if site is None:
                joined = self.dense.merge(sub, incoming)
            else:
                joined = merge_into(self.dense.merge, sub, incoming, site=site)
            vc, lossy = joined.vc, joined.lossy
        if inplace:
            if n:
                for name in ("slot_score", "slot_dc", "slot_ts", "rmv_vc"):
                    getattr(state, name).index_copy_(2, ids, getattr(joined, name))
            state.vc.copy_(vc)
            state.lossy.copy_(lossy)
            return state

        def put(name):
            leaf = getattr(state, name)
            return leaf.index_copy(2, ids, getattr(joined, name)) if n else leaf

        return TopkRmvDenseState(
            slot_score=put("slot_score"), slot_dc=put("slot_dc"), slot_ts=put("slot_ts"),
            rmv_vc=put("rmv_vc"), vc=vc, lossy=lossy,
        )

    # --- demote / hydrate ---------------------------------------------------

    def demote(self, state: Any, part: int) -> Any:
        """Move one resident partition to the cold tier: serialize its
        psnap (the CCPT payload IS the stored representation), join it
        into the host substrate, reset the device slice to identity."""
        part = int(part)
        if part == self.P or part not in self.resident:
            return state
        psnap = pt.restrict_psnap(self.dense, state, part, self.P)
        payload = serial.dumps_dense(f"{self.name}_psnap", psnap)
        self._digests[part] = pt.digest_entries(state, self.P, [part])[part]
        self._fold_into_cold(psnap)
        state = clear_parts(self.dense, state, [part], self.P)
        self.resident.discard(part)
        self._store_payload(part, payload)
        self.metrics.count("pager.evictions")
        self._export()
        return state

    def hydrate(self, state: Any, part: int) -> Any:
        """Bring one cold partition back device-resident by decoding and
        joining its stored CCPT payload (so every hydration round-trips
        the storage format), then clear it out of the host substrate."""
        part = int(part)
        if part == self.P or part in self.resident:
            return state
        t0 = time.perf_counter()
        tok = (
            obs_spans.begin(SPAN_HYDRATE, part=part) if obs_spans.ACTIVE else None
        )
        try:
            if faults.ACTIVE:
                faults.fire("pager.hydrate")
            payload = self._load_payload(part)
            _name, psnap = serial.loads_dense(payload, self._like_delta)
            if profile.ACTIVE or devprof.ACTIVE:
                # The dispatch timing + h2d bytes of a hydration are
                # device-observatory evidence.
                with profile.dispatch("pager.hydrate", operands=(psnap,)):
                    state = self._join(state, psnap)
            else:
                state = self._join(state, psnap)
            if self._cold is not None:
                _clear_ids_(self.dense, self._cold, _part_ids([part], self.P, self.extent))
            self._drop_payload(part)
            self._digests.pop(part, None)
            self.resident.add(part)
            self.metrics.count("pager.hydrations")
        finally:
            obs_spans.end(tok)
        self.metrics.observe("pager.miss_ms", (time.perf_counter() - t0) * 1e3)
        state = self._drain_queue(state)
        self._export()
        return state

    def ensure_resident(self, state: Any, parts: Iterable[int]) -> Any:
        """The op/serve front door: hydrate whatever of `parts` is cold
        (billing hit/miss), bump recency, and re-enforce the HBM budget
        demoting ONLY partitions outside `parts`."""
        want = [int(p) for p in parts if int(p) != self.P]
        for p in want:
            if p in self.resident or p not in self._ref:
                self.hits += 1
            else:
                self.misses += 1
                state = self.hydrate(state, p)
        self.touch(want)
        return self.enforce_budget(state, protect=want)

    def ensure_resident_ids(self, state: Any, ids: Any) -> Any:
        return self.ensure_resident(state, self.parts_for_ids(ids))

    def enforce_budget(self, state: Any, protect: Iterable[int] = ()) -> Any:
        """Demote clock victims until resident item bytes fit the HBM
        budget. `protect` pins the partitions the caller is about to
        touch. No budget configured ⇒ no-op."""
        if not self.hbm_budget or not self.universe:
            return state
        protected = {int(p) for p in protect}
        # Bounded sweep: every visit either demotes or decays a ref
        # counter, so the clock terminates even when everything is hot.
        fuel = len(self.universe) * (_REF_CAP + 2)
        while self.resident_bytes() > self.hbm_budget and fuel > 0:
            victim = self._clock_victim(protected, fuel)
            if victim is None:
                break
            state = self.demote(state, victim)
            fuel -= 1
        return state

    def _clock_victim(self, protected: Set[int], fuel: int) -> Optional[int]:
        n = len(self.universe)
        for _ in range(min(fuel, n * (_REF_CAP + 2))):
            p = self.universe[self._hand % n]
            self._hand += 1
            if p not in self.resident or p in protected:
                continue
            if self._ref.get(p, 0) > 0:
                self._ref[p] -= 1  # second chance
                continue
            return p
        return None

    # --- the cold substrate -------------------------------------------------

    def _new_substrate(self) -> Any:
        """The join identity as CPU tensors, pinned when the managed
        state lives on a card."""
        pin = self._device.type == "cuda"
        with host_device():
            ident = self.dense.init(self._R, self._NK)
        if not pin:
            return tree_map(lambda x: x.to("cpu"), ident)
        return tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x), ident
        )

    def _fold_into_cold(self, delta: Any) -> None:
        """Join one delta-shaped payload into the host substrate on the
        CPU (the engine's plain path), observed as the
        ``pager.cold_fold`` dispatch."""
        from ..parallel import delta as dl

        if self._cold is None:
            self._cold = self._new_substrate()
        if self._slices:
            self._join(self._cold, delta, inplace=True, site="pager.cold_fold")
            return
        cpu = torch.device("cpu")
        with host_device():
            delta = tree_map(lambda x: x.to(cpu) if isinstance(x, torch.Tensor) else x, delta)
            expanded = dl.expand_table_delta(self.dense, self._cold, delta)
        self._cold = merge_into(self.dense.merge, self._cold, expanded, site="pager.cold_fold")

    def _refresh_cold(self, parts: Iterable[int]) -> None:
        """Re-derive payload + digest for cold partitions whose substrate
        content just changed — one leaf walk covers all of them."""
        want = sorted({int(p) for p in parts} & self.cold_parts())
        if not want or self._cold is None:
            return
        digs = pt.digest_entries(self._cold, self.P, want)
        for part in want:
            psnap = pt.restrict_psnap(self.dense, self._cold, part, self.P)
            self._store_payload(
                part, serial.dumps_dense(f"{self.name}_psnap", psnap)
            )
            self._digests[part] = digs[part]

    # --- gossip/anti-entropy integration ------------------------------------

    def apply_delta(self, state: Any, delta: Any) -> Any:
        """Join a peer delta (or decoded psnap) into the logical state
        WITHOUT hydrating: hot half on device, cold half folded into the
        host substrate (or queued under CCRDT_PAGER_FOLD=0)."""
        from ..parallel.delta import apply_any_delta

        cold = self.cold_parts()
        if not cold:
            return apply_any_delta(self.dense, state, delta)
        parts = pt.delta_parts(self.dense, state, delta, self.P)
        hit_cold = parts & cold
        if not hit_cold:
            return apply_any_delta(self.dense, state, delta)
        hot, coldd = pt.split_delta(self.dense, state, delta, self.P, hit_cold)
        if hot is not None:
            state = self._join(state, hot)
        if coldd is not None:
            if self.fold_cold:
                self._fold_into_cold(coldd)
                self._refresh_cold(hit_cold)
                self.metrics.count("pager.cold_folds")
            else:
                self._queued.append((frozenset(hit_cold), coldd))
                self.metrics.count("pager.queued_deltas")
        return state

    def apply_payload(self, state: Any, payload: bytes) -> Any:
        """Anti-entropy repair entry: a fetched psnap payload joins hot
        on device / cold host-side, exactly like a delta."""
        _name, psnap = serial.loads_dense(payload, self._like_delta)
        return self.apply_delta(state, psnap)

    def absorb_peer(self, peer: Any) -> Any:
        """Fold the cold-partition slices of a full peer state into the
        host tier; returns the peer with those slices cleared, safe for
        the caller's ordinary device merge. Full snapshots always fold
        (anchors are rare; queueing a whole state buys nothing)."""
        cold = sorted(self.cold_parts())
        if not cold:
            return peer
        for part in cold:
            self._fold_into_cold(pt.restrict_psnap(self.dense, peer, part, self.P))
        self._refresh_cold(cold)
        self.metrics.count("pager.cold_folds", len(cold))
        return clear_parts(self.dense, peer, cold, self.P)

    def _drain_queue(self, state: Any) -> Any:
        """After a hydration, re-attempt queued deltas: partitions now
        resident apply on device; still-cold remainders re-queue."""
        if not self._queued:
            return state
        pending, self._queued = self._queued, []
        for parts, delta in pending:
            still_cold = set(parts) & self.cold_parts()
            if not still_cold:
                state = self._join(state, delta)
                self.metrics.count("pager.queue_drains")
                continue
            hot, coldd = pt.split_delta(
                self.dense, state, delta, self.P, still_cold
            )
            if hot is not None:
                state = self._join(state, hot)
                self.metrics.count("pager.queue_drains")
            if coldd is not None:
                self._queued.append((frozenset(still_cold), coldd))
        return state

    # --- mixed-residency read surface ---------------------------------------

    def digest_entries_for(self, state: Any, parts: Sequence[int]) -> Dict[int, int]:
        """Per-partition digests against the LOGICAL state: live entries
        from the device state, cold entries from the cache — bit-equal to
        an all-resident `digest_entries` because a cold partition's
        content lives wholly in the substrate the cache was cut from."""
        want = [int(p) for p in parts]
        cold = self.cold_parts()
        live = [p for p in want if p not in cold]
        out = dict(pt.digest_entries(state, self.P, live)) if live else {}
        for p in want:
            if p in cold:
                out[p] = self._digests[p]
        return out

    def digest_vector(self, state: Any) -> np.ndarray:
        entries = self.digest_entries_for(state, range(self.P + 1))
        vec = np.zeros(self.P + 1, np.uint32)
        for part, crc in entries.items():
            vec[part] = crc
        return vec

    def psnap_payload(self, state: Any, part: int) -> bytes:
        """The dumps_dense psnap payload for any partition: cold answers
        straight from storage (no hydration), hot restricts the device
        state as the legacy path does."""
        part = int(part)
        if part != self.P and part in self.cold_parts():
            self.metrics.count("pager.blob_serves")
            return self._load_payload(part)
        return serial.dumps_dense(
            f"{self.name}_psnap",
            pt.restrict_psnap(self.dense, state, part, self.P),
        )

    def psnap_blob(self, state: Any, seq: int, part: int) -> bytes:
        return pt.encode_psnap_blob(seq, part, self.psnap_payload(state, part))

    def full_state(self, state: Any) -> Any:
        """The logical state: device ⊔ cold substrate. Used at anchor
        publishes, serve swaps, checkpoints, and reference compares.
        Does not change residency. The substrate is copied to the
        state's device (a synchronous copy: the substrate may be written
        again right after) and joined there; the result is a new state."""
        if not self.has_cold() or self._cold is None:
            return state
        dev = leaves(state)[0].device
        cold_dev = tree_map(lambda x: x.to(dev), self._cold)
        self.metrics.count("pager.full_joins")
        return merge_into(
            self.dense.merge, state, cold_dev, site="pager.full_join"
        )

    # --- payload tiers (RAM -> disk) ----------------------------------------

    def _store_payload(self, part: int, payload: bytes) -> None:
        path = self._spilled.pop(part, None)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._payloads[part] = payload
        self._enforce_host_budget()

    def _enforce_host_budget(self) -> None:
        if not (self.host_budget and self.spill_dir):
            return
        while self.host_bytes() > self.host_budget and self._payloads:
            # Spill the least-recently-touched payload first.
            part = min(self._payloads, key=lambda p: (self._ref.get(p, 0), p))
            path = os.path.join(
                self.spill_dir, f"{SPILL_PREFIX}{self.name}-{part:05d}.ccpt"
            )
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(self._payloads[part])
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._spilled[part] = path
            del self._payloads[part]
            self.metrics.count("pager.spills")

    def _load_payload(self, part: int) -> bytes:
        blob = self._payloads.get(part)
        if blob is not None:
            return blob
        path = self._spilled.get(part)
        if path is None:
            raise KeyError(f"partition {part} has no cold payload")
        with open(path, "rb") as f:
            return f.read()

    def _drop_payload(self, part: int) -> None:
        self._payloads.pop(part, None)
        path = self._spilled.pop(part, None)
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass

    # --- observability -------------------------------------------------------

    def _export(self) -> None:
        m = self.metrics
        m.set("pager.resident_parts", len(self.resident))
        m.set("pager.resident_bytes", self.resident_bytes())
        m.set("pager.cold_parts", len(self.universe) - len(self.resident))
        m.set("pager.host_bytes", self.host_bytes())
        m.set("pager.spilled_parts", len(self._spilled))
        if devprof.ACTIVE:
            # HBM occupancy vs CCRDT_PAGER_HBM_BUDGET + high-watermark,
            # into the device observatory's own metrics registry.
            devprof.note_pager(self.resident_bytes(), self.hbm_budget)

    def export_gauges(self) -> None:
        self._export()

    def counters(self) -> Dict[str, int]:
        snap = self.metrics.snapshot()["counters"]
        return {
            k: int(v) for k, v in snap.items() if k.startswith("pager.")
        }

    def health_fields(self) -> Dict[str, Any]:
        return {
            "pager_resident_parts": len(self.resident),
            "pager_cold_parts": len(self.universe) - len(self.resident),
            "pager_resident_bytes": self.resident_bytes(),
            "pager_hbm_budget": self.hbm_budget,
            "pager_host_bytes": self.host_bytes(),
            "pager_spilled_parts": len(self._spilled),
            "pager_hit_rate": round(self.hit_rate(), 4),
            "pager_evictions": int(
                self.metrics.counters.get("pager.evictions", 0)
            ),
            "pager_hydrations": int(
                self.metrics.counters.get("pager.hydrations", 0)
            ),
            "pager_cold_folds": int(
                self.metrics.counters.get("pager.cold_folds", 0)
            ),
        }

    def status_fields(self) -> Dict[str, Any]:
        """The dashboard drop (`pager r:N/B` column in obs_dashboard)."""
        return {
            "resident_parts": len(self.resident),
            "total_parts": len(self.universe),
            "resident_bytes": self.resident_bytes(),
            "hit_rate": round(self.hit_rate(), 4),
        }
