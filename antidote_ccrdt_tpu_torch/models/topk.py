"""topk: bounded top-K of (id, score) pairs, per-id max.

Reference: ``src/antidote_ccrdt_topk.erl`` — but rebuilt, not ported:
SURVEY.md §2 quirk #1 documents that the reference's ``topk`` is actually a
*filtered grow-only map* (its "size" field is used as a score threshold in
``changes_state`` ``:164-166``, ``add`` never prunes ``:157-158``, and its
own ``new_test`` fails). Per the survey directive this rebuild implements a
real bounded top-K:

* state = at most K (id, score) entries, keeping the max score per id;
* ``downstream`` drops ops that cannot change the observable state
  (the reference's filtering concept, ``topk.erl:90-94``, done right);
* compaction batches adds into one ``add_map`` op (``:136-146``) but merges
  duplicate ids with **max** rather than the reference's order-dependent
  last-wins (quirk #4, ``topk.erl:160-161``).

The state is a join-semilattice (join = per-id max, then top-K by
(score, id) order), so the dense merge is JOIN algebra.

A port of ``antidote_ccrdt_tpu/models/topk.py``: the scalar half is the same
code (bit for bit in ``to_binary``), the dense half computes the JAX
engine's results on tensors.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

from ..core import serial
from ..core.behaviour import EffectOp, PrepareOp, registry
from ..core.clock import ClockContext


class TopkState(NamedTuple):
    entries: Dict[Any, int]  # id -> best score; len <= size
    size: int


def _beats(a: Tuple[Any, int], b: Tuple[Any, int]) -> bool:
    """(id, score) strict order: score desc, then id desc (topk.erl:83)."""
    i1, s1 = a
    i2, s2 = b
    return s1 > s2 or (s1 == s2 and i1 > i2)


def _min_entry(entries: Dict[Any, int]) -> Optional[Tuple[Any, int]]:
    best = None
    for pair in entries.items():
        if best is None or _beats(best, pair):
            best = pair
    return best


def _join(entries: Dict[Any, int], items, size: int) -> Dict[Any, int]:
    """Per-id max over the union, then keep the top `size` by order."""
    merged = dict(entries)
    for id_, score in items:
        if id_ not in merged or score > merged[id_]:
            merged[id_] = score
    if len(merged) <= size:
        return merged
    ranked = sorted(merged.items(), key=lambda p: (p[1], p[0]), reverse=True)
    return dict(ranked[:size])


class TopkScalar:
    type_name = "topk"

    def new(self, size: int = 100) -> TopkState:
        assert isinstance(size, int) and size > 0
        return TopkState({}, size)

    def value(self, state: TopkState) -> list:
        return sorted(
            state.entries.items(), key=lambda p: (p[1], p[0]), reverse=True
        )

    def downstream(
        self, op: PrepareOp, state: TopkState, ctx: ClockContext
    ) -> Optional[EffectOp]:
        kind, payload = op
        assert kind == "add"
        id_, score = payload
        return ("add", (id_, score)) if self._changes_state(id_, score, state) else None

    def _changes_state(self, id_, score, state: TopkState) -> bool:
        if id_ in state.entries:
            return score > state.entries[id_]
        if len(state.entries) < state.size:
            return True
        min_ = _min_entry(state.entries)
        return _beats((id_, score), min_)

    def update(self, effect: EffectOp, state: TopkState) -> Tuple[TopkState, list]:
        kind, payload = effect
        if kind == "add":
            id_, score = payload
            return TopkState(_join(state.entries, [(id_, score)], state.size), state.size), []
        if kind == "add_map":
            return TopkState(_join(state.entries, payload.items(), state.size), state.size), []
        raise ValueError(f"unsupported effect {effect!r}")

    def require_state_downstream(self, op: PrepareOp) -> bool:
        return True

    def is_operation(self, op: Any) -> bool:
        return (
            isinstance(op, tuple)
            and len(op) == 2
            and op[0] == "add"
            and isinstance(op[1], tuple)
            and len(op[1]) == 2
            and isinstance(op[1][1], int)
        )

    def is_replicate_tagged(self, effect: EffectOp) -> bool:
        return False

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        return e1[0] in ("add", "add_map") and e2[0] in ("add", "add_map")

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        """Batch adds into one add_map; duplicate ids take max (quirk #4 fix)."""

        def items(e):
            return [e[1]] if e[0] == "add" else list(e[1].items())

        merged: Dict[Any, int] = {}
        for id_, score in items(e1) + items(e2):
            if id_ not in merged or score > merged[id_]:
                merged[id_] = score
        return None, ("add_map", merged)

    def equal(self, a: TopkState, b: TopkState) -> bool:
        return a.entries == b.entries and a.size == b.size

    def to_binary(self, state: TopkState) -> bytes:
        return serial.dumps_scalar(self.type_name, tuple(state))

    def from_binary(self, data: bytes) -> TopkState:
        name, payload = serial.loads_scalar(data)
        assert name == self.type_name
        entries, size = payload
        return TopkState(entries, size)


registry.register("topk", scalar=TopkScalar())


class TopkScalarCompat(TopkScalar):
    """Reference-OBSERVABLE topk semantics, quirks included, for
    differential testing against a live Antidote node.

    Decision record (VERDICT r1 missing #4): the rebuilt `TopkScalar`
    above is the product — a real bounded top-K per SURVEY §2 quirk #1's
    directive — and that decision is permanent. This class exists solely
    so the bridge can be driven against a host that runs the reference
    module and byte-level behavior must match. It reproduces, faithfully
    (`src/antidote_ccrdt_topk.erl`):

    * ``new()`` defaults to size **1000** (:65-66) even though the
      reference's own test expects 100;
    * ``downstream`` emits the add iff ``Score > Size`` — "size" is a
      score threshold, not a capacity (:164-166);
    * ``update`` add is ``maps:put`` — **last-wins**, not max (:157-158),
      and ``add`` never prunes: the state is a filtered grow-only map;
    * ``can_compact`` is always true and ``compact_ops`` merges duplicate
      ids last-wins via ``maps:merge`` (:136-146, :160-161) — an
      order-dependent result;
    * ``equal`` compares the full state (:107-109).

    NOT registered: `registry` whitelists the six reference type names and
    "topk" maps to the rebuilt engine. Construct this directly. Subclasses
    `TopkScalar`, overriding exactly the quirk-bearing callbacks; the rest
    (value ordering, serialization, equal, predicates) are shared.
    """

    type_name = "topk_compat"

    def new(self, size: int = 1000) -> TopkState:
        assert isinstance(size, int) and size > 0
        return TopkState({}, size)

    def downstream(
        self, op: PrepareOp, state: TopkState, ctx: ClockContext
    ) -> Optional[EffectOp]:
        kind, payload = op
        assert kind == "add"
        id_, score = payload
        # changes_state/2 (:164-166): Score > Size, nothing else.
        return ("add", (id_, score)) if score > state.size else None

    def update(self, effect: EffectOp, state: TopkState) -> Tuple[TopkState, list]:
        kind, payload = effect
        if kind == "add":
            id_, score = payload
            entries = dict(state.entries)
            entries[id_] = score  # maps:put — last-wins (:157-158)
            return TopkState(entries, state.size), []
        if kind == "add_map":
            entries = dict(state.entries)
            entries.update(payload)  # maps:merge — last-wins (:160-161)
            return TopkState(entries, state.size), []
        raise ValueError(f"unsupported effect {effect!r}")

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        return True  # (:131-132)

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        def items(e):
            return [e[1]] if e[0] == "add" else list(e[1].items())

        merged: Dict[Any, int] = {}
        for id_, score in items(e1) + items(e2):
            merged[id_] = score  # last-wins, in op order (:136-146)
        return None, ("add_map", merged)



# --- dense level -----------------------------------------------------------

import dataclasses  # noqa: E402

import torch  # noqa: E402

from ..core.behaviour import MergeKind  # noqa: E402
from ..device import DeviceLike, resolve_device  # noqa: E402
from ..ops.dense_table import (  # noqa: E402
    NEG_INF,
    masked_topk,
    observables_equal,
    observe_value,
    table_addresses,
)


@dataclasses.dataclass
class TopkDenseState:
    """Per-id best-score table [R, NK, I]; the bounded top-K observable is
    derived. The dense lattice keeps every id's max (join = elementwise
    max), which refines the scalar bounded state without changing the
    observable."""

    best_score: torch.Tensor  # i32[R, NK, I]; NEG_INF = never seen


@dataclasses.dataclass
class TopkOps:
    key: torch.Tensor  # i32[R, B]
    id: torch.Tensor  # i32[R, B]
    score: torch.Tensor  # i32[R, B]
    valid: torch.Tensor  # bool[R, B]


class TopkDense:
    """Batched topk over [n_replicas, n_keys] (port of the JAX
    ``TopkDense``). ``device``: where `init` puts states (default: the
    CUDA card; raises without one)."""

    type_name = "topk"
    merge_kind = MergeKind.JOIN

    def __init__(self, n_ids: int, size: int = 100, device: DeviceLike = None):
        self.I = n_ids
        self.K = size
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int = 1) -> TopkDenseState:
        return TopkDenseState(
            best_score=torch.full((n_replicas, n_keys, self.I), NEG_INF, dtype=torch.int32, device=self.device)
        )

    def apply_ops(self, state: TopkDenseState, ops: TopkOps):
        """Per-(key, id) max of the batch's valid scores; an op whose key
        or id lies outside the table is dropped (the JAX scatter's
        ``mode="drop"``)."""
        flat, keep = table_addresses(tuple(state.best_score.shape), ops.key, ops.id, ops.valid)
        out = state.best_score.clone()
        out.view(-1).scatter_reduce_(0, flat, ops.score.to(torch.int32)[keep], "amax")
        return TopkDenseState(out), None

    def merge(self, a: TopkDenseState, b: TopkDenseState) -> TopkDenseState:
        return TopkDenseState(torch.maximum(a.best_score, b.best_score))

    def observe(self, state: TopkDenseState):
        return masked_topk(state.best_score, self.K)

    def value(self, state: TopkDenseState):
        return observe_value(self.observe, state)

    def equal(self, a: TopkDenseState, b: TopkDenseState) -> bool:
        return observables_equal(self.observe(a), self.observe(b))


def make_dense(n_ids: int, size: int = 100, device: DeviceLike = None) -> TopkDense:
    return TopkDense(n_ids=n_ids, size=size, device=device)


registry.register("topk", dense_factory=make_dense)
