"""topk_rmv: top-K with add-wins element removal via per-id vector clocks.

Reference: ``src/antidote_ccrdt_topk_rmv.erl``. The state is a 6-tuple
``{Observed, Masked, Removals, Vc, Min, Size}`` (``:67-74``):

* ``observed`` — id -> best visible element, at most ``size`` entries;
* ``masked``  — id -> set of *all* live adds (the history that removal
  filters; an add survives a removal iff its ts is newer than the removal
  vc at its origin DC — the add-wins core, ``:258-260``);
* ``removals`` — id -> vector-clock tombstone (``:64``);
* ``vc`` — max timestamp per DC over every add this replica has seen
  (``:233``);
* ``min`` — cached smallest observed element (``:399-406``).

Elements are ``(score, id, (dc, ts))`` triples ordered by ``cmp``
(score, then id, then ts — ``:390-395``); ``NIL`` is the reference's
``{nil, nil, nil}``.

Extra-op generation (``antidote_ccrdt.erl:37-40``): `update` returns ops to
re-ship when (a) an add arrives for an already-removed element — re-broadcast
the stored removal (``:234-237``) — or (b) a removal uncovers a masked
element which gets promoted into observed (``:291-295``).

A copy of ``antidote_ccrdt_tpu/models/topk_rmv.py``: the same code, bit for
bit in ``to_binary``. The dense engine is ``models/topk_rmv_dense.py``.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

from ..core import serial
from ..core.behaviour import EffectOp, PrepareOp, registry
from ..core.clock import ClockContext

# (score, id, (dc, ts)) — internal element order, and (None, None, None) nil.
Elem = Tuple[Any, Any, Any]
Vc = Dict[Any, int]
NIL: Elem = (None, None, None)


class TopkRmvState(NamedTuple):
    observed: Dict[Any, Elem]
    masked: Dict[Any, FrozenSet[Elem]]
    removals: Dict[Any, Vc]
    vc: Vc
    min: Elem
    size: int


def _cmp(a: Elem, b: Elem) -> bool:
    """Strict 'a beats b' total order: score, then id, then ts (topk_rmv.erl:390-395).

    nil never beats anything; anything beats nil."""
    if a == NIL:
        return False
    if b == NIL:
        return True
    s1, i1, (_, t1) = a
    s2, i2, (_, t2) = b
    return s1 > s2 or (s1 == s2 and i1 > i2) or (s1 == s2 and i1 == i2 and t1 > t2)


def _vc_get(vc: Vc, dc: Any) -> int:
    return vc.get(dc, 0)


def _vc_update(vc: Vc, dc: Any, ts: int) -> Vc:
    out = dict(vc)
    out[dc] = max(ts, out.get(dc, ts))
    return out


def _merge_vcs(a: Vc, b: Vc) -> Vc:
    out = dict(a)
    for k, t in b.items():
        out[k] = max(t, out[k]) if k in out else t
    return out


def _min_observed(observed: Dict[Any, Elem]) -> Elem:
    """Smallest observed element by natural term order (topk_rmv.erl:399-406)."""
    if not observed:
        return NIL
    return min(observed.values())


class TopkRmvScalar:
    type_name = "topk_rmv"

    def new(self, size: int = 100) -> TopkRmvState:
        assert isinstance(size, int) and size > 0
        return TopkRmvState({}, {}, {}, {}, NIL, size)

    def value(self, state: TopkRmvState) -> list:
        return [(i, s) for (s, i, _) in state.observed.values()]

    def downstream(
        self, op: PrepareOp, state: TopkRmvState, ctx: ClockContext
    ) -> Optional[EffectOp]:
        kind, payload = op
        if kind == "add":
            # Stamp with (dc, time) — the reference's only shim calls
            # (topk_rmv.erl:104-105), here explicit via ctx.
            id_, score = payload
            dc, ts = ctx.stamp()
            elem_internal = (score, id_, (dc, ts))
            if id_ in state.observed:
                changes = _cmp(elem_internal, state.observed[id_])
            else:
                changes = _cmp(elem_internal, state.min)
            tag = "add" if changes else "add_r"
            return (tag, (id_, score, (dc, ts)))
        if kind == "rmv":
            id_ = payload
            if id_ not in state.masked:
                return None
            tag = "rmv" if id_ in state.observed else "rmv_r"
            return (tag, (id_, dict(state.vc)))
        raise ValueError(f"unsupported op {op!r}")

    def update(self, effect: EffectOp, state: TopkRmvState) -> Tuple[TopkRmvState, list]:
        kind, payload = effect
        if kind in ("add", "add_r"):
            id_, score, ts = payload
            return self._add(id_, score, ts, state)
        if kind in ("rmv", "rmv_r"):
            id_, vc = payload
            return self._rmv(id_, vc, state)
        raise ValueError(f"unsupported effect {effect!r}")

    def _add(self, id_, score, ts, state: TopkRmvState):
        dc, t = ts
        vc1 = _vc_update(state.vc, dc, t)
        rmv_vc = state.removals.get(id_, {})
        if _vc_get(rmv_vc, dc) >= t:
            # Add dominated by a stored tombstone: state unchanged except the
            # clock advance, and the removal is re-broadcast (:234-237).
            new_state = state._replace(vc=vc1)
            return new_state, [("rmv", (id_, dict(rmv_vc)))]
        elem = (score, id_, ts)
        masked = dict(state.masked)
        masked[id_] = masked.get(id_, frozenset()) | {elem}
        observed, min_ = self._recompute_observed(
            state.observed, state.min, state.size, id_, elem
        )
        return TopkRmvState(observed, masked, state.removals, vc1, min_, state.size), []

    def _recompute_observed(self, observed, min_, size, id_, elem):
        """topk_rmv.erl:302-334."""
        if id_ in observed:
            old = observed[id_]
            if _cmp(elem, old):
                new_obs = dict(observed)
                new_obs[id_] = elem
                new_min = _min_observed(new_obs) if old == min_ else min_
                return new_obs, new_min
            return observed, min_
        if len(observed) < size:
            new_obs = dict(observed)
            new_obs[id_] = elem
            new_min = elem if (_cmp(min_, elem) or min_ == NIL) else min_
            return new_obs, new_min
        if _cmp(elem, min_):
            min_id = min_[1]
            new_obs = dict(observed)
            del new_obs[min_id]
            new_obs[id_] = elem
            return new_obs, _min_observed(new_obs)
        return observed, min_

    def _rmv(self, id_, vc_rmv: Vc, state: TopkRmvState):
        """topk_rmv.erl:252-298."""
        removals = dict(state.removals)
        removals[id_] = _merge_vcs(removals.get(id_, {}), vc_rmv)
        masked = dict(state.masked)
        if id_ in masked:
            # add-wins filter: survive iff strictly newer than the removal
            # vc at the add's origin DC (:258-260).
            kept = frozenset(
                e for e in masked[id_] if e[2][1] > _vc_get(vc_rmv, e[2][0])
            )
            if kept:
                masked[id_] = kept
            else:
                del masked[id_]
        impacts = False
        if id_ in state.observed:
            _, _, (odc, ots) = state.observed[id_]
            impacts = _vc_get(vc_rmv, odc) >= ots
        if not impacts:
            return state._replace(masked=masked, removals=removals), []
        tmp_obs = dict(state.observed)
        removed_elem = tmp_obs.pop(id_)
        # Promotion scan over the whole masked map (:276-281): best live
        # element of every non-observed id, by natural term order.
        candidates = [
            max(elems) for i, elems in masked.items() if i not in tmp_obs
        ]
        if not candidates:
            new_min = _min_observed(tmp_obs) if removed_elem == state.min else state.min
            return (
                TopkRmvState(tmp_obs, masked, removals, state.vc, new_min, state.size),
                [],
            )
        new_elem = max(candidates)
        s, i, t = new_elem
        tmp_obs[i] = new_elem
        new_state = TopkRmvState(
            tmp_obs, masked, removals, state.vc, _min_observed(tmp_obs), state.size
        )
        return new_state, [("add", (i, s, t))]

    def require_state_downstream(self, op: PrepareOp) -> bool:
        return True

    def is_operation(self, op: Any) -> bool:
        if not (isinstance(op, tuple) and len(op) == 2):
            return False
        kind, payload = op
        if kind == "add":
            return (
                isinstance(payload, tuple)
                and len(payload) == 2
                and all(isinstance(x, int) for x in payload)
            )
        if kind == "rmv":
            return isinstance(payload, int)
        return False

    def is_replicate_tagged(self, effect: EffectOp) -> bool:
        return effect[0] in ("add_r", "rmv_r")

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        """topk_rmv.erl:178-194."""
        k1, k2 = e1[0], e2[0]
        if (k1, k2) in (("add", "add"), ("add_r", "add")):
            return e1[1][0] == e2[1][0]
        if k1 in ("add", "add_r") and k2 in ("rmv", "rmv_r"):
            if (k1, k2) == ("add", "rmv_r"):
                return False
            id1, _, (dc, ts) = e1[1]
            id2, vc = e2[1]
            return id1 == id2 and _vc_get(vc, dc) >= ts
        if k1 in ("rmv", "rmv_r") and k2 in ("rmv", "rmv_r"):
            return e1[1][0] == e2[1][0]
        return False

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        """topk_rmv.erl:197-223. None marks the dead slot."""
        k1, k2 = e1[0], e2[0]
        if (k1, k2) == ("add", "add"):
            id1, s1, t1 = e1[1]
            id2, s2, t2 = e2[1]
            if s1 > s2:
                return ("add", (id1, s1, t1)), ("add_r", (id2, s2, t2))
            return ("add_r", (id1, s1, t1)), ("add", (id2, s2, t2))
        if (k1, k2) == ("add_r", "add"):
            _, s1, t1 = e1[1]
            _, s2, t2 = e2[1]
            if s1 == s2 and t1 == t2:
                return None, e2
            return e1, e2
        if k1 in ("add", "add_r") and k2 in ("rmv", "rmv_r"):
            return None, e2
        if k1 in ("rmv", "rmv_r") and k2 in ("rmv", "rmv_r"):
            id2, vc2 = e2[1]
            vc1 = e1[1][1]
            merged = _merge_vcs(vc1, vc2)
            # rmv absorbs rmv_r: the result is observable if either was
            # (topk_rmv.erl:216-223 — {rmv_r,rmv_r} is the only pair that
            # stays tagged).
            tag = "rmv_r" if (k1, k2) == ("rmv_r", "rmv_r") else "rmv"
            return None, (tag, (id2, merged))
        raise ValueError(f"cannot compact {e1!r}, {e2!r}")

    def equal(self, a: TopkRmvState, b: TopkRmvState) -> bool:
        # Observable state only (topk_rmv.erl:151-153).
        return a.observed == b.observed and a.size == b.size

    def to_binary(self, state: TopkRmvState) -> bytes:
        payload = (
            state.observed,
            {k: frozenset(v) for k, v in state.masked.items()},
            state.removals,
            state.vc,
            state.min,
            state.size,
        )
        return serial.dumps_scalar(self.type_name, payload)

    def from_binary(self, data: bytes) -> TopkRmvState:
        name, payload = serial.loads_scalar(data)
        assert name == self.type_name
        obs, masked, removals, vc, min_, size = payload
        return TopkRmvState(obs, dict(masked), removals, vc, tuple(min_), size)


registry.register("topk_rmv", scalar=TopkRmvScalar(), generates_extra_operations=True)
