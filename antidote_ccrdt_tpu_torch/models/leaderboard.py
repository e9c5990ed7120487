"""leaderboard: top-K with permanent player bans.

Reference: ``src/antidote_ccrdt_leaderboard.erl``. Unlike topk_rmv's
add-wins removal, a ban is irreversible (``:21-27``), so no causal metadata
is needed: the 5-tuple state ``{Observed, Masked, Bans, Min, Size}``
(``:62-68``) keeps only the best score per player, a ban set, and a cached
min. ``Masked`` holds the best score of each non-observed player so a ban
of an observed player can promote a replacement (``:265-286``), emitting an
extra ``("add", promoted)`` op (``:279-283``).

Dense design (SURVEY.md §7): per (replica, key) a direct-indexed player
table — ``best_score[P]``, ``seen[P]``, ``banned[P]`` — where applying an
op batch is a segment-max scatter and the cross-replica merge is
elementwise ``max`` / ``or`` (JOIN algebra). Observed/masked/min are
*derived* views (masked top-K), not materialized: recomputing them
vectorized replaces the reference's incremental min/promotion bookkeeping
(the hot paths at ``leaderboard.erl:298-312``).

A port of ``antidote_ccrdt_tpu/models/leaderboard.py``: the scalar half is
the same code (bit for bit in ``to_binary``), the dense half computes the
JAX engine's results on tensors.
"""

from __future__ import annotations

from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

from ..core import serial
from ..core.behaviour import EffectOp, PrepareOp, registry
from ..core.clock import ClockContext

Pair = Tuple[Any, Any]  # (id, score); (None, None) is the reference's {nil, nil}
NIL: Pair = (None, None)


class LeaderboardState(NamedTuple):
    observed: Dict[Any, int]
    masked: Dict[Any, int]
    bans: FrozenSet[Any]
    min: Pair
    size: int


def _cmp(a: Pair, b: Pair) -> bool:
    """Strict 'a beats b': score then id (leaderboard.erl:289-294)."""
    if a == NIL:
        return False
    if b == NIL:
        return True
    i1, s1 = a
    i2, s2 = b
    return s1 > s2 or (s1 == s2 and i1 > i2)


def _min_pair(observed: Dict[Any, int]) -> Pair:
    """Smallest (id, score) by cmp order (leaderboard.erl:297-303)."""
    best = NIL
    for pair in observed.items():
        if best == NIL or _cmp(best, pair):
            best = pair
    return best


def _largest(masked: Dict[Any, int]) -> Pair:
    """Largest (id, score) by cmp order (leaderboard.erl:306-312)."""
    best = NIL
    for pair in masked.items():
        if best == NIL or _cmp(pair, best):
            best = pair
    return best


class LeaderboardScalar:
    type_name = "leaderboard"

    def new(self, size: int = 100) -> LeaderboardState:
        assert isinstance(size, int) and size > 0
        return LeaderboardState({}, {}, frozenset(), NIL, size)

    def value(self, state: LeaderboardState) -> list:
        return sorted(state.observed.items())

    def downstream(
        self, op: PrepareOp, state: LeaderboardState, ctx: ClockContext
    ) -> Optional[EffectOp]:
        """leaderboard.erl:94-116 filter cascade."""
        kind, payload = op
        if kind == "add":
            id_, score = payload
            if id_ in state.bans:
                return None
            if id_ in state.observed:
                return ("add", (id_, score)) if score > state.observed[id_] else None
            if id_ in state.masked and score <= state.masked[id_]:
                return None
            if len(state.observed) < state.size or _cmp((id_, score), state.min):
                return ("add", (id_, score))
            return ("add_r", (id_, score))
        if kind == "ban":
            id_ = payload
            return None if id_ in state.bans else ("ban", id_)
        raise ValueError(f"unsupported op {op!r}")

    def update(
        self, effect: EffectOp, state: LeaderboardState
    ) -> Tuple[LeaderboardState, list]:
        kind, payload = effect
        if kind in ("add", "add_r"):
            return self._add(payload[0], payload[1], state)
        if kind == "ban":
            return self._ban(payload, state)
        raise ValueError(f"unsupported effect {effect!r}")

    def _add(self, id_, score, state: LeaderboardState):
        """leaderboard.erl:216-261."""
        if id_ in state.bans:
            return state, []
        if id_ in state.observed:
            if score > state.observed[id_]:
                new_obs = dict(state.observed)
                new_obs[id_] = score
                new_min = _min_pair(new_obs) if state.min[0] == id_ else state.min
                return state._replace(observed=new_obs, min=new_min), []
            return state, []
        if len(state.observed) == state.size:
            if _cmp((id_, score), state.min):
                # Promote over the min: min is demoted to masked (:237-242).
                min_id, min_score = state.min
                masked = dict(state.masked)
                masked.pop(id_, None)
                new_obs = dict(state.observed)
                new_obs[id_] = score
                del new_obs[min_id]
                masked[min_id] = min_score
                return (
                    state._replace(
                        observed=new_obs, masked=masked, min=_min_pair(new_obs)
                    ),
                    [],
                )
            if id_ not in state.masked or score > state.masked[id_]:
                masked = dict(state.masked)
                masked[id_] = score
                return state._replace(masked=masked), []
            return state, []
        new_obs = dict(state.observed)
        new_obs[id_] = score
        new_min = (
            (id_, score)
            if state.min == NIL or _cmp(state.min, (id_, score))
            else state.min
        )
        return state._replace(observed=new_obs, min=new_min), []

    def _ban(self, id_, state: LeaderboardState):
        """leaderboard.erl:265-286."""
        masked1 = dict(state.masked)
        masked1.pop(id_, None)
        obs1 = dict(state.observed)
        was_observed = id_ in obs1
        obs1.pop(id_, None)
        bans1 = state.bans | {id_}
        if not was_observed:
            return state._replace(masked=masked1, bans=bans1), []
        new_elem = _largest(state.masked)  # pre-ban masked, as in :271
        if new_elem == NIL:
            new_min = _min_pair(obs1) if state.min[0] == id_ else state.min
            return (
                LeaderboardState(obs1, masked1, bans1, new_min, state.size),
                [],
            )
        new_id, new_score = new_elem
        masked2 = dict(masked1)
        masked2.pop(new_id, None)
        obs2 = dict(obs1)
        obs2[new_id] = new_score
        new_state = LeaderboardState(obs2, masked2, bans1, new_elem, state.size)
        return new_state, [("add", new_elem)]

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
        if kind == "ban":
            return isinstance(payload, int)
        return False

    def is_replicate_tagged(self, effect: EffectOp) -> bool:
        return effect[0] == "add_r"

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        """leaderboard.erl:163-174."""
        k1, k2 = e1[0], e2[0]
        if k1 in ("add", "add_r") and k2 in ("add", "add_r"):
            return e1[1][0] == e2[1][0]
        if k1 in ("add", "add_r") and k2 == "ban":
            return e1[1][0] == e2[1]
        if (k1, k2) == ("ban", "ban"):
            return e1[1] == e2[1]
        return False

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        """leaderboard.erl:177-205. None marks the dead slot."""
        k1, k2 = e1[0], e2[0]
        if k1 in ("add", "add_r") and k2 in ("add", "add_r"):
            if e1[1][1] > e2[1][1]:
                return e1, None
            return None, e2
        if k1 in ("add", "add_r") and k2 == "ban":
            return None, e2
        if (k1, k2) == ("ban", "ban"):
            return None, e2
        raise ValueError(f"cannot compact {e1!r}, {e2!r}")

    def equal(self, a: LeaderboardState, b: LeaderboardState) -> bool:
        # Observable state only (leaderboard.erl:137-139).
        return a.observed == b.observed and a.size == b.size

    def to_binary(self, state: LeaderboardState) -> bytes:
        return serial.dumps_scalar(self.type_name, tuple(state))

    def from_binary(self, data: bytes) -> LeaderboardState:
        name, payload = serial.loads_scalar(data)
        assert name == self.type_name
        obs, masked, bans, min_, size = payload
        return LeaderboardState(obs, masked, frozenset(bans), tuple(min_), size)


registry.register(
    "leaderboard", scalar=LeaderboardScalar(), generates_extra_operations=True
)



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
    promotion_mask,
    table_addresses,
)


@dataclasses.dataclass
class LeaderboardDenseState:
    """Direct-indexed player table per (replica, instance): the best known
    score per player and a permanent ban mask; the observable top-K is
    derived, so the cross-replica merge is elementwise max / or."""

    best_score: torch.Tensor  # i32[R, NK, P]; NEG_INF = never seen
    banned: torch.Tensor  # bool[R, NK, P]


@dataclasses.dataclass
class LeaderboardOps:
    """Effect-op batch per replica. add_valid/ban_valid mask padding."""

    add_key: torch.Tensor  # i32[R, B]
    add_id: torch.Tensor  # i32[R, B]
    add_score: torch.Tensor  # i32[R, B]
    add_valid: torch.Tensor  # bool[R, B]
    ban_key: torch.Tensor  # i32[R, Bb]
    ban_id: torch.Tensor  # i32[R, Bb]
    ban_valid: torch.Tensor  # bool[R, Bb]


class LeaderboardDense:
    """Batched leaderboard over [n_replicas, n_keys] (port of the JAX
    ``LeaderboardDense``); P = player-id space, K = board size. A ban wins
    over any add (leaderboard.erl:21-27, :494-499). ``device``: where
    `init` puts states (default: the CUDA card; raises without one)."""

    type_name = "leaderboard"
    merge_kind = MergeKind.JOIN

    def __init__(self, n_players: int, size: int = 100, device: DeviceLike = None):
        self.P = n_players
        self.K = size
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int = 1) -> LeaderboardDenseState:
        shape = (n_replicas, n_keys, self.P)
        return LeaderboardDenseState(
            best_score=torch.full(shape, NEG_INF, dtype=torch.int32, device=self.device),
            banned=torch.zeros(shape, dtype=torch.bool, device=self.device),
        )

    def apply_ops(self, state: LeaderboardDenseState, ops: LeaderboardOps, collect_promotions: bool = False):
        old_obs = self.observe(state) if collect_promotions else None
        shape = tuple(state.best_score.shape)
        score = state.best_score.clone()
        rows, keep = table_addresses(shape, ops.add_key, ops.add_id, ops.add_valid)
        score.view(-1).scatter_reduce_(0, rows, ops.add_score.to(torch.int32)[keep], "amax")
        banned = state.banned.clone()
        rows, _ = table_addresses(shape, ops.ban_key, ops.ban_id, ops.ban_valid)
        banned.view(-1)[rows] = True
        new_state = LeaderboardDenseState(score, banned)
        promoted = None
        if collect_promotions:
            promoted = self._promotions(old_obs, self.observe(new_state), ops)
        return new_state, promoted

    def merge(self, a: LeaderboardDenseState, b: LeaderboardDenseState) -> LeaderboardDenseState:
        return LeaderboardDenseState(
            best_score=torch.maximum(a.best_score, b.best_score),
            banned=a.banned | b.banned,
        )

    def observe(self, state: LeaderboardDenseState):
        """(ids, scores, valid) of the top-K non-banned players, score desc
        with id-desc tiebreak (leaderboard cmp, :289-294)."""
        return masked_topk(torch.where(state.banned, NEG_INF, state.best_score), self.K)

    def value(self, state: LeaderboardDenseState):
        return observe_value(self.observe, state)

    def equal(self, a: LeaderboardDenseState, b: LeaderboardDenseState) -> bool:
        return observables_equal(self.observe(a), self.observe(b))

    def _promotions(self, old, new, ops: LeaderboardOps):
        """Entries of the new observable absent from both the old observable
        and this batch's adds to the same instance, i.e. uncovered by bans
        (leaderboard.erl:279-283); identity is (id, score)."""
        old_ids, old_scores, old_valid = old
        new_ids, new_scores, new_valid = new
        keep = promotion_mask(
            (new_ids, new_scores),
            new_valid,
            (old_ids, old_scores),
            old_valid,
            ops.add_key,
            (ops.add_id, ops.add_score),
            ops.add_valid,
        )
        return new_ids, new_scores, keep


def make_dense(n_players: int, size: int = 100, device: DeviceLike = None) -> LeaderboardDense:
    return LeaderboardDense(n_players=n_players, size=size, device=device)


registry.register("leaderboard", dense_factory=make_dense)
