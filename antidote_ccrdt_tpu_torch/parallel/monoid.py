"""MONOID → JOIN lift: the gossip plane for average + wordcount (port of
``antidote_ccrdt_tpu/parallel/monoid.py``).

Snapshot gossip re-merges peer states, and a monoid `+` double-counts on
re-merge. The classic counter-CRDT construction (the G-counter lift)
closes that: key each member's contribution and make anti-entropy
*replace* slices instead of adding them. Every MONOID leaf has a leading
``[n_replicas, ...]`` axis, and one replica row is one writer's
contribution accumulator, so:

* ``LiftedMonoidState`` = inner monoid state + ``ver: i32[R]``, a per-row
  count of the op batches that row's writer has applied;
* ``merge`` = per row, the side with the higher version (ties keep the
  left side). Under the single-writer-per-row contract this is a true
  join: idempotent, commutative and associative.

Contract: each row has ONE writer at a time, and a row's (version,
content) pair is write-once. That forbids applying ops onto a row copy
that arrived via gossip, so writers keep contributions and gossip in
separate states — `MonoidContributor` packages the discipline.

Deltas (`monoid_row_delta`) ship whole changed ROWS, self-contained: each
carries (row index, version, full row payload), and applying one replaces
any local row with a lower version — duplicated, reordered or dropped
deltas are all harmless.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.behaviour import MergeKind
from ..utils.tree import as_numpy, flatten_with_path, map_with_path, tree_map


@dataclasses.dataclass
class LiftedMonoidState:
    """A monoid dense state plus per-replica-row versions.

    ``ver[r]`` counts op batches applied to row r by its writer; the
    lifted join replaces whole rows by version.

    ``swept`` (static metadata, not a leaf — JAX's treedef carries it)
    marks states that have been through `merge`, i.e. that may contain
    rows adopted from gossip; `apply_ops` refuses them. Rebuilding the
    dataclass from its leaves alone resets it to False, so it catches the
    in-process misuse pattern, not adversarial laundering."""

    inner: Any
    ver: torch.Tensor  # i32[R]
    swept: bool = dataclasses.field(default=False, metadata=dict(static=True))


class MonoidLift:
    """JOIN-algebra adapter around a MONOID dense engine, with the dense
    engine surface (init/apply_ops/merge/observe)."""

    merge_kind = MergeKind.JOIN

    def __init__(self, inner: Any):
        kind = getattr(inner, "merge_kind", None)
        if kind != MergeKind.MONOID:
            raise ValueError(
                f"MonoidLift wraps MONOID engines; {type(inner).__name__} "
                f"has merge_kind {kind!r} (JOIN engines gossip directly)"
            )
        self.inner = inner
        self.type_name = f"{inner.type_name}_lifted"

    def init(self, n_replicas: int, n_keys: int = 1, **params: Any) -> LiftedMonoidState:
        return LiftedMonoidState(
            inner=self.inner.init(n_replicas, n_keys, **params),
            ver=torch.zeros((n_replicas,), dtype=torch.int32, device=self.inner.device),
        )

    def apply_ops(
        self, state: LiftedMonoidState, ops: Any,
        owned: Optional[Sequence[int]] = None,
        allow_swept: bool = False, **kw: Any,
    ) -> Tuple[LiftedMonoidState, Any]:
        """Apply one op batch and bump the version of the rows this member
        WRITES. `owned=None` bumps every row (single-process use, where
        the caller owns the whole grid); gossiping members MUST pass their
        owned rows.

        Raises on a state that has been through `merge` (``swept=True``):
        applying ops onto gossip-adopted rows double-counts batches under
        a legitimate version. `allow_swept=True` is the explicit escape
        hatch for callers that have re-established the write-once
        contract some other way."""
        if state.swept and not allow_swept:
            raise ValueError(
                "apply_ops on a merged (swept) LiftedMonoidState: its rows "
                "may have been adopted from gossip, and re-applying ops "
                "onto them double-counts under a legitimate version. Apply "
                "onto the writer's own contribution state "
                "(MonoidContributor), or pass allow_swept=True if the "
                "write-once contract is re-established."
            )
        new_inner, extras = self.inner.apply_ops(state.inner, ops, **kw)
        R = state.ver.shape[0]
        b = np.zeros((R,), np.int32)
        if owned is None:
            b[:] = 1
        else:
            b[np.asarray(sorted(owned), np.int64)] = 1
        bump = torch.from_numpy(b).to(state.ver.device)
        return LiftedMonoidState(new_inner, state.ver + bump, swept=state.swept), extras

    def merge(self, a: LiftedMonoidState, b: LiftedMonoidState) -> LiftedMonoidState:
        take_b = b.ver > a.ver  # ties keep a: same (ver, content) by contract

        def pick(x, y):
            return torch.where(take_b.view(take_b.shape + (1,) * (x.dim() - 1)), y, x)

        return LiftedMonoidState(
            inner=tree_map(pick, a.inner, b.inner),
            ver=torch.maximum(a.ver, b.ver),
            swept=True,
        )

    def observe(self, state: LiftedMonoidState) -> Any:
        return self.inner.observe(state.inner)

    def total(self, state: LiftedMonoidState) -> Any:
        """Global monoid value: fold every contribution row with the inner
        `+` — the read-side reconciliation (1 logical row out)."""
        from ..harness.dense_replay import fold_rows

        return fold_rows(self.inner, state.inner, range(state.ver.shape[0]))


class MonoidContributor:
    """The write/read discipline the lift's contract requires, packaged:

    * ``own`` — this member's contributions, built purely by `apply`;
      NEVER merged with remote rows.
    * ``peers`` — everything learned from gossip, merged freely.
    * ``view`` — ``peers ⊔ own``: what to publish, read, and checkpoint.

    The G-counter discipline (only increment your own entry; merge
    handles the rest), at row granularity."""

    def __init__(self, lift: MonoidLift, n_replicas: int, n_keys: int = 1):
        self.lift = lift
        self.own = lift.init(n_replicas, n_keys)
        self.peers = lift.init(n_replicas, n_keys)

    def apply(self, ops: Any, owned: Sequence[int], **kw: Any) -> Any:
        self.own, extras = self.lift.apply_ops(self.own, ops, owned=owned, **kw)
        return extras

    @property
    def view(self) -> LiftedMonoidState:
        return self.lift.merge(self.peers, self.own)

    def absorb(self, state: LiftedMonoidState) -> None:
        """Merge a swept/fetched state into the gossip side."""
        self.peers = self.lift.merge(self.peers, state)


# --- self-contained row-replace deltas ------------------------------------


def monoid_row_delta(
    lift: MonoidLift, prev: LiftedMonoidState, cur: LiftedMonoidState
) -> Dict[str, Any]:
    """Rows whose version advanced since `prev`, with FULL row payloads,
    keyed by JAX's leaf paths of the inner state (``.sum``, ``.counts``).
    The version is the authoritative change signal."""
    rows = np.nonzero(as_numpy(cur.ver) != as_numpy(prev.ver))[0].astype(np.int32)
    rj = torch.from_numpy(rows).to(cur.ver.device)
    at = rj.to(torch.int64)
    return {
        "rows": rj,
        "ver": cur.ver[at],
        "leaves": {p: leaf[at] for p, leaf in flatten_with_path(cur.inner)},
    }


def apply_monoid_row_delta(
    lift: MonoidLift, state: LiftedMonoidState, delta: Dict[str, Any]
) -> LiftedMonoidState:
    """Replace local rows that the delta carries at a HIGHER version.
    Host-side scatter, one copy back to each leaf's device."""
    rows = as_numpy(delta["rows"]).astype(np.int64)
    dver = as_numpy(delta["ver"])
    local_ver = as_numpy(state.ver).copy()
    take = dver > local_ver[rows]
    if not take.any():
        return state
    sel = rows[take]
    local_ver[sel] = dver[take]

    def replace(p, leaf):
        arr = as_numpy(leaf).copy()
        arr[sel] = as_numpy(delta["leaves"][p])[take]
        return torch.from_numpy(arr).to(leaf.device)

    return LiftedMonoidState(
        inner=map_with_path(replace, state.inner),
        ver=torch.from_numpy(local_ver.astype(np.int32)).to(state.ver.device),
        # Adopting peer rows via a delta is gossip adoption exactly like
        # merge(): the result must trip apply_ops' write-once guard too.
        swept=True,
    )


def like_monoid_delta(lift: MonoidLift, like_state: LiftedMonoidState) -> Dict[str, Any]:
    """Structure target for deserializing lifted deltas."""
    z = torch.zeros((0,), dtype=torch.int32, device=like_state.ver.device)
    return {
        "rows": z,
        "ver": z,
        "leaves": {p: z for p, _ in flatten_with_path(like_state.inner)},
    }


def monoid_delta_in_bounds(
    lift: MonoidLift, like_state: LiftedMonoidState, delta: Dict[str, Any]
) -> bool:
    """Config/bounds validation of a decoded peer delta."""
    R = int(like_state.ver.shape[0])
    rows = as_numpy(delta.get("rows", None))
    dver = as_numpy(delta.get("ver", None))
    if rows.ndim != 1 or not np.issubdtype(rows.dtype, np.integer):
        return False
    if not np.issubdtype(dver.dtype, np.integer):
        return False
    n = rows.size
    if dver.shape != (n,):
        return False
    if n and (rows.min() < 0 or rows.max() >= R):
        return False
    # Duplicate row indices would make apply's fancy assignment last-write-
    # wins: a crafted [ver 10, ver 3] pair for one row leaves the stale
    # ver-3 payload in place even though each entry passes the version
    # guard. Honest publishers never emit duplicates.
    if np.unique(rows).size != n:
        return False
    paths = {p: tuple(leaf.shape) for p, leaf in flatten_with_path(like_state.inner)}
    if set(delta.get("leaves", {})) != set(paths):
        return False
    for p, shape in paths.items():
        if tuple(as_numpy(delta["leaves"][p]).shape) != (n,) + shape[1:]:
            return False
    return True
