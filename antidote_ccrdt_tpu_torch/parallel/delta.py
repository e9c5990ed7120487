"""Delta-state replication for dense lattice states (port of
``antidote_ccrdt_tpu/parallel/delta.py``).

Delta-CRDT lineage ("Big(ger) Sets: decomposed delta CRDT Sets in Riak",
PAPERS.md): instead of shipping the whole lattice state on every
anti-entropy round, ship the *join-decomposed delta* — the state
restricted to the rows whose content changed since the last publish.

Why this is safe with NO special delta-merge kernel: empty rows are the
join identity for every leaf (slots NEG_INF/0, tombstones 0, vc 0, lossy
False), so `expand` lifts a delta back to a full-shape state and the
ordinary engine join applies it. Chaining is the one obligation: a
receiver may apply member M's delta seq k only if it has applied M's full
state or deltas through seq k-1.

The changed-row mask is computed on the state's device; the row gather
and the expansion run on the host in numpy, as in JAX (the delta is
serialized to bytes right after, and its row count differs on every
publish). Table deltas are dicts keyed by JAX's leaf path strings
(``.counts``), so a delta cut by one package applies in the other.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.tree import as_numpy, flatten_with_path, leaves, map_with_path


@dataclasses.dataclass
class TopkRmvDelta:
    """State restricted to changed (replica, key, id) rows.

    `rows` are flat indices into the [R*NK*I] row space; slot/tombstone
    payloads ride per changed row; the small dense leaves (vc, lossy)
    ship whole — they are O(R*NK*D), not O(I)."""

    rows: torch.Tensor  # i32[n] flat (r*NK + k)*I + id
    slot_score: torch.Tensor  # i32[n, M]
    slot_dc: torch.Tensor  # i32[n, M]
    slot_ts: torch.Tensor  # i32[n, M]
    rmv_vc: torch.Tensor  # i32[n, D]
    vc: torch.Tensor  # i32[R, NK, D]
    lossy: torch.Tensor  # bool[R, NK]


def _changed_mask(prev: Any, cur: Any) -> torch.Tensor:
    """bool [R, NK, I]: rows whose join inputs differ."""
    return (
        (cur.slot_score != prev.slot_score).any(-1)
        | (cur.slot_dc != prev.slot_dc).any(-1)
        | (cur.slot_ts != prev.slot_ts).any(-1)
        | (cur.rmv_vc != prev.rmv_vc).any(-1)
    )


def state_delta(dense: Any, prev: Any, cur: Any) -> TopkRmvDelta:
    """Rows of `cur` that differ from `prev` (plus the whole small
    leaves). The row leaves land on the device of `cur`."""
    R, NK, I, M = cur.slot_score.shape
    D = cur.rmv_vc.shape[-1]
    dev = cur.slot_score.device
    mask = as_numpy(_changed_mask(prev, cur)).reshape(-1)
    rows = np.nonzero(mask)[0].astype(np.int32)

    def pick(x, w):
        return torch.from_numpy(np.ascontiguousarray(as_numpy(x).reshape(R * NK * I, w)[rows])).to(dev)

    return TopkRmvDelta(
        rows=torch.from_numpy(rows).to(dev),
        slot_score=pick(cur.slot_score, M),
        slot_dc=pick(cur.slot_dc, M),
        slot_ts=pick(cur.slot_ts, M),
        rmv_vc=pick(cur.rmv_vc, D),
        vc=cur.vc,
        lossy=cur.lossy,
    )


def expand_delta(dense: Any, delta: TopkRmvDelta) -> Any:
    """Lift a delta to a full-shape state on the engine's device whose
    untouched rows are the join identity, so `dense.merge(state,
    expand_delta(...))` applies it. Host-side scatter into identity
    arrays (numpy), then one copy to the device."""
    from ..models.topk_rmv_dense import TopkRmvDenseState
    from ..ops.dense_table import NEG_INF

    R, NK, D = delta.vc.shape
    I, M = dense.I, dense.M
    rows = as_numpy(delta.rows).astype(np.int64)
    score = np.full((R * NK * I, M), NEG_INF, np.int32)
    dc = np.zeros((R * NK * I, M), np.int32)
    ts = np.zeros((R * NK * I, M), np.int32)
    rvc = np.zeros((R * NK * I, D), np.int32)
    score[rows] = as_numpy(delta.slot_score)
    dc[rows] = as_numpy(delta.slot_dc)
    ts[rows] = as_numpy(delta.slot_ts)
    rvc[rows] = as_numpy(delta.rmv_vc)

    def put(a, shape):
        return torch.from_numpy(a.reshape(shape)).to(dense.device)

    shape4 = (R, NK, I, M)
    return TopkRmvDenseState(
        slot_score=put(score, shape4),
        slot_dc=put(dc, shape4),
        slot_ts=put(ts, shape4),
        rmv_vc=put(rvc, (R, NK, I, D)),
        vc=torch.as_tensor(as_numpy(delta.vc)).to(dense.device),
        lossy=torch.as_tensor(as_numpy(delta.lossy)).to(dense.device),
    )


def empty_delta(dense: Any) -> TopkRmvDelta:
    """A shape-valid zero-row delta: the `like` structure for
    deserialization (loads_dense checks structure, not shapes)."""

    def z(*s):
        return torch.zeros(s, dtype=torch.int32, device=dense.device)

    return TopkRmvDelta(
        rows=z(0), slot_score=z(0, dense.M), slot_dc=z(0, dense.M),
        slot_ts=z(0, dense.M), rmv_vc=z(0, dense.D),
        vc=z(1, 1, dense.D), lossy=torch.zeros((1, 1), dtype=torch.bool, device=dense.device),
    )


def delta_nbytes(delta: Any) -> int:
    return sum(as_numpy(leaf).nbytes for leaf in leaves(delta))


def apply_delta(dense: Any, state: Any, delta: TopkRmvDelta) -> Any:
    """Join a delta into `state` (receiver side)."""
    return dense.merge(state, expand_delta(dense, delta))


# --- generic entrywise deltas (topk / leaderboard / wordcount / average) ---


def _split_leaves(state: Any):
    """(paths, leaves, table_paths): table leaves are the [R, NK, P] score/
    count/ban planes (3-D); everything else (lost counters, flags) ships
    whole — they are O(R*NK), not O(P)."""
    flat = flatten_with_path(state)
    paths = [p for p, _ in flat]
    vals = [leaf for _, leaf in flat]
    table = [p for p, leaf in flat if leaf.dim() == 3]
    return paths, vals, table


def _int_dtype(dtype: torch.dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex and dtype != torch.bool


def table_delta(dense: Any, prev: Any, cur: Any) -> dict:
    """Entrywise delta for the table-shaped dense states (topk,
    leaderboard, wordcount, average): every 3-D leaf shares the [R, NK, P]
    plane, a changed-entry index selects the shipped cells.

    Payload semantics follow the engine's merge algebra: JOIN types ship
    the new VALUES (applied via the idempotent join), MONOID types ship
    the numeric DIFFERENCE since the last publish (applied via `+`). The
    delta is a plain dict, keyed by JAX's leaf paths."""
    from ..core.behaviour import MergeKind

    monoid = dense.merge_kind == MergeKind.MONOID
    paths, prevs, table_paths = _split_leaves(prev)
    _, curs, _ = _split_leaves(cur)
    by_path = dict(zip(paths, zip(prevs, curs)))
    dev = curs[0].device

    changed = None
    for p in table_paths:
        pv, cv = by_path[p]
        c = cv != pv
        changed = c if changed is None else (changed | c)
    if changed is None:
        # No O(P) table planes (average: the whole state is O(R*NK)) —
        # everything ships as a "whole" leaf and the index is empty.
        idx = torch.zeros((0,), dtype=torch.int32, device=dev)
    else:
        mask = as_numpy(changed).reshape(-1)
        idx = torch.from_numpy(np.nonzero(mask)[0].astype(np.int32)).to(dev)

    out: dict = {"idx": idx, "table": {}, "whole": {}}
    at = idx.to(torch.int64)
    for p in paths:
        pv, cv = by_path[p]
        if p in table_paths:
            vals = cv.reshape(-1)[at]
            if monoid:
                vals = vals - pv.reshape(-1)[at]
            out["table"][p] = vals
        else:
            out["whole"][p] = (cv - pv) if (monoid and _int_dtype(cv.dtype)) else cv
    return out


def expand_table_delta(dense: Any, like: Any, delta: dict) -> Any:
    """Lift an entrywise delta onto the identity state (`dense.init` IS
    the join bottom / monoid zero for every type), so `dense.merge`
    applies it — the same move as `expand_delta`, type-agnostically."""
    R, NK = leaves(like)[0].shape[:2]
    ident = dense.init(R, NK)
    _, _, table_paths = _split_leaves(ident)
    idx = as_numpy(delta["idx"]).astype(np.int64)

    def rebuild(p, leaf):
        if p in table_paths:
            flat = as_numpy(leaf).reshape(-1).copy()
            flat[idx] = as_numpy(delta["table"][p])
            return torch.from_numpy(flat.reshape(tuple(leaf.shape))).to(leaf.device)
        return torch.as_tensor(as_numpy(delta["whole"][p])).to(leaf.device)

    return map_with_path(rebuild, ident)


def apply_table_delta(dense: Any, state: Any, delta: dict) -> Any:
    return dense.merge(state, expand_table_delta(dense, state, delta))


# --- engine-generic dispatch (used by the gossip tier) --------------------


def _is_topk_rmv_state(state: Any) -> bool:
    from ..models.topk_rmv_dense import TopkRmvDenseState

    return isinstance(state, TopkRmvDenseState)


def _is_lifted(state: Any) -> bool:
    from .monoid import LiftedMonoidState

    return isinstance(state, LiftedMonoidState)


def _is_monoid_row_delta(delta: Any) -> bool:
    return isinstance(delta, dict) and "ver" in delta and "leaves" in delta


def make_delta(dense: Any, prev: Any, cur: Any) -> Any:
    """Engine-generic delta: slot-level for topk_rmv states, row-replace
    for lifted monoid states, entrywise for the flat table engines."""
    if _is_topk_rmv_state(cur):
        return state_delta(dense, prev, cur)
    if _is_lifted(cur):
        from .monoid import monoid_row_delta

        return monoid_row_delta(dense, prev, cur)
    return table_delta(dense, prev, cur)


def apply_any_delta(dense: Any, state: Any, delta: Any) -> Any:
    if isinstance(delta, TopkRmvDelta):
        return apply_delta(dense, state, delta)
    if _is_monoid_row_delta(delta):
        from .monoid import apply_monoid_row_delta

        return apply_monoid_row_delta(dense, state, delta)
    return apply_table_delta(dense, state, delta)


def like_delta_for(dense: Any, like_state: Any) -> Any:
    """Structure target for deserializing this engine's deltas (shapes are
    free; loads_dense checks structure only)."""
    if _is_topk_rmv_state(like_state):
        return empty_delta(dense)
    if _is_lifted(like_state):
        from .monoid import like_monoid_delta

        return like_monoid_delta(dense, like_state)
    paths, vals, table_paths = _split_leaves(like_state)
    z = torch.zeros((0,), dtype=torch.int32, device=vals[0].device)
    return {
        "idx": z,
        "table": {p: z for p in table_paths},
        "whole": {p: leaf for p, leaf in zip(paths, vals) if p not in table_paths},
    }


def delta_in_bounds(dense: Any, like_state: Any, delta: Any) -> bool:
    """Config/bounds validation of a decoded peer delta (the gossip fetch
    guard: a structure-compatible delta from a differently-configured peer
    must be rejected before expansion indexes out of range)."""
    if _is_lifted(like_state):
        from .monoid import monoid_delta_in_bounds

        return _is_monoid_row_delta(delta) and monoid_delta_in_bounds(dense, like_state, delta)
    R, NK = leaves(like_state)[0].shape[:2]
    if isinstance(delta, TopkRmvDelta):
        n_rows = R * NK * dense.I
        n = int(delta.rows.shape[0]) if delta.rows.dim() == 1 else -1
        # Full-shape checks, leading dims included: a structure-compatible
        # delta from a peer with different R/NK would otherwise slip
        # through and broadcast its rows into every local replica.
        if (
            n < 0
            or tuple(delta.slot_score.shape) != (n, dense.M)
            or tuple(delta.slot_dc.shape) != (n, dense.M)
            or tuple(delta.slot_ts.shape) != (n, dense.M)
            or tuple(delta.rmv_vc.shape) != (n, dense.D)
            or tuple(delta.vc.shape) != (R, NK, dense.D)
            or tuple(delta.lossy.shape) != (R, NK)
        ):
            return False
        rows = as_numpy(delta.rows)
        return bool(rows.size == 0 or (rows.min() >= 0 and rows.max() < n_rows))
    paths, vals, table_paths = _split_leaves(like_state)
    shapes = {p: tuple(leaf.shape) for p, leaf in zip(paths, vals)}
    n_entries = {p: int(np.prod(shapes[p])) for p in table_paths}
    if set(delta.get("table", {})) != set(table_paths):
        return False
    idx = as_numpy(delta["idx"])
    if idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer):
        return False
    if idx.size and (idx.min() < 0 or idx.max() >= min(n_entries.values())):
        return False
    # Each table payload must carry exactly one (scalar) value per index.
    for p in table_paths:
        if tuple(as_numpy(delta["table"][p]).shape) != (idx.size,):
            return False
    for p, whole in delta.get("whole", {}).items():
        if p not in shapes or tuple(as_numpy(whole).shape) != shapes[p]:
            return False
    return True
