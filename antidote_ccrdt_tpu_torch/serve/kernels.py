"""Per-type batched query kernels: one dispatch materializes every key.

A snapshot answers three query shapes —

    value   the type's full observable for one key
    topk    the first k entries of a ranked observable
    range   entries whose score falls in [lo, hi] (leaderboard windows)

— and the kernel strategy is the same for every engine: fold the
snapshot's replica rows to the single read-side row with the engine's
own merge lattice (log2(R) batched dispatches through
`harness.dense_replay.fold_rows`; `MonoidLift.total` for lifted MONOID
engines, whose read-side reconciliation is the + fold, not the
version-pick join), run the engine's `observe` ONCE over the
whole key axis, and pull the result to the host. That single
materialization answers arbitrarily many queries: per-query work is a
numpy gather over the key axis, and a batch of identical hot queries
collapses to one gather (`answer` memoizes within the batch; the
cross-batch memo is `serve.cache.HotKeyCache`).

Bit-identity contract (tests/test_serve_staleness.py): the "value"
answer for key k equals the engine's own `value()` of the folded
snapshot at that key — for score-table engines (`topk_rmv`, `topk`,
`leaderboard`) it IS `dense.value(folded)[0][k]` reshaped to JSON
(tuples become 2-lists), for scalar observables (lifted average) the
observed float, for vocab tables (lifted wordcount) the nonzero
(token_index, count) pairs in index order.

Port of ``antidote_ccrdt_tpu/serve/kernels.py``: the same views and
answers. `materialize` folds and observes on the device of the state it
is given (on a card the fold's joins are the engine's K3 launches, the
observe its ``masked_topk``) and pulls the observable with
``.cpu().numpy()``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import devprof, profile


class SnapshotView:
    """Host-side materialization of one snapshot: everything query
    answering needs, in numpy. `mode` picks the per-type answer shape:

      table    per-key ranked [(id, score), ...] lists (JOIN score tables)
      scalar   one number per key (lifted average)
      vocab    a [NK, V] count table (lifted wordcount)
    """

    __slots__ = ("mode", "table", "arr", "n_keys")

    def __init__(self, mode: str, table=None, arr=None, n_keys: int = 0):
        self.mode = mode
        self.table = table  # mode "table": list of per-key [(id, score)] lists
        self.arr = arr      # mode "scalar"/"vocab": np.ndarray [NK] / [NK, V]
        self.n_keys = int(n_keys)


def materialize(dense: Any, state: Any) -> SnapshotView:
    """Fold replica rows, observe once, pull to host — the one device
    round-trip a snapshot ever pays, regardless of query volume."""
    from ..harness.dense_replay import fold_rows
    from ..utils.tree import leaves

    if hasattr(dense, "total"):
        # MonoidLift: the read-side reconciliation is the inner + fold
        # (the lifted join would version-pick rows, which is the GOSSIP
        # lattice, not the read value).
        folded = dense.total(state)
        eng = dense.inner
    else:
        rows = int(leaves(state)[0].shape[0])
        folded = fold_rows(dense, state, range(rows)) if rows > 1 else state
        eng = dense

    if hasattr(eng, "value"):
        # Score-table engines: value() is the reference observable —
        # per-key ranked (id, score) lists, already host-materialized.
        # The device dispatch inside is the engine's observe.
        if profile.ACTIVE or devprof.ACTIVE:
            with profile.dispatch(
                "serve.materialize",
                fn=getattr(eng, "observe", None),
                operands=(folded,),
            ):
                table = eng.value(folded)[0]
        else:
            table = eng.value(folded)[0]
        return SnapshotView("table", table=table, n_keys=len(table))

    if profile.ACTIVE or devprof.ACTIVE:
        with profile.dispatch(
            "serve.materialize",
            fn=getattr(eng, "observe", None),
            operands=(folded,),
        ):
            obs = eng.observe(folded)
    else:
        obs = eng.observe(folded)
    obs = obs.cpu().numpy()[0]  # drop row axis
    if obs.ndim <= 1:
        arr = obs.reshape(-1)
        return SnapshotView("scalar", arr=arr, n_keys=arr.shape[0])
    return SnapshotView("vocab", arr=obs, n_keys=obs.shape[0])


def query_key(q: Dict[str, Any]) -> Tuple:
    """Canonical identity of one query — the batch-memo and hot-key
    cache key. Unknown fields are deliberately excluded: two requests
    asking the same question share one computed answer."""
    return (
        str(q.get("op", "value")),
        int(q.get("key", 0)),
        None if q.get("k") is None else int(q["k"]),
        None if q.get("lo") is None else int(q["lo"]),
        None if q.get("hi") is None else int(q["hi"]),
    )


def _pairs(entries) -> List[List[int]]:
    return [[int(i), int(s)] for i, s in entries]


def answer_one(view: SnapshotView, q: Dict[str, Any]) -> Any:
    """One query against one materialized view. Returns the JSON-shaped
    value, or raises ValueError for a malformed query (the plane turns
    that into a per-result error, never a dropped batch)."""
    op, key, k, lo, hi = query_key(q)
    if not (0 <= key < view.n_keys):
        raise ValueError(f"key {key} out of range [0, {view.n_keys})")
    if view.mode == "table":
        row = view.table[key]
        if op == "value":
            return _pairs(row)
        if op == "topk":
            return _pairs(row[: (len(row) if k is None else max(0, k))])
        if op == "range":
            lo_v = -math.inf if lo is None else lo
            hi_v = math.inf if hi is None else hi
            return _pairs(p for p in row if lo_v <= p[1] <= hi_v)
        raise ValueError(f"unknown op {op!r}")
    if view.mode == "scalar":
        if op != "value":
            raise ValueError(f"op {op!r} unsupported for scalar observables")
        return float(view.arr[key])
    # vocab: [V] counts for this key; entries are (token_index, count).
    counts = view.arr[key]
    nz = np.flatnonzero(counts)
    if op == "value":
        return [[int(v), int(counts[v])] for v in nz]
    if op == "topk":
        ranked = sorted(nz, key=lambda v: (-int(counts[v]), int(v)))
        return [[int(v), int(counts[v])] for v in ranked[: (len(ranked) if k is None else max(0, k))]]
    if op == "range":
        lo_v = -math.inf if lo is None else lo
        hi_v = math.inf if hi is None else hi
        return [[int(v), int(counts[v])] for v in nz if lo_v <= int(counts[v]) <= hi_v]
    raise ValueError(f"unknown op {op!r}")


def answer(view: SnapshotView, queries: List[Dict[str, Any]]) -> List[Any]:
    """Answer a batch against one view, memoizing identical queries —
    a thousand requests for the same hot leaderboard cost one gather."""
    memo: Dict[Tuple, Any] = {}
    out: List[Any] = []
    for q in queries:
        kq = query_key(q)
        if kq not in memo:
            memo[kq] = answer_one(view, q)
        out.append(memo[kq])
    return out
