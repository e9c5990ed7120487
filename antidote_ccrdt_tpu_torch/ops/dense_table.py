"""Shared helpers for direct-indexed dense score tables (port of
``antidote_ccrdt_tpu/ops/dense_table.py``).

A per-id best-score table [R, NK, P] whose observable is the masked
top-K: score desc, id desc tiebreak (topk.erl:83, leaderboard.erl:289-294).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

# Safe "minus infinity" score sentinel: negatable in int32 (the JAX
# package's value, dense_table.py:20).
NEG_INF = -(2**31 - 1)

_I32_MIN = -(2**31)


def scatter_max_rows(table: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """``table[r].at[rows[r]].max(upd[r])`` for every replica r, as a new
    table: the contract of ``scatter_max_rows_mxu`` with the replica axis
    written out.

    table i32[R, T, D] >= 0 (the JAX function leaves untouched cells at
    max(table, 0); reachable tombstone tables are >= 0, where the two
    agree), rows i32[R, B] (rows outside [0, T) are dropped, duplicates
    allowed), upd i32[R, B, D] >= 0. The input table is not modified: the
    caller's state is immutable and may be a broadcast view. On a card
    this is one launch of K1c (``ops.kernels.scatter_max_rows_copy``),
    which reads a broadcast view in place and writes a new table; on the
    CPU a contiguous copy and K1's plain version."""
    from .kernels import scatter_max_rows_copy

    return scatter_max_rows_copy(table, rows, upd)


def dedup_rows_run_max(rows: torch.Tensor, upd: torch.Tensor, n_rows: int):
    """Collapse duplicate scatter rows to run heads carrying the run max.

    Sort updates by row (stably); a suffix run-max gives every element
    the max of its run from itself on, so each run's first element holds
    the run's per-column total; only that head keeps its row index (the
    rest point at the `n_rows` sentinel, which no consumer matches).

    rows [Br] i32, upd [Br, D] i32 >= 0. Returns (head_rows [Br],
    total [Br, D]). K1 needs no such prepass (integer ``atomicMax``
    commutes); this is the JAX prepass's contract, kept for callers that
    want one update per row."""
    from .segment import run_max

    order = torch.sort(rows, stable=True).indices
    r_s = rows[order]
    total = run_max(upd[order], r_s, direction="suffix")
    is_head = torch.ones_like(r_s, dtype=torch.bool)
    is_head[1:] = r_s[1:] != r_s[:-1]
    head_rows = torch.where(is_head, r_s, torch.full_like(r_s, n_rows))
    return head_rows, total


def table_addresses(shape, key: torch.Tensor, id_: torch.Tensor, valid: torch.Tensor):
    """Flat addresses into a [R, NK, P] table of the [R, B] ops that land
    in it, and the [R, B] mask of those ops, as the JAX package's
    ``table.at[key, id].op(..., mode="drop")`` per replica: an index in
    [-n, 0) wraps to index + n (jnp indexing normalises it) and one
    outside [-n, n) drops the op, as does ``valid`` False."""
    R, NK, P = shape

    def wrap(idx, n):
        idx = idx.to(torch.int64)
        return torch.where(idx < 0, idx + n, idx), (idx >= -n) & (idx < n)

    k, k_in = wrap(key, NK)
    i, i_in = wrap(id_, P)
    keep = valid & k_in & i_in
    r = torch.arange(R, device=k.device)[:, None]
    return ((r * NK + k) * P + i)[keep], keep


def wrapping_add(table: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """A new table: `table` with `vals` added at the flat addresses `flat`
    (duplicates accumulate). An integer table wraps in its own dtype, as
    JAX's ``.at[].add`` does; addition modulo 2^32 is exact in any order."""
    return table.reshape(-1).index_add(0, flat, vals.to(table.dtype)).view(table.shape)


def neg_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 negation with two's-complement wrap (-INT32_MIN == INT32_MIN,
    as in XLA), widened to int64 for key packing."""
    n = -x.to(torch.int64)
    return torch.where(n == 2**31, torch.full_like(n, _I32_MIN), n)


def masked_topk(scores: torch.Tensor, k: int):
    """(ids, scores, valid) of the top-k entries of a [..., P] score table;
    NEG_INF marks absent entries. Order: ascending (-score, -id) with the
    negation in int32, exactly JAX's 2-key sort: score desc, id desc, and
    an INT32_MIN score (whose negation wraps to itself) first.

    The JAX function selects hierarchically by chunks; its result is the
    exact top-min(k, P) of that order, which one `topk` over packed int64
    keys (unique, since ids are) gives here."""
    P = scores.shape[-1]
    kf = min(k, P)
    ids = torch.arange(P, device=scores.device, dtype=torch.int64)
    key = neg_i32(scores) * 2**32 + (2**31 - ids)
    _, idx = torch.topk(key, kf, dim=-1, largest=False, sorted=True)
    top = torch.gather(scores, -1, idx)
    ids_out = idx.to(torch.int32)
    return ids_out, top, (top > NEG_INF) & (ids_out >= 0)


def observe_value(observe_fn: Callable, state) -> List[List[List[Tuple[int, int]]]]:
    """Materialize an (ids, scores, valid) observable to host as nested
    [(id, score)] lists per (replica, instance) — the value/1 shape."""
    ids, scores, valid = (x.cpu() for x in observe_fn(state))
    R, NK, K = ids.shape
    ids, scores, valid = ids.tolist(), scores.tolist(), valid.tolist()
    return [
        [
            [(ids[r][nk][j], scores[r][nk][j]) for j in range(K) if valid[r][nk][j]]
            for nk in range(NK)
        ]
        for r in range(R)
    ]


def _all_eq(pairs) -> torch.Tensor:
    acc = None
    for n, o in pairs:
        eq = n == o
        acc = eq if acc is None else (acc & eq)
    return acc


def promotion_mask(
    new_cols: Sequence[torch.Tensor],
    new_valid: torch.Tensor,
    old_cols: Sequence[torch.Tensor],
    old_valid: torch.Tensor,
    batch_key: torch.Tensor,
    batch_cols: Sequence[torch.Tensor],
    batch_valid: torch.Tensor,
) -> torch.Tensor:
    """Which entries of a new observable were *uncovered* (promoted) rather
    than carried over or freshly added (topk_rmv :291-295).

    `new_cols`/`old_cols` are [R, NK, K] observables, `batch_cols` are
    [R, B] add columns matched only against adds targeting the same
    instance (`batch_key == nk`). Returns the promoted mask [R, NK, K]."""
    in_old = (
        _all_eq((n[..., :, None], o[..., None, :]) for n, o in zip(new_cols, old_cols))
        & old_valid[..., None, :]
    ).any(-1)
    NK = new_valid.shape[1]
    nk = torch.arange(NK, device=new_valid.device, dtype=batch_key.dtype)[None, :, None, None]
    in_batch = (
        _all_eq((n[..., :, None], b[:, None, None, :]) for n, b in zip(new_cols, batch_cols))
        & (batch_key[:, None, None, :] == nk)
        & batch_valid[:, None, None, :]
    ).any(-1)
    return new_valid & ~in_old & ~in_batch


def observables_equal(a_obs, b_obs) -> bool:
    """Observable-state equality on (ids, scores, valid) triples."""
    ia, sa, va = a_obs
    ib, sb, vb = b_obs
    return bool(
        ((va == vb) & torch.where(va, ia == ib, True) & torch.where(va, sa == sb, True)).all()
    )
