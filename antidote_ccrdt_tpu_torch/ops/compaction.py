"""Batched op-log compaction: one vectorized pass over the whole log (port
of ``antidote_ccrdt_tpu/ops/compaction.py``).

The reference compacts op logs *pairwise*: the host walks the log calling
``can_compact/2`` then ``compact_ops/2`` on adjacent pairs, with ``{noop}``
marking dead slots (richest rules in ``antidote_ccrdt_topk_rmv.erl:178-223``).
Here the *entire log* compacts in one pass: sort ops by (key, id),
reduce within each group, rewrite tags, compress. Semantics, as in JAX:

* **topk_rmv** (``topk_rmv.erl:197-223``): per (key, id), every removal
  fuses into ONE rmv with the vc join of all of them (tagged ``rmv`` if
  any input was untagged); adds dominated by the fused tombstone
  (``vc[dc] >= ts``, :182-187) and exact duplicate adds (:255-259) are
  deleted; surviving adds keep the best ``m_keep`` per id by (score desc,
  ts desc), the winner observable iff any live add of the group was
  untagged, the rest demoted to ``add_r`` (:198-202).
* **average** (``average.erl:127``): all adds per key fuse into one
  ``(sum, n)``.
* **topk**: adds per (key, id) keep the max score (quirk #4's fix).
* **leaderboard**: per player, the best add survives unless the log also
  bans the player; bans dedupe (``leaderboard.erl:163-205``).
* **wordcount/worddocumentcount**: counts fuse per (key, token) (quirk
  #3's fix).

Each log kernel takes columns [..., L] (a leading replica axis rides
along where JAX vmaps) and returns the JAX kernel's result bit for bit:
dead/padding rows last, ``n_live`` the compacted length (int32). JAX's
multi-key ``lax.sort`` (stable) is a chain of stable torch sorts over
exactly packed int64 key words, least significant first; negated keys
wrap at INT32_MIN as in int32 (``dense_table.neg_i32``).

The second half fuses K chained gossip deltas into one
(``coalesce_deltas``), host-side numpy as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.tree import as_numpy
from .dense_table import neg_i32
from .kernels import dom_lookup
from .segment import prefix_rank, run_max, segment_starts

# Op kinds for the dense topk_rmv log. DEAD marks padding on input and
# deleted slots on output (the reference's {noop}).
KIND_ADD = 0
KIND_ADD_R = 1
KIND_RMV = 2
KIND_RMV_R = 3
KIND_DEAD = 4

_BIG = 2**31 - 1
I32 = torch.int32
I64 = torch.int64


@dataclasses.dataclass
class TopkRmvLog:
    """A dense effect-op log for topk_rmv instances on a [n_keys] grid.

    Row i is one effect op; ``kind == KIND_DEAD`` marks padding. ``vc`` is
    only meaningful for rmv rows (zeros otherwise); score/dc/ts only for
    adds. Columns are [..., L], vc [..., L, D]."""

    kind: torch.Tensor  # i32[L]
    key: torch.Tensor  # i32[L] instance index
    id: torch.Tensor  # i32[L] element id
    score: torch.Tensor  # i32[L]
    dc: torch.Tensor  # i32[L]
    ts: torch.Tensor  # i32[L]
    vc: torch.Tensor  # i32[L, D]


# --- sorting helpers --------------------------------------------------------


def _pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32-range keys packed exactly into one int64 word that sorts
    as (hi, lo) lexicographically."""
    return hi.to(I64) * 2**32 + (lo.to(I64) + 2**31)


def _lex_order(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting [..., L] rows by int64 `words`, most
    significant first: one stable sort per word, the last word first."""
    perm = None
    for w in reversed(words):
        if perm is None:
            perm = torch.sort(w, dim=-1, stable=True).indices
        else:
            p = torch.sort(torch.gather(w, -1, perm), dim=-1, stable=True).indices
            perm = torch.gather(perm, -1, p)
    return perm


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x[..., order] for columns [..., L]; rows of [..., L, D] tables."""
    if x.dim() == order.dim():
        return torch.gather(x, -1, order)
    L, D = x.shape[-2:]
    n = order.numel() // order.shape[-1]
    off = torch.arange(0, n * L, L, device=x.device, dtype=I64).view(order.shape[:-1] + (1,))
    rows = x.reshape(n * L, D).index_select(0, (order + off).reshape(-1))
    return rows.view(order.shape + (D,))


def _live_first(live: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(~live, stable=True)``: live rows first, each class in
    its order (an int8 copy of the mask is sorted, not the bools)."""
    return torch.sort((~live).to(torch.int8), dim=-1, stable=True).indices


def _compress(live: torch.Tensor, rows: Tuple[torch.Tensor, ...]):
    """Stable-partition live rows to the front. Returns (rows', n_live)."""
    order = _live_first(live)
    return tuple(_take(r, order) for r in rows), live.sum(-1, dtype=I32)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Per-row sum over the row's segment (dense ids [..., L]), wrapping
    in the dtype of `vals` as JAX's int32 ``segment_sum`` does."""
    L = seg.shape[-1]
    n = seg.numel()
    if n == 0:
        return vals.clone()
    off = torch.arange(0, n, L, device=seg.device, dtype=I64).view(seg.shape[:-1] + (1,))
    gseg = (seg.to(I64) + off).reshape(n)
    acc = torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, gseg, vals.reshape(n))
    return acc.index_select(0, gseg).view(vals.shape)


def _where(cond: torch.Tensor, a, b) -> torch.Tensor:
    """int32 ``jnp.where`` (torch promotes two Python ints to int64)."""
    return torch.where(cond, a, b).to(I32)


# --- the log kernels --------------------------------------------------------


def _compact_topk_rmv_sorted(log: TopkRmvLog, m_keep: int):
    """Shared core of the whole-log compaction: sort + group rules, WITHOUT
    the final compress. Returns the group-sorted field columns, the
    per-row fused vc for kept rmvs, and the live/kind masks — so each
    caller compacts into its own output shape with one partition.

    The vc rows are gathered once by the sort permutation (the largest
    memory term: [..., L, D]); the group's vc join is a per-segment
    max (``run_max``)."""
    kind = log.kind
    is_add = (kind == KIND_ADD) | (kind == KIND_ADD_R)
    is_rmv = (kind == KIND_RMV) | (kind == KIND_RMV_R)
    dead = ~(is_add | is_rmv)

    # Sort: dead rows last; within a (key, id) group rmvs first, then adds
    # by cmp order desc (score, then ts — topk_rmv.erl:390-395). Non-add
    # rows sort with sanitized score/ts/dc, so a group's rmvs land at the
    # group FRONT ordered by kind: the group's first row is a complete
    # has-rmv / observable-rmv summary. Keys: (key, id, is_add, -score,
    # -ts, dc, kind), the negations wrapping in int32.
    skey = _where(dead, _BIG, log.key)
    sid = _where(dead, _BIG, log.id)
    zero = torch.zeros_like(kind, dtype=I64)
    sdc = _where(is_add, log.dc, 0)
    perm = _lex_order([
        _pair(skey, sid),
        is_add.to(I64),
        _pair(torch.where(is_add, neg_i32(log.score), zero), torch.where(is_add, neg_i32(log.ts), zero)),
        _pair(sdc, kind),
    ])
    key_s, id_s, kind_s = _take(skey, perm), _take(sid, perm), _take(kind, perm)
    score_s, ts_s, dc_s = _take(log.score, perm), _take(log.ts, perm), _take(sdc, perm)
    is_add_s = (kind_s == KIND_ADD) | (kind_s == KIND_ADD_R)
    is_rmv_s = (kind_s == KIND_RMV) | (kind_s == KIND_RMV_R)
    vc_s = _take(log.vc, perm).masked_fill_(~is_rmv_s[..., None], 0)

    first, start, seg = segment_starts(key_s, id_s)
    start64 = start.to(I64)

    # Fused tombstone per (key, id): vc join over the group's rmv rows
    # (merge_vcs, topk_rmv.erl:378-386), at every row of the group.
    merged_vc = run_max(vc_s, seg)
    del vc_s
    group_has_rmv = torch.gather(is_rmv_s, -1, start64)
    group_rmv_observable = torch.gather(kind_s, -1, start64) == KIND_RMV

    # Keep ONE rmv per group (the first), carrying the fused vc.
    keep_rmv = is_rmv_s & (prefix_rank(is_rmv_s, start) == 0)

    # Adds: delete tombstone-dominated ones (vc[dc] >= ts, :182-187) and
    # exact duplicates (adjacent after the sort, :255-259). The dc lookup
    # is max(vc[dc], 0), 0 for dc outside [0, D): JAX's one-hot reduce.
    dom = dom_lookup(dc_s[..., None], merged_vc)[..., 0] >= ts_s
    out_vc = merged_vc.masked_fill_(~keep_rmv[..., None], 0)

    def roll(x):
        return torch.roll(x, 1, dims=-1)

    dup = (
        is_add_s & ~first & roll(is_add_s)
        & (score_s == roll(score_s)) & (ts_s == roll(ts_s)) & (dc_s == roll(dc_s))
    )
    live_add = is_add_s & ~(group_has_rmv & dom) & ~dup
    add_rank = prefix_rank(live_add, start)
    live_add = live_add & (add_rank < m_keep)

    # Tags: winner observable iff the group still ships an untagged add;
    # the rest demote to add_r (:198-202).
    group_has_obs_add = run_max((live_add & (kind_s == KIND_ADD)).to(I32), seg).to(torch.bool)
    add_kind = _where((add_rank == 0) & group_has_obs_add, KIND_ADD, KIND_ADD_R)
    rmv_kind = _where(group_rmv_observable, KIND_RMV, KIND_RMV_R)

    live = live_add | keep_rmv
    out_kind = torch.where(live_add, add_kind, torch.where(keep_rmv, rmv_kind, KIND_DEAD)).to(I32)
    return (
        out_kind, key_s, id_s, score_s, dc_s, ts_s, out_vc,
        live, live_add, keep_rmv,
    )


def compact_topk_rmv_log(log: TopkRmvLog, m_keep: int = 4):
    """Compact a topk_rmv effect log in one pass.

    Returns (compacted TopkRmvLog, n_live). Replaying the compacted log from
    any state yields the same observable state as the original log (modulo
    masked history beyond the best `m_keep` live adds per id — the same
    capacity bound as the dense state's M slots)."""
    (
        out_kind, key_s, id_s, score_s, dc_s, ts_s, out_vc,
        live, _live_add, _keep_rmv,
    ) = _compact_topk_rmv_sorted(log, m_keep)
    (out_kind, key_o, id_o, score_o, dc_o, ts_o, vc_o), n_live = _compress(
        live, (out_kind, key_s, id_s, score_s, dc_s, ts_s, out_vc)
    )
    blank = out_kind == KIND_DEAD
    return (
        TopkRmvLog(
            kind=out_kind,
            key=key_o.masked_fill(blank, 0),
            id=id_o.masked_fill(blank, 0),
            score=score_o.masked_fill(blank, 0),
            dc=dc_o.masked_fill(blank, 0),
            ts=ts_o.masked_fill(blank, 0),
            vc=vc_o.masked_fill(blank[..., None], 0),
        ),
        n_live,
    )


def compact_average_log(key: torch.Tensor, val: torch.Tensor, num: torch.Tensor):
    """Fuse every add per key into one (sum, n) op (average.erl:127).

    Padding: num <= 0 (the reference's N=0 no-op guard, average.erl:89).
    Returns (key', sum', n', n_live) with live rows first; sums wrap in
    the dtype of `val`/`num`."""
    skey = _where(num <= 0, _BIG, key)
    perm = torch.sort(skey, dim=-1, stable=True).indices
    key_s, val_s, num_s = _take(skey, perm), _take(val, perm), _take(num, perm)
    first, _, seg = segment_starts(key_s)
    pad = key_s == _BIG
    sums = _segment_sum(val_s.masked_fill(pad, 0), seg)
    nums = _segment_sum(num_s.masked_fill(pad, 0), seg)
    keep = first & ~pad
    out_val = sums.masked_fill(~keep, 0)
    out_num = nums.masked_fill(~keep, 0)
    (key_o, val_o, num_o), n_live = _compress(keep, (key_s, out_val, out_num))
    return key_o.masked_fill(num_o <= 0, 0), val_o, num_o, n_live


def _blank_tail(n_live: torch.Tensor, L: int) -> torch.Tensor:
    return torch.arange(L, device=n_live.device) >= n_live[..., None]


def compact_topk_log(key: torch.Tensor, id_: torch.Tensor, score: torch.Tensor):
    """One add per (key, id), keeping the MAX score (fixes quirk #4 — the
    reference merges duplicate ids last-wins, topk.erl:160-161).

    Padding: score < 0. Returns (key', id', score', n_live), live first."""
    skey = _where(score < 0, _BIG, key)
    perm = _lex_order([_pair(skey, id_), neg_i32(score)])
    key_s, id_s, score_s = _take(skey, perm), _take(id_, perm), _take(score, perm)
    first, _, _ = segment_starts(key_s, id_s)
    keep = first & (key_s != _BIG)
    (key_o, id_o, score_o), n_live = _compress(keep, (key_s, id_s, score_s))
    blank = _blank_tail(n_live, key.shape[-1])
    return key_o.masked_fill(blank, 0), id_o.masked_fill(blank, 0), score_o.masked_fill(blank, -1), n_live


# Op kinds for the dense leaderboard log.
KIND_LB_ADD = 0
KIND_LB_ADD_R = 1
KIND_LB_BAN = 2
KIND_LB_DEAD = 3


def compact_leaderboard_log(kind: torch.Tensor, key: torch.Tensor, id_: torch.Tensor, score: torch.Tensor):
    """Compact a leaderboard effect log in one pass.

    The reference's pairwise rules (``leaderboard.erl:163-205``): add/add of
    the same player keep the better score (the winner keeps its own tag);
    an add followed by a ban of that player deletes the add; ban/ban of the
    same player dedupe. The whole-log pass additionally drops *every* add
    of a player the log also bans regardless of order — sound because bans
    are permanent (``leaderboard.erl:21-27``). Among equal best scores the
    observable ``add`` is preferred over ``add_r``.

    Padding: kind == KIND_LB_DEAD. Returns (kind', key', id', score',
    n_live) with live rows first."""
    is_add = (kind == KIND_LB_ADD) | (kind == KIND_LB_ADD_R)
    is_ban = kind == KIND_LB_BAN
    dead = ~(is_add | is_ban)
    skey = _where(dead, _BIG, key)
    sid = _where(dead, _BIG, id_)
    # Sort: dead last; per (key, id) bans first, then adds best-first
    # (score desc, observable tag before add_r on ties).
    perm = _lex_order([_pair(skey, sid), is_add.to(I64), _pair(neg_i32(score), kind)])
    key_s, id_s, score_s, kind_s = _take(skey, perm), _take(sid, perm), _take(score, perm), _take(kind, perm)
    is_add_s = (kind_s == KIND_LB_ADD) | (kind_s == KIND_LB_ADD_R)
    is_ban_s = kind_s == KIND_LB_BAN

    first, start, seg = segment_starts(key_s, id_s)
    group_has_ban = run_max(is_ban_s.to(I32), seg).to(torch.bool)
    keep_ban = is_ban_s & (prefix_rank(is_ban_s, start) == 0)
    keep_add = is_add_s & (prefix_rank(is_add_s, start) == 0) & ~group_has_ban

    live = keep_ban | keep_add
    out_kind = kind_s.masked_fill(~live, KIND_LB_DEAD)
    (kind_o, key_o, id_o, score_o), n_live = _compress(live, (out_kind, key_s, id_s, score_s))
    blank = kind_o == KIND_LB_DEAD
    return kind_o, key_o.masked_fill(blank, 0), id_o.masked_fill(blank, 0), score_o.masked_fill(blank, 0), n_live


def compact_wordcount_log(key: torch.Tensor, token: torch.Tensor, count: torch.Tensor):
    """Fuse counts per (key, token) (fixes quirk #3 — the reference's
    compact_ops discards both ops, wordcount.erl:70-72).

    Padding: token < 0. Returns (key', token', count', n_live), live first."""
    skey = _where(token < 0, _BIG, key)
    perm = torch.sort(_pair(skey, token), dim=-1, stable=True).indices
    key_s, tok_s, cnt_s = _take(skey, perm), _take(token, perm), _take(count, perm)
    first, _, seg = segment_starts(key_s, tok_s)
    pad = key_s == _BIG
    sums = _segment_sum(cnt_s.masked_fill(pad, 0), seg)
    keep = first & ~pad
    out_cnt = sums.masked_fill(~keep, 0)
    (key_o, tok_o, cnt_o), n_live = _compress(keep, (key_s, tok_s, out_cnt))
    blank = _blank_tail(n_live, key.shape[-1])
    return key_o.masked_fill(blank, 0), tok_o.masked_fill(blank, -1), cnt_o.masked_fill(blank, 0), n_live


# --- term-level entry: host effect logs in, compacted logs out -------------
#
# The whole-log equivalent of the reference host's `can_compact/2` +
# `compact_ops/2` walk (antidote_ccrdt.erl:55-56), on the scalar effect-op
# tuples a host holds ("add"/"add_r"/"rmv"/"rmv_r"/"ban"/"add_counts" +
# payload, the shapes `ScalarCCRDT.update` consumes).


def _round_up(n: int, q: int = 64) -> int:
    return max(q, (n + q - 1) // q * q)


def _np_to(dev: torch.device, *arrays: np.ndarray):
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def compact_effect_ops(type_name, effects, m_keep=None, device: DeviceLike = None):
    """Compact a list of scalar effect-op tuples for `type_name` in one
    vectorized pass on `device` (default: the CUDA card; raises without
    one). Returns the compacted list (order: the kernel's (key, id)
    grouping, observable tags preserved per the reference's pairwise
    rules — see the per-type kernels above).

    `m_keep` bounds surviving adds per id for topk_rmv (None = keep every
    non-dominated add, the reference-compaction semantics: its add/add
    rule demotes but never deletes, topk_rmv.erl:198-202)."""
    known = ("topk_rmv", "average", "topk", "leaderboard",
             "wordcount", "worddocumentcount")
    if type_name not in known:
        raise ValueError(f"no whole-log compactor for type {type_name!r}")
    dev = resolve_device(device)
    effects = list(effects)
    if not effects:
        return []
    if type_name == "topk_rmv":
        return _compact_effects_topk_rmv(effects, m_keep, dev)
    if type_name == "average":
        return _compact_effects_average(effects, dev)
    if type_name == "topk":
        return _compact_effects_topk(effects, dev)
    if type_name == "leaderboard":
        return _compact_effects_leaderboard(effects, dev)
    return _compact_effects_wordcount(type_name, effects, dev)


def _compact_effects_topk_rmv(effects, m_keep, dev):
    kinds = {"add": KIND_ADD, "add_r": KIND_ADD_R, "rmv": KIND_RMV, "rmv_r": KIND_RMV_R}
    L = _round_up(len(effects))
    max_dc = 0
    for kind, payload in effects:
        if kind not in kinds:
            raise ValueError(f"bad topk_rmv effect kind {kind!r}")
        if kind in ("add", "add_r"):
            max_dc = max(max_dc, int(payload[2][0]))
        else:
            vc = payload[1]
            if vc:
                max_dc = max(max_dc, max(int(d) for d in vc))
    D = max_dc + 1
    cols = {name: np.zeros(L, np.int32) for name in ("key", "id", "score", "dc", "ts")}
    kind_a = np.full(L, KIND_DEAD, np.int32)
    vc_a = np.zeros((L, D), np.int32)
    for j, (kind, payload) in enumerate(effects):
        kind_a[j] = kinds[kind]
        if kind in ("add", "add_r"):
            id_, score, (dc, ts) = payload
            cols["id"][j], cols["score"][j] = id_, score
            cols["dc"][j], cols["ts"][j] = dc, ts
        else:
            id_, vc = payload
            cols["id"][j] = id_
            for d, t in vc.items():
                vc_a[j, int(d)] = t
    log = TopkRmvLog(*_np_to(dev, kind_a, cols["key"], cols["id"], cols["score"], cols["dc"], cols["ts"], vc_a))
    out, n_live = compact_topk_rmv_log(log, m_keep if m_keep is not None else L)
    n = int(n_live)
    kind_o, id_o, score_o, dc_o, ts_o, vc_o = (
        x[:n].cpu().numpy() for x in (out.kind, out.id, out.score, out.dc, out.ts, out.vc)
    )
    res = []
    for j in range(n):
        k = int(kind_o[j])
        if k in (KIND_ADD, KIND_ADD_R):
            res.append(
                ("add" if k == KIND_ADD else "add_r",
                 (int(id_o[j]), int(score_o[j]), (int(dc_o[j]), int(ts_o[j]))))
            )
        else:
            vc = {int(d): int(t) for d, t in enumerate(vc_o[j]) if t > 0}
            res.append(("rmv" if k == KIND_RMV else "rmv_r", (int(id_o[j]), vc)))
    return res


def _compact_effects_average(effects, dev):
    L = _round_up(len(effects))
    key = np.zeros(L, np.int32)
    val = np.zeros(L, np.int32)
    num = np.zeros(L, np.int32)
    for j, (kind, payload) in enumerate(effects):
        if kind != "add":
            raise ValueError(f"bad average effect kind {kind!r}")
        v, n = (payload if isinstance(payload, tuple) else (payload, 1))
        val[j], num[j] = v, n
    _, val_o, num_o, n_live = compact_average_log(*_np_to(dev, key, val, num))
    n = int(n_live)
    val_o, num_o = val_o[:n].tolist(), num_o[:n].tolist()
    return [("add", (val_o[j], num_o[j])) for j in range(n)]


def _compact_effects_topk(effects, dev):
    L = _round_up(len(effects))
    key = np.zeros(L, np.int32)
    id_ = np.zeros(L, np.int32)
    score = np.full(L, -1, np.int32)
    for j, (kind, payload) in enumerate(effects):
        if kind != "add":
            raise ValueError(f"bad topk effect kind {kind!r}")
        id_[j], score[j] = payload
    _, id_o, score_o, n_live = compact_topk_log(*_np_to(dev, key, id_, score))
    n = int(n_live)
    id_o, score_o = id_o[:n].tolist(), score_o[:n].tolist()
    return [("add", (id_o[j], score_o[j])) for j in range(n)]


def _compact_effects_leaderboard(effects, dev):
    kinds = {"add": KIND_LB_ADD, "add_r": KIND_LB_ADD_R, "ban": KIND_LB_BAN}
    names = {KIND_LB_ADD: "add", KIND_LB_ADD_R: "add_r", KIND_LB_BAN: "ban"}
    L = _round_up(len(effects))
    kind = np.full(L, KIND_LB_DEAD, np.int32)
    key = np.zeros(L, np.int32)
    id_ = np.zeros(L, np.int32)
    score = np.zeros(L, np.int32)
    for j, (k, payload) in enumerate(effects):
        if k not in kinds:
            raise ValueError(f"bad leaderboard effect kind {k!r}")
        kind[j] = kinds[k]
        if k == "ban":
            id_[j] = payload
        else:
            id_[j], score[j] = payload
    kind_o, _, id_o, score_o, n_live = compact_leaderboard_log(*_np_to(dev, kind, key, id_, score))
    n = int(n_live)
    kind_o, id_o, score_o = kind_o[:n].tolist(), id_o[:n].tolist(), score_o[:n].tolist()
    res = []
    for j in range(n):
        if kind_o[j] == KIND_LB_BAN:
            res.append(("ban", id_o[j]))
        else:
            res.append((names[kind_o[j]], (id_o[j], score_o[j])))
    return res


def _compact_effects_wordcount(type_name, effects, dev):
    """Wordcount family: each effect contributes per-token counts (texts
    tokenize; worddocumentcount dedupes tokens PER DOCUMENT first —
    wordcount.erl:76-86), then counts fuse per token through the dense
    kernel over a local token index."""
    from ..models.wordcount import tokenize

    per_document = type_name == "worddocumentcount"
    contribs = []  # (token string, count)
    for kind, payload in effects:
        if kind == "add":
            toks = tokenize(payload)
            if per_document:
                toks = set(toks)
            for w in toks:
                contribs.append((w, 1))
        elif kind == "add_counts":
            contribs.extend((w, int(c)) for w, c in payload.items())
        else:
            raise ValueError(f"bad {type_name} effect kind {kind!r}")
    if not contribs:
        return []
    vocab = {}
    for w, _ in contribs:
        vocab.setdefault(w, len(vocab))
    words = list(vocab)
    L = _round_up(len(contribs))
    key = np.zeros(L, np.int32)
    tok = np.full(L, -1, np.int32)
    cnt = np.zeros(L, np.int32)
    for j, (w, c) in enumerate(contribs):
        tok[j], cnt[j] = vocab[w], c
    _, tok_o, cnt_o, n_live = compact_wordcount_log(*_np_to(dev, key, tok, cnt))
    n = int(n_live)
    tok_o, cnt_o = tok_o[:n].tolist(), cnt_o[:n].tolist()
    merged = {words[tok_o[j]]: cnt_o[j] for j in range(n)}
    return [("add_counts", merged)] if merged else []


# --- batch coalescing: the replay/pipeline pre-ship pass -------------------


def _coalesce_topk_rmv_kernel(log: TopkRmvLog, m_keep: int, out_adds: int, out_rmvs: int):
    """Compact every replica's [L] log (columns [R, L]) and re-split it
    into fixed-shape add/rmv op fields (dead rows -> the engines' padding
    sentinels: add_ts=0, rmv_id=-1)."""
    (
        _out_kind, key_s, id_s, score_s, dc_s, ts_s, out_vc,
        _live, live_add, keep_rmv,
    ) = _compact_topk_rmv_sorted(log, m_keep)
    # Stable-partition each class to the front, then SLICE the output
    # window; rows taken beyond the class count are non-class rows, masked
    # back to the engines' padding sentinels.
    order_a = _live_first(live_add)[..., :out_adds]
    a_miss = ~torch.gather(live_add, -1, order_a)
    adds = tuple(_take(x, order_a).masked_fill_(a_miss, 0) for x in (key_s, id_s, score_s, dc_s, ts_s))

    order_r = _live_first(keep_rmv)[..., :out_rmvs]
    r_miss = ~torch.gather(keep_rmv, -1, order_r)
    rmvs = (
        _take(key_s, order_r).masked_fill_(r_miss, 0),
        _take(id_s, order_r).masked_fill_(r_miss, -1),
        _take(out_vc, order_r).masked_fill_(r_miss[..., None], 0),
    )
    return adds, rmvs, live_add.sum(-1, dtype=I32), keep_rmv.sum(-1, dtype=I32)


def coalesce_topk_rmv_ops(ops_list, n_dcs: int, m_keep: int, out_adds: int, out_rmvs: int):
    """Fuse a sequence of TopkRmvOps batches into ONE compacted batch — the
    pre-ship pass over op logs (reference: the host compacts its log
    before shipping, antidote_ccrdt.erl:55-56; rules
    antidote_ccrdt_topk_rmv.erl:178-223). Removals fuse per id, dominated
    and duplicate adds are deleted, surviving adds keep the best `m_keep`
    per id (match the engine's slot capacity M: the join truncates there
    anyway). Runs on the device of the batches, every replica at once.

    Returns (TopkRmvOps[R, out_adds / out_rmvs], n_add[R], n_rmv[R]), the
    counts as numpy int32. Raises if any replica's live ops overflow the
    output windows.

    Semantics note (same divergence the reference accepts): a dominated
    add deleted by compaction no longer advances the state vc
    (topk_rmv.erl:182-187 'forgets the clock advance'), and it can no
    longer be reported as a dominated extra — run compaction on logs
    whose dominated re-broadcasts are not needed (e.g. intra-DC replay),
    not between `downstream` and the extras-collecting apply."""
    from ..models.topk_rmv_dense import TopkRmvOps

    ops_list = list(ops_list)

    def cat(field):
        return torch.cat([getattr(o, field) for o in ops_list], dim=1)

    add_key, add_id, add_score, add_dc, add_ts = (
        cat(f) for f in ("add_key", "add_id", "add_score", "add_dc", "add_ts")
    )
    rmv_key, rmv_id, rmv_vc = cat("rmv_key"), cat("rmv_id"), cat("rmv_vc")
    R, Ba = add_key.shape
    Brr = rmv_key.shape[1]
    L = _round_up(Ba + Brr, 128)
    pad_a = L - Ba - Brr
    if rmv_vc.shape[-1] != n_dcs:
        raise ValueError(f"rmv_vc width {rmv_vc.shape[-1]} != n_dcs {n_dcs}")
    dev = add_key.device

    def cat_field(a_val, r_val, pad_val):
        pad = torch.full((R, pad_a) + tuple(a_val.shape[2:]), pad_val, dtype=I32, device=dev)
        return torch.cat([a_val.to(I32), r_val.to(I32), pad], dim=1)

    zeros_r = torch.zeros_like(rmv_key, dtype=I32)
    log = TopkRmvLog(
        kind=cat_field(_where(add_ts > 0, KIND_ADD, KIND_DEAD), _where(rmv_id >= 0, KIND_RMV, KIND_DEAD), KIND_DEAD),
        key=cat_field(add_key, rmv_key, 0),
        id=cat_field(add_id, rmv_id, 0),
        score=cat_field(add_score, zeros_r, 0),
        dc=cat_field(add_dc, zeros_r, 0),
        ts=cat_field(add_ts, zeros_r, 0),
        vc=cat_field(torch.zeros((R, Ba, n_dcs), dtype=I32, device=dev), rmv_vc, 0),
    )
    del rmv_vc
    adds, rmvs, n_add, n_rmv = _coalesce_topk_rmv_kernel(log, m_keep, out_adds, out_rmvs)
    del log
    n_add_h, n_rmv_h = n_add.cpu().numpy(), n_rmv.cpu().numpy()
    if (n_add_h > out_adds).any() or (n_rmv_h > out_rmvs).any():
        raise ValueError(
            f"coalesced log overflows output windows: max {int(n_add_h.max())} "
            f"adds / {int(n_rmv_h.max())} rmvs vs ({out_adds}, {out_rmvs})"
        )
    return TopkRmvOps(*adds, *rmvs), n_add_h, n_rmv_h


# -- wire-window delta coalescing --------------------------------------------
# The gossip analog of the pre-ship op pass above: fuse K consecutive
# pending publish windows' deltas into ONE frame. Every gossip delta ships
# row/cell VALUES under an idempotent join (topk_rmv slot rows, table JOIN
# cells), so last-window-wins per touched row is exact: the coalesced
# frame gives the bit-identical state the K chained frames would. (MONOID
# table diffs sum instead.) Host-side numpy, as in JAX: window row counts
# differ every publish, and the frame is serialized right after.


def _last_wins(rows_cat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(unique_rows_sorted, gather_index_of_LAST_occurrence). The inputs
    are concatenated in window order, so "last occurrence" is "latest
    window" — the join-exact winner for value-shipping deltas."""
    rev = rows_cat[::-1]
    uniq, first_rev = np.unique(rev, return_index=True)
    return uniq, rows_cat.shape[0] - 1 - first_rev


def coalesce_topk_rmv_deltas(deltas):
    """Fuse K chained `parallel.delta.TopkRmvDelta` windows (oldest
    first) into one delta: union of touched rows, latest window's payload
    per row, latest whole-state leaves (vc/lossy are monotone and each
    window ships them in full). The row leaves land on the device of the
    newest window's."""
    from ..parallel.delta import TopkRmvDelta

    deltas = list(deltas)
    if len(deltas) == 1:
        return deltas[0]
    rows_cat = np.concatenate([as_numpy(d.rows) for d in deltas])
    uniq, take = _last_wins(rows_cat)
    dev = deltas[-1].rows.device

    def cat(field):
        return torch.from_numpy(np.concatenate([as_numpy(getattr(d, field)) for d in deltas])[take]).to(dev)

    return TopkRmvDelta(
        rows=torch.from_numpy(uniq.astype(np.int32)).to(dev),
        slot_score=cat("slot_score"),
        slot_dc=cat("slot_dc"),
        slot_ts=cat("slot_ts"),
        rmv_vc=cat("rmv_vc"),
        vc=deltas[-1].vc,
        lossy=deltas[-1].lossy,
    )


def coalesce_table_deltas(deltas, monoid: bool = False):
    """Fuse K chained entrywise table deltas (`parallel.delta.table_delta`
    dicts, oldest first). JOIN payloads: latest value per touched cell +
    latest whole leaves. MONOID payloads ship diffs — sum per cell, and
    sum the integer whole leaves (the non-integer ones ship values). Sums
    wrap in the leaves' dtype, as numpy's do."""
    deltas = list(deltas)
    if len(deltas) == 1:
        return deltas[0]
    dev = deltas[-1]["idx"].device
    idx_cat = np.concatenate([as_numpy(d["idx"]) for d in deltas])
    table_paths = list(deltas[-1]["table"])
    out_table = {}
    if monoid:
        uniq, scatter = np.unique(idx_cat, return_inverse=True)
        for p in table_paths:
            vals = np.concatenate([as_numpy(d["table"][p]) for d in deltas])
            acc = np.zeros(uniq.shape[0], vals.dtype)
            np.add.at(acc, scatter.reshape(-1), vals)
            out_table[p] = torch.from_numpy(acc).to(dev)
    else:
        uniq, take = _last_wins(idx_cat)
        for p in table_paths:
            vals = np.concatenate([as_numpy(d["table"][p]) for d in deltas])
            out_table[p] = torch.from_numpy(vals[take]).to(dev)
    out_whole = {}
    for p, last in deltas[-1]["whole"].items():
        if monoid and not last.dtype.is_floating_point and last.dtype != torch.bool:
            out_whole[p] = torch.from_numpy(sum(as_numpy(d["whole"][p]) for d in deltas)).to(last.device)
        else:
            out_whole[p] = last
    return {
        "idx": torch.from_numpy(uniq.astype(np.int32)).to(dev),
        "table": out_table,
        "whole": out_whole,
    }


def coalesce_deltas(dense, deltas):
    """Engine-generic fuse of K chained gossip deltas (oldest first), or
    None when this delta flavor has no coalesce kernel (lifted-monoid row
    deltas — the publisher falls back to re-cutting the interval delta
    against the last shipped state, which is exact for every engine)."""
    from ..core.behaviour import MergeKind
    from ..parallel.delta import TopkRmvDelta, _is_monoid_row_delta

    deltas = list(deltas)
    if not deltas:
        return None
    if all(isinstance(d, TopkRmvDelta) for d in deltas):
        return coalesce_topk_rmv_deltas(deltas)
    if all(isinstance(d, dict) and not _is_monoid_row_delta(d) and "idx" in d for d in deltas):
        monoid = getattr(dense, "merge_kind", None) == MergeKind.MONOID
        return coalesce_table_deltas(deltas, monoid=monoid)
    return None
