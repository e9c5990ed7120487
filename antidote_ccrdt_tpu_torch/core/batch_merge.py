"""`batch_merge`: merge many scalar CRDT states in one batched device pass
(port of ``antidote_ccrdt_tpu/core/batch_merge.py``).

A host hands over N replica states (live scalar states, their `to_binary`
blobs, or reference ``term_to_binary`` blobs) and gets one merged state of
the same scalar shape back. The join is the lattice the dense engines
implement:

  average      (s, n) pairs          combine = +   (MONOID, host ints)
  wordcount(s) word -> count         combine = +   (MONOID)
  topk         id -> best score      join = per-id max, keep top size
  leaderboard  scores + bans         join = max / or, observable re-derived
  topk_rmv     full add-wins state   join = slot lattice + vc max

MONOID caveat: the + combiners are not idempotent — average and the
wordcounts require the inputs' op histories to be disjoint. The JOIN types
tolerate any overlap.

The converters build the sorted id/dc universes on the host, lay the
states out as one [N, ...] dense batch on the device, fold the join
pairwise in ceil(log2 N) batched merges, and read the one row back.
Capacities are sized exactly from the inputs, so the dense lossy flag can
never set. For topk_rmv the fold's slot join is K3 (``ops.kernels.
sort_slots``, add-wins filter fused) at W = 2M, after one unfused K3 call
at W = M that puts each row in canonical order.

``device``: where the dense batch lives — the CUDA card by default
(raising without one), ``"cpu"`` for the plain PyTorch path. Every result
equals the JAX package's ``batch_merge`` on the same inputs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..device import HOST_ONLY, DeviceLike, resolve_device
from ..obs import devprof
from ..obs import profile
from ..obs import spans as obs_spans
from ..utils.tree import dataclass_fields
from .behaviour import registry

_I32_MIN, _I32_MAX = -(2**31 - 1), 2**31 - 1


def _check_i32(x: int) -> int:
    # Exclusive lower bound: _I32_MIN is the dense engines' "never seen"
    # sentinel, so a real score equal to it would silently vanish in the
    # merged state — reject it loudly instead.
    if not (_I32_MIN < x <= _I32_MAX):
        raise ValueError(
            f"value {x} outside the dense engines' usable int32 range "
            f"({_I32_MIN} is the absent-entry sentinel)"
        )
    return int(x)


# -- state trees -------------------------------------------------------------


def _tree_map(fn: Callable, *trees: Any) -> Any:
    """`fn` over the tensor leaves of dataclass / NamedTuple states (None
    leaves stay None; a static dataclass field is structure, taken from
    the first tree, as JAX's treedef carries it)."""
    t0 = trees[0]
    if t0 is None:
        return None
    if dataclasses.is_dataclass(t0):
        names, static = dataclass_fields(type(t0))
        return type(t0)(
            **{n: _tree_map(fn, *(getattr(t, n) for t in trees)) for n in names},
            **{k: getattr(t0, k) for k in static},
        )
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda x: out.append(x), tree)
    return out


def _copy_leaf(x: torch.Tensor) -> torch.Tensor:
    """A clone that keeps a mesh-placed leaf's ``sharding`` tag (as the
    JAX package's jitted copy keeps its operand's sharding)."""
    out = torch.clone(x)
    sharding = getattr(x, "sharding", None)
    if sharding is not None:
        out.sharding = sharding
    return out


def snapshot_state(state: Any) -> Any:
    """A copy of every tensor leaf of a state: a held snapshot that no
    later merge can touch. Observed as the ``batch_merge.snapshot``
    dispatch (a ``round.device_dispatch`` span, `obs.profile`)."""
    tok = (
        obs_spans.begin("round.device_dispatch", site="batch_merge.snapshot")
        if obs_spans.ACTIVE
        else None
    )
    try:
        if profile.ACTIVE or devprof.ACTIVE:
            with profile.dispatch("batch_merge.snapshot", operands=(state,)):
                return _tree_map(_copy_leaf, state)
        return _tree_map(_copy_leaf, state)
    finally:
        obs_spans.end(tok)


def stage_to_device(tree: Any, device: DeviceLike = None) -> Any:
    """Enqueue the copies of a state's leaves to `device` (default: the
    card) and return at once (``non_blocking``); leaves already there pass
    through."""
    dev = resolve_device(device)
    return _tree_map(lambda x: x.to(dev, non_blocking=True), tree)


def tree_nbytes(tree: Any) -> int:
    """Total payload bytes across a state's tensor leaves."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


# -- folds -------------------------------------------------------------------


def merge_into(merge, state, incoming, donate_incoming: bool = True, site: str = "batch_merge.into"):
    """One window's merge, `state ⊔ incoming`. The JAX package donates
    `incoming`'s buffers to the result; buffer reuse never changes a
    result, so here it is the engine's merge, which writes no input.
    `site` labels the dispatch for spans, `obs.profile` and
    `obs.devprof`; `donate_incoming` only names the JAX slot
    (``donate_rhs`` or ``plain``) in the devprof signature."""
    donation = "donate_rhs" if donate_incoming else "plain"
    tok = (
        obs_spans.begin("round.device_dispatch", site=site, n=2)
        if obs_spans.ACTIVE
        else None
    )
    try:
        if profile.ACTIVE or devprof.ACTIVE:
            with profile.dispatch(site, fn=merge, operands=(incoming,), donation=donation):
                return merge(state, incoming)
        return merge(state, incoming)
    finally:
        obs_spans.end(tok)


@contextlib.contextmanager
def host_device() -> Iterator[None]:
    """A region in which new tensors and merges go to the host CPU: the
    default device of tensor factories is the CPU, and an entry point
    called without a device (``batch_merge``, ``registry.make_dense``)
    runs its plain path there. The pager's cold-fold tier runs the same
    merges as the card's hot path, on CPU tensors. A device passed
    explicitly still wins."""
    token = HOST_ONLY.set(True)
    try:
        with torch.device("cpu"):
            yield
    finally:
        HOST_ONLY.reset(token)


def host_merge_into(merge, state, incoming, donate_incoming: bool = True, site: str = "batch_merge.into"):
    """`merge_into` on the host: both states are brought to the CPU and
    folded there by the engine's plain path; the card is not touched."""
    cpu = torch.device("cpu")
    return merge_into(
        merge,
        _tree_map(lambda x: x.to(cpu), state),
        _tree_map(lambda x: x.to(cpu), incoming),
        donate_incoming=donate_incoming,
        site=site,
    )


def fold_states(merge, states: Sequence[Any]):
    """Fold N same-shape states in ceil(log2 N) batched merges: stack to
    [N, ...] (engine merges are rank-polymorphic over the leading axis),
    fold, and take the single row."""
    if not states:
        raise ValueError("fold_states needs at least one state")
    if len(states) == 1:
        return states[0]
    batch = _tree_map(lambda *xs: torch.stack(xs, 0), *states)
    folded = _batched_fold(merge, batch, donation="donate_both")
    return _tree_map(lambda x: x[0], folded)


def _batched_fold(merge, batch: Any, donation: str = ""):
    """Fold a [N, ...] state down to [1, ...]: each level merges the first
    half against the second half in one call, carrying the odd row. Each
    level is observed as a ``batch_merge.fold`` dispatch; `donation`
    names the JAX slot (``donate_both`` for `fold_states`) in the devprof
    signature and changes nothing else."""
    n = _leaves(batch)[0].shape[0]
    while n > 1:
        half = n // 2
        lhs = _tree_map(lambda x: x[:half], batch)
        rhs = _tree_map(lambda x: x[half : 2 * half], batch)
        tok = (
            obs_spans.begin("round.device_dispatch", site="batch_merge.fold", n=n)
            if obs_spans.ACTIVE
            else None
        )
        try:
            if profile.ACTIVE or devprof.ACTIVE:
                with profile.dispatch("batch_merge.fold", fn=merge, operands=(lhs, rhs), donation=donation):
                    merged = merge(lhs, rhs)
            else:
                merged = merge(lhs, rhs)
        finally:
            obs_spans.end(tok)
        if n % 2:
            rest = _tree_map(lambda x: x[2 * half :], batch)
            batch = _tree_map(lambda m, t: torch.cat([m, t], 0), merged, rest)
        else:
            batch = merged
        n = (n + 1) // 2
    return batch


# Dense engines keyed by (type, device, capacities): the converters size
# capacities exactly, so equal shapes reuse one engine.
_DENSE_MEMO: Dict[Any, Any] = {}


def _memo_dense(type_name: str, device: DeviceLike = None, **caps):
    dev = resolve_device(device)
    key = (type_name, str(dev), tuple(sorted(caps.items())))
    eng = _DENSE_MEMO.get(key)
    if eng is None:
        eng = registry.make_dense(type_name, device=dev, **caps)
        _DENSE_MEMO[key] = eng
    return eng


def prewarm_topk_rmv(size: int, n_ids: int = 1, n_dcs: int = 1, max_slots: int = 1, device: DeviceLike = None) -> int:
    """Boot-time warm-up: build the kernels (on a card) and run one
    topk_rmv fold merge of [1, 1, U, M] halves per rung of the padded
    capacity ladder up to `max_slots` live adds per id, so the first real
    merges pay no build. Returns the number of rungs run."""
    from ..models.topk_rmv_dense import TopkRmvDenseState

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..ops import _build

        _build.build_all()
    U, D = devprof.pad_dim(n_ids), devprof.pad_dim(n_dcs)
    rungs = 0
    m = 1
    while True:
        m = devprof.pad_dim(m)
        dense = _memo_dense("topk_rmv", dev, n_ids=U, n_dcs=D, size=size, slots_per_id=m)

        def blank():
            return TopkRmvDenseState(
                slot_score=torch.full((1, 1, U, m), _I32_MIN, dtype=torch.int32, device=dev),
                slot_dc=torch.zeros((1, 1, U, m), dtype=torch.int32, device=dev),
                slot_ts=torch.zeros((1, 1, U, m), dtype=torch.int32, device=dev),
                rmv_vc=torch.zeros((1, 1, U, D), dtype=torch.int32, device=dev),
                vc=torch.zeros((1, 1, D), dtype=torch.int32, device=dev),
                lossy=torch.zeros((1, 1), dtype=torch.bool, device=dev),
            )

        dense.merge(blank(), blank())
        rungs += 1
        if m >= max_slots:
            return rungs
        m *= 2


# -- the entry point -----------------------------------------------------------


def batch_merge(type_name: str, states: Sequence[Any], device: DeviceLike = None) -> Any:
    """Join N scalar states of `type_name` into one. Accepts live scalar
    states or `to_binary` blobs (mixed is fine); returns a live scalar
    state (call the type's `to_binary` to ship it back). The dense fold
    runs on `device`: the card by default, ``"cpu"`` for the plain path."""
    dev = resolve_device(device)
    if not states:
        raise ValueError("batch_merge needs at least one state")
    eng = registry.scalar(type_name)

    def decode(blob):
        if blob[:1] == b"\x83":  # Erlang term_to_binary (ETF magic)
            from . import wire

            return wire.from_reference_binary(type_name, bytes(blob))
        return eng.from_binary(blob)  # framework CCRD snapshot

    states = [decode(s) if isinstance(s, (bytes, bytearray)) else s for s in states]
    if len(states) == 1:
        return states[0]
    fn = _MERGERS.get(type_name)
    if fn is None:
        raise ValueError(f"no batch_merge for type {type_name!r}")
    return fn(states, dev)


def _on(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(dev)


# -- simple monoids --------------------------------------------------------


def _merge_average(states, dev):
    # Two ints per state: host arithmetic (unbounded Python ints — the
    # scalar average has no i32 range limit).
    return (sum(s for s, _ in states), sum(n for _, n in states))


def _merge_wordcount(states, dev):
    vocab = sorted({w for st in states for w in st})
    idx = {w: i for i, w in enumerate(vocab)}
    # i32 like the dense engine's count tables: per-entry range is
    # checked, and the column sums wrap in int32 as the JAX sum does.
    table = np.zeros((len(states), len(vocab)), np.int32)
    for r, st in enumerate(states):
        for w, c in st.items():
            table[r, idx[w]] = _check_i32(c)
    if not vocab:
        return {}
    total = _on(dev, table).sum(0, dtype=torch.int32).cpu().numpy()
    return {w: int(total[i]) for w, i in idx.items() if total[i]}


# -- score tables ----------------------------------------------------------


def _merge_topk(states, dev):
    from ..models.topk import TopkDenseState, TopkState, _join

    size = states[0].size
    if any(s.size != size for s in states):
        raise ValueError("cannot merge topk states of different sizes")
    ids = sorted({i for st in states for i in st.entries})
    if not ids:
        return TopkState({}, size)
    dense = _memo_dense("topk", dev, n_ids=len(ids), size=size)
    idx = {w: i for i, w in enumerate(ids)}
    table = np.full((len(states), 1, len(ids)), _I32_MIN, np.int32)
    for r, st in enumerate(states):
        for w, c in st.entries.items():
            table[r, 0, idx[w]] = _check_i32(c)
    folded = _batched_fold(dense.merge, TopkDenseState(best_score=_on(dev, table)))
    best = folded.best_score[0, 0].cpu().numpy()
    # _join applies the scalar type's own top-`size` truncation rule.
    return TopkState(
        _join({}, ((w, int(best[i])) for w, i in idx.items() if best[i] > _I32_MIN), size),
        size,
    )


def _merge_leaderboard(states, dev):
    from ..models.leaderboard import LeaderboardDenseState, LeaderboardState, NIL, _min_pair

    size = states[0].size
    if any(s.size != size for s in states):
        raise ValueError("cannot merge leaderboard states of different sizes")
    ids = sorted({i for st in states for i in (*st.observed, *st.masked, *st.bans)})
    if not ids:
        return LeaderboardState({}, {}, frozenset(), NIL, size)
    dense = _memo_dense("leaderboard", dev, n_players=len(ids), size=size)
    idx = {w: i for i, w in enumerate(ids)}
    score = np.full((len(states), 1, len(ids)), _I32_MIN, np.int32)
    banned = np.zeros((len(states), 1, len(ids)), bool)
    for r, st in enumerate(states):
        for src in (st.observed, st.masked):
            for w, c in src.items():
                score[r, 0, idx[w]] = max(score[r, 0, idx[w]], _check_i32(c))
        for w in st.bans:
            banned[r, 0, idx[w]] = True
    folded = _batched_fold(
        dense.merge, LeaderboardDenseState(best_score=_on(dev, score), banned=_on(dev, banned))
    )
    f_score = folded.best_score[0, 0].cpu().numpy()
    f_ban = folded.banned[0, 0].cpu().numpy()
    live = [(w, int(f_score[i])) for w, i in idx.items() if f_score[i] > _I32_MIN and not f_ban[i]]
    live.sort(key=lambda p: (p[1], p[0]), reverse=True)
    observed = dict(live[:size])
    masked = dict(live[size:])
    bans = frozenset(w for w, i in idx.items() if f_ban[i])
    return LeaderboardState(observed, masked, bans, _min_pair(observed), size)


# -- topk_rmv (full add-wins state) ----------------------------------------


def topk_rmv_tables(states, dev) -> Tuple[Any, List[Any], List[Any]]:
    """The host half of the topk_rmv converter: ([N, 1, U, M] dense batch
    on `dev` with each row's slots in host order, not yet canonical,
    sorted ids, sorted dcs), or None when the states hold no id and no
    dc. M is the largest union of live adds of one id, so the fold cannot
    overflow."""
    from ..models.topk_rmv_dense import TopkRmvDenseState

    size = states[0].size
    if any(s.size != size for s in states):
        raise ValueError("cannot merge topk_rmv states of different sizes")
    ids = sorted({i for st in states for i in (*st.masked, *st.removals)})
    dcs = sorted(
        {
            d
            for st in states
            for d in (
                *st.vc,
                *(d for vc in st.removals.values() for d in vc),
                *(e[2][0] for es in st.masked.values() for e in es),
            )
        }
    )
    if not ids and not dcs:
        return None
    U, D = max(len(ids), 1), max(len(dcs), 1)
    # Exact capacity: the union multiset of live adds per id.
    union: Dict[Any, set] = {}
    for st in states:
        for w, es in st.masked.items():
            union.setdefault(w, set()).update(es)
    M = max((len(es) for es in union.values()), default=1)
    if devprof.WARMUP:
        # Warm-up buckets (CCRDT_DEVPROF_WARMUP=1): capacities padded to
        # the next power of two, as the JAX package pads them. Padded
        # slots carry the absent-entry sentinels (_I32_MIN score, 0 ts,
        # 0 vc) that the extraction skips, so the result is unchanged.
        U, D, M = devprof.pad_dim(U), devprof.pad_dim(D), devprof.pad_dim(M)
    id_idx = {w: i for i, w in enumerate(ids)}
    dc_idx = {d: i for i, d in enumerate(dcs)}

    N = len(states)
    slot_score = np.full((N, 1, U, M), _I32_MIN, np.int32)
    slot_dc = np.zeros((N, 1, U, M), np.int32)
    slot_ts = np.zeros((N, 1, U, M), np.int32)
    rmv_vc = np.zeros((N, 1, U, D), np.int32)
    vc = np.zeros((N, 1, D), np.int32)
    for r, st in enumerate(states):
        for w, es in st.masked.items():
            for j, (s, _i, (d, t)) in enumerate(sorted(es)):
                slot_score[r, 0, id_idx[w], j] = _check_i32(s)
                slot_dc[r, 0, id_idx[w], j] = dc_idx[d]
                slot_ts[r, 0, id_idx[w], j] = _check_i32(t)
        for w, v in st.removals.items():
            for d, t in v.items():
                rmv_vc[r, 0, id_idx[w], dc_idx[d]] = _check_i32(t)
        for d, t in st.vc.items():
            vc[r, 0, dc_idx[d]] = _check_i32(t)

    raw = TopkRmvDenseState(
        slot_score=_on(dev, slot_score), slot_dc=_on(dev, slot_dc), slot_ts=_on(dev, slot_ts),
        rmv_vc=_on(dev, rmv_vc), vc=_on(dev, vc),
        lossy=torch.zeros((N, 1), dtype=torch.bool, device=dev),
    )
    return raw, ids, dcs


def topk_rmv_to_dense(states, dev) -> Tuple[Any, Any, List[Any], List[Any]]:
    """The topk_rmv converter: (engine, canonical [N, 1, U, M] dense batch
    on `dev`, sorted ids, sorted dcs), or None (see `topk_rmv_tables`)."""
    from ..ops.kernels import sort_slots

    conv = topk_rmv_tables(states, dev)
    if conv is None:
        return None
    raw, ids, dcs = conv
    _, _, U, M = raw.slot_ts.shape
    dense = _memo_dense("topk_rmv", dev, n_ids=U, n_dcs=raw.vc.shape[-1], size=states[0].size, slots_per_id=M)
    # Canonicalize rows to the slot invariant (sorted desc, dup-free) that
    # the merge's join requires: K3 unfused at W = M.
    s_, d_, t_, _ = sort_slots([(raw.slot_score, raw.slot_dc, raw.slot_ts)], M)
    return dense, dataclasses.replace(raw, slot_score=s_, slot_dc=d_, slot_ts=t_), ids, dcs


def topk_rmv_from_dense(folded, ids: List[Any], dcs: List[Any], size: int):
    """The scalar topk_rmv state of row 0 of a folded dense batch."""
    from ..models.topk_rmv import TopkRmvState, _min_observed

    assert not bool(folded.lossy.any())  # capacity sized exactly
    f_score = folded.slot_score[0, 0].cpu().numpy()
    f_dc = folded.slot_dc[0, 0].cpu().numpy()
    f_ts = folded.slot_ts[0, 0].cpu().numpy()
    f_rmv = folded.rmv_vc[0, 0].cpu().numpy()
    f_vc = folded.vc[0, 0].cpu().numpy()

    masked = {}
    for i in np.flatnonzero((f_ts > 0).any(-1)).tolist():
        w = ids[i]
        js = np.flatnonzero(f_ts[i] > 0)
        masked[w] = frozenset(
            (s, w, (dcs[d], t))
            for s, d, t in zip(f_score[i, js].tolist(), f_dc[i, js].tolist(), f_ts[i, js].tolist())
        )
    removals: Dict[Any, Dict[Any, int]] = {}
    rows, cols = np.nonzero(f_rmv)
    for i, d, t in zip(rows.tolist(), cols.tolist(), f_rmv[rows, cols].tolist()):
        removals.setdefault(ids[i], {})[dcs[d]] = t
    out_vc = {dcs[d]: int(f_vc[d]) for d in np.flatnonzero(f_vc).tolist()}
    # Observed: top `size` per-id bests by cmp order (derived, like the
    # dense engine's observe).
    bests = [max(es) for es in masked.values()]
    bests.sort(reverse=True)
    observed = {e[1]: e for e in bests[:size]}
    return TopkRmvState(observed, masked, removals, out_vc, _min_observed(observed), size)


def _merge_topk_rmv(states, dev):
    from ..models.topk_rmv import NIL, TopkRmvState

    size = states[0].size
    conv = topk_rmv_to_dense(states, dev)
    if conv is None:
        return TopkRmvState({}, {}, {}, {}, NIL, size)
    dense, batch, ids, dcs = conv
    return topk_rmv_from_dense(_batched_fold(dense.merge, batch), ids, dcs, size)


_MERGERS = {
    "average": _merge_average,
    "wordcount": _merge_wordcount,
    "worddocumentcount": _merge_wordcount,
    "topk": _merge_topk,
    "leaderboard": _merge_leaderboard,
    "topk_rmv": _merge_topk_rmv,
}
