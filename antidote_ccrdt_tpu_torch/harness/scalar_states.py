"""Seeded scalar replica states for ``batch_merge``, and an independent
host-side join of topk_rmv states to check it against.

Each state is built by driving effect ops through the type's scalar
`update` (extra ops re-applied to the same state), as a replica that saw
those ops would hold it. At the north-star size that is too slow for
topk_rmv (`update` copies the `masked` dict on every add), so
`topk_rmv_direct` builds the same states straight from the draws; the
tests and ``chip_smoke.py`` hold it against `update` at a reduced size.

The draws are numpy from a seed, so the JAX package's tests can drive the
same ops through its own scalar models.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from ..core.behaviour import registry

EffectOp = Tuple[str, Any]


def apply_effects(name: str, state: Any, effects: Sequence[EffectOp]) -> Any:
    """`state` after each effect through the scalar `update`, each extra
    op it returns applied right after it."""
    eng = registry.scalar(name)
    for eff in effects:
        state, extras = eng.update(eff, state)
        for e in extras:
            state, _ = eng.update(e, state)
    return state


# -- topk_rmv ----------------------------------------------------------------


def topk_rmv_effects(
    n_states: int, n_ids: int, n_adds: int, n_rmvs: int, seed: int,
    score_max: int = 1_000_000, rmv_dcs: int = 4,
) -> List[List[EffectOp]]:
    """Per state r (which is DC r, with its own clock): `n_adds` adds of
    uniform ids in [0, n_ids) and scores in [1, score_max) at ts 1, 2, ...,
    and `n_rmvs` removals interleaved among them. A removal targets an id
    the state has added; its vc covers the state's own adds so far and
    `rmv_dcs` other DCs at uniform ts in [1, n_adds], so in a join it also
    removes other states' adds."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(n_states):
        ids = rng.integers(0, n_ids, n_adds)
        scores = rng.integers(1, score_max, n_adds)
        after = np.sort(rng.integers(1, n_adds + 1, n_rmvs))  # removal j follows add after[j] - 1
        pick = (rng.random(n_rmvs) * after).astype(np.int64)  # an add already made
        others = [rng.choice([d for d in range(n_states) if d != r] or [r], rmv_dcs) for _ in range(n_rmvs)]
        other_ts = rng.integers(1, n_adds + 1, (n_rmvs, rmv_dcs))
        effects: List[EffectOp] = []
        j = 0
        for k in range(n_adds):
            effects.append(("add", (int(ids[k]), int(scores[k]), (r, k + 1))))
            while j < n_rmvs and after[j] == k + 1:
                vc = {int(d): int(t) for d, t in zip(others[j], other_ts[j])}
                vc[r] = k + 1
                effects.append(("rmv", (int(ids[pick[j]]), vc)))
                j += 1
        out.append(effects)
    return out


def top_observed(masked: Dict[Any, frozenset], size: int):
    """The top `size` per-id bests (natural element order) and their min."""
    from ..models.topk_rmv import _min_observed

    bests = sorted((max(es) for es in masked.values()), reverse=True)
    observed = {e[1]: e for e in bests[:size]}
    return observed, _min_observed(observed)


def topk_rmv_direct(effects: Sequence[EffectOp], size: int):
    """The state `apply_effects("topk_rmv", new(size), effects)` gives for
    one state's `topk_rmv_effects`, built from the ops in one pass: adds
    of the state's own DC arrive in ts order and each removal's vc covers
    only adds made before it, so no add is dominated on arrival, an add
    survives iff its ts exceeds the joined tombstone at its DC, and the
    observed set is the top `size` of the per-id bests."""
    from ..models.topk_rmv import TopkRmvState

    adds: Dict[Any, List[Tuple]] = {}
    removals: Dict[Any, Dict[Any, int]] = {}
    vc: Dict[Any, int] = {}
    for kind, payload in effects:
        if kind == "add":
            id_, score, (dc, ts) = payload
            adds.setdefault(id_, []).append((score, id_, (dc, ts)))
            vc[dc] = max(vc.get(dc, ts), ts)
        else:
            id_, rvc = payload
            cur = removals.setdefault(id_, {})
            for d, t in rvc.items():
                cur[d] = max(cur.get(d, t), t)
    masked = {}
    for id_, es in adds.items():
        rv = removals.get(id_, {})
        kept = frozenset(e for e in es if e[2][1] > rv.get(e[2][0], 0))
        if kept:
            masked[id_] = kept
    observed, mn = top_observed(masked, size)
    return TopkRmvState(observed, masked, removals, vc, mn, size)


def topk_rmv_set_join(states: Sequence[Any]):
    """The join of topk_rmv states as sets, written independently of the
    dense engines: removals and vc are the pointwise max; masked is the
    union of the inputs' adds, keeping those whose ts exceeds the joined
    tombstone at their DC; observed is the top `size` of the per-id bests."""
    from ..models.topk_rmv import TopkRmvState

    size = states[0].size
    removals: Dict[Any, Dict[Any, int]] = {}
    vc: Dict[Any, int] = {}
    union: Dict[Any, set] = {}
    for st in states:
        for id_, rv in st.removals.items():
            cur = removals.setdefault(id_, {})
            for d, t in rv.items():
                cur[d] = max(cur.get(d, t), t)
        for d, t in st.vc.items():
            vc[d] = max(vc.get(d, t), t)
        for id_, es in st.masked.items():
            union.setdefault(id_, set()).update(es)
    masked = {}
    for id_, es in union.items():
        rv = removals.get(id_, {})
        kept = frozenset(e for e in es if e[2][1] > max(rv.get(e[2][0], 0), 0))
        if kept:
            masked[id_] = kept
    observed, mn = top_observed(masked, size)
    return TopkRmvState(observed, masked, removals, vc, mn, size)


def topk_rmv_capacity_states(m: int, n: int = 4, size: int = 4, n_ids: int = 6):
    """n topk_rmv states over ids 0..n_ids-1 whose union holds exactly m
    live adds of id 0 (the k-th on state k % n, every third also on the
    next state) and fewer of every other id; the last id carries
    tombstones. So ``batch_merge`` sizes its capacity M = m: the
    converter's K3 call runs at W = m and the fold's joins at W = 2m.
    Draws from seed m."""
    from ..models.topk_rmv import TopkRmvState

    rng = np.random.default_rng(m)
    adds = {w: [(int(rng.integers(1, 100)), w, (int(rng.integers(0, n)), k + 1))
                for k in range(m if w == 0 else int(rng.integers(1, m)))] for w in range(n_ids)}
    last = n_ids - 1
    states = []
    for r in range(n):
        masked = {w: frozenset(e for k, e in enumerate(es) if k % n == r or (k % 3 == 0 and (k + 1) % n == r))
                  for w, es in adds.items()}
        masked = {w: es for w, es in masked.items() if es}
        observed, mn = top_observed(masked, size)
        states.append(TopkRmvState(observed, masked, {last: {r: 2, (r + 1) % n: 1}}, {r: m + 1}, mn, size))
    return states


# -- the other types -----------------------------------------------------------


def seeded_effects(name: str, n_states: int, seed: int, n_ops: int = 200, n_ids: int = 40) -> List[List[EffectOp]]:
    """A few seeded effect ops per state for `name`, disjoint across states
    (the MONOID types count every op once)."""
    rng = np.random.default_rng(seed)
    words = ["a", "b", "c", "dd", "", "e\nf", "x  y"]
    out = []
    for r in range(n_states):
        if name == "average":
            eff = [("add", (int(v), int(n))) for v, n in zip(rng.integers(-50, 1000, n_ops), rng.integers(0, 3, n_ops))]
        elif name in ("wordcount", "worddocumentcount"):
            eff = [("add", " ".join(rng.choice(words, int(rng.integers(0, 6))))) for _ in range(n_ops // 10)]
        elif name == "topk":
            eff = [("add", (int(i), int(s))) for i, s in zip(rng.integers(0, n_ids, n_ops), rng.integers(1, 10_000, n_ops))]
        elif name == "leaderboard":
            ids = np.minimum(rng.zipf(1.2, n_ops) - 1, n_ids - 1)
            eff = [("add", (int(i), int(s))) for i, s in zip(ids, rng.integers(1, 10_000, n_ops))]
            eff += [("ban", int(i)) for i in rng.integers(0, n_ids, max(n_ops // 50, 1))]
        else:
            raise ValueError(f"no seeded ops for {name!r}")
        out.append(eff)
    return out


def seeded_states(name: str, n_states: int, seed: int, size: int = 10, **kw) -> List[Any]:
    """One state per replica, each built through `update` from
    `seeded_effects` (topk_rmv: `topk_rmv_effects` at a small size)."""
    eng = registry.scalar(name)
    if name == "topk_rmv":
        effects = topk_rmv_effects(n_states, kw.get("n_ids", 40), kw.get("n_ops", 60), kw.get("n_rmvs", 6), seed)
    else:
        effects = seeded_effects(name, n_states, seed, **kw)
    new = (lambda: eng.new(size)) if name in ("topk", "leaderboard", "topk_rmv") else eng.new
    return [apply_effects(name, new(), eff) for eff in effects]
