"""Batched lattice-law checks + per-type law fixtures (port of
``antidote_ccrdt_tpu/ops/laws.py``).

Certified-MRDT-style machine checking (PAPERS.md: arxiv 2203.14518) of the
algebraic laws every replication mechanism leans on:

* merge commutativity + associativity for EVERY registered dense type;
* merge idempotence for JOIN types (MONOID states are deltas — merging a
  delta with itself legitimately double-counts);
* delta composition: ``apply_any_delta(dense, prev, make_delta(dense,
  prev, cur)) == cur`` for a chained (prev, cur) pair.

A fixture generates states with a [1, n] instance grid (each key cell an
independently-reached instance), so one ``merge`` checks n instance pairs.
Fixtures are registered on the type registry
(`core.behaviour.Registry.register(law_fixture=...)`); this module
registers the six built-in types' at import, with the JAX fixtures' seeded
numpy draws, so both packages check the same states. A fixture takes
``device=`` (default: the CUDA card); importing builds nothing.

`BrokenMergeDense` is the committed negative fixture: a deliberately
non-commutative merge the checker must flag.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.behaviour import MergeKind, registry
from ..device import DeviceLike, resolve_device
from ..utils.tree import as_numpy, leaves


def tree_equal(a: Any, b: Any) -> bool:
    """Exact leaf-wise equality of two identically-shaped states."""
    return all(bool((x == y).all()) for x, y in zip(leaves(a), leaves(b)))


def instance_mismatch(a: Any, b: Any) -> np.ndarray:
    """bool [R, NK] per-instance mismatch mask: every leaf reduced over
    its trailing axes onto the leading instance grid (leaves without the
    grid broadcast into every cell)."""
    leaves_a, leaves_b = leaves(a), leaves(b)
    grid: Optional[Tuple[int, int]] = next(
        (tuple(x.shape[:2]) for x in leaves_a if x.dim() >= 2), None
    )
    if grid is None:
        ne = any(not bool((x == y).all()) for x, y in zip(leaves_a, leaves_b))
        return np.asarray([[ne]])
    mask = np.zeros(grid, bool)
    for x, y in zip(leaves_a, leaves_b):
        ne = as_numpy(x != y)
        if ne.ndim >= 2 and ne.shape[:2] == grid:
            mask |= ne.reshape(grid[0], grid[1], -1).any(axis=-1)
        elif ne.any():
            mask |= True
    return mask


def check_engine_laws(
    dense: Any, states: List[Any], chain: Optional[Tuple[Any, Any]] = None
) -> Dict[str, Any]:
    """Machine-check the merge laws for one engine on >= 3 batched states.

    The verdict uses the engine's OWN equality (`dense.equal`) when it
    has one — topk_rmv's slot planes are canonical up to the engine's
    equality, not bit order — and exact tree equality otherwise. The
    per-instance failure count always comes from the tree mismatch mask,
    so a failing law names the first bad (replica, key) cell."""
    a, b, c = states[0], states[1], states[2]
    merge = dense.merge
    eng_eq = getattr(dense, "equal", None)

    def equal(x: Any, y: Any) -> bool:
        return bool(eng_eq(x, y)) if eng_eq is not None else tree_equal(x, y)

    ab = merge(a, b)
    pairs: Dict[str, Tuple[Any, Any]] = {
        "commutativity": (ab, merge(b, a)),
        "associativity": (merge(ab, c), merge(a, merge(b, c))),
    }
    if dense.merge_kind == MergeKind.JOIN:
        pairs["idempotence"] = (merge(a, a), a)
    if chain is not None:
        from ..parallel.delta import apply_any_delta, make_delta

        prev, cur = chain
        pairs["delta_composition"] = (apply_any_delta(dense, prev, make_delta(dense, prev, cur)), cur)

    n_instances = int(np.prod(leaves(a)[0].shape[:2]))
    laws: Dict[str, Any] = {}
    for law, (x, y) in pairs.items():
        ok = equal(x, y)
        entry: Dict[str, Any] = {"ok": ok, "instances": n_instances}
        if not ok:
            mask = instance_mismatch(x, y)
            bad = np.argwhere(mask)
            entry["failed_instances"] = int(mask.sum())
            if len(bad):
                entry["first_failure_rk"] = [int(v) for v in bad[0]]
        laws[law] = entry
    return {
        "type": getattr(dense, "type_name", type(dense).__name__),
        "merge_kind": dense.merge_kind.value,
        "n_instances": n_instances,
        "laws": laws,
        "ok": all(e["ok"] for e in laws.values()),
    }


# -- built-in fixtures -------------------------------------------------------
#
# fixture(seed, n, device=None) -> {"dense": engine, "states": [A, B, C],
# "chain": (prev, cur) | None}; every state is a [1, n] instance grid
# built by applying a seeded op batch, so all n pairs are reachable. The
# draws are the JAX fixtures', call for call.


def _on(dev: torch.device):
    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return t


def _states(d: Any, n: int, gen, **apply_kw) -> Dict[str, Any]:
    def st(s: int) -> Any:
        return d.apply_ops(d.init(1, n), gen(s), **apply_kw)[0]

    prev = st(0)
    cur, _ = d.apply_ops(prev, gen(7), **apply_kw)
    return {"dense": d, "states": [st(0), st(1), st(2)], "chain": (prev, cur)}


def _fx_topk(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    from ..models import topk as tk

    dev = resolve_device(device)
    t = _on(dev)
    d = tk.make_dense(n_ids=24, size=4, device=dev)

    def gen(s: int) -> Any:
        rng = np.random.default_rng(1000 * (seed + 1) + s)
        bsz = 4 * n
        return tk.TopkOps(
            key=t(rng.integers(0, n, bsz).astype(np.int32)[None]),
            id=t(rng.integers(0, 24, bsz).astype(np.int32)[None]),
            score=t(rng.integers(1, 500, bsz).astype(np.int32)[None]),
            valid=t(np.ones(bsz, bool)[None]),
        )

    return _states(d, n, gen)


def _fx_leaderboard(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    from ..models import leaderboard as lb

    dev = resolve_device(device)
    t = _on(dev)
    d = lb.make_dense(n_players=24, size=4, device=dev)

    def gen(s: int) -> Any:
        rng = np.random.default_rng(2000 * (seed + 1) + s)
        bsz, bb = 4 * n, max(4, n // 2)
        return lb.LeaderboardOps(
            add_key=t(rng.integers(0, n, bsz).astype(np.int32)[None]),
            add_id=t(rng.integers(0, 24, bsz).astype(np.int32)[None]),
            add_score=t(rng.integers(1, 500, bsz).astype(np.int32)[None]),
            add_valid=t(np.ones(bsz, bool)[None]),
            ban_key=t(rng.integers(0, n, bb).astype(np.int32)[None]),
            ban_id=t(rng.integers(0, 24, bb).astype(np.int32)[None]),
            ban_valid=t((rng.random(bb) < 0.5)[None]),
        )

    return _states(d, n, gen)


def _fx_wordcount(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    from ..models import wordcount as wc

    dev = resolve_device(device)
    t = _on(dev)
    d = wc.make_dense(n_buckets=32, device=dev)

    def gen(s: int) -> Any:
        rng = np.random.default_rng(3000 * (seed + 1) + s)
        bsz = 6 * n
        # Tokens beyond the table (>= 32) exercise the lost-counter
        # monoid leaf too.
        return wc.WordcountOps(
            key=t(rng.integers(0, n, bsz).astype(np.int32)[None]),
            token=t(rng.integers(0, 40, bsz).astype(np.int32)[None]),
        )

    return _states(d, n, gen)


def _fx_average(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    from ..models.average import AverageDense, AverageOps

    dev = resolve_device(device)
    t = _on(dev)
    d = AverageDense(device=dev)

    def gen(s: int) -> Any:
        rng = np.random.default_rng(4000 * (seed + 1) + s)
        bsz = 4 * n
        return AverageOps(
            key=t(rng.integers(0, n, bsz).astype(np.int32)[None]),
            value=t(rng.integers(-50, 50, bsz).astype(np.int32)[None]),
            count=t(rng.integers(0, 5, bsz).astype(np.int32)[None]),
        )

    return _states(d, n, gen)


def _fx_topk_rmv(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    from ..models.topk_rmv_dense import TopkRmvOps, make_dense

    dev = resolve_device(device)
    t = _on(dev)
    i_, dcs = 16, 3
    d = make_dense(n_ids=i_, n_dcs=dcs, size=4, slots_per_id=3, device=dev)

    def gen(s: int) -> Any:
        rng = np.random.default_rng(5000 * (seed + 1) + s)
        bsz, br = 4 * n, max(4, n // 2)
        r_vc = np.zeros((1, br, dcs), np.int32)
        r_vc[0, :, rng.integers(0, dcs)] = rng.integers(1, 200, br)
        return TopkRmvOps(
            add_key=t(rng.integers(0, n, bsz).astype(np.int32)[None]),
            add_id=t(rng.integers(0, i_, bsz).astype(np.int32)[None]),
            add_score=t(rng.integers(1, 500, bsz).astype(np.int32)[None]),
            add_dc=t(rng.integers(0, dcs, bsz).astype(np.int32)[None]),
            add_ts=t(rng.integers(1, 1000, bsz).astype(np.int32)[None]),
            rmv_key=t(rng.integers(0, n, br).astype(np.int32)[None]),
            rmv_id=t(rng.integers(0, i_, br).astype(np.int32)[None]),
            rmv_vc=t(r_vc),
        )

    return _states(d, n, gen, collect_dominated=False)


# -- the committed negative fixture ------------------------------------------


class BrokenMergeDense:
    """A deliberately NON-commutative, NON-associative 'engine' whose
    merge is ``2a - b``. It is idempotent (``2a - a == a``) on purpose:
    the checker must flag the specific broken laws, not just any law.
    Never registered on the global registry."""

    type_name = "broken_merge_fixture"
    merge_kind = MergeKind.JOIN

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int) -> Dict[str, torch.Tensor]:
        return {"x": torch.zeros((n_replicas, n_keys), dtype=torch.int32, device=self.device)}

    def merge(self, a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"x": 2 * a["x"] - b["x"]}


def broken_merge_fixture(seed: int, n: int, device: DeviceLike = None) -> Dict[str, Any]:
    d = BrokenMergeDense(device=device)
    t = _on(d.device)

    def st(lo: int, hi: int) -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng(6000 * (seed + 1) + lo)
        # Disjoint value ranges guarantee a != b somewhere, so the
        # commutativity failure is deterministic, never seed-luck.
        return {"x": t(rng.integers(lo, hi, (1, n)).astype(np.int32))}

    return {"dense": d, "states": [st(1, 100), st(100, 200), st(200, 300)], "chain": None}


# -- registration ------------------------------------------------------------

_BUILTIN_FIXTURES = {
    "topk": _fx_topk,
    "leaderboard": _fx_leaderboard,
    "wordcount": _fx_wordcount,
    "worddocumentcount": _fx_wordcount,
    "average": _fx_average,
    "topk_rmv": _fx_topk_rmv,
}

for _name, _fx in _BUILTIN_FIXTURES.items():
    registry.register(_name, law_fixture=_fx)
del _name, _fx
