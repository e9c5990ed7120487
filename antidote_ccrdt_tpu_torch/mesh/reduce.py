"""Intra-slice reconciliation as a collective over the mesh's dc axis.

Port of ``antidote_ccrdt_tpu/mesh/reduce.py``. The state is split into
the plan's blocks and every key column runs
``parallel.dist.lattice_all_reduce`` over its dc blocks — recursive
doubling whose combiner is the engine's own JOIN merge — so every
replica row becomes the join of its dc block in one call instead of N
gossip rounds. On a card each of those merges is the engine's merge on
the blocks' views (K3 for topk_rmv). The JAX package caches one jitted
program per (merge, plan, tree structure); the port has nothing to
compile and keeps no cache.

Correctness: the dc all-reduce replaces each replica row r with
join({rows in r's dc block}). JOIN merges are associative, commutative,
and idempotent, so (a) the reduce is itself idempotent — re-reducing a
reduced state is a no-op; (b) the observable state (fold of all rows)
is unchanged — the fold already joined every row; and (c) gossip
convergence arguments are untouched: peers exchange pre-joined rows and
the fleet fixpoint is still the global join. MONOID engines are
excluded (`supports`): + is not idempotent, so pre-summing rows that
gossip will sum again double-counts (the same reason psnaps refuse bare
monoids). MONOID reconciliation over the mesh is a `psum` — exposed as
`psum_reduce` — but it must consume disjoint op histories, which the
elastic worker's row-per-replica gossip does not provide.

Fault point: `mesh.reduce` fires before each collective (utils/faults.py).
The reduce is a pure optimization — callers treat an injected failure as
"skip this round's reduce" (`try_ici_reduce`), counting
`mesh.reduce_failures`; convergence falls back to plain gossip.
"""

from __future__ import annotations

from typing import Any, Optional

from ..obs import devprof, profile
from ..obs import spans as obs_spans
from ..parallel import dist
from ..utils import faults
from ..utils.tree import tree_map

SPAN_ICI = obs_spans.ICI_REDUCE  # "round.ici_reduce"


def _reduce_fn(dense: Any, plan: Any, state: Any):
    """The plan's dc all-reduce of `state`'s tree as one function."""
    merge = dense.merge
    specs = plan.specs(state)

    def blocks(grid):
        return dist.along(grid, plan.mesh, "dc", lambda col: dist.lattice_all_reduce(col, merge))

    return dist.shard_map(blocks, plan.mesh, (specs,), specs)


def supports(dense: Any) -> bool:
    """JOIN engines only — see the MONOID caveat in the module doc."""
    from ..core.behaviour import MergeKind
    from ..parallel.monoid import MonoidLift

    if isinstance(dense, MonoidLift):
        return False
    return getattr(dense, "merge_kind", None) != MergeKind.MONOID


def ici_reduce(
    dense: Any, plan: Any, state: Any, *, donate: bool = False,
    metrics: Optional[Any] = None,
) -> Any:
    """One batched JOIN all-reduce of `state` over the dc axis. May
    raise `faults.InjectedFault` (point `mesh.reduce`); a "drop" action
    skips the collective and returns the state unchanged. `donate` only
    names the JAX slot (``donate`` or ``plain``) in the devprof
    signature: the engine's merge writes no input."""
    if faults.ACTIVE:
        act = faults.fire("mesh.reduce")
        if act == "drop":
            if metrics is not None:
                metrics.count("mesh.reduce_skipped")
            return state
    state = plan.ensure_placed(state)
    fn = _reduce_fn(dense, plan, state)
    tok = (
        obs_spans.begin(SPAN_ICI, n_dc=plan.n_dc, n_key=plan.n_key)
        if obs_spans.ACTIVE
        else None
    )
    try:
        if profile.ACTIVE or devprof.ACTIVE:
            with profile.dispatch(
                "mesh.ici_reduce",
                fn=fn,
                operands=(state,),
                donation="donate" if donate else "plain",
            ):
                if metrics is not None:
                    with metrics.timer("mesh.ici_reduce"):
                        out = fn(state)
                else:
                    out = fn(state)
        elif metrics is not None:
            with metrics.timer("mesh.ici_reduce"):
                out = fn(state)
        else:
            out = fn(state)
    finally:
        obs_spans.end(tok)
    if metrics is not None:
        metrics.count("mesh.ici_reduces")
    return out


def try_ici_reduce(
    dense: Any, plan: Any, state: Any, *, donate: bool = False,
    metrics: Optional[Any] = None,
) -> Any:
    """Total variant: an injected/real reduce failure degrades to plain
    gossip (the reduce is an optimization, never load-bearing)."""
    try:
        return ici_reduce(
            dense, plan, state, donate=donate, metrics=metrics
        )
    except faults.InjectedFault:
        if metrics is not None:
            metrics.count("mesh.reduce_failures")
        return state


# -- MONOID psum (bench / dryrun parity) ------------------------------------


def psum_reduce(plan: Any, tree: Any) -> Any:
    """All-reduce a MONOID accumulator tree (leading axis = replica
    rows, sharded over dc) with `dist.psum` — the collective MONOID
    merges lower to when histories are disjoint. Bench surface only;
    the elastic worker path is JOIN-gated by `supports`."""

    def spec_of(leaf):
        dims = [None] * leaf.ndim
        if leaf.ndim and leaf.shape[0] % plan.n_dc == 0:
            dims[0] = "dc"
        while dims and dims[-1] is None:
            dims.pop()
        return dist.P(*dims)

    specs = tree_map(spec_of, tree)
    fn = dist.shard_map(
        lambda grid: dist.along(grid, plan.mesh, "dc", dist.psum),
        plan.mesh, (specs,), specs,
    )
    return fn(tree)
