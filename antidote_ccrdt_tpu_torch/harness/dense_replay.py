"""Batched multi-DC replay over the dense engines (port of
``antidote_ccrdt_tpu/harness/dense_replay.py``).

Every replica (simulated DC) applies its own op batch in one call across
all replicas; reconciliation is a state-level exchange. For JOIN types
(topk_rmv) replica rows are full states in a join-semilattice: `sync`
folds the contributing rows with the CRDT join and broadcasts the result
back, so duplicated and reordered contributions are absorbed by
construction (`sync(contributors=...)` is the fault surface). MONOID
engines (delta rows on a shared base) are ported with their types.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import torch

from ..core.behaviour import MergeKind
from ..utils.metrics import Metrics


def map_state(fn, *states: Any) -> Any:
    """Apply `fn` leaf by leaf over dataclass states of one type."""
    first = states[0]
    return type(first)(
        **{
            f.name: fn(*(getattr(s, f.name) for s in states))
            for f in dataclasses.fields(first)
        }
    )


def _rows(state: Any, idx) -> Any:
    return map_state(lambda x: x[idx], state)


def fold_rows(dense: Any, state: Any, contributors: Sequence[int]) -> Any:
    """Fold the given replica rows (with repetition allowed) with the CRDT
    merge. `merge` is batched over the leading replica axis, so the tree
    reduction halves the whole stack at once: log2(n) merges in all."""
    idx = torch.as_tensor(list(contributors), dtype=torch.int64, device=state.vc.device)
    acc = _rows(state, idx)  # [C, ...]
    n = len(idx)
    while n > 1:
        half = n // 2
        merged = dense.merge(_rows(acc, slice(0, half)), _rows(acc, slice(half, 2 * half)))
        if n % 2:
            merged = map_state(
                lambda m, t: torch.cat([m, t], dim=0), merged, _rows(acc, slice(2 * half, n))
            )
        acc = merged
        n = half + n % 2
    return acc


def _broadcast_rows(folded: Any, n: int) -> Any:
    """Row 0 seen as n rows: a view (stride 0 on the replica axis), never
    written through — the engine's kernels read it through its stride
    (K1c) or the engine copies it first (K3's inputs)."""
    return map_state(lambda x: x[:1].expand((n,) + tuple(x.shape[1:])), folded)


class DenseReplay:
    """Round-based multi-DC pipeline over a dense JOIN engine.

    state layout: [n_replicas, n_keys, ...] — replica r's row is DC r. The
    state lives on the engine's device.
    """

    def __init__(
        self,
        dense: Any,
        n_replicas: int,
        n_keys: int = 1,
        metrics: Optional[Metrics] = None,
    ):
        if dense.merge_kind != MergeKind.JOIN:
            raise NotImplementedError(
                f"{type(dense).__name__}: only JOIN engines are ported so far"
            )
        self.dense = dense
        self.n = n_replicas
        self.nk = n_keys
        self.metrics = metrics if metrics is not None else Metrics()
        self.state = dense.init(n_replicas=n_replicas, n_keys=n_keys)
        self.extras_log: List[Any] = []

    def apply(self, ops: Any) -> Any:
        """Apply one op batch (replica r's ops in row r) locally at every
        replica in one call; collects the generated extras."""
        with self.metrics.timer("apply"):
            kwargs = getattr(self.dense, "replication_extras_kwargs", {})
            self.state, extras = self.dense.apply_ops(self.state, ops, **kwargs)
        if extras is not None:
            self.extras_log.append(extras)
        self.metrics.count("rounds")
        return extras

    def sync(self, contributors: Optional[Sequence[int]] = None) -> None:
        """Inter-DC reconciliation. `contributors` lists the replica rows
        whose contribution reaches the exchange (default: each exactly
        once); duplicates model duplicated delivery, omissions loss. An
        empty list (total loss) leaves every replica as it was."""
        if contributors is None:
            contributors = range(self.n)
        contributors = list(contributors)
        with self.metrics.timer("sync"):
            if contributors:
                folded = fold_rows(self.dense, self.state, contributors)
                self.state = _broadcast_rows(folded, self.n)
        self.metrics.count("syncs")

    def full_state(self) -> Any:
        """Per-replica effective state: the replica rows themselves."""
        return self.state

    def observe(self) -> Any:
        return self.dense.observe(self.full_state())

    def converged(self) -> bool:
        """All replicas report the same observable, bit for bit."""
        return all(bool((leaf == leaf[:1]).all()) for leaf in self.observe())
