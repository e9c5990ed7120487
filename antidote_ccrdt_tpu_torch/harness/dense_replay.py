"""Batched multi-DC replay over the dense engines (port of
``antidote_ccrdt_tpu/harness/dense_replay.py``).

Every replica (simulated DC) applies its own op batch in one call across
all replicas; reconciliation is a state-level exchange whose protocol
depends on the type's merge algebra (`MergeKind`):

* **JOIN** (topk, topk_rmv, leaderboard): replica rows are full states in
  a join-semilattice; `sync` folds the contributing rows with the CRDT
  join and broadcasts the result back, so duplicated and reordered
  contributions are absorbed by construction.
* **MONOID** (average, wordcount, worddocumentcount): replica rows are
  *deltas* accumulated since the last sync; `sync` folds them onto a
  shared one-row base and resets them — exactly-once by construction, and
  a duplicated contribution measurably double-counts (the dual fault
  surface).

`sync(contributors=...)` is the delivery fault surface: duplicates model
duplicated delivery, omissions loss.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from ..core.behaviour import MergeKind
from ..utils.metrics import Metrics
from ..utils.tree import leaves, tree_map


def _rows(state: Any, idx) -> Any:
    return tree_map(lambda x: x[idx], state)


def fold_rows(dense: Any, state: Any, contributors: Sequence[int]) -> Any:
    """Fold the given replica rows (with repetition allowed) with the CRDT
    merge. `merge` is batched over the leading replica axis, so the tree
    reduction halves the whole stack at once: log2(n) merges in all. The
    row index lives on the device of the state's first leaf."""
    dev = leaves(state)[0].device
    idx = torch.as_tensor(list(contributors), dtype=torch.int64, device=dev)
    acc = _rows(state, idx)  # [C, ...]
    n = len(idx)
    while n > 1:
        half = n // 2
        merged = dense.merge(_rows(acc, slice(0, half)), _rows(acc, slice(half, 2 * half)))
        if n % 2:
            merged = tree_map(
                lambda m, t: torch.cat([m, t], dim=0), merged, _rows(acc, slice(2 * half, n))
            )
        acc = merged
        n = half + n % 2
    return acc


def _broadcast_rows(folded: Any, n: int) -> Any:
    """Row 0 seen as n rows: a view (stride 0 on the replica axis), never
    written through — the engine's kernels read it through its stride
    (K1c) or the engine copies it first (K3's inputs)."""
    return tree_map(lambda x: x[:1].expand((n,) + tuple(x.shape[1:])), folded)


class DenseReplay:
    """Round-based multi-DC pipeline over a dense engine.

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
        self.dense = dense
        self.n = n_replicas
        self.nk = n_keys
        self.metrics = metrics if metrics is not None else Metrics()
        if dense.merge_kind == MergeKind.MONOID:
            # base: the converged state as of the last sync (one row,
            # broadcast on read); rows of `state` are per-replica deltas.
            self.base = dense.init(n_replicas=1, n_keys=n_keys)
        else:
            self.base = None
        self.state = dense.init(n_replicas=n_replicas, n_keys=n_keys)
        self.extras_log: List[Any] = []

    # -- local application -------------------------------------------------

    def apply(self, ops: Any, report_drops: bool = False) -> Any:
        """Apply one op batch (replica r's ops in row r) locally at every
        replica in one call; collects the generated extras.

        `report_drops` counts the ops the engine will drop silently
        (``utils.validate.topk_rmv_drop_report``) into this replay's
        metrics, padding apart from genuine out-of-range garbage: wire an
        alarm on ``ops_dropped_out_of_range`` to catch a corrupted feed."""
        if report_drops and hasattr(ops, "rmv_vc"):
            from ..utils.validate import topk_rmv_drop_report

            rep = topk_rmv_drop_report(self.dense, self.state, ops)
            self.metrics.count(
                "ops_dropped_out_of_range",
                rep["add_dropped_out_of_range"] + rep["rmv_dropped_out_of_range"],
            )
            self.metrics.count("ops_padding", rep["add_padding"] + rep["rmv_padding"])
        with self.metrics.timer("apply"):
            kwargs = getattr(self.dense, "replication_extras_kwargs", {})
            self.state, extras = self.dense.apply_ops(self.state, ops, **kwargs)
        if extras is not None:
            self.extras_log.append(extras)
        self.metrics.count("rounds")
        return extras

    def apply_coalesced(self, ops_list: Sequence[Any], **coalesce_kw: Any) -> Any:
        """Whole-log compaction as a pre-apply pass: fuse several op
        batches into one compacted batch via the engine's `coalesce_ops`
        (reference: the host compacts its log before shipping,
        antidote_ccrdt.erl:55-56), then apply it as a single round.

        Compaction deletes dominated adds, so their re-broadcast extras are
        not generated — use on logs whose dominated extras are not consumed
        (see ops.compaction.coalesce_topk_rmv_ops)."""
        coalesce = getattr(self.dense, "coalesce_ops", None)
        if coalesce is None:
            raise TypeError(
                f"{type(self.dense).__name__} does not support batch "
                "coalescing (no coalesce_ops)"
            )
        with self.metrics.timer("coalesce"):
            ops, n_add, n_rmv = coalesce(ops_list, **coalesce_kw)
        self.metrics.count("coalesce_ops_in", sum(
            o.add_key.shape[0] * (o.add_key.shape[1] + o.rmv_key.shape[1])
            for o in ops_list
        ))
        self.metrics.count("coalesce_ops_out", int(n_add.sum() + n_rmv.sum()))
        return self.apply(ops)

    # -- reconciliation ----------------------------------------------------

    def sync(self, contributors: Optional[Sequence[int]] = None) -> None:
        """Inter-DC reconciliation. `contributors` lists the replica rows
        whose contribution reaches the exchange (default: each exactly
        once). JOIN types absorb duplicates (idempotent join); MONOID
        types double-count them. An empty list (total loss): JOIN replicas
        keep their local state; MONOID replicas have shipped (and lost)
        their deltas, the base unchanged."""
        if contributors is None:
            contributors = range(self.n)
        contributors = list(contributors)
        monoid = self.dense.merge_kind == MergeKind.MONOID
        with self.metrics.timer("sync"):
            if not contributors:
                if monoid:
                    self.state = self.dense.init(n_replicas=self.n, n_keys=self.nk)
            elif not monoid:
                folded = fold_rows(self.dense, self.state, contributors)
                self.state = _broadcast_rows(folded, self.n)
            else:
                summed = fold_rows(self.dense, self.state, contributors)
                self.base = self.dense.merge(self.base, summed)
                self.state = self.dense.init(n_replicas=self.n, n_keys=self.nk)
        self.metrics.count("syncs")

    # -- observation -------------------------------------------------------

    def full_state(self) -> Any:
        """Per-replica effective state: deltas on top of the shared base
        for MONOID types, the replica rows themselves for JOIN types."""
        if self.base is None:
            return self.state
        return self.dense.merge(_broadcast_rows(self.base, self.n), self.state)

    def observe(self) -> Any:
        return self.dense.observe(self.full_state())

    def converged(self, atol: float = 0.0) -> bool:
        """All replicas report the same observable (bitwise by default;
        atol > 0 allows absolute float slack, with no relative component —
        a silent rtol would mask exactly the small divergences the fault
        tests exist to catch)."""
        obs = self.observe()
        for leaf in leaves(tuple(obs) if isinstance(obs, (tuple, list)) else (obs,)):
            if atol > 0.0 and leaf.dtype.is_floating_point:
                if not bool((((leaf - leaf[:1]).abs() <= atol) | (leaf == leaf[:1])).all()):
                    return False
            elif not bool((leaf == leaf[:1]).all()):
                return False
        return True
