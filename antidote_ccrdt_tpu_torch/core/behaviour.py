"""The dense half of the CCRDT behaviour contract (port of
``antidote_ccrdt_tpu/core/behaviour.py``).

Dense states are dataclasses of tensors with leading batch axes
``[n_replicas, n_keys, ...]``; ``apply_ops`` and ``merge`` process every
(replica, key) instance in one call. The scalar half (one instance, one
op at a time) is ported with the batch_merge slice.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Iterable


class MergeKind(enum.Enum):
    """Algebra of the dense `merge` operator.

    JOIN: idempotent join-semilattice — merging full replica states is safe
        under duplication and reordering (topk, topk_rmv, leaderboard).
    MONOID: non-idempotent commutative monoid — per-replica states are
        deltas merged exactly once (average, wordcount, worddocumentcount).
    """

    JOIN = "join"
    MONOID = "monoid"


class Registry:
    """Dense type registry: the rebuild of ``antidote_ccrdt:is_type/1``
    for the engines ported so far."""

    def __init__(self) -> None:
        self._dense_factory: Dict[str, Any] = {}

    def register(self, name: str, dense_factory: Any) -> None:
        self._dense_factory[name] = dense_factory

    def is_type(self, name: Any) -> bool:
        return isinstance(name, str) and name in self._dense_factory

    def make_dense(self, name: str, **params: Any) -> Any:
        """Construct a dense engine with explicit capacities. ``device``
        (default: the CUDA card, raising without one) is one of the
        params."""
        return self._dense_factory[name](**params)

    def dense_types(self) -> Iterable[str]:
        return set(self._dense_factory)


registry = Registry()
