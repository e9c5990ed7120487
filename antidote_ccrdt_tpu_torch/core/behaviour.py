"""The CCRDT behaviour contract (port of
``antidote_ccrdt_tpu/core/behaviour.py``).

Two levels, as in the JAX package:

* **Scalar level** (`ScalarCCRDT`): one CRDT instance, one op at a time,
  pure Python, the reference's 12 callbacks (``antidote_ccrdt.erl:47-59``).
  The port keeps its own copies of the JAX package's scalar models.
* **Dense level** (`DenseCCRDT`): states are dataclasses of tensors with
  leading batch axes ``[n_replicas, n_keys, ...]``; ``apply_ops`` and
  ``merge`` process every (replica, key) instance in one call.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, Iterable, Optional, Protocol, Tuple, runtime_checkable

from .clock import ClockContext

# A prepare-side operation submitted by a client, e.g. ("add", (id, score)).
PrepareOp = Tuple[str, Any]
# A downstream effect op, e.g. ("add", (id, score, (dc, ts))).
EffectOp = Tuple[str, Any]


class MergeKind(enum.Enum):
    """Algebra of the dense `merge` operator.

    JOIN: idempotent join-semilattice — merging full replica states is safe
        under duplication and reordering (topk, topk_rmv, leaderboard).
    MONOID: non-idempotent commutative monoid — per-replica states are
        deltas merged exactly once (average, wordcount, worddocumentcount).
    """

    JOIN = "join"
    MONOID = "monoid"


@runtime_checkable
class ScalarCCRDT(Protocol):
    """Single-instance, single-op semantics, the reference's callbacks.
    Replica identity and time come in through a `ClockContext`."""

    type_name: str

    def new(self, *args: Any) -> Any: ...

    def value(self, state: Any) -> Any: ...

    def downstream(self, op: PrepareOp, state: Any, ctx: ClockContext) -> Optional[EffectOp]:
        """The effect op of a prepare op at its origin; None when it cannot
        change any replica (the reference's ``{ok, noop}``)."""
        ...

    def update(self, effect: EffectOp, state: Any) -> Tuple[Any, list]:
        """(new_state, extra effect ops to re-ship), the list always present."""
        ...

    def require_state_downstream(self, op: PrepareOp) -> bool: ...

    def is_operation(self, op: Any) -> bool: ...

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool: ...

    def compact_ops(self, e1: EffectOp, e2: EffectOp) -> Tuple[Optional[EffectOp], Optional[EffectOp]]:
        """Pairwise op-log compaction; None marks a deleted slot."""
        ...

    def is_replicate_tagged(self, effect: EffectOp) -> bool: ...

    def equal(self, a: Any, b: Any) -> bool: ...

    def to_binary(self, state: Any) -> bytes: ...

    def from_binary(self, data: bytes) -> Any: ...


@runtime_checkable
class DenseCCRDT(Protocol):
    """Batched dense semantics: states whose tensors carry leading axes
    ``[n_replicas, n_keys, ...]``."""

    type_name: str
    merge_kind: MergeKind

    def init(self, n_replicas: int, n_keys: int) -> Any: ...

    def apply_ops(self, state: Any, ops: Any) -> Tuple[Any, Any]:
        """Apply one [n_replicas, batch] op batch; (new_state, extras)."""
        ...

    def merge(self, a: Any, b: Any) -> Any:
        """Two-way merge with `merge_kind` algebra."""
        ...

    def observe(self, state: Any) -> Any: ...


class Registry:
    """Type registry: the rebuild of ``antidote_ccrdt:is_type/1`` and
    ``generates_extra_operations/1`` (``antidote_ccrdt.erl:61-65``). Dense
    engines are built by factories that take ``device=``; the JAX
    package's import-time engine singletons have no counterpart (an
    engine built at import would resolve the card at import)."""

    def __init__(self) -> None:
        self._scalar: Dict[str, ScalarCCRDT] = {}
        self._dense_factory: Dict[str, Any] = {}
        self._extra_ops: set = set()
        self._law_fixture: Dict[str, Any] = {}

    def register(
        self,
        name: str,
        scalar: Optional[ScalarCCRDT] = None,
        dense_factory: Optional[Any] = None,
        generates_extra_operations: bool = False,
        law_fixture: Optional[Any] = None,
    ) -> None:
        if scalar is not None:
            self._scalar[name] = scalar
        if dense_factory is not None:
            self._dense_factory[name] = dense_factory
        if generates_extra_operations:
            self._extra_ops.add(name)
        if law_fixture is not None:
            self._law_fixture[name] = law_fixture

    def is_type(self, name: Any) -> bool:
        return isinstance(name, str) and (name in self._scalar or name in self._dense_factory)

    def generates_extra_operations(self, name: Any) -> bool:
        return self.is_type(name) and name in self._extra_ops

    def scalar(self, name: str) -> ScalarCCRDT:
        return self._scalar[name]

    def make_dense(self, name: str, **params: Any) -> Any:
        """Construct a dense engine with explicit capacities. ``device``
        (default: the CUDA card, raising without one) is one of the
        params."""
        return self._dense_factory[name](**params)

    def scalar_types(self) -> Iterable[str]:
        return self._scalar.keys()

    def dense_types(self) -> Iterable[str]:
        return set(self._dense_factory)

    # -- lattice-law audit hooks --------------------------------------------
    # A law fixture is `fn(seed, n, device=None) -> {"dense": engine,
    # "states": [A, B, C], "chain": (prev, cur) | None}` generating
    # REACHABLE batched states (a [1, n] instance grid built from real op
    # applications) for the merge/delta law checker in ops/laws.py, on
    # `device` (default: the CUDA card). Types without a fixture are
    # reported as unaudited.

    def law_fixture(self, name: str) -> Optional[Any]:
        return self._law_fixture.get(name)

    def law_fixtures(self) -> Dict[str, Any]:
        return dict(self._law_fixture)


registry = Registry()
