"""Multi-DC replay: the harness that stands in for the Antidote host.

The reference library delegates replication to its host and only *documents*
the delivery contract — effect ops delivered causally, exactly once
(SURVEY.md §1). This module simulates that host for N replicas:

* `ScalarReplay` — the faithful op-based pipeline over the scalar types:
  prepare ops hit `downstream` at their origin replica, effect ops are
  queued to every replica and applied via `update` in causal order; extra
  ops generated by `update` are applied locally at each replica (each
  replica derives the same extras deterministically, and re-applying them is
  idempotent — they exist for hosts that prune non-observable ops).
  Doubles as the CPU/"BEAM stand-in" benchmark baseline.

* `FaultInjector` — drop / duplicate / reorder at the delivery layer, to
  demonstrate which guarantees each path needs: the op-based pipeline
  *requires* causal exactly-once (faults break convergence — the reference's
  implicit assumption made load-bearing), while the dense JOIN lattice path
  shrugs off duplication and reordering by construction.

* `check_convergence` — pairwise observable equality across replicas, the
  generalization of delete_semantics_test (topk_rmv.erl:572-593).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core.behaviour import ScalarCCRDT
from ..core.clock import make_contexts
from ..utils.metrics import Metrics


@dataclasses.dataclass
class FaultInjector:
    """Delivery-layer fault model. Applied per (op, destination replica)."""

    drop_prob: float = 0.0
    dup_prob: float = 0.0
    reorder_window: int = 0  # max positions an op may be delayed past later ops
    seed: int = 0

    def __post_init__(self) -> None:
        # One generator for the injector's lifetime: each (delivery, replica)
        # draws fresh randomness, so faults are uncorrelated across replicas
        # and sync rounds.
        self._rng = np.random.default_rng(self.seed)

    def transform(self, deliveries: List[Any]) -> List[Any]:
        rng = self._rng
        out: List[Any] = []
        for op in deliveries:
            if self.drop_prob and rng.random() < self.drop_prob:
                continue
            out.append(op)
            if self.dup_prob and rng.random() < self.dup_prob:
                out.append(op)
        if self.reorder_window > 1 and len(out) > 1:
            idx = np.arange(len(out), dtype=float)
            idx += rng.uniform(0, self.reorder_window, size=len(out))
            out = [out[i] for i in np.argsort(idx, kind="stable")]
        return out


class ScalarReplay:
    """Op-based multi-master replay over a scalar CCRDT type."""

    def __init__(
        self,
        crdt: ScalarCCRDT,
        n_replicas: int,
        new_args: tuple = (),
        faults: Optional[FaultInjector] = None,
        metrics: Optional[Metrics] = None,
    ):
        self.crdt = crdt
        self.n = n_replicas
        self.ctxs = make_contexts(n_replicas)
        self.states = [crdt.new(*new_args) for _ in range(n_replicas)]
        self.faults = faults
        self.effect_log: List[Tuple[int, Any]] = []  # (origin, effect)
        self.ops_applied = 0
        self.metrics = metrics if metrics is not None else Metrics()

    def submit(self, origin: int, prepare_op: Any) -> Optional[Any]:
        """Client submits a prepare op at `origin`: run downstream there,
        apply locally, and queue the effect for the other replicas."""
        eff = self.crdt.downstream(prepare_op, self.states[origin], self.ctxs[origin])
        if eff is None:
            return None
        self._apply(origin, eff)
        self.effect_log.append((origin, eff))
        return eff

    def _apply(self, replica: int, effect: Any) -> None:
        state, extras = self.crdt.update(effect, self.states[replica])
        self.ops_applied += 1
        # Extra ops re-enter the pipeline locally (deterministic at every
        # replica; idempotent to re-apply).
        while extras:
            nxt = []
            for e in extras:
                state, more = self.crdt.update(e, state)
                self.ops_applied += 1
                nxt.extend(more)
            extras = nxt
        self.states[replica] = state

    def sync(self) -> None:
        """Deliver every queued effect to every non-origin replica, in
        causal (generation) order, through the fault injector if any."""
        before = self.ops_applied
        with self.metrics.timer("sync"):
            for r in range(self.n):
                deliveries = [eff for (origin, eff) in self.effect_log if origin != r]
                if self.faults is not None:
                    deliveries = self.faults.transform(deliveries)
                for eff in deliveries:
                    self._apply(r, eff)
            self.effect_log.clear()
        self.metrics.count("merges", self.ops_applied - before)
        self.metrics.count("syncs")

    def run(self, stream) -> None:
        for origin, op in stream:
            self.submit(origin, op)
        self.sync()

    def values(self) -> list:
        return [self.crdt.value(s) for s in self.states]

    def converged(self) -> bool:
        return check_convergence(self.crdt, self.states)


def check_convergence(crdt: ScalarCCRDT, states: Sequence[Any]) -> bool:
    """Pairwise observable equality (the reference's `equal/2` semantics)."""
    return all(crdt.equal(states[0], s) for s in states[1:])
