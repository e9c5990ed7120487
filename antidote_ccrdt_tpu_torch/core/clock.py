"""Explicit, injectable replica identity + logical time.

The reference obtains both from ambient process state: ``?TIME:system_time/1``
and ``?DC_META_DATA:get_my_dc_id/0`` resolve to two gen_servers in test mode
(``src/mock_time.erl:59-62``, ``src/mock_dc_meta_data.erl:49-56``) and to
``erlang`` / Antidote's ``dc_meta_data_utilities`` in production
(``src/antidote_ccrdt_topk_rmv.erl:28-35``). That hidden state is the *only*
nondeterminism in the entire library.

Here both are plain values threaded through `ReplicaContext`, which makes
`downstream` a pure function of (op, state, ctx) — and therefore batchable:
a batch of timestamps is just an array the harness allocates up front.

A copy of ``antidote_ccrdt_tpu/core/clock.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Callable, Protocol, Tuple, runtime_checkable

DcId = int
Timestamp = int


@runtime_checkable
class ClockContext(Protocol):
    """What `downstream` actually requires of its context: a fresh
    (dc, ts) origin stamp. `ReplicaContext` is the standard provider; the
    bridge supplies `_FixedCtx` (caller-provided dc/ts over the wire —
    the host owns the clock there, as Antidote does), so the callback
    annotations use this Protocol, not the concrete class."""

    def stamp(self) -> Tuple[DcId, Timestamp]: ...


class LogicalClock:
    """Deterministic monotone clock: each `system_time()` call returns the
    next integer. Mirrors ``mock_time``'s gen_server counter
    (``mock_time.erl:59-62``: reply State+1, store State+1)."""

    def __init__(self, start: int = 0) -> None:
        self._t = start
        self._lock = threading.Lock()

    def system_time(self) -> Timestamp:
        with self._lock:
            self._t += 1
            return self._t

    def get_time(self) -> Timestamp:
        """Peek without advancing (``mock_time.erl:61-62``)."""
        return self._t


class WallClock:
    """Production clock: milliseconds since epoch, monotonicized. The
    reference's prod binding is ``erlang:system_time(milli_seconds)``."""

    def __init__(self) -> None:
        self._last = 0
        self._lock = threading.Lock()

    def system_time(self) -> Timestamp:
        with self._lock:
            now = time.time_ns() // 1_000_000
            self._last = max(self._last, now)
            return self._last

    def get_time(self) -> Timestamp:
        return self._last


@dataclasses.dataclass
class ReplicaContext:
    """Everything `downstream` may read besides (op, state).

    In the reference this is the pair of shim calls at
    ``antidote_ccrdt_topk_rmv.erl:104-105``. `dc_index` is the dense integer
    used by the array kernels (vector clocks are arrays indexed by DC);
    `dc_id` is the opaque identity used at the scalar level, kept separate so
    scalar states compare exactly like reference terms.
    """

    dc_id: DcId
    clock: LogicalClock
    dc_index: int = 0

    def stamp(self) -> Tuple[DcId, Timestamp]:
        """A fresh (dc, ts) origin stamp for an add op."""
        return (self.dc_id, self.clock.system_time())


def make_contexts(n_replicas: int, shared_clock: bool = True) -> list[ReplicaContext]:
    """Contexts for a simulated multi-DC deployment.

    shared_clock=True reproduces the reference test rig (one mock_time
    gen_server shared by every simulated DC), which yields globally unique
    timestamps; False gives each DC its own clock — realistic, and exercises
    the vc-domination logic harder (equal timestamps across DCs).
    """
    if shared_clock:
        clk = LogicalClock()
        return [ReplicaContext(dc_id=i, clock=clk, dc_index=i) for i in range(n_replicas)]
    return [
        ReplicaContext(dc_id=i, clock=LogicalClock(), dc_index=i)
        for i in range(n_replicas)
    ]
