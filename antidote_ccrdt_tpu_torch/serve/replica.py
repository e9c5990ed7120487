"""Device-resident read replica: double-buffered snapshots of merged state.

The write path (sweeps, ingest folds) replaces the worker's carried state
round by round — holding a bare reference to it from a concurrent reader
thread would race the next round's writes. The replica therefore owns
its buffers outright: `swap` runs one whole-tree device copy
(`core.batch_merge.snapshot_state`, on the device of the state) and
publishes the copy by atomic reference flip into a two-slot ring.
Readers grab the live slot without any lock on the query hot path;
the previous slot stays intact until the swap after next, so a query
mid-answer on the old snapshot never sees a freed buffer either.

Each snapshot carries its staleness pedigree, stamped at swap time on
the worker's OWN monotonic clock:

* ``seq``          the publish seq this snapshot reflects (`as_of_seq`);
* ``swap_mono``    when the copy was taken;
* ``lag_bound_s``  the worker's replication-lag bound at that instant
                   (max over peers of lag seconds + staleness seconds,
                   from `obs.lag.LagTracker`) — how far behind the
                   fleet's writes this state could already have been
                   WHEN it was captured.

`ServePlane` turns the pair into the advertised
``staleness_bound_s = (now - swap_mono) + lag_bound_s``: every term is
a difference of one process's monotonic clock, so cross-host clock skew
cannot shrink the bound (tests/test_serve_staleness.py pins this under
asymmetric simulated skew).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

import torch

from ..core import batch_merge
from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..utils.tree import leaves


class Snapshot:
    """One immutable read-replica buffer plus its staleness pedigree.

    ``view`` is the lazily-attached host materialization
    (`serve.kernels.SnapshotView`) — None until the first query against
    this snapshot forces it (that miss/hit split is the snapshot cache).
    """

    __slots__ = ("state", "seq", "swap_mono", "lag_bound_s", "view")

    def __init__(self, state: Any, seq: int, swap_mono: float, lag_bound_s: float):
        self.state = state
        self.seq = int(seq)
        self.swap_mono = float(swap_mono)
        self.lag_bound_s = float(lag_bound_s)
        self.view: Any = None


class ReadReplica:
    """Two-slot snapshot ring: `swap` publishes, `live` reads lock-free."""

    def __init__(
        self,
        metrics: Any = None,
        mono: Callable[[], float] = time.monotonic,
    ):
        self.metrics = metrics
        self.mono = mono  # injectable: sim drills pass the skewed virtual clock
        self._swap_lock = threading.Lock()
        self._bufs: list = [None, None]
        self._live = 0

    def swap(
        self,
        state: Any,
        seq: int,
        lag_bound_s: float = 0.0,
        resolve: Optional[Callable[[Any], Any]] = None,
    ) -> Snapshot:
        """Copy `state` to a fresh device buffer and make it the live
        snapshot. Called from the worker's round thread at publish
        boundaries; queries racing the swap keep reading the old slot
        until the single reference flip below. `resolve` maps the carried
        state to the logical state first — the pager hook (`full_state`)
        joins demoted partitions back in so reads never see a hole."""
        tok = (
            obs_spans.begin("round.serve_swap", seq=int(seq))
            if obs_spans.ACTIVE
            else None
        )
        try:
            if resolve is not None:
                state = resolve(state)
            with self._swap_lock:
                snap = Snapshot(
                    batch_merge.snapshot_state(state),
                    seq,
                    self.mono(),
                    lag_bound_s,
                )
                idx = 1 - self._live
                self._bufs[idx] = snap
                self._live = idx  # the atomic publish: readers see old or new
        finally:
            obs_spans.end(tok)
        if self.metrics is not None:
            self.metrics.count("serve.swaps")
            # Mesh-sharded states: the snapshot copy keeps each leaf's
            # sharding (core.batch_merge.snapshot_state), so the replica
            # holds per-device shards, never a gathered whole — gauge how
            # many logical devices the live snapshot spans (one for an
            # unsharded tensor) so the obs plane can prove reads stayed
            # shard-resident.
            leaf = next(iter(leaves(snap.state)), None)
            if isinstance(leaf, torch.Tensor):
                sharding = getattr(leaf, "sharding", None)
                self.metrics.set(
                    "serve.replica_shards",
                    float(len(sharding.device_set)) if sharding is not None else 1.0,
                )
        obs_events.emit(
            "serve.swap", seq=snap.seq, lag_bound_s=round(snap.lag_bound_s, 6)
        )
        return snap

    def live(self) -> Optional[Snapshot]:
        """The current snapshot (None before the first swap). Lock-free:
        one list read of a slot only `swap` reassigns."""
        return self._bufs[self._live]

    def previous(self) -> Optional[Snapshot]:
        """The snapshot one swap back (still intact — its buffers are
        only reused by the swap after next)."""
        return self._bufs[1 - self._live]
