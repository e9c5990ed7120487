"""Elastic membership: failure detection + join-based gossip anti-entropy.

SURVEY.md §5 marks "failure detection / elastic recovery" absent in the
reference (delegated to the Antidote host). This module is that tier,
built the CRDT way rather than the collective way:

* `parallel.multihost` (over ``torch.distributed``) and `parallel.dist`
  are the FAST path — collectives. Collectives need a fixed, fully-alive
  world: a dead peer hangs the program, and a process group cannot
  shrink without a restart.
* This module is the FAILURE-TOLERANT path: members exchange whole
  lattice states through a shared store (filesystem here; the transport
  is a trivial read/write interface, so object stores or RPC slot in).
  Because every dense state is a join-semilattice (merge is associative,
  commutative, idempotent — tests/test_properties.py pins the laws),
  gossip needs none of the machinery fragile systems need: a stale
  snapshot merges harmlessly, a duplicated op batch re-applied after
  recovery dedups in the join, and membership can change between any two
  sweeps. Recovery is literally "merge the dead member's last published
  state and keep going".

Pieces:
* `GossipStore` — publish/fetch member snapshots + heartbeats in a
  shared directory (atomic rename writes; `harness.checkpoint` format).
  Since the net/ tier it is the filesystem INSTANCE of the pluggable
  transport surface: `net.transport.GossipNode` over `FsTransport`.
  Every entry point below takes any `GossipNode` — sockets
  (`net.tcp.TcpTransport`) and the deterministic chaos simulator
  (`net.sim.SimTransport`) gossip through the same code paths.
* `alive_members` / `owners` — timeout failure detector + the
  deterministic replica→member assignment everyone recomputes from the
  alive set alone (no coordinator, no consensus: ownership only affects
  WHO applies ops; overlap during a membership transition is safe by
  idempotence).
* `sweep` — fold every peer's latest snapshot into the local state with
  the engine join.

The serial sweep path here is also the contract the overlapped round
pipeline (`parallel/overlap.py`) decomposes: its `DeltaPrefetcher`
runs this module's fetch+validate+decode half (`sweep_deltas`' chain
walk, `_resolve_monoid`'s lift discipline) ahead of the round on its own
thread, and the round thread folds the pre-expanded results through
`core.batch_merge`. Convergence is mode-independent — both paths apply
the same joins — which tests/test_overlap.py pins bit-identically.

The real-process drill (3 workers, one killed mid-run, survivors detect,
adopt its replicas, converge to the sequential reference) lives in
scripts/elastic_demo.py + tests/test_elastic.py.

Port of ``antidote_ccrdt_tpu/parallel/elastic.py``: the same blobs,
counters, events and draws. Every join goes through the port's
``parallel.delta.apply_any_delta`` and the engine's ``merge``, so on a
card a sweep runs the engine's kernels (K3 for topk_rmv) on states that
``core.serial.loads_dense`` decoded onto the card. With a
``core.pager.PartitionPager`` (``pager=``), anchors publish the logical
state, digests and psnaps of cold partitions come from the pager, and
payloads touching cold partitions fold host-side. With a
``mesh.MeshPlan`` (``mesh_plan=``), anchors produce digests and psnaps
shard by shard and partial repairs fetch shard by shard.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..net.transport import FsTransport, GossipNode
from ..obs import devprof
from ..obs import events as obs_events
from ..obs import profile
from ..obs import spans as obs_spans
from ..utils.metrics import Metrics
from .delta import empty_delta  # noqa: F401 — part of this module's API


# Ingest fast-path knobs. CCRDT_INGEST_COMPACT=0 is the bit-identical
# kill switch: deferred publishes ship immediately, one frame per window,
# exactly the pre-compaction wire trace. CCRDT_INGEST_COALESCE caps how
# many consecutive pending windows a publisher fuses into one frame.
ENV_COMPACT = "CCRDT_INGEST_COMPACT"
ENV_COALESCE = "CCRDT_INGEST_COALESCE"
_FALSE = ("0", "false", "no", "off")


def compact_enabled() -> bool:
    return os.environ.get(ENV_COMPACT, "1").strip().lower() not in _FALSE


def coalesce_max() -> int:
    try:
        v = int(os.environ.get(ENV_COALESCE, "4"))
    except ValueError:
        return 4
    return max(1, v)


class GossipStore(GossipNode):
    """Shared-directory gossip node (the historical name and constructor,
    kept so no caller breaks): `GossipNode` over `net.transport
    .FsTransport`. See net/transport.py for the file layout and the
    timestamp-payload heartbeat format."""

    def __init__(self, root: str, member: str, metrics: Optional[Metrics] = None):
        super().__init__(FsTransport(root, member, metrics=metrics))
        self.root = root


class DeltaPublisher:
    """Publish a member's state as chained deltas with periodic full
    snapshots (the classic delta-CRDT shipping discipline: deltas for
    bandwidth, full states as the resync anchor). Engine-generic via
    `parallel.delta.make_delta`: slot deltas for topk_rmv, entrywise for
    the table engines, self-contained row-replace deltas for MONOID
    engines through the versioned-row lift (`parallel.monoid` — a raw
    monoid engine is auto-wrapped; states must be `LiftedMonoidState`,
    enforced at the first publish)."""

    def __init__(
        self, store: GossipNode, dense: Any, name: Optional[str] = None,
        full_every: int = 8, keep: int = 16,
        lag_source: Optional[Callable[[], float]] = None,
        lag_threshold: float = 8.0,
        lag_full_every: int = 2,
        partitions: Optional[int] = None,
        mesh_plan: Optional[Any] = None,
        pager: Optional[Any] = None,
    ):
        from ..core import serial
        from ..core.behaviour import MergeKind
        from .monoid import MonoidLift

        if getattr(dense, "merge_kind", None) == MergeKind.MONOID:
            dense = MonoidLift(dense)
        self.store = store
        self.dense = dense
        # The header name is the blob's only persisted type record —
        # default to the (possibly lifted) engine's own name so on-disk
        # gossip artifacts identify their engine truthfully.
        self.name = name if name is not None else getattr(
            dense, "type_name", "topk_rmv"
        )
        self.full_every = full_every
        self.keep = keep
        # Lag-driven backpressure: when `lag_source` (typically max
        # lag_ops over obs.lag.LagTracker.report()) says some peer is
        # >= lag_threshold ops behind, anchor cadence tightens to
        # lag_full_every so the laggard resyncs from a RECENT snapshot
        # instead of replaying (or worse, missing) a long delta chain.
        self.lag_source = lag_source
        self.lag_threshold = lag_threshold
        self.lag_full_every = max(1, lag_full_every)
        # Partition plane (core/partition.py): when set, every full
        # anchor ALSO publishes the P+1 digest vector and per-partition
        # psnaps, so peers running `PartialAntiEntropy` can repair only
        # divergent partitions instead of pulling the whole snapshot.
        # None = whole-instance gossip only (the legacy path, and what a
        # mixed-version fleet degrades to).
        self.partitions = partitions
        # mesh/plan.MeshPlan: anchors produce digest slices + psnaps
        # shard by shard (mesh/gossip.py) instead of in one whole-state
        # walk; the published wire blobs are byte-identical, so peers
        # never see the difference. None = unsharded production.
        self.mesh_plan = mesh_plan
        # core/pager.PartitionPager: under out-of-core paging the device
        # state is only the HOT slice of the logical state. Anchors then
        # publish `pager.full_state` (the logical join) so whole-snapshot
        # consumers see no hole, and the partition surface serves cold
        # digests/psnaps straight from the pager's stored CCPT blobs.
        # Deltas are untouched: they are cut device-side, where cold
        # slices never change between publishes. None = all-resident.
        self.pager = pager
        self.seq = -1
        self._prev: Any = None
        self._serial = serial
        # Wire-window staging (ingest fast path): `publish(..., defer=
        # True)` parks delta windows here instead of shipping each one;
        # `flush_wire` fuses them into ONE range frame [lo..hi] via
        # `ops.compaction.coalesce_deltas` (falling back to re-cutting
        # the interval delta against `_wire_prev`, the last state that
        # actually reached the wire — exact for every engine). Entries
        # are (seq, delta, blob-or-None).
        self._staged: List[Tuple[int, Any, Optional[bytes]]] = []
        self._wire_prev: Any = None
        self._last_state: Any = None
        # encode_delta stash: (seq, is_full) frozen so the publish that
        # consumes a pre-cut blob takes the SAME anchor/pressure branch
        # the encode did (a lag probe flipping between the two calls
        # would otherwise ship a blob cut for the wrong branch).
        self._next_plan: Optional[Tuple[int, bool]] = None
        # Serve-plane hook: called as on_publish(state, seq) after every
        # publish, the natural swap point for a read replica — the state
        # just shipped is exactly what peers will converge toward, so
        # serving it keeps reads within one round of the write frontier.
        self.on_publish: Optional[Callable[[Any, int], None]] = None

    def _branch(self, seq: int) -> bool:
        """True = `seq` publishes a full anchor. Evaluates (and counts)
        the lag-pressure probe, so call once per seq — `encode_delta`
        freezes its answer in `_next_plan` for the matching publish."""
        full_every = self.full_every
        pressured = False
        if self.lag_source is not None:
            try:
                pressured = float(self.lag_source()) >= self.lag_threshold
            except Exception:
                pressured = False  # a broken probe must not stop publishing
        if pressured and self.lag_full_every < full_every:
            full_every = self.lag_full_every
            self.store.metrics.count("net.lag_anchor_cuts")
        return self._prev is None or seq % full_every == 0

    def encode_delta(self, state: Any) -> Optional[Dict[str, Any]]:
        """Pre-cut the NEXT publish's delta so callers can reuse ONE
        join-decomposed delta for both the WAL record and the gossip
        blob (`wal.log_step(..., delta=, blob=)` then
        `publish(state, encoded=...)`) instead of extracting it twice.
        Returns None when the next publish is a full anchor (anchors
        ship whole snapshots; the WAL then cuts its own delta)."""
        from .delta import make_delta

        seq = self.seq + 1
        is_full = self._branch(seq)
        self._next_plan = (seq, is_full)
        if is_full:
            return None
        if obs_spans.ACTIVE:
            with obs_spans.span(
                "round.delta_encode", origin=self.store.member, dseq=seq
            ):
                delta = make_delta(self.dense, self._prev, state)
                blob = self._serial.dumps_dense(f"{self.name}_delta", delta)
        else:
            delta = make_delta(self.dense, self._prev, state)
            blob = self._serial.dumps_dense(f"{self.name}_delta", delta)
        return {"seq": seq, "delta": delta, "blob": blob}

    def publish(
        self, state: Any, encoded: Optional[Dict[str, Any]] = None,
        defer: bool = False,
    ) -> Dict[str, Any]:
        """Publish one window. With `defer=True` (and the ingest fast
        path enabled) a delta window is STAGED instead of shipped; the
        wire frame goes out when `coalesce_max()` windows are pending,
        at the next non-deferred publish, at an anchor (which flushes
        the staged tail before it lands), or at an explicit
        `flush_wire()` — whichever comes first. Anchors are never
        deferred."""
        from .delta import make_delta

        from .monoid import LiftedMonoidState, MonoidLift

        if isinstance(self.dense, MonoidLift) and not isinstance(
            state, LiftedMonoidState
        ):
            raise TypeError(
                "DeltaPublisher.publish: monoid gossip needs versioned "
                "rows — build the state with MonoidLift(engine).init(...) "
                "(parallel/monoid.py)"
            )
        self.seq += 1
        if self._next_plan is not None and self._next_plan[0] == self.seq:
            is_full = self._next_plan[1]
            self._next_plan = None
        else:
            self._next_plan = None
            is_full = self._branch(self.seq)
        if is_full:
            # Ship any staged-but-unshipped windows BEFORE the anchor
            # lands. Discarding them (the anchor IS their join, at a
            # higher seq) looks like a free optimization, but with the
            # default coalesce cap (4) >= the drills' full_every (4)
            # the cap can never fill inside an anchor interval — every
            # window would be superseded and NO delta ever reaches the
            # wire: peers resync through full anchors only and the
            # fast path goes dark. Flushing keeps the chain continuous;
            # a peer that already swept the anchor skips the older
            # frame seqs by cursor, so the join is unchanged.
            self.flush_wire()
            # Under paging the anchor must carry the LOGICAL state —
            # a device-only snapshot would publish identity holes where
            # the cold partitions live.
            pub_state = state
            if self.pager is not None and self.pager.has_cold():
                pub_state = self.pager.full_state(state)
            if obs_spans.ACTIVE:
                # Full-snapshot anchor: serialize + hand to the medium.
                with obs_spans.span("round.snapshot", seq=self.seq):
                    self.store.publish(self.name, pub_state, self.seq)
            else:
                self.store.publish(self.name, pub_state, self.seq)
            if self.partitions:
                # Partition artifacts ride the anchor cadence: the full
                # snapshot stays published (legacy peers and the
                # psnap-exhausted fallback read it), digests + changed
                # psnaps go alongside.
                self.store.publish_partitioned(
                    self.name, state, self.seq, self.dense, self.partitions,
                    plan=self.mesh_plan, pager=self.pager,
                )
            self._wire_prev = state
            self._last_state = state
            kind, nbytes = "full", -1
        else:
            staging = defer and compact_enabled()
            if (
                encoded is not None
                and encoded.get("seq") == self.seq
                and encoded.get("blob") is not None
            ):
                # Pre-cut by encode_delta (same _prev, same seq): the
                # extraction cost was already paid — and already
                # attributed to round.delta_encode — there.
                delta, blob = encoded.get("delta"), encoded["blob"]
            else:
                if obs_spans.ACTIVE:
                    with obs_spans.span(
                        "round.delta_encode", origin=self.store.member,
                        dseq=self.seq,
                    ):
                        delta = make_delta(self.dense, self._prev, state)
                        # A deferred window's bytes may never ship (the
                        # coalesced frame re-serializes) — skip the dump
                        # until flush decides.
                        blob = (
                            None if staging else self._serial.dumps_dense(
                                f"{self.name}_delta", delta
                            )
                        )
                else:
                    delta = make_delta(self.dense, self._prev, state)
                    blob = (
                        None if staging else self._serial.dumps_dense(
                            f"{self.name}_delta", delta
                        )
                    )
            self._staged.append((self.seq, delta, blob))
            self._last_state = state
            if staging and len(self._staged) < coalesce_max():
                kind, nbytes = "staged", 0
            else:
                shipped = self.flush_wire()
                kind, nbytes = "delta", shipped["nbytes"]
        self._prev = state
        if self.on_publish is not None:
            try:
                self.on_publish(state, self.seq)
            except Exception:
                # The read plane must never stall the write plane.
                self.store.metrics.count("serve.swap_errors")
        return {"kind": kind, "seq": self.seq, "nbytes": nbytes}

    @property
    def staged_windows(self) -> int:
        return len(self._staged)

    def flush_wire(self) -> Optional[Dict[str, Any]]:
        """Ship every staged window as ONE range frame [lo..hi] (None
        when nothing is pending). Multi-window frames fuse through
        `ops.compaction.coalesce_deltas`; flavors without a coalesce
        kernel (lifted-monoid row deltas) re-cut the interval delta
        against `_wire_prev` — the last state that reached the wire —
        which is exact for every engine. Either way the frame joins to
        the bit-identical state the chained per-window frames would."""
        if not self._staged:
            return None
        from ..ops.compaction import coalesce_deltas
        from .delta import make_delta

        lo = self._staged[0][0]
        hi = self._staged[-1][0]
        if len(self._staged) == 1:
            delta, blob = self._staged[0][1], self._staged[0][2]
            if blob is None:
                if obs_spans.ACTIVE:
                    with obs_spans.span(
                        "round.delta_encode", origin=self.store.member,
                        dseq=hi,
                    ):
                        blob = self._serial.dumps_dense(
                            f"{self.name}_delta", delta
                        )
                else:
                    blob = self._serial.dumps_dense(
                        f"{self.name}_delta", delta
                    )
        else:
            def _fuse() -> bytes:
                fused = coalesce_deltas(
                    self.dense, [d for _, d, _ in self._staged]
                )
                if fused is None:
                    fused = make_delta(
                        self.dense, self._wire_prev, self._last_state
                    )
                return self._serial.dumps_dense(f"{self.name}_delta", fused)

            if obs_spans.ACTIVE:
                with obs_spans.span(
                    "round.delta_encode", origin=self.store.member,
                    dseq=hi, lo=lo, via="coalesce",
                ):
                    blob = _fuse()
            else:
                blob = _fuse()
        self.store.publish_delta(blob, hi, keep=self.keep, lo=lo)
        self._staged.clear()
        self._wire_prev = self._last_state
        return {"kind": "delta", "seq": hi, "lo": lo, "nbytes": len(blob)}


class PartialAntiEntropy:
    """Partition-granular resync (the tentpole of the partition plane):
    instead of pulling a peer's whole snapshot on a delta-chain gap,
    compare `P+1`-entry digest vectors (`core.partition.state_digests`)
    and fetch psnaps for **only the divergent partitions**.

    Outcome ladder per (member, gap):
    1. vectors fully agree → advance the cursor to the digest seq with
       ZERO fetches (the gap was bandwidth already paid via another
       route — nothing to transfer at all);
    2. some partitions diverge → `request_psnaps` + fetch + join each;
       a partition counts repaired when the post-merge digest matches
       the peer's OR the psnap's own seq has caught up to the digest seq
       (a stored psnap's seq is the last anchor at which that partition
       changed, so "older but matching" is complete, not stale);
    3. psnaps missing / still divergent after `max_tries` sweeps →
       report unhandled, and `sweep_deltas` falls back to the legacy
       whole-snapshot fetch (also the mixed-version-fleet path: a legacy
       peer publishes no digests, so step 1 bails immediately).

    Counters: `net.partition_resyncs` (completed partial repairs),
    `part.divergent` gauge (size of the last divergence set), and
    `net.psnap_wasted` — fetches for a partition whose digests already
    agreed. By construction this stays 0; scripts/chaos_gate.py fails
    the build if it ever isn't."""

    def __init__(
        self, store: GossipNode, partitions: Optional[int] = None,
        max_tries: int = 3, watchdog: Optional[Any] = None,
        mesh_plan: Optional[Any] = None, pager: Optional[Any] = None,
    ):
        from ..core import partition as pt

        self.store = store
        self.partitions = partitions if partitions else pt.n_partitions()
        self.max_tries = max(1, max_tries)
        self._pt = pt
        # member -> consecutive incomplete partial-resync attempts; reset
        # on completion, tripped into full-snap fallback at max_tries.
        self._tries: Dict[str, int] = {}
        # Optional obs.audit.DivergenceWatchdog: every digest exchange
        # below feeds it (observe_peer), and applied psnaps reset its
        # wedge clock (note_repair_progress) — this resync loop IS the
        # repair whose absence the wedged-divergence alarm detects.
        self.watchdog = watchdog
        # mesh/plan.MeshPlan: divergent-partition fetches are grouped by
        # owning key shard (mesh/gossip.group_parts_by_shard) so a
        # repair pulls shard-local psnap slices and stitches them back
        # together, billing `mesh.cross_slice_fetches` / `.cross_slice_
        # bytes`. None = the flat fetch order (unsharded behavior).
        self.mesh_plan = mesh_plan
        # core/pager.PartitionPager: digest vectors come from
        # `pager.digest_vector` (device entries for hot partitions,
        # cached CCPT digests for cold) and fetched psnaps targeting
        # cold partitions fold host-side instead of hydrating — partial
        # anti-entropy never blocks on a page-in. None = all-resident.
        self.pager = pager

    def _own_vec(self, state: Any) -> Any:
        if self.pager is not None and self.pager.has_cold():
            return self.pager.digest_vector(state)
        return self._pt.state_digests(state, self.partitions)

    def try_resync(
        self, member: str, dense: Any, state: Any, cur: int
    ) -> Tuple[Any, int, bool]:
        """(state, cursor, handled). handled=False → caller should run
        the whole-snapshot path."""
        from .delta import apply_any_delta, delta_in_bounds, like_delta_for

        pt, P = self._pt, self.partitions
        got = self.store.fetch_digests(member)
        if got is None:
            return state, cur, False  # legacy peer / torn blob
        dig_seq, peer_vec = got
        if dig_seq <= cur or len(peer_vec) != P + 1:
            # Digest older than our cursor (the snap outran it) or a
            # fleet disagreeing on P: partial resync can't certify
            # anything — use the full snapshot.
            return state, cur, False
        own_vec = self._own_vec(state)
        div = pt.divergent_parts(own_vec, peer_vec)
        self.store.metrics.set("part.divergent", float(len(div)))
        if self.watchdog is not None:
            self.watchdog.observe_peer(member, own_vec, peer_vec, seq=dig_seq)
        if not div:
            # Full agreement: the peer's anchor adds nothing we lack.
            self.store.metrics.count("net.partition_agree_advances")
            obs_events.emit(
                "psnap.resync", origin=member, parts=[], dig_seq=dig_seq,
                fetched=0,
            )
            self._tries.pop(member, None)
            return state, max(cur, dig_seq), True
        # Wasted-resync guard (chaos_gate's detector): only divergent
        # partitions may be fetched. Anything else would be billed here.
        fetch_parts = []
        for p in div:
            if own_vec[p] == peer_vec[p]:
                self.store.metrics.count("net.psnap_wasted")
                continue
            fetch_parts.append(p)
        if self.mesh_plan is not None:
            # Shard-local slices: fetch in owning-shard order, one
            # shard's partitions at a time, and stitch the repairs back
            # together (the join is order-free, so grouping is free).
            from ..mesh import gossip as mesh_gossip

            groups = mesh_gossip.group_parts_by_shard(
                self.mesh_plan, fetch_parts
            )
            fetch_parts = [p for _s, ps in groups for p in ps]
        self.store.request_psnaps(member, fetch_parts)
        like = like_delta_for(dense, state)
        repaired_by_seq = set()
        fetched = 0
        bytes_before = self.store.metrics.counters.get("net.psnap_bytes", 0.0)
        for p in fetch_parts:
            r = self.store.fetch_psnap(
                member, p, like,
                validate=lambda d: delta_in_bounds(dense, state, d),
            )
            if r is None:
                continue  # not served yet (push media) — next sweep
            ps_seq, payload = r
            try:
                if self.pager is not None:
                    # Cold-targeting psnaps fold host-side (or queue);
                    # hot ones join on device — never a forced page-in.
                    state = self.pager.apply_delta(state, payload)
                else:
                    state = apply_any_delta(dense, state, payload)
            except Exception:  # noqa: BLE001 — total, same as sweep
                continue
            fetched += 1
            if self.mesh_plan is not None:
                self.store.metrics.count("mesh.cross_slice_fetches")
            if ps_seq >= dig_seq:
                repaired_by_seq.add(p)
        if self.mesh_plan is not None and fetched:
            bytes_after = self.store.metrics.counters.get(
                "net.psnap_bytes", 0.0
            )
            self.store.metrics.count(
                "mesh.cross_slice_bytes", float(bytes_after - bytes_before)
            )
        post_vec = self._own_vec(state)
        outstanding = [
            p for p in fetch_parts
            if post_vec[p] != peer_vec[p] and p not in repaired_by_seq
        ]
        if fetched and self.watchdog is not None:
            self.watchdog.note_repair_progress(member)
        if not outstanding:
            self.store.metrics.count("net.partition_resyncs")
            obs_events.emit(
                "psnap.resync", origin=member, parts=list(fetch_parts),
                dig_seq=dig_seq, fetched=fetched,
            )
            self._tries.pop(member, None)
            return state, max(cur, dig_seq), True
        tries = self._tries.get(member, 0) + 1
        self._tries[member] = tries
        if tries >= self.max_tries:
            # Residual divergence partial resync can't close (e.g. the
            # peer pruned psnaps, or P mismatch upstream): give up and
            # let the whole snapshot repair everything.
            self._tries.pop(member, None)
            return state, cur, False
        # In progress: psnaps requested, replies in flight. Skip the
        # full fetch this sweep; joins already applied are kept (they
        # are monotone — never wrong, at worst incomplete).
        return state, cur, True


def sweep_deltas(
    store: GossipNode, dense: Any, state: Any, cursors: Dict[str, int],
    partial: Optional[PartialAntiEntropy] = None,
    pager: Optional[Any] = None,
) -> Tuple[Any, Dict[str, Any]]:
    """Delta-aware sweep: per peer, chain contiguous deltas from the
    cursor; on a gap (pruned, torn, or never-seen member) resync from the
    peer's full snapshot and continue chaining. `cursors` maps member ->
    highest seq applied and is updated in place. Applying a full snapshot
    after deltas (or twice) is harmless — everything is a join.

    With `partial` (a `PartialAntiEntropy`), the gap branch first tries
    partition-granular repair — digest-vector compare, then psnaps for
    only the divergent partitions — and falls back to the whole snapshot
    when the peer has no partition surface or the partial repair stalls.

    With `pager` (a `core.pager.PartitionPager`), deltas and snapshots
    targeting cold partitions fold host-side through the pager instead
    of joining on device — the sweep never forces a hydration."""
    from .delta import apply_any_delta, delta_in_bounds, like_delta_for

    dense, state = _resolve_monoid(dense, state, "sweep_deltas")
    like_delta = like_delta_for(dense, state)
    stats = {"deltas": 0, "fulls": 0, "skipped": 0}

    def _apply(st: Any, delta: Any) -> Any:
        if pager is not None:
            return pager.apply_delta(st, delta)
        return apply_any_delta(dense, st, delta)

    def chain(member: str, cur: int) -> int:
        nonlocal state, stats
        avail = sorted(store.delta_seqs(member))
        while True:
            # Frames are stored under their HIGH seq; a range frame
            # [lo..hi] is applicable iff lo <= cur+1 (overlapping
            # coverage below the cursor is harmless — every gossip
            # delta joins idempotently). Legacy frames are the lo==hi
            # degenerate case, so this loop subsumes the old cur+1 walk.
            nxt = next((s for s in avail if s > cur), None)
            if nxt is None:
                break
            got = store.fetch_delta_framed(
                member, nxt, like_delta,
                validate=lambda d: delta_in_bounds(dense, state, d),
            )
            if got is None:
                break  # torn/mismatched write: retry (or resync) next sweep
            lo, hi, delta = got
            if lo > cur + 1:
                break  # real gap below the frame → anchor resync path
            # Same total-failure policy as fetch/fetch_delta: a decodable-
            # but-malformed delta that slips past delta_in_bounds must not
            # crash the gossip loop — break the chain and resync next sweep.
            try:
                tok = (
                    obs_spans.begin(
                        "round.delta_apply", origin=member, dseq=hi, lo=lo
                    )
                    if obs_spans.ACTIVE
                    else None
                )
                try:
                    if profile.ACTIVE or devprof.ACTIVE:
                        with profile.dispatch("elastic.delta_apply", operands=(delta,)):
                            state = _apply(state, delta)
                    else:
                        state = _apply(state, delta)
                finally:
                    obs_spans.end(tok)
            except Exception:  # noqa: BLE001 — deliberately total
                stats["skipped"] += 1
                break
            stats["deltas"] += 1
            cur = hi
            # Terminal stage of the delta trace: (origin, dseq) merged
            # into THIS member's state. `lo` rides along so the audit
            # accepts the range jump as chained, not a gap-skip.
            obs_events.emit("delta.apply", origin=member, dseq=cur, lo=lo)
        return cur

    for m in sorted(set(store.snapshot_members()) | set(store.delta_members())):
        if m == store.member:
            continue
        cur = cursors.get(m, -1)
        cur = chain(m, cur)
        snap_seq = store.snapshot_seq(m)
        if snap_seq is not None and snap_seq > cur:
            if partial is not None:
                state, cur2, handled = partial.try_resync(m, dense, state, cur)
                if handled:
                    if cur2 > cur:
                        cur = chain(m, cur2)
                        stats["partials"] = stats.get("partials", 0) + 1
                    cursors[m] = cur
                    continue
            got = store.fetch(m, state, dense=dense)
            if got is None:
                stats["skipped"] += 1
            else:
                _seq, peer = got
                try:
                    tok = (
                        obs_spans.begin(
                            "round.delta_apply", origin=m, step=_seq,
                            via="snap",
                        )
                        if obs_spans.ACTIVE
                        else None
                    )
                    try:
                        if pager is not None and pager.has_cold():
                            # Cold slices of the peer fold host-side;
                            # the device merge sees only the hot rest.
                            peer = pager.absorb_peer(peer)
                        if profile.ACTIVE or devprof.ACTIVE:
                            with profile.dispatch(
                                "elastic.snap_merge", fn=dense.merge, operands=(peer,)
                            ):
                                state = dense.merge(state, peer)
                        else:
                            state = dense.merge(state, peer)
                    finally:
                        obs_spans.end(tok)
                except Exception:  # noqa: BLE001 — deliberately total
                    stats["skipped"] += 1
                else:
                    stats["fulls"] += 1
                    obs_events.emit("snap.apply", origin=m, step=_seq)
                    cur = max(cur, _seq)
                    cur = chain(m, cur)
        cursors[m] = cur
    return state, stats


def owners(alive: List[str], n_replicas: int) -> Dict[int, str]:
    """Deterministic replica→member assignment from the alive set alone:
    replica r belongs to alive[r % len(alive)]. Every member computes this
    locally; during a membership transition two members may briefly both
    own a replica and apply the same deterministic op stream — harmless,
    the join dedups (idempotence is what makes coordination unnecessary)."""
    alive = sorted(alive)
    if not alive:
        return {}
    return {r: alive[r % len(alive)] for r in range(n_replicas)}


def my_replicas(store: GossipNode, n_replicas: int, timeout_s: float) -> List[int]:
    own = owners(store.alive_members(timeout_s), n_replicas)
    return [r for r, m in own.items() if m == store.member]


def _resolve_monoid(dense: Any, state: Any, where: str) -> Tuple[Any, Any]:
    """Gossip entry points speak the JOIN algebra. MONOID engines enter
    through the versioned-row lift (`parallel.monoid.MonoidLift`): handed
    a raw monoid engine, auto-wrap it — but the STATE must already carry
    row versions (they are real protocol information only the writer can
    produce), so a raw monoid state is a usage error, not something to
    paper over."""
    from ..core.behaviour import MergeKind
    from .monoid import LiftedMonoidState, MonoidLift

    if getattr(dense, "merge_kind", None) == MergeKind.MONOID:
        dense = MonoidLift(dense)
    if isinstance(dense, MonoidLift) and not isinstance(state, LiftedMonoidState):
        raise TypeError(
            f"{where}: monoid gossip needs versioned rows — build the "
            "state with MonoidLift(engine).init(...) and apply ops "
            "through the lift (parallel/monoid.py)"
        )
    return dense, state


def sweep(
    store: GossipNode, dense: Any, state: Any, pager: Optional[Any] = None
) -> Tuple[Any, int]:
    """Fold every peer's latest snapshot into `state` with the engine
    join. Returns (state, n_merged). Self's snapshot is skipped (already
    reflected); stale or concurrent publishes are safe by idempotence
    (MONOID engines ride the versioned-row lift, where row-replace is
    the idempotent join — `parallel.monoid`)."""
    dense, state = _resolve_monoid(dense, state, "sweep")
    n = 0
    for m in store.snapshot_members():
        if m == store.member:
            continue
        got = store.fetch(m, state, dense=dense)
        if got is None:
            continue
        _step, peer = got
        if pager is not None and pager.has_cold():
            peer = pager.absorb_peer(peer)
        tok = (
            obs_spans.begin("round.delta_apply", origin=m, step=_step, via="sweep")
            if obs_spans.ACTIVE
            else None
        )
        try:
            if profile.ACTIVE or devprof.ACTIVE:
                with profile.dispatch(
                    "elastic.sweep_merge", fn=dense.merge, operands=(peer,)
                ):
                    state = dense.merge(state, peer)
            else:
                state = dense.merge(state, peer)
        finally:
            obs_spans.end(tok)
        # Visible to the replay certifier: a full-snapshot fold covers the
        # origin's stream through _step (obs/audit.py reconcile_op_counts).
        obs_events.emit("snap.apply", origin=m, step=_step, via="sweep")
        n += 1
    return state, n
