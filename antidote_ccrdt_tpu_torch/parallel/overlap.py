"""Overlapped round pipeline: host I/O off the round thread (port of
``antidote_ccrdt_tpu/parallel/overlap.py``).

The e2e gossip round runs well above the windowed device compute
because WAL append, delta encode/decode, and gossip I/O sit SERIALLY on
the same thread as device dispatch. This module is the restructure —
three mechanisms, each mapped onto the pieces the rest of the repo
already has:

1. **Out-of-place device merges.** The JAX package donates the incoming
   side of a merge to its output; here every merge writes a new state
   and reads its inputs only (``core.batch_merge.merge_into``), so a
   state the host stage may still be serializing is never written.
   CUDA work is queued on the default stream from every thread, so a
   state expanded on the prefetcher's thread is ready, in stream order,
   for the round thread's fold.

2. **Async host stages.** One `HostStage` worker thread owns WAL append,
   delta encode, and gossip send. Its bounded FIFO queue is the ordering
   guarantee: append(step) is submitted before publish(step), so
   durability still precedes visibility (the write-ahead contract)
   — just not on the round thread. A full queue blocks the submitter
   (backpressure, billed `overlap.stalls`); a task exception fail-stops
   the stage (re-raised at the next submit/drain — async must not
   swallow durability failures). Inbound, a `DeltaPrefetcher` thread
   runs the fetch+decode half of `elastic.sweep_deltas` ahead of the
   round, pre-expanding topk_rmv deltas to mergeable full states
   (`delta.expand_delta` — host scatter cost paid off-thread) into a
   bounded `ApplyQueue`.

3. **Multi-window batched dispatch.** When the apply queue holds >=2
   mergeable windows, `drain_into` folds them — current state riding
   along — in one `core.batch_merge.fold_states` call (log2 N batched
   dispatches) instead of one dispatch per window.

The durability half of the bargain: `CommitCoalescer` runs
group commit ON the host stage — WAL appends stage (write, no fsync) and
the publish-boundary task, FIFO-after every append it covers, commits
the whole batch with one fsync per dirty segment stream (see
harness/wal.py for the three durability modes and the async watermark).

Overflow policy (`ApplyQueue`): drop-oldest-delta-keep-anchor, mirroring
`net/tcp.py`'s send-queue shed. Dropping delta seq k breaks the chained
contiguity obligation for that member, so the shed also drops its later
queued deltas, records a per-member HOLE (`overlap.dropped_deltas`
billed per drop), and refuses further deltas from that member until the
prefetcher lands a full-snapshot anchor with seq >= the hole — the
anchor covers the gap by construction (a snapshot is the whole history).
Snapshots themselves are latest-wins per member, exactly like the tcp
send queue.

Correctness is unchanged from the serial path because ALL gossiped
payloads are joins: JOIN-engine deltas expand to full states whose
untouched rows are the join identity, and MONOID engines always gossip
through the versioned-row lift (row-replace is idempotent and
commutative). Apply order and duplication are therefore free —
bit-identical convergence is pinned by tests/test_overlap.py (run
through this package by tests/test_torch_overlap.py).

The ingest fast path tightens the inbound half further: the
prefetcher fetches a RUN of range frames per peer (compacted wire
windows, `net.transport` CCRF framing), decodes them as one batch under
the `round.delta_decode` span (degrading to per-frame decode when the
`ingest.decode` fault point fires — a corrupt batch must never wedge
the chain), pre-expands BOTH topk_rmv and entrywise table deltas to
mergeable states on the device of the state they join (the expansion
copies them there), so `drain_into`'s folds read device-resident
operands instead of paying h2d inside `round.device_dispatch`.

Failures: the JAX package catches every exception around the expansion,
the batch decode, the poll loop, the sequential apply and the batched
fold. Here only what a malformed or torn payload raises
(`PAYLOAD_ERRORS`, and the `OSError` of an injected fault or a flaky
medium around fetch and decode) is caught and billed; anything else — a
kernel that fails to build or launch, a CUDA error — propagates to the
round thread (the prefetcher's thread keeps it for `stop`).

Env knobs (all read at pipeline construction):
  CCRDT_OVERLAP        on unless set to 0/false/no/off (default ON)
  CCRDT_OVERLAP_QUEUE  apply-queue depth (default 32)
  CCRDT_OVERLAP_BATCH  max windows folded per batched dispatch (default 8)
  CCRDT_OVERLAP_HOSTQ  host-stage queue depth (default 8)
  CCRDT_INGEST_DECODE_BATCH  max inbound frames decoded per batch (default 8)
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..utils import faults

# What a malformed, torn or mismatched payload raises while it is
# decoded, expanded, split or joined.
PAYLOAD_ERRORS = (ValueError, TypeError, KeyError, IndexError)

ENV_FLAG = "CCRDT_OVERLAP"
ENV_QUEUE = "CCRDT_OVERLAP_QUEUE"
ENV_BATCH = "CCRDT_OVERLAP_BATCH"
ENV_HOSTQ = "CCRDT_OVERLAP_HOSTQ"

_FALSE = ("0", "false", "no", "off")


def enabled(flag: Optional[bool] = None) -> bool:
    """Resolve the overlap switch: an explicit CLI value wins, else
    CCRDT_OVERLAP (ON unless set to 0/false/no/off)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get(ENV_FLAG, "1").strip().lower() not in _FALSE


def _env_int(name: str, default: int, floor: int = 1) -> int:
    try:
        return max(floor, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


def queue_depth() -> int:
    return _env_int(ENV_QUEUE, 32)


def batch_cap() -> int:
    return _env_int(ENV_BATCH, 8, floor=2)


def host_queue_depth() -> int:
    return _env_int(ENV_HOSTQ, 8)


ENV_DECODE_BATCH = "CCRDT_INGEST_DECODE_BATCH"


def decode_batch_cap() -> int:
    return _env_int(ENV_DECODE_BATCH, 8)


# -- the background host stage ------------------------------------------------


class HostStage:
    """One worker thread owning the round's host-side I/O (WAL append,
    delta encode, gossip send). A SINGLE thread on purpose: the bounded
    FIFO is the write-ahead ordering guarantee — append(step) submitted
    before publish(step) runs before it. submit() blocks when the queue
    is full (backpressure toward the round thread, billed
    `overlap.stalls`); a task exception fail-stops the stage and
    re-raises at the next submit/drain/close, so a durability failure
    cannot be silently swallowed by asynchrony. Phase spans inside tasks
    (wal_append, delta_encode, gossip_send, snapshot) land on this
    thread's tid and are therefore classified OVERLAPPABLE by
    `obs.spans.attribute`."""

    def __init__(self, metrics: Any = None, depth: int = 8, name: str = "host"):
        self.metrics = metrics
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._exc: Optional[BaseException] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"overlap-{name}"
        )
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            fn, args, kwargs = item
            try:
                if self._exc is None:  # fail-stop: drop work after a failure
                    fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised at submit
                self._exc = e
            finally:
                self._q.task_done()

    def _check(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            self._closed = True
            raise exc

    def submit(self, fn, *args, **kwargs) -> None:
        self._check()
        if self._closed:
            raise RuntimeError("HostStage is closed")
        if self.metrics is not None and self._q.full():
            self.metrics.count("overlap.stalls")
        self._q.put((fn, args, kwargs))  # blocks when full: backpressure
        if self.metrics is not None:
            self.metrics.count("overlap.host_tasks")

    def drain(self) -> None:
        """Block until every submitted task has run (the flush barrier
        before a publish boundary the caller must observe, and before
        the final convergence loop)."""
        self._q.join()
        self._check()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._q.join()
            self._thread.join(timeout=10)
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


# -- group-commit coalescer ----------------------------------------------------


class CommitCoalescer:
    """Batches WAL fsyncs across members sharing a log device (group
    commit). Every `ElasticWal` registered here stages its appends
    (group/async durability); `flush()` — called from the publish-
    boundary task running ON the HostStage, so it sits FIFO-after every
    append it covers — commits all of them: one `wal.fsync` fault fire
    and one fsync per dirty segment stream per member, instead of one
    per append. `maybe_flush()` is the time-bounded variant for call
    sites that run every round (a flush is forced anyway whenever a
    member's own byte/time backstop trips inside `log_step`).

    Single-member processes still win: consecutive ROUNDS between
    publish boundaries share one fsync (`wal.group_size` histogram
    records how many)."""

    def __init__(self, metrics: Any = None, min_interval_ms: float = 0.0):
        self.metrics = metrics
        self.min_interval_ms = float(min_interval_ms)
        self._wals: List[Any] = []
        self._last = 0.0

    def add(self, wal: Any) -> None:
        if wal is not None and wal not in self._wals:
            self._wals.append(wal)

    def flush(self) -> int:
        """Commit every registered member's staged batch. Returns the
        total records acked durable across members."""
        total = 0
        for wal in self._wals:
            total += wal.flush()
        self._last = time.monotonic()
        if total and self.metrics is not None:
            self.metrics.count("wal.coalesced_commits")
        return total

    def maybe_flush(self) -> int:
        if (time.monotonic() - self._last) * 1e3 < self.min_interval_ms:
            return 0
        return self.flush()


# -- the bounded inbound apply queue ------------------------------------------


_ALL_PARTS = -1  # hole key meaning "every partition" (legacy / unknown)


class _Entry:
    __slots__ = ("kind", "member", "seq", "payload", "merged", "parts", "lo")

    def __init__(self, kind: str, member: str, seq: int, payload: Any,
                 merged: Any, parts: Optional[frozenset] = None,
                 lo: Optional[int] = None):
        self.kind = kind          # "delta" | "snap"
        self.member = member
        self.seq = seq
        self.payload = payload    # decoded delta / fetched peer state
        self.merged = merged      # pre-expanded mergeable state, or None
        # Low edge of a range frame [lo..seq] (compacted wire windows);
        # lo == seq is the legacy single-window case. Rides into the
        # delta.apply event so the causal audit reads the jump as
        # chained coverage, not a gap-skip.
        self.lo = seq if lo is None else lo
        # Partition set this payload touches (core.partition.delta_parts
        # minus the meta partition — whole-instance leaves are shipped in
        # full by every delta and are join-monotone, so their loss heals
        # via ANY later payload). None = unknown/legacy: touches all.
        # Empty frozenset = meta-only: dropping it loses nothing durable.
        self.parts = parts


class ApplyQueue:
    """Bounded queue of pre-decoded inbound payloads, shed with the
    net/tcp.py send-queue policy: oldest DELTA first, anchors kept,
    snapshots latest-wins per member. Shedding a delta opens a HOLE
    (chained deltas are valid only gap-free) — at PARTITION granularity
    when entries carry their partition set: only the member's later
    queued deltas that INTERSECT the victim's partitions are purged with
    it, only intersecting further deltas are refused (disjoint
    partitions keep flowing), and a full snapshot with seq >= a
    partition's hole heals that partition. Entries without a partition
    set (`parts=None` — legacy callers, engines without an item plan)
    degrade to the old whole-member hole."""

    def __init__(self, depth: int = 32, metrics: Any = None):
        self.depth = max(1, depth)
        self.metrics = metrics
        self._lock = threading.Lock()
        self._q: "deque[_Entry]" = deque()
        # member -> {partition (or _ALL_PARTS) -> min healing snap seq}
        self._holes: Dict[str, Dict[int, int]] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def dirty_floor(self, member: str) -> Optional[int]:
        """The member's widest open hole (lowest snapshot seq healing
        ALL of its holed partitions), or None when its chain is intact."""
        with self._lock:
            holes = self._holes.get(member)
            return max(holes.values()) if holes else None

    def dirty_parts(self, member: str) -> Dict[int, int]:
        """{partition -> min healing snap seq} for the member's open
        holes (`_ALL_PARTS` = every partition)."""
        with self._lock:
            return dict(self._holes.get(member, {}))

    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.count(name, n)

    @staticmethod
    def _holed(holes: Dict[int, int], parts: Optional[frozenset]) -> bool:
        """Does a payload touching `parts` hit any open hole?"""
        if not holes:
            return False
        if _ALL_PARTS in holes or parts is None:
            return True
        return any(p in holes for p in parts)

    def _shed_locked(self) -> None:
        """Make room (lock held): drop the oldest delta plus the same
        member's later queued deltas intersecting its partition set
        (partition-granular contiguity), recording a hole per touched
        partition; a meta-only delta (empty parts) drops alone and holes
        nothing — its whole-instance leaves are monotone and re-shipped
        by every later payload. A queue of only snapshots drops its
        oldest (a hole marks it for refetch — the newer anchor on the
        store still covers it)."""
        victim = next((e for e in self._q if e.kind == "delta"), None)
        if victim is not None:
            vp = victim.parts
            dropped = [victim]
            if vp is None or vp:
                dropped += [
                    e for e in self._q
                    if e.kind == "delta" and e.member == victim.member
                    and e.seq > victim.seq
                    and (vp is None or e.parts is None or (e.parts & vp))
                ]
            for e in dropped:
                self._q.remove(e)
            holes = self._holes.setdefault(victim.member, {})
            for e in dropped:
                if e.parts is None:
                    holes[_ALL_PARTS] = max(
                        holes.get(_ALL_PARTS, -1), e.seq
                    )
                else:
                    for p in e.parts:
                        holes[p] = max(holes.get(p, -1), e.seq)
            if not holes:
                self._holes.pop(victim.member, None)
            self._count("overlap.dropped_deltas", len(dropped))
            return
        e = self._q.popleft()  # all snaps: oldest snap goes
        holes = self._holes.setdefault(e.member, {})
        holes[_ALL_PARTS] = max(holes.get(_ALL_PARTS, -1), e.seq)
        self._count("overlap.dropped_snaps")

    def put_delta(self, member: str, seq: int, payload: Any,
                  merged: Any = None,
                  parts: Optional[frozenset] = None,
                  lo: Optional[int] = None) -> bool:
        """Enqueue delta `seq` of `member` (a range frame when lo < seq);
        False when refused (the delta touches a holed partition — the
        caller must stop chaining until an anchor covers it; deltas
        touching only intact partitions are still accepted)."""
        with self._lock:
            if self._holed(self._holes.get(member, {}), parts):
                return False
            if len(self._q) >= self.depth:
                self._shed_locked()
            if self._holed(self._holes.get(member, {}), parts):
                # The shed just holed (part of) THIS member's chain and
                # the incoming delta lands in the gap.
                self._count("overlap.dropped_deltas")
                return False
            self._q.append(
                _Entry("delta", member, seq, payload, merged, parts, lo=lo)
            )
            return True

    def put_snap(self, member: str, seq: int, payload: Any,
                 merged: Any = None) -> bool:
        """Enqueue a full-snapshot anchor (latest-wins per member). A
        snapshot covers every partition through `seq`, so it heals each
        hole it reaches (seq >= that partition's hole); an anchor below
        ALL open holes is refused (it cannot cover any gap). A stale
        anchor with the member's DELTAS queued behind it is kept, not
        replaced: those deltas chain from the anchor's seq, and popping
        them without it would emit a dseq jump the flight-log causal
        audit reads as a gap-skip (applying the old anchor too is just
        an extra join)."""
        with self._lock:
            holes = self._holes.get(member)
            if holes and all(seq < h for h in holes.values()):
                return False
            q = list(self._q)
            stale = [
                e for e in q if e.kind == "snap" and e.member == member
            ]
            for e in stale:
                if any(
                    e2.kind == "delta" and e2.member == member
                    for e2 in q[q.index(e) + 1:]
                ):
                    continue
                self._q.remove(e)
            if len(self._q) >= self.depth:
                self._shed_locked()
            holes = self._holes.get(member)
            if holes and all(seq < h for h in holes.values()):
                return False  # the shed re-holed us above this anchor
            self._q.append(_Entry("snap", member, seq, payload, merged))
            if holes:
                for p in [p for p, h in holes.items() if seq >= h]:
                    holes.pop(p)
                if not holes:
                    self._holes.pop(member, None)
            return True

    def pop_all(self) -> List[_Entry]:
        with self._lock:
            out = list(self._q)
            self._q.clear()
            return out


# -- the inbound prefetcher ---------------------------------------------------


class DeltaPrefetcher:
    """The fetch+validate+decode half of `elastic.sweep_deltas`, run
    AHEAD of the round: chain contiguous deltas per peer from a fetch
    cursor, fall back to the full-snapshot anchor on a gap (or an
    ApplyQueue hole), and pre-expand topk_rmv deltas to mergeable full
    states so the round thread's fold is pure device work. `poll()` is
    the thread-free core — the sim chaos test drives it synchronously
    for determinism; `start()` wraps it in a daemon thread whose
    `round.gossip_recv` spans (emitted inside the transport fetch paths)
    land on their own tid and read as OVERLAPPABLE. An error the thread
    does not bill (not a payload's or the medium's) ends it and is
    raised again by the next `check` (every `drain_into` calls it) or by
    `stop`."""

    def __init__(self, store: Any, dense: Any, like_state: Any,
                 apq: ApplyQueue, metrics: Any = None,
                 partitions: Optional[int] = None):
        from ..utils.tree import leaves
        from .delta import like_delta_for
        from .elastic import _resolve_monoid
        from .monoid import MonoidLift

        dense, like_state = _resolve_monoid(dense, like_state, "DeltaPrefetcher")
        self.store = store
        self.dense = dense
        self.like_state = like_state
        self.apq = apq
        self.metrics = metrics if metrics is not None else store.metrics
        # With a partition count, every decoded delta is tagged with the
        # partitions it touches (receiver-side: core.partition
        # .delta_parts) so ApplyQueue sheds/heals at partition
        # granularity. None keeps whole-member holes (legacy).
        self.partitions = partitions
        self._like_delta = like_delta_for(dense, like_state)
        # Lifted monoid states carry host-side row versions; they apply
        # through apply_monoid_row_delta / MonoidLift.merge sequentially,
        # never through the batched device fold.
        self._foldable = not isinstance(dense, MonoidLift)
        self.cursors: Dict[str, int] = {}  # highest seq ENQUEUED per member
        # Expanded windows are staged where the state they join lives.
        self._device = leaves(like_state)[0].device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def _fetch_snap(self, member: str, floor: int) -> int:
        """Fetch `member`'s latest anchor if it advances past `floor`;
        returns the new cursor position (or `floor` unchanged)."""
        got = self.store.fetch(member, self.like_state, dense=self.dense)
        if got is None:
            return floor
        seq, peer = got
        if seq <= floor and self.apq.dirty_floor(member) is None:
            return floor
        if self.apq.put_snap(
            member, seq, peer, peer if self._foldable else None
        ):
            self.metrics.count("overlap.prefetched_snaps")
            return max(floor, seq)
        return floor

    def _decode(self, member: str, hi: int, payload: bytes) -> Any:
        """Decode one frame payload (billed `round.delta_decode` inside
        the node). Returns the delta or None (torn/out-of-bounds)."""
        from .delta import delta_in_bounds

        return self.store.decode_delta_blob(
            member, hi, payload, self._like_delta,
            validate=lambda d: delta_in_bounds(
                self.dense, self.like_state, d
            ),
        )

    def _expand(self, delta: Any) -> Any:
        """Pre-expand a decoded delta to a mergeable full state on the
        device of the state it joins (`drain_into`'s fold then reads
        device-resident operands instead of paying the transfer inside
        `round.device_dispatch`). A payload the expansion rejects gives
        None, which keeps the sequential-apply fallback; a device error
        propagates."""
        from ..core.batch_merge import stage_to_device, tree_nbytes
        from .delta import TopkRmvDelta, expand_delta, expand_table_delta

        if not self._foldable:
            return None
        try:
            if isinstance(delta, TopkRmvDelta):
                merged = expand_delta(self.dense, delta)
            elif isinstance(delta, dict) and "idx" in delta:
                # Entrywise table deltas join the fold path too:
                # apply_table_delta IS merge(state, expand_table_delta),
                # so folding the expansion is the same join.
                merged = expand_table_delta(
                    self.dense, self.like_state, delta
                )
            else:
                return None
        except PAYLOAD_ERRORS:
            return None
        merged = stage_to_device(merged, self._device)
        self.metrics.count("ingest.staged_bytes", tree_nbytes(merged))
        return merged

    def _parts(self, delta: Any) -> Optional[frozenset]:
        if not self.partitions:
            return None
        from ..core import partition as pt

        try:
            # Meta partition excluded: whole-instance leaves ride every
            # delta in full and are join-monotone, so they need no hole
            # bookkeeping (see _Entry).
            return frozenset(
                pt.delta_parts(
                    self.dense, self.like_state, delta, self.partitions
                )
            ) - {pt.meta_part(self.partitions)}
        except PAYLOAD_ERRORS:
            return None  # untagged = touches-all (safe)

    def _ingest_frames(self, member: str, cur: int, frames: List) -> tuple:
        """Decode a collected run of wire frames as ONE batch, then
        expand + enqueue in chain order. The batch decode degrades to
        per-frame decode when the `ingest.decode` fault point fires (or
        the batch pass raises) — a poisoned batch must never wedge the
        prefetch chain; the per-frame total-failure policy then applies.
        Returns (new cursor, entries enqueued)."""
        if not frames:
            return cur, 0
        try:
            if faults.ACTIVE and faults.fire("ingest.decode") != "ok":
                raise faults.InjectedFault("ingest.decode: degraded batch")
            decoded = [
                self._decode(member, hi, payload)
                for _lo, hi, payload in frames
            ]
        except PAYLOAD_ERRORS + (OSError,):  # degrade, never wedge
            self.metrics.count("ingest.decode_degraded")
            decoded = []
            for _lo, hi, payload in frames:
                try:
                    decoded.append(self._decode(member, hi, payload))
                except PAYLOAD_ERRORS + (OSError,):
                    decoded.append(None)
        n = 0
        for (lo, hi, _payload), delta in zip(frames, decoded):
            if delta is None:
                break  # torn/mismatched write: retry next poll
            merged = self._expand(delta)
            parts = self._parts(delta)
            if not self.apq.put_delta(
                member, hi, delta, merged, parts, lo=lo
            ):
                break  # queue holed this member: anchor path next poll
            cur = hi
            n += 1
            self.metrics.count("overlap.prefetched_deltas")
        return cur, n

    def poll(self) -> int:
        """One prefetch pass over every peer; returns entries enqueued."""
        store = self.store
        cap = decode_batch_cap()
        n = 0
        members = sorted(
            set(store.snapshot_members()) | set(store.delta_members())
        )
        for m in members:
            if m == store.member:
                continue
            cur = self.cursors.get(m, -1)
            hole = self.apq.dirty_floor(m)
            if hole is not None and self.partitions is None:
                # Anchor-only until the hole is covered: deltas past a
                # dropped seq can never restore chain contiguity. (With
                # partitions, holes are per-partition — keep chaining and
                # let put_delta refuse only intersecting deltas; the
                # trailing anchor fetch below covers the holed ones.)
                snap_seq = store.snapshot_seq(m)
                if snap_seq is not None and snap_seq >= hole:
                    new = self._fetch_snap(m, cur)
                    n += int(new > cur)
                    cur = new
                self.cursors[m] = cur
                continue
            avail = sorted(store.delta_seqs(m))
            # Frames live under their HIGH seq; [lo..hi] chains from the
            # cursor iff lo <= cur+1 (the legacy frame is lo == hi).
            nxt = next((s for s in avail if s > cur), None)
            head = store.fetch_delta_blob(m, nxt) if nxt is not None else None
            if head is None or head[0] > cur + 1:
                # First contact (or a pruned/compacted tail): the chain
                # cannot start from here, so land the anchor FIRST — one
                # poll then yields anchor + the frames chained behind it,
                # instead of burning a second pass. When the chain IS
                # walkable the anchor is skipped: deltas are cheaper.
                snap_seq = store.snapshot_seq(m)
                if snap_seq is not None and snap_seq > cur:
                    new = self._fetch_snap(m, cur)
                    n += int(new > cur)
                    cur = new
            while True:
                # Collect the walkable frame run (wire fetches billed
                # `round.gossip_recv` inside fetch_delta_blob), then
                # batch-decode + enqueue it.
                frames = []
                walk = cur
                while len(frames) < cap:
                    if head is not None:
                        fr, head = head, None
                        if fr[1] <= walk:
                            continue  # anchor already covered the head
                    else:
                        nx = next((s for s in avail if s > walk), None)
                        if nx is None:
                            break
                        fr = store.fetch_delta_blob(m, nx)
                    if fr is None or fr[0] > walk + 1:
                        break
                    frames.append(fr)
                    walk = fr[1]
                if not frames:
                    break
                cur2, got = self._ingest_frames(m, cur, frames)
                n += got
                stalled = cur2 < frames[-1][1]
                cur = max(cur, cur2)
                if stalled:
                    break  # torn frame or holed queue: resume next poll
            snap_seq = store.snapshot_seq(m)
            if snap_seq is not None and snap_seq > cur:
                new = self._fetch_snap(m, cur)
                n += int(new > cur)
                cur = new
            self.cursors[m] = cur
        return n

    def start(self, interval: float = 0.002) -> None:
        self._thread = threading.Thread(
            target=self._run, args=(interval,), daemon=True,
            name="overlap-prefetch",
        )
        self._thread.start()

    def _run(self, interval: float) -> None:
        while not self._stop.is_set():
            try:
                n = self.poll()
            except PAYLOAD_ERRORS + (OSError,):
                # A flaky peer or a bad payload must not kill
                # prefetching for the rest; transports are already
                # total, so this counts real bugs loudly in metrics.
                self.metrics.count("overlap.prefetch_errors")
                n = 0
            except BaseException as e:  # re-raised by stop()
                self._exc = e
                return
            if not n:
                self._stop.wait(interval)

    def check(self) -> None:
        """Raise what ended the thread, if anything did."""
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def stop(self) -> None:
        """Stop the thread; raise what ended it, if anything did."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.check()


# -- the pipeline facade ------------------------------------------------------


class OverlapPipeline:
    """What `run_worker` holds in overlap mode: the host stage (outbound
    WAL/encode/send), the prefetcher+apply queue (inbound), the
    fold-and-apply drain, and the APPLIED per-peer watermarks
    (`cursors`) that the lag tracker and status drops read."""

    def __init__(self, store: Any, dense: Any, like_state: Any, *,
                 metrics: Any = None, depth: Optional[int] = None,
                 fold_cap: Optional[int] = None,
                 host_depth: Optional[int] = None,
                 start_thread: bool = True,
                 partitions: Optional[int] = None,
                 post_fold: Optional[Any] = None,
                 pager: Optional[Any] = None):
        self.metrics = metrics if metrics is not None else store.metrics
        # Out-of-core residency (core/pager.py). While any partition is
        # cold, inbound payloads must route through the pager (hot half
        # on device, cold half folded host-side) — merging a full
        # expanded window straight into the device state would land rows
        # the pager's cached cold digests can't see.
        self.pager = pager
        # Mesh hook (mesh/reduce.py): called as
        # post_fold(state) on the ROUND thread after a drain actually
        # folded windows in — where an intra-slice reduce belongs (fresh
        # peer rows just landed; pre-join them before the next publish).
        # Must be total and must NOT write its operand in place: the
        # host stage may still be serializing the state it receives.
        self.post_fold = post_fold
        self.apq = ApplyQueue(
            depth if depth is not None else queue_depth(),
            metrics=self.metrics,
        )
        self.prefetch = DeltaPrefetcher(
            store, dense, like_state, self.apq, metrics=self.metrics,
            partitions=partitions,
        )
        self.dense = self.prefetch.dense
        self.host = HostStage(
            metrics=self.metrics,
            depth=host_depth if host_depth is not None else host_queue_depth(),
        )
        self.fold_cap = fold_cap if fold_cap is not None else batch_cap()
        self.cursors: Dict[str, int] = {}  # highest seq APPLIED per member
        if start_thread:
            self.prefetch.start()

    def submit(self, fn, *args, **kwargs) -> None:
        self.host.submit(fn, *args, **kwargs)

    def pressure_depth(self) -> int:
        """Combined backlog an admission controller should gate on: the
        inbound apply queue PLUS the outbound host-stage queue (pending
        WAL appends / encodes / sends). The write tier's ingest plane
        sheds writers on this — a deep host queue means acks
        would stack behind fsync work the pipeline hasn't run yet."""
        return len(self.apq) + self.host._q.qsize()

    def _apply_sequential(self, state: Any, entries: List[_Entry]) -> Any:
        """Fallback / non-foldable application, entry by entry: a
        malformed payload must not crash the round (billed
        `overlap.apply_errors`); any other error propagates."""
        from .delta import apply_any_delta

        pager = self.pager
        for e in entries:
            try:
                if pager is not None and pager.has_cold():
                    if e.kind == "snap":
                        state = self.dense.merge(
                            state, pager.absorb_peer(e.payload)
                        )
                    else:
                        state = pager.apply_delta(state, e.payload)
                elif e.kind == "snap":
                    state = self.dense.merge(state, e.payload)
                else:
                    state = apply_any_delta(self.dense, state, e.payload)
            except PAYLOAD_ERRORS:
                self.metrics.count("overlap.apply_errors")
        return state

    def drain_into(self, state: Any) -> Any:
        """Fold every queued window into `state` on the ROUND thread:
        mergeable entries (pre-expanded deltas + JOIN snapshots) go
        through `core.batch_merge.fold_states` in chunks of `fold_cap`
        — >=2 windows become ONE batched dispatch chain — the rest apply
        sequentially. Join algebra makes the order irrelevant; the
        flight-recorder apply events are emitted in queue order, which
        preserves per-member seq contiguity for `ccrdt_trace audit`."""
        # The span brackets the WHOLE apply stage — queue pop, fold
        # dispatch, the sequential fallback, AND the apply-event
        # bookkeeping. Any of these can absorb tens of ms (the pop and
        # the dispatch both ride behind the previous round's chained
        # device work), so billing only the inner merge section left
        # that wall time as unattributed gap in `spans.attribute`. The
        # span's m0 is backdated over the pop (an empty drain emits no
        # span at all — near-zero samples would skew the phase p50s).
        t0 = time.monotonic() if obs_spans.ACTIVE else None
        self.prefetch.check()
        entries = self.apq.pop_all()
        if not entries:
            return state
        from ..core.batch_merge import fold_states, merge_into

        if self.pager is not None and self.pager.has_cold():
            # Mixed residency: the batched fold would write cold
            # partitions' rows onto the device behind the pager's back.
            # Everything goes through the pager-aware sequential path.
            mergeable, rest = [], entries
        else:
            mergeable = [e for e in entries if e.merged is not None]
            rest = [e for e in entries if e.merged is None]
        tok = (
            obs_spans.begin(
                "round.delta_apply", via="overlap", n=len(entries)
            )
            if obs_spans.ACTIVE
            else None
        )
        if tok is not None:
            tok["m0"] = t0
        try:
            merge = self.dense.merge
            i = 0
            while i < len(mergeable):
                chunk = mergeable[i:i + self.fold_cap]
                i += len(chunk)
                try:
                    if len(chunk) >= 2:
                        state = fold_states(
                            merge, [state] + [e.merged for e in chunk]
                        )
                        self.metrics.count("overlap.folds")
                        self.metrics.count(
                            "overlap.folded_windows", len(chunk)
                        )
                        # Cross-member fused apply: the chunk rides the
                        # queue in arrival order, so windows from
                        # DIFFERENT peers stack into the same batched
                        # dispatch (the join is law-certified
                        # commutative/associative — member boundaries
                        # mean nothing to it).
                        self.metrics.count(
                            "ingest.fused_members",
                            len({e.member for e in chunk}),
                        )
                    else:
                        state = merge_into(merge, state, chunk[0].merged)
                except PAYLOAD_ERRORS:  # fall back per entry
                    state = self._apply_sequential(state, chunk)
            state = self._apply_sequential(state, rest)
            for e in entries:
                if e.kind == "delta":
                    obs_events.emit(
                        "delta.apply", origin=e.member, dseq=e.seq,
                        lo=e.lo,
                    )
                else:
                    obs_events.emit(
                        "snap.apply", origin=e.member, step=e.seq
                    )
                if e.seq > self.cursors.get(e.member, -1):
                    self.cursors[e.member] = e.seq
        finally:
            obs_spans.end(tok)
        self.metrics.count("overlap.windows", len(entries))
        if self.post_fold is not None:
            state = self.post_fold(state)
        return state

    def close(self, state: Any) -> Any:
        """Flush at end of the step loop: host tasks durable (WAL tail +
        last publishes), prefetcher stopped, queue remnants folded in.
        The caller then runs the ordinary SERIAL final-convergence loop
        — it must keep adopting late-detected deaths and needs no
        pipeline."""
        self.host.drain()
        self.prefetch.stop()
        state = self.drain_into(state)
        self.host.close()
        return state
