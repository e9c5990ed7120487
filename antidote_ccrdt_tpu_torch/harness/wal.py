"""Per-replica write-ahead delta log: crash-consistent worker recovery
(port of ``antidote_ccrdt_tpu/harness/wal.py``: the same segment files,
records and checkpoint, so either package recovers a log the other wrote).

The elastic tier (parallel/elastic.py) survives crashes by PEER adoption:
op generation is deterministic, so survivors regenerate a dead member's
whole history. That is the fallback of last resort — it costs a full
re-apply of every adopted replica's stream and only works while op
streams are regenerable. This module gives each worker its own durable
recovery path, the way a database pairs WAL + checkpoint:

* `WriteAheadLog` — generic append-only segmented log of (seq, payload)
  records. Framing per record::

      u32le frame_len | u32le crc32(frame) | frame
      frame := u64le seq ++ payload

  CRC covers seq+payload, so a torn OR bit-rotted tail is detected, not
  replayed. Appends either fsync inline (`sync=True`, the `wal.fsync`
  fault point) or stage — write+flush to the OS, fsync deferred to
  `fsync_if_dirty()` so a caller can batch many appends under ONE fsync
  (group commit). Segments rotate at a byte threshold;
  `compact(watermark)` drops whole segments whose records are all <= the
  watermark; `truncate_after(watermark)` physically removes the record
  tail PAST a watermark (async-durability recovery). On open, a torn
  tail is truncated in place and any segments after the tear are dropped
  — bytes after a torn frame were never acknowledged to anyone.

* `ElasticWal` — the elastic-worker discipline on top, now with three
  durability modes (`CCRDT_WAL_DURABILITY`, default ``group``):

  - ``sync``  — legacy: one fsync per append, durable == appended.
  - ``group`` — group commit: appends stage; `flush()` (called at every
    publish boundary, plus byte/time backstops) fsyncs the whole batch
    once per dirty segment stream, so consecutive rounds share one
    fsync. Durable-before-visible is preserved because the boundary
    flushes BEFORE the publish.
  - ``async`` — opt-in: gossip may ship a delta BEFORE its fsync. The
    log publishes a per-member durability watermark (`wal.durable_seq`
    gauge + `wal.durable` flight events); fsyncs happen lazily (bounds)
    and at checkpoints. Recovery truncates the log to the watermark
    recorded in a tiny fsync'd mini-log (`wm/`), and the obs/audit
    certifier reconciles published-vs-durable from the flight log — so
    relaxed-path speed stays *audited* (zero unaudited loss).

  With `partitions` set the log is sharded into per-partition segment
  STREAMS (stream 0 keeps the legacy top-level layout; streams 1..S-1
  live in ``stream-NN/`` subdirs), records routed by their partition
  tag and fsync'd by a small writer pool so independent partitions never
  serialize behind one fd. Recovery merges streams by seq; `compact()`
  works per stream (a fully-covered stream compacts independently).
  Legacy single-stream logs are just the S=1 case and open unchanged.

  Each applied op batch is logged as a join-decomposed delta
  (`parallel.delta.make_delta`) BEFORE the state is published (sync /
  group modes), and a periodic full checkpoint anchors compaction.
  `recover` rebuilds state = checkpoint ⊔ WAL-delta suffix — safe by
  exactly the delta-chaining argument from parallel/delta.py.

A `kill -9` mid-run therefore costs a worker nothing it had appended
(sync), nothing past the last group flush (group), or nothing past the
published watermark (async — and the certifier proves exactly that from
the flight log). Peer adoption remains the fallback when the WAL itself
is lost (tests pin both paths).
"""

from __future__ import annotations

import os
import shutil
import struct
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from ..core import serial
from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..utils import faults
from ..utils.metrics import Metrics
from .checkpoint import load_dense_checkpoint, save_dense_checkpoint

_HDR = struct.Struct("<II")  # frame_len, crc32
_SEQ = struct.Struct("<Q")
_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".wal"

_STREAM_PREFIX = "stream-"
_WM_DIR = "wm"

MODES = ("sync", "group", "async")


def durability_mode(override: Optional[str] = None) -> str:
    """Resolve the durability mode: explicit override > env > 'group'."""
    m = (override or os.environ.get("CCRDT_WAL_DURABILITY", "")).strip().lower()
    return m if m in MODES else "group"


def _seg_name(idx: int) -> str:
    return f"{_SEG_PREFIX}{idx:08d}{_SEG_SUFFIX}"


class WriteAheadLog:
    """Segmented, CRC-framed write-ahead log (fsync per append, or
    staged appends + batched `fsync_if_dirty` for group commit)."""

    def __init__(
        self,
        root: str,
        segment_bytes: int = 1 << 20,
        sync: bool = True,
        metrics: Optional[Metrics] = None,
        fault_point: Optional[str] = "wal.fsync",
    ):
        self.root = root
        self.segment_bytes = int(segment_bytes)
        self.sync = sync
        self.metrics = metrics if metrics is not None else Metrics()
        self.fault_point = fault_point
        os.makedirs(root, exist_ok=True)
        self._seg_max: Dict[int, int] = {}  # segment idx -> max seq in it
        self.last_seq = -1
        self.torn_bytes = 0
        self._dirty = False  # bytes written+flushed but not yet fsync'd
        self._scan_and_repair()
        self._cur = max(self._seg_max) if self._seg_max else 0
        self._fh = open(self._path(self._cur), "ab")

    # -- layout ------------------------------------------------------------

    def _path(self, idx: int) -> str:
        return os.path.join(self.root, _seg_name(idx))

    def _segments(self) -> List[int]:
        out = []
        for f in os.listdir(self.root):
            if f.startswith(_SEG_PREFIX) and f.endswith(_SEG_SUFFIX):
                try:
                    out.append(int(f[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    # -- open-time repair --------------------------------------------------

    def _scan_and_repair(self) -> None:
        """Validate every segment in order; on the first torn/corrupt
        frame, truncate that segment there and DELETE all later segments
        (a record is only durable if every byte before it is — bytes
        past a tear were never acknowledged)."""
        segs = self._segments()
        for pos, idx in enumerate(segs):
            good, max_seq, n = self._scan_segment(self._path(idx))
            size = os.path.getsize(self._path(idx))
            if n:
                self._seg_max[idx] = max_seq
                self.last_seq = max(self.last_seq, max_seq)
            if good < size:
                self.torn_bytes += size - good
                os.truncate(self._path(idx), good)
                for later in segs[pos + 1:]:
                    self.torn_bytes += os.path.getsize(self._path(later))
                    os.remove(self._path(later))
                break
        if self.torn_bytes:
            self.metrics.count("wal.torn_bytes", self.torn_bytes)
            obs_events.emit(
                "wal.torn", dir=self.root, bytes=self.torn_bytes
            )

    @staticmethod
    def _scan_segment(path: str) -> Tuple[int, int, int]:
        """-> (valid_prefix_bytes, max_seq, n_records)."""
        good, max_seq, n = 0, -1, 0
        with open(path, "rb") as f:
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) != _HDR.size:
                    break
                ln, crc = _HDR.unpack(hdr)
                frame = f.read(ln)
                if len(frame) != ln or zlib.crc32(frame) != crc:
                    break
                max_seq = max(max_seq, _SEQ.unpack(frame[:_SEQ.size])[0])
                n += 1
                good += _HDR.size + ln
        return good, max_seq, n

    # -- append / rotate ---------------------------------------------------

    def append(self, seq: int, payload: bytes, sync: Optional[bool] = None) -> None:
        """Append one record. ``sync=True`` fsyncs inline (the legacy
        fsync-per-append discipline and its `wal.fsync` fault point);
        ``sync=False`` STAGES the record — written+flushed to the OS so
        readers see it, but durable only after `fsync_if_dirty()` (the
        group-commit path, where the caller fires the fault point once
        per batch instead)."""
        do_sync = self.sync if sync is None else sync
        frame = _SEQ.pack(seq) + payload
        rec = _HDR.pack(len(frame), zlib.crc32(frame)) + frame
        if self._fh.tell() + len(rec) > self.segment_bytes and self._fh.tell() > 0:
            self._rotate()
        self._fh.write(rec)
        self._fh.flush()
        if do_sync:
            # Fault point `wal.fsync`: an injected EIO surfaces to the
            # caller exactly like a dying disk — the record is NOT
            # durable and the caller must not publish past it.
            if faults.ACTIVE and self.fault_point:
                faults.fire(self.fault_point)
            os.fsync(self._fh.fileno())
        else:
            self._dirty = True
        self._seg_max[self._cur] = max(self._seg_max.get(self._cur, -1), seq)
        self.last_seq = max(self.last_seq, seq)
        self.metrics.count("wal.appends")
        self.metrics.count("wal.bytes", len(rec))
        # Appended watermark gauge + event at WRITE time in every mode:
        # the flight log's wal.append trail is the certifier's exposure
        # axis (what COULD have been published), durable acknowledgement
        # is the separate wal.durable trail.
        self.metrics.set("wal.last_seq", float(self.last_seq))
        obs_events.emit("wal.append", wseq=seq, bytes=len(rec))

    def fsync_if_dirty(self) -> bool:
        """Group-commit fsync: one fsync covering every staged append on
        this stream. Deliberately does NOT fire the fault point — the
        batch-level caller (`ElasticWal.flush`) fires it exactly once so
        one injected EIO poisons the whole batch fail-stop rather than
        partial-acking some streams."""
        if not self._dirty:
            return False
        os.fsync(self._fh.fileno())
        self._dirty = False
        return True

    def _rotate(self) -> None:
        # A dirty (staged, unfsync'd) segment is fsync'd before it is
        # closed — we would otherwise lose the fd we need for the group
        # fsync. Durability is still only ACKED at the next flush():
        # under-claiming is always safe.
        if self._dirty:
            os.fsync(self._fh.fileno())
            self._dirty = False
        self._fh.close()
        self._cur += 1
        self._fh = open(self._path(self._cur), "ab")
        self.metrics.count("wal.rotations")
        obs_events.emit("wal.rotate", segment=self._cur)

    # -- read / compact / truncate ------------------------------------------

    def records(self) -> Iterator[Tuple[int, bytes]]:
        """All (seq, payload) records in segment+offset order (staged
        records included — they are flushed to the OS). The open-time
        repair already removed any tear; a frame going bad AFTER open
        (concurrent corruption) stops iteration at the last valid
        prefix, mirroring the open-time policy."""
        self._fh.flush()
        for idx in sorted(self._seg_max) if self._seg_max else []:
            with open(self._path(idx), "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) != _HDR.size:
                        break
                    ln, crc = _HDR.unpack(hdr)
                    frame = f.read(ln)
                    if len(frame) != ln or zlib.crc32(frame) != crc:
                        return
                    yield _SEQ.unpack(frame[:_SEQ.size])[0], frame[_SEQ.size:]

    def compact(self, watermark: int) -> int:
        """Remove closed segments whose every record seq <= watermark.
        The ACTIVE segment never goes (truncating the file under the
        append handle is not crash-safe); rotation keeps it bounded.
        Returns the number of segments removed."""
        removed = 0
        for idx in sorted(self._seg_max):
            if idx == self._cur:
                continue
            if self._seg_max[idx] <= watermark:
                os.remove(self._path(idx))
                del self._seg_max[idx]
                removed += 1
        if removed:
            self.metrics.count("wal.segments_compacted", removed)
        return removed

    def truncate_after(self, watermark: int) -> int:
        """Physically remove every record with seq > watermark (async-
        durability recovery: the tail past the durable watermark was
        published-but-never-acked, and leaving it would let a restarted
        incarnation's re-appended seqs interleave with a stale divergent
        timeline). Within a stream seqs ascend, so the cut is a single
        truncate + drop-later-segments. Returns records removed."""
        self._fh.flush()
        removed = 0
        cut_at: Optional[Tuple[int, int]] = None  # (segment idx, offset)
        for idx in self._segments():
            path = self._path(idx)
            off = 0
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) != _HDR.size:
                        break
                    ln, crc = _HDR.unpack(hdr)
                    frame = f.read(ln)
                    if len(frame) != ln or zlib.crc32(frame) != crc:
                        break
                    seq = _SEQ.unpack(frame[:_SEQ.size])[0]
                    if seq > watermark:
                        if cut_at is None:
                            cut_at = (idx, off)
                        removed += 1
                    off += _HDR.size + ln
            if cut_at is not None:
                break  # ascending seqs: every later record is past the mark
        if cut_at is None:
            return 0
        cut_idx, cut_off = cut_at
        self._fh.close()
        segs = self._segments()
        os.truncate(self._path(cut_idx), cut_off)
        for later in segs[segs.index(cut_idx) + 1:]:
            # Count the records in segments dropped whole.
            _, _, n = self._scan_segment(self._path(later))
            removed += n if later != cut_idx else 0
            os.remove(self._path(later))
        # Rebuild the index from what survived, then re-open for append.
        self._seg_max = {}
        self.last_seq = -1
        for idx in self._segments():
            _, max_seq, n = self._scan_segment(self._path(idx))
            if n:
                self._seg_max[idx] = max_seq
                self.last_seq = max(self.last_seq, max_seq)
        self._cur = max(self._segments() or [0])
        self._fh = open(self._path(self._cur), "ab")
        os.fsync(self._fh.fileno())
        self._dirty = False
        self.metrics.count("wal.truncated_records", removed)
        obs_events.emit(
            "wal.truncate", dir=self.root, watermark=int(watermark),
            records=removed,
        )
        return removed

    def close(self) -> None:
        if self._fh is not None:
            if self._dirty:
                os.fsync(self._fh.fileno())
                self._dirty = False
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- elastic-worker discipline ---------------------------------------------


class ElasticWal:
    """Checkpoint + delta WAL for one elastic gossip worker.

    Record payload: ``encode_term((step, owned_list)) is framed inside
    the ETF term together with the delta blob`` — concretely
    ``encode_term((step, owned, delta_blob))`` where ``delta_blob`` is
    the same `dumps_dense(f"{name}_delta", delta)` encoding the gossip
    tier ships, so WAL records and wire deltas stay one format.

    With `partitions` set, records are tagged with the partition set
    their delta touches (``encode_term((step, owned, blob, parts))`` —
    a 4-tuple; `core.partition.delta_parts`), so recovery and rejoin
    tooling can reason per partition — and the tag doubles as the
    STREAM ROUTE: the log shards into `nstreams` per-partition segment
    streams (stream 0 = the legacy top-level dir, so untagged/legacy
    logs are just the single-stream case). `recover` merges streams by
    seq and branches on the tuple arity, so un-tagged legacy records
    and tagged records interleave freely (the mixed-version contract).

    Durability modes — see the module docstring. The group/async write
    path stages appends and `flush()` commits the batch: one
    `wal.fsync` fault fire for the WHOLE batch (fail-stop, never a
    partial ack), parallel per-stream fsyncs via a small writer pool,
    then (async) one fsync'd watermark record in the `wm/` mini-log.
    `durable_seq` is the highest seq with every record at or below it
    fsync-acked.
    """

    SNAP = "snap.ckpt"

    def __init__(
        self,
        root: str,
        member: str,
        dense: Any,
        name: str,
        segment_bytes: int = 256 << 10,
        metrics: Optional[Metrics] = None,
        partitions: Optional[int] = None,
        durability: Optional[str] = None,
        streams: Optional[int] = None,
        mesh_plan: Optional[Any] = None,
    ):
        self.dir = os.path.join(root, f"wal-{member}")
        self.member = member
        self.dense = dense
        self.name = name
        self.partitions = partitions
        self.metrics = metrics if metrics is not None else Metrics()
        self.durability = durability_mode(durability)
        # mesh/plan.MeshPlan: stream count follows the key-shard count
        # and routing follows shard ownership, so each stream holds
        # exactly one shard's partitions — a shard's WAL slice is
        # self-contained (the per-shard recombination test_mesh.py pins).
        # Explicit `streams`/env still wins: operators outrank the plan.
        self.mesh_plan = mesh_plan
        env_streams = os.environ.get("CCRDT_WAL_STREAMS", "")
        if streams is None and env_streams:
            try:
                streams = int(env_streams)
            except ValueError:
                streams = None
        if streams is None and mesh_plan is not None:
            streams = mesh_plan.n_key
        if streams is None:
            streams = min(4, partitions) if partitions else 1
        # A reader must open every stream that EXISTS on disk, however
        # it was configured itself — a legacy (single-stream) reopen of
        # a multi-stream log still recovers/truncates all streams; its
        # own new appends simply all route to stream 0.
        disk_streams = 1
        if os.path.isdir(self.dir):
            for f in os.listdir(self.dir):
                if f.startswith(_STREAM_PREFIX):
                    try:
                        disk_streams = max(
                            disk_streams, int(f[len(_STREAM_PREFIX):]) + 1
                        )
                    except ValueError:
                        continue
        self.nstreams = max(1, int(streams), disk_streams)
        # Group-commit bounds: a staged batch is force-flushed once it
        # exceeds either bound, even if no publish boundary arrives.
        self.group_bytes = int(
            os.environ.get("CCRDT_WAL_GROUP_BYTES", str(1 << 20))
        )
        self.group_ms = float(os.environ.get("CCRDT_WAL_GROUP_MS", "100"))
        sync = self.durability == "sync"
        self.streams: List[WriteAheadLog] = []
        for s in range(self.nstreams):
            sroot = (
                self.dir if s == 0
                else os.path.join(self.dir, f"{_STREAM_PREFIX}{s:02d}")
            )
            self.streams.append(
                WriteAheadLog(
                    sroot, segment_bytes=segment_bytes, sync=sync,
                    metrics=self.metrics,
                )
            )
        self.log = self.streams[0]  # legacy alias (tests, tooling)
        # --- durability watermark mini-log (async mode) -----------------
        # The wm log holds fsync'd (watermark, b"") records; its last
        # seq after crash-repair IS the durable watermark. Open-time
        # discipline: an existing wm truncates every data stream past
        # its watermark (regardless of the CURRENT mode — the stale
        # tail was never acked no matter how we reopen); then a
        # non-async reopen deletes the wm dir so a stale watermark can
        # never truncate records a later sync/group run made durable.
        self._wm: Optional[WriteAheadLog] = None
        wm_dir = os.path.join(self.dir, _WM_DIR)
        had_wm = os.path.isdir(wm_dir)
        if had_wm:
            wm_scan = WriteAheadLog(
                wm_dir, segment_bytes=4 << 10, sync=True,
                metrics=self.metrics, fault_point=None,
            )
            watermark = wm_scan.last_seq
            wm_scan.close()
            truncated = 0
            for st in self.streams:
                truncated += st.truncate_after(watermark)
            if truncated:
                self.metrics.set("wal.recover_truncated", truncated)
        if self.durability == "async":
            self._wm = WriteAheadLog(
                wm_dir, segment_bytes=4 << 10, sync=True,
                metrics=self.metrics, fault_point=None,
            )
            # Fresh wm over pre-existing data (a sync/group log reopened
            # as async): everything on disk now was durable at open
            # (repair already pruned tears), so seed the watermark —
            # otherwise a crash before the first flush would truncate
            # records an earlier run legitimately made durable.
            last = self._last_on_disk()
            if last >= 0 and self._wm.last_seq < last:
                self._wm.append(last, b"", sync=True)
        elif had_wm:
            shutil.rmtree(wm_dir, ignore_errors=True)
        # --- group-commit state -----------------------------------------
        self._pending: Set[int] = set()   # staged seqs awaiting fsync ack
        self._staged_bytes = 0
        self._last_flush = time.monotonic()
        self._first_staged = self._last_flush  # opens with the group
        self._last_appended = self._last_on_disk()
        self._pool = None  # lazy writer pool for parallel stream fsyncs
        self._publish_gauges()

    # -- bookkeeping --------------------------------------------------------

    def _last_on_disk(self) -> int:
        return max((st.last_seq for st in self.streams), default=-1)

    @property
    def durable_seq(self) -> int:
        """Highest seq S such that every record <= S is fsync-acked."""
        if not self._pending:
            return self._last_appended
        return min(self._pending) - 1

    def _publish_gauges(self) -> None:
        d = self.durable_seq
        self.metrics.set("wal.durable_seq", float(d))
        self.metrics.set(
            "wal.durability_lag", float(max(0, self._last_appended - d))
        )

    def stream_for_part(self, part: int) -> int:
        """Partition -> stream index. With a mesh plan this is shard
        ownership (`MeshPlan.shard_of`, clamped to the streams that
        exist); without one it is the same `% nstreams` fold — identical
        routes when nstreams == n_key, by construction of `shard_of`."""
        if self.mesh_plan is not None:
            return self.mesh_plan.shard_of(int(part)) % self.nstreams
        return int(part) % self.nstreams

    def _stream_for(self, parts) -> WriteAheadLog:
        """Partition tag -> stream route. Untagged / unknown-partition
        records go to stream 0 (the legacy layout)."""
        if self.nstreams <= 1 or not parts:
            return self.streams[0]
        return self.streams[self.stream_for_part(min(int(p) for p in parts))]

    # -- write path --------------------------------------------------------

    def log_step(
        self,
        step: int,
        owned,
        prev_view: Any,
        view: Any,
        delta: Any = None,
        blob: Optional[bytes] = None,
    ) -> int:
        """Append this step's join-decomposed delta (prev_view -> view)
        plus its ownership record. sync/group modes: MUST run before the
        step's publish (write-ahead: the record precedes any externally
        visible effect; in group mode the BOUNDARY flush completes it).
        async mode: the publish may overtake the fsync — the durability
        watermark and the certifier account for exactly that window.

        `delta`/`blob` let a caller that already cut this step's delta
        for gossip (DeltaPublisher.encode_delta) hand it over instead of
        paying a second extraction. Returns the appended payload size."""
        if obs_spans.ACTIVE:
            # The whole write-ahead cost — delta extraction (when not
            # reused from the publisher), encode, CRC framing, staging
            # or fsync — is one serial round phase.
            with obs_spans.span("round.wal_append", step=int(step)):
                return self._log_step(step, owned, prev_view, view, delta, blob)
        return self._log_step(step, owned, prev_view, view, delta, blob)

    def _log_step(
        self, step, owned, prev_view, view, delta, blob
    ) -> int:
        from ..parallel.delta import make_delta

        if delta is None:
            delta = make_delta(self.dense, prev_view, view)
            blob = None
        if blob is None:
            blob = serial.dumps_dense(f"{self.name}_delta", delta)
        payload, parts = self._encode_record(step, owned, view, delta, blob)
        stream = self._stream_for(parts)
        if self.durability == "sync":
            stream.append(step, payload, sync=True)
            self._last_appended = max(self._last_appended, int(step))
        else:
            stream.append(step, payload, sync=False)
            self._last_appended = max(self._last_appended, int(step))
            if not self._pending:
                # The undurable window opens when the FIRST record of a
                # group is staged, not at the previous flush: measuring
                # from _last_flush made any quiet period >= group_ms
                # flush the next append solo, so multi-append boundaries
                # could never form a group.
                self._first_staged = time.monotonic()
            self._pending.add(int(step))
            self._staged_bytes += len(payload)
            # Byte/time backstop: a run with sparse publish boundaries
            # still bounds its undurable window.
            if (
                self._staged_bytes >= self.group_bytes
                or (time.monotonic() - self._first_staged) * 1e3
                >= self.group_ms
            ):
                self.flush()
        self._publish_gauges()
        return len(payload)

    def _encode_record(
        self, step: int, owned, view: Any, delta: Any, blob: bytes
    ) -> Tuple[bytes, Tuple[int, ...]]:
        """Legacy 3-tuple record, or the partition-tagged 4-tuple when
        this WAL runs with a partition count. Also returns the tag (the
        stream route)."""
        base = (int(step), [int(r) for r in owned], blob)
        if not self.partitions:
            return serial.encode_term(base), ()
        from ..core import partition as pt

        try:
            parts = tuple(sorted(
                pt.delta_parts(self.dense, view, delta, self.partitions)
            ))
        except Exception:  # noqa: BLE001 — a tag failure must not block
            parts = ()     # durability; empty tag = "unknown partitions"
        return serial.encode_term(base + (list(parts),)), parts

    def flush(self) -> int:
        """Group commit: fsync every dirty stream (in parallel when
        several are dirty), then — async mode — fsync the advanced
        watermark into the wm mini-log. ONE `wal.fsync` fault fire
        covers the whole batch: an injected EIO poisons the entire
        group fail-stop BEFORE any stream fsyncs, so no subset of the
        batch is ever acked (the staged records stay pending and a
        retry re-commits them). Returns the group size acked."""
        if not self._pending:
            return 0
        if obs_spans.ACTIVE:
            # The group fsync is write-ahead cost too — bill it to the
            # same phase as the staged appends it commits.
            with obs_spans.span(
                "round.wal_append", via="flush", n=len(self._pending)
            ):
                return self._flush()
        return self._flush()

    def _flush(self) -> int:
        if faults.ACTIVE:
            # Raise => durable_seq does NOT advance, pending is kept.
            faults.fire("wal.fsync")
        dirty = [st for st in self.streams if st._dirty]
        if len(dirty) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=min(4, self.nstreams),
                    thread_name_prefix="wal-writer",
                )
            # Writer pool: independent partitions' fsyncs overlap in the
            # kernel instead of serializing behind one fd. Any failure
            # surfaces here and durable_seq does not advance.
            list(self._pool.map(WriteAheadLog.fsync_if_dirty, dirty))
        elif dirty:
            dirty[0].fsync_if_dirty()
        group = len(self._pending)
        self._pending.clear()
        self._staged_bytes = 0
        self._last_flush = time.monotonic()
        if self._wm is not None and self._last_appended >= 0:
            # The watermark record is itself fsync'd: after a crash its
            # last seq is exactly what recovery may trust.
            self._wm.append(self._last_appended, b"", sync=True)
        self.metrics.count("wal.flushes")
        self.metrics.observe("wal.group_size", group)
        self._publish_gauges()
        obs_events.emit(
            "wal.durable", through=int(self.durable_seq), group=group
        )
        return group

    def checkpoint(self, view: Any, step: int) -> None:
        """Anchor: durable full state at `step`, then compact every
        closed segment fully covered by it — PER STREAM, so a stream
        whose every record is covered compacts independently of its
        busier siblings. Call only for state already PUBLISHED at this
        step — the watermark must never pass what gossip has seen."""
        self.flush()  # compaction must never outrun durability acks
        save_dense_checkpoint(
            os.path.join(self.dir, self.SNAP), self.name, view, step=step
        )
        for st in self.streams:
            st.compact(step)
        if self._wm is not None:
            self._wm.compact(step)
        self.metrics.count("wal.checkpoints")
        obs_events.emit("wal.checkpoint", step=step)

    # -- recovery ----------------------------------------------------------

    def recover(self, like_view: Any) -> Tuple[Optional[Any], int, Set[int]]:
        """-> (recovered_view_or_None, last_step, owned_union).

        recovered_view = checkpoint ⊔ WAL-delta suffix; the suffix is
        the per-partition streams MERGED BY SEQ (global seq order, so
        the delta-chaining argument holds exactly as in the
        single-stream case); last_step is the highest durable step
        (-1 = nothing recovered); owned_union is every replica id the
        lost incarnation logged ownership of. In async mode the open
        already truncated every stream to the wm watermark, so what we
        replay here is precisely the certified-durable prefix.

        Pager spill blobs (core/pager.py) under this WAL dir are
        discarded first: a spill file is a residency cache of state that
        is durable here, and the dead incarnation may have been killed
        mid-spill — recovery rebuilds all-resident from checkpoint+WAL
        and must never resurrect a possibly-torn blob."""
        from ..core import pager as pg
        from ..parallel.delta import apply_any_delta, like_delta_for

        dropped = pg.discard_spill(self.dir)
        if dropped:
            self.metrics.count("pager.spills_discarded", dropped)

        state: Optional[Any] = None
        last_step = -1
        snap_path = os.path.join(self.dir, self.SNAP)
        if os.path.exists(snap_path):
            try:
                step, _name, state = load_dense_checkpoint(
                    snap_path, like_view, dense=self.dense
                )
                last_step = max(last_step, int(step))
                self.metrics.count("wal.recovered_snapshot")
            except Exception:  # noqa: BLE001 — a torn/foreign checkpoint
                state = None   # must not block WAL replay (total recovery)
        like_delta = like_delta_for(self.dense, like_view)
        owned: Set[int] = set()
        parts_touched: Set[int] = set()
        n = 0
        merged: List[Tuple[int, bytes]] = []
        for st in self.streams:
            merged.extend(st.records())
        merged.sort(key=lambda sp: sp[0])
        for seq, payload in merged:
            try:
                rec = serial.decode_term(payload)
                # Arity is the version marker: legacy records are
                # (step, owned, blob); partition-tagged ones append the
                # partition list. Both replay identically — the tag is
                # metadata, the delta blob is the state.
                if len(rec) == 4:
                    step, rec_owned, blob, rec_parts = rec
                else:
                    step, rec_owned, blob = rec
                    rec_parts = ()
                _name, delta = serial.loads_dense(blob, like_delta)
                base = like_view if state is None else state
                state = apply_any_delta(self.dense, base, delta)
            except Exception:  # noqa: BLE001 — skip undecodable record,
                continue       # the join tolerates gaps (next snapshot wins)
            owned.update(int(r) for r in rec_owned)
            parts_touched.update(int(p) for p in rec_parts)
            last_step = max(last_step, int(step))
            n += 1
        if n:
            self.metrics.count("wal.recovered_records", n)
        obs_events.emit(
            "wal.recover",
            records=n,
            last_step=last_step,
            owned=sorted(owned),
            parts=sorted(parts_touched),
            had_checkpoint=os.path.exists(snap_path),
            durable_through=int(self.durable_seq),
            mode=self.durability,
        )
        return state, last_step, owned

    def close(self) -> None:
        if self._pending:
            self.flush()
        for st in self.streams:
            st.close()
        if self._wm is not None:
            self._wm.close()
            self._wm = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
