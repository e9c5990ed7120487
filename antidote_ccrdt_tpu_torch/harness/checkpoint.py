"""Checkpoint / resume: write-ahead op journal + state snapshots (port of
``antidote_ccrdt_tpu/harness/checkpoint.py``; the files are the same
bytes, so either package loads what the other wrote).

The reference's only persistence is whole-state ``to_binary/1`` with no
journal and no versioning (SURVEY.md §5): a crashed materializer loses
every op since the last snapshot. Here the harness gets the full recipe a
host database would use:

* `Journal` — a write-ahead log of (origin, prepare_op) records, file-backed
  or in-memory, length-prefix framed. Prepare ops (not effects) are
  journaled because replay re-derives effects deterministically: replica
  clocks are `LogicalClock`s whose counters the snapshot captures, so
  re-running `downstream` after restore stamps identical (dc, ts) pairs.

* `CheckpointingReplay` — a `ScalarReplay` that journals every submission
  and can `snapshot()` to versioned bytes (per-replica state blobs via the
  type's own ``to_binary`` + clock counters + journal position + pending
  effect queue).

* `resume` — restore the snapshot and replay the journal suffix; the result
  is bit-identical to a run that never stopped (tested both mid-epoch and
  at sync boundaries).

Dense states checkpoint through `core.serial.dumps_dense` (npz + treedef
manifest) — see `save_dense_checkpoint` / `load_dense_checkpoint`.

The partitioned variants below (`save_partitioned_checkpoint`,
`RejoinStreamer`) make the PARTITION the unit of durability: one shard
file per partition plus a manifest commit marker, and rejoin streams
divergent partitions in lag order. This is deliberately the same axis
`harness/wal.py` shards its per-partition segment streams on:
a partition's whole durable footprint — its checkpoint shard and its
WAL stream — can be recovered, compacted, or streamed to a rejoining
worker without touching its siblings.

The mesh variant (``save_mesh_checkpoint``) writes the same files shard
by shard: each key shard of a ``mesh.MeshPlan`` saves the partitions it
owns, then one manifest commits the whole.
"""

from __future__ import annotations

import io
import os
import struct
from typing import Any, BinaryIO, Iterator, List, Optional, Tuple

from ..core import serial
from ..core.behaviour import ScalarCCRDT
from ..core.clock import LogicalClock
from ..utils import faults
from .replay import ScalarReplay

SNAP_MAGIC = b"CCKP"
SNAP_VERSION = 1


class Journal:
    """Append-only write-ahead log of (origin, prepare_op) records."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._mem: List[bytes] = []
        self._fh: Optional[BinaryIO] = None
        if path is not None:
            self._fh = open(path, "ab")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def append(self, origin: int, op: Any) -> None:
        rec = serial.encode_term((origin, op))
        frame = struct.pack("<I", len(rec)) + rec
        if self.path is not None:
            if self._fh is None:
                raise ValueError("journal is closed")
            self._fh.write(frame)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        else:
            self._mem.append(rec)

    def entries(self, start: int = 0) -> Iterator[Tuple[int, Any]]:
        """Yield (origin, prepare_op) from record index `start` on."""
        if self.path is None:
            for rec in self._mem[start:]:
                yield serial.decode_term(rec)
            return
        if self._fh is not None:
            self._fh.flush()
        with open(self.path, "rb") as f:
            i = 0
            while True:
                hdr = f.read(4)
                if not hdr:
                    return
                if len(hdr) != 4:
                    raise ValueError("truncated journal frame header")
                (n,) = struct.unpack("<I", hdr)
                rec = f.read(n)
                if len(rec) != n:
                    raise ValueError("truncated journal record")
                if i >= start:
                    yield serial.decode_term(rec)
                i += 1

    def __len__(self) -> int:
        if self.path is None:
            return len(self._mem)
        return sum(1 for _ in self.entries())

    def repair(self) -> int:
        """Crash-consistent open: truncate a torn tail in place.

        A process killed mid-append leaves a partial final frame (the
        header or record cut short). `entries()` stays STRICT — a torn
        read in the middle of normal operation is a real error — but
        recovery (`resume`) calls this first: scan frames from the
        start, find the end of the last complete record, truncate the
        file there, and return the number of bytes discarded. The intact
        prefix is exactly what was durable (appends fsync per record),
        and truncating — rather than skipping — matters because later
        appends must land after the last good frame, not after garbage.
        """
        if self.path is None:
            return 0
        if self._fh is not None:
            self._fh.flush()
        size = os.path.getsize(self.path)
        good = 0
        with open(self.path, "rb") as f:
            while True:
                hdr = f.read(4)
                if len(hdr) != 4:
                    break
                (n,) = struct.unpack("<I", hdr)
                rec = f.read(n)
                if len(rec) != n:
                    break
                good += 4 + n
        torn = size - good
        if torn:
            os.truncate(self.path, good)
            if self._fh is not None:
                # Reopen the append handle: a buffered position past the
                # truncation point would resurrect the torn bytes.
                self._fh.close()
                self._fh = open(self.path, "ab")
        return torn


class CheckpointingReplay(ScalarReplay):
    """ScalarReplay with a write-ahead journal and snapshot/resume."""

    def __init__(
        self,
        crdt: ScalarCCRDT,
        n_replicas: int,
        new_args: tuple = (),
        journal: Optional[Journal] = None,
    ):
        super().__init__(crdt, n_replicas, new_args=new_args)
        self.journal = journal if journal is not None else Journal()
        self.seq = 0  # journal records reflected in this replay's state
        self.new_args = new_args

    def submit(self, origin: int, prepare_op: Any):
        self.journal.append(origin, prepare_op)
        self.seq += 1
        return super().submit(origin, prepare_op)

    def sync(self) -> None:
        # Sync points must be journaled: effects re-derived on replay pass
        # through `downstream`, whose output depends on the origin state,
        # which depends on *when* remote effects were delivered. Marker
        # records (origin = -1) make replay re-sync at the same boundaries.
        self.journal.append(-1, None)
        self.seq += 1
        super().sync()

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> bytes:
        """Versioned snapshot of everything `resume` needs. The journal
        itself is not embedded — it is the durable log living beside the
        snapshot, exactly how a database pairs WAL + checkpoint."""
        clocks = [ctx.clock.get_time() for ctx in self.ctxs]
        shared = all(c is self.ctxs[0].clock for c in (ctx.clock for ctx in self.ctxs))
        body = serial.encode_term(
            {
                "name": self.crdt.type_name,
                "new_args": tuple(self.new_args),
                "states": [self.crdt.to_binary(s) for s in self.states],
                "clocks": clocks,
                "shared_clock": shared,
                "seq": self.seq,
                "pending": [
                    (o, serial.encode_term(e)) for (o, e) in self.effect_log
                ],
                "ops_applied": self.ops_applied,
            }
        )
        return SNAP_MAGIC + bytes([SNAP_VERSION]) + body


def _restore(crdt: ScalarCCRDT, snap: bytes, journal: Journal) -> CheckpointingReplay:
    if snap[:4] != SNAP_MAGIC:
        raise ValueError("not a CCRDT checkpoint (bad magic)")
    if snap[4] > SNAP_VERSION:
        raise ValueError(f"checkpoint version {snap[4]} newer than {SNAP_VERSION}")
    d = serial.decode_term(snap[5:])
    if d["name"] != crdt.type_name:
        raise ValueError(f"checkpoint is for {d['name']!r}, not {crdt.type_name!r}")
    rp = CheckpointingReplay(crdt, len(d["states"]), new_args=d["new_args"], journal=journal)
    rp.states = [crdt.from_binary(b) for b in d["states"]]
    rp.seq = d["seq"]
    rp.ops_applied = d["ops_applied"]
    rp.effect_log = [(o, serial.decode_term(e)) for (o, e) in d["pending"]]
    if d["shared_clock"]:
        clk = LogicalClock(max(d["clocks"]))
        for ctx in rp.ctxs:
            ctx.clock = clk
    else:
        for ctx, t in zip(rp.ctxs, d["clocks"]):
            ctx.clock = LogicalClock(t)
    return rp


def resume(
    crdt: ScalarCCRDT,
    snapshot: Optional[bytes],
    journal: Journal,
    n_replicas: Optional[int] = None,
    new_args: tuple = (),
) -> CheckpointingReplay:
    """Restore from `snapshot` (or fresh state if None) and replay the
    journal suffix. Deterministic: replayed prepare ops re-derive the same
    effect ops because the snapshot restored the logical clocks.

    Recovery is crash-consistent: a torn final journal record (the crash
    landed mid-append) is truncated away first (`Journal.repair`) — the
    intact prefix replays, the tail is discarded."""
    journal.repair()
    if snapshot is None:
        if n_replicas is None:
            raise ValueError("n_replicas required when starting without a snapshot")
        rp = CheckpointingReplay(crdt, n_replicas, new_args=new_args, journal=journal)
        start = 0
    else:
        rp = _restore(crdt, snapshot, journal)
        start = rp.seq
    for origin, op in journal.entries(start):
        # bypass self.journal.append — these records are already durable
        if origin == -1:
            ScalarReplay.sync(rp)
        else:
            ScalarReplay.submit(rp, origin, op)
        rp.seq += 1
    return rp


# -- dense checkpoints -----------------------------------------------------


def save_dense_checkpoint(path: str, name: str, state: Any, step: int = 0) -> None:
    """Atomic (write+rename) dense-state checkpoint file."""
    blob = serial.dumps_dense(name, state)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", step))
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    # Fault point `ckpt.replace`: a raise here is a crash between the
    # durable tmp write and the commit — the previous checkpoint must
    # survive untouched (the .tmp is harmless debris).
    if faults.ACTIVE:
        faults.fire("ckpt.replace")
    os.replace(tmp, path)


def load_dense_checkpoint(
    path: str, like: Any, dense: Any = None
) -> Tuple[int, str, Any]:
    """Returns (step, name, state) with `state` in the structure of `like`.

    Pass the dense engine as `dense` to structurally validate the restored
    state against the engine config (utils.validate.check_state) — a
    checkpoint written under different capacities (I/M/D/K) otherwise
    surfaces only as silent wrong answers deep in the kernels."""
    with open(path, "rb") as f:
        data = f.read()
    (step,) = struct.unpack("<Q", data[:8])
    name, state = serial.loads_dense(data[8:], like)
    if dense is not None:
        from ..utils.validate import check_state

        check_state(dense, state)
    return step, name, state


# -- partitioned (sharded) dense checkpoints --------------------------------
#
# One file per partition (`shard-<part>.ckpt`, a CCPT psnap container —
# core/partition.py) plus a `manifest.json` commit marker. The unit of
# durability is the PARTITION: a rejoining worker streams and persists
# state shard by shard, and a crash mid-stream (SIGKILL between shards)
# costs only the partition in flight — restart resumes from the last
# durable shard instead of refetching one giant blob.

_SHARD_PREFIX = "shard-"
_SHARD_SUFFIX = ".ckpt"
_MANIFEST = "manifest.json"


def _shard_path(root: str, part: int) -> str:
    return os.path.join(root, f"{_SHARD_PREFIX}{part:04d}{_SHARD_SUFFIX}")


def _write_shard(
    root: str, name: str, dense: Any, state: Any, part: int, P: int,
    step: int, pager: Any = None,
) -> int:
    """Atomically persist partition `part` of `state`; returns bytes.
    With a pager, a demoted partition's shard is written straight from
    its stored CCPT payload (transfer format is storage format) — no
    hydration to checkpoint."""
    from ..core import partition as pt

    if pager is not None:
        payload = pager.psnap_payload(state, part)
    else:
        payload = serial.dumps_dense(
            f"{name}_psnap", pt.restrict_psnap(dense, state, part, P)
        )
    blob = pt.encode_psnap_blob(step, part, payload)
    path = _shard_path(root, part)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    if faults.ACTIVE:
        faults.fire("ckpt.replace")
    os.replace(tmp, path)
    return len(blob)


def save_partitioned_checkpoint(
    root: str, name: str, state: Any, dense: Any, step: int,
    partitions: Optional[int] = None,
    parts: Optional[List[int]] = None,
    pager: Any = None,
) -> int:
    """Shard `state` into per-partition checkpoint files (P id
    partitions + the meta partition) and commit with a manifest.
    Returns total bytes written. Shards first, manifest last: the
    manifest is the whole-checkpoint commit point, but each shard is
    individually durable the moment it lands (what the rejoin streamer
    relies on). `parts` restricts the write to a subset — the mesh
    path (`save_mesh_checkpoint`) saves each key shard's owned
    partitions separately; because `_write_shard` is a pure function of
    (state, part), the union of per-shard saves is byte-identical to
    one whole save. A subset save writes no manifest (it is a slice,
    not a commit point)."""
    from ..core import partition as pt

    P = partitions if partitions else pt.n_partitions()
    os.makedirs(root, exist_ok=True)
    total = 0
    todo = sorted(int(p) for p in parts) if parts is not None else range(P + 1)
    for part in todo:
        total += _write_shard(root, name, dense, state, part, P, step,
                              pager=pager)
    if parts is not None:
        return total
    if pager is not None and pager.has_cold():
        digests = pager.digest_vector(state)
    else:
        digests = pt.state_digests(state, P)
    _write_manifest(root, name, step, P, digests)
    return total


def _write_manifest(
    root: str, name: str, step: int, P: int, digests: Any
) -> None:
    import json

    manifest = {
        "name": name,
        "step": int(step),
        "partitions": int(P),
        "digests": [int(d) for d in digests],
    }
    tmp = os.path.join(root, f"{_MANIFEST}.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(root, _MANIFEST))


def save_mesh_checkpoint(
    root: str, name: str, state: Any, dense: Any, step: int, plan: Any,
    pager: Any = None,
) -> int:
    """Shard-grouped checkpoint: each key shard of a `mesh.MeshPlan`
    persists exactly the partitions it owns (`parts=owned_parts(s)`),
    then the manifest commits the whole — the mesh counterpart of
    `save_partitioned_checkpoint`, producing byte-identical files
    (pinned by test_mesh.py). The digest vector in the manifest is
    produced shard-by-shard and stitched (mesh/gossip.py)."""
    from ..mesh import gossip as mesh_gossip

    total = 0
    for s in range(plan.n_key):
        total += save_partitioned_checkpoint(
            root, name, state, dense, step,
            partitions=plan.P, parts=plan.owned_parts(s), pager=pager,
        )
    digests = mesh_gossip.sharded_digest_vector(state, plan, pager=pager)
    _write_manifest(root, name, step, plan.P, digests)
    return total


def load_partitioned_checkpoint(
    root: str, base: Any, dense: Any
) -> Tuple[int, Optional[str], Any, List[int]]:
    """-> (step, name, state, durable_parts): join every decodable shard
    under `root` into `base`. Tolerates a PARTIAL checkpoint — missing,
    torn, or foreign shards are skipped, not fatal (the streamer resumes
    exactly from what this reports durable). `step` is the highest shard
    seq seen (-1 = nothing durable). Falls back to a legacy single-file
    whole-instance checkpoint (`snap.ckpt`) when no shards exist, so
    pre-partition checkpoint directories keep restoring."""
    from ..core import partition as pt
    from ..parallel.delta import apply_any_delta, like_delta_for

    state, step, name = base, -1, None
    durable: List[int] = []
    if not os.path.isdir(root):
        return step, name, state, durable
    shards = sorted(
        f for f in os.listdir(root)
        if f.startswith(_SHARD_PREFIX) and f.endswith(_SHARD_SUFFIX)
    )
    if not shards:
        legacy = os.path.join(root, "snap.ckpt")
        if os.path.exists(legacy):
            try:
                step, name, state = load_dense_checkpoint(
                    legacy, base, dense=dense
                )
            except Exception:  # noqa: BLE001 — torn legacy file: nothing
                pass           # durable, same contract as missing shards
        return step, name, state, durable
    like_delta = like_delta_for(dense, base)
    for fname in shards:
        try:
            with open(os.path.join(root, fname), "rb") as f:
                blob = f.read()
            seq, part, payload = pt.decode_psnap_blob(blob)
            got_name, delta = serial.loads_dense(payload, like_delta)
            state = apply_any_delta(dense, state, delta)
        except Exception:  # noqa: BLE001 — skip the torn shard; the
            continue       # streamer refetches it
        durable.append(int(part))
        step = max(step, int(seq))
        if name is None and got_name.endswith("_psnap"):
            name = got_name[: -len("_psnap")]
    return step, name, state, durable


class RejoinStreamer:
    """Incremental, resumable rejoin: instead of swallowing a peer's
    whole snapshot, stream state PARTITION BY PARTITION, persisting each
    one durably (`_write_shard`) before moving to the next.

    Order is lowest-lag first: partitions whose digests already agree
    with the peer complete immediately (persisted from local state, zero
    transfer), then divergent partitions stream in ascending order. A
    SIGKILL between shards costs only the partition in flight — the next
    incarnation's `start()` loads the durable shards, re-diffs digests,
    and plans only what is still missing (tests pin the drill).

    Counters: `rejoin.parts_streamed`, `rejoin.parts_skipped` (already
    durable/agreeing), `rejoin.stream_bytes`."""

    def __init__(
        self, root: str, name: str, dense: Any, store: Any, peer: str,
        partitions: Optional[int] = None, metrics: Any = None,
    ):
        from ..core import partition as pt

        self.root = root
        self.name = name
        self.dense = dense
        self.store = store
        self.peer = peer
        self.partitions = partitions if partitions else pt.n_partitions()
        self.metrics = metrics if metrics is not None else store.metrics
        self.plan: List[int] = []
        self.peer_seq: int = -1
        self._pt = pt
        os.makedirs(root, exist_ok=True)

    def start(self, base: Any) -> Any:
        """Join durable shards into `base`, diff digests against the
        peer, and plan the remaining stream. Returns the restored state
        (call `step`/`run` next). With no peer digest vector (legacy
        peer), the plan covers every partition — still streamed and
        persisted one at a time."""
        from ..obs import events as obs_events

        pt, P = self._pt, self.partitions
        step, _name, state, durable = load_partitioned_checkpoint(
            self.root, base, self.dense
        )
        got = self.store.fetch_digests(self.peer)
        if got is None:
            self.plan = [p for p in range(P + 1)]
            self.peer_seq = -1
        else:
            self.peer_seq, peer_vec = got
            own_vec = pt.state_digests(state, P)
            div = set(pt.divergent_parts(own_vec, peer_vec))
            # Lowest-lag first: agreeing partitions are done — persist
            # any not yet durable straight from local state.
            for p in range(P + 1):
                if p in div:
                    continue
                if p not in durable:
                    _write_shard(
                        self.root, self.name, self.dense, state, p, P,
                        max(0, self.peer_seq),
                    )
                self.metrics.count("rejoin.parts_skipped")
            self.plan = sorted(div)
        self.store.request_psnaps(self.peer, self.plan)
        obs_events.emit(
            "rejoin.plan", origin=self.peer, parts=list(self.plan),
            durable=sorted(durable),
        )
        return state

    def step(self, state: Any) -> Tuple[Any, Optional[int], bool]:
        """Stream ONE partition: fetch its psnap, join it, persist the
        shard. -> (state, part_streamed_or_None, finished). `None` with
        finished=False means the psnap is still in flight (push media) —
        advance the medium and call again."""
        from ..obs import events as obs_events
        from ..parallel.delta import delta_in_bounds, like_delta_for

        if not self.plan:
            return state, None, True
        p = self.plan[0]
        like = like_delta_for(self.dense, state)
        r = self.store.fetch_psnap(
            self.peer, p, like,
            validate=lambda d: delta_in_bounds(self.dense, state, d),
        )
        if r is None:
            self.store.request_psnaps(self.peer, [p])
            return state, None, False
        seq, payload = r
        from ..parallel.delta import apply_any_delta

        state = apply_any_delta(self.dense, state, payload)
        nbytes = _write_shard(
            self.root, self.name, self.dense, state, p, self.partitions,
            max(seq, self.peer_seq, 0),
        )
        self.plan.pop(0)
        self.metrics.count("rejoin.parts_streamed")
        self.metrics.count("rejoin.stream_bytes", nbytes)
        obs_events.emit(
            "rejoin.part", origin=self.peer, part=p, bytes=nbytes,
            remaining=len(self.plan),
        )
        return state, p, not self.plan

    def run(self, state: Any, max_stalls: int = 64,
            advance=None) -> Any:
        """Drain the plan. `advance` (optional callable) pumps the
        medium between stalled fetches — the sim drill passes
        `lambda: net.advance(dt)`; real transports just retry."""
        stalls = 0
        while self.plan and stalls < max_stalls:
            state, part, _done = self.step(state)
            if part is None:
                stalls += 1
                if advance is not None:
                    advance()
            else:
                stalls = 0
        return state
