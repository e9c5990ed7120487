"""Blob-plane `Transport` protocol + filesystem transport + state facade.

Extraction of the medium out of `parallel.elastic.GossipStore`: the
gossip tier's needs reduce to publishing/fetching OPAQUE BYTES keyed by
(member, kind, seq) plus a liveness surface. Everything the engines care
about — checkpoint headers, treedef validation, delta chaining — lives
ABOVE the medium in `GossipNode`, so `DeltaPublisher`, `sweep_deltas`,
`sweep`, and `my_replicas` run unchanged over a shared directory
(`FsTransport`), real sockets (`net.tcp.TcpTransport`), or the
deterministic simulator (`net.sim.SimTransport`).

Blob formats are transport-invariant:

* snapshot blob = ``u64le step ++ core.serial.dumps_dense(name, state)``
  (identical bytes to `harness.checkpoint.save_dense_checkpoint`, so
  on-disk artifacts from older rounds remain readable);
* delta blob    = ``core.serial.dumps_dense(f"{name}_delta", delta)``.

Heartbeats: `FsTransport` writes an 8-byte little-endian wall-clock
timestamp PAYLOAD into `hb-<member>` (atomic replace) and reads that —
file mtime is only the fallback for empty/foreign heartbeat files,
because mtime is flaky on coarse-granularity or object-store-backed
filesystems (the first GossipStore relied on mtime alone). Socket and
sim transports track liveness via `net.membership` instead.

Port of ``antidote_ccrdt_tpu/net/transport.py``: the same blobs. An anchor
of the partition plane deflates its psnaps PSNAP_THREADS at a time on
threads (`GossipNode.publish_partitioned`).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Protocol, Tuple, runtime_checkable

from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..topo import zones as topo_zones
from ..utils import faults
from ..utils.metrics import Metrics

# -- range-framed delta blobs (ingest fast path) ------------------------------
# A compacted frame covers the publisher's windows [lo..hi] in ONE blob,
# published at seq=hi:  b"CCRF" ++ u64le lo ++ u64le hi ++ delta payload.
# The magic differs from core.serial's b"CCRD" at byte 3, so a legacy
# receiver handed a framed blob fails serial decode (total-failure policy
# reads None) and falls back to the snapshot anchor — backward interop
# without a wire-protocol version bump. A range-aware receiver strips the
# header and treats a bare payload as the degenerate frame [seq..seq].

# An anchor's psnaps without a pager (`GossipNode.publish_partitioned`)
# are built this many at a time and deflated side by side on as many
# threads (zlib lets go of the interpreter): the same blobs, published in
# the same order, at most this many raw payloads held at once.
PSNAP_THREADS = 4

FRAME_MAGIC = b"CCRF"
_FRAME_HDR = len(FRAME_MAGIC) + 16  # magic + u64 lo + u64 hi


def encode_range_frame(lo: int, hi: int, payload: bytes) -> bytes:
    """Wrap a serialized delta covering windows [lo..hi]."""
    if not 0 <= lo <= hi:
        raise ValueError(f"bad frame range [{lo}..{hi}]")
    return FRAME_MAGIC + struct.pack("<QQ", lo, hi) + payload


def decode_range_frame(
    blob: bytes, seq: int
) -> Tuple[int, int, bytes]:
    """(lo, hi, payload) of a delta blob fetched at `seq`: framed blobs
    decode their header, bare (legacy) blobs read as [seq..seq]."""
    if blob[:4] == FRAME_MAGIC and len(blob) >= _FRAME_HDR:
        lo, hi = struct.unpack_from("<QQ", blob, 4)
        return int(lo), int(hi), blob[_FRAME_HDR:]
    return seq, seq, blob


def frame_range(blob: bytes, seq: int) -> Tuple[int, int]:
    """Header-only peek at the windows a delta blob covers."""
    lo, hi, _ = decode_range_frame(blob[:_FRAME_HDR], seq)
    return lo, hi


@runtime_checkable
class Transport(Protocol):
    """What a gossip medium must provide. Blobs are opaque bytes; `seq`
    namespacing and retention (`keep`) follow the delta-shipping
    discipline documented in `parallel.delta`. All methods must be
    total: a missing/torn/unreachable artifact reads as None/[], never
    an exception — join-based gossip retries on the next sweep."""

    member: str

    # -- liveness ----------------------------------------------------------
    def heartbeat(self) -> None: ...
    def members(self) -> List[str]: ...
    def alive_members(self, timeout_s: float) -> List[str]: ...

    # -- snapshots (latest-wins, one slot per member) ----------------------
    def publish(self, blob: bytes) -> None: ...
    def fetch(self, member: str) -> Optional[bytes]: ...
    def fetch_head(self, member: str, n: int) -> Optional[bytes]: ...
    def snapshot_members(self) -> List[str]: ...

    # -- deltas (per-member seq-keyed window) ------------------------------
    def publish_delta(self, seq: int, blob: bytes, keep: int = 16) -> None: ...
    def fetch_delta(self, member: str, seq: int) -> Optional[bytes]: ...
    def delta_seqs(self, member: str) -> List[int]: ...
    def delta_members(self) -> List[str]: ...

    # -- partition plane (optional; see core.partition) --------------------
    # Digest blobs are tiny P+1-entry summaries pushed like snapshots;
    # psnap blobs are per-partition partial snapshots that are STORED,
    # not broadcast — peers pull only divergent partitions. Transports
    # without these methods degrade to whole-instance resync (GossipNode
    # probes with getattr), which is also the mixed-version-fleet path.
    def publish_digest(self, blob: bytes) -> None: ...
    def fetch_digest(self, member: str) -> Optional[bytes]: ...
    def publish_psnap(self, part: int, blob: bytes) -> None: ...
    def fetch_psnap(self, member: str, part: int) -> Optional[bytes]: ...
    def request_psnaps(self, member: str, parts: List[int]) -> None: ...

    def close(self) -> None: ...

    def peers(self) -> List[str]:
        """Everyone ever seen, excluding self."""
        ...


class FsTransport:
    """Shared-directory medium (the original `GossipStore` file layout).

    Layout: `<root>/snap-<member>` (latest snapshot blob, atomic
    replace), `<root>/delta-<member>-<seq:08d>`, `<root>/hb-<member>`
    (8-byte timestamp payload, mtime fallback). One writer per member
    id; any number of readers."""

    def __init__(self, root: str, member: str, metrics: Optional[Metrics] = None):
        self.root = root
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        os.makedirs(root, exist_ok=True)
        self.heartbeat()

    # -- liveness ----------------------------------------------------------

    def heartbeat(self) -> None:
        p = os.path.join(self.root, f"hb-{self.member}")
        # Thread-unique tmp name: with the overlap pipeline, the
        # heartbeat daemon and the host-stage thread (publish →
        # heartbeat) beat concurrently — a shared tmp would let one
        # thread's replace() delete the other's file mid-write.
        tmp = f"{p}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(struct.pack("<d", time.time()))
        os.replace(tmp, p)

    def _heartbeat_age(self, member: str) -> Optional[float]:
        """Seconds since `member` last beat, or None (no evidence).
        Reads the timestamp payload; falls back to file mtime for
        empty/short files (a foreign writer using the pre-payload
        format, or a torn write)."""
        p = os.path.join(self.root, f"hb-{member}")
        try:
            with open(p, "rb") as f:
                payload = f.read(8)
            if len(payload) == 8:
                return time.time() - struct.unpack("<d", payload)[0]
            return time.time() - os.path.getmtime(p)
        except OSError:
            return None

    def members(self) -> List[str]:
        return sorted(
            f[3:]
            for f in os.listdir(self.root)
            if f.startswith("hb-") and ".tmp" not in f
        )

    def peers(self) -> List[str]:
        return [m for m in self.members() if m != self.member]

    def alive_members(self, timeout_s: float) -> List[str]:
        """Members whose heartbeat is fresher than `timeout_s`. Always
        includes self (a member never suspects itself)."""
        out = []
        for m in self.members():
            if m == self.member:
                out.append(m)
                continue
            age = self._heartbeat_age(m)
            if age is not None and age <= timeout_s:
                out.append(m)
        return sorted(out)

    # -- snapshots ---------------------------------------------------------

    def publish(self, blob: bytes) -> None:
        if faults.ACTIVE:
            mangled = faults.mangle("transport.publish", blob)
            if mangled is None:
                return  # injected drop: the publish silently never lands
            blob = mangled
        path = os.path.join(self.root, f"snap-{self.member}")
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self.heartbeat()

    def fetch(self, member: str) -> Optional[bytes]:
        try:
            with open(os.path.join(self.root, f"snap-{member}"), "rb") as f:
                return f.read()
        except OSError:
            return None

    def fetch_head(self, member: str, n: int) -> Optional[bytes]:
        try:
            with open(os.path.join(self.root, f"snap-{member}"), "rb") as f:
                return f.read(n)
        except OSError:
            return None

    def snapshot_members(self) -> List[str]:
        return sorted(
            f[5:]
            for f in os.listdir(self.root)
            if f.startswith("snap-") and ".tmp" not in f
        )

    # -- deltas ------------------------------------------------------------

    def publish_delta(self, seq: int, blob: bytes, keep: int = 16) -> None:
        if faults.ACTIVE:
            mangled = faults.mangle("transport.publish_delta", blob)
            if mangled is None:
                return  # injected drop
            blob = mangled
        path = os.path.join(self.root, f"delta-{self.member}-{seq:08d}")
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            # fsync BEFORE the rename commits the name, matching `publish`:
            # without it a crash can leave delta-<m>-<seq> present but
            # empty/torn, which a peer reads as seq-present-but-garbage
            # (fetch_delta decodes to None forever — a permanent chain
            # break at that seq until the window prunes it).
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # The fs-medium analog of a tcp frame.send: the moment this
        # origin's delta became visible to peers. Same (origin, dseq)
        # trace context, so delta_paths() sees one "write"/"send" stage
        # regardless of medium.
        obs_events.emit(
            "transport.delta_write",
            origin=self.member,
            dseq=seq,
            bytes=len(blob),
        )
        self.heartbeat()
        for s in self.delta_seqs(self.member):
            if s <= seq - keep:
                try:
                    os.remove(
                        os.path.join(self.root, f"delta-{self.member}-{s:08d}")
                    )
                except OSError:
                    pass

    def fetch_delta(self, member: str, seq: int) -> Optional[bytes]:
        try:
            # The fault point sits INSIDE the try: an injected OSError
            # reads as None, preserving the Transport totality contract
            # (exactly how a real EIO on this read must behave).
            if faults.ACTIVE:
                faults.fire("transport.fetch_delta")
            with open(
                os.path.join(self.root, f"delta-{member}-{seq:08d}"), "rb"
            ) as f:
                blob = f.read()
            if faults.ACTIVE:
                blob = faults.mangle("transport.fetch_delta.read", blob)
            return blob
        except OSError:
            return None

    def delta_seqs(self, member: str) -> List[int]:
        pre = f"delta-{member}-"
        out = []
        for f in os.listdir(self.root):
            if f.startswith(pre) and ".tmp" not in f:
                try:
                    out.append(int(f[len(pre):]))
                except ValueError:
                    continue
        return sorted(out)

    def delta_members(self) -> List[str]:
        # Strip "delta-" prefix and "-<seq>" suffix (member names may
        # themselves contain dashes).
        return sorted(
            {
                f[len("delta-"):].rsplit("-", 1)[0]
                for f in os.listdir(self.root)
                if f.startswith("delta-") and ".tmp" not in f
            }
        )

    # -- partition plane ---------------------------------------------------
    # `dig-<member>` (latest digest vector blob, atomic replace) and
    # `psnap-<member>-<part:04d>`. On a shared directory the fetch IS the
    # request, so `request_psnaps` is a no-op and partial resync resolves
    # within one sweep.

    def publish_digest(self, blob: bytes) -> None:
        if faults.ACTIVE:
            mangled = faults.mangle("transport.publish", blob)
            if mangled is None:
                return
            blob = mangled
        path = os.path.join(self.root, f"dig-{self.member}")
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def fetch_digest(self, member: str) -> Optional[bytes]:
        try:
            with open(os.path.join(self.root, f"dig-{member}"), "rb") as f:
                return f.read()
        except OSError:
            return None

    def publish_psnap(self, part: int, blob: bytes) -> None:
        if faults.ACTIVE:
            mangled = faults.mangle("transport.publish", blob)
            if mangled is None:
                return
            blob = mangled
        path = os.path.join(self.root, f"psnap-{self.member}-{part:04d}")
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def fetch_psnap(self, member: str, part: int) -> Optional[bytes]:
        try:
            with open(
                os.path.join(self.root, f"psnap-{member}-{part:04d}"), "rb"
            ) as f:
                return f.read()
        except OSError:
            return None

    def request_psnaps(self, member: str, parts: List[int]) -> None:
        pass  # pull medium: fetch_psnap reads the peer's files directly

    def close(self) -> None:
        pass


class GossipNode:
    """State-plane facade over any `Transport`: the exact surface the
    original `GossipStore` exposed to `parallel.elastic`, so every gossip
    entry point (`DeltaPublisher`, `sweep`, `sweep_deltas`,
    `my_replicas`) and drill runs unchanged over filesystem, TCP, or
    simulated media.

    Encoding/decoding and validation live here (not in transports):
    snapshot blobs carry the dense-checkpoint layout, fetches are TOTAL
    (any decode/validation failure reads as None — a torn concurrent
    write or a peer on a mismatched engine config must be skipped, not
    crash the gossip loop; the next sweep retries)."""

    def __init__(self, transport: Transport, metrics: Optional[Metrics] = None):
        self.transport = transport
        self.member = transport.member
        # Zone passthrough for transports running the topo/ layer, with
        # the CCRDT_ZONE env fallback for zone-less media (FsTransport):
        # a mesh-sharded worker gossiping through a shared directory is
        # still ON a slice (topo/zones.py slice_zone), and drills and
        # dashboards read the label off the node instead of reaching
        # into the transport. None when neither source names one.
        self.zone = (
            getattr(transport, "zone", None)
            or os.environ.get(topo_zones.ENV_ZONE)
            or None
        )
        self.metrics = (
            metrics
            if metrics is not None
            else getattr(transport, "metrics", None) or Metrics()
        )

    # -- liveness (delegated) ----------------------------------------------

    def heartbeat(self) -> None:
        self.transport.heartbeat()

    def members(self) -> List[str]:
        return self.transport.members()

    def alive_members(self, timeout_s: float) -> List[str]:
        return self.transport.alive_members(timeout_s)

    # -- snapshots ---------------------------------------------------------

    def publish(self, name: str, state: Any, step: int) -> None:
        """Atomically publish this member's state at `step` (and beat)."""
        from ..core import serial

        blob = struct.pack("<Q", step) + serial.dumps_dense(name, state)
        self.metrics.count("net.snap_publishes")
        self.metrics.count("net.snap_bytes", len(blob))
        obs_events.emit(
            "snap.publish", origin=self.member, step=step, bytes=len(blob)
        )
        if obs_spans.ACTIVE:
            # Handing the blob to the medium (fs write / tcp enqueue /
            # sim heap push) — the host cost of putting it in flight.
            with obs_spans.span(
                "round.gossip_send", kind="snap", step=step, bytes=len(blob)
            ):
                self.transport.publish(blob)
        else:
            self.transport.publish(blob)

    def fetch(
        self, member: str, like: Any, dense: Any = None
    ) -> Optional[Tuple[int, Any]]:
        """Latest (step, state) published by `member`, or None. ANY decode
        or validation failure reads as None — see class docstring."""
        from ..core import serial

        tok = (
            obs_spans.begin("round.gossip_recv", kind="snap", origin=member)
            if obs_spans.ACTIVE
            else None
        )
        try:
            blob = self.transport.fetch(member)
        finally:
            obs_spans.end(tok)
        if blob is None:
            return None
        # Decode + validation are their own phase (round.delta_decode):
        # gossip_recv is the medium cost, this is the host parse cost —
        # splitting them is what lets the ingest gate see which side
        # regressed.
        dtok = (
            obs_spans.begin("round.delta_decode", kind="snap", origin=member)
            if obs_spans.ACTIVE
            else None
        )
        try:
            try:
                (step,) = struct.unpack("<Q", blob[:8])
                _name, state = serial.loads_dense(blob[8:], like)
                if dense is not None:
                    from ..utils.validate import check_state

                    check_state(dense, state)
            except Exception:  # noqa: BLE001 — deliberately total, see docstring
                return None
            self.metrics.count("net.snap_fetches")
            return step, state
        finally:
            obs_spans.end(dtok)

    def snapshot_seq(self, member: str) -> Optional[int]:
        """Seq/step of `member`'s snapshot from its 8-byte header —
        without parsing the (large) payload."""
        hdr = self.transport.fetch_head(member, 8)
        if hdr is None or len(hdr) < 8:
            return None
        return struct.unpack("<Q", hdr)[0]

    def snapshot_members(self) -> List[str]:
        return self.transport.snapshot_members()

    # -- deltas ------------------------------------------------------------

    def publish_delta(
        self, delta_blob: bytes, seq: int, keep: int = 16,
        lo: Optional[int] = None,
    ) -> None:
        """Atomically publish a serialized delta at `seq`; retain only the
        last `keep` (receivers that fall off the window resync from the
        full snapshot). With `lo` < `seq` the blob ships range-framed: one
        compacted frame covering the publisher's windows [lo..seq] (the
        ingest fast path — see `encode_range_frame`)."""
        if lo is not None and lo < seq:
            delta_blob = encode_range_frame(lo, seq, delta_blob)
            self.metrics.count("ingest.coalesced_frames")
            self.metrics.count("ingest.coalesced_ops", seq - lo + 1)
        else:
            lo = seq
        self.metrics.count("net.delta_publishes")
        self.metrics.count("net.delta_bytes", len(delta_blob))
        # Stage 1 of the delta propagation path: this replica minted
        # (origin, dseq) — a compacted frame mints the whole [lo..dseq]
        # range at once, and the audit treats `lo` as its chain link.
        obs_events.emit(
            "delta.publish",
            origin=self.member,
            dseq=seq,
            lo=lo,
            bytes=len(delta_blob),
        )
        if obs_spans.ACTIVE:
            with obs_spans.span(
                "round.gossip_send", kind="delta", origin=self.member,
                dseq=seq, bytes=len(delta_blob),
            ):
                self.transport.publish_delta(seq, delta_blob, keep=keep)
        else:
            self.transport.publish_delta(seq, delta_blob, keep=keep)

    def fetch_delta_blob(
        self, member: str, seq: int
    ) -> Optional[Tuple[int, int, bytes]]:
        """Raw (lo, hi, payload) at `seq` — the fetch half of
        `fetch_delta_framed`, billed to `round.gossip_recv` only. The
        prefetcher's batched decode stage pulls blobs through this and
        decodes them in one `round.delta_decode` pass."""
        tok = (
            obs_spans.begin(
                "round.gossip_recv", kind="delta", origin=member, dseq=seq
            )
            if obs_spans.ACTIVE
            else None
        )
        try:
            blob = self.transport.fetch_delta(member, seq)
        finally:
            obs_spans.end(tok)
        if blob is None:
            return None
        try:
            return decode_range_frame(blob, seq)
        except Exception:  # noqa: BLE001 — torn header reads as missing
            return None

    def decode_delta_blob(
        self, member: str, seq: int, payload: bytes, like_delta: Any,
        validate=None,
    ) -> Optional[Any]:
        """Deserialize + validate one fetched delta payload, billed to
        `round.delta_decode`. Same total-failure policy as `fetch`."""
        from ..core import serial

        tok = (
            obs_spans.begin(
                "round.delta_decode", kind="delta", origin=member, dseq=seq
            )
            if obs_spans.ACTIVE
            else None
        )
        try:
            try:
                _name, delta = serial.loads_dense(payload, like_delta)
                if validate is not None and not validate(delta):
                    return None
            except Exception:  # noqa: BLE001 — see fetch
                return None
            self.metrics.count("net.delta_fetches")
            obs_events.emit("delta.fetch", origin=member, dseq=seq)
            return delta
        finally:
            obs_spans.end(tok)

    def fetch_delta_framed(
        self, member: str, seq: int, like_delta: Any, validate=None
    ) -> Optional[Tuple[int, int, Any]]:
        """(lo, hi, delta) of the (possibly range-framed) delta stored at
        `seq`; bare legacy blobs read as the degenerate frame
        [seq..seq]. None on any fetch/decode/validate failure."""
        got = self.fetch_delta_blob(member, seq)
        if got is None:
            return None
        lo, hi, payload = got
        delta = self.decode_delta_blob(
            member, seq, payload, like_delta, validate=validate
        )
        if delta is None:
            return None
        return lo, hi, delta

    def fetch_delta(
        self, member: str, seq: int, like_delta: Any, validate=None
    ) -> Optional[Any]:
        """Deserialized delta at `seq`, or None (missing/torn/pruned/
        mis-configured — same total-failure policy as `fetch`). `validate`
        (delta -> bool) rejects structurally-decodable deltas from a peer
        on a DIFFERENT engine config before expansion can index out of
        range downstream. Range-framed blobs decode to their inner delta
        (use `fetch_delta_framed` when the covered range matters)."""
        got = self.fetch_delta_framed(member, seq, like_delta, validate)
        return None if got is None else got[2]

    def delta_seqs(self, member: str) -> List[int]:
        return self.transport.delta_seqs(member)

    def delta_members(self) -> List[str]:
        return self.transport.delta_members()

    # -- partition plane ---------------------------------------------------
    # Degrades per-method via getattr: a transport without the partition
    # surface (or a legacy peer that never publishes digests) reads as
    # None everywhere, and callers fall back to whole-instance resync.

    def partitions_supported(self) -> bool:
        return all(
            hasattr(self.transport, m)
            for m in ("publish_digest", "fetch_digest", "publish_psnap",
                      "fetch_psnap", "request_psnaps")
        )

    def publish_partitioned(
        self, name: str, state: Any, seq: int, dense: Any, P: int,
        plan: Optional[Any] = None, pager: Optional[Any] = None,
    ) -> Optional[Any]:
        """Anchor-time partition publish: the P+1 digest vector (pushed
        like a snapshot — tiny) plus psnap blobs for every partition whose
        digest changed since the last anchor (ALL partitions on the first;
        the psnap store is cumulative, so it is complete from then on).
        With a `mesh.MeshPlan`, the digest vector and the psnaps are
        produced shard by shard — each key shard contributes exactly the
        slice it owns, stitched back into the same wire blobs (the
        artifacts are byte-identical either way, which test_mesh.py
        pins), billing per-shard counters for the chaos gate. With a
        `core.pager.PartitionPager`, digests and psnaps for demoted
        partitions come from the pager's stored CCPT blobs — the
        transfer format is the storage format, so a cold partition is
        served without hydrating. Returns the digest vector, or None
        when the medium has no partition surface."""
        from ..core import partition as pt
        from ..core import serial

        pub_dig = getattr(self.transport, "publish_digest", None)
        pub_ps = getattr(self.transport, "publish_psnap", None)
        if pub_dig is None or pub_ps is None:
            return None
        if plan is not None:
            from ..mesh import gossip as mesh_gossip

            vec = mesh_gossip.sharded_digest_vector(
                state, plan, metrics=self.metrics, pager=pager
            )
        elif pager is not None and pager.has_cold():
            vec = pager.digest_vector(state)
        else:
            vec = pt.state_digests(state, P)
        cache = getattr(self, "_last_digests", None)
        if cache is None:
            cache = self._last_digests = {}
        prev = cache.get(name)
        changed = (
            list(range(P + 1))
            if prev is None or len(prev) != len(vec)
            else pt.divergent_parts(prev, vec)
        )
        if plan is not None:
            from ..mesh import gossip as mesh_gossip

            for shard, _parts in mesh_gossip.group_parts_by_shard(
                plan, changed
            ):
                for part, blob in mesh_gossip.shard_psnap_blobs(
                    name, state, seq, dense, plan, shard, parts=changed,
                    pager=pager,
                ):
                    self.metrics.count("net.psnap_publishes")
                    self.metrics.count(f"mesh.shard{shard:02d}.psnap_publishes")
                    pub_ps(part, blob)
            changed = []
        with ThreadPoolExecutor(PSNAP_THREADS) as pool:
            for lo in range(0, len(changed), PSNAP_THREADS):
                group = changed[lo : lo + PSNAP_THREADS]
                if pager is not None:
                    blobs = [pager.psnap_blob(state, seq, p) for p in group]
                else:
                    payloads = [
                        serial.dumps_dense(
                            f"{name}_psnap", pt.restrict_psnap(dense, state, p, P)
                        )
                        for p in group
                    ]
                    blobs = pool.map(
                        pt.encode_psnap_blob, [seq] * len(group), group, payloads
                    )
                for part, blob in zip(group, blobs):
                    self.metrics.count("net.psnap_publishes")
                    pub_ps(part, blob)
        dig_blob = pt.encode_digest_blob(seq, vec)
        self.metrics.count("net.dig_publishes")
        self.metrics.count("net.dig_bytes", len(dig_blob))
        pub_dig(dig_blob)
        cache[name] = vec
        return vec

    def fetch_digests(self, member: str) -> Optional[Tuple[int, Any]]:
        """(seq, uint32[P+1]) of `member`'s latest digest vector, or None
        (legacy peer / torn blob / no partition surface) — total."""
        from ..core import partition as pt

        fd = getattr(self.transport, "fetch_digest", None)
        if fd is None:
            return None
        blob = fd(member)
        if blob is None:
            return None
        try:
            seq, vec = pt.decode_digest_blob(blob)
        except Exception:  # noqa: BLE001 — total, same policy as fetch
            return None
        # The audit watchdog rides these fetches (one observe_peer per
        # successful digest exchange) — count them so the chaos gate can
        # prove the watchdog's feed never silently goes dark.
        self.metrics.count("net.dig_fetches")
        return seq, vec

    def fetch_psnap(
        self, member: str, part: int, like_delta: Any, validate=None
    ) -> Optional[Tuple[int, Any]]:
        """(seq, decoded psnap payload) for one partition, or None —
        total. Bills `net.psnap_bytes` (the anti-entropy bytes the
        partition plane exists to shrink)."""
        from ..core import partition as pt
        from ..core import serial

        fp = getattr(self.transport, "fetch_psnap", None)
        if fp is None:
            return None
        blob = fp(member, part)
        if blob is None:
            return None
        try:
            seq, got_part, payload = pt.decode_psnap_blob(blob)
            if got_part != part:
                return None
            _name, delta = serial.loads_dense(payload, like_delta)
            if validate is not None and not validate(delta):
                return None
        except Exception:  # noqa: BLE001 — see fetch
            return None
        self.metrics.count("net.psnap_fetches")
        self.metrics.count("net.psnap_bytes", len(blob))
        obs_events.emit(
            "psnap.fetch", origin=member, part=part, bytes=len(blob)
        )
        return seq, delta

    def request_psnaps(self, member: str, parts: List[int]) -> None:
        rq = getattr(self.transport, "request_psnaps", None)
        if rq is not None and parts:
            rq(member, list(parts))

    def close(self) -> None:
        self.transport.close()
