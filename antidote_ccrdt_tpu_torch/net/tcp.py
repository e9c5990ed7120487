"""Real TCP gossip peer: push-replicated blobs over `{packet,4}` frames.

Wire: the bridge's framing (`bridge.protocol.pack_frame`/`unpack_frames`
— u32_be length + ETF payload), so a BEAM host could join the gossip
mesh natively. Frame terms (member names as utf-8 binaries, `heard` the
sender's piggybacked `Membership.heard_ages` map):

    {snap,  Member, Blob, Heard}
    {delta, Member, Seq, Keep, Blob, Heard}
    {ping,  Member, Heard}
    {metrics_req}                      -> {metrics_resp, Member, Text}
    {metrics_req, T1}                  -> {metrics_resp, Member, Text, T1, T2}

Clock piggyback (obs/spans.py): `{hello}` may carry a 5th element — the
sender's `time.monotonic()` at send (T1) — and the matching
`{hello_ack}` then carries (T1, T2) where T2 is the receiver's
monotonic clock at receipt; likewise `{metrics_req, T1}`. At the reply
the sender computes the NTP-style estimate ``offset = T2 - (T1+T3)/2``
(T3 = reply receipt) and feeds `obs.spans.ClockSync`, which is how a
fleet's span timelines align. Both handlers index tolerantly, so mixed
old/new fleets interop: short tuples mean "no clock data".

`metrics_req` is the one request/reply pair: a scraper (Prometheus shim,
`scrape_metrics`, the dashboard) connects, sends the request, and gets
this member's OpenMetrics text back on the SAME inbound connection — the
only frame ever written back on an accepted socket. Scrapers are not
members: the request bypasses membership observation entirely.

Topology: full mesh over a static address book by default. Each member
keeps ONE outgoing connection per peer (`_PeerLink`) feeding from a
bounded send queue; inbound connections are accept-and-read only.
Received blobs land in local caches, so the `Transport` fetch surface is
a local dict read — anti-entropy stays pull-shaped above (`sweep_deltas`
chains whatever has arrived) while the medium is push-shaped below.

`install_router()` switches the mesh to the zone-aware topology from
`topo/`: frames then go where `ZoneRouter.send_targets` says (leaves
intra-zone, anchors also to remote-zone anchors), cross-zone frames
travel as `{rsnap,...}`/`{rdelta,...}` carrying (member, zone) hop
stamps, and receiving anchors relay per `plan_relay` — each relayed
send shows up as a `frame.relay` event and in the
`topo.cross_zone.{frames,bytes}` counters. Links also negotiate a codec
at connect time via `{hello}`/`{hello_ack}` (codec byte 0=raw 1=zlib
ahead of the ETF payload, `topo.codec`); a peer that never acks —
an un-upgraded build — gets legacy bare-ETF frames forever, so mixed
fleets interop. The default compress policy is zlib on cross-zone links
only (`compress="cross_zone"`): intra-zone links are cheap, the DCN is
not.

Failure behavior (the design goal: DEGRADE, never hang):

* connects/sends carry timeouts; a stalled peer costs the sender thread,
  never the caller;
* reconnects retry forever with exponential backoff + jitter (metrics:
  `net.retries`) — a dead peer is cheap to keep trying;
* the send queue is bounded with a drop-oldest-delta-keep-anchor policy:
  deltas are join-decomposed (`parallel.delta`), so a dropped delta only
  breaks the receiver's chain, and the periodically-published full
  anchor resyncs the gap (`sweep_deltas`'s fallback). Snapshots are
  latest-wins — a newly queued anchor replaces any queued older one;
* liveness comes from `net.membership`: every received frame is direct
  evidence of its sender, and a ping's piggybacked ages, aged by the
  ping's wait in the receiver, evidence of the others, so a stalled peer
  decays ALIVE -> SUSPECT -> DEAD instead of blocking.

Frames are ENCODED AT SEND TIME (the queue holds builders, not bytes) so
piggybacked ages are measured when the frame actually leaves — a frame
that sat queued behind a dead link must not deliver stale "I heard X
recently" claims.

Port of ``antidote_ccrdt_tpu/net/tcp.py``: the same frames, caches,
counters and events. Two differences. JAX's transport takes the ages of
every frame as they stand; a large frame lands seconds after they were
taken, so passed from peer to peer they kept a dead member alive while
large frames flowed (``_handle``). And a psnap asked for with
`request_psnaps` and not yet answered is waited for by `fetch_psnap`, at
most PSNAP_WAIT_S, instead of reading whatever older psnap the cache
holds. The JAX transport leaves this to thread timing, and its slower
caller usually lets the reply land first; the port's fast caller read
the stale psnap, asked again, and so moved each divergent partition
twice (scripts/partition_demo.py's resync). The price: a peer that dies
between the request and its reply holds each such `fetch_psnap` for
PSNAP_WAIT_S, after which it reads the cache as JAX's does.

A frame carrying a binary of at least ``etf.CHUNK_MIN`` bytes is written
from its parts (`etf.encode_chunks`, ``sendmsg``; the send timeout bounds
the whole frame, as it bounds ``sendall``) and read into one buffer of its
full size, so a 100 MB delta is not copied a dozen times on its way (the
bytes on the wire are the same).
"""

from __future__ import annotations

import random
import select
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..bridge.protocol import MAX_FRAME, pack_frame, unpack_frames
from ..core import etf
from ..core.etf import Atom
from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..topo import (
    CODEC_RAW,
    CODEC_ZLIB,
    UNKNOWN_ZONE,
    ZoneMap,
    ZoneRouter,
    encode_frame,
    unpack_coded_frames,
    zone_from_env,
)
from ..utils import faults
from . import transport
from ..utils.metrics import Metrics
from .membership import Membership

A_SNAP = Atom("snap")
A_DELTA = Atom("delta")
A_PING = Atom("ping")
A_METRICS_REQ = Atom("metrics_req")
A_METRICS_RESP = Atom("metrics_resp")
A_HELLO = Atom("hello")
A_HELLO_ACK = Atom("hello_ack")
A_RSNAP = Atom("rsnap")
A_RDELTA = Atom("rdelta")
A_DIG = Atom("dig")
A_RDIG = Atom("rdig")
A_PSNAP = Atom("psnap")
A_PSNAP_REQ = Atom("psnap_req")
A_QUERY = Atom("query")
A_QUERY_RESP = Atom("query_resp")
A_WRITE = Atom("write")
A_WRITE_ACK = Atom("write_ack")

_SNAP, _DELTA, _PING, _DIG, _PSNAP = "snap", "delta", "ping", "dig", "psnap"

# (member, zone) hop stamps of a routed frame, origin first.
_Path = List[Tuple[str, str]]


def scrape_metrics(addr: Tuple[str, int], timeout: float = 2.0) -> Tuple[str, str]:
    """One-shot in-band scrape of a live `TcpTransport`: connect to its
    gossip listener, send `{metrics_req}`, return (member, OpenMetrics
    text). Bounded by `timeout` end-to-end — a wedged or fault-injected
    worker yields `socket.timeout`/`ConnectionError`, never a hang."""
    deadline = time.monotonic() + timeout
    with socket.create_connection(addr, timeout=timeout) as s:
        t1 = time.monotonic()
        s.sendall(pack_frame((A_METRICS_REQ, t1)))
        buf = bytearray()
        while True:
            s.settimeout(max(0.01, deadline - time.monotonic()))
            data = s.recv(1 << 16)
            if not data:
                raise ConnectionError("scrape connection closed before reply")
            buf.extend(data)
            for term in unpack_frames(buf):
                if term[0] == A_METRICS_RESP:
                    member = term[1].decode("utf-8")
                    if len(term) >= 5:
                        # Echoed (T1, T2): a scraper running the span
                        # plane refines its offset to this worker.
                        obs_spans.observe_exchange(
                            member,
                            float(term[3]),
                            float(term[4]),
                            time.monotonic(),
                        )
                    return member, term[2].decode("utf-8")


class QueryCancelled(ConnectionError):
    """`query_peer` abandoned because its `cancel` event was set — the
    router reaped a hedge loser or failed over off this peer."""


def query_peer(
    addr: Tuple[str, int],
    payload: bytes,
    timeout: float = 2.0,
    cancel: Optional[threading.Event] = None,
    connect_timeout: Optional[float] = None,
    qid: Optional[bytes] = None,
) -> Tuple[str, bytes]:
    """One-shot serve-plane read against a live `TcpTransport`: connect
    to its gossip listener, send `{query, Payload[, Qid]}`, return
    (member, response bytes — the serve plane's canonical JSON,
    verbatim). Bounded by `timeout` end-to-end: the deadline is checked
    explicitly on EVERY loop turn, so a peer that accepts the frame and
    then drips unrelated traffic (or nothing) without ever answering
    still surfaces `socket.timeout` — connection-level faults are not
    the only escape hatch. The fleet router leans on this: a
    never-answering peer must time out so it can fail over instead of
    hanging. `cancel` (a threading.Event) aborts the wait early with
    `QueryCancelled` — how a hedged/failed-over attempt's loser is
    reaped. `qid` is opaque router metadata echoed back in the response
    frame (correlation under failover). The querier never joins the
    gossip membership."""
    deadline = time.monotonic() + timeout
    frame: Tuple[Any, ...] = (
        (A_QUERY, bytes(payload)) if qid is None
        else (A_QUERY, bytes(payload), bytes(qid))
    )
    with socket.create_connection(
        addr, timeout=(connect_timeout if connect_timeout is not None
                       else timeout)
    ) as s:
        s.sendall(pack_frame(frame))
        buf = bytearray()
        while True:
            now = time.monotonic()
            if now >= deadline:
                raise socket.timeout(
                    f"query deadline exceeded ({timeout}s, no query_resp)"
                )
            if cancel is not None and cancel.is_set():
                raise QueryCancelled("query cancelled by router")
            # Short recv slices so cancellation and the hard deadline
            # are both honored even while frames keep trickling in.
            s.settimeout(max(0.01, min(0.1, deadline - now)))
            try:
                data = s.recv(1 << 16)
            except socket.timeout:
                continue  # no bytes this slice; deadline check re-arms
            if not data:
                raise ConnectionError("query connection closed before reply")
            buf.extend(data)
            for term in unpack_frames(buf):
                if term[0] == A_QUERY_RESP:
                    if qid is not None and (
                        len(term) < 4 or bytes(term[3]) != bytes(qid)
                    ):
                        continue  # someone else's (stale) answer
                    return term[1].decode("utf-8"), bytes(term[2])


def write_peer(
    addr: Tuple[str, int],
    payload: bytes,
    timeout: float = 2.0,
    cancel: Optional[threading.Event] = None,
    connect_timeout: Optional[float] = None,
    wid: Optional[bytes] = None,
) -> Tuple[str, bytes]:
    """One-shot ingest-plane write against a live `TcpTransport`: send
    `{write, Payload[, Wid]}`, return (member, ack bytes — the ingest
    plane's canonical JSON, verbatim). The SAME deadline/cancel
    contract as `query_peer`: the deadline is checked on every loop
    turn so a peer that accepts the frame and never acks surfaces
    `socket.timeout` (the write router fails over — safely, because the
    payload's write_id dedups at the successor), and `cancel` aborts
    with `QueryCancelled`. `wid` is opaque router correlation metadata
    echoed in the ack frame. The writer never joins the membership."""
    deadline = time.monotonic() + timeout
    frame: Tuple[Any, ...] = (
        (A_WRITE, bytes(payload)) if wid is None
        else (A_WRITE, bytes(payload), bytes(wid))
    )
    with socket.create_connection(
        addr, timeout=(connect_timeout if connect_timeout is not None
                       else timeout)
    ) as s:
        s.sendall(pack_frame(frame))
        buf = bytearray()
        while True:
            now = time.monotonic()
            if now >= deadline:
                raise socket.timeout(
                    f"write deadline exceeded ({timeout}s, no write_ack)"
                )
            if cancel is not None and cancel.is_set():
                raise QueryCancelled("write cancelled by router")
            s.settimeout(max(0.01, min(0.1, deadline - now)))
            try:
                data = s.recv(1 << 16)
            except socket.timeout:
                continue  # no bytes this slice; deadline check re-arms
            if not data:
                raise ConnectionError("write connection closed before ack")
            buf.extend(data)
            for term in unpack_frames(buf):
                if term[0] == A_WRITE_ACK:
                    if wid is not None and (
                        len(term) < 4 or bytes(term[3]) != bytes(wid)
                    ):
                        continue  # someone else's (stale) ack
                    return term[1].decode("utf-8"), bytes(term[2])


def probe_clock(
    addr: Tuple[str, int], timeout: float = 2.0
) -> Tuple[str, float, float]:
    """One NTP-style exchange against a live worker over the in-band
    `{metrics_req, T1}` frame: returns (member, offset, rtt) where
    ``offset ~= worker_monotonic - local_monotonic``. Raises like
    `scrape_metrics` on a dead/legacy worker (a 3-element reply means
    the peer predates the clock piggyback)."""
    deadline = time.monotonic() + timeout
    with socket.create_connection(addr, timeout=timeout) as s:
        t1 = time.monotonic()
        s.sendall(pack_frame((A_METRICS_REQ, t1)))
        buf = bytearray()
        while True:
            s.settimeout(max(0.01, deadline - time.monotonic()))
            data = s.recv(1 << 16)
            if not data:
                raise ConnectionError("probe connection closed before reply")
            buf.extend(data)
            for term in unpack_frames(buf):
                if term[0] == A_METRICS_RESP:
                    if len(term) < 5:
                        raise ConnectionError(
                            "peer replied without clock echo (legacy build)"
                        )
                    t3 = time.monotonic()
                    t2 = float(term[4])
                    member = term[1].decode("utf-8")
                    obs_spans.observe_exchange(member, t1, t2, t3)
                    return member, t2 - (t1 + t3) / 2.0, t3 - t1


class _Chunks:
    """A frame as the buffers to write in order (`etf.encode_chunks`);
    `len` is its size on the wire."""

    __slots__ = ("parts", "nbytes")

    def __init__(self, parts: List[bytes]):
        self.parts = parts
        self.nbytes = sum(len(x) for x in parts)

    def __len__(self) -> int:
        return self.nbytes


def _send_frame(sock: socket.socket, frame) -> None:
    """`sock.sendall` of a frame, bytes or `_Chunks`. As with `sendall`,
    the socket's timeout bounds the whole send: a `_Chunks` frame not out
    by then raises `socket.timeout`."""
    if not isinstance(frame, _Chunks):
        sock.sendall(frame)
        return
    timeout = sock.gettimeout()
    deadline = None if timeout is None else time.monotonic() + timeout
    views = [memoryview(x) for x in frame.parts if len(x)]
    try:
        while views:
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise socket.timeout("timed out")
                sock.settimeout(left)
            sent = sock.sendmsg(views)
            while sent and sent >= len(views[0]):
                sent -= len(views.pop(0))
            if sent:
                views[0] = views[0][sent:]
    finally:
        sock.settimeout(timeout)


# Seconds `fetch_psnap` waits for the reply to a psnap request.
PSNAP_WAIT_S = 1.0

# A frame whose missing part is this large is read straight into one
# buffer of its size (`TcpTransport._read_rest`).
_BIG_READ = 1 << 20


class _PeerLink:
    """One outgoing connection: bounded queue + sender thread with
    backoff. `enqueue` never blocks the caller; the queue policy keeps
    at most one snapshot (latest anchor) and one pending ping, and sheds
    the OLDEST delta first when full."""

    def __init__(
        self,
        name: str,
        addr: Tuple[str, int],
        rng: random.Random,
        metrics: Metrics,
        queue_max: int,
        connect_timeout: float,
        send_timeout: float,
        backoff_base: float,
        backoff_max: float,
        negotiate: Optional[Callable[[socket.socket], Optional[int]]] = None,
    ):
        self.name = name  # peer's member name (frame.send events, gauges)
        self.addr = addr
        self.rng = rng
        self.metrics = metrics
        self.queue_max = queue_max
        self.connect_timeout = connect_timeout
        self.send_timeout = send_timeout
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        # Hello exchange run on each fresh socket; returns the codec the
        # peer accepts, or None for a legacy peer (bare-ETF frames).
        # Re-runs on every reconnect — the peer may have been upgraded.
        self.negotiate = negotiate
        self.codec: Optional[int] = None
        # (kind, build_frame: () -> bytes, meta: trace context carried to
        # the frame.send event — {origin, dseq} for deltas)
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._stop = False
        self._sock: Optional[socket.socket] = None
        self._attempts = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _gauge_depth(self) -> None:
        # Called under self._cv: per-peer send-queue depth for the
        # dashboard (a climbing gauge = this peer's link is stalling).
        self.metrics.set(f"net.sendq.{self.name}", float(len(self._q)))

    def enqueue(
        self,
        kind: str,
        build_frame: Callable[[], bytes],
        meta: Optional[Dict[str, object]] = None,
    ) -> None:
        with self._cv:
            if self._stop:
                return
            if kind in (_SNAP, _DIG):
                # Latest-wins: a queued older snapshot/digest is dead weight.
                stale = [i for i, (k, _, _m) in enumerate(self._q) if k == kind]
                for i in reversed(stale):
                    del self._q[i]
            elif kind == _PING and any(k == _PING for k, _, _m in self._q):
                return  # one pending ping is enough liveness signal
            if len(self._q) >= self.queue_max:
                # Backpressure: shed the oldest DELTA (anchors resync the
                # gap); only if no delta is queued shed the oldest frame.
                for i, (k, _, _m) in enumerate(self._q):
                    if k == _DELTA:
                        del self._q[i]
                        break
                else:
                    self._q.popleft()
                self.metrics.count("net.send_drops")
            self._q.append((kind, build_frame, meta or {}))
            self._gauge_depth()
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)

    # -- sender thread -----------------------------------------------------

    def _backoff(self) -> float:
        d = min(self.backoff_max, self.backoff_base * (2.0 ** self._attempts))
        return d * (0.5 + self.rng.random())  # jitter in [0.5d, 1.5d)

    def _ensure_connected(self) -> bool:
        if self._sock is not None:
            return True
        try:
            s = socket.create_connection(self.addr, timeout=self.connect_timeout)
            s.settimeout(self.send_timeout)
            if self.negotiate is not None:
                try:
                    self.codec = self.negotiate(s)
                except Exception:
                    self.codec = None  # any hello trouble -> legacy frames
            self._sock = s
            self._attempts = 0
            self.metrics.count("net.connects")
            return True
        except OSError:
            self._attempts += 1
            self.metrics.count("net.retries")
            return False

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                kind, build, meta = self._q[0]
            if not self._ensure_connected():
                with self._cv:
                    self._cv.wait(timeout=self._backoff())
                    if self._stop:
                        return
                continue
            # Wire-time span on the SENDER thread: attribution counts it
            # as overlappable — the worker round never waited for it.
            tok = (
                obs_spans.begin(
                    "round.gossip_send", wire=True, peer=self.name,
                    fkind=kind,
                    **{k: meta[k] for k in ("origin", "dseq") if k in meta},
                )
                if obs_spans.ACTIVE
                else None
            )
            try:
                frame = build()
                dropped = False
                try:
                    # Fault point `tcp.send`: raise = connection reset
                    # mid-send (exercises the reconnect/backoff path
                    # exactly like a real ECONNRESET); drop = frame lost
                    # on the wire (the queue treats it as sent —
                    # receivers resync via anchors).
                    if faults.ACTIVE and faults.fire("tcp.send") == "drop":
                        dropped = True
                        self.metrics.count("net.fault_drops")
                    else:
                        _send_frame(self._sock, frame)
                except OSError:
                    # close() may have nulled _sock concurrently (it owns
                    # the socket teardown); swap-then-close so both
                    # orders are safe.
                    s, self._sock = self._sock, None
                    if s is not None:
                        try:
                            s.close()
                        except OSError:
                            pass
                    self._attempts += 1
                    self.metrics.count("net.retries")
                    continue  # same frame retries after reconnect
            finally:
                obs_spans.end(tok)
            with self._cv:
                # Sent: drop it (the queue head may have been reshuffled
                # by the snap-replacement policy; remove by identity).
                try:
                    self._q.remove((kind, build, meta))
                except ValueError:
                    pass
                self._gauge_depth()
            if not dropped:
                self.metrics.count("net.frames_sent")
                self.metrics.count("net.bytes_sent", len(frame))
                if meta.get("cross_zone"):
                    # Counted at actual wire time with post-codec sizes:
                    # these two gauges ARE the DCN bill the topology is
                    # meant to shrink (bench_gate reports them).
                    self.metrics.count("topo.cross_zone.frames")
                    self.metrics.count("topo.cross_zone.bytes", len(frame))
                # Emitted when the frame actually left (not at enqueue):
                # delta metas carry (origin, dseq) so the trace shows the
                # true wire time of each propagation hop.
                obs_events.emit(
                    "frame.send",
                    peer=self.name,
                    fkind=kind,
                    bytes=len(frame),
                    **meta,
                )


class TcpTransport:
    """`net.transport.Transport` over real sockets (see module docstring).

    `peers` is the static address book {member: (host, port)}; `bind`
    may use port 0 (the kernel-assigned address is `self.address`, for
    rendezvous schemes like the demo's address files). `members()`
    reports only members actually HEARD FROM (self included) — the
    address book is connectivity, membership is evidence — so start
    barriers wait for real traffic, exactly like heartbeat files."""

    def __init__(
        self,
        member: str,
        bind: Tuple[str, int] = ("127.0.0.1", 0),
        peers: Optional[Dict[str, Tuple[str, int]]] = None,
        metrics: Optional[Metrics] = None,
        queue_max: int = 64,
        connect_timeout: float = 0.5,
        send_timeout: float = 2.0,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        seed: Optional[int] = None,
        zone: Optional[str] = None,
        compress: str = "cross_zone",
        hello_timeout: float = 1.0,
    ):
        self.member = member
        self.metrics = metrics if metrics is not None else Metrics()
        self.membership = Membership(member, metrics=self.metrics)
        # Zone defaults to CCRDT_ZONE (one shared default zone when unset,
        # so unconfigured fleets keep exact full-mesh behavior). Routing
        # stays full-mesh until install_router() is called.
        self.zone = zone if zone is not None else zone_from_env()
        self.zones = ZoneMap(member, self.zone)
        self.router: Optional[ZoneRouter] = None
        self.compress = compress  # "off" | "cross_zone" | "all"
        self.hello_timeout = hello_timeout
        self._rng = random.Random(
            seed if seed is not None else hash(member) & 0xFFFFFFFF
        )
        self._lock = threading.Lock()
        self._snaps: Dict[str, bytes] = {}
        self._deltas: Dict[str, Dict[int, bytes]] = {}
        # Partition plane: per-member digest-vector blobs (pushed, tiny)
        # and per-(member, part) psnap blobs. Own psnaps are STORED here
        # at anchor time and only cross the wire when a peer requests
        # divergent partitions ({psnap_req} -> {psnap}).
        self._digs: Dict[str, bytes] = {}
        self._psnaps: Dict[str, Dict[int, bytes]] = {}
        # (member, part) -> deadline of a psnap request whose reply has
        # not landed; `fetch_psnap` waits on `_psnap_landed` until then.
        self._psnap_asked: Dict[Tuple[str, int], float] = {}
        self._psnap_landed = threading.Condition(self._lock)
        # Serve plane: `{query, Payload}` frames are answered by this
        # handler (bytes -> bytes) when a plane is installed; None means
        # this worker does not serve reads (error reply, never a hang).
        self.query_handler: Optional[Callable[[bytes], bytes]] = None
        self.write_handler: Optional[Callable[[bytes], bytes]] = None
        self._closed = False

        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(bind)
        self._server.listen(16)
        self.address: Tuple[str, int] = self._server.getsockname()[:2]

        self._link_params = (
            queue_max, connect_timeout, send_timeout, backoff_base, backoff_max,
        )
        self._links: Dict[str, _PeerLink] = {}
        for name, addr in sorted((peers or {}).items()):
            self.add_peer(name, addr)

        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    def add_peer(self, name: str, addr: Tuple[str, int]) -> None:
        """Open (or keep) the outgoing link to `name`. Exists because
        port-0 binds can't know each other's addresses at construction —
        rendezvous (the demo's addr files) discovers them afterwards."""
        if name == self.member:
            return
        with self._lock:
            if name in self._links or self._closed:
                return
            self._links[name] = _PeerLink(
                name, tuple(addr), self._rng, self.metrics,
                *self._link_params, negotiate=self._hello_exchange,
            )

    def install_serve(self, plane: Any) -> None:
        """Attach a serve plane (or any bytes->bytes handler): inbound
        `{query, Payload}` frames are answered with `{query_resp,
        Member, ResponseBytes}` on the same connection. A real
        `ServePlane` gets its "tcp"-labelled handler so sheds on this
        surface are countable apart from bridge/HTTP ones. Payload is
        opaque: an rtrace context (``"trace"`` in the canonical JSON
        doc) and the response-borne ``"rtrace"`` echo ride these frames
        byte-for-byte with no frame-format change."""
        handler_for = getattr(plane, "handler_for", None)
        if callable(handler_for):
            self.query_handler = handler_for("tcp")
        else:
            self.query_handler = getattr(plane, "handle", plane)

    def install_ingest(self, plane: Any) -> None:
        """Attach an ingest plane (or any bytes->bytes handler): inbound
        `{write, Payload}` frames are answered with `{write_ack, Member,
        AckBytes}` on the same connection — the write tier's twin of
        `install_serve`. A real `IngestPlane` gets its "tcp"-labelled
        handler so write sheds on this surface count separately. Like
        the query frames, the payload (bare JSON or a CCRF range frame)
        is opaque — a ``"trace"`` context inside it and the ack's
        ``"rtrace"`` echo propagate unchanged."""
        handler_for = getattr(plane, "handler_for", None)
        if callable(handler_for):
            self.write_handler = handler_for("tcp")
        else:
            self.write_handler = getattr(plane, "handle", plane)

    def learn_zone(self, name: str, zone: str) -> None:
        """Feed static zone config (address files, CLI) into the map —
        hellos and relay stamps keep teaching it afterwards."""
        self.zones.learn(name, zone)

    def install_router(self, timeout_s: float = 2.0) -> ZoneRouter:
        """Switch from full-mesh to the zone-aware topology (`topo/`).
        `timeout_s` is the SWIM alive-horizon anchor elections use.
        Peers with unknown zones keep full-mesh treatment, so calling
        this before zones are learned only delays the traffic win."""
        self.router = ZoneRouter(
            self.member,
            self.zone,
            self.zones,
            membership=self.membership,
            timeout_s=timeout_s,
            metrics=self.metrics,
        )
        return self.router

    # -- per-link codec negotiation ----------------------------------------

    def _hello_exchange(self, sock: socket.socket) -> Optional[int]:
        """Run on the sender thread right after each connect: send
        `{hello, Member, Zone, [Codecs]}` (legacy-framed — an old peer
        decodes it as an unknown tag and ignores it) and wait, bounded,
        for `{hello_ack, Member, Zone, Codec}` on the same socket — the
        second of the two write-back frames inbound handlers may send.
        Timeout/EOF/garbage all mean "legacy peer": frames to this link
        stay bare ETF. The ack also teaches us the peer's zone."""
        try:
            t1 = time.monotonic()
            sock.sendall(
                pack_frame((
                    A_HELLO,
                    self.member.encode("utf-8"),
                    self.zone.encode("utf-8"),
                    [CODEC_RAW, CODEC_ZLIB],
                    t1,  # clock piggyback; old peers ignore the extra slot
                ))
            )
            self.metrics.count("net.hellos")
            buf = bytearray()
            deadline = time.monotonic() + self.hello_timeout
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                sock.settimeout(left)
                data = sock.recv(1 << 16)
                if not data:
                    return None
                buf.extend(data)
                for term in unpack_coded_frames(buf):
                    if term[0] == A_HELLO_ACK:
                        # Index tolerantly: a legacy ack is 4 elements, a
                        # clock-bearing one appends (T1, T2).
                        mb, zb, codec = term[1], term[2], term[3]
                        peer = mb.decode("utf-8")
                        self.zones.learn(peer, zb.decode("utf-8"))
                        if len(term) >= 6:
                            obs_spans.observe_exchange(
                                peer,
                                float(term[4]),
                                float(term[5]),
                                time.monotonic(),
                            )
                        self.metrics.count("net.hello_acks")
                        return int(codec)
        except (OSError, ValueError):
            return None
        finally:
            try:
                sock.settimeout(self._link_params[2])  # send_timeout
            except OSError:
                pass

    def _link_codec(self, link: _PeerLink) -> Optional[int]:
        """Effective send codec for one link, decided at build time:
        min(what the peer accepts, what the compress policy wants)."""
        negotiated = link.codec
        if negotiated is None:
            return None  # legacy peer
        if negotiated >= CODEC_ZLIB and self._compress_to(link.name):
            return CODEC_ZLIB
        return CODEC_RAW

    def _compress_to(self, peer: str) -> bool:
        if self.compress == "all":
            return True
        if self.compress == "off":
            return False
        pz = self.zones.zone_of(peer)
        return pz not in (self.zone, UNKNOWN_ZONE)

    # -- frame builders (called at send time, see module docstring) --------

    def _wire(self, term, link: _PeerLink):
        codec = self._link_codec(link)
        chunks = etf.encode_chunks(term)
        if len(chunks) > 1 and codec in (None, CODEC_RAW):
            # A large binary: the frame's head, then the parts as they are.
            tag = b"" if codec is None else bytes([CODEC_RAW])
            n = len(tag) + sum(len(x) for x in chunks)
            return _Chunks([struct.pack(">I", n) + tag, *chunks])
        payload = b"".join(chunks)
        if codec is None:
            return struct.pack(">I", len(payload)) + payload
        return encode_frame(payload, codec, self.metrics)

    def _heard_term(self) -> Dict[bytes, float]:
        return {
            m.encode("utf-8"): float(age)
            for m, age in self.membership.heard_ages().items()
        }

    def _snap_frame(self, blob: bytes, link: _PeerLink) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire((A_SNAP, mb, blob, self._heard_term()), link)

    def _delta_frame(
        self, seq: int, keep: int, blob: bytes, link: _PeerLink
    ) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire(
            (A_DELTA, mb, seq, keep, blob, self._heard_term()), link
        )

    def _ping_frame(self, link: _PeerLink) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire((A_PING, mb, self._heard_term()), link)

    @staticmethod
    def _path_term(path: _Path) -> List[Tuple[bytes, bytes]]:
        return [(m.encode("utf-8"), z.encode("utf-8")) for m, z in path]

    def _rsnap_frame(
        self, origin: str, blob: bytes, path: _Path, link: _PeerLink
    ) -> Callable[[], bytes]:
        ob, pt = origin.encode("utf-8"), self._path_term(path)
        return lambda: self._wire(
            (A_RSNAP, ob, blob, pt, self._heard_term()), link
        )

    def _rdelta_frame(
        self,
        origin: str,
        seq: int,
        keep: int,
        blob: bytes,
        path: _Path,
        link: _PeerLink,
    ) -> Callable[[], bytes]:
        ob, pt = origin.encode("utf-8"), self._path_term(path)
        return lambda: self._wire(
            (A_RDELTA, ob, seq, keep, blob, pt, self._heard_term()), link
        )

    def _dig_frame(self, blob: bytes, link: _PeerLink) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire((A_DIG, mb, blob, self._heard_term()), link)

    def _rdig_frame(
        self, origin: str, blob: bytes, path: _Path, link: _PeerLink
    ) -> Callable[[], bytes]:
        ob, pt = origin.encode("utf-8"), self._path_term(path)
        return lambda: self._wire(
            (A_RDIG, ob, blob, pt, self._heard_term()), link
        )

    def _psnap_frame(
        self, part: int, blob: bytes, link: _PeerLink
    ) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire(
            (A_PSNAP, mb, part, blob, self._heard_term()), link
        )

    def _psnap_req_frame(
        self, parts: List[int], link: _PeerLink
    ) -> Callable[[], bytes]:
        mb = self.member.encode("utf-8")
        return lambda: self._wire(
            (A_PSNAP_REQ, mb, list(parts), self._heard_term()), link
        )

    # -- receive path ------------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                conn, _peer = self._server.accept()
            except OSError:
                return  # server closed
            threading.Thread(
                target=self._read_conn, args=(conn,), daemon=True
            ).start()

    def _read_conn(self, conn: socket.socket) -> None:
        buf = bytearray()
        conn.settimeout(None)
        # When the bytes read since then began to arrive: the last read
        # that found nothing waiting. A frame handled at `now` has waited
        # at most `now - arrived` (the `waited_s` of `_handle`).
        arrived = time.monotonic()
        try:
            while True:
                idle = not select.select([conn], [], [], 0)[0]
                data = conn.recv(1 << 16)
                if idle:
                    arrived = time.monotonic()
                if not data:
                    return
                buf.extend(data)
                self.metrics.count("net.bytes_recv", len(data))
                buf = self._read_rest(conn, buf)
                if buf is None:
                    return
                for term in unpack_coded_frames(buf):
                    waited = time.monotonic() - arrived
                    if obs_spans.ACTIVE:
                        # Reader-thread span: frame decode + cache write
                        # (overlappable — the round never blocks on it).
                        with obs_spans.span(
                            "round.gossip_recv", wire=True,
                            fkind=str(term[0]) if term else "?",
                        ):
                            self._handle(term, conn, waited)
                    else:
                        self._handle(term, conn, waited)
        except (OSError, ValueError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _read_rest(self, conn: socket.socket, buf: bytearray) -> Optional[bytearray]:
        """`buf` with the rest of its first frame read into it when at
        least _BIG_READ bytes of that frame are missing: one buffer of the
        frame's size, filled by ``recv_into`` (None if the peer closed).
        Otherwise `buf` as it is."""
        if len(buf) < 4:
            return buf
        (n,) = struct.unpack(">I", bytes(buf[:4]))
        if n > MAX_FRAME or 4 + n - len(buf) < _BIG_READ:
            return buf  # the unpacker refuses an oversize frame
        whole = bytearray(4 + n)
        got = len(buf)
        whole[:got] = buf
        with memoryview(whole) as view:
            while got < len(whole):
                k = conn.recv_into(view[got:])
                if not k:
                    return None
                self.metrics.count("net.bytes_recv", k)
                got += k
        return whole

    def _store_snap(self, m: str, blob: bytes) -> bool:
        """Anchor cache write; True when the blob was accepted. Ordered
        within one link, but reconnects can interleave: only a
        step-header >= the cached one replaces the anchor."""
        with self._lock:
            old = self._snaps.get(m)
            if (
                old is None
                or len(blob) < 8
                or struct.unpack("<Q", blob[:8])[0]
                >= struct.unpack("<Q", old[:8])[0]
            ):
                self._snaps[m] = blob
                return True
            return False

    def _store_delta(self, m: str, seq: int, keep: int, blob: bytes) -> bool:
        """Delta window write; True when `seq` is NEW and survived the
        prune (a stale redelivery must not trigger a re-relay). Prune
        against the window MAX: reconnect interleavings can deliver an
        old delta late — it must not re-enter past the keep bound."""
        with self._lock:
            window = self._deltas.setdefault(m, {})
            fresh = seq not in window
            window[seq] = blob
            hi = max(window)
            for s in [s for s in window if s <= hi - keep]:
                del window[s]
            return fresh and seq in window

    @staticmethod
    def _ccpt_seq(blob: bytes) -> Optional[int]:
        """Embedded seq of a CCPT partition blob (core.partition), or
        None for anything else — kept header-only so the transport stays
        payload-opaque."""
        if len(blob) >= 14 and bytes(blob[:4]) == b"CCPT":
            return struct.unpack_from("<Q", blob, 6)[0]
        return None

    def _store_dig(self, m: str, blob: bytes) -> bool:
        """Digest-vector cache write, newest-seq-wins (same reconnect
        interleaving hazard as `_store_snap`)."""
        with self._lock:
            old = self._digs.get(m)
            new_seq, old_seq = self._ccpt_seq(blob), (
                self._ccpt_seq(old) if old is not None else None
            )
            if (
                old is None
                or new_seq is None
                or old_seq is None
                or new_seq >= old_seq
            ):
                self._digs[m] = blob
                return True
            return False

    def _store_psnap(self, m: str, part: int, blob: bytes) -> bool:
        with self._lock:
            if self._psnap_asked.pop((m, part), None) is not None:
                self._psnap_landed.notify_all()
            window = self._psnaps.setdefault(m, {})
            old = window.get(part)
            new_seq, old_seq = self._ccpt_seq(blob), (
                self._ccpt_seq(old) if old is not None else None
            )
            if (
                old is None
                or new_seq is None
                or old_seq is None
                or new_seq >= old_seq
            ):
                window[part] = blob
                return True
            return False

    def _serve_psnaps(self, requester: str, parts: List[int]) -> None:
        """Answer one `{psnap_req}`: push OUR stored psnap blobs for the
        requested partitions back to the requester (point-to-point on the
        direct link; a requester we hold no link to falls back to
        whole-snapshot resync on its side)."""
        link = self._links.get(requester)
        if link is None:
            return
        with self._lock:
            own = dict(self._psnaps.get(self.member, {}))
        for part in parts:
            blob = own.get(int(part))
            if blob is None:
                continue
            self.metrics.count("net.psnap_serves")
            link.enqueue(
                _PSNAP,
                self._psnap_frame(int(part), blob, link),
                meta={"origin": self.member, "part": int(part)},
            )

    def _handle(
        self, term, conn: Optional[socket.socket] = None,
        waited_s: float = 0.0,
    ) -> None:
        """Act on one decoded frame. `waited_s` bounds how long the frame
        sat in this member's socket and reader before it got here; the
        ages a ping relays are aged by it."""
        self.metrics.count("net.frames_recv")
        tag = term[0]
        if tag == A_METRICS_REQ:
            # In-band scrape: reply on the inbound connection and return
            # WITHOUT touching membership — the scraper is not a member.
            # A 2-element request carries the scraper's T1 (clock
            # piggyback); echo it with our T2 so the scraper can align.
            if conn is not None:
                t1 = term[1] if len(term) > 1 else None
                self._send_metrics_resp(conn, t1=t1)
            return
        if tag == A_QUERY:
            # Serve-plane read: same reply-on-inbound-connection contract
            # as the scrape — the querier never joins the membership. An
            # optional 3rd element is opaque router metadata (qid),
            # echoed back for correlation under failover/hedging.
            if conn is not None and len(term) > 1:
                qid = bytes(term[2]) if len(term) > 2 else None
                self._send_query_resp(conn, bytes(term[1]), qid=qid)
            return
        if tag == A_WRITE:
            # Ingest-plane write: same reply-on-inbound-connection
            # contract — the writer never joins the membership. The
            # handler BLOCKS this reader thread until the round loop
            # drains the write (bounded by the plane's ack timeout);
            # that is safe here because every inbound connection gets
            # its own reader thread.
            if conn is not None and len(term) > 1:
                wid = bytes(term[2]) if len(term) > 2 else None
                self._send_write_ack(conn, bytes(term[1]), wid=wid)
            return
        if tag == A_HELLO:
            # Link setup from a topo-aware peer: learn its zone, answer
            # with ours and the best codec we can decode of its offer.
            # Tolerant indexing: element 5 (T1) arrived with the clock
            # piggyback; older peers send 4 elements, and a hard unpack
            # here would close the whole read connection on mismatch.
            mb, zb, codecs = term[1], term[2], term[3]
            t1 = term[4] if len(term) > 4 else None
            m = mb.decode("utf-8")
            self.zones.learn(m, zb.decode("utf-8"))
            chosen = CODEC_ZLIB if CODEC_ZLIB in list(codecs) else CODEC_RAW
            if conn is not None:
                ack = [
                    A_HELLO_ACK,
                    self.member.encode("utf-8"),
                    self.zone.encode("utf-8"),
                    chosen,
                ]
                if t1 is not None:
                    ack.extend([float(t1), time.monotonic()])
                try:
                    conn.sendall(pack_frame(tuple(ack)))
                except OSError:
                    pass
            self.membership.observe(m)
            return
        if tag == A_SNAP:
            _, mb, blob, heard = term
            m = mb.decode("utf-8")
            obs_events.emit(
                "frame.recv", fkind=_SNAP, origin=m, bytes=len(blob)
            )
            if self._store_snap(m, blob) and self.zones.zone_of(m) == self.zone:
                # A zone-mate's own anchor: if we are this zone's relay
                # anchor, carry it across the DCN (no-op for leaves).
                self._relay_snap(m, blob, [(m, self.zone)])
        elif tag == A_RSNAP:
            _, ob, blob, path_t, heard = term
            origin = ob.decode("utf-8")
            path = [
                (pm.decode("utf-8"), pz.decode("utf-8")) for pm, pz in path_t
            ]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            m = path[-1][0] if path else origin  # the actual wire sender
            obs_events.emit(
                "frame.recv",
                fkind=_SNAP,
                origin=origin,
                bytes=len(blob),
                hops=len(path),
            )
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_snap(origin, blob):
                self._relay_snap(origin, blob, path)
        elif tag == A_DELTA:
            _, mb, seq, keep, blob, heard = term
            m = mb.decode("utf-8")
            # Stage "recv" of the delta trace: the frame's own
            # {delta, Member, Seq, ...} term IS the trace context.
            obs_events.emit(
                "frame.recv",
                fkind=_DELTA,
                origin=m,
                dseq=int(seq),
                bytes=len(blob),
            )
            if (
                self._store_delta(m, int(seq), int(keep), blob)
                and self.zones.zone_of(m) == self.zone
            ):
                self._relay_delta(
                    m, int(seq), int(keep), blob, [(m, self.zone)]
                )
        elif tag == A_RDELTA:
            _, ob, seq, keep, blob, path_t, heard = term
            origin = ob.decode("utf-8")
            path = [
                (pm.decode("utf-8"), pz.decode("utf-8")) for pm, pz in path_t
            ]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            m = path[-1][0] if path else origin
            obs_events.emit(
                "frame.recv",
                fkind=_DELTA,
                origin=origin,
                dseq=int(seq),
                bytes=len(blob),
                hops=len(path),
            )
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_delta(origin, int(seq), int(keep), blob):
                self._relay_delta(origin, int(seq), int(keep), blob, path)
        elif tag == A_DIG:
            _, mb, blob, heard = term
            m = mb.decode("utf-8")
            obs_events.emit(
                "frame.recv", fkind=_DIG, origin=m, bytes=len(blob)
            )
            if self._store_dig(m, blob) and self.zones.zone_of(m) == self.zone:
                self._relay_dig(m, blob, [(m, self.zone)])
        elif tag == A_RDIG:
            _, ob, blob, path_t, heard = term
            origin = ob.decode("utf-8")
            path = [
                (pm.decode("utf-8"), pz.decode("utf-8")) for pm, pz in path_t
            ]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            m = path[-1][0] if path else origin
            obs_events.emit(
                "frame.recv", fkind=_DIG, origin=origin, bytes=len(blob),
                hops=len(path),
            )
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_dig(origin, blob):
                self._relay_dig(origin, blob, path)
        elif tag == A_PSNAP:
            _, mb, part, blob, heard = term
            m = mb.decode("utf-8")
            obs_events.emit(
                "frame.recv", fkind=_PSNAP, origin=m, part=int(part),
                bytes=len(blob),
            )
            self._store_psnap(m, int(part), blob)
        elif tag == A_PSNAP_REQ:
            _, mb, parts, heard = term
            m = mb.decode("utf-8")
            self.metrics.count("net.psnap_reqs_recv")
            self._serve_psnaps(m, [int(p) for p in parts])
        elif tag == A_PING:
            _, mb, heard = term
            m = mb.decode("utf-8")
        else:
            return  # unknown frame: ignore (forward compatibility)
        if m != self.member:
            self.membership.observe(m)
        if tag == A_PING:
            # Relayed ages count only from pings, each aged by its wait
            # here. An age is taken when its frame is encoded: a large
            # frame lands seconds later (its encoding, the wire, and the
            # frames read before it), and so does a ping read behind one.
            # Taken as they stand, such ages make the members they name
            # that much fresher, and passed on from peer to peer they keep
            # a dead member alive for as long as large frames flow.
            self.membership.absorb(
                {k.decode("utf-8"): float(v) + waited_s
                 for k, v in heard.items()}
            )

    # -- relay (anchors only; plan_relay returns [] for leaves) ------------

    def _relay_snap(self, origin: str, blob: bytes, path: _Path) -> None:
        def enq(link: _PeerLink, stamped: _Path, meta: Dict[str, object]):
            link.enqueue(
                _SNAP, self._rsnap_frame(origin, blob, stamped, link), meta
            )

        self._relay(_SNAP, origin, path, enq)

    def _relay_dig(self, origin: str, blob: bytes, path: _Path) -> None:
        def enq(link: _PeerLink, stamped: _Path, meta: Dict[str, object]):
            link.enqueue(
                _DIG, self._rdig_frame(origin, blob, stamped, link), meta
            )

        self._relay(_DIG, origin, path, enq)

    def _relay_delta(
        self, origin: str, seq: int, keep: int, blob: bytes, path: _Path
    ) -> None:
        def enq(link: _PeerLink, stamped: _Path, meta: Dict[str, object]):
            link.enqueue(
                _DELTA,
                self._rdelta_frame(origin, seq, keep, blob, stamped, link),
                meta,
            )

        self._relay(_DELTA, origin, path, enq, dseq=seq)

    def _relay(
        self,
        fkind: str,
        origin: str,
        path: _Path,
        enq: Callable[[_PeerLink, _Path, Dict[str, object]], None],
        dseq: Optional[int] = None,
    ) -> None:
        router = self.router
        if router is None:
            return
        targets = router.plan_relay(origin, path, sorted(self._links))
        if not targets:
            return
        stamped = path + [(self.member, self.zone)]
        trace: Dict[str, object] = {"origin": origin}
        if dseq is not None:
            trace["dseq"] = dseq
        for peer, cross in targets:
            link = self._links.get(peer)
            if link is None:
                continue
            enq(link, stamped, dict(trace, cross_zone=cross, relay=True))
        self.metrics.count("topo.relays")
        obs_events.emit(
            "frame.relay",
            fkind=fkind,
            hops=len(path),
            n_targets=len(targets),
            cross_zone=any(c for _, c in targets),
            **trace,
        )

    def _send_metrics_resp(self, conn: socket.socket, t1=None) -> None:
        """Answer one `{metrics_req}`: render a snapshot (never the live
        dicts) and write it back. Degrade-never-hang: the `tcp.send`
        fault point (drop or raised reset) and any real socket error
        close the connection, so the scraper sees EOF/error within its
        own timeout while the registry stays intact. When the request
        carried T1, the reply appends (T1, T2) for the clock piggyback."""
        from ..obs import export as obs_export

        self.metrics.count("net.scrapes")
        text = obs_export.prometheus_text(
            self.metrics, labels={"member": self.member}
        )
        resp = [
            A_METRICS_RESP, self.member.encode("utf-8"), text.encode("utf-8"),
        ]
        if t1 is not None:
            resp.extend([float(t1), time.monotonic()])
        frame = pack_frame(tuple(resp))
        try:
            if faults.ACTIVE and faults.fire("tcp.send") == "drop":
                self.metrics.count("net.fault_drops")
                raise OSError("injected scrape-reply drop")
            conn.sendall(frame)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass

    def _send_query_resp(
        self, conn: socket.socket, payload: bytes,
        qid: Optional[bytes] = None,
    ) -> None:
        """Answer one `{query, Payload}` via the installed serve plane.
        Degrade-never-hang, exactly like `_send_metrics_resp`: a handler
        failure (including an injected `serve.query` fault) or the
        `tcp.send` fault point closes the connection, so the querier
        sees EOF/error within its own timeout."""
        self.metrics.count("net.queries")
        try:
            handler = self.query_handler
            if handler is None:
                from ..serve import plane as serve_plane

                resp = serve_plane.encode(
                    {"member": self.member, "error": "no serve plane"}
                )
            else:
                resp = bytes(handler(payload))
        except Exception:  # noqa: BLE001 — degrade: close, querier times out
            try:
                conn.close()
            except OSError:
                pass
            return
        frame = pack_frame(
            (A_QUERY_RESP, self.member.encode("utf-8"), resp)
            if qid is None
            else (A_QUERY_RESP, self.member.encode("utf-8"), resp, qid)
        )
        try:
            if faults.ACTIVE and faults.fire("tcp.send") == "drop":
                self.metrics.count("net.fault_drops")
                raise OSError("injected query-reply drop")
            conn.sendall(frame)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass

    def _send_write_ack(
        self, conn: socket.socket, payload: bytes,
        wid: Optional[bytes] = None,
    ) -> None:
        """Answer one `{write, Payload}` via the installed ingest plane.
        Degrade-never-hang, exactly like `_send_query_resp`: a handler
        failure or the `tcp.send` fault point closes the connection, so
        the writer sees EOF/error within its own timeout and retries
        idempotently by write_id."""
        self.metrics.count("net.writes")
        try:
            handler = self.write_handler
            if handler is None:
                from ..serve import plane as serve_plane

                resp = serve_plane.encode(
                    {"member": self.member, "error": "no ingest plane"}
                )
            else:
                resp = bytes(handler(payload))
        except Exception:  # noqa: BLE001 — degrade: close, writer times out
            try:
                conn.close()
            except OSError:
                pass
            return
        frame = pack_frame(
            (A_WRITE_ACK, self.member.encode("utf-8"), resp)
            if wid is None
            else (A_WRITE_ACK, self.member.encode("utf-8"), resp, wid)
        )
        try:
            if faults.ACTIVE and faults.fire("tcp.send") == "drop":
                self.metrics.count("net.fault_drops")
                raise OSError("injected write-ack drop")
            conn.sendall(frame)
        except OSError:
            try:
                conn.close()
            except OSError:
                pass

    # -- Transport: liveness ----------------------------------------------

    def _targets(self) -> List[Tuple[str, bool]]:
        """Where self's own frames go: every link when full-mesh, the
        router's (peer, cross_zone) picks once install_router() ran."""
        names = sorted(self._links)
        if self.router is None:
            return [(n, False) for n in names]
        return self.router.send_targets(names)

    def heartbeat(self) -> None:
        for peer, cross in self._targets():
            link = self._links.get(peer)
            if link is None:
                continue
            meta = {"cross_zone": True} if cross else None
            link.enqueue(_PING, self._ping_frame(link), meta=meta)

    def members(self) -> List[str]:
        return self.membership.members()

    def peers(self) -> List[str]:
        return [m for m in self.members() if m != self.member]

    def alive_members(self, timeout_s: float) -> List[str]:
        return self.membership.alive(timeout_s)

    # -- Transport: snapshots ---------------------------------------------

    def publish(self, blob: bytes) -> None:
        with self._lock:
            self._snaps[self.member] = blob
        path = [(self.member, self.zone)]
        for peer, cross in self._targets():
            link = self._links.get(peer)
            if link is None:
                continue
            if cross:
                # Self is its zone's anchor sending straight across the
                # DCN: stamp the path so the remote anchor can fan out.
                link.enqueue(
                    _SNAP,
                    self._rsnap_frame(self.member, blob, path, link),
                    meta={"origin": self.member, "cross_zone": True},
                )
            else:
                link.enqueue(
                    _SNAP,
                    self._snap_frame(blob, link),
                    meta={"origin": self.member},
                )

    def fetch(self, member: str) -> Optional[bytes]:
        with self._lock:
            return self._snaps.get(member)

    def fetch_head(self, member: str, n: int) -> Optional[bytes]:
        with self._lock:
            blob = self._snaps.get(member)
        return None if blob is None else blob[:n]

    def snapshot_members(self) -> List[str]:
        with self._lock:
            return sorted(self._snaps)

    # -- Transport: deltas -------------------------------------------------

    def publish_delta(self, seq: int, blob: bytes, keep: int = 16) -> None:
        # Compacted range frames (net.transport CCRF framing) ride the
        # wire as ordinary opaque delta blobs — peek the header only for
        # send-side observability (the meta `lo` shows up in queue-shed
        # diagnostics; one frame may carry many windows).
        lo = transport.frame_range(blob, seq)[0]
        if lo < seq and self.metrics is not None:
            self.metrics.count("net.tcp.coalesced_frames_sent")
        with self._lock:
            window = self._deltas.setdefault(self.member, {})
            window[seq] = blob
            for s in [s for s in window if s <= seq - keep]:
                del window[s]
        path = [(self.member, self.zone)]
        for peer, cross in self._targets():
            link = self._links.get(peer)
            if link is None:
                continue
            if cross:
                link.enqueue(
                    _DELTA,
                    self._rdelta_frame(self.member, seq, keep, blob, path, link),
                    meta={
                        "origin": self.member, "dseq": seq, "lo": lo,
                        "cross_zone": True,
                    },
                )
            else:
                link.enqueue(
                    _DELTA,
                    self._delta_frame(seq, keep, blob, link),
                    meta={"origin": self.member, "dseq": seq, "lo": lo},
                )

    def fetch_delta(self, member: str, seq: int) -> Optional[bytes]:
        with self._lock:
            return self._deltas.get(member, {}).get(seq)

    def delta_seqs(self, member: str) -> List[int]:
        with self._lock:
            return sorted(self._deltas.get(member, {}))

    def delta_members(self) -> List[str]:
        with self._lock:
            return sorted(self._deltas)

    # -- Transport: partition plane ----------------------------------------

    def publish_digest(self, blob: bytes) -> None:
        """Push the (tiny) digest-vector blob like a snapshot anchor;
        routed `{rdig}` across zones so remote fleets can detect
        divergence without ever pulling whole snapshots."""
        with self._lock:
            self._digs[self.member] = blob
        path = [(self.member, self.zone)]
        for peer, cross in self._targets():
            link = self._links.get(peer)
            if link is None:
                continue
            if cross:
                link.enqueue(
                    _DIG,
                    self._rdig_frame(self.member, blob, path, link),
                    meta={"origin": self.member, "cross_zone": True},
                )
            else:
                link.enqueue(
                    _DIG,
                    self._dig_frame(blob, link),
                    meta={"origin": self.member},
                )

    def fetch_digest(self, member: str) -> Optional[bytes]:
        with self._lock:
            return self._digs.get(member)

    def publish_psnap(self, part: int, blob: bytes) -> None:
        """Store-only: psnap bytes cross the wire exclusively on demand
        (`request_psnaps` -> `{psnap_req}` -> `{psnap}`) — broadcasting
        them would re-create the whole-snapshot bill the partition plane
        exists to avoid."""
        with self._lock:
            self._psnaps.setdefault(self.member, {})[int(part)] = blob

    def fetch_psnap(self, member: str, part: int) -> Optional[bytes]:
        key = (member, int(part))
        with self._lock:
            while key in self._psnap_asked:
                left = self._psnap_asked[key] - time.monotonic()
                if left <= 0:
                    del self._psnap_asked[key]  # no reply: read the cache
                    break
                self._psnap_landed.wait(left)
            return self._psnaps.get(member, {}).get(int(part))

    def request_psnaps(self, member: str, parts: List[int]) -> None:
        if not parts:
            return
        link = self._links.get(member)
        if link is None:
            return  # unreachable peer: caller falls back to full resync
        self.metrics.count("net.psnap_reqs_sent")
        deadline = time.monotonic() + PSNAP_WAIT_S
        with self._lock:
            for p in parts:
                self._psnap_asked[(member, int(p))] = deadline
        link.enqueue(
            "psnap_req",  # no special queue policy: tiny and re-askable
            self._psnap_req_frame([int(p) for p in parts], link),
            meta={"origin": self.member},
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass
        for link in self._links.values():
            link.close()
