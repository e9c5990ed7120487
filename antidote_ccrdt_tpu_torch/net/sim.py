"""Deterministic in-process simulated transport for chaos testing.

Replay-based convergence checking (the approach "Automatically Verifying
Replication-aware Linearizability" argues CRDT stacks need) requires the
fault schedule to be EXACTLY reproducible: same seed -> same drops, same
duplicates, same delivery order, bit-identical final states. So the
simulator owns ALL nondeterminism sources:

* a VIRTUAL clock (`SimNet.time`) advanced only by `advance`/`run_until`
  — no wall clock anywhere; `Membership` runs on it via its injected
  `now`;
* one seeded `random.Random` consumed in a deterministic order (the
  drill loop steps members single-threaded; there are no threads in here);
* a message heap ordered by (delivery time, send counter) so latency
  ties break deterministically.

Faults: per-message latency sampled from a range (which yields
reordering for free), iid loss and duplication probabilities, named
partitions (`partition`/`heal` — messages dropped at send time when
src and dst are in different groups), and member crashes (`crash` — a
crashed member neither sends nor receives, and its transport raises on
further use by the drill loop).

Messages carry the same logical payloads as `net.tcp` frames — the
blobs are the REAL serialized bytes (`GossipNode` encodes above the
transport), so chaos runs exercise the production encode/decode and
validation paths, not a shortcut."""

from __future__ import annotations

import heapq
import random
from typing import Dict, List, Optional, Tuple

from ..obs import events as obs_events
from ..obs import spans as obs_spans
from ..topo import ZoneMap, ZoneRouter, zone_from_env
from ..utils.metrics import Metrics
from . import transport
from .membership import Membership


class SimNet:
    """The shared medium: clock, fault injection, message scheduling."""

    def __init__(
        self,
        seed: int = 0,
        latency: Tuple[float, float] = (0.001, 0.02),
        loss: float = 0.0,
        dup: float = 0.0,
        metrics: Optional[Metrics] = None,
        link_latency: Optional[
            Dict[Tuple[str, str], Tuple[float, float]]
        ] = None,
    ):
        self.rng = random.Random(seed)
        self.latency = latency
        # Per-DIRECTION latency override {(src, dst): (lo, hi)}: lets a
        # drill make A->B slow and B->A fast (asymmetric RTT — exactly
        # the error term of the NTP-style offset estimate in obs/spans).
        self.link_latency = dict(link_latency or {})
        self.loss = loss
        self.dup = dup
        self.metrics = metrics if metrics is not None else Metrics()
        self.time = 0.0
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._counter = 0
        self._members: Dict[str, "SimTransport"] = {}
        self._groups: Optional[List[set]] = None
        self._crashed: set = set()

    # -- topology ----------------------------------------------------------

    def join(self, member: str, zone: Optional[str] = None) -> "SimTransport":
        """Add a member; `zone` opts it into the topo/ layout. The shared
        medium is the zone oracle: every existing member learns the
        newcomer's zone and vice versa (config-file discovery collapses
        to a dict in-process), so drills exercise routing, not gossip
        of the zone map itself — `net.tcp` covers that via hellos."""
        t = SimTransport(self, member, zone=zone)
        for other in self._members.values():
            other.zones.learn(member, t.zone)
            t.zones.learn(other.member, other.zone)
        self._members[member] = t
        return t

    def partition(self, *groups) -> None:
        """Split the network: members in different groups cannot exchange
        messages (members in no listed group are isolated)."""
        self._groups = [set(g) for g in groups]
        obs_events.emit(
            "sim.partition",
            groups=[sorted(g) for g in self._groups],
            vt=self.time,
        )

    def heal(self) -> None:
        self._groups = None
        obs_events.emit("sim.heal", vt=self.time)

    def crash(self, member: str) -> None:
        """Permanently silence `member`: no sends, no deliveries. Its
        queued in-flight messages are dropped at delivery time."""
        self._crashed.add(member)
        obs_events.emit("sim.crash", peer=member, vt=self.time)

    def reachable(self, src: str, dst: str) -> bool:
        if src in self._crashed or dst in self._crashed:
            return False
        if self._groups is None:
            return True
        return any(src in g and dst in g for g in self._groups)

    # -- transmission ------------------------------------------------------

    def send(self, src: str, dst: str, msg: tuple) -> None:
        """Apply the fault model and schedule delivery. Partition/crash
        filtering happens at SEND time (a message in flight when a
        partition forms still arrives — links don't retroactively eat
        packets); crash filtering repeats at delivery."""
        if not self.reachable(src, dst):
            self.metrics.count("net.sim_unreachable")
            obs_events.emit(
                "sim.drop", cause="unreachable", src=src, dst=dst,
                fkind=str(msg[0]), vt=self.time,
            )
            return
        copies = 1
        if self.rng.random() < self.loss:
            self.metrics.count("net.sim_lost")
            obs_events.emit(
                "sim.drop", cause="loss", src=src, dst=dst,
                fkind=str(msg[0]), vt=self.time,
            )
            copies = 0
        elif self.rng.random() < self.dup:
            self.metrics.count("net.sim_duplicated")
            copies = 2
        lo, hi = self.link_latency.get((src, dst), self.latency)
        for _ in range(copies):
            at = self.time + lo + (hi - lo) * self.rng.random()
            self._counter += 1
            heapq.heappush(self._heap, (at, self._counter, dst, msg))
            self.metrics.count("net.sim_msgs")

    def advance(self, dt: float) -> None:
        self.run_until(self.time + dt)

    def run_until(self, t: float) -> None:
        """Advance the virtual clock to `t`, delivering everything due."""
        while self._heap and self._heap[0][0] <= t:
            at, _n, dst, msg = heapq.heappop(self._heap)
            self.time = max(self.time, at)
            if dst in self._crashed:
                continue
            self._members[dst]._deliver(msg)
        self.time = max(self.time, t)


class SimTransport:
    """`net.transport.Transport` over a `SimNet` (see module docstring).

    Cache shape mirrors `net.tcp.TcpTransport`: pushes land in local
    snapshot/delta dicts, fetches read them; liveness is a `Membership`
    on the virtual clock, fed by piggybacked ages on every message."""

    def __init__(self, net: SimNet, member: str, zone: Optional[str] = None):
        self.net = net
        self.member = member
        self.metrics = net.metrics
        self.zone = zone if zone is not None else zone_from_env()
        self.zones = ZoneMap(member, self.zone)
        self.router: Optional[ZoneRouter] = None
        self.membership = Membership(
            member, now=lambda: net.time, metrics=net.metrics
        )
        self._snaps: Dict[str, bytes] = {}
        self._deltas: Dict[str, Dict[int, bytes]] = {}
        # Partition plane caches, mirroring net.tcp: digest vectors are
        # pushed; psnaps are stored locally and only transferred when a
        # peer requests divergent partitions.
        self._digs: Dict[str, bytes] = {}
        self._psnaps: Dict[str, Dict[int, bytes]] = {}
        # Clock model for offset-estimation drills: each member reads
        # the shared virtual clock through its own constant skew, and
        # `clock_exchange` runs the same T1/T2/T3 protocol the tcp hello
        # piggybacks — deterministically, so tests can bound the offset
        # error by the configured RTT asymmetry.
        self.clock_skew = 0.0
        self.clock = obs_spans.ClockSync()
        # Serve plane: in-band "query" messages are answered by this
        # handler when installed; replies land in the querier's
        # `query_resps` list at delivery time (the sim's synchronous
        # analog of tcp's reply-on-inbound-connection).
        self.query_handler = None
        self.query_resps: List[Tuple[str, bytes]] = []
        # Router metadata: qid-keyed responses + cancellation. A reply
        # whose qid was cancelled before delivery is DROPPED (counted,
        # `net.query_cancelled_drops`) — the sim analog of the router
        # reaping a hedge loser / failed-over attempt, and what the
        # zero-duplicate-answer drill asserts on.
        self.query_results: Dict[bytes, Tuple[str, bytes]] = {}
        # Insertion-ordered so the cap in `cancel_query` evicts the
        # oldest cancellations first — it only needs to cover qids whose
        # (possibly dup-delivered) responses can still be in flight, so
        # long chaos drills don't accumulate spent qids forever.
        self._query_cancelled: Dict[bytes, None] = {}
        # Ingest plane: in-band "write" messages, the write tier's twin
        # of the query plumbing above — same synchronous handler, same
        # wid-keyed results + cancellation-drop discipline, so sim
        # drills shake owner failover / duplicate delivery exactly as
        # the sockets would.
        self.write_handler = None
        self.write_acks: List[Tuple[str, bytes]] = []
        self.write_results: Dict[bytes, Tuple[str, bytes]] = {}
        self._write_cancelled: Dict[bytes, None] = {}

    def local_clock(self) -> float:
        """This member's view of time: virtual clock + its skew."""
        return self.net.time + self.clock_skew

    def clock_exchange(self, peer: str) -> None:
        """Start one NTP-style exchange with `peer`; the estimate lands
        in `self.clock` when the reply is delivered."""
        self._check_live()
        self._send(
            peer, ("clock_req", self.member, self.local_clock()), False, 0
        )

    def install_serve(self, plane) -> None:
        """Attach a serve plane (or any bytes->bytes handler), exactly
        as `TcpTransport.install_serve` — sim drills exercise the same
        query path chaos-deterministically. Payloads are opaque here
        too: an rtrace ``"trace"`` context and the response ``"rtrace"``
        echo round-trip byte-identically with the tcp surface."""
        handler_for = getattr(plane, "handler_for", None)
        if callable(handler_for):
            self.query_handler = handler_for("sim")
        else:
            self.query_handler = getattr(plane, "handle", plane)

    def query(self, peer: str, payload: bytes,
              qid: Optional[bytes] = None) -> None:
        """Send one serve-plane read to `peer`; the response arrives in
        `self.query_resps` as (peer, bytes) once the net delivers it.
        With `qid` (opaque router metadata, echoed by the peer) it ALSO
        lands in `self.query_results[qid]` — unless `cancel_query(qid)`
        ran first, in which case the late answer is dropped."""
        self._check_live()
        msg = (
            ("query", self.member, bytes(payload)) if qid is None
            else ("query", self.member, bytes(payload), bytes(qid))
        )
        self._send(peer, msg, False, len(payload))

    def install_ingest(self, plane) -> None:
        """Attach an ingest plane (or any bytes->bytes handler), exactly
        as `TcpTransport.install_ingest` — sim drills exercise the same
        write path chaos-deterministically."""
        handler_for = getattr(plane, "handler_for", None)
        if callable(handler_for):
            self.write_handler = handler_for("sim")
        else:
            self.write_handler = getattr(plane, "handle", plane)

    def write(self, peer: str, payload: bytes,
              wid: Optional[bytes] = None) -> None:
        """Send one ingest-plane write to `peer`; the ack arrives in
        `self.write_acks` as (peer, bytes) once the net delivers it.
        With `wid` (opaque router metadata, echoed by the peer) it ALSO
        lands in `self.write_results[wid]` — unless `cancel_write(wid)`
        ran first, in which case the late ack is dropped (the payload's
        write_id still dedups any retry at the plane)."""
        self._check_live()
        msg = (
            ("write", self.member, bytes(payload)) if wid is None
            else ("write", self.member, bytes(payload), bytes(wid))
        )
        self._send(peer, msg, False, len(payload))

    def cancel_write(self, wid: bytes) -> None:
        """Abandon an in-flight wid: its ack, if it ever arrives, is
        dropped instead of delivered — same bounded-set discipline as
        `cancel_query`. Note this abandons only the ACK; whether the
        write folded is the plane's business, which is why retries
        carry the same write_id."""
        wid = bytes(wid)
        self._write_cancelled[wid] = None
        while len(self._write_cancelled) > 1024:
            self._write_cancelled.pop(next(iter(self._write_cancelled)))
        self.write_results.pop(wid, None)

    def cancel_query(self, qid: bytes) -> None:
        """Abandon an in-flight qid: its response, if it ever arrives,
        is dropped instead of delivered — the sim's router-cancellation
        analog (a hedge loser must not surface a duplicate answer). The
        set only needs to cover in-flight qids, so it is bounded: beyond
        the cap the oldest cancellations (whose replies are long since
        dropped or never coming) are forgotten."""
        qid = bytes(qid)
        self._query_cancelled[qid] = None
        while len(self._query_cancelled) > 1024:
            self._query_cancelled.pop(next(iter(self._query_cancelled)))
        self.query_results.pop(qid, None)

    def install_router(self, timeout_s: float = 2.0) -> ZoneRouter:
        """Switch from full-mesh to the zone-aware topology, exactly as
        `TcpTransport.install_router` — so chaos drills shake the SAME
        routing policy the real sockets run."""
        self.router = ZoneRouter(
            self.member,
            self.zone,
            self.zones,
            membership=self.membership,
            timeout_s=timeout_s,
            metrics=self.metrics,
        )
        return self.router

    # -- send side ---------------------------------------------------------

    def _check_live(self) -> None:
        if self.member in self.net._crashed:
            raise RuntimeError(f"{self.member} is crashed (a drill-loop bug)")

    def _targets(self) -> List[Tuple[str, bool]]:
        peers = [m for m in sorted(self.net._members) if m != self.member]
        if self.router is None:
            return [(m, False) for m in peers]
        return self.router.send_targets(peers)

    def _send(self, dst: str, msg_base: tuple, cross: bool, nbytes: int) -> None:
        if cross:
            self.metrics.count("topo.cross_zone.frames")
            self.metrics.count("topo.cross_zone.bytes", nbytes)
        # heard_ages is per-send so every copy carries fresh evidence
        # (matches tcp's encode-at-send-time rule).
        self.net.send(
            self.member, dst,
            msg_base + (dict(self.membership.heard_ages()),),
        )

    def heartbeat(self) -> None:
        self._check_live()
        for dst, cross in self._targets():
            self._send(dst, ("ping", self.member), cross, 0)

    def publish(self, blob: bytes) -> None:
        self._check_live()
        self._snaps[self.member] = blob
        path = [(self.member, self.zone)]
        for dst, cross in self._targets():
            if cross:
                self._send(
                    dst, ("rsnap", self.member, blob, path), True, len(blob)
                )
            else:
                self._send(dst, ("snap", self.member, blob), False, 0)

    def publish_delta(self, seq: int, blob: bytes, keep: int = 16) -> None:
        self._check_live()
        window = self._deltas.setdefault(self.member, {})
        window[seq] = blob
        for s in [s for s in window if s <= seq - keep]:
            del window[s]
        path = [(self.member, self.zone)]
        for dst, cross in self._targets():
            if cross:
                self._send(
                    dst,
                    ("rdelta", self.member, seq, keep, blob, path),
                    True,
                    len(blob),
                )
            else:
                self._send(
                    dst, ("delta", self.member, seq, keep, blob), False, 0
                )

    # -- partition plane ---------------------------------------------------

    @staticmethod
    def _ccpt_seq(blob: bytes) -> Optional[int]:
        import struct as _struct

        if len(blob) >= 14 and bytes(blob[:4]) == b"CCPT":
            return _struct.unpack_from("<Q", blob, 6)[0]
        return None

    def publish_digest(self, blob: bytes) -> None:
        self._check_live()
        self._digs[self.member] = blob
        path = [(self.member, self.zone)]
        for dst, cross in self._targets():
            if cross:
                self._send(
                    dst, ("rdig", self.member, blob, path), True, len(blob)
                )
            else:
                self._send(dst, ("dig", self.member, blob), False, 0)

    def fetch_digest(self, member: str) -> Optional[bytes]:
        return self._digs.get(member)

    def publish_psnap(self, part: int, blob: bytes) -> None:
        self._check_live()
        self._psnaps.setdefault(self.member, {})[int(part)] = blob

    def fetch_psnap(self, member: str, part: int) -> Optional[bytes]:
        return self._psnaps.get(member, {}).get(int(part))

    def request_psnaps(self, member: str, parts: List[int]) -> None:
        self._check_live()
        if parts:
            self.metrics.count("net.psnap_reqs_sent")
            self._send(
                member, ("psnap_req", self.member, list(parts)), False, 0
            )

    # -- receive side ------------------------------------------------------

    def _store_snap(self, src: str, blob: bytes) -> bool:
        old = self._snaps.get(src)
        # Same reorder guard as tcp: only a >= step header replaces.
        import struct as _struct

        if (
            old is None
            or len(blob) < 8
            or _struct.unpack("<Q", blob[:8])[0]
            >= _struct.unpack("<Q", old[:8])[0]
        ):
            self._snaps[src] = blob
            return True
        return False

    def _store_delta(self, src: str, seq: int, keep: int, blob: bytes) -> bool:
        window = self._deltas.setdefault(src, {})
        fresh = seq not in window
        window[seq] = blob
        if fresh and blob[:4] == transport.FRAME_MAGIC:
            # Compacted range frame (CCRF) landed — receive-side mirror
            # of the publisher's ingest.coalesced_frames counter, so sim
            # chaos drills can assert compaction actually crossed the
            # (lossy) wire and not just left the publisher.
            self.metrics.count("net.sim.coalesced_frames_recv")
        # Prune against the window MAX, not this message's seq: a
        # reordered old delta must not re-enter past the keep bound.
        hi = max(window)
        for s in [s for s in window if s <= hi - keep]:
            del window[s]
        return fresh and seq in window

    def _store_dig(self, src: str, blob: bytes) -> bool:
        old = self._digs.get(src)
        new_seq = self._ccpt_seq(blob)
        old_seq = self._ccpt_seq(old) if old is not None else None
        if (
            old is None
            or new_seq is None
            or old_seq is None
            or new_seq >= old_seq
        ):
            self._digs[src] = blob
            return True
        return False

    def _store_psnap(self, src: str, part: int, blob: bytes) -> bool:
        window = self._psnaps.setdefault(src, {})
        old = window.get(part)
        new_seq = self._ccpt_seq(blob)
        old_seq = self._ccpt_seq(old) if old is not None else None
        if (
            old is None
            or new_seq is None
            or old_seq is None
            or new_seq >= old_seq
        ):
            window[part] = blob
            return True
        return False

    def _deliver(self, msg: tuple) -> None:
        if obs_spans.ACTIVE:
            # Same phase name as the tcp reader thread: frame ingest.
            with obs_spans.span(
                "round.gossip_recv", wire=True, fkind=str(msg[0]),
                sim_member=self.member,
            ):
                self._deliver_inner(msg)
        else:
            self._deliver_inner(msg)

    def _deliver_inner(self, msg: tuple) -> None:
        kind, src = msg[0], msg[1]
        heard = msg[-1]
        sender = src
        if kind == "clock_req":
            # Reply with (echoed T1, our clock at receipt): the
            # requester completes the offset estimate at delivery.
            t1 = msg[2]
            self._send(
                src,
                ("clock_resp", self.member, t1, self.local_clock()),
                False,
                0,
            )
        elif kind == "clock_resp":
            t1, t2 = msg[2], msg[3]
            self.clock.note(src, t1, t2, self.local_clock())
        elif kind == "snap":
            blob = msg[2]
            if self._store_snap(src, blob) and (
                self.zones.zone_of(src) == self.zone
            ):
                self._relay("snap", src, [(src, self.zone)],
                            lambda path: ("rsnap", src, blob, path), len(blob))
        elif kind == "rsnap":
            _k, origin, blob, path = msg[:4]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            sender = path[-1][0] if path else origin
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_snap(origin, blob):
                self._relay("snap", origin, path,
                            lambda p: ("rsnap", origin, blob, p), len(blob))
        elif kind == "delta":
            _k, _s, seq, keep, blob = msg[:5]
            if self._store_delta(src, seq, keep, blob) and (
                self.zones.zone_of(src) == self.zone
            ):
                self._relay(
                    "delta", src, [(src, self.zone)],
                    lambda p: ("rdelta", src, seq, keep, blob, p),
                    len(blob), dseq=seq,
                )
        elif kind == "rdelta":
            _k, origin, seq, keep, blob, path = msg[:6]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            sender = path[-1][0] if path else origin
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_delta(origin, seq, keep, blob):
                self._relay(
                    "delta", origin, path,
                    lambda p: ("rdelta", origin, seq, keep, blob, p),
                    len(blob), dseq=seq,
                )
        elif kind == "dig":
            blob = msg[2]
            if self._store_dig(src, blob) and (
                self.zones.zone_of(src) == self.zone
            ):
                self._relay("dig", src, [(src, self.zone)],
                            lambda p: ("rdig", src, blob, p), len(blob))
        elif kind == "rdig":
            _k, origin, blob, path = msg[:4]
            for pm, pz in path:
                self.zones.learn(pm, pz)
            sender = path[-1][0] if path else origin
            if not ZoneRouter.loop_safe(path, self.member):
                self.metrics.count("topo.relay_loops")
                return
            if self._store_dig(origin, blob):
                self._relay("dig", origin, path,
                            lambda p: ("rdig", origin, blob, p), len(blob))
        elif kind == "psnap":
            _k, _s, part, blob = msg[:4]
            self._store_psnap(src, int(part), blob)
        elif kind == "query":
            payload = msg[2]
            # Every frame carries the piggybacked heard-ages dict as its
            # last element, so a qid-bearing query is a 5-tuple and a
            # legacy qid-less one a 4-tuple.
            qid = bytes(msg[3]) if len(msg) > 4 else None
            handler = self.query_handler
            self.metrics.count("net.queries")
            if handler is not None:
                try:
                    resp = bytes(handler(bytes(payload)))
                except Exception as e:  # noqa: BLE001 — degrade, never wedge
                    import json as _json

                    resp = _json.dumps({"error": str(e)}).encode("utf-8")
            else:
                import json as _json

                resp = _json.dumps({"error": "no serve plane"}).encode("utf-8")
            out = (
                ("query_resp", self.member, resp) if qid is None
                else ("query_resp", self.member, resp, qid)
            )
            self._send(src, out, False, len(resp))
        elif kind == "query_resp":
            qid = bytes(msg[3]) if len(msg) > 4 else None
            if qid is not None and qid in self._query_cancelled:
                # Cancelled in flight: the router already moved on; a
                # late duplicate answer must not surface. Keep the qid
                # in the (bounded) cancel set: a dup-delivered copy of
                # this response may still be in flight behind it.
                self.metrics.count("net.query_cancelled_drops")
            else:
                self.query_resps.append((src, bytes(msg[2])))
                if qid is not None:
                    self.query_results[qid] = (src, bytes(msg[2]))
        elif kind == "write":
            payload = msg[2]
            # Same tuple convention as "query": the piggybacked heard
            # dict is the last element, so wid-bearing writes are
            # 5-tuples and wid-less ones 4-tuples.
            wid = bytes(msg[3]) if len(msg) > 4 else None
            handler = self.write_handler
            self.metrics.count("net.writes")
            if handler is not None:
                try:
                    resp = bytes(handler(bytes(payload)))
                except Exception as e:  # noqa: BLE001 — degrade, never wedge
                    import json as _json

                    resp = _json.dumps({"error": str(e)}).encode("utf-8")
            else:
                import json as _json

                resp = _json.dumps(
                    {"error": "no ingest plane"}
                ).encode("utf-8")
            out = (
                ("write_ack", self.member, resp) if wid is None
                else ("write_ack", self.member, resp, wid)
            )
            self._send(src, out, False, len(resp))
        elif kind == "write_ack":
            wid = bytes(msg[3]) if len(msg) > 4 else None
            if wid is not None and wid in self._write_cancelled:
                # Cancelled in flight: the router already failed over; a
                # late duplicate ack must not surface (the successor's
                # ack is the one the client keeps).
                self.metrics.count("net.write_cancelled_drops")
            else:
                self.write_acks.append((src, bytes(msg[2])))
                if wid is not None:
                    self.write_results[wid] = (src, bytes(msg[2]))
        elif kind == "psnap_req":
            parts = msg[2]
            self.metrics.count("net.psnap_reqs_recv")
            own = self._psnaps.get(self.member, {})
            for p in parts:
                blob = own.get(int(p))
                if blob is None:
                    continue
                self.metrics.count("net.psnap_serves")
                self._send(
                    src, ("psnap", self.member, int(p), blob), False, len(blob)
                )
        if sender != self.member:
            self.membership.observe(sender)
        self.membership.absorb(heard)

    def _relay(
        self,
        fkind: str,
        origin: str,
        path: list,
        mk_msg,
        nbytes: int,
        dseq: Optional[int] = None,
    ) -> None:
        """Forward an accepted frame per `plan_relay` (no-op for leaves
        and full-mesh transports). Mirrors tcp's relay: stamps self onto
        the path, counts cross-zone traffic, emits `frame.relay`."""
        router = self.router
        if router is None:
            return
        candidates = [m for m in sorted(self.net._members) if m != self.member]
        targets = router.plan_relay(origin, path, candidates)
        if not targets:
            return
        stamped = list(path) + [(self.member, self.zone)]
        for dst, cross in targets:
            self._send(dst, mk_msg(stamped), cross, nbytes)
        self.metrics.count("topo.relays")
        ev: Dict[str, object] = {
            "member": self.member,
            "fkind": fkind,
            "origin": origin,
            "hops": len(path),
            "n_targets": len(targets),
            "cross_zone": any(c for _, c in targets),
            "vt": self.net.time,
        }
        if dseq is not None:
            ev["dseq"] = dseq
        obs_events.emit("frame.relay", **ev)

    # -- Transport reads ---------------------------------------------------

    def members(self) -> List[str]:
        return self.membership.members()

    def peers(self) -> List[str]:
        return [m for m in self.members() if m != self.member]

    def alive_members(self, timeout_s: float) -> List[str]:
        return self.membership.alive(timeout_s)

    def fetch(self, member: str) -> Optional[bytes]:
        return self._snaps.get(member)

    def fetch_head(self, member: str, n: int) -> Optional[bytes]:
        blob = self._snaps.get(member)
        return None if blob is None else blob[:n]

    def snapshot_members(self) -> List[str]:
        return sorted(self._snaps)

    def fetch_delta(self, member: str, seq: int) -> Optional[bytes]:
        return self._deltas.get(member, {}).get(seq)

    def delta_seqs(self, member: str) -> List[int]:
        return sorted(self._deltas.get(member, {}))

    def delta_members(self) -> List[str]:
        return sorted(self._deltas)

    def close(self) -> None:
        pass
