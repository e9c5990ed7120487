"""Structured event tracing: a bounded flight-recorder ring + JSONL spill.

The cluster's "what happened" plane. Every runtime layer (net transports,
membership, WAL, bridge, fault registry) emits small typed events into a
per-process `FlightRecorder`:

    {"seq": 17, "t": 1754380000.123456, "member": "w1",
     "kind": "delta.apply", "origin": "w0", "dseq": 4}

* ``seq`` is a per-process monotonic ordinal (the recorder's own lamport
  axis — wall clocks across workers need not agree);
* ``member`` is the process identity (set once via `configure`);
* ``kind`` is a dotted type name; the wired kinds are listed below;
* remaining keys are the event's typed payload.

Trace context: delta events carry ``(origin, dseq)`` — the publishing
replica and its delta sequence number, the same pair the `{packet,4}`
gossip frames already ship in their `{delta, Member, Seq, ...}` terms —
so one logical delta can be followed end to end across every process's
log: ``delta.publish`` (origin) -> ``frame.send``/``transport.delta_write``
(medium) -> ``frame.recv``/``delta.fetch`` (receiver) -> ``delta.apply``
(each peer). `scripts/obs_dashboard.py --demo` reconstructs exactly this
path as its acceptance check.

Durability model (the crash part of "flight recorder"):

* the RING is always on: a bounded `collections.deque` (default 4096) —
  cheap appends, never grows, inspectable in-process via `events()`;
* when ``CCRDT_OBS_DIR`` is set (`install_from_env`, mirroring how
  `utils.faults` propagates `CCRDT_FAULTS` to drill subprocesses), every
  event is ALSO appended, line-buffered, to
  ``<dir>/flight-<member>-<pid>.jsonl``. Line buffering flushes each
  event to the kernel as it happens, so even a SIGKILL — which no
  handler can observe — leaves every emitted event on disk; the `make
  crash-demo` drill asserts the victim's dump ends just before its kill
  point. One file per (member, pid): a restarted incarnation never
  appends to its dead predecessor's log;
* `atexit` + SIGTERM/SIGINT hooks write a final ``proc.exit`` event and
  close the spill — its ABSENCE marks a log as a crash dump.

Wired event kinds:

    delta.publish / delta.fetch / delta.apply / snap.publish / snap.apply
    frame.send / frame.recv / frame.relay  (tcp+sim; origin+dseq trace
                                        context; relay = topo/ anchors)
    topo.anchor_change                 (zone anchor election / failover)
    transport.delta_write              (fs medium; the frame-send analog)
    peer.suspect / peer.dead / peer.realive   (SWIM transitions, with age)
    wal.append / wal.rotate / wal.checkpoint / wal.recover / wal.torn
    wal.durable / wal.truncate         (group-commit flush acks and
                                        watermark truncation: the
                                        published-vs-durable audit axis)
    fault.hit                          (utils.faults firings)
    bridge.request / bridge.reconnect
    serve.query / serve.swap            (read-serving plane: batched
                                        reads answered, replica swaps)
    sim.drop / sim.crash / sim.partition / sim.heal
    proc.start / proc.exit
    ingest.write / ingest.fold / ingest.ack   (write tier; request plane)
    session.write / session.read              (read-tier session audit feed)
    rtrace.trace                              (request tracing, obs/rtrace.py)

Request plane: the high-rate per-request kinds (`REQUEST_KINDS` +
``rtrace.*``) are isolated into per-kind rings and their own
``flight-req-<member>-<pid>.jsonl`` spill — a request flood can never
evict another kind's audit evidence (certify_sessions/certify_writes
replay session.* and ingest.ack/ingest.fold) nor anything in the main
ring. `events()` merges both planes on the shared seq axis; `scan_dir`
picks up both spill streams; lifecycle events are written to both files
so each is self-describing about clean exit vs crash.

This module is stdlib-only and imported by nearly every runtime layer —
it must never import back into the package.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import signal
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

ENV_DIR = "CCRDT_OBS_DIR"
DEFAULT_RING = 4096
DEFAULT_REQUEST_RING = 1 << 16

# High-rate per-REQUEST kinds: one (or more) of these fires for every
# routed read/write the fleet serves, so a request storm arrives at
# 10^4-10^5 events while the control-plane kinds above trickle. They
# live in their OWN per-kind rings (+ their own spill stream) so a
# flood of one kind can never evict another kind's audit evidence —
# certify_sessions replays session.write/session.read, certify_writes
# replays ingest.ack/ingest.fold.
# `rtrace.*` events (obs/rtrace.py) are request-plane by prefix.
REQUEST_KINDS = frozenset({
    "serve.query", "ingest.write", "ingest.ack", "ingest.fold",
    "session.write", "session.read", "router.give_up",
    "router.write_give_up", "fault.hit",
})


def _is_request_kind(kind: str) -> bool:
    # `devprof.*` (compile events, obs/devprof.py) ride the request
    # plane too: a recompile storm is exactly the burst shape the
    # per-kind rings exist to isolate, and the line-buffered req spill
    # is what makes compile evidence survive a SIGKILL.
    return (
        kind in REQUEST_KINDS
        or kind.startswith("rtrace.")
        or kind.startswith("devprof.")
    )


class FlightRecorder:
    """One process's bounded event rings + optional line-buffered spill.

    Two planes share one seq axis (so merged replay order is total):

    * the MAIN ring holds control-plane events (gossip, SWIM, WAL,
      topo, ...) at `ring` capacity;
    * request-plane kinds (`REQUEST_KINDS` + ``rtrace.*``) get one ring
      EACH at `req_ring` capacity and spill to a separate
      ``flight-req-*`` stream — per-kind isolation means a serve.query
      flood can never evict ingest.fold/ingest.ack audit evidence, and
      nothing request-shaped can touch the main ring at all.
    """

    def __init__(
        self,
        member: str = "?",
        ring: int = DEFAULT_RING,
        spill_path: Optional[str] = None,
        req_ring: int = DEFAULT_REQUEST_RING,
        req_spill_path: Optional[str] = None,
    ):
        self.member = member
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.req_ring_max = int(req_ring)
        self.req_rings: Dict[str, collections.deque] = {}
        self.spill_path = spill_path
        self.req_spill_path = req_spill_path
        self._seq = 0
        self._lock = threading.Lock()
        self._fh = None
        self._req_fh = None
        if spill_path is not None:
            os.makedirs(os.path.dirname(spill_path) or ".", exist_ok=True)
            # buffering=1: line-buffered — each event reaches the kernel
            # when its newline is written, which is what makes the spill
            # a usable post-SIGKILL flight record.
            self._fh = open(spill_path, "a", buffering=1)
        if req_spill_path is not None:
            os.makedirs(
                os.path.dirname(req_spill_path) or ".", exist_ok=True
            )
            self._req_fh = open(req_spill_path, "a", buffering=1)

    def emit(self, kind: str, **fields: Any) -> Dict[str, Any]:
        ev: Dict[str, Any] = {"kind": kind, "member": self.member}
        ev.update(fields)
        req = _is_request_kind(kind)
        with self._lock:
            ev["seq"] = self._seq
            self._seq += 1
            ev["t"] = round(time.time(), 6)
            if req:
                ring = self.req_rings.get(kind)
                if ring is None:
                    ring = self.req_rings[kind] = collections.deque(
                        maxlen=self.req_ring_max
                    )
                ring.append(ev)
            else:
                self.ring.append(ev)
            fh = self._req_fh if req else self._fh
            if fh is None and req:
                fh = self._fh  # request spill follows the main spill
            fhs = [fh] if fh is not None else []
            if kind in ("proc.start", "proc.exit") \
                    and self._req_fh is not None:
                # Lifecycle events land in BOTH spills: every flight
                # file must be self-describing about whether its
                # incarnation exited cleanly (certify_writes reads the
                # absence of proc.exit as a crash dump, per file).
                fhs.append(self._req_fh)
            for f in fhs:
                try:
                    f.write(json.dumps(ev, default=str) + "\n")
                except (OSError, ValueError):
                    pass  # a full/closed spill must never crash the caller
        return ev

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            if kind is not None:
                src = self.req_rings.get(kind) if _is_request_kind(kind) \
                    else self.ring
                evs = list(src) if src is not None else []
            else:
                evs = list(self.ring)
                for ring in self.req_rings.values():
                    evs.extend(ring)
                evs.sort(key=lambda e: e["seq"])
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def dump(self, path: str) -> int:
        """Write the current ring contents as JSONL; returns event count.
        (The spill file, when enabled, is already the durable record —
        this is for explicit post-mortems and tests.)"""
        evs = self.events()
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=str) + "\n")
        return len(evs)

    def close(self) -> None:
        with self._lock:
            for attr in ("_fh", "_req_fh"):
                fh = getattr(self, attr)
                if fh is not None:
                    try:
                        fh.close()
                    except OSError:
                        pass
                    setattr(self, attr, None)


# -- module-level recorder (the surface the runtime layers use) -------------

_recorder = FlightRecorder()
_hooks_installed = False


def recorder() -> FlightRecorder:
    return _recorder


def emit(kind: str, **fields: Any) -> Dict[str, Any]:
    """Record one event on the process recorder (thread-safe, bounded)."""
    return _recorder.emit(kind, **fields)


def events(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    return _recorder.events(kind)


def dump(path: str) -> int:
    return _recorder.dump(path)


def configure(
    member: str,
    ring: int = DEFAULT_RING,
    spill_dir: Optional[str] = None,
    crash_hooks: bool = True,
    req_ring: int = DEFAULT_REQUEST_RING,
) -> FlightRecorder:
    """Replace the process recorder: set its identity, ring bounds, and
    (optionally) the spill directory. Emits ``proc.start`` so every log
    opens with the incarnation's identity and pid."""
    global _recorder
    old, spill, req_spill = _recorder, None, None
    if spill_dir is not None:
        spill = os.path.join(spill_dir, f"flight-{member}-{os.getpid()}.jsonl")
        req_spill = os.path.join(
            spill_dir, f"flight-req-{member}-{os.getpid()}.jsonl"
        )
    _recorder = FlightRecorder(
        member=member, ring=ring, spill_path=spill,
        req_ring=req_ring, req_spill_path=req_spill,
    )
    old.close()
    if crash_hooks and spill is not None:
        _install_exit_hooks()
    _recorder.emit("proc.start", pid=os.getpid())
    return _recorder


def install_from_env(
    member: str, env: Optional[Dict[str, str]] = None
) -> bool:
    """Enable the disk spill iff ``CCRDT_OBS_DIR`` is set (the same
    supervisor->worker propagation pattern `utils.faults` uses for
    ``CCRDT_FAULTS``). Returns whether a spill was enabled; without the
    env var the in-memory ring still records under `member`'s name."""
    d = (env if env is not None else os.environ).get(ENV_DIR)
    configure(member, spill_dir=d or None)
    return bool(d)


def reset(
    member: str = "?",
    ring: int = DEFAULT_RING,
    req_ring: int = DEFAULT_REQUEST_RING,
) -> FlightRecorder:
    """Fresh in-memory recorder (tests)."""
    return configure(member, ring=ring, crash_hooks=False, req_ring=req_ring)


def _install_exit_hooks() -> None:
    """atexit + SIGTERM/SIGINT: stamp ``proc.exit`` and close the spill.
    A log WITHOUT a trailing proc.exit is a crash dump (SIGKILL / torn
    process) — the discriminator `crash_recovery_demo` keys on. Handlers
    chain to any previously-installed ones; installation is idempotent
    and skipped off the main thread (signal module restriction)."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True

    def _finalize() -> None:
        _recorder.emit("proc.exit", pid=os.getpid())
        _recorder.close()

    atexit.register(_finalize)
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev = signal.getsignal(sig)

            def _handler(signum, frame, _prev=prev):
                _finalize()
                if callable(_prev):
                    _prev(signum, frame)
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(sig, _handler)
        except (OSError, ValueError):
            pass  # non-main interpreter contexts


# -- log readers (dashboard / drills / tests) --------------------------------


def read_log(path: str) -> List[Dict[str, Any]]:
    """Parse one flight JSONL file, skipping any torn tail line (a
    SIGKILL can land mid-write of the final event)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn tail
    except OSError:
        pass
    return out


def scan_dir(obs_dir: str) -> Dict[str, List[Dict[str, Any]]]:
    """All flight logs in a spill dir: {filename: [events...]}."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    try:
        names = sorted(os.listdir(obs_dir))
    except OSError:
        return out
    for fn in names:
        if fn.startswith("flight-") and fn.endswith(".jsonl"):
            out[fn] = read_log(os.path.join(obs_dir, fn))
    return out


def delta_paths(
    logs: Dict[str, List[Dict[str, Any]]]
) -> Dict[tuple, Dict[str, List[Dict[str, Any]]]]:
    """Group delta trace events across a fleet's logs by their trace
    context: {(origin, dseq): {stage: [events]}} where stage is one of
    publish/send/write/relay/recv/fetch/apply — the cross-replica
    propagation path of each logical delta (relay = a zone anchor
    forwarding a routed frame, topo/)."""
    stages = {
        "delta.publish": "publish",
        "frame.send": "send",
        "transport.delta_write": "write",
        "frame.relay": "relay",
        "frame.recv": "recv",
        "delta.fetch": "fetch",
        "delta.apply": "apply",
    }
    out: Dict[tuple, Dict[str, List[Dict[str, Any]]]] = {}
    for evs in logs.values():
        for ev in evs:
            stage = stages.get(ev.get("kind", ""))
            if stage is None or "dseq" not in ev or "origin" not in ev:
                continue
            key = (ev["origin"], int(ev["dseq"]))
            out.setdefault(key, {}).setdefault(stage, []).append(ev)
    return out


def iter_kinds(
    logs: Dict[str, List[Dict[str, Any]]], kind: str
) -> Iterator[Dict[str, Any]]:
    for evs in logs.values():
        for ev in evs:
            if ev.get("kind") == kind:
                yield ev
