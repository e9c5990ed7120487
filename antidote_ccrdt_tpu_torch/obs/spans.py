"""Round-phase span tracing: where a gossip round's wall time goes.

`obs.profile` times device dispatches in isolation; `obs.events` records
WHAT happened. Neither can answer the ROADMAP's top question — of the
~141ms e2e round (BENCH_r05), how much is WAL append vs delta encode vs
gossip I/O vs device sync, and how much is unattributed host slop? This
module adds the missing layer: named begin/end spans with monotonic
timestamps, span ids and parent links, recorded into a bounded ring and
(when ``CCRDT_OBS_DIR`` is set) a line-buffered crash-durable JSONL
spill, exactly mirroring the flight recorder's conventions.

The worker round is cut into ten load-bearing phases::

    round.wal_append       harness.wal.ElasticWal.log_step
    round.delta_encode     parallel.elastic.DeltaPublisher (delta branch,
                           including wire-window coalescing at flush)
    round.snapshot         parallel.elastic.DeltaPublisher (full branch)
    round.gossip_send      net.transport.GossipNode publish paths + the
                           tcp sender thread's actual wire write
    round.gossip_recv      GossipNode fetch paths (wire bytes only) + the
                           tcp reader thread
    round.delta_decode     GossipNode decode/validate of fetched blobs —
                           snapshot loads and the prefetcher's batched
                           frame decode both bill here
    round.delta_apply      parallel.elastic.sweep_deltas (delta + snap)
    round.device_dispatch  core.batch_merge folds, drill op application
    round.device_sync      explicit block_until_ready (only taken when
                           spans are ACTIVE — an honest sync point, the
                           off path is untouched)
    round.lag_update       obs.lag export in the worker loop

plus a ``round.e2e`` wrapper span per worker step that attribution
reconciles the phase sums against. Delta-flavoured spans carry the same
``(origin, dseq)`` trace context as the flight-recorder events, so a
span joins its events.

Overhead discipline copies `utils.faults`/`obs.profile`: a module-level
``ACTIVE`` bool call sites check FIRST — the disabled path is one global
load and a branch. Span durations are optionally mirrored into `Metrics`
as ``span.<name>`` latencies so the live scrape surfaces (HTTP /metrics,
in-band ``{metrics_req}``) carry the span plane without reading spills.

Cross-worker alignment: workers timestamp with ``time.monotonic()``,
whose epoch is per-process. `ClockSync` holds NTP-style per-peer offset
estimates — from an exchange (t1 = local send, t2 = remote clock at
receipt, t3 = local receive): ``offset = t2 - (t1 + t3)/2`` with error
bounded by the RTT asymmetry, keeping the minimum-RTT sample per peer
(the classic NTP filter). `net.tcp` piggybacks these timestamps on the
existing ``{hello}``/``{hello_ack}`` and ``{metrics_req}`` frames;
`net.sim` exposes a deterministic ``clock_exchange``. Offsets are
spilled as ``{"k": "offset"}`` records; `align_offsets` BFSes the
offset graph from a reference member so every fleet member's monotonic
clock maps onto one timeline, and `to_chrome_trace` emits Chrome
trace-event JSON (Perfetto-loadable) on that timeline.

This module is stdlib-only and must stay import-cycle-free: `net.tcp`,
`harness.wal`, `parallel.elastic`, and `core.batch_merge` all import it
at module load. The Metrics mirror is duck-typed for that reason.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

ENV_FLAG = "CCRDT_SPANS"
ENV_DIR = "CCRDT_OBS_DIR"  # shared with obs.events — one spill dir per fleet

DEFAULT_RING = 8192

# The load-bearing phases chaos_gate requires to stay lit. round.e2e is
# deliberately not here: it is the denominator, not a phase.
PHASES = (
    "round.wal_append",
    "round.delta_encode",
    "round.gossip_send",
    "round.gossip_recv",
    "round.delta_decode",
    "round.delta_apply",
    "round.device_dispatch",
    "round.device_sync",
    "round.snapshot",
    "round.lag_update",
)

E2E = "round.e2e"

# Conditional phases, deliberately NOT in PHASES: they only light when
# their subsystem is armed, so requiring them fleet-wide would fail
# every non-mesh / non-serve run. `round.serve_swap` is emitted by
# serve/replica.py; `round.ici_reduce` (ICI_REDUCE) by mesh/reduce.py —
# chaos_gate's mesh leg requires the latter lit *in mesh drills only*;
# `round.pager_hydrate` (PAGER_HYDRATE) by core/pager.py page-ins —
# chaos_gate's working-set leg requires it lit *in pager drills only*.
ICI_REDUCE = "round.ici_reduce"
PAGER_HYDRATE = "round.pager_hydrate"

# Hot-path gate — call sites must check `if spans.ACTIVE:` first.
ACTIVE = False

_TRACER: Optional["_Tracer"] = None


class ClockSync:
    """Minimum-RTT NTP-style offset filter.

    ``note(peer, t1, t2, t3)`` ingests one exchange (local-clock send
    time t1, remote-clock receipt time t2, local-clock receive time t3)
    and keeps, per peer, the offset estimate from the exchange with the
    smallest RTT seen so far — ``offset ~= remote_clock - local_clock``,
    accurate to half the RTT asymmetry."""

    def __init__(self):
        self.peers: Dict[str, Tuple[float, float]] = {}  # peer -> (offset, rtt)
        self._lock = threading.Lock()

    def note(
        self, peer: str, t1: float, t2: float, t3: float
    ) -> Optional[Tuple[float, float]]:
        rtt = t3 - t1
        if rtt < 0:  # clock went backwards / garbled frame: discard
            return None
        offset = t2 - (t1 + t3) / 2.0
        with self._lock:
            cur = self.peers.get(peer)
            if cur is None or rtt < cur[1]:
                self.peers[peer] = (offset, rtt)
        return offset, rtt

    def snapshot(self) -> Dict[str, Tuple[float, float]]:
        with self._lock:
            return dict(self.peers)


class _Tracer:
    """One per-process span recorder: bounded ring + optional spill."""

    def __init__(
        self,
        member: str,
        metrics: Any = None,
        ring: int = DEFAULT_RING,
        spill_dir: Optional[str] = None,
    ):
        self.member = member
        self.metrics = metrics
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.clock = ClockSync()
        self._lock = threading.Lock()
        self._sid = 0
        self._tids: Dict[int, int] = {}  # thread ident -> small stable index
        self._tls = threading.local()
        self._fh = None
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
            path = os.path.join(
                spill_dir, f"spans-{member}-{os.getpid()}.jsonl"
            )
            # Line-buffered like the flight recorder: every completed
            # span reaches the file before a SIGKILL.
            self._fh = open(path, "a", buffering=1)
        # The wall<->monotonic anchor: lets readers place this process's
        # monotonic timeline on the wall clock (and each other's, via
        # offset records).
        self._write(
            {
                "k": "clock",
                "member": member,
                "pid": os.getpid(),
                "wall": round(time.time(), 6),
                "mono": time.monotonic(),
            }
        )

    # -- record plumbing ---------------------------------------------------

    def _write(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self.ring.append(rec)
            if self._fh is not None:
                try:
                    self._fh.write(json.dumps(rec) + "\n")
                except (OSError, ValueError):
                    pass  # spill is best-effort; the ring stays whole

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids)
                self._tids[ident] = tid
            return tid

    # -- span primitives ---------------------------------------------------

    def begin(self, name: str, fields: Dict[str, Any]) -> Dict[str, Any]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        with self._lock:
            self._sid += 1
            sid = self._sid
        frame = {
            "sid": sid,
            "parent": stack[-1]["sid"] if stack else None,
            "name": name,
            "m0": time.monotonic(),
            "fields": fields,
        }
        stack.append(frame)
        return frame

    def end(self, frame: Dict[str, Any]) -> None:
        m1 = time.monotonic()
        stack = getattr(self._tls, "stack", None)
        # Pop through any frames abandoned by exceptions between begin
        # and end (non-lexical begin/end users): the frame must leave
        # the stack exactly once.
        if stack:
            while stack and stack[-1]["sid"] != frame["sid"]:
                stack.pop()
            if stack:
                stack.pop()
        rec = {
            "k": "span",
            "name": frame["name"],
            "sid": frame["sid"],
            "parent": frame["parent"],
            "member": self.member,
            "tid": self._tid(),
            "m0": frame["m0"],
            "m1": m1,
        }
        if frame["fields"]:
            rec.update(frame["fields"])
        self._write(rec)
        m = self.metrics
        if m is not None:
            try:
                m.merge(
                    {
                        "counters": {},
                        "latencies": {f"span.{frame['name']}": [m1 - frame["m0"]]},
                    }
                )
            except Exception:  # noqa: BLE001 — tracing must never break a round
                pass

    def observe_exchange(
        self, peer: str, t1: float, t2: float, t3: float
    ) -> None:
        est = self.clock.note(peer, t1, t2, t3)
        if est is None:
            return
        offset, rtt = est
        self._write(
            {
                "k": "offset",
                "member": self.member,
                "peer": peer,
                "offset": offset,
                "rtt": rtt,
                "mono": time.monotonic(),
            }
        )
        m = self.metrics
        if m is not None:
            try:
                m.count("clock.exchanges")
                m.set(f"clock.offset_seconds.{peer}", offset)
            except Exception:  # noqa: BLE001
                pass

    def close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None


# -- lifecycle ----------------------------------------------------------------


def install(
    member: str,
    metrics: Any = None,
    ring: int = DEFAULT_RING,
    spill_dir: Optional[str] = None,
) -> None:
    """Arm the span plane for this process."""
    global ACTIVE, _TRACER
    if _TRACER is not None:
        _TRACER.close()
    _TRACER = _Tracer(member, metrics=metrics, ring=ring, spill_dir=spill_dir)
    ACTIVE = True


def uninstall() -> None:
    global ACTIVE, _TRACER
    ACTIVE = False
    tr, _TRACER = _TRACER, None
    if tr is not None:
        tr.close()


@contextlib.contextmanager
def installed(
    member: str,
    metrics: Any = None,
    ring: int = DEFAULT_RING,
    spill_dir: Optional[str] = None,
):
    """Scoped enable for tests: always restores the previous state."""
    global ACTIVE, _TRACER
    prev = _TRACER
    _TRACER = None  # detach so install() doesn't close the restorable tracer
    install(member, metrics=metrics, ring=ring, spill_dir=spill_dir)
    try:
        yield _TRACER
    finally:
        uninstall()
        if prev is not None:
            _TRACER = prev
            ACTIVE = True


def set_metrics(metrics: Any) -> None:
    """Attach (or replace) the Metrics mirror on the active tracer — for
    workers that must arm the plane before their Metrics object exists
    (the tcp drills install before the transport so the first hello
    exchange's clock offset is not lost). No-op when the plane is down."""
    tr = _TRACER
    if tr is not None:
        tr.metrics = metrics


def install_from_env(
    member: str, metrics: Any = None, env: Optional[dict] = None
) -> bool:
    """Arm iff ``CCRDT_SPANS`` is truthy; spill under ``CCRDT_OBS_DIR``
    when set (same supervisor->worker propagation as the flight
    recorder). Returns whether the plane was armed."""
    e = env if env is not None else os.environ
    raw = e.get(ENV_FLAG, "")
    if raw.strip().lower() not in ("1", "true", "yes", "on"):
        return False
    install(member, metrics=metrics, spill_dir=e.get(ENV_DIR) or None)
    return True


# -- recording API ------------------------------------------------------------


@contextlib.contextmanager
def span(name: str, **fields):
    """Record one span around the body. Call sites guard with
    ``if spans.ACTIVE:``; this tolerates a concurrent `uninstall`."""
    tr = _TRACER
    if tr is None:
        yield
        return
    frame = tr.begin(name, fields)
    try:
        yield
    finally:
        tr.end(frame)


def begin(name: str, **fields) -> Optional[Dict[str, Any]]:
    """Non-lexical begin: returns a token for `end`, or None when the
    plane is down (pass it to `end` unconditionally; None is a no-op)."""
    tr = _TRACER
    if tr is None:
        return None
    return tr.begin(name, fields)


def end(token: Optional[Dict[str, Any]]) -> None:
    tr = _TRACER
    if tr is None or token is None:
        return
    tr.end(token)


def observe_exchange(peer: str, t1: float, t2: float, t3: float) -> None:
    """Feed one NTP-style exchange into the active tracer (no-op when
    the plane is down)."""
    tr = _TRACER
    if tr is not None:
        tr.observe_exchange(peer, t1, t2, t3)


def drain() -> List[Dict[str, Any]]:
    """Snapshot of the in-memory ring (oldest first). Empty when down."""
    tr = _TRACER
    if tr is None:
        return []
    with tr._lock:
        return list(tr.ring)


# -- readers (post-mortem / merge side; work without ACTIVE) ------------------


def read_spans(path: str) -> List[Dict[str, Any]]:
    """All records in one spill file; a torn tail line (SIGKILL mid-
    write) is skipped, mirroring `obs.events.read_log`."""
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
                    continue
    except OSError:
        pass
    return out


def scan_dir(dirpath: str) -> Dict[str, List[Dict[str, Any]]]:
    """All span spills under `dirpath`, keyed by member (a member that
    restarted contributes all its pids' records, concatenated)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    try:
        names = sorted(os.listdir(dirpath))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith("spans-") and fn.endswith(".jsonl")):
            continue
        recs = read_spans(os.path.join(dirpath, fn))
        if not recs:
            continue
        member = next(
            (r["member"] for r in recs if "member" in r),
            fn[len("spans-"):].rsplit("-", 1)[0],
        )
        out.setdefault(member, []).extend(recs)
    return out


def clock_offsets(
    by_member: Dict[str, List[Dict[str, Any]]]
) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """Min-RTT offset per (member, peer) from the spilled offset
    records: ``offsets[a][b] ~= mono_b - mono_a``."""
    out: Dict[str, Dict[str, Tuple[float, float]]] = {}
    for member, recs in by_member.items():
        best: Dict[str, Tuple[float, float]] = {}
        for r in recs:
            if r.get("k") != "offset":
                continue
            peer, off, rtt = r.get("peer"), r.get("offset"), r.get("rtt")
            if peer is None or off is None or rtt is None:
                continue
            cur = best.get(peer)
            if cur is None or rtt < cur[1]:
                best[peer] = (float(off), float(rtt))
        if best:
            out[member] = best
    return out


def align_offsets(
    offsets: Dict[str, Dict[str, Tuple[float, float]]],
    members: Iterable[str],
    ref: Optional[str] = None,
) -> Dict[str, float]:
    """Per-member shift mapping local monotonic time onto the reference
    member's monotonic timeline: ``aligned = mono + shift[member]``,
    ``shift[ref] == 0``. BFS over the (bidirectional) offset graph,
    preferring low-RTT edges; unreachable members get shift 0 (their
    spans still render, just unaligned — the CLI reports them)."""
    members = sorted(set(members))
    if not members:
        return {}
    if ref is None or ref not in members:
        ref = members[0]
    # Build symmetric edge list: offsets[a][b] = mono_b - mono_a, so an
    # observation at b about a also yields an a->b edge with sign flip.
    edges: Dict[str, Dict[str, Tuple[float, float]]] = {m: {} for m in members}
    for a, peers in offsets.items():
        for b, (off, rtt) in peers.items():
            if a not in edges or b not in edges:
                continue
            cur = edges[a].get(b)
            if cur is None or rtt < cur[1]:
                edges[a][b] = (off, rtt)
            cur = edges[b].get(a)
            if cur is None or rtt < cur[1]:
                edges[b][a] = (-off, rtt)
    shift: Dict[str, float] = {ref: 0.0}
    frontier = [ref]
    while frontier:
        nxt: List[str] = []
        for a in frontier:
            for b, (off, _rtt) in sorted(
                edges.get(a, {}).items(), key=lambda kv: kv[1][1]
            ):
                if b in shift:
                    continue
                # aligned(a) = mono_a + shift[a]; mono_b ~= mono_a + off
                # => shift[b] = shift[a] - off.
                shift[b] = shift[a] - off
                nxt.append(b)
        frontier = nxt
    for m in members:
        shift.setdefault(m, 0.0)
    return shift


def anchor_of(recs: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    for r in recs:
        if r.get("k") == "clock":
            return r
    return None


def to_chrome_trace(
    by_member: Dict[str, List[Dict[str, Any]]],
    shifts: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """Merge per-member span records into one Chrome trace-event JSON
    object (Perfetto loads it directly). Timestamps are microseconds on
    the aligned reference timeline, zero-based at the earliest span."""
    if shifts is None:
        shifts = align_offsets(clock_offsets(by_member), by_member.keys())
    events: List[Dict[str, Any]] = []
    base: Optional[float] = None
    for member in sorted(by_member):
        sh = shifts.get(member, 0.0)
        for r in by_member[member]:
            if r.get("k") == "span":
                t = r["m0"] + sh
                if base is None or t < base:
                    base = t
    base = base or 0.0
    for pid, member in enumerate(sorted(by_member), start=1):
        sh = shifts.get(member, 0.0)
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": member},
            }
        )
        for r in by_member[member]:
            if r.get("k") != "span":
                continue
            args = {
                k: v
                for k, v in r.items()
                if k not in ("k", "name", "member", "tid", "m0", "m1")
            }
            events.append(
                {
                    "name": r["name"],
                    "cat": "round",
                    "ph": "X",
                    "ts": round((r["m0"] + sh - base) * 1e6, 3),
                    "dur": round((r["m1"] - r["m0"]) * 1e6, 3),
                    "pid": pid,
                    "tid": int(r.get("tid", 0)),
                    "args": args,
                }
            )
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"aligned_members": sorted(by_member)},
    }


# -- attribution --------------------------------------------------------------


def _union(intervals: List[Tuple[float, float]]) -> float:
    """Total length of the union of [lo, hi) intervals."""
    total, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def _pctl(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def attribute(
    by_member: Dict[str, List[Dict[str, Any]]]
) -> Dict[str, Any]:
    """Per-round dispatch-gap attribution.

    For every ``round.e2e`` span E on a worker: phase spans of the same
    member are clipped to E's window; those on E's own thread are the
    SERIAL host time, phases on other threads (tcp sender/reader, the
    overlap pipeline's host stage and prefetcher) are OVERLAPPABLE —
    work the round did not have to wait for. Coverage and the
    unattributed gap are measured against the union of BOTH classes
    (covered = serial ∪ overlappable clipped to E): an overlapped round
    is explained by phases regardless of which thread owns them, and
    the residue is time no instrumented phase accounts for. Per-phase
    TOTALS are summed over the phases' full (unclipped) extents — in
    overlap mode host stages run between e2e windows too, and totals
    must show where wall time went, not just the slice inside a window
    — while per-round ``phases_ms_p50`` samples stay clipped. Returns
    per-member and fleet aggregates: per-phase totals/p50s,
    serial/overlap/gap p50s, coverage p50, and the critical-path
    ranking (phases by total time)."""
    members_out: Dict[str, Any] = {}
    fleet_cov: List[float] = []
    fleet_phase_totals: Dict[str, float] = {}
    fleet_e2e: List[float] = []
    fleet_serial: List[float] = []
    fleet_overlap: List[float] = []
    fleet_gap: List[float] = []
    fleet_rounds = 0
    for member, recs in sorted(by_member.items()):
        spans_ = [r for r in recs if r.get("k") == "span"]
        e2es = sorted(
            (r for r in spans_ if r.get("name") == E2E),
            key=lambda r: r["m0"],
        )
        phases = [r for r in spans_ if r.get("name") in PHASES]
        rounds: List[Dict[str, Any]] = []
        phase_totals: Dict[str, float] = {}
        phase_samples: Dict[str, List[float]] = {}
        for e in e2es:
            lo, hi, tid = e["m0"], e["m1"], e.get("tid", 0)
            dur = hi - lo
            if dur <= 0:
                continue
            serial_iv: List[Tuple[float, float]] = []
            overlap_iv: List[Tuple[float, float]] = []
            by_phase: Dict[str, float] = {}
            for p in phases:
                plo, phi = max(p["m0"], lo), min(p["m1"], hi)
                if phi <= plo:
                    continue
                by_phase[p["name"]] = by_phase.get(p["name"], 0.0) + (phi - plo)
                if p.get("tid", 0) == tid:
                    serial_iv.append((plo, phi))
                else:
                    overlap_iv.append((plo, phi))
            serial = _union(serial_iv)
            overlap = _union(overlap_iv)
            covered = _union(serial_iv + overlap_iv)
            gap = max(0.0, dur - covered)
            rounds.append(
                {
                    "e2e": dur,
                    "serial": serial,
                    "overlap": overlap,
                    "gap": gap,
                    "coverage": covered / dur,
                    "phases": by_phase,
                }
            )
            for name, v in by_phase.items():
                phase_samples.setdefault(name, []).append(v)
        # Totals over the phases' full extents (NOT clipped to e2e
        # windows): overlapped host stages run during the inter-round
        # sleep as well, and that work must still show in the ledger.
        for p in phases:
            d = p["m1"] - p["m0"]
            if d > 0:
                phase_totals[p["name"]] = phase_totals.get(p["name"], 0.0) + d
        if not rounds:
            continue
        cov = [r["coverage"] for r in rounds]
        e2e_s = [r["e2e"] for r in rounds]
        ser_s = [r["serial"] for r in rounds]
        ovl_s = [r["overlap"] for r in rounds]
        gap_s = [r["gap"] for r in rounds]
        members_out[member] = {
            "rounds": len(rounds),
            "e2e_ms_p50": _pctl(e2e_s, 0.5) * 1e3,
            "serial_ms_p50": _pctl(ser_s, 0.5) * 1e3,
            "overlap_ms_p50": _pctl(ovl_s, 0.5) * 1e3,
            "gap_ms_p50": _pctl(gap_s, 0.5) * 1e3,
            "coverage_p50": _pctl(cov, 0.5),
            "phases_ms_p50": {
                n: _pctl(v, 0.5) * 1e3 for n, v in sorted(phase_samples.items())
            },
            "phases_ms_total": {
                n: v * 1e3 for n, v in sorted(phase_totals.items())
            },
            "critical_path": [
                n
                for n, _v in sorted(
                    phase_totals.items(), key=lambda kv: -kv[1]
                )
            ],
        }
        fleet_cov.extend(cov)
        fleet_e2e.extend(e2e_s)
        fleet_serial.extend(ser_s)
        fleet_overlap.extend(ovl_s)
        fleet_gap.extend(gap_s)
        fleet_rounds += len(rounds)
        for n, v in phase_totals.items():
            fleet_phase_totals[n] = fleet_phase_totals.get(n, 0.0) + v
    return {
        "members": members_out,
        "fleet": {
            "rounds": fleet_rounds,
            "e2e_ms_p50": _pctl(fleet_e2e, 0.5) * 1e3,
            "serial_ms_p50": _pctl(fleet_serial, 0.5) * 1e3,
            "overlap_ms_p50": _pctl(fleet_overlap, 0.5) * 1e3,
            "gap_ms_p50": _pctl(fleet_gap, 0.5) * 1e3,
            "coverage_p50": _pctl(fleet_cov, 0.5),
            "phases_ms_total": {
                n: v * 1e3 for n, v in sorted(fleet_phase_totals.items())
            },
            "critical_path": [
                n
                for n, _v in sorted(
                    fleet_phase_totals.items(), key=lambda kv: -kv[1]
                )
            ],
        },
    }


def format_report(att: Dict[str, Any]) -> str:
    """Human-readable attribute report (the CLI and demos print this)."""
    lines: List[str] = []
    fleet = att.get("fleet", {})
    lines.append(
        f"rounds={fleet.get('rounds', 0)} "
        f"e2e p50 {fleet.get('e2e_ms_p50', 0.0):.2f}ms | "
        f"serial {fleet.get('serial_ms_p50', 0.0):.2f}ms "
        f"overlappable {fleet.get('overlap_ms_p50', 0.0):.2f}ms "
        f"gap {fleet.get('gap_ms_p50', 0.0):.2f}ms "
        f"(coverage {fleet.get('coverage_p50', 0.0):.1%})"
    )
    totals = fleet.get("phases_ms_total", {})
    path = fleet.get("critical_path", [])
    if path:
        lines.append("critical path (by total phase time):")
        for name in path:
            lines.append(f"  {name:<22} {totals.get(name, 0.0):10.2f} ms")
    for member, row in sorted(att.get("members", {}).items()):
        lines.append(
            f"{member}: rounds={row['rounds']} "
            f"e2e p50 {row['e2e_ms_p50']:.2f}ms "
            f"serial {row['serial_ms_p50']:.2f}ms "
            f"gap {row['gap_ms_p50']:.2f}ms "
            f"coverage {row['coverage_p50']:.1%}"
        )
    return "\n".join(lines)
