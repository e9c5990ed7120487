"""Request-scoped tracing: per-request hop records + tail attribution.

The spans plane (obs/spans.py) is worker-centric: it explains where a
*round* spends its time inside one process. Since the read tier
and the write tier made queries and writes fleet products, a
request's latency is born ACROSS processes — HRW route decisions,
breaker verdicts, hedged attempts, serve-plane queue time, kernel
folds, WAL-durability waits, ack-tier probes — and a p99 scraped off
one worker decomposes none of it. This module is the request-scoped
counterpart:

* `FleetRouter.query()` / `WriteRouter.write()` call `begin()` to mint
  a trace context ``(trace_id, hop_seq)`` and record typed client hops
  (`route`, `attempt`, `hedge_launch`, `dead_reroute`, `backoff`,
  `ack_probe`) as the request progresses;
* when the trace is head-sampled, `Trace.wire()` returns a small
  ``{"id", "hs"}`` doc the router embeds in the request's canonical
  JSON — the payload is transport-opaque, so the SAME bytes propagate
  unchanged over the tcp `{query}`/`{write}` frames, the sim's in-band
  messages, the bridge ops, and `POST /query`·`/write`;
* the serve/ingest planes call `server_trace()` on a traced request,
  stamp their stage marks on THEIR monotonic clock (enqueue → drain →
  kernel for reads; stage → fold → durable wait for writes), and
  attach the echo to the response — an UNtraced request produces a
  byte-identical response to the pre-trace wire format (the tri-surface
  parity tests pin this);
* the client absorbs each echo together with the attempt's local
  send/recv times; that pair IS an NTP exchange, so the span tracer's
  `ClockSync` min-RTT filter recovers per-peer clock offsets and the
  waterfall assembles on ONE aligned timeline without scraping any
  worker.

Storage: committed traces are bounded three ways — a main ring, a
slow-request ring (the N slowest survive even a flood of fast ones),
and one ``rtrace.trace`` flight-recorder event per commit, which the
request-event stream (obs/events.py) spills to disk for the CLI
(`scripts/ccrdt_rtrace.py`) and post-mortems. Head sampling
(``CCRDT_RTRACE_SAMPLE``) bounds the server-side cost; requests that
end shed / failed / deadline-exceeded are ALWAYS committed (their
client hops need no server cooperation). ``CCRDT_RTRACE=0`` is the
kill switch: no mint, no echo, byte-identical wire traffic.

Degradation: every record path is guarded by the ``rtrace.record``
fault point and a bare except — tracing can degrade a request to
untraced but can never block or fail it.

Attribution decomposes client-observed latency into SEVEN buckets that
sum to the observed total (coverage ~1.0 by construction, lost only to
clock-mapping clips)::

    route         client-side routing decisions (candidate order,
                  breaker verdicts, staleness demotion)
    backoff       sleeps between retry rounds
    wire          attempt time not explained by the server (network +
                  connect + router poll slop)
    queue_wait    serve-plane enqueue->drain / ingest stage->fold wait
    kernel        device fold / materialize inside the winning server
    ack_probe     durability wait + replicated_to_k probes (writes)
    hedge_overlap duplicated in-flight time (Σ attempts − their union;
                  reported alongside, not double-counted in the sum)

Stdlib-only (no numpy, no torch); imports only sibling obs modules that
are themselves stdlib-only.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from . import events as obs_events
from .spans import ClockSync, _pctl, _union
from ..utils import faults

ENV = "CCRDT_RTRACE"
ENV_SAMPLE = "CCRDT_RTRACE_SAMPLE"

DEFAULT_RING = 2048
DEFAULT_SLOW = 64

BUCKETS = (
    "route", "backoff", "wire", "queue_wait", "kernel", "ack_probe",
    "hedge_overlap",
)

# Outcomes that force a commit regardless of the head-sample decision:
# failures are exactly the traces nobody can afford to have sampled out.
FORCED_OUTCOMES = ("shed", "failed", "deadline", "uncovered")

# Hot-path gate — call sites check `if rtrace.ACTIVE:` first.
ACTIVE = False

_PLANE: Optional["_Plane"] = None


def _killed(env: Optional[Dict[str, str]] = None) -> bool:
    return (env if env is not None else os.environ).get(ENV, "") == "0"


class Trace:
    """One request's client-side trace: id, ordered hops, server echoes.

    Thread-safe (attempt threads record concurrently); every mutator is
    wrapped so a failure degrades the trace to dead, never the request.
    """

    __slots__ = (
        "id", "kind", "key", "member", "sampled", "t0", "hops", "server",
        "dead", "outcome", "ms", "_hs", "_lock",
    )

    def __init__(self, tid: str, kind: str, key: str, member: str,
                 sampled: bool, t0: float):
        self.id = tid
        self.kind = kind          # "read" | "write"
        self.key = key
        self.member = member
        self.sampled = sampled
        self.t0 = t0              # client monotonic at mint
        self.hops: List[Dict[str, Any]] = []
        self.server: List[Dict[str, Any]] = []
        self.dead = False         # degraded: stop recording, stay silent
        self.outcome = ""
        self.ms = 0.0
        self._hs = 0
        self._lock = threading.Lock()

    def hop(self, kind: str, t0: float, t1: Optional[float] = None,
            **fields: Any) -> None:
        """Record one typed client hop [t0, t1] (point events pass only
        t0). Guarded by the ``rtrace.record`` fault point: an injected
        drop/raise degrades THIS trace to untraced and returns."""
        if self.dead:
            return
        try:
            if faults.ACTIVE and faults.fire("rtrace.record") != "ok":
                raise OSError("injected rtrace drop")
            h = {"k": kind, "t0": round(t0, 6),
                 "t1": round(t1 if t1 is not None else t0, 6), **fields}
            with self._lock:
                h["hs"] = self._hs
                self._hs += 1
                self.hops.append(h)
        except Exception:  # noqa: BLE001 — degrade, never fail the request
            self.dead = True
            p = _PLANE
            if p is not None:
                p.bump("degraded")

    def wire(self) -> Optional[Dict[str, Any]]:
        """The context embedded in the request doc — only head-sampled
        traces ask the servers to do work, so the fleet-side cost scales
        with the sample rate, not the request rate."""
        if self.dead or not self.sampled:
            return None
        with self._lock:
            return {"id": self.id, "hs": self._hs}

    def absorb_echo(self, echo: Dict[str, Any], t_send: float,
                    t_recv: float) -> None:
        """Attach one server echo, and feed the (send, server-mid,
        recv) triple to the ClockSync — every traced response doubles
        as an NTP exchange."""
        if self.dead or not isinstance(echo, dict):
            return
        try:
            e = dict(echo)
            e["t_send"] = round(t_send, 6)
            e["t_recv"] = round(t_recv, 6)
            with self._lock:
                self.server.append(e)
            p = _PLANE
            peer = e.get("peer")
            m_in, m_out = e.get("m_in"), e.get("m_out")
            if p is not None and peer and m_in is not None \
                    and m_out is not None:
                p.clock.note(str(peer), t_send,
                             (float(m_in) + float(m_out)) / 2.0, t_recv)
        except Exception:  # noqa: BLE001
            self.dead = True

    def doc(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "id": self.id, "kind": self.kind, "key": self.key,
                "member": self.member, "outcome": self.outcome,
                "sampled": self.sampled, "t0": round(self.t0, 6),
                "ms": round(self.ms, 3), "hops": list(self.hops),
                "server": list(self.server),
            }


class _Plane:
    """Per-process trace store: mint counter, rings, offsets, counters."""

    def __init__(self, member: str, sample: float = 1.0,
                 ring: int = DEFAULT_RING, slow: int = DEFAULT_SLOW,
                 metrics: Any = None):
        self.member = member
        self.sample = max(0.0, min(1.0, float(sample)))
        self.ring: collections.deque = collections.deque(maxlen=ring)
        self.slow_cap = int(slow)
        self.slow: List[Tuple[float, int, Dict[str, Any]]] = []  # min-heap
        self.clock = ClockSync()
        self.metrics = metrics
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.exemplars: Dict[str, Tuple[str, float]] = {}
        self._n = 0
        self._tb = 0  # slow-heap tiebreak (heapq must never compare docs)
        self._lock = threading.Lock()
        self._pid = os.getpid()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n
        if self.metrics is not None:
            try:
                self.metrics.count(f"rtrace.{name}", n)
            except Exception:  # noqa: BLE001
                pass

    def mint(self, kind: str, key: str, t0: float) -> Trace:
        with self._lock:
            self._n += 1
            tid = f"{self.member}-{self._pid:x}-{self._n:x}"
            # Deterministic head sampling: a pure function of the trace
            # id, so a request is sampled identically no matter who asks.
            sampled = (
                zlib.crc32(tid.encode()) % 1000000
            ) / 1e6 < self.sample
            self.counters["minted"] += 1
            if sampled:
                self.counters["sampled"] += 1
        m = self.metrics
        if m is not None:
            try:
                m.count("rtrace.minted")
                if sampled:
                    m.count("rtrace.sampled")
            except Exception:  # noqa: BLE001
                pass
        return Trace(tid, kind, key, self.member, sampled, t0)

    def commit(self, tr: Trace, outcome: str, ms: float) -> bool:
        """Store a finished trace. Sampled traces and forced outcomes
        always commit; unsampled completions survive only through the
        slow ring (the tail is the point)."""
        if tr.dead:
            return False
        tr.outcome = outcome
        tr.ms = float(ms)
        forced = outcome in FORCED_OUTCOMES
        slow_kept = False
        with self._lock:
            floor = self.slow[0][0] if len(self.slow) >= self.slow_cap \
                else -1.0
            if not (tr.sampled or forced) and tr.ms <= floor:
                self.counters["skipped"] += 1
                return False
        d = tr.doc()
        with self._lock:
            if tr.sampled or forced:
                self.ring.append(d)
            if tr.ms > floor:
                heapq.heappush(self.slow, (tr.ms, self._tb, d))
                self._tb += 1
                while len(self.slow) > self.slow_cap:
                    heapq.heappop(self.slow)
                slow_kept = True
            fam = f"{'router.read' if tr.kind == 'read' else 'router.write'}"
            cur = self.exemplars.get(fam)
            if outcome == "ok" and (cur is None or tr.ms >= cur[1]):
                self.exemplars[fam] = (tr.id, tr.ms)
            self.counters["committed"] += 1
            if forced:
                self.counters["forced"] += 1
            if slow_kept:
                self.counters["slow_kept"] += 1
        m = self.metrics
        if m is not None:
            try:
                m.count("rtrace.committed")
                if forced:
                    m.count("rtrace.forced")
                if slow_kept:
                    m.count("rtrace.slow_kept")
            except Exception:  # noqa: BLE001
                pass
        try:
            # NB: `kind` is the event-kind positional — the trace's own
            # read/write kind rides inside the stored doc.
            obs_events.emit("rtrace.trace", id=tr.id, outcome=outcome,
                            ms=round(tr.ms, 3), trace=d)
        except Exception:  # noqa: BLE001
            pass
        return True


# -- module surface (the one the routers/planes use) --------------------------


def install(member: str, sample: float = 1.0, ring: int = DEFAULT_RING,
            slow: int = DEFAULT_SLOW, metrics: Any = None,
            env: Optional[Dict[str, str]] = None) -> Optional[_Plane]:
    """Arm the plane for this process. Returns None (and disarms) when
    the ``CCRDT_RTRACE=0`` kill switch is set."""
    global ACTIVE, _PLANE
    if _killed(env):
        ACTIVE, _PLANE = False, None
        return None
    _PLANE = _Plane(member, sample=sample, ring=ring, slow=slow,
                    metrics=metrics)
    ACTIVE = True
    return _PLANE


def install_from_env(member: str, env: Optional[Dict[str, str]] = None,
                     metrics: Any = None) -> bool:
    """Arm iff ``CCRDT_RTRACE`` is set truthy (same supervisor->worker
    propagation pattern as CCRDT_FAULTS / CCRDT_SPANS); ``=0`` disarms
    even over an explicit install."""
    e = env if env is not None else os.environ
    v = e.get(ENV, "")
    if not v or v == "0":
        uninstall()
        return False
    sample = 1.0
    try:
        sample = float(e.get(ENV_SAMPLE, "1") or 1.0)
    except ValueError:
        pass
    return install(member, sample=sample, metrics=metrics, env=env) \
        is not None


def installed() -> bool:
    return ACTIVE and _PLANE is not None


def uninstall() -> None:
    global ACTIVE, _PLANE
    ACTIVE, _PLANE = False, None


def begin(kind: str, key: str = "", t0: float = 0.0) -> Optional[Trace]:
    """Mint a trace for one client request (None when the plane is
    dark — call sites treat a None trace as 'record nothing')."""
    p = _PLANE
    if not ACTIVE or p is None:
        return None
    try:
        return p.mint(kind, key, t0)
    except Exception:  # noqa: BLE001
        return None


def commit(tr: Optional[Trace], outcome: str, ms: float) -> bool:
    p = _PLANE
    if tr is None or p is None:
        return False
    try:
        return p.commit(tr, outcome, ms)
    except Exception:  # noqa: BLE001
        return False


def counters() -> Dict[str, int]:
    p = _PLANE
    return dict(p.counters) if p is not None else {}


def exemplars() -> Dict[str, Tuple[str, float]]:
    """{metric family: (trace_id, ms)} — the stored trace behind each
    family's worst observed latency, for OpenMetrics exemplar lines."""
    p = _PLANE
    if p is None:
        return {}
    with p._lock:
        return dict(p.exemplars)


def traces(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    p = _PLANE
    if p is None:
        return []
    with p._lock:
        out = list(p.ring)
    if kind is not None:
        out = [t for t in out if t.get("kind") == kind]
    return out


def slowest(n: int = 10) -> List[Dict[str, Any]]:
    p = _PLANE
    if p is None:
        return []
    with p._lock:
        ranked = sorted(p.slow, key=lambda e: -e[0])
    return [doc for _ms, _tb, doc in ranked[:n]]


def find(tid: str) -> Optional[Dict[str, Any]]:
    for d in traces():
        if d.get("id") == tid:
            return d
    for d in slowest(DEFAULT_SLOW):
        if d.get("id") == tid:
            return d
    return None


def offsets() -> Dict[str, Tuple[float, float]]:
    p = _PLANE
    return p.clock.snapshot() if p is not None else {}


def health_fields() -> Dict[str, Any]:
    p = _PLANE
    if p is None:
        return {}
    with p._lock:
        c = dict(p.counters)
        n_slow = len(p.slow)
    return {
        "rtrace_minted": int(c.get("minted", 0)),
        "rtrace_committed": int(c.get("committed", 0)),
        "rtrace_degraded": int(c.get("degraded", 0)),
        "rtrace_slow_ring": n_slow,
    }


# -- server side --------------------------------------------------------------


def server_trace(doc: Any) -> Optional[Dict[str, Any]]:
    """The trace context carried by a parsed request doc, or None.
    Stateless on purpose: a worker echoes hop timings for any traced
    request whether or not its own plane is armed — the CLIENT decided
    to pay for this trace. Honors the kill switch."""
    if _killed():
        return None
    t = doc.get("trace") if isinstance(doc, dict) else None
    if isinstance(t, dict) and isinstance(t.get("id"), str):
        return t
    return None


def server_echo(ctx: Dict[str, Any], member: str,
                marks: Dict[str, float], **extra: Any) -> Dict[str, Any]:
    """Build the response-borne echo: the request's trace id, this
    worker's identity, and the stage marks on ITS monotonic clock (the
    client's ClockSync maps them onto the client axis).

    The echo is the ONLY artifact — the client folds it into the trace
    doc and the ``rtrace.trace`` commit event carries it to disk, so
    the serve/ingest hot path pays no per-request flight-recorder
    write of its own."""
    e: Dict[str, Any] = {"id": ctx.get("id"), "peer": member}
    for k, v in marks.items():
        if v is not None:
            e[k] = round(float(v), 6)
    e.update(extra)
    return e


# -- merge / attribution engine ----------------------------------------------


def _shift_for(peer: str, offs: Dict[str, Any]) -> Optional[float]:
    o = offs.get(peer)
    if o is None:
        return None
    # ClockSync stores (offset, rtt); stored trace docs keep plain floats.
    return float(o[0]) if isinstance(o, (tuple, list)) else float(o)


def _winner_echo(tr: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The echo of the attempt that produced the answer: the last echo
    whose peer matches the winning attempt hop (dedup'd write retries
    echo more than once; the last delivery is the one that returned)."""
    win = None
    for h in tr.get("hops", ()):
        if h.get("k") == "attempt" and h.get("ok"):
            win = h
    if win is None:
        return None
    for e in reversed(tr.get("server", ())):
        if e.get("peer") == win.get("peer"):
            return e
    return None


def attribute(tr: Dict[str, Any],
              offs: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
    """Decompose one stored trace into the seven buckets (ms).

    By construction route+backoff+wire+queue_wait+kernel+ack_probe sums
    to the client-observed total minus clock-mapping clips;
    hedge_overlap is duplicated parallel time reported alongside."""
    total = float(tr.get("ms", 0.0))
    out = {b: 0.0 for b in BUCKETS}
    out["total"] = total
    out["kernel_compile"] = 0.0  # sub-annotation of kernel, not a bucket
    hops = tr.get("hops", ())
    atts: List[Tuple[float, float]] = []
    for h in hops:
        d = max(0.0, (float(h.get("t1", 0)) - float(h.get("t0", 0))) * 1e3)
        k = h.get("k")
        if k == "route":
            out["route"] += d
        elif k == "backoff":
            out["backoff"] += d
        elif k == "ack_probe":
            out["ack_probe"] += d
        elif k == "attempt":
            atts.append((float(h["t0"]), float(h["t1"])))
    union_ms = _union(atts) * 1e3
    out["hedge_overlap"] = max(
        0.0, sum((b - a) for a, b in atts) * 1e3 - union_ms
    )
    e = _winner_echo(tr)
    server_ms = 0.0
    if e is not None:
        qw = kn = ap = 0.0
        if "m_drain" in e and "m_q" in e:       # read echo
            qw = max(0.0, (float(e["m_drain"]) - float(e["m_q"])) * 1e3)
            kn = float(e.get("kernel_ms", 0.0))
        elif "m_fold" in e and "m_stage" in e:  # write echo
            qw = max(0.0, (float(e["m_fold"]) - float(e["m_stage"])) * 1e3)
            kn = float(e.get("kernel_ms", 0.0))
            ap = max(0.0, float(e.get("durable_wait_ms", 0.0)))
        # The server can only explain time inside the attempt that
        # carried it — clip so a skewed echo never exceeds the wire gap.
        att_ms = max(
            0.0,
            (float(e.get("t_recv", 0)) - float(e.get("t_send", 0))) * 1e3,
        )
        qw = min(qw, att_ms)
        kn = min(kn, max(0.0, att_ms - qw))
        ap = min(ap, max(0.0, att_ms - qw - kn))
        out["queue_wait"], out["kernel"] = qw, kn
        # Attribution honesty: when the device observatory
        # saw compiles inside this hop's window, the echo carries their
        # total as `compile_ms` and the kernel bucket gets a
        # sub-annotation splitting compile-storm latency from genuine
        # kernel time. Clipped to the kernel bucket — compile time IS
        # kernel-bucket time, just dishonestly labeled before this.
        cms = max(0.0, float(e.get("compile_ms", 0.0)))
        out["kernel_compile"] = min(cms, kn)
        out["ack_probe"] += ap
        server_ms = qw + kn + ap
    # Wire = time the request was genuinely in flight (the attempts'
    # union — launch to settle as the CLIENT saw it, which includes the
    # router's poll granularity) minus what the server explained. It is
    # measured, not a residual: if hops go missing, coverage DROPS and
    # the gates see it.
    out["wire"] = max(0.0, union_ms - server_ms)
    known = out["route"] + out["backoff"] + out["wire"] \
        + out["queue_wait"] + out["kernel"] + out["ack_probe"]
    out["coverage"] = known / total if total > 0 else 1.0
    return out


def complete(tr: Dict[str, Any]) -> Tuple[bool, str]:
    """Is this stored trace a gap-free waterfall? Requires a dense hop
    sequence (no evicted/err-dropped hops), a route decision, at least
    one attempt, and — for sampled completed requests — a server echo
    from the winning attempt."""
    hops = tr.get("hops", ())
    hss = sorted(int(h.get("hs", -1)) for h in hops)
    if hss != list(range(len(hops))):
        return False, "hop sequence has holes"
    kinds = [h.get("k") for h in hops]
    if "route" not in kinds:
        return False, "no route hop"
    if tr.get("outcome") == "ok":
        if "attempt" not in kinds:
            return False, "no attempt hop"
        if tr.get("sampled") and _winner_echo(tr) is None:
            return False, "winning attempt carried no server echo"
    return True, ""


def waterfall(tr: Dict[str, Any],
              offs: Optional[Dict[str, Any]] = None) -> List[Dict[str, Any]]:
    """The trace as ordered [t0_ms, t1_ms] segments relative to the
    request start, server stages mapped onto the client's clock via the
    ClockSync offsets (live plane offsets by default)."""
    offs = offs if offs is not None else offsets()
    base = float(tr.get("t0", 0.0))
    rows: List[Dict[str, Any]] = []

    def _row(name: str, a: float, b: float, **f: Any) -> None:
        rows.append(dict(
            name=name, t0_ms=round((a - base) * 1e3, 3),
            t1_ms=round((b - base) * 1e3, 3), **f,
        ))

    for h in tr.get("hops", ()):
        _row(h.get("k", "?"), float(h.get("t0", base)),
             float(h.get("t1", base)),
             **{k: v for k, v in h.items()
                if k not in ("k", "t0", "t1", "hs")})
    for e in tr.get("server", ()):
        peer = str(e.get("peer"))
        shift = _shift_for(peer, offs)
        if shift is None:
            # No offset sample yet: anchor the server window onto the
            # attempt's midpoint so the waterfall still renders.
            m_in, m_out = e.get("m_in"), e.get("m_out")
            if m_in is None or m_out is None:
                continue
            mid = (float(e.get("t_send", base))
                   + float(e.get("t_recv", base))) / 2.0
            shift = (float(m_in) + float(m_out)) / 2.0 - mid
        pairs = (("server", "m_in", "m_out"),
                 ("queue_wait", "m_q", "m_drain"),
                 ("kernel", "m_drain", "m_done"),
                 ("queue_wait", "m_stage", "m_fold"))
        for name, ka, kb in pairs:
            a, b = e.get(ka), e.get(kb)
            if a is None or b is None:
                continue
            _row(name, float(a) - shift, float(b) - shift, peer=peer)
    rows.sort(key=lambda r: (r["t0_ms"], r["t1_ms"]))
    return rows


def attribution_report(
    trs: List[Dict[str, Any]],
    offs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Fleet-level tail attribution over stored traces: per-bucket p50 /
    p99 milliseconds, coverage percentiles, and the p99 request's
    dominant bucket — the 'where did the tail go' answer."""
    rows = [attribute(t, offs) for t in trs if t.get("outcome") == "ok"]
    if not rows:
        return {"n": 0}
    totals = [r["total"] for r in rows]
    p99_total = _pctl(totals, 0.99)
    # The p99 exemplar request: the slowest at-or-under the p99 mark.
    under = [(r, t) for r, t in zip(rows, trs)
             if t.get("outcome") == "ok" and r["total"] <= p99_total + 1e-9]
    ex_row, ex_tr = max(under, key=lambda rt: rt[0]["total"])
    dom = max(BUCKETS, key=lambda b: ex_row.get(b, 0.0)
              if b != "hedge_overlap" else -1.0)
    doc: Dict[str, Any] = {
        "n": len(rows),
        "total_ms_p50": round(_pctl(totals, 0.50), 3),
        "total_ms_p99": round(p99_total, 3),
        "coverage_p50": round(_pctl([r["coverage"] for r in rows], 0.50), 4),
        "coverage_p99_req": round(ex_row["coverage"], 4),
        "p99_trace_id": ex_tr.get("id"),
        "p99_dominant_bucket": dom,
        "p99_dominant_ms": round(ex_row.get(dom, 0.0), 3),
        # The p99 trace's compile share (devprof sub-annotation of the
        # kernel bucket): how much of the tail was recompile churn.
        "p99_kernel_compile_ms": round(
            ex_row.get("kernel_compile", 0.0), 3
        ),
        "p99_compile_share": round(
            ex_row.get("kernel_compile", 0.0) / ex_row["total"], 4
        ) if ex_row["total"] > 0 else 0.0,
        "buckets_ms_p50": {
            b: round(_pctl([r[b] for r in rows], 0.50), 3) for b in BUCKETS
        },
        "buckets_ms_p99": {
            b: round(_pctl([r[b] for r in rows], 0.99), 3) for b in BUCKETS
        },
    }
    return doc


def format_report(rep: Dict[str, Any]) -> str:
    if not rep.get("n"):
        return "rtrace: no completed traces"
    lines = [
        f"rtrace attribution over {rep['n']} completed requests: "
        f"p50 {rep['total_ms_p50']:.2f}ms p99 {rep['total_ms_p99']:.2f}ms "
        f"(coverage p50 {rep['coverage_p50']:.1%})",
        f"  p99 trace {rep['p99_trace_id']}: dominant bucket "
        f"{rep['p99_dominant_bucket']} ({rep['p99_dominant_ms']:.2f}ms), "
        f"compile share {rep.get('p99_compile_share', 0.0):.1%} "
        f"({rep.get('p99_kernel_compile_ms', 0.0):.2f}ms)",
    ]
    for b in BUCKETS:
        lines.append(
            f"  {b:<13} p50 {rep['buckets_ms_p50'][b]:>9.3f}ms   "
            f"p99 {rep['buckets_ms_p99'][b]:>9.3f}ms"
        )
    return "\n".join(lines)


# -- offline readers (CLI / demos) -------------------------------------------


def scan_traces(obs_dir: str) -> List[Dict[str, Any]]:
    """All committed traces found in a spill dir's request-event
    streams (each `rtrace.trace` event carries the full trace doc)."""
    out: List[Dict[str, Any]] = []
    for evs in obs_events.scan_dir(obs_dir).values():
        for ev in evs:
            if ev.get("kind") == "rtrace.trace" \
                    and isinstance(ev.get("trace"), dict):
                out.append(ev["trace"])
    return out


def to_json(doc: Any) -> str:
    return json.dumps(doc, indent=2, sort_keys=True)
