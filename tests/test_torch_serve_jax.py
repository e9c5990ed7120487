"""The port's serve and audit planes against the JAX package's on the same
seeded inputs, byte for byte.

* ``serve.kernels.materialize`` gives the same view, and
  ``ServePlane.handle`` the same answer bytes (a frozen monotonic clock,
  so staleness bounds agree), for topk_rmv, topk, leaderboard and the
  lifted average and wordcount engines.
* ``IngestPlane`` acks and flight events are equal write for write (the
  wall clock of the event recorders frozen).
* ``certify``, ``certify_sessions`` and ``certify_writes`` certificates
  are byte-equal, and each package verifies the other's.
* A JAX ``FleetRouter`` querying port workers over ``TcpTransport`` gets
  the answers it gets from JAX workers, and the reverse.
"""

import json
import threading
import time
import types

import numpy as np
import pytest

import jax.numpy as jnp

from antidote_ccrdt_tpu import serve as jserve
from antidote_ccrdt_tpu.models import topk as jtopk
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu.net import tcp as jtcp
from antidote_ccrdt_tpu.obs import audit as jaudit
from antidote_ccrdt_tpu.obs import events as jevents
from antidote_ccrdt_tpu.parallel import monoid as jmon
from antidote_ccrdt_tpu.serve import kernels as jkernels
from antidote_ccrdt_tpu_torch import registry, serve as pserve
from antidote_ccrdt_tpu_torch.models import topk as ptopk
from antidote_ccrdt_tpu_torch.models import wordcount as pwc
from antidote_ccrdt_tpu_torch.net import tcp as ptcp
from antidote_ccrdt_tpu_torch.obs import audit as paudit
from antidote_ccrdt_tpu_torch.obs import events as pevents
from antidote_ccrdt_tpu_torch.parallel import monoid as pmon
from antidote_ccrdt_tpu_torch.serve import kernels as pkernels
from torch_twins import NEG_INF, leaderboard_pair, lifted_pair, t, topk_rmv_pair

PKGS = {"jax": (jserve, jaudit, jevents, jtcp), "torch": (pserve, paudit, pevents, ptcp)}
WALL = 1_700_000_000.0


def _frozen_wall(monkeypatch):
    """Both packages' flight recorders and certificates read one frozen
    wall clock (``time.time``); everything else of ``time`` is real."""
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    fake.time = lambda: WALL
    for mod in (jevents, pevents, jaudit, paudit):
        monkeypatch.setattr(mod, "time", fake)


def _topk_pair(seed, R=3, NK=2, I=40, K=5):
    rng = np.random.default_rng(seed)
    best = rng.integers(-50, 500, (R, NK, I)).astype(np.int32)
    best[rng.random((R, NK, I)) < 0.5] = NEG_INF
    return ((jtopk.make_dense(I, K), jtopk.TopkDenseState(jnp.asarray(best))),
            (ptopk.make_dense(I, K, device="cpu"), ptopk.TopkDenseState(t(best))))


def _lifted_wordcount_pair(seed, R=4, NK=2, V=8, steps=3):
    """MonoidLift(wordcount) in both packages; step k writes row k % R."""
    jl, pl = jmon.MonoidLift(jwc.WordcountDense(V)), pmon.MonoidLift(
        registry.make_dense("wordcount", n_buckets=V, device="cpu"))
    js, ps = jl.init(R, NK), pl.init(R, NK)
    rng = np.random.default_rng(seed)
    for k in range(steps):
        key = rng.integers(0, NK, (R, 6)).astype(np.int32)
        tok = rng.integers(-1, V, (R, 6)).astype(np.int32)
        tok[np.arange(R) != k % R] = -1
        js = jl.apply_ops(js, jwc.WordcountOps(key=jnp.asarray(key), token=jnp.asarray(tok)), owned=[k % R])[0]
        ps = pl.apply_ops(ps, pwc.WordcountOps(key=t(key), token=t(tok)), owned=[k % R])[0]
    return (jl, js), (pl, ps)


def _engines(name):
    if name == "topk_rmv":
        (jd, js), (pd, ps) = topk_rmv_pair(11, R=3, I=24, D=3, M=2, K=6)
        return (jd, js[-1]), (pd, ps[-1])
    if name == "topk":
        return _topk_pair(12)
    if name == "leaderboard":
        return leaderboard_pair(13)
    if name == "average_lifted":
        (jl, js), (pl, ps) = lifted_pair(14)
        return (jl, js[-1]), (pl, ps[-1])
    return _lifted_wordcount_pair(15)


def _requests(n_keys):
    """Query frames over every key and op, with the malformed, the
    out-of-range and the session-uncovered cases."""
    qs = []
    for key in range(n_keys):
        qs += [{"op": "value", "key": key}, {"op": "topk", "key": key, "k": 3},
               {"op": "range", "key": key, "lo": 2, "hi": 300}, {"op": "topk", "key": key}]
    frames = [jserve.request_bytes(qs), jserve.request_bytes(qs[:3], max_staleness_s=5.0),
              jserve.request_bytes([{"op": "value", "key": n_keys}, {"op": "nope", "key": 0}]),
              jserve.request_bytes([{"op": "value", "key": 0}], session={"w0": 99}),
              jserve.request_bytes([{"op": "value", "key": 0}], session={"w0": 1})]
    assert frames == [pserve.request_bytes(qs), pserve.request_bytes(qs[:3], max_staleness_s=5.0),
                      pserve.request_bytes([{"op": "value", "key": n_keys}, {"op": "nope", "key": 0}]),
                      pserve.request_bytes([{"op": "value", "key": 0}], session={"w0": 99}),
                      pserve.request_bytes([{"op": "value", "key": 0}], session={"w0": 1})]
    frames += [b"not json", b'{"queries": 3}']
    return frames


@pytest.mark.parametrize("name", ["topk_rmv", "topk", "leaderboard", "average_lifted", "wordcount_lifted"])
def test_views_and_answer_bytes_equal_jax(name):
    (jd, js), (pd, ps) = _engines(name)
    jv, pv = jkernels.materialize(jd, js), pkernels.materialize(pd, ps)
    assert (pv.mode, pv.n_keys) == (jv.mode, jv.n_keys)
    if jv.mode == "table":
        assert pv.table == [[tuple(map(int, p)) for p in row] for row in jv.table]
    else:
        assert pv.arr.dtype == jv.arr.dtype and np.array_equal(pv.arr, jv.arr)
    planes = {}
    for pkg, (serve, *_), dense, state in (("jax", PKGS["jax"], jd, js), ("torch", PKGS["torch"], pd, ps)):
        plane = serve.ServePlane(dense, member="w0", mono=lambda: 50.0)
        plane.swap(state, 1)
        planes[pkg] = plane
    for raw in _requests(jv.n_keys) * 2:  # the second pass answers from the cache
        got, want = planes["torch"].handle(raw), planes["jax"].handle(raw)
        assert got == want, raw
    assert planes["torch"].metrics.snapshot()["counters"] == planes["jax"].metrics.snapshot()["counters"]


class _StepClock:
    """A monotonic clock that only its own `sleep` and the caller's
    `advance` move: deadlines and the durable wait of an `IngestPlane`
    run on it, however slowly the threads are scheduled."""

    def __init__(self):
        self.t = 0.0
        self._lock = threading.Lock()

    def mono(self):
        with self._lock:
            return self.t

    def sleep(self, dt):
        self.advance(dt)

    def advance(self, dt):
        with self._lock:
            self.t += dt


def _ingest_run(pkg):
    """Seeded writes into one IngestPlane, each drained at a known seq by
    this thread once the writer thread has parked it: the ack bytes and
    the plane's flight events. The plane's deadlines run on a `_StepClock`
    (write 4's durable wait downgrades when its fake sleeps pass the
    deadline), and `ack_timeout_s` is long enough that a writer parked
    on the real clock outwaits any stall of this thread."""
    serve, _audit, events, _tcp = PKGS[pkg]
    events.reset("ing")
    durable = {"seq": 2}
    clock = _StepClock()
    plane = serve.IngestPlane("w0", durable_fn=lambda: durable["seq"], watermarks_fn=lambda: {"w0": 7, "w1": 3},
                               ack_timeout_s=60.0, poll_s=0.01, mono=clock.mono, sleep=clock.sleep)
    rng = np.random.default_rng(5)
    docs = []
    for i in range(6):
        ops = [["add", [int(rng.integers(0, 40)), int(rng.integers(1, 900)), [i % 3, 1_000_000 + 4 * i + j]]]
               for j in range(3)]
        docs.append(serve.encode({"write_id": f"c:{i}", "ops": ops,
                                  "ack": ("applied", "durable", "durable")[i % 3]}))
    acks, folded = [], []
    for i, raw in enumerate(docs):
        out = []
        th = threading.Thread(target=lambda r=raw: out.append(plane.handle(r)))
        th.start()
        deadline = time.monotonic() + 60.0
        while plane.depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        clock.advance(0.001)
        durable["seq"] = 0 if i == 4 else 10 + i  # write 4's durable ack downgrades
        assert plane.drain(10 + i, folded.extend) == 1
        th.join(60.0)
        acks.append(out[0])
    acks.append(plane.handle(docs[1]))  # a duplicate re-acks
    acks.append(plane.handle(b'{"write_id": "bad"}'))
    acks.append(plane.handle(serve.encode({"probe": {"w0": 3}})))
    return acks, folded, [dict(e) for e in events.events()], plane.metrics.snapshot()["counters"]


def test_ingest_acks_and_events_equal_jax(monkeypatch):
    _frozen_wall(monkeypatch)
    try:
        got, want = _ingest_run("torch"), _ingest_run("jax")
    finally:
        pevents.reset("?")
        jevents.reset("?")
    assert got[0] == want[0]
    assert json.loads(got[0][1])["write_ack"] and json.loads(got[0][-3])["duplicate"]
    assert got[1] == want[1] and len(got[1]) == 18
    assert got[2] == want[2] and {e["kind"] for e in got[2]} >= {"ingest.fold", "ingest.write"}
    assert got[3] == want[3]


def _write_logs():
    """A fleet's spill: acks told to a client, the origin's durability
    watermark and a survivor's delta cursor, with one acked-but-lost
    write for the negative certificate."""
    acks = [{"kind": "ingest.ack", "member": "c0", "peer": "w0", "origin": "w0", "wseq": s, "level": lvl,
             "write_id": f"c:{s}", "requested": lvl, "seq": s} for s, lvl in ((1, "durable"), (2, "applied"),
                                                                             (3, "replicated_to_k"))]
    ok = {"client": acks, "flight-w0-1.jsonl": [{"kind": "wal.durable", "member": "w0", "through": 3}]}
    bad = {"client": acks + [dict(acks[0], wseq=9, write_id="c:9", seq=9)],
           "flight-w0-1.jsonl": [{"kind": "wal.durable", "member": "w0", "through": 3}]}
    return ok, bad


def _session_logs():
    ev = [{"kind": "session.write", "seq": 0, "session": "s1", "origin": "w0", "wseq": 4},
          {"kind": "session.read", "seq": 1, "session": "s1", "peer": "w1", "served": {"w0": 5},
           "rw": True, "mono": True},
          {"kind": "session.read", "seq": 2, "session": "s1", "peer": "w2", "served": {"w0": 3},
           "rw": True, "mono": True}]
    return {"client": ev[:2]}, {"client": ev}


def test_certificates_byte_equal_and_cross_verified(monkeypatch):
    _frozen_wall(monkeypatch)
    run_logs = {"flight-a-1.jsonl": [{"kind": "delta.publish", "member": "a", "origin": "a", "dseq": 1, "seq": 0},
                                     {"kind": "delta.apply", "member": "a", "origin": "b", "dseq": 1, "seq": 1}],
                "flight-b-1.jsonl": [{"kind": "delta.publish", "member": "b", "origin": "b", "dseq": 1, "seq": 0},
                                     {"kind": "delta.apply", "member": "b", "origin": "a", "dseq": 1, "seq": 1}]}
    wok, wbad = _write_logs()
    sok, sbad = _session_logs()
    calls = [
        ("certify", dict(logs=run_logs, digests={"a": [7, 8], "b": [7, 8]}, reference=[7, 8], meta={"d": 1})),
        ("certify", dict(logs=run_logs, digests={"a": [7, 8], "b": [7, 9]}, meta={"d": 2})),
        ("certify_writes", dict(logs=wok, meta={"arm": "honest"})),
        ("certify_writes", dict(logs=wbad, meta={"arm": "lost"})),
        ("certify_sessions", dict(logs=sok, meta={"arm": "ryw"})),
        ("certify_sessions", dict(logs=sbad, meta={"arm": "monotonic"})),
    ]
    oks = []
    for fn, kw in calls:
        got, want = getattr(paudit, fn)(**kw), getattr(jaudit, fn)(**kw)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), fn
        assert got["signature"] == want["signature"]
        assert paudit.verify_certificate(want) and jaudit.verify_certificate(got)
        tampered = dict(got, ok=not got["ok"])
        assert not paudit.verify_certificate(tampered) and not jaudit.verify_certificate(tampered)
        oks.append(got["ok"])
    assert oks == [True, False, True, False, True, False]


def _workers(pkg, dense, state):
    serve, _audit, _events, tcp = PKGS[pkg]
    out = {}
    for m in ("w0", "w1"):
        tr = tcp.TcpTransport(m)
        plane = serve.ServePlane(dense, member=m, mono=lambda: 10.0)
        plane.swap(state, 3)
        tr.install_serve(plane)
        out[m] = tr
    return out


def test_routers_of_either_package_get_equal_answers_from_either_fleet():
    (jd, js), (pd, ps) = topk_rmv_pair(21, R=3, I=24, D=3, M=2, K=6)
    fleets = {"jax": _workers("jax", jd, js[-1]), "torch": _workers("torch", pd, ps[-1])}
    qs = [{"op": "value", "key": 0}, {"op": "topk", "key": 0, "k": 2}, {"op": "range", "key": 0, "lo": 1, "hi": 200}]
    try:
        answers = {}
        for rpkg in ("jax", "torch"):
            serve = PKGS[rpkg][0]
            for fpkg, fleet in fleets.items():
                addrs = {m: tr.address for m, tr in fleet.items()}
                router = serve.FleetRouter(sorted(addrs), serve.tcp_query_fn(addrs), hedge=False, seed=1)
                docs = [router.query(qs, key=f"k{i}", max_staleness_s=60.0) for i in range(4)]
                answers[rpkg, fpkg] = json.dumps(docs, sort_keys=True).encode()
                assert router.metrics.snapshot()["counters"].get("router.failovers", 0) == 0
        assert len(set(answers.values())) == 1
        doc = json.loads(answers["jax", "torch"])[0]
        assert "error" not in doc and doc["results"][0]["as_of_seq"] == 3
    finally:
        for fleet in fleets.values():
            for tr in fleet.values():
                tr.close()
