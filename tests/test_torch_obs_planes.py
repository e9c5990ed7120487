"""The port's observability planes (``obs/{lag,export,http,rtrace,
profile,devprof}.py`` and ``core/batch_merge.py``'s dispatch hooks)
against the JAX package's.

* Every case of ``tests/test_obs_lag.py``, ``tests/test_obs_export.py``,
  ``tests/test_obs_http.py``, ``tests/test_obs_profile.py`` and
  ``tests/test_devprof.py`` runs again through the port (engines on the
  CPU inside ``host_device``). Left out of ``test_devprof.py``:
  ``test_sigkill_spills_compile_events`` (a subprocess of the JAX
  package, marked slow there) and ``test_stepping_drill_attributes_every_compile``,
  which needs a jit recompile per round: the port's compile is a
  kernel's first load, which never happens on the CPU. The attribution
  it checks is held below with a build cache that grows.
* ``tests/test_rtrace.py`` runs through the port in
  ``tests/test_torch_bridge.py`` (it imports the serve and bridge planes);
  the trace docs, wire encodings, exemplars and attribution it relies on
  are also held against JAX's below.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

# test_obs_profile.py and test_devprof.py both have a
# test_install_from_env_gating: each runs, suffixed with its file.
globals().update(port_copies(
    "test_obs_lag.py", "test_obs_export.py", "test_obs_http.py", "test_obs_profile.py",
    ("test_devprof.py", dict(skip=["test_sigkill_spills_compile_events",
                                   "test_stepping_drill_attributes_every_compile"])),
))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages side by side -------------------------------------------

import numpy as np  # noqa: E402
import torch  # noqa: E402

from antidote_ccrdt_tpu.core import batch_merge as jbm  # noqa: E402
from antidote_ccrdt_tpu.models.topk_rmv import TopkRmvScalar as JaxTopkRmvScalar  # noqa: E402
from antidote_ccrdt_tpu.obs import devprof as jdevprof  # noqa: E402
from antidote_ccrdt_tpu.obs import export as jexport  # noqa: E402
from antidote_ccrdt_tpu.obs import lag as jlag  # noqa: E402
from antidote_ccrdt_tpu.obs import profile as jprofile  # noqa: E402
from antidote_ccrdt_tpu.obs import rtrace as jrtrace  # noqa: E402
from antidote_ccrdt_tpu.obs import spans as jspans  # noqa: E402
from antidote_ccrdt_tpu.utils.metrics import Metrics as JaxMetrics  # noqa: E402
from antidote_ccrdt_tpu_torch.core import batch_merge as pbm  # noqa: E402
from antidote_ccrdt_tpu_torch.models.topk_rmv import TopkRmvScalar  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import devprof as pdevprof  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import events as pevents  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import export as pexport  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import lag as plag  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import profile as pprofile  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import rtrace as prtrace  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import spans as pspans  # noqa: E402
from antidote_ccrdt_tpu_torch.ops import _build  # noqa: E402
from antidote_ccrdt_tpu_torch.utils.metrics import Metrics  # noqa: E402


@pytest.fixture(autouse=True)
def _every_plane_dark():
    for mod in (prtrace, jrtrace, pprofile, jprofile, pdevprof, jdevprof):
        mod.uninstall()
    pdevprof.set_warmup(False)
    jdevprof.set_warmup(False)
    yield
    for mod in (prtrace, jrtrace, pprofile, jprofile, pdevprof, jdevprof):
        mod.uninstall()
    pdevprof.set_warmup(False)
    jdevprof.set_warmup(False)


def _fill(m):
    """The same counters, gauges and samples in a Metrics of either package."""
    rng = np.random.default_rng(3)
    for i in range(12):
        m.count("net.delta_publishes")
        m.count("net.delta_bytes", float(rng.integers(100, 5000)))
        m.observe("round.e2e", float(rng.random()) * 0.05)
        m.observe("wal.group_size", float(rng.integers(1, 9)))
    m.set("lag.ops.w1", 3.0)
    m.set("part.divergent", 2.0)
    return m


def _rtrace_session(rt, metrics):
    """A scripted read and write through one package's rtrace plane ->
    (trace docs, slowest, exemplars, counters, health, json)."""
    rt.install("w0", sample=1.0, metrics=metrics)
    docs = []
    for i, (kind, outcome, ms) in enumerate([("read", "ok", 4.5), ("write", "ok", 9.25),
                                             ("read", "shed", 1.0), ("read", "ok", 12.0)]):
        tr = rt.begin(kind, key=f"k{i}", t0=10.0 + i)
        tr.hop("route", 10.0 + i, 10.001 + i, cands=["w1", "w2"])
        tr.hop("attempt", 10.001 + i, 10.004 + i, peer="w1", n=1)
        ctx = rt.server_trace({"q": 1, "trace": tr.wire()})
        echo = rt.server_echo(ctx, "w1", {"m_in": 50.0 + i, "q_in": 50.0005 + i, "m_out": 50.002 + i},
                              compile_ms=0.25)
        tr.absorb_echo(echo, 10.001 + i, 10.004 + i)
        tr.hop("backoff", 10.004 + i)
        rt.commit(tr, outcome, ms)
        docs.append(tr.doc())
    out = (docs, rt.slowest(10), rt.exemplars(), rt.counters(), rt.health_fields(),
           [rt.to_json(d) for d in docs], [rt.attribute(d) for d in docs], [rt.complete(d) for d in docs],
           [rt.waterfall(d) for d in docs], rt.attribution_report(docs), rt.offsets())
    rt.uninstall()
    return out


def test_rtrace_encodings_equal_jax():
    """Trace ids, hop records, server echoes, the JSON wire encoding,
    exemplars, the attribution and waterfall of the same scripted
    requests, and the Prometheus text carrying the exemplars: equal to
    the JAX package's, byte for byte where bytes."""
    pm, jm = Metrics(), JaxMetrics()
    got, want = _rtrace_session(prtrace, pm), _rtrace_session(jrtrace, jm)
    assert got == want
    assert got[2], "no exemplar was recorded"
    assert pm.snapshot()["counters"] == jm.snapshot()["counters"]
    text_args = dict(labels={"member": "w0"}, exemplars=got[2])
    assert pexport.prometheus_text(_fill(Metrics()), **text_args) == \
        jexport.prometheus_text(_fill(JaxMetrics()), **text_args)


def test_prometheus_text_and_jsonl_are_byte_equal_to_jax():
    p, j = _fill(Metrics()), _fill(JaxMetrics())
    assert pexport.prometheus_text(p, labels={"member": "m0"}) == jexport.prometheus_text(j, labels={"member": "m0"})
    assert list(pexport.jsonl_lines(p)) == list(jexport.jsonl_lines(j))


def test_lag_tracker_reports_and_gauges_equal_jax():
    def drive(mod, metrics):
        t = {"now": 0.0}
        lt = mod.LagTracker("me", clock=lambda: t["now"])
        for i in range(20):
            t["now"] = 0.5 * i
            lt.observe_published("b", i)
            if i % 3 == 0:
                lt.observe_applied("b", i - 2)
            lt.observe_published("c", 2 * i)
        lt.drop("c")
        lt.export_to(metrics)
        blobs = [bytes([i]) * (i + 1) for i in range(5)]
        # Staleness reads the host's monotonic clock, not the injected one.
        report = {p: {k: v for k, v in r.items() if k != "staleness_s"} for p, r in lt.report().items()}
        gauges = {k: v for k, v in metrics.snapshot()["counters"].items() if "staleness" not in k}
        return (report, [lt.lag(p) for p in ("b", "c")], gauges,
                [mod.payload_digest(b) for b in blobs],
                mod.digest_agreement({"a": blobs[0], "b": blobs[0], "c": blobs[1]}))

    assert drive(plag, Metrics()) == drive(jlag, JaxMetrics())


def _grow_states(sc, n_states, rounds):
    """topk_rmv scalar states that gain one live add per id a round."""
    states = [sc.new(13) for _ in range(n_states)]
    out = []
    for r in range(rounds):
        for wi in range(n_states):
            states[wi], _ = sc.update(("add", (1, 100 + 7 * r + wi, (f"dc{wi}", r * n_states + wi + 1))), states[wi])
        out.append(list(states))
    return out


def test_batch_merge_dispatch_hooks_match_jax():
    """`batch_merge`'s fold levels are ``batch_merge.fold`` dispatches
    with a ``round.device_dispatch`` span each, as in JAX: the same
    sites, the same counts, the same h2d bytes; `merge_into` and
    `snapshot_state` are their own sites."""
    def drive(bm, sc, prof, spans_mod, metrics):
        with spans_mod.installed("w0"), prof.installed(metrics):
            for states in _grow_states(sc, 5, 3):
                bm.batch_merge("topk_rmv", states)
            names = [(s["name"], s.get("site"), s.get("n")) for s in spans_mod.drain()
                     if s.get("name") == "round.device_dispatch"]
        snap = metrics.snapshot()
        lat, c = snap["latencies"], snap["counters"]
        # Every dispatch is classified (a jit compile or hit in JAX, a
        # kernel load or none in the port); the split itself differs.
        assert c.get("profile.jit_hits", 0) + c.get("profile.jit_misses", 0) == len(
            lat["profile.dispatch.batch_merge.fold"])
        return names, {k: len(v) for k, v in lat.items() if k.startswith("profile.dispatch.")}, c["profile.h2d_bytes"]

    got = drive(pbm, TopkRmvScalar(), pprofile, pspans, Metrics())
    want = drive(jbm, JaxTopkRmvScalar(), jprofile, jspans, JaxMetrics())
    assert got == want
    assert got[1]["profile.dispatch.batch_merge.fold"] == 9  # 5 -> 3 -> 2 -> 1, three calls

    m = Metrics()
    a = pbm.fold_states(lambda x, y: torch.maximum(x, y), [torch.arange(4)] * 3)
    with pspans.installed("w0"), pprofile.installed(m):
        assert torch.equal(pbm.merge_into(torch.maximum, torch.zeros(4, dtype=torch.int64), a), a)
        assert torch.equal(pbm.snapshot_state(a), a)
        sites = [s.get("site") for s in pspans.drain() if s.get("name") == "round.device_dispatch"]
    assert sites == ["batch_merge.into", "batch_merge.snapshot"]
    assert {"profile.dispatch.batch_merge.into", "profile.dispatch.batch_merge.snapshot"} <= set(m.snapshot()["latencies"])


def test_warmup_padding_keeps_jax_results():
    """With the warm-up armed, topk_rmv capacities pad to powers of two
    in both packages and every merged state is unchanged."""
    rounds = _grow_states(TopkRmvScalar(), 3, 5)
    jrounds = _grow_states(JaxTopkRmvScalar(), 3, 5)
    plain = [pbm.batch_merge("topk_rmv", s) for s in rounds]
    pdevprof.set_warmup(True)
    jdevprof.set_warmup(True)
    padded = [pbm.batch_merge("topk_rmv", s) for s in rounds]
    want = [jbm.batch_merge("topk_rmv", s) for s in jrounds]
    assert [repr(s) for s in padded] == [repr(s) for s in plain] == [repr(s) for s in want]


def test_signatures_name_leaves_and_dtypes_as_jax():
    """A port state's devprof signature has JAX's leaf names, shapes and
    dtype names; the device takes the place of the sharding."""
    from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr
    from antidote_ccrdt_tpu_torch import registry

    pd = registry.make_dense("topk_rmv", n_ids=8, n_dcs=2, size=4, slots_per_id=2, device="cpu")
    jd = jtkr.make_dense(n_ids=8, n_dcs=2, size=4, slots_per_id=2)
    got = pdevprof.signature((pd.init(3, 1), np.int32(7)), donation="donate_rhs")
    want = jdevprof.signature((jd.init(3, 1), np.int32(7)), donation="donate_rhs")
    assert [leaf[:3] for leaf in got["leaves"]] == [leaf[:3] for leaf in want["leaves"]]
    assert {leaf[3] for leaf in got["leaves"][:-1]} == {"cpu"} and got["donation"] == "donate_rhs"
    assert pdevprof._leaf_nbytes((pd.init(3, 1),)) == jdevprof._leaf_nbytes((jd.init(3, 1),))


def test_kernel_loads_are_attributed_as_compiles(monkeypatch):
    """The port's compile is a kernel's first load (``ops._build``): a
    fold level whose merge loaded a kernel is a compile, attributed to
    its site with the axis that changed since the site's last compile;
    one that loaded none is an execute. (On the CPU nothing loads, so
    here each merge of a new shape stands for a kernel's first load.)"""
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvDense

    loaded = set()
    real_merge = TopkRmvDense.merge

    def merge(self, a, b):
        loaded.add(tuple(a.slot_ts.shape))
        return real_merge(self, a, b)

    monkeypatch.setattr(_build, "loaded", lambda: len(loaded))
    monkeypatch.setattr(TopkRmvDense, "merge", merge)
    m = Metrics()
    pevents.reset("devprof-port")
    with pdevprof.installed(m):
        for states in _grow_states(TopkRmvScalar(), 3, 4):  # M = 3, 6, 9, 12
            pbm.batch_merge("topk_rmv", states)
        sites = pdevprof.sites_report()
    evs = [e for e in pevents.events() if e["kind"] == "devprof.compile"]
    assert [e["axis"] for e in evs] == ["first_trace"] + [
        f"arg0.slot_score axis3 {k}->{k + 3}" for k in (3, 6, 9)]
    assert all(e["site"] == "batch_merge.fold" and e["signature"] for e in evs)
    assert m.snapshot()["counters"]["devprof.compiles"] == 4 == sites["batch_merge.fold"]["compiles"]
    assert sites["batch_merge.fold"]["dispatches"] == 4 * 2  # 3 -> 2 -> 1
