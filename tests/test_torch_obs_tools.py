"""The port's operator tools (``antidote_ccrdt_tpu_torch/scripts/``:
``ccrdt_{trace,spans,rtrace,devprof,audit}``, ``obs_dashboard``,
``spans_demo``, ``overlap_demo``) against the JAX package's scripts.

* Every case of ``tests/test_trace_cli.py`` runs again with the port's
  ``ccrdt_trace`` in place of ``scripts/ccrdt_trace.py``.
* One differential case a subcommand: the JAX CLI and the port's on one
  spill made from a numpy seed (flight logs with delta paths, devprof
  compiles and request traces, span spills with clock offsets, status
  drops, DEVPROF carriers, final digests) give the same stdout, stderr,
  exit code and output files, byte for byte (the Perfetto trace and the
  signed certificate included; the certificate's clock frozen).
* The port folds an ``elastic_demo`` observable digest to its crc32, where
  JAX's CLI stops; every script answers ``--help`` where ``import jax``
  raises; the demos and ``laws`` without a device name the missing card
  (the anti-entropy demos ``partition_demo`` and ``topo_demo`` too).
* chip_smoke.py's phase 19 at a small width on the CPU.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_twins import port_copy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["ccrdt_trace", "ccrdt_spans", "ccrdt_rtrace", "ccrdt_devprof", "ccrdt_audit",
           "obs_dashboard", "spans_demo", "overlap_demo", "partition_demo", "topo_demo", "audit_demo",
           "multichip_demo"]

globals().update(port_copy("test_trace_cli.py", imports=False, replace=[
    ('        "scripts",\n        "ccrdt_trace.py",',
     '        "antidote_ccrdt_tpu_torch",\n        "scripts",\n        "ccrdt_trace.py",'),
    ('"scripts", "ccrdt_trace.py")', '"antidote_ccrdt_tpu_torch", "scripts", "ccrdt_trace.py")'),
]))


def jax_cli(name):
    """The JAX package's ``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_cli(name):
    return importlib.import_module(f"antidote_ccrdt_tpu_torch.scripts.{name}")


def run_main(main, argv):
    """(exit code, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


# --- one seeded spill ---------------------------------------------------------

MEMBERS = ("w0", "w1", "w2")


def _flight(rng):
    """{member: [events]}: delta paths (one never applied, a straggler, a
    relayed cross-zone frame, a gap-skip at w1), devprof compiles and
    committed request traces."""
    evs = {m: [] for m in MEMBERS}
    for o, origin in enumerate(MEMBERS):
        for dseq in range(1, 6):
            t_pub = 100.0 + dseq + o * 0.01 + float(rng.uniform(0, 0.05))
            evs[origin].append(dict(kind="delta.publish", origin=origin, dseq=dseq, t=t_pub,
                                    bytes=int(rng.integers(100, 5000))))
            for peer in MEMBERS:
                if peer == origin:
                    continue
                t_send = t_pub + float(rng.uniform(0.001, 0.003))
                evs[origin].append(dict(kind="frame.send", origin=origin, dseq=dseq, peer=peer, fkind="delta",
                                        bytes=int(rng.integers(100, 5000)), t=t_send))
                t_recv = t_send + float(rng.uniform(0.001, 0.01))
                if dseq == 2 and origin == "w0":
                    evs["w2" if peer == "w1" else "w1"].append(dict(kind="frame.relay", origin=origin, dseq=dseq,
                                                                    cross_zone=peer == "w2", t=t_recv - 0.0005))
                evs[peer].append(dict(kind="frame.recv", origin=origin, dseq=dseq, fkind="delta", t=t_recv,
                                      hops=int(rng.integers(1, 3))))
                evs[peer].append(dict(kind="delta.fetch", origin=origin, dseq=dseq, t=t_recv + 0.0004))
                if (origin, dseq) == ("w2", 5) or (origin, dseq, peer) == ("w0", 3, "w1"):
                    continue  # never applied; a gap-skip at w1
                lat = float(rng.exponential(0.05)) * (20.0 if (origin, dseq, peer) == ("w1", 4, "w0") else 1.0)
                evs[peer].append(dict(kind="delta.apply", origin=origin, dseq=dseq, t=t_recv + 0.001 + lat))
    for m in ("w0", "w1"):
        for i, (site, axis) in enumerate((("batch_merge.fold", "first_trace"),
                                          ("batch_merge.fold", "arg0.slot_score axis3 4->8"),
                                          ("drill.apply", "first_trace"),
                                          ("batch_merge.fold", "arg0.slot_score axis3 8->16"))):
            evs[m].append(dict(kind="devprof.compile", site=site, axis=axis, t=100.0 + i,
                               ms=round(float(rng.uniform(5, 900)), 3), cache_depth=i + 1,
                               mono=round(50.0 + i + float(rng.uniform(0, 0.5)), 6)))
    for i in range(6):
        t0 = 200.0 + i
        route, att = float(rng.uniform(0.0001, 0.001)), float(rng.uniform(0.002, 0.03))
        hops = [dict(k="route", t0=t0, t1=t0 + route, hs=0, peer="w1"),
                dict(k="attempt", t0=t0 + route, t1=t0 + route + att, hs=1, peer="w1", ok=True)]
        if i % 3 == 0:
            hops.append(dict(k="backoff", t0=t0 + route + att, t1=t0 + route + att + 0.004, hs=2))
        m_in = 500.0 + i
        server = [dict(peer="w1", t_send=t0 + route, t_recv=t0 + route + att, m_in=m_in, m_out=m_in + att * 0.8,
                       m_q=m_in + 0.0002, m_drain=m_in + att * 0.3, m_done=m_in + att * 0.7,
                       kernel_ms=round(att * 400, 3))]
        tr = dict(id=f"w2-{i:04x}-1", kind="read" if i % 2 else "write", key=f"k{i % 3}", member="w2",
                  sampled=True, t0=t0, hops=hops, server=server, outcome="ok" if i != 5 else "shed",
                  ms=round((hops[-1]["t1"] - t0) * 1e3, 3))
        evs["w2"].append(dict(kind="rtrace.trace", trace=tr, t=t0 + 1.0))
    return evs


def _spans(rng, member, tid0=0):
    """One worker's span spill: its clock anchor, five rounds of phases
    (the sends on another thread) and clock offsets to its peers."""
    from antidote_ccrdt_tpu_torch.obs.spans import E2E, PHASES

    recs = [dict(k="clock", member=member, pid=4242, wall=1_700_000_000.0, mono=10.0)]
    sid = 0
    for step in range(5):
        lo = 10.0 + step * 0.3 + float(rng.uniform(0, 0.01))
        dur = float(rng.uniform(0.05, 0.12))
        sid += 1
        recs.append(dict(k="span", name=E2E, sid=sid, parent=None, member=member, tid=tid0, m0=lo, m1=lo + dur,
                         step=step))
        e2e_sid, t = sid, lo
        for name in PHASES:
            d = float(rng.uniform(0.001, dur / 12))
            sid += 1
            tid = tid0 + 1 if name == "round.gossip_send" else tid0
            recs.append(dict(k="span", name=name, sid=sid, parent=e2e_sid, member=member, tid=tid, m0=t, m1=t + d))
            t += d
    for peer in MEMBERS:
        if peer != member:
            recs.append(dict(k="offset", member=member, peer=peer, offset=float(rng.uniform(-0.002, 0.002)),
                             rtt=float(rng.uniform(0.0001, 0.001)), mono=11.0))
    return recs


@pytest.fixture(scope="module")
def spill(tmp_path_factory):
    """A seeded spill directory (``obs/``, status drops, carriers, digests)."""
    rng = np.random.default_rng(16)
    root = tmp_path_factory.mktemp("spill")
    obs = root / "obs"
    obs.mkdir()
    for m, evs in _flight(rng).items():
        evs.sort(key=lambda e: e["t"])
        with open(obs / f"flight-{m}-4242.jsonl", "w") as f:
            for seq, ev in enumerate(evs):
                f.write(json.dumps({"member": m, "seq": seq, **ev}) + "\n")
    for i, m in enumerate(MEMBERS[:2]):  # w2 has no span spill: no offset path to it
        with open(obs / f"spans-{m}-4242.jsonl", "w") as f:
            for rec in _spans(rng, m, tid0=i):
                f.write(json.dumps(rec) + "\n")
    gauges = lambda: dict(live_buffer_bytes=int(rng.integers(1, 2**33)),  # noqa: E731
                          live_buffer_peak_bytes=int(rng.integers(2**33, 2**34)),
                          hbm_used_bytes=int(rng.integers(1, 2**32)), hbm_budget_bytes=2**34,
                          hbm_peak_bytes=int(rng.integers(2**32, 2**33)),
                          hbm_occupancy=round(float(rng.uniform(0, 1)), 4))
    (root / "obs-w0.json").write_text(json.dumps({"member": "w0", "devprof": gauges()}))
    (root / "obs-w1.json").write_text(json.dumps(
        {"member": "w1", "counters": {f"devprof.{k}": v for k, v in gauges().items()}}))
    (root / "obs-w2.json").write_text(json.dumps({"member": "w2", "devprof": {}}))
    for name, shift in (("DEVPROF_a.json", 0.0), ("DEVPROF_b.json", 1.5)):
        (root / name).write_text(json.dumps(dict(
            recompiles_per_100_rounds=round(float(rng.uniform(0, 20)) + shift, 3),
            compile_ms_share_pct=round(float(rng.uniform(0, 10)), 3), overhead_pct=round(float(rng.uniform(0, 2)), 3),
            storm_cut_factor=round(float(rng.uniform(3, 9)), 3),
            checks={"storm_cut": True, "overhead": shift == 0.0, "identity": True}, **{"pass": shift == 0.0})))
    digest = [int(x) for x in rng.integers(0, 2**32, 4)]
    finals = root / "finals"
    finals.mkdir()
    for m in MEMBERS:
        d = list(digest)
        if m == "w2":
            d[2] ^= 1  # one divergent partition
        (finals / f"final-{m}.json").write_text(json.dumps({"member": m, "digest": d}))
    (root / "digests.json").write_text(json.dumps({"w1": "-".join("%08x" % x for x in digest)}))
    (root / "reference.txt").write_text("-".join("%08x" % x for x in digest))
    from antidote_ccrdt_tpu_torch.obs import audit as port_audit

    cert = port_audit.certify(obs_dir=str(obs), digests={m: digest for m in MEMBERS}, reference=digest)
    (root / "signed.json").write_text(json.dumps(cert, indent=2, sort_keys=True))
    return root


def _ref(spill):
    return (spill / "reference.txt").read_text()


# (CLI, port-only arguments, argument builder, output files, compare stderr)
CASES = {
    "trace-summary": ("ccrdt_trace", [], lambda s: ["summary", "obs", "--require-complete"], [], True),
    "trace-path": ("ccrdt_trace", [], lambda s: ["path", "obs", "w0", "2"], [], True),
    "trace-stragglers": ("ccrdt_trace", [], lambda s: ["stragglers", "obs", "--factor", "2.5", "--json"], [], True),
    "trace-audit": ("ccrdt_trace", [], lambda s: ["audit", "obs"], [], True),
    "spans-merge": ("ccrdt_spans", [], lambda s: ["merge", "obs", "-o", "trace.json"], ["trace.json"], True),
    "spans-attribute": ("ccrdt_spans", [], lambda s: ["attribute", "obs", "--min-coverage", "0.5"], [], True),
    "rtrace-waterfall": ("ccrdt_rtrace", [], lambda s: ["waterfall", "obs"], [], True),
    "rtrace-attribute": ("ccrdt_rtrace", [], lambda s: ["attribute", "obs", "--json"], [], True),
    "rtrace-slowest": ("ccrdt_rtrace", [], lambda s: ["slowest", "obs", "-n", "4"], [], True),
    "devprof-churn": ("ccrdt_devprof", [], lambda s: ["churn", "obs", "-n", "5"], [], True),
    "devprof-timeline": ("ccrdt_devprof", [], lambda s: ["timeline", "obs", "--site", "batch_merge.fold", "--json"],
                         [], True),
    "devprof-watermarks": ("ccrdt_devprof", [], lambda s: ["watermarks", "."], [], True),
    "devprof-diff": ("ccrdt_devprof", [], lambda s: ["diff", "DEVPROF_a.json", "DEVPROF_b.json"], [], True),
    "audit-laws": ("ccrdt_audit", ["--device", "cpu"],
                   lambda s: ["laws", "--types", "topk_rmv,average", "--pairs", "32", "--json"], [], False),
    "audit-certify": ("ccrdt_audit", [], lambda s: ["certify", "obs", "--final-dir", "finals", "--digests",
                                                    "digests.json", "--reference", _ref(s), "--out", "cert.json"],
                      ["cert.json"], True),
    "audit-verify": ("ccrdt_audit", [], lambda s: ["verify", "signed.json"], [], True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_equals_jax_byte_for_byte(case, spill, monkeypatch):
    name, port_only, argv, outputs, with_stderr = CASES[case]
    monkeypatch.chdir(spill)
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)  # the certificate's stamp
    got = {}
    for side, main, extra in (("jax", jax_cli(name).main, []), ("port", port_cli(name).main, port_only)):
        rc, out, err = run_main(main, argv(spill) + extra)
        files = {}
        for fn in outputs:
            files[fn] = (spill / fn).read_bytes()
            os.remove(spill / fn)
        got[side] = (rc, out, err if with_stderr else "", files)
    assert got["port"] == got["jax"]
    assert got["jax"][1] or got["jax"][2]  # the case printed something


def test_certify_folds_an_observable_digest_as_audit_demo_does(tmp_path):
    """elastic_demo's final digest is a list of [id, score] pairs: the port
    certifies it as its crc32 (JAX's audit_demo's reading); JAX's CLI
    stops on it."""
    import zlib

    obs = tmp_path / "obs"
    obs.mkdir()
    (obs / "flight-w0-1.jsonl").write_text(json.dumps({"member": "w0", "seq": 0, "kind": "x", "t": 1.0}) + "\n")
    digest = [[7, 310], [3, 95], [41, 12]]
    for m in ("w0", "w1"):
        (tmp_path / f"final-{m}.json").write_text(json.dumps({"member": m, "digest": digest}))
    crc = zlib.crc32(json.dumps(digest, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF
    argv = ["certify", str(obs), "--final-dir", str(tmp_path), "--reference", "%08x" % crc, "--json"]
    rc, out, _ = run_main(port_cli("ccrdt_audit").main, argv)
    doc = json.loads(out)
    assert rc == 0 and doc["ok"] and doc["checks"]["matches_reference"]
    assert doc["worker_digests"] == {"w0": "%08x" % crc, "w1": "%08x" % crc}
    with pytest.raises(TypeError):
        run_main(jax_cli("ccrdt_audit").main, argv)


@pytest.fixture(scope="module")
def no_jax(tmp_path_factory):
    """A path entry whose ``jax`` package raises on import."""
    d = tmp_path_factory.mktemp("nojax")
    (d / "jax").mkdir()
    (d / "jax" / "__init__.py").write_text('raise ImportError("jax is not on this machine")\n')
    return str(d)


@pytest.mark.parametrize("name", SCRIPTS)
def test_help_runs_where_jax_cannot_be_imported(name, no_jax):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([no_jax, REPO]))
    p = subprocess.run([sys.executable, "-m", f"antidote_ccrdt_tpu_torch.scripts.{name}", "--help"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "usage:" in p.stdout


@pytest.mark.parametrize("name,args", [
    ("obs_dashboard", ["--demo"]), ("spans_demo", []), ("overlap_demo", []),
    ("ccrdt_audit", ["laws", "--pairs", "2"]), ("partition_demo", []), ("topo_demo", []),
    ("audit_demo", []), ("multichip_demo", []),
])
def test_without_a_device_the_tool_names_the_missing_card(tmp_path, name, args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    p = subprocess.run([sys.executable, "-m", f"antidote_ccrdt_tpu_torch.scripts.{name}", *args],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr, p.stderr[-2000:]
    assert not os.listdir(tmp_path)  # no fleet started


def test_chip_smoke_observability_phase_holds_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 19 on the CPU: 19a, 19b, 19d (over the spill
    of phase 18a's drill, ``run_spanned_drill`` at ``--shape
    4,256,32,8,4,8``) and 19e whole; from 19c its fleets and its digest
    and counter gates (the 0.30 timing bar is held on the card only). Each
    fleet is killed after 240 s."""
    import runpy

    import torch

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # 19c's workers inherit this process's environment
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    ns["phase_observability"].__globals__.update(
        ELASTIC_SHAPE="4,256,32,8,4,8", WORKER_ENV=dict(os.environ, OMP_NUM_THREADS="1"),
        OBS_TIMEOUT_S=240.0, ELASTIC_FLEET_TIMEOUT_S=240.0)
    drill = ns["run_spanned_drill"](ns["elastic_references"](torch, "cpu")["4,256,32,8,4,8"], "cpu",
                                    str(tmp_path / "a"))
    fleets_root = str(tmp_path / "fleets")
    fleets = ns["run_obs_fleets"]("cpu", fleets_root, ns["demo_reference_crc"](torch))
    reads = ns["spill_reads"](drill, str(tmp_path))
    launches = ns["phase_observability"](torch, "cpu", drill, fleets, reads, dev="cpu")
    assert launches == {n: 0 for n in ns["SOURCES"]}  # the CPU's plain versions count nothing
