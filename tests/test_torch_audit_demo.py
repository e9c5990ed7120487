"""The port's certified-convergence demo (``antidote_ccrdt_tpu_torch/
scripts/audit_demo.py``) against the JAX package's ``scripts/audit_demo.py``,
on the same seeds, at the demo's width, on the CPU.

* The divergent arm: the port's ``run_divergent(device="cpu")`` reports
  what JAX's ``run_divergent()`` reports (``ok``, ``p_star``, the
  divergent and counterexample partitions, the four watchdog states, the
  ``audit.*`` counters, the time to agreement), and its certificate is
  byte-equal to JAX's, signature included, under a frozen wall clock.
* The durability leg: with both packages' crash drill stubbed by one
  verdict, the two ``run_durability`` reports are equal, and the
  fabricated pre-fsync-loss certificates byte-equal.
* The law leg at a few pairs: the port's report equals JAX's.
* The healthy fleet: three port ``net_gossip_demo`` workers on the CPU
  under JAX's seeded ``tcp.send`` drops certify OK with zero wedge
  alarms; each worker's digest is the crc of JAX's reference digest, and
  JAX's ``certify`` over the port's flight-log spill gives the port's
  checks.
"""

import importlib.util
import json
import os
import runpy
import time
import types

import pytest

from antidote_ccrdt_tpu_torch.scripts import audit_demo
from antidote_ccrdt_tpu_torch.scripts import crash_recovery_demo as port_crash

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN_T = 1_700_000_000.0


def _jax_audit_demo():
    spec = importlib.util.spec_from_file_location("jax_audit_demo", os.path.join(REPO, "scripts", "audit_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread_a_worker(monkeypatch):
    """Each worker process computes on one CPU thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture
def frozen_clocks():
    """Both packages' certifiers and flight recorders read one fixed wall
    clock: the port's through chip_smoke.py's ``frozen_wall_clock``, JAX's
    the same way."""
    from antidote_ccrdt_tpu.obs import audit as jax_audit, events as jax_events

    frozen_wall_clock = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))["frozen_wall_clock"]
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    fake.time = lambda: FROZEN_T
    saved = [(mod, mod.time) for mod in (jax_audit, jax_events)]
    with frozen_wall_clock(FROZEN_T):
        try:
            for mod, _ in saved:
                mod.time = fake
            yield
        finally:
            for mod, real in saved:
                mod.time = real


def test_divergent_arm_and_its_certificate_equal_jax(frozen_clocks):
    want = _jax_audit_demo().run_divergent()
    got = audit_demo.run_divergent(device="cpu")
    for key in ("ok", "p_star", "divergent_parts", "counterexample_parts", "states", "counters", "tta_p50_s"):
        assert got[key] == want[key], key
    assert got["ok"] and got["states"] == {"agree": 0, "first": 1, "wedged": 2, "healed": 0}
    assert json.dumps(got["cert"], sort_keys=True) == json.dumps(want["cert"], sort_keys=True)
    assert got["cert"]["t"] == FROZEN_T and not got["cert"]["ok"]


def test_durability_leg_and_fabricated_certificate_equal_jax(monkeypatch, frozen_clocks):
    """Both packages' ``run_durability`` over one stubbed crash-drill
    verdict: equal reports, and the fabricated log's certificate (what
    each package's ``certify`` returned for it) byte-equal."""
    from antidote_ccrdt_tpu.obs import audit as jax_audit
    from antidote_ccrdt_tpu_torch.obs import audit as port_audit

    jax_demo = _jax_audit_demo()
    jax_crash = importlib.import_module("scripts.crash_recovery_demo")
    fleet = {"ok": True, "problems": [], "durability": "async", "kill_seq": 3, "victim_flight_durable": 2,
             "victim_flight_last_step": 4, "victim_recover_last_step": 3, "mode": "wal",
             "certifier_checks": {"causal_delivery": True, "op_count_reconciliation": True,
                                  "durability_watermark": True}}
    asked = []

    def scenario(mode, type_name, timeout, durability="group", **kw):
        asked.append((mode, type_name, durability))
        return dict(fleet)

    certs = {}

    def recording(name, certify):
        def call(*a, **kw):
            certs[name] = certify(*a, **kw)
            return certs[name]
        return call

    monkeypatch.setattr(jax_crash, "run_scenario", scenario)
    monkeypatch.setattr(port_crash, "run_scenario", scenario)
    monkeypatch.setattr(jax_audit, "certify", recording("jax", jax_audit.certify))
    monkeypatch.setattr(port_audit, "certify", recording("port", port_audit.certify))
    want = jax_demo.run_durability()
    got = audit_demo.run_durability(device="cpu")
    assert asked == [("wal", "topk_rmv", "async")] * 2
    assert got == want and got["ok"] and got["fabricated_flagged"]
    assert [x["uncovered"] for x in got["fabricated_exposures"]] == [[6, 9]]
    assert json.dumps(certs["port"], sort_keys=True) == json.dumps(certs["jax"], sort_keys=True)
    assert certs["port"] == audit_demo.fabricated_loss_certificate()


def test_law_leg_equals_jax():
    want = _jax_audit_demo().run_laws(pairs=4)
    got = audit_demo.run_laws(pairs=4, device="cpu")
    assert got == want and got["ok"] and got["selftest_caught"]


def test_healthy_fleet_certifies_against_jax_reference(tmp_path):
    from antidote_ccrdt_tpu.obs import audit as jax_audit

    jax_demo = _jax_audit_demo()
    want_crc = jax_demo._crc(importlib.import_module("scripts.elastic_demo").reference_digest("topk_rmv"))
    got = audit_demo.run_healthy(root=str(tmp_path / "fleet"), device="cpu", report_dir=str(tmp_path / "reports"))
    assert got["ok"] and got["verified"] and got["cert"]["ok"] and got["wedge_alarms"] == 0
    assert got["reference"] == want_crc
    assert got["digests"] == {f"w{i}": want_crc for i in range(audit_demo.N_WORKERS)}
    assert sorted(os.listdir(tmp_path / "reports")) == [f"report-w{i}.json" for i in range(audit_demo.N_WORKERS)]
    jax_cert = jax_audit.certify(obs_dir=os.path.join(got["root"], "obs"), digests=got["digests"],
                                 reference=want_crc)
    assert jax_cert["ok"] and jax_cert["checks"] == got["cert"]["checks"]
    assert set(got["cert"]["checks"]) >= {"causal_delivery", "op_count_reconciliation", "matches_reference",
                                         "partition_digest_agreement"}


def test_main_writes_the_port_certificate_and_jax_text(tmp_path, monkeypatch, capsys):
    """The CLI on the CPU: exit 0, JAX's printed verdict lines, and the
    healthy certificate in ``AUDIT_torch_r01.json`` of the current
    directory (never the committed ``AUDIT_r01.json``)."""
    monkeypatch.chdir(tmp_path)
    assert audit_demo.main(["--device", "cpu", "--pairs", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "== certified convergence (obs/audit.py) =="
    assert out[1].startswith("laws      : ok (") and out[1].endswith("broken fixture caught)")
    assert out[2].startswith("healthy   : cert OK (signature valid, ") and out[2].endswith("-> AUDIT_torch_r01.json")
    assert out[3].startswith("divergent : watchdog ") and out[-1] == "audit-demo: OK"
    assert os.listdir(tmp_path) == ["AUDIT_torch_r01.json"]
    with open(tmp_path / "AUDIT_torch_r01.json") as f:
        cert = json.load(f)
    assert cert["ok"] and cert["meta"]["arm"] == "healthy"
