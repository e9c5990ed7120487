"""The port's fault registry (``utils/faults.py``), flight-event log
(``obs/events.py``) and span tracer (``obs/spans.py``).

* Every case of ``tests/test_faults.py``, ``tests/test_obs_events.py``
  and ``tests/test_obs_spans.py`` runs again through the port's modules
  (the span case on ``net/sim.py`` included).
* The same plan and seed give the same decisions, ``trace()`` and
  ``hits()`` in both packages, and the env payloads round-trip between
  them.
* The two packages' registries, recorders and tracers are separate:
  arming one leaves the other inert.
"""

import pytest

from antidote_ccrdt_tpu.obs import events as jevents
from antidote_ccrdt_tpu.obs import spans as jspans
from antidote_ccrdt_tpu.utils import faults as jfaults
from antidote_ccrdt_tpu_torch.obs import events as pevents
from antidote_ccrdt_tpu_torch.obs import spans as pspans
from antidote_ccrdt_tpu_torch.utils import faults as pfaults
from torch_twins import port_copy

globals().update(port_copy("test_faults.py"))
globals().update(port_copy("test_obs_events.py"))
globals().update(port_copy("test_obs_spans.py"))


@pytest.fixture(autouse=True)
def _both_registries_clean():
    pfaults.uninstall()
    jfaults.uninstall()
    yield
    pfaults.uninstall()
    jfaults.uninstall()


PLANS = [
    ({"wal.fsync": [{"action": "raise", "rate": 0.3}],
      "tcp.send": [{"action": "drop", "at": [1, 4]}, {"action": "delay", "rate": 0.2, "delay_s": 0.0}],
      "transport.publish": [{"action": "truncate", "rate": 0.5, "keep": 0.5}]}, 7),
    ({"p": [{"action": "drop", "rate": 0.5, "max_fires": 5}], "q": [{"action": "raise", "at": [0, 2]}]}, 123),
]


def drive(faults):
    """Fire every point of the plans 40 times in a fixed interleaving;
    -> (decisions, trace, hits)."""
    out = []
    for i in range(40):
        for point in ("wal.fsync", "tcp.send", "p", "q"):
            try:
                out.append(faults.fire(point))
            except faults.InjectedFault as e:
                out.append(f"raised {e}")
        out.append(faults.mangle("transport.publish", bytes(range(i + 1))))
    return out, faults.trace(), {p: faults.hits(p) for p in ("wal.fsync", "tcp.send", "transport.publish", "p", "q")}


@pytest.mark.parametrize("plan,seed", PLANS)
def test_same_plan_and_seed_give_jax_trace_and_hits(plan, seed):
    with pfaults.injected(plan, seed=seed):
        got = drive(pfaults)
    with jfaults.injected(plan, seed=seed):
        want = drive(jfaults)
    assert got == want
    assert got[1] and any(got[2].values())


@pytest.mark.parametrize("plan,seed", PLANS)
def test_env_payloads_round_trip_between_the_packages(plan, seed):
    payload = pfaults.plan_to_env(plan, seed=seed)
    assert payload == jfaults.plan_to_env(plan, seed=seed)
    assert jfaults.install_from_env({jfaults.ENV_VAR: payload})
    want = drive(jfaults)
    jfaults.uninstall()
    assert pfaults.install_from_env({pfaults.ENV_VAR: jfaults.plan_to_env(plan, seed=seed)})
    assert drive(pfaults) == want


def test_each_package_has_its_own_fault_registry():
    with pfaults.injected({"wal.fsync": [{"action": "raise", "at": [0]}]}):
        assert pfaults.ACTIVE and not jfaults.ACTIVE
        assert jfaults.fire("wal.fsync") == "ok"
        with pytest.raises(pfaults.InjectedFault):
            pfaults.fire("wal.fsync")
    with jfaults.injected({"wal.fsync": [{"action": "raise", "at": [0]}]}):
        assert jfaults.ACTIVE and not pfaults.ACTIVE
        assert pfaults.fire("wal.fsync") == "ok"
        assert pfaults.trace() == [] and jfaults.hits("wal.fsync") == 0


def test_each_package_has_its_own_recorder_and_tracer(tmp_path):
    pevents.configure("port-member")
    jevents.configure("jax-member")
    try:
        pevents.emit("wal.append", wseq=1)
        assert [e["kind"] for e in pevents.events(kind="wal.append")] == ["wal.append"]
        assert jevents.events(kind="wal.append") == []
        assert pevents.events()[-1]["member"] == "port-member"
    finally:
        pevents.reset()
        jevents.reset()
    with pspans.installed("w0"):
        assert pspans.ACTIVE and not jspans.ACTIVE
    assert not pspans.ACTIVE
