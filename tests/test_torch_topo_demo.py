"""The port's two-zone fleet demo (``antidote_ccrdt_tpu_torch/scripts/
topo_demo.py``) and chip_smoke.py's phase 20 on the CPU.

* ``test_chip_smoke_antientropy_phase_holds_on_the_cpu`` runs phase 20
  with ``dev="cpu"``: 20a's partition drill at the demo's width under
  ``held_against_plain`` with all seven of JAX's checks, the demo-width
  reports of two runs equal but for the timing counters, and 20b's
  ``topo_demo`` whole (two legs of six port workers, the za anchor
  SIGKILLed, every gate of JAX's: survivors at the reference in both
  legs, cross-zone frames and relays, a failover event, at most half the
  full mesh's cross-zone sends), each worker's first K1c, K2 and K3 calls
  held. 20a's TCP probe runs at 1 and 4 MB here, and both peers' deltas
  are seen landing at w2 before the outage, timed against w2's last sweep.
  topo_demo is killed after 240 s. The reference the demo holds its
  survivors to, the port's ``elastic_demo.reference_digest``, equals
  JAX's after the demo's JSON normalisation.
* ``--out auto`` numbers ``TOPO_torch_rNN.json`` in the current directory
  and never takes a ``TOPO_r*.json`` name.
"""

import importlib.util
import json
import os
import runpy

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_elastic_demo():
    spec = importlib.util.spec_from_file_location("jax_elastic_demo", os.path.join(REPO, "scripts", "elastic_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_antientropy_phase_holds_on_the_cpu(monkeypatch, tmp_path, capsys):
    from antidote_ccrdt_tpu_torch.scripts.elastic_demo import reference_digest

    want = json.loads(json.dumps(_jax_elastic_demo().reference_digest("topk_rmv")))
    assert json.loads(json.dumps(reference_digest("topk_rmv", device="cpu"))) == want and want

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    ns = runpy.run_path(os.path.join(REPO, "chip_smoke.py"))
    ns["phase_antientropy"].__globals__.update(AE_SHAPE="demo", AE_TIMEOUT_S=240.0, AE_PROBE_MB=(1, 4),
                                               WORKER_ENV=dict(os.environ, OMP_NUM_THREADS="1"))
    launches = ns["phase_antientropy"](torch, "cpu", ns["run_topo"]("cpu"), dev="cpu")
    assert launches == {n: 0 for n in ns["SOURCES"]}  # the CPU's plain versions count nothing
    lines = {ln.split("] ", 1)[0][1:]: json.loads(ln.split("] ", 1)[1])
             for ln in capsys.readouterr().out.splitlines() if ln.startswith("[20a ")}
    assert set(lines["20a tcp probe"]["landed_s"]) == {"1", "4"}
    margin = lines["20a partition drill"]["pre_outage_margin_s"]
    assert set(margin) == {"w0", "w1"} and all(isinstance(v, float) for v in margin.values()), margin


def test_out_auto_numbers_the_port_rounds_in_the_current_directory(monkeypatch, tmp_path):
    from antidote_ccrdt_tpu_torch.scripts import topo_demo

    monkeypatch.chdir(tmp_path)
    assert topo_demo._next_round_path() == str(tmp_path / "TOPO_torch_r01.json")
    (tmp_path / "TOPO_r07.json").write_text("{}")
    (tmp_path / "TOPO_torch_r02.json").write_text("{}")
    assert topo_demo._next_round_path() == str(tmp_path / "TOPO_torch_r03.json")
