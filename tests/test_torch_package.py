"""Package rules of the port: it imports no jax and nothing of the JAX
package, and its entry points default to the CUDA card and raise without
one (they never fall back to the CPU quietly)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from antidote_ccrdt_tpu_torch import registry
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import importlib, pkgutil\n"
        "import antidote_ccrdt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'antidote_ccrdt_tpu' or m.startswith('antidote_ccrdt_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.make_dense("topk_rmv", n_ids=8, n_dcs=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TopkRmvEffectGen(Workload(2, 8))
    # An explicit CPU device is the one way to the plain path.
    assert registry.make_dense("topk_rmv", n_ids=8, n_dcs=2, device="cpu").device.type == "cpu"


def test_registry_knows_topk_rmv():
    assert registry.is_type("topk_rmv") and not registry.is_type("nope")
    assert "topk_rmv" in registry.dense_types()
