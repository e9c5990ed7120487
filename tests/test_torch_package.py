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
from antidote_ccrdt_tpu_torch.ops import laws  # noqa: F401  (registers the law fixtures)
from antidote_ccrdt_tpu_torch.ops.compaction import compact_effect_ops

REPO = Path(__file__).resolve().parent.parent
# Modules of the compaction and MONOID slice; the walk must import each.
NEW_MODULES = [
    "ops.segment", "ops.compaction", "ops.laws", "harness.pipeline", "parallel.delta",
    "parallel.monoid", "utils.tree", "models.average", "models.wordcount", "harness.dense_replay",
]


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import importlib, pkgutil\n"
        "import antidote_ccrdt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "       or m == 'antidote_ccrdt_tpu' or m.startswith('antidote_ccrdt_tpu.')]\n"
        f"missing = [m for m in {NEW_MODULES!r} if 'antidote_ccrdt_tpu_torch.' + m not in sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
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
    for name, kw in (("average", {}), ("wordcount", dict(n_buckets=8)), ("worddocumentcount", dict(n_buckets=8))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.make_dense(name, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compact_effect_ops("average", [("add", 1)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry.law_fixture("average")(0, 2)
    assert compact_effect_ops("average", [("add", 1)], device="cpu") == [("add", (1, 1))]
    # An explicit CPU device is the one way to the plain path.
    assert registry.make_dense("topk_rmv", n_ids=8, n_dcs=2, device="cpu").device.type == "cpu"


def test_registry_knows_topk_rmv():
    assert registry.is_type("topk_rmv") and not registry.is_type("nope")
    assert "topk_rmv" in registry.dense_types()
