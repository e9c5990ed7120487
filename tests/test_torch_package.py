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
# Modules of the compaction and MONOID slice, the validation module, the
# durable host path (its nine modules), the gossip plane, the serve
# plane with the audit certifiers, and the overlapped round pipeline
# with the partition pager, the bridge server and client, the mesh plane,
# the multi-process plane, the elastic drill worker, the operator's
# observability tools, the anti-entropy gates, the certified-convergence
# gates and the fleet write and read tiers; the walk must import each.
NEW_MODULES = [
    "ops.segment", "ops.compaction", "ops.laws", "harness.pipeline", "parallel.delta",
    "parallel.monoid", "utils.tree", "models.average", "models.wordcount", "harness.dense_replay",
    "utils.validate",
    "obs", "obs.events", "obs.spans", "utils.faults", "harness.replay", "core.partition", "core.pager",
    "harness.checkpoint", "harness.wal", "harness.native_host", "harness.native_tokenizer",
    # the gossip plane
    "topo", "topo.zones", "topo.anchor", "topo.codec", "topo.router", "bridge", "bridge.protocol",
    "net", "net.membership", "net.transport", "net.sim", "net.tcp", "obs.lag", "obs.export",
    "obs.rtrace", "obs.http", "obs.profile", "obs.devprof", "parallel.elastic",
    # the serve plane and the audit certifiers
    "serve", "serve.cache", "serve.routing_common", "serve.session", "serve.replica", "serve.kernels",
    "serve.plane", "serve.router", "serve.ingest", "serve.write_session", "obs.audit",
    # the overlapped round pipeline and the partition pager
    "parallel.overlap", "core.pager",
    # the bridge server and client
    "bridge.server", "bridge.client",
    # the single-process mesh plane
    "parallel.dist", "parallel.sharded", "mesh", "mesh.plan", "mesh.reduce", "mesh.gossip",
    # the multi-process plane
    "parallel.multihost", "harness.orbax_ckpt", "parallel.orbax_gossip", "scripts.multihost_demo",
    # the elastic drill worker
    "scripts.elastic_demo", "scripts.net_gossip_demo", "scripts.crash_recovery_demo",
    # the operator's observability tools
    "scripts.ccrdt_trace", "scripts.ccrdt_spans", "scripts.ccrdt_rtrace", "scripts.ccrdt_devprof",
    "scripts.ccrdt_audit", "scripts.obs_dashboard", "scripts.spans_demo", "scripts.overlap_demo",
    # the anti-entropy gates
    "scripts.partition_demo", "scripts.topo_demo",
    # the certified-convergence gates
    "scripts.audit_demo", "scripts.multichip_demo",
    # the fleet write tier
    "scripts.write_tier_demo",
    # the fleet read tier
    "scripts.read_tier_demo",
    # the request-tracing gate
    "scripts.rtrace_demo",
]
WORKER_SCRIPTS = ["elastic_demo", "net_gossip_demo", "crash_recovery_demo",
                  "ccrdt_trace", "ccrdt_spans", "ccrdt_rtrace", "ccrdt_devprof", "ccrdt_audit",
                  "obs_dashboard", "spans_demo", "overlap_demo", "partition_demo", "topo_demo",
                  "audit_demo", "multichip_demo", "write_tier_demo", "read_tier_demo", "rtrace_demo"]


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


@pytest.mark.parametrize("name", WORKER_SCRIPTS)
def test_worker_scripts_import_no_jax_nor_the_jax_package_nor_its_scripts(name):
    """Every import statement of the port's worker scripts, those inside
    functions included, names neither jax, nor the JAX package, nor the
    repository's `scripts` package (the port keeps its own copies)."""
    import ast

    tree = ast.parse((REPO / "antidote_ccrdt_tpu_torch" / "scripts" / f"{name}.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "antidote_ccrdt_tpu", "scripts")]
    assert not bad, bad
    assert any(m.startswith("antidote_ccrdt_tpu_torch.") for m in names)


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
    # The write session compacts on a device, the law checker builds its
    # fixtures on one: neither falls back to the CPU quietly.
    from antidote_ccrdt_tpu_torch.obs.audit import LawChecker
    from antidote_ccrdt_tpu_torch.serve import WriteRouter, WriteSession

    with pytest.raises(RuntimeError, match="no CUDA device"):
        WriteSession(WriteRouter(["w0"], lambda *a: b""), "topk_rmv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LawChecker(types=["average"], pairs=2).run()
    assert WriteSession(WriteRouter(["w0"], lambda *a: b""), "topk_rmv", device="cpu").device.type == "cpu"
    # The bridge server resolves its device once, when it is built: its
    # grids, batch_merge and grid_compact never fall back to the CPU.
    from antidote_ccrdt_tpu_torch.bridge import BridgeServer
    from antidote_ccrdt_tpu_torch.bridge.server import _Grid

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BridgeServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _Grid("average", {})
    with BridgeServer(device="cpu") as srv:
        assert srv.device.type == "cpu"
    # A mesh is built over the cards unless the caller names its devices.
    from antidote_ccrdt_tpu_torch.mesh import MeshPlan

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshPlan.build()
    assert MeshPlan.build(n_dc=2, n_key=1, devices=["cpu"] * 2).mesh.device.type == "cpu"
    # A multi-process world joins on the card unless the caller asks for
    # the CPU (JAX's CI rig): without a card it raises before any rendezvous.
    from antidote_ccrdt_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("localhost:1", 1, 0, backend="gloo", local_devices=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_replica_mesh()
    from antidote_ccrdt_tpu_torch.core.batch_merge import host_device

    with host_device():
        assert multihost.global_replica_mesh().shape == {"dcn": 1, "dc": 1, "key": 1}
    # An explicit CPU device is the one way to the plain path.
    assert registry.make_dense("topk_rmv", n_ids=8, n_dcs=2, device="cpu").device.type == "cpu"


def test_write_tier_demo_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """The drill and its CLI resolve the device before any worker starts:
    without a card they raise; with ``--device cpu`` they get past it (to
    the width, here a bad one)."""
    from antidote_ccrdt_tpu_torch.scripts import write_tier_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(write_tier_demo, "_spawn_fleet", lambda *a, **kw: pytest.fail("a worker was started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        write_tier_demo.run_fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        write_tier_demo.main(["--out", "unused.json"])
    with pytest.raises(ValueError):
        write_tier_demo.run_fleet(device="cpu", shape="not,a,width")


def test_read_tier_demo_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """The read-tier drill and its CLI resolve the device before any worker
    starts: without a card they raise; with ``--device cpu`` they get past
    it (to the width, here a bad one)."""
    from antidote_ccrdt_tpu_torch.scripts import read_tier_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(read_tier_demo, "_spawn_fleet", lambda *a, **kw: pytest.fail("a worker was started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_tier_demo.run_fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_tier_demo.main(["--out", "unused.json"])
    with pytest.raises(ValueError):
        read_tier_demo.run_fleet(device="cpu", shape="not,a,width")


def test_rtrace_demo_raises_without_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    """The request-tracing drill and its CLI resolve the device before any
    worker starts: without a card they raise; with ``--device cpu`` they
    get past it (to the width, here a bad one)."""
    from antidote_ccrdt_tpu_torch.scripts import rtrace_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(rtrace_demo, "_spawn_fleet", lambda *a, **kw: pytest.fail("a worker was started"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rtrace_demo.run_fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rtrace_demo.main(["--out", "unused.json"])
    with pytest.raises(ValueError):
        rtrace_demo.run_fleet(device="cpu", shape="not,a,width")


def test_registry_knows_topk_rmv():
    assert registry.is_type("topk_rmv") and not registry.is_type("nope")
    assert "topk_rmv" in registry.dense_types()
