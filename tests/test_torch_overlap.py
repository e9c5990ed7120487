"""The port's overlapped round pipeline (``parallel/overlap.py``) against
the JAX package's.

* Every case of ``tests/test_overlap.py`` and ``tests/test_ingest_fastpath.py``
  runs again through the port, with the drills of ``torch_twins`` in place
  of scripts/elastic_demo.py's, less the one in `LEFT_OUT`; the slow
  SIGKILL drill runs the port's ``scripts/crash_recovery_demo.py``
  (``--device cpu``).
* The same seeded chaos drill through both packages' `OverlapPipeline`s
  ends in equal digests and equal ``overlap.*`` counters.
* Only what a malformed payload raises is billed; any other error in a
  fold propagates out of `drain_into`.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

_DEMO = ("from elastic_demo import DRILLS, R, STEPS, reference_digest",
         "from torch_twins import DEMO_DRILLS as DRILLS, R, STEPS, reference_digest")
LEFT_OUT = {
    "test_merge_slots_cached_per_bound_method":
        "the port has no jit cache: merges run out of place, with no slots to cache (ROADMAP C)",
}

globals().update(port_copies(
    ("test_overlap.py", dict(skip=list(LEFT_OUT), helpers=["run_overlap_chaos"], replace=[
        _DEMO, ("    merge_slots,\n", ""), ("    import jax\n", "    from torch_twins import torch_jax as jax\n"),
        ("from test_net_chaos import run_chaos", "from torch_twins import port_run_chaos as run_chaos"),
        ('os.path.join(REPO, "scripts", "crash_recovery_demo.py"),\n         "--mode", "wal", "--durability", "group"]',
         'os.path.join(REPO, "antidote_ccrdt_tpu_torch", "scripts", "crash_recovery_demo.py"),\n'
         '         "--mode", "wal", "--durability", "group", "--device", "cpu"]'),
    ])),
    ("test_ingest_fastpath.py", dict(replace=[_DEMO])),
))
port_run_overlap_chaos = globals().pop("run_overlap_chaos")


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages side by side -------------------------------------------

import os  # noqa: E402
import sys  # noqa: E402

from antidote_ccrdt_tpu_torch.parallel import overlap  # noqa: E402
from torch_twins import demo_drills, leaf_bytes  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_overlap import run_overlap_chaos as jax_run_overlap_chaos  # noqa: E402


@pytest.mark.parametrize("seed,depth,drain_every", [(7, 3, 3), (2, 2, 4)])
def test_same_seed_gives_jax_digests_and_overlap_counters(seed, depth, drain_every):
    """The shed, the holes, the anchors that heal them and the folds come
    out as the JAX package's: equal digests and every ``overlap.*`` and
    simulator counter equal."""
    got_d, got_c = port_run_overlap_chaos("topk_rmv", seed, depth=depth, drain_every=drain_every)
    want_d, want_c = jax_run_overlap_chaos("topk_rmv", seed, depth=depth, drain_every=drain_every)
    assert got_d == want_d
    assert got_c == want_c
    assert got_c["overlap.folds"] > 0 and got_c["overlap.dropped_deltas"] > 0
    assert got_c.get("overlap.apply_errors", 0) == 0


def _queued_pipeline(tmp_path, windows=3):
    """A receiver's pipeline holding `windows` expanded deltas of one
    publisher, its state and the publisher's final state."""
    from antidote_ccrdt_tpu_torch.parallel.elastic import DeltaPublisher, GossipStore

    drill = demo_drills("torch")["topk_rmv"]
    dense = drill.make_engine()
    a, b = GossipStore(str(tmp_path), "a"), GossipStore(str(tmp_path), "b")
    pub = DeltaPublisher(a, dense, name="topk_rmv", full_every=100)
    st = drill.init(dense)
    for step in range(windows + 1):
        st = drill.apply(dense, st, step, range(4))
        pub.publish(st)
    ovl = overlap.OverlapPipeline(b, dense, drill.init(dense), start_thread=False)
    assert ovl.prefetch.poll() == windows + 1  # the anchor and the deltas
    return ovl, dense, drill.init(dense), st


def test_drain_folds_the_queue_into_the_publishers_state(tmp_path):
    ovl, dense, state, want = _queued_pipeline(tmp_path)
    got = ovl.drain_into(state)
    assert leaf_bytes(got) == leaf_bytes(dense.merge(state, want))
    assert ovl.metrics.counters["overlap.folds"] == 1
    assert ovl.metrics.counters["overlap.folded_windows"] == 4
    ovl.close(got)


def test_a_raising_merge_propagates_out_of_drain_into(tmp_path):
    """A fold whose merge fails with anything but a payload's error (here
    the RuntimeError a CUDA failure raises) is not billed and not retried
    entry by entry: it leaves `drain_into`."""
    ovl, dense, state, _ = _queued_pipeline(tmp_path)

    def broken(a, b):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    ovl.dense = type("Broken", (), {"merge": staticmethod(broken)})()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ovl.drain_into(state)
    assert ovl.metrics.counters.get("overlap.apply_errors", 0) == 0
    ovl.host.close()


def test_a_malformed_payload_is_billed_not_raised(tmp_path):
    """A payload error (a ValueError from the join) in the fold falls
    back entry by entry and is billed ``overlap.apply_errors``, as in the
    JAX package."""
    ovl, dense, state, _ = _queued_pipeline(tmp_path, windows=1)

    class Bad:
        def __getattr__(self, name):
            return getattr(dense, name)

        def merge(self, a, b):
            raise ValueError("rows out of range")

    ovl.dense = Bad()
    assert ovl.drain_into(state) is state
    assert ovl.metrics.counters["overlap.apply_errors"] == 2
    ovl.host.close()


@pytest.mark.parametrize("raised_by", ["drain_into", "stop"])
def test_prefetch_thread_error_is_raised_on_the_round_thread(tmp_path, raised_by):
    """The prefetcher's thread bills a payload or medium error and goes
    on; any other error ends it, and the round thread's next
    `drain_into` (or `stop`) raises it."""
    ovl, _dense, state, _ = _queued_pipeline(tmp_path)

    def broken():
        raise RuntimeError("CUDA error: launch failure")

    ovl.prefetch.store.snapshot_members = broken
    ovl.prefetch.start(interval=0.001)
    ovl.prefetch._thread.join(timeout=10)
    with pytest.raises(RuntimeError, match="launch failure"):
        ovl.drain_into(state) if raised_by == "drain_into" else ovl.prefetch.stop()
    assert ovl.metrics.counters.get("overlap.prefetch_errors", 0) == 0
    ovl.host.close()


def test_chip_smoke_overlapped_drill_holds_on_the_cpu():
    """chip_smoke.py phase 14a's drill (`run_gossip(overlap=True)`) at a tiny width on
    the CPU: the survivors reach the sequential reference after adopting
    the victim's replicas, and the queue shed and folded, as phase 14
    requires on the card."""
    import torch

    import chip_smoke

    out = chip_smoke.run_gossip(torch, "cpu", (4, 64, 16, 4), overlap=True)
    assert out["covered"] and out["ref"] and all(d == out["ref"] for d in out["digests"].values())
    c = out["counters"]
    assert c["overlap.folds"] > 0 and c["overlap.dropped_deltas"] > 0 and not c.get("overlap.apply_errors")
