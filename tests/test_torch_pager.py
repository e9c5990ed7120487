"""The port's partition pager (``core/pager.py``) against the JAX package's.

* Every case of ``tests/test_pager.py`` runs again through the port
  (``jax.numpy`` and ``jax.tree_util`` through ``torch_twins``; the
  SIGKILL drill's child process too).
* One seeded stream through both packages' pagers — demotions under a
  budget, hot writes, peer deltas with removals folded cold or queued,
  a peer's whole state absorbed, hydrations — gives byte-equal stored
  payloads, digest vectors, substrate leaves, logical states and
  counters, with `fold_cold` on and off.
* scripts/working_set_demo.py's drill at the demo's own geometry gives
  JAX's digest vector, observable and counters.
"""

import os

import numpy as np
import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copy

_JNP = ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp")
globals().update(port_copy("test_pager.py", replace=[
    _JNP, ("import jax\n", "from torch_twins import torch_jax as jax\n"),
    ("DENSE = make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M)",
     'DENSE = make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M, device="cpu")'),
    ("dense = make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M)",
     'dense = make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M, device="cpu")'),
    ("PYTHONPATH=REPO\n", 'PYTHONPATH=REPO + os.pathsep + os.path.join(REPO, "tests")\n'),
]))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages side by side -------------------------------------------

import jax.numpy as jnp  # noqa: E402

from antidote_ccrdt_tpu.core import pager as jpg  # noqa: E402
from antidote_ccrdt_tpu.core import partition as jpt  # noqa: E402
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr  # noqa: E402
from antidote_ccrdt_tpu.parallel import delta as jdl  # noqa: E402
from antidote_ccrdt_tpu_torch import convert  # noqa: E402
from antidote_ccrdt_tpu_torch.core import pager as ppg  # noqa: E402
from antidote_ccrdt_tpu_torch.core import partition as ppt  # noqa: E402
from antidote_ccrdt_tpu_torch.models import topk_rmv_dense as ptkr  # noqa: E402
from antidote_ccrdt_tpu_torch.parallel import delta as pdl  # noqa: E402
from torch_twins import leaf_bytes  # noqa: E402

SR, SI, SD, SK, SM, SB, SBR, SP = 3, 96, 3, 8, 2, 40, 6, 8


def _ops(pkg, rng, owned=range(SR), hot_ids=None):
    """A seeded batch with adds (Zipf ids, or drawn from `hot_ids`) and
    removals carrying a vc on the row's dc."""
    cols = dict(add_key=np.zeros((SR, SB), np.int32), add_id=np.zeros((SR, SB), np.int32),
                add_score=np.zeros((SR, SB), np.int32), add_dc=np.zeros((SR, SB), np.int32),
                add_ts=np.zeros((SR, SB), np.int32), rmv_key=np.zeros((SR, SBR), np.int32),
                rmv_id=np.full((SR, SBR), -1, np.int32), rmv_vc=np.zeros((SR, SBR, SD), np.int32))
    for r in owned:
        ids = ((rng.zipf(1.3, SB) - 1) % SI) if hot_ids is None else hot_ids[rng.integers(0, len(hot_ids), SB)]
        cols["add_id"][r] = ids
        cols["add_score"][r] = rng.integers(1, 500, SB)
        cols["add_dc"][r] = r % SD
        cols["add_ts"][r] = rng.integers(1, 400, SB)
        cols["rmv_id"][r] = rng.integers(0, SI, SBR)
        cols["rmv_vc"][r, :, r % SD] = rng.integers(1, 200, SBR)
    if pkg == "jax":
        return jtkr.TopkRmvOps(**{k: jnp.asarray(v) for k, v in cols.items()})
    return convert.from_numpy(ptkr.TopkRmvOps, cols, "cpu")


def _stream(pkg, fold_cold):
    """One pager's life on a seeded stream; what it stored and counted."""
    mods = (jtkr, jpg, jpt, jdl) if pkg == "jax" else (ptkr, ppg, ppt, pdl)
    tkr, pg, pt, dl = mods
    kw = {} if pkg == "jax" else {"device": "cpu"}
    dense = tkr.make_dense(n_ids=SI, n_dcs=SD, size=SK, slots_per_id=SM, **kw)
    rng = np.random.default_rng(5)
    state = dense.init(SR, 1)
    for _ in range(3):
        state = dense.apply_ops(state, _ops(pkg, rng), collect_dominated=False)[0]
    probe = pg.PartitionPager(dense, state, P=SP, name="probe")
    budget = probe.meta_bytes + sum(probe.part_bytes[p] for p in range(3))
    pager = pg.PartitionPager(dense, state, P=SP, name="topk_rmv", hbm_budget_bytes=budget,
                              fold_cold=fold_cold)
    state = pager.enforce_budget(state)
    snaps = []

    def snap(label):
        sub = pager._cold
        snaps.append((label, sorted(pager.cold_parts()), [pager._load_payload(p) for p in sorted(pager.cold_parts())],
                      [int(x) for x in pager.digest_vector(state)],
                      leaf_bytes(sub) if sub is not None else None, leaf_bytes(pager.full_state(state))))

    snap("budget")
    part_map = pt.part_of(np.arange(SI), SP)
    hot_ids = np.arange(SI)[np.isin(part_map, sorted(pager.resident))]
    state = dense.apply_ops(state, _ops(pkg, rng, hot_ids=hot_ids), collect_dominated=False)[0]
    snap("hot writes")
    peer0 = dense.init(SR, 1)
    peer = dense.apply_ops(peer0, _ops(pkg, rng, owned=[1, 2]), collect_dominated=False)[0]
    state = pager.apply_delta(state, dl.make_delta(dense, peer0, peer))
    snap("peer delta")
    peer = dense.apply_ops(peer, _ops(pkg, rng, owned=[0]), collect_dominated=False)[0]
    state = dense.merge(state, pager.absorb_peer(peer))
    snap("absorbed peer")
    for want in ([0, 1], [5, 6, 7], [2]):
        state = pager.ensure_resident(state, want)
        snap(f"ensure {want}")
    state = pager.hydrate(state, sorted(pager.cold_parts())[0])
    snap("hydrate")
    counters = {k: int(v) for k, v in pager.metrics.counters.items()}
    return snaps, counters, (pager.hits, pager.misses)


@pytest.mark.parametrize("fold_cold", [True, False])
def test_one_stream_stores_and_counts_as_jax(fold_cold):
    got = _stream("torch", fold_cold)
    want = _stream("jax", fold_cold)
    assert [s[0] for s in got[0]] == [s[0] for s in want[0]]
    for g, w in zip(got[0], want[0]):
        assert g[1] == w[1], g[0]  # cold partitions
        assert g[2] == w[2], g[0]  # stored CCPT payload bytes
        assert g[3] == w[3], g[0]  # digest vector
        assert g[4] == w[4], g[0]  # substrate leaves
        assert g[5] == w[5], g[0]  # the logical state
    assert got[1] == want[1] and got[2] == want[2]
    assert got[1]["pager.evictions"] > 0 and got[1]["pager.hydrations"] > 0
    assert got[1].get("pager.cold_folds" if fold_cold else "pager.queued_deltas", 0) > 0


def test_clear_parts_leaves_the_input_unchanged():
    """Demotion's device half writes a copy: the state it was given (which
    a publisher or a WAL may still hold) keeps its slices."""
    dense = ptkr.make_dense(n_ids=SI, n_dcs=SD, size=SK, slots_per_id=SM, device="cpu")
    state = dense.apply_ops(dense.init(SR, 1), _ops("torch", np.random.default_rng(1)),
                            collect_dominated=False)[0]
    before = leaf_bytes(state)
    cleared = ppg.clear_parts(dense, state, [0, 3], SP)
    assert leaf_bytes(state) == before
    jd = jtkr.make_dense(n_ids=SI, n_dcs=SD, size=SK, slots_per_id=SM)
    from torch_twins import to_jax

    assert leaf_bytes(cleared) == leaf_bytes(jpg.clear_parts(jd, to_jax(state), [0, 3], SP))


def test_working_set_drill_gives_jax_digests_and_counters(monkeypatch):
    """scripts/working_set_demo.py's drill (3 workers on FsTransport, a
    budget of a tenth of the state, Zipf accesses through
    `ensure_resident`, partial anti-entropy) through the port at the
    demo's geometry: JAX's digest vector, observable and counters, and
    the demo's gates."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
    import working_set_demo as wsd

    monkeypatch.delenv(jpg.ENV_FLAG, raising=False)
    want = wsd.run_drill(7, P=32, spans=True)
    mod = port_copy("../scripts/working_set_demo.py", helpers=["run_drill"], replace=[
        _JNP, ("    import jax\n\n    jax.config.update(\"jax_platforms\", \"cpu\")\n", ""),
        ("make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M)",
         'make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M, device="cpu")'),
        ("from scripts.cover import install_child_cover  # noqa: E402\n\ninstall_child_cover()", "")])
    got = mod["run_drill"](7, P=32, spans=True)
    for key in ("converged", "matches_reference", "digest_vector", "observable", "counters", "hit_rates",
                "state_bytes", "hbm_budget_bytes", "span_names"):
        assert got[key] == want[key], key
    assert got["converged"] and got["matches_reference"] and got["min_hit_rate"] >= wsd.MIN_HIT
    c = got["counters"]
    assert all(c[k] > 0 for k in ("pager.evictions", "pager.hydrations", "pager.cold_folds"))
    assert c.get("net.psnap_wasted", 0) == 0 and "round.pager_hydrate" in got["span_names"]


def test_paged_serve_plane_answers_as_jax():
    """A `ServePlane(pager=)` over a state with cold partitions swaps in
    the logical state (`full_state`): its answers equal the JAX package's
    paged plane's and the all-resident plane's, and the answered ids feed
    the pager's clock (`note_ids`)."""
    from antidote_ccrdt_tpu import serve as jserve
    from antidote_ccrdt_tpu_torch import serve as pserve

    queries = [{"op": "value", "key": 0}, {"op": "topk", "key": 0, "k": 5},
               {"op": "range", "key": 0, "lo": 100, "hi": 400}]
    answers = {}
    for pkg, tkr, pg, serve in (("torch", ptkr, ppg, pserve), ("jax", jtkr, jpg, jserve)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        dense = tkr.make_dense(n_ids=SI, n_dcs=SD, size=SK, slots_per_id=SM, **kw)
        state = dense.apply_ops(dense.init(SR, 1), _ops(pkg, np.random.default_rng(3)), collect_dominated=False)[0]
        plain = serve.ServePlane(dense, member="w0")
        plain.swap(state, 0)
        pager = pg.PartitionPager(dense, state, P=SP, name="topk_rmv")
        for p in range(0, SP, 2):
            state = pager.demote(state, p)
        paged = serve.ServePlane(dense, member="w0", pager=pager)
        paged.swap(state, 0)
        got = [r["value"] for r in paged.query(queries)["results"]]
        assert got == [r["value"] for r in plain.query(queries)["results"]]
        answers[pkg] = (got, dict(pager._ref), pager.metrics.counters.get("pager.full_joins", 0))
    assert answers["torch"] == answers["jax"]
    assert any(answers["torch"][1].values()) and answers["torch"][2] == 1


def test_chip_smoke_working_set_drill_holds_on_the_cpu():
    """chip_smoke.py phase 14c's drill (`run_working_set`) at a reduced
    width on the CPU meets the demo's gates, and its all-resident arm
    ends in the same digests."""
    import torch

    import chip_smoke

    geo = (4, 256, chip_smoke.WS_B, chip_smoke.WS_BR)
    paged = chip_smoke.run_working_set(torch, "cpu", geo, spans=True)
    chip_smoke.check_working_set(paged, "cpu")
    assert "round.pager_hydrate" in paged["span_names"] and not paged["cold_tier_pinned"]
    flat = chip_smoke.run_working_set(torch, "cpu", geo, paged=False)
    assert flat["converged"] and flat["digest_vector"] == paged["digest_vector"]
    assert flat["observable"] == paged["observable"]
