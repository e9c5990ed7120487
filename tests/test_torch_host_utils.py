"""The port's host-side utilities against the JAX package's, on the same
seeded inputs: ``harness/opgen.py`` (``Workload``, ``_draw_ids``,
``prepare_stream``), ``utils/benchtime.py`` (``stack_rounds``,
``windowed``), ``utils/metrics.py`` (``device_trace``, ``profile``) and
``core/batch_merge.host_device``."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.core import batch_merge as jbm
from antidote_ccrdt_tpu.harness import opgen as jopgen
from antidote_ccrdt_tpu.models.topk_rmv_dense import make_dense as jax_make_dense
from antidote_ccrdt_tpu.utils import benchtime as jbt
from antidote_ccrdt_tpu.utils import metrics as jmetrics
from antidote_ccrdt_tpu_torch import batch_merge, convert, registry
from antidote_ccrdt_tpu_torch.core import batch_merge as pbm
from antidote_ccrdt_tpu_torch.device import resolve_device
from antidote_ccrdt_tpu_torch.harness import opgen as popgen
from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
from antidote_ccrdt_tpu_torch.utils import benchtime as pbt
from antidote_ccrdt_tpu_torch.utils import metrics as pmetrics

WORKLOADS = [
    dict(n_replicas=3, n_ids=50, seed=1),
    dict(n_replicas=5, n_ids=1000, zipf_a=1.0, rmv_frac=0.3, seed=2),
    dict(n_replicas=2, n_ids=7, zipf_a=1.5, rmv_frac=0.5, rmv_kind="ban", score_max=20, seed=3),
]


@pytest.mark.parametrize("kw", WORKLOADS)
def test_prepare_stream_draws_the_jax_stream(kw):
    got = list(popgen.prepare_stream(popgen.Workload(**kw), 500))
    want = list(jopgen.prepare_stream(jopgen.Workload(**kw), 500))
    assert got == want
    assert {op[0] for _, op in got} <= {"add", kw.get("rmv_kind", "rmv")}


@pytest.mark.parametrize("kw", WORKLOADS)
def test_draw_ids_and_workload_match_jax(kw):
    pw, jw = popgen.Workload(**kw), jopgen.Workload(**kw)
    assert vars(pw) == vars(jw)
    got = popgen._draw_ids(np.random.default_rng(9), pw, 300)
    want = jopgen._draw_ids(np.random.default_rng(9), jw, 300)
    assert got.dtype == want.dtype and np.array_equal(got, want)


R, I, D, K, M = 3, 40, 3, 6, 4


def batches(n, seed=4):
    wl = dict(n_replicas=R, n_ids=I, score_max=60, seed=seed)
    jg = jopgen.TopkRmvEffectGen(jopgen.Workload(**wl))
    pg = popgen.TopkRmvEffectGen(popgen.Workload(**wl), device="cpu")
    return [jg.next_batch(20, 4) for _ in range(n)], [pg.next_batch(20, 4) for _ in range(n)]


def test_stack_rounds_matches_jax():
    jb, pb = batches(3)
    got, want = pbt.stack_rounds(pb), jbt.stack_rounds(jb)
    for name, arr in convert.to_numpy(got).items():
        assert np.array_equal(arr, np.asarray(getattr(want, name))), name
    assert tuple(got.add_id.shape) == (3, R, 20)


def test_windowed_applies_every_round_in_order_and_times_the_rest():
    # Three windows of two rounds: the port's windowed must apply all six
    # rounds in order (its end state equals the JAX engine's six applies),
    # and both report (ops/s, ms/round) over the two timed windows.
    jb, pb = batches(6, seed=5)
    jeng = jax_make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    peng = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")
    seen = []

    def port_apply(st, ops):
        st = peng.apply_ops(st, ops)[0]
        seen.append(st)
        return st

    windows = [pbt.stack_rounds(pb[k:k + 2]) for k in range(0, 6, 2)]
    p_rate, p_ms = pbt.windowed(port_apply, peng.init(R), windows, R * 24)
    j_rate, j_ms = jbt.windowed(lambda st, ops: jeng.apply_ops(st, ops)[0], jeng.init(R),
                                [jbt.stack_rounds(jb[k:k + 2]) for k in range(0, 6, 2)], R * 24)
    assert len(seen) == 6
    want = jeng.init(R)
    for ops in jb:
        want = jeng.apply_ops(want, ops)[0]
    for name, arr in convert.to_numpy(seen[-1]).items():
        assert np.array_equal(arr, np.asarray(getattr(want, name))), name
    for rate, ms in ((p_rate, p_ms), (j_rate, j_ms)):
        assert np.isfinite(rate) and rate > 0 and np.isfinite(ms) and ms > 0


def test_profile_and_device_trace_write_a_trace(tmp_path):
    # The region computes the same under both packages' hooks, and each
    # writes its trace into its log_dir.
    x = np.arange(1000, dtype=np.int32)
    with jmetrics.profile(str(tmp_path / "jax")):
        with jmetrics.device_trace("square_sum"):
            want = int((jnp.asarray(x) ** 2).sum())
    with pmetrics.profile(str(tmp_path / "torch")):
        with pmetrics.device_trace("square_sum"):
            got = int((torch.from_numpy(x) ** 2).sum())
    assert got == want
    for sub in ("jax", "torch"):
        files = [f for _, _, fs in os.walk(tmp_path / sub) for f in fs]
        assert files, sub
    trace = [f for f in os.listdir(tmp_path / "torch") if f.endswith(".json")]
    assert trace and "square_sum" in (tmp_path / "torch" / trace[0]).read_text()


@pytest.mark.parametrize("name", ["topk_rmv", "topk", "wordcount"])
def test_host_device_merges_on_the_cpu_like_jax(name, monkeypatch):
    # Without a card an entry point called without a device raises; inside
    # host_device it runs on the CPU and merges as JAX does inside its own.
    states = ss.seeded_states(name, n_states=4, seed=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pbm.host_device():
        assert resolve_device().type == "cpu"
        assert torch.empty(2).device.type == "cpu"
        assert registry.make_dense("topk_rmv", n_ids=4, n_dcs=2).device.type == "cpu"
        got = batch_merge(name, states)
    with jbm.host_device():
        want = jbm.batch_merge(name, states)
    assert got == want
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
