"""The port's segment primitives, whole-log compaction and batch coalescing
against the JAX package's, bit for bit on seeded inputs (CPU, plain
versions)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.harness.opgen import TopkRmvEffectGen as JaxGen
from antidote_ccrdt_tpu.harness.opgen import Workload as JaxWorkload
from antidote_ccrdt_tpu.harness.pipeline import stream_apply as jax_stream_apply
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr
from antidote_ccrdt_tpu.ops import compaction as jc
from antidote_ccrdt_tpu.ops import dense_table as jdt
from antidote_ccrdt_tpu.ops import segment as jseg
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
from antidote_ccrdt_tpu_torch.harness.pipeline import Prefetcher, stream_apply
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
from antidote_ccrdt_tpu_torch.ops import compaction as pc
from antidote_ccrdt_tpu_torch.ops import dense_table as pdt
from antidote_ccrdt_tpu_torch.ops import segment as pseg

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(port, jax_value):
    return np.array_equal(np.asarray(port), np.asarray(jax_value)) and (
        np.asarray(port).shape == np.asarray(jax_value).shape
    )


# --- segment primitives -------------------------------------------------------


def sorted_keys(seed, L, n_groups):
    """Two sorted key columns whose groups include runs of one row, and a
    first row equal to the last (the roll wraps there)."""
    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, n_groups, L)).astype(np.int32)
    b = np.zeros(L, np.int32)
    for g in np.unique(a):
        idx = np.nonzero(a == g)[0]
        b[idx] = np.sort(rng.integers(0, 3, idx.size))
    return a, b


@pytest.mark.parametrize("seed,L,n_groups", [(0, 1, 1), (1, 2, 1), (2, 40, 40), (3, 40, 5), (4, 40, 1)])
def test_segment_primitives_match_jax(seed, L, n_groups):
    a, b = sorted_keys(seed, L, n_groups)
    rng = np.random.default_rng(100 + seed)
    jf, js, jsg = jseg.segment_starts(jnp.asarray(a), jnp.asarray(b))
    pf, ps, psg = pseg.segment_starts(t(a), t(b))
    assert same(pf, jf) and same(ps, js) and same(psg, jsg)
    assert ps.dtype == torch.int32 and psg.dtype == torch.int32
    flag = rng.random(L) < 0.6
    assert same(pseg.prefix_rank(t(flag), ps), jseg.prefix_rank(jnp.asarray(flag), js))
    assert same(pseg.group_rank([t(a), t(b)]), jseg.group_rank([jnp.asarray(a), jnp.asarray(b)]))
    for vals in (rng.integers(0, I32_MAX, L).astype(np.int32), rng.integers(0, 1000, (L, 3)).astype(np.int32)):
        for direction in ("both", "prefix", "suffix"):
            want = jseg.run_max(jnp.asarray(vals), jsg, direction)
            assert same(pseg.run_max(t(vals), psg, direction), want), direction
            # Sorted raw run ids (not dense) work as segment ids too.
            want = jseg.run_max(jnp.asarray(vals), jnp.asarray(a), direction)
            assert same(pseg.run_max(t(vals), t(a), direction), want), direction


def test_segment_primitives_batch_over_rows():
    rows = [sorted_keys(s, 40, 6) for s in range(3)]
    a = np.stack([r[0] for r in rows])
    b = np.stack([r[1] for r in rows])
    vals = np.random.default_rng(7).integers(0, 50, (3, 40, 3)).astype(np.int32)
    pf, ps, psg = pseg.segment_starts(t(a), t(b))
    for r in range(3):
        jf, js, jsg = jseg.segment_starts(jnp.asarray(a[r]), jnp.asarray(b[r]))
        assert same(pf[r], jf) and same(ps[r], js) and same(psg[r], jsg)
        for direction in ("both", "prefix", "suffix"):
            got = pseg.run_max(t(vals), psg, direction)[r]
            assert same(got, jseg.run_max(jnp.asarray(vals[r]), jsg, direction))


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_rows_run_max_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, 9, 40).astype(np.int32)
    upd = rng.integers(0, I32_MAX, (40, 4)).astype(np.int32)
    jh, jt = jdt.dedup_rows_run_max(jnp.asarray(rows), jnp.asarray(upd), 9)
    ph, pt = pdt.dedup_rows_run_max(t(rows), t(upd), 9)
    assert same(ph, jh) and same(pt, jt)


# --- the log kernels ------------------------------------------------------------


def topk_rmv_log(seed, L=96, D=3, n_keys=2, n_ids=5):
    """A log with every kind (a dead kind other than 4 too), INT32_MIN and
    INT32_MAX scores and ts, ties, exact duplicates, tombstones that do and
    do not dominate, and junk payloads on rmv rows."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, 0, 0, 1, 1, 2, 3, 4, 7], L).astype(np.int32)
    key = rng.integers(0, n_keys, L).astype(np.int32)
    id_ = rng.integers(0, n_ids, L).astype(np.int32)
    score = rng.choice([I32_MIN, -5, 0, 3, 3, 9, I32_MAX], L).astype(np.int32)
    dc = rng.integers(0, D, L).astype(np.int32)
    ts = rng.choice([I32_MIN, 1, 2, 2, 5, 40, I32_MAX], L).astype(np.int32)
    vc = rng.integers(0, 8, (L, D)).astype(np.int32)
    dup = rng.integers(0, L, L // 6)
    for j in dup:  # exact duplicates of earlier rows
        k = rng.integers(0, L)
        for col in (kind, key, id_, score, dc, ts):
            col[k] = col[j]
        vc[k] = vc[j]
    return dict(kind=kind, key=key, id=id_, score=score, dc=dc, ts=ts, vc=vc)


@pytest.mark.parametrize("seed,m_keep", [(0, 1), (1, 2), (2, 4), (3, 96)])
def test_compact_topk_rmv_log_matches_jax(seed, m_keep):
    cols = topk_rmv_log(seed)
    jout, jn = jc.compact_topk_rmv_log(jc.TopkRmvLog(**{k: jnp.asarray(v) for k, v in cols.items()}), m_keep)
    pout, pn = pc.compact_topk_rmv_log(convert.from_numpy(pc.TopkRmvLog, cols, "cpu"), m_keep)
    assert same(pn, jn) and pn.dtype == torch.int32
    for name, got in convert.to_numpy(pout).items():
        assert same(got, getattr(jout, name)), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scalar_log_kernels_match_jax(seed):
    rng = np.random.default_rng(seed)
    L = 80
    key = rng.integers(-1, 4, L).astype(np.int32)
    # average: sums near 2^31 wrap in int32; num <= 0 is padding.
    val = rng.choice([1, -7, 2**30, I32_MAX], L).astype(np.int32)
    num = rng.integers(-1, 3, L).astype(np.int32)
    for got, want in zip(pc.compact_average_log(t(key), t(val), t(num)),
                         jc.compact_average_log(jnp.asarray(key), jnp.asarray(val), jnp.asarray(num))):
        assert same(got, want)
    id_ = rng.integers(0, 6, L).astype(np.int32)
    score = rng.choice([-1, 0, 5, 5, 80, I32_MAX, I32_MIN], L).astype(np.int32)
    for got, want in zip(pc.compact_topk_log(t(key), t(id_), t(score)),
                         jc.compact_topk_log(jnp.asarray(key), jnp.asarray(id_), jnp.asarray(score))):
        assert same(got, want)
    kind = rng.choice([0, 1, 2, 3, 5], L).astype(np.int32)
    for got, want in zip(pc.compact_leaderboard_log(t(kind), t(key), t(id_), t(score)),
                         jc.compact_leaderboard_log(*map(jnp.asarray, (kind, key, id_, score)))):
        assert same(got, want)
    tok = rng.integers(-2, 7, L).astype(np.int32)
    cnt = rng.choice([1, 2, I32_MAX], L).astype(np.int32)
    for got, want in zip(pc.compact_wordcount_log(t(key), t(tok), t(cnt)),
                         jc.compact_wordcount_log(*map(jnp.asarray, (key, tok, cnt)))):
        assert same(got, want)


# --- compact_effect_ops ---------------------------------------------------------


def effects(name, seed, n=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "topk_rmv":
            i = int(rng.integers(0, 6))
            if rng.random() < 0.3:
                vc = {int(d): int(rng.integers(1, 30)) for d in rng.choice(4, int(rng.integers(0, 3)), replace=False)}
                out.append((str(rng.choice(["rmv", "rmv_r"])), (i, vc)))
            else:
                out.append((str(rng.choice(["add", "add_r"])),
                            (i, int(rng.choice([1, 7, 7, I32_MIN])), (int(rng.integers(0, 4)), int(rng.integers(1, 30))))))
        elif name == "average":
            out.append(("add", int(rng.integers(-9, 9)) if rng.random() < 0.5
                        else (int(rng.integers(-9, 9)), int(rng.integers(-1, 3)))))
        elif name == "topk":
            out.append(("add", (int(rng.integers(0, 8)), int(rng.integers(0, 50)))))
        elif name == "leaderboard":
            p = int(rng.integers(0, 8))
            out.append(("ban", p) if rng.random() < 0.15
                       else (str(rng.choice(["add", "add_r"])), (p, int(rng.integers(0, 50)))))
        else:
            words = ["a", "b", "", "cc", "d d"]
            if rng.random() < 0.3:
                out.append(("add_counts", {str(rng.choice(words)): int(rng.integers(1, 4))}))
            else:
                out.append(("add", " ".join(rng.choice(words, int(rng.integers(1, 5))))))
    return out


NAMES = ["topk_rmv", "average", "topk", "leaderboard", "wordcount", "worddocumentcount"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_effect_ops_matches_jax(name, seed):
    effs = effects(name, seed)
    for m_keep in ((None, 2) if name == "topk_rmv" else (None,)):
        assert pc.compact_effect_ops(name, effs, m_keep, device="cpu") == jc.compact_effect_ops(name, effs, m_keep)
    assert pc.compact_effect_ops(name, [], device="cpu") == jc.compact_effect_ops(name, []) == []


def test_compact_effect_ops_refuses_unknown_types_and_kinds():
    with pytest.raises(ValueError, match="no whole-log compactor"):
        pc.compact_effect_ops("mystery", [("add", 1)], device="cpu")
    with pytest.raises(ValueError, match="bad topk_rmv effect kind"):
        pc.compact_effect_ops("topk_rmv", [("ban", 1)], device="cpu")


# --- batch coalescing -----------------------------------------------------------


def random_ops(seed, R=3, B=40, Br=8, D=3, I=6):
    """TopkRmvOps columns with INT32_MIN scores, ts ties, padding adds
    (ts <= 0) and padding removals (id < 0)."""
    rng = np.random.default_rng(seed)
    ts = rng.choice([0, -1, 3, 3, 9, 12], (R, B)).astype(np.int32)
    vc = rng.integers(0, 12, (R, Br, D)).astype(np.int32)
    return dict(
        add_key=rng.integers(0, 2, (R, B)).astype(np.int32),
        add_id=rng.integers(0, I, (R, B)).astype(np.int32),
        add_score=rng.choice([I32_MIN, 1, 4, 4, 99], (R, B)).astype(np.int32),
        add_dc=rng.integers(0, D, (R, B)).astype(np.int32),
        add_ts=ts,
        rmv_key=rng.integers(0, 2, (R, Br)).astype(np.int32),
        rmv_id=rng.integers(-1, I, (R, Br)).astype(np.int32),
        rmv_vc=vc,
    )


def jax_ops(cols):
    return jtkr.TopkRmvOps(**{k: jnp.asarray(v) for k, v in cols.items()})


@pytest.mark.parametrize("windows", [(None, None), (70, 20)])
def test_coalesce_topk_rmv_ops_matches_jax(windows):
    batches = [random_ops(s) for s in range(3)]
    out_adds, out_rmvs = windows
    if out_adds is None:
        out_adds, out_rmvs = 3 * 40, 3 * 8
    jo, jna, jnr = jc.coalesce_topk_rmv_ops([jax_ops(b) for b in batches], 3, 2, out_adds, out_rmvs)
    po, pna, pnr = pc.coalesce_topk_rmv_ops(
        [convert.from_numpy(TopkRmvOps, b, "cpu") for b in batches], 3, 2, out_adds, out_rmvs
    )
    assert same(pna, jna) and same(pnr, jnr)
    for name, got in convert.to_numpy(po).items():
        assert same(got, getattr(jo, name)), name


def engines(I, D, M=4, K=8):
    return jtkr.make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M), registry.make_dense(
        "topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")


def gens(seed, R, I, zipf_a=1.1):
    args = dict(n_replicas=R, n_ids=I, zipf_a=zipf_a, score_max=1000, seed=seed)
    return JaxGen(JaxWorkload(**args)), TopkRmvEffectGen(Workload(**args), device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_coalesce_ops_matches_sequential_apply_and_jax(seed):
    R, I, D = 3, 4096, 3
    jd, pd = engines(I, D)
    jg, pg = gens(seed, R, I, zipf_a=1.02)
    jb = [jg.next_batch(32, 6) for _ in range(3)]
    pb = [pg.next_batch(32, 6) for _ in range(3)]
    seq = pd.init(n_replicas=R)
    for ops in pb:
        seq, _ = pd.apply_ops(seq, ops, collect_dominated=False)
    fused, n_add, n_rmv = pd.coalesce_ops(pb)
    jfused, jn_add, jn_rmv = jd.coalesce_ops(jb)
    assert same(n_add, jn_add) and same(n_rmv, jn_rmv) and (n_add > 0).all()
    for name, got in convert.to_numpy(fused).items():
        assert same(got, getattr(jfused, name)), name
    one, _ = pd.apply_ops(pd.init(n_replicas=R), fused, collect_dominated=False)
    jone, _ = jd.apply_ops(jd.init(n_replicas=R), jfused, collect_dominated=False)
    for name, got in convert.to_numpy(one).items():
        assert same(got, getattr(jone, name)), name
    assert not bool(seq.lossy.any())
    for name in ("slot_score", "slot_ts", "slot_dc", "rmv_vc"):
        assert torch.equal(getattr(seq, name), getattr(one, name)), name
    assert pd.equal(seq, one)


def test_coalesce_window_overflow_raises():
    _, pd = engines(64, 3)
    _, pg = gens(2, 3, 64)
    with pytest.raises(ValueError, match="overflows"):
        pd.coalesce_ops([pg.next_batch(48, 8) for _ in range(3)], out_adds=4, out_rmvs=1)


def test_replay_apply_coalesced_and_stream_apply_match_jax():
    from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay

    R = 3
    jd, pd = engines(64, 3)
    jg, pg = gens(3, R, 64)
    jb = [jg.next_batch(48, 8) for _ in range(3)]
    pb = [pg.next_batch(48, 8) for _ in range(3)]

    raw = DenseReplay(pd, n_replicas=R)
    for ops in pb:
        raw.apply(ops)
    rp, jr = DenseReplay(pd, n_replicas=R), JaxReplay(jd, n_replicas=R)
    rp.apply_coalesced(pb)
    jr.apply_coalesced(jb)
    for name, got in convert.to_numpy(rp.state).items():
        assert same(got, getattr(jr.state, name)), name
    assert pd.equal(raw.state, rp.state)
    for c in ("coalesce_ops_in", "coalesce_ops_out"):
        assert rp.metrics.counters[c] == jr.metrics.counters[c]
    assert rp.metrics.counters["coalesce_ops_out"] < rp.metrics.counters["coalesce_ops_in"]

    # stream_apply(coalesce=2) over 3 batches: one fused pair + the partial
    # tail group, the same end state as JAX's and the same observable as
    # applying them in sequence.
    st, n = stream_apply(pd, pd.init(n_replicas=R), iter(pb), coalesce=2,
                         apply_kwargs=dict(collect_dominated=False))
    jst, jn = jax_stream_apply(jd, jd.init(n_replicas=R), iter(jb), coalesce=2,
                               apply_kwargs=dict(collect_dominated=False))
    assert n == jn == 3
    for name, got in convert.to_numpy(st).items():
        assert same(got, getattr(jst, name)), name
    assert pd.equal(raw.state, st)


def test_replay_without_capability_raises():
    from antidote_ccrdt_tpu_torch.models.average import AverageDense

    rp = DenseReplay(AverageDense(device="cpu"), n_replicas=2, n_keys=3)
    with pytest.raises(TypeError, match="coalesce"):
        rp.apply_coalesced([])


def test_prefetcher_forwards_producer_errors():
    def boom():
        yield 1
        raise RuntimeError("producer failed")

    with Prefetcher(boom(), depth=1) as pf:
        assert next(pf) == 1
        with pytest.raises(RuntimeError, match="producer failed"):
            next(pf)
    assert not pf._thread.is_alive()
