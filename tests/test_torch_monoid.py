"""The port's MONOID engines (AverageDense, WordcountDense), the host
vocabularies and DenseReplay's MONOID protocol against the JAX package's,
bit for bit on seeded inputs (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay
from antidote_ccrdt_tpu.models import average as jav
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.models import average as pav
from antidote_ccrdt_tpu_torch.models import wordcount as pwc

I32_MAX = np.iinfo(np.int32).max


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_state(port, jax_state):
    for name, got in convert.to_numpy(port).items():
        want = np.asarray(getattr(jax_state, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def avg_ops(rng, R, NK, B, big=False):
    """Keys in [-NK-1, NK+1) (negatives wrap, the far ones drop), count 0
    padding whose value must not leak, and values near 2^31 that wrap."""
    key = rng.integers(-NK - 1, NK + 1, (R, B)).astype(np.int32)
    value = (rng.choice([2**30, I32_MAX - 3, -(2**30)], (R, B)) if big
             else rng.integers(-50, 100, (R, B))).astype(np.int32)
    count = rng.integers(0, 3, (R, B)).astype(np.int32)
    return dict(key=key, value=value, count=count)


def jax_avg_ops(cols):
    return jav.AverageOps(**{k: jnp.asarray(v) for k, v in cols.items()})


@pytest.mark.parametrize("big", [False, True])
def test_average_dense_matches_jax(big):
    R, NK = 3, 5
    rng = np.random.default_rng(1 + big)
    jd, pd = jav.AverageDense(), registry.make_dense("average", device="cpu")
    js, ps = jd.init(R, NK), pd.init(R, NK)
    for _ in range(3):
        cols = avg_ops(rng, R, NK, 24, big)
        js, _ = jd.apply_ops(js, jax_avg_ops(cols))
        ps, _ = pd.apply_ops(ps, convert.from_numpy(pav.AverageOps, cols, "cpu"))
        assert_state(ps, js)
    js2 = jd.merge(js, js)
    ps2 = pd.merge(ps, ps)
    assert_state(ps2, js2)
    for p, j in ((ps, js), (ps2, js2)):
        got, want = pd.observe(p).numpy(), np.asarray(jd.observe(j))
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))  # the float32 bits


def word_ops(rng, R, NK, V, B):
    """Tokens >= V (lost), padding tokens < 0, and keys that wrap."""
    key = rng.integers(-NK, NK, (R, B)).astype(np.int32)
    token = rng.integers(-2, V + 3, (R, B)).astype(np.int32)
    return dict(key=key, token=token)


def test_wordcount_apply_ops_matches_jax():
    R, NK, V = 3, 2, 16
    rng = np.random.default_rng(4)
    jd, pd = jwc.make_dense(V), registry.make_dense("wordcount", n_buckets=V, device="cpu")
    js, ps = jd.init(R, NK), pd.init(R, NK)
    for _ in range(3):
        cols = word_ops(rng, R, NK, V, 40)
        js, _ = jd.apply_ops(js, jwc.WordcountOps(**{k: jnp.asarray(v) for k, v in cols.items()}))
        ps, _ = pd.apply_ops(ps, convert.from_numpy(pwc.WordcountOps, cols, "cpu"))
        assert_state(ps, js)
    assert int(ps.lost.sum()) > 0
    assert_state(pd.merge(ps, ps), jd.merge(js, js))
    assert pd.equal(ps, ps) and not pd.equal(ps, pd.init(R, NK))


def doc_records(rng, R, B, V, n_words=12):
    """Per-token records with duplicate words inside a document, distinct
    words that share a hashed bucket (uniq differs, token equal), keys that
    wrap and padding."""
    key = rng.integers(-1, 2, (R, B)).astype(np.int32)
    doc = np.sort(rng.integers(0, 6, (R, B)), axis=1).astype(np.int32)
    uniq = rng.integers(0, n_words, (R, B)).astype(np.int32)
    token = (uniq % (V // 2)).astype(np.int32)  # collisions: word w and w + V/2
    token[rng.random((R, B)) < 0.1] = -1
    token[rng.random((R, B)) < 0.05] = V + 1
    return dict(key=key, doc=doc, uniq=uniq, token=token)


def test_wordcount_apply_doc_ops_dedups_like_jax():
    R, NK, V = 2, 2, 8
    rng = np.random.default_rng(5)
    jd, pd = jwc.make_dense(V), registry.make_dense("worddocumentcount", n_buckets=V, device="cpu")
    js, ps = jd.init(R, NK), pd.init(R, NK)
    for _ in range(2):
        cols = doc_records(rng, R, 48, V)
        js, _ = jd.apply_doc_ops(js, jwc.WordDocOps(**{k: jnp.asarray(v) for k, v in cols.items()}))
        ps, _ = pd.apply_doc_ops(ps, convert.from_numpy(pwc.WordDocOps, cols, "cpu"))
        assert_state(ps, js)


@pytest.mark.parametrize("with_table", [False, True])
def test_wordcount_apply_doc_ops_compact_matches_jax(with_table):
    R, NK, V, B, DOCS = 3, 2, 16, 40, 6
    rng = np.random.default_rng(6 + with_table)
    jd, pd = jwc.make_dense(V), registry.make_dense("worddocumentcount", n_buckets=V, device="cpu")
    uniq = rng.integers(-1, 24, (R, B)).astype(np.int32)  # -1 and ids past the table
    doc_lens = rng.integers(0, 9, (R, DOCS)).astype(np.int32)  # empty documents too
    counts = rng.integers(0, B + 1, R).astype(np.int32)
    table = rng.integers(0, V, 20).astype(np.int32) if with_table else None
    js = jd.apply_doc_ops_compact(jd.init(R, NK), jnp.asarray(uniq), jnp.asarray(doc_lens), jnp.asarray(counts),
                                  None if table is None else jnp.asarray(table), key=1)[0]
    ps = pd.apply_doc_ops_compact(pd.init(R, NK), t(uniq), t(doc_lens), t(counts),
                                  None if table is None else t(table), key=1)[0]
    assert_state(ps, js)


def test_hashed_vocab_merge_report_and_audit_match_jax():
    words = ["alpha", "beta", "gamma", "delta", "", "beta", "épsilon", "zeta eta"]
    for V in (3, 7, 64):
        docs = [" ".join(words[i:i + 3]) for i in range(len(words))]
        pa, pb, ja, jb = pwc.HashedVocab(V), pwc.HashedVocab(V), jwc.HashedVocab(V), jwc.HashedVocab(V)
        for k, d in enumerate(docs):
            side = (pa, ja) if k % 2 else (pb, jb)
            assert side[0].encode(d, per_document=k % 3 == 0) == side[1].encode(d, per_document=k % 3 == 0)
        pa.merge(pb)
        ja.merge(jb)
        assert pa.report() == ja.report()
        counts = np.arange(V) % 3
        assert pa.decode_counts(counts) == ja.decode_counts(counts)
        assert pwc.vocab_collision_audit(words, V) == jwc.vocab_collision_audit(words, V)
        assert [pwc.hash_token(w, V) for w in words] == [jwc.hash_token(w, V) for w in words]
    ve, je = pwc.VocabEncoder(), jwc.VocabEncoder()
    assert ve.encode("a b a c", per_document=True) == je.encode("a b a c", per_document=True)
    assert ve.decode_counts([1, 0, 2]) == je.decode_counts([1, 0, 2])
    with pytest.raises(ValueError, match="bucket-count mismatch"):
        pwc.HashedVocab(3).merge(pwc.HashedVocab(4))


# --- DenseReplay, MONOID protocol -----------------------------------------------


def replay_pair(R, NK):
    return (JaxReplay(jav.AverageDense(), n_replicas=R, n_keys=NK),
            DenseReplay(registry.make_dense("average", device="cpu"), n_replicas=R, n_keys=NK))


def test_average_delta_exchange_matches_global_mean_and_jax():
    R, NK = 4, 6
    rng = np.random.default_rng(0)
    jr, pr = replay_pair(R, NK)
    all_sum, all_cnt = np.zeros(NK), np.zeros(NK)
    for _ in range(3):
        key = rng.integers(0, NK, (R, 8)).astype(np.int32)
        cols = dict(key=key, value=rng.integers(-50, 100, (R, 8)).astype(np.int32), count=np.ones((R, 8), np.int32))
        np.add.at(all_sum, key.ravel(), cols["value"].ravel())
        np.add.at(all_cnt, key.ravel(), 1)
        jr.apply(jax_avg_ops(cols))
        pr.apply(convert.from_numpy(pav.AverageOps, cols, "cpu"))
        jr.sync()
        pr.sync()
        assert_state(pr.base, jr.base)
        assert_state(pr.full_state(), jr.full_state())
    assert pr.converged()
    expected = np.where(all_cnt == 0, 0.0, all_sum / np.maximum(all_cnt, 1))
    np.testing.assert_allclose(pr.observe().numpy()[0], expected, rtol=1e-6)
    assert np.array_equal(pr.observe().numpy(), np.asarray(jr.observe()))


@pytest.mark.parametrize("contributors", [[0, 0, 1, 2], [], [2], None])
def test_monoid_sync_fault_surface_matches_jax(contributors):
    """A duplicated contribution double-counts, total loss drops the
    in-flight deltas and keeps the base: as the JAX replay does."""
    R, NK = 3, 4
    rng = np.random.default_rng(1)
    jr, pr = replay_pair(R, NK)
    for rnd in range(2):
        cols = avg_ops(rng, R, NK, 8)
        jr.apply(jax_avg_ops(cols))
        pr.apply(convert.from_numpy(pav.AverageOps, cols, "cpu"))
        if rnd == 0:
            jr.sync()
            pr.sync()
    jr.sync(contributors)
    pr.sync(contributors)
    assert_state(pr.state, jr.state)
    assert_state(pr.base, jr.base)
    assert np.array_equal(pr.observe().numpy(), np.asarray(jr.observe()))
    assert pr.converged() == jr.converged() and pr.converged(atol=1e-3) == jr.converged(atol=1e-3)
    assert pr.metrics.counters["syncs"] == 2


def test_duplicate_contribution_double_counts():
    R, NK = 3, 4
    rng = np.random.default_rng(1)
    cols = avg_ops(rng, R, NK, 8)
    honest, faulty = replay_pair(R, NK)[1], replay_pair(R, NK)[1]
    for rp in (honest, faulty):
        rp.apply(convert.from_numpy(pav.AverageOps, cols, "cpu"))
    honest.sync()
    faulty.sync(contributors=[0, 0, 1, 2])
    assert honest.converged() and faulty.converged()
    assert not torch.equal(honest.base.sum, faulty.base.sum)


def test_wordcount_replay_matches_jax():
    R, NK, V = 3, 2, 16
    rng = np.random.default_rng(8)
    jr = JaxReplay(jwc.make_dense(V), n_replicas=R, n_keys=NK)
    pr = DenseReplay(registry.make_dense("wordcount", n_buckets=V, device="cpu"), n_replicas=R, n_keys=NK)
    for rnd in range(4):
        cols = word_ops(rng, R, NK, V, 20)
        jr.apply(jwc.WordcountOps(**{k: jnp.asarray(v) for k, v in cols.items()}))
        pr.apply(convert.from_numpy(pwc.WordcountOps, cols, "cpu"))
        if rnd == 1:
            jr.sync([0, 0, 1])
            pr.sync([0, 0, 1])
    jr.sync()
    pr.sync()
    assert_state(pr.base, jr.base)
    assert_state(pr.full_state(), jr.full_state())
    assert pr.converged()
