"""The port's partition plane (``core/partition.py``) against the JAX
package's on states made from one seed: the id map, digest vectors (byte
for byte), psnaps and their application, the partitions a delta touches,
hot/cold delta splits, the CCPT blobs (byte-equal, each package decoding
the other's) and the digest sampler."""

import numpy as np
import pytest

from antidote_ccrdt_tpu.core import partition as jpt
from antidote_ccrdt_tpu.core import serial as jserial
from antidote_ccrdt_tpu.parallel import delta as jdelta
from antidote_ccrdt_tpu_torch.core import partition as ppt
from antidote_ccrdt_tpu_torch.core import serial as pserial
from antidote_ccrdt_tpu_torch.parallel import delta as pdelta
from torch_twins import assert_tree, leaderboard_pair, lifted_pair, topk_rmv_pair, wordcount_pair


@pytest.mark.parametrize("P", [1, 3, 8, 64])
def test_part_of_matches_jax(P):
    ids = np.concatenate([np.arange(500), np.random.default_rng(P).integers(0, 2**31 - 1, 500)])
    got, want = ppt.part_of(ids, P), jpt.part_of(ids, P)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert ppt.meta_part(P) == jpt.meta_part(P) == P


@pytest.mark.parametrize("env", [None, "5", "zero", "0"])
def test_n_partitions_reads_the_env_like_jax(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("CCRDT_PARTITIONS", raising=False)
    else:
        monkeypatch.setenv("CCRDT_PARTITIONS", env)
    assert ppt.n_partitions() == jpt.n_partitions()
    assert ppt.n_partitions(3) == jpt.n_partitions(3)


def states(kind):
    """(JAX engine, JAX state, port engine, port state) of one kind."""
    if kind == "topk_rmv":
        (jd, js), (pd, ps) = topk_rmv_pair(7)
        return jd, js[-1], pd, ps[-1]
    if kind == "leaderboard":
        (jd, js), (pd, ps) = leaderboard_pair(8)
        return jd, js, pd, ps
    if kind == "wordcount":
        (jd, js), (pd, ps) = wordcount_pair(9)
        return jd, js, pd, ps
    (jd, js), (pd, ps) = lifted_pair(10)
    return jd, js[-1], pd, ps[-1]


KINDS = ["topk_rmv", "leaderboard", "wordcount", "lifted"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", [1, 4, 8])
def test_state_digests_match_jax(kind, P):
    jd, js, pd, ps = states(kind)
    got, want = ppt.state_digests(ps, P), jpt.state_digests(js, P)
    assert got.dtype == want.dtype == np.uint32 and got.shape == (P + 1,)
    assert np.array_equal(got, want)
    assert ppt.digest_entries(ps, P, [P, 0]) == jpt.digest_entries(js, P, [P, 0])
    assert ppt.divergent_parts(got, want) == []


def test_a_change_in_one_partition_moves_only_its_digest():
    _jd, _js, _pd, ps = states("leaderboard")
    P = 8
    before = ppt.state_digests(ps, P)
    score = ps.best_score.clone()
    score[1, 0, 5] += 1
    after = ppt.state_digests(type(ps)(score, ps.banned), P)
    assert ppt.divergent_parts(before, after) == [int(ppt.part_of([5], P)[0])]
    assert ppt.divergent_parts(before, after[:-1]) == jpt.divergent_parts(before, after[:-1]) == list(range(P + 1))


@pytest.mark.parametrize("kind", ["topk_rmv", "leaderboard", "lifted"])
def test_psnaps_match_jax_and_repair_a_lagging_state(kind):
    """Every partition's psnap (the meta one included) equals JAX's leaf
    for leaf and as dumps_dense bytes; applying all of them to a lagging
    state gives JAX's result, which is the join of the two states."""
    P = 4
    if kind == "topk_rmv":
        (jd, js), (pd, ps) = topk_rmv_pair(11)
        jlag, jlive, plag, plive = js[0], js[-1], ps[0], ps[-1]
    elif kind == "lifted":
        (jd, js), (pd, ps) = lifted_pair(12)
        jlag, jlive, plag, plive = js[1], js[-1], ps[1], ps[-1]
    else:
        (jd, jlive), (pd, plive) = leaderboard_pair(13)
        (_, jlag), (_, plag) = leaderboard_pair(14)
    jfix, pfix = jlag, plag
    for part in range(P + 1):
        jp, pp = jpt.restrict_psnap(jd, jlive, part, P), ppt.restrict_psnap(pd, plive, part, P)
        assert_tree(pp, jp)
        name = f"{kind}_psnap"
        assert pserial.dumps_dense(name, pp) == jserial.dumps_dense(name, jp)
        jfix, pfix = jpt.apply_psnap(jd, jfix, jp), ppt.apply_psnap(pd, pfix, pp)
        assert_tree(pfix, jfix)
    assert_tree(pfix, pd.merge(plag, plive))
    assert np.array_equal(ppt.state_digests(pfix, P), ppt.state_digests(pd.merge(plag, plive), P))


def test_psnap_of_a_bare_monoid_engine_raises_like_jax():
    (jd, js), (pd, ps) = wordcount_pair(15)
    with pytest.raises(ValueError, match="unsound"):
        ppt.restrict_psnap(pd, ps, 0, 4)
    with pytest.raises(ValueError, match="unsound"):
        jpt.restrict_psnap(jd, js, 0, 4)


def deltas(kind):
    """(JAX engine, like, delta, port engine, like, delta, prev states)."""
    if kind == "topk_rmv":
        (jd, js), (pd, ps) = topk_rmv_pair(16)
        return jd, js[-1], jdelta.make_delta(jd, js[0], js[-1]), pd, ps[-1], pdelta.make_delta(pd, ps[0], ps[-1]), (js[0], ps[0])
    if kind == "lifted":
        (jd, js), (pd, ps) = lifted_pair(17)
        return jd, js[-1], jdelta.make_delta(jd, js[0], js[-1]), pd, ps[-1], pdelta.make_delta(pd, ps[0], ps[-1]), (js[0], ps[0])
    (jd, js), (pd, ps) = leaderboard_pair(18)
    (_, jprev), (_, pprev) = leaderboard_pair(19)
    jprev, pprev = jd.merge(jprev, jd.init(2, 2)), pd.merge(pprev, pd.init(2, 2))
    jcur, pcur = jd.merge(jprev, js), pd.merge(pprev, ps)
    return jd, jcur, jdelta.make_delta(jd, jprev, jcur), pd, pcur, pdelta.make_delta(pd, pprev, pcur), (jprev, pprev)


@pytest.mark.parametrize("kind", ["topk_rmv", "leaderboard", "lifted"])
@pytest.mark.parametrize("P", [3, 8])
def test_delta_parts_match_jax(kind, P):
    jd, jlike, jdl, pd, plike, pdl, _ = deltas(kind)
    got = ppt.delta_parts(pd, plike, pdl, P)
    assert got == jpt.delta_parts(jd, jlike, jdl, P)
    assert got


@pytest.mark.parametrize("kind", ["topk_rmv", "leaderboard"])
@pytest.mark.parametrize("cold", [[], [0], [1, 2], [0, 1, 2, 3]])
def test_split_delta_matches_jax_and_hot_join_cold_is_the_delta(kind, cold):
    P = 4
    jd, jlike, jdl, pd, plike, pdl, (jprev, pprev) = deltas(kind)
    phot, pcold = ppt.split_delta(pd, plike, pdl, P, cold)
    jhot, jcold = jpt.split_delta(jd, jlike, jdl, P, cold)
    assert_tree(phot, jhot)
    if jcold is None:
        assert pcold is None
    else:
        assert_tree(pcold, jcold)
    whole = pdelta.apply_any_delta(pd, pprev, pdl)
    halves = pdelta.apply_any_delta(pd, pprev, phot)
    if pcold is not None:
        halves = pdelta.apply_any_delta(pd, halves, pcold)
    assert_tree(halves, jdelta.apply_any_delta(jd, jprev, jdl))
    assert_tree(whole, jdelta.apply_any_delta(jd, jprev, jdl))


def test_split_of_a_lifted_row_delta_raises_like_jax():
    jd, jlike, jdl, pd, plike, pdl, _ = deltas("lifted")
    with pytest.raises(ValueError, match="lifted"):
        ppt.split_delta(pd, plike, pdl, 4, [0])
    with pytest.raises(ValueError, match="lifted"):
        jpt.split_delta(jd, jlike, jdl, 4, [0])


def test_ccpt_blobs_are_byte_equal_and_cross_decode():
    jd, js, pd, ps = states("topk_rmv")
    P = 8
    vec = ppt.state_digests(ps, P)
    blob = ppt.encode_digest_blob(42, vec)
    assert blob == jpt.encode_digest_blob(42, jpt.state_digests(js, P))
    for dec in (ppt.decode_digest_blob, jpt.decode_digest_blob):
        seq, got = dec(blob)
        assert seq == 42 and np.array_equal(got, vec)
    for part in (0, P):
        payload = pserial.dumps_dense("topk_rmv_psnap", ppt.restrict_psnap(pd, ps, part, P))
        pblob = ppt.encode_psnap_blob(7, part, payload)
        jblob = jpt.encode_psnap_blob(7, part, jserial.dumps_dense("topk_rmv_psnap", jpt.restrict_psnap(jd, js, part, P)))
        assert pblob == jblob and ppt.is_partition_blob(pblob)
        assert ppt.decode_psnap_blob(jblob) == jpt.decode_psnap_blob(pblob) == (7, part, payload)
    raw = ppt.encode_psnap_blob(1, 2, b"x")  # too small to deflate: version 1
    assert raw[4] == 1 and jpt.decode_psnap_blob(raw) == (1, 2, b"x")
    with pytest.raises(ValueError, match="kind"):
        ppt.decode_digest_blob(pblob)
    with pytest.raises(ValueError, match="magic"):
        ppt.decode_psnap_blob(b"CCRDxxxxxxxxxxxxxxxxxx")
    with pytest.raises(ValueError, match="newer"):
        ppt.decode_psnap_blob(b"CCPT\x09\x01" + bytes(12))


def test_digest_sampler_memoizes_by_seq_and_rate_limits_like_jax():
    jd, js, pd, ps = states("leaderboard")
    now = [0.0]
    ps_, js_ = ppt.DigestSampler(4, 1.0, mono=lambda: now[0]), jpt.DigestSampler(4, 1.0, mono=lambda: now[0])
    for seq, dt in ((1, 0.0), (1, 5.0), (2, 0.0), (None, 0.1), (None, 0.5), (None, 2.0)):
        now[0] += dt
        assert np.array_equal(ps_.sample(ps, seq), js_.sample(js, seq))
        assert ps_.computes == js_.computes
    assert ps_.computes == 3
    ps_.invalidate()
    ps_.sample(ps, 2)
    assert ps_.computes == 4
