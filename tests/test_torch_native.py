"""The port's native host and tokenizer bindings (``harness/native_host.py``,
``harness/native_tokenizer.py``) against the JAX package's. Both bind the
same C++ sources; the port builds them into its own ``build/`` at first
use, and a build that fails fails these tests.

* Every case of ``tests/test_native_host.py`` and
  ``tests/test_native_tokenizer.py`` runs again through the port, with the
  dense ops put on the CPU.
* Drains from the same submissions equal JAX's batch for batch, the
  overflow carry and the zero-capacity error included; tokenizer arrays
  equal JAX's at 1 and 4 threads; one FNV-1a in the port, equal to JAX's.
* The demo flow of ``scripts/end_to_end_demo.py`` at the sizes of
  ``tests/test_end_to_end.py``: every replica equals the scalar engine fed
  the same delivered stream, and the dense state equals JAX's run of the
  same drains after every round.

The JAX bindings used here load libraries built by this module's own
fixture into a private directory, never ``native/build/``, which other
test processes may be writing at the same moment.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from antidote_ccrdt_tpu.harness import native_host as jnh
from antidote_ccrdt_tpu.harness import native_tokenizer as jnt
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu_torch import registry
from antidote_ccrdt_tpu_torch.harness import native_host as pnh
from antidote_ccrdt_tpu_torch.harness import native_tokenizer as pnt
from antidote_ccrdt_tpu_torch.models import wordcount as pwc
from antidote_ccrdt_tpu_torch.models.topk_rmv import TopkRmvScalar
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
from antidote_ccrdt_tpu_torch.ops import _build
from torch_twins import assert_tree, build_native_libraries, port_copy


@pytest.fixture(scope="module", autouse=True)
def jax_native_private(tmp_path_factory):
    """Point the JAX package's native host and tokenizer bindings at
    libraries built for this process alone (no Makefile there, so the
    tokenizer's ``make`` is skipped), from a clean load; restore every
    name at teardown, so a JAX test file run later on the same worker
    sees its bindings as they were. A failed g++ errors the tests."""
    out = tmp_path_factory.mktemp("jax_native")
    libs = build_native_libraries(str(out))
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jnh, "ccrdt_host"), (jnt, "ccrdt_tokenizer")):
            mp.setattr(mod, "_NATIVE_DIR", str(out))
            mp.setattr(mod, "_LIB_PATH", libs[name])
            mp.setattr(mod, "_lib", None)
            mp.setattr(mod, "_build_error", None)
        yield libs

# The JAX files skip when the toolchain is missing; here a failed build
# fails the test.
_FAIL_ON_BUILD_ERROR = ('pytest.skip("native toolchain unavailable")', "pytest.fail(build_error())")
globals().update(port_copy("test_native_host.py", replace=[
    ('pytestmark = pytest.mark.skipif(\n    not nh.available(), reason=f"native host unavailable: {nh.build_error()}"\n)',
     "build_error = nh.build_error"),
    _FAIL_ON_BUILD_ERROR,
    ("batch_rmvs=8)", 'batch_rmvs=8, device="cpu")'),
    ("batch_rmvs=4)", 'batch_rmvs=4, device="cpu")'),
    ("batch_rmvs=0)", 'batch_rmvs=0, device="cpu")'),
    ("slots_per_id=4)", 'slots_per_id=4, device="cpu")'),
]))
globals().update(port_copy("test_native_tokenizer.py", replace=[
    ('pytestmark = pytest.mark.skipif(\n    not nt.available(), reason=f"native toolchain unavailable: {nt.build_error()}"\n)',
     "build_error = nt.build_error"),
    _FAIL_ON_BUILD_ERROR,
    ("n_buckets=V)", 'n_buckets=V, device="cpu")'),
    ("make_dense(V)", 'make_dense(V, device="cpu")'),
    ("jax.device_get(state.counts)", "state.counts"),
]))


def test_native_libraries_build_into_the_package():
    assert pnh.available(), pnh.build_error()
    assert pnt.available(), pnt.build_error()
    assert pnh.build_error() is None and pnt.build_error() is None
    for name in ("ccrdt_host", "ccrdt_tokenizer"):
        assert (_build.BUILD_DIR / f"lib{name}.so").exists()


def test_jax_bindings_load_the_private_build(jax_native_private):
    """The JAX bindings this module compares with load this process's own
    libraries, never a ``native/build/`` file another process may be
    writing."""
    for mod, name in ((jnh, "ccrdt_host"), (jnt, "ccrdt_tokenizer")):
        assert mod.available(), mod.build_error()
        assert mod._ensure_lib()._name == jax_native_private[name] == mod._LIB_PATH
        assert not os.path.exists(os.path.join(mod._NATIVE_DIR, "Makefile"))


def submit_same(hosts, seed, D, n_ops, rmv_frac):
    """Seeded submissions, identical at every host: batches of adds and
    single removals carrying each origin's vc."""
    rng = np.random.default_rng(seed)
    for origin in range(D):
        n = int(rng.integers(n_ops // 2, n_ops + 1))
        kinds = np.where(rng.random(n) < rmv_frac, jnh.KIND_RMV, jnh.KIND_ADD).astype(np.int32)
        ids = rng.integers(0, 40, n)
        scores = rng.integers(1, 1000, n)
        adds = kinds == jnh.KIND_ADD
        for h in hosts:
            h.submit_batch(origin, kinds[adds], np.zeros(adds.sum()), ids[adds], scores[adds])
        for i in np.flatnonzero(~adds):
            vc = rng.integers(0, 20, D).astype(np.int32)
            for h in hosts:
                assert h.submit(origin, jnh.KIND_RMV, 0, int(ids[i]), vc=vc) > 0


def assert_ops(port_ops, jax_ops):
    for f in TopkRmvOps.__dataclass_fields__:
        got, want = getattr(port_ops, f).numpy(), np.asarray(getattr(jax_ops, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("caps", [(64, 16), (8, 2), (5, 1)])
def test_drains_match_jax_batch_for_batch(caps):
    """Small capacities force the add/rmv split to overflow: the carry and
    its delivery order must match JAX's on every call."""
    D = 3
    with pnh.NativeHost(D) as ph, jnh.NativeHost(D) as jh:
        submit_same([ph, jh], 4, D, 30, 0.3)
        for _round in range(40):
            for r in range(D):
                (po, pa, pr), (jo, ja, jr) = ph.drain_topk_rmv_ops(r, *caps, device="cpu"), jh.drain_topk_rmv_ops(r, *caps)
                assert (pa, pr) == (ja, jr)
                assert_ops(po, jo)
                assert ph.backlog(r) == jh.backlog(r)
            if all(ph.backlog(r) == 0 for r in range(D)):
                break
        assert all(ph.backlog(r) == 0 for r in range(D))
        assert ph.stats() == jh.stats()
        raw_p, raw_j = ph.drain(0, 10), jh.drain(0, 10)
        assert raw_p.keys() == raw_j.keys() and all(np.array_equal(raw_p[k], raw_j[k]) for k in raw_p)


def test_zero_capacity_error_and_carry_match_jax():
    with pnh.NativeHost(2) as ph, jnh.NativeHost(2) as jh:
        submit_same([ph, jh], 5, 2, 10, 0.5)
        for caps in ((4, 0), (0, 4)):
            with pytest.raises(ValueError) as pe:
                ph.drain_topk_rmv_ops(0, *caps, device="cpu")
            with pytest.raises(ValueError) as je:
                jh.drain_topk_rmv_ops(0, *caps)
            assert str(pe.value) == str(je.value) and "zero-capacity" in str(pe.value)
            assert ph.backlog(0) == jh.backlog(0) > 0
        (po, pa, pr), (jo, ja, jr) = ph.drain_topk_rmv_ops(0, 32, 32, device="cpu"), jh.drain_topk_rmv_ops(0, 32, 32)
        assert (pa, pr) == (ja, jr) and pa > 0 and pr > 0
        assert_ops(po, jo)
        assert ph.backlog(0) == jh.backlog(0) == 0


DOCS = ["the quick brown fox", "the  quick\nfox", "", "a a a b", "unicode été café café", " x ", "b a b a"]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("buckets", [0, 97, 1 << 16])
@pytest.mark.parametrize("per_document", [False, True])
def test_tokenizer_arrays_match_jax(threads, buckets, per_document):
    rng = np.random.default_rng(threads + buckets)
    docs = DOCS + [" ".join(f"w{t}" for t in rng.integers(0, 300, rng.integers(0, 40))) for _ in range(60)]
    pt_, jt_ = pnt.NativeTokenizer(buckets), jnt.NativeTokenizer(buckets)
    for chunk in (docs[:30], docs[30:]):
        (pi, pe), (ji, je) = pt_.encode_batch(chunk, per_document, threads), jt_.encode_batch(chunk, per_document, threads)
        assert pi.dtype == ji.dtype and pe.dtype == je.dtype
        assert np.array_equal(pi, ji) and np.array_equal(pe, je)
    assert pt_.vocab_size() == jt_.vocab_size()
    if buckets == 0:
        assert pt_.vocab() == jt_.vocab()


def test_doc_loaders_match_jax():
    rng = np.random.default_rng(3)
    per_replica = [[" ".join(f"w{t}" for t in rng.integers(0, 50, 12)) for _ in range(5)] for _ in range(3)]
    for per_doc in (False, True):
        got = pnt.wordcount_ops_from_docs(per_replica, 64, per_document=per_doc, key=1, device="cpu")
        want = jnt.wordcount_ops_from_docs(per_replica, 64, per_document=per_doc, key=1)
        assert np.array_equal(got.key.numpy(), np.asarray(want.key))
        assert np.array_equal(got.token.numpy(), np.asarray(want.token))
    got, want = pnt.worddoc_ops_from_docs(per_replica, 64, device="cpu"), jnt.worddoc_ops_from_docs(per_replica, 64)
    for f in ("key", "doc", "uniq", "token"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f
    got, want = pnt.worddoc_compact_arrays_from_docs(per_replica, 64), jnt.worddoc_compact_arrays_from_docs(per_replica, 64)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in got)


def test_one_fnv1a_in_the_port_equal_to_jax():
    assert pnt.fnv1a_buckets is pwc.fnv1a_buckets
    rng = np.random.default_rng(0)
    words = ["", "a", "été", "café", "word-with-longer-text", "日本語"] + [
        "w" + str(rng.integers(0, 10**9)) for _ in range(300)]
    for V in (1, 7, 1024, 1 << 16):
        got = pwc.fnv1a_buckets(words, V)
        assert got.dtype == np.int32
        assert np.array_equal(got, jnt.fnv1a_buckets(words, V))
        assert got.tolist() == [jwc.hash_token(w, V) for w in words] == [pwc.hash_token(w, V) for w in words]
    assert pwc.fnv1a_buckets([], 8).shape == (0,)


def test_demo_flow_matches_the_scalar_engine_and_jax():
    """scripts/end_to_end_demo.py's flow through the port at the sizes of
    tests/test_end_to_end.py: the same submissions go to a port host and a
    JAX host; each replica drains, the port's batch equals JAX's, both
    engines apply the stacked round, and the states agree after every
    round."""
    _demo_flow(None, resume=False)


def test_demo_flow_resumes_from_a_checkpoint_like_jax(tmp_path):
    """The same flow with the demo's mid-stream crash and resume
    (``scripts/end_to_end_demo.py:116-124``): after round rounds // 2 each
    package saves its state (the port through its DCP-backed
    ``harness.orbax_ckpt``, JAX through Orbax), drops it and restores it
    into zeros; the restored states are equal and the flow goes on from
    them to equal states (test_end_to_end.py's ``resumed``)."""
    _demo_flow(tmp_path, resume=True)


def _demo_flow(tmp_path, resume):
    import torch

    from jax.tree_util import tree_map as jax_tree_map

    from antidote_ccrdt_tpu.harness import orbax_ckpt as jck
    from antidote_ccrdt_tpu_torch.harness import orbax_ckpt as pck
    from antidote_ccrdt_tpu_torch.utils.tree import tree_map

    n_dcs, n_ids, k, m, rounds, adds, rmvs = 3, 128, 8, 8, 3, 40, 6
    rng = np.random.default_rng(0)
    pd = registry.make_dense("topk_rmv", n_ids=n_ids, n_dcs=n_dcs, size=k, slots_per_id=m, device="cpu")
    jd = jtkr.make_dense(n_ids=n_ids, n_dcs=n_dcs, size=k, slots_per_id=m)
    pstate, jstate = pd.init(n_dcs, 1), jd.init(n_dcs, 1)
    scalar_engine = TopkRmvScalar()
    scalar = [scalar_engine.new(k) for _ in range(n_dcs)]
    frontiers = np.zeros((n_dcs, n_dcs), np.int32)
    B, Br = 2 * n_dcs * adds, 2 * n_dcs * rmvs
    submitted = delivered = 0
    resumed = False
    with pnh.NativeHost(n_dcs) as ph, jnh.NativeHost(n_dcs) as jh:
        for rnd in range(rounds):
            for origin in range(n_dcs):
                na = int(rng.integers(adds // 2, adds + 1))
                ids, scores = rng.integers(0, n_ids, na), rng.integers(1, 10_000, na)
                for h in (ph, jh):
                    h.submit_batch(origin, np.full(na, pnh.KIND_ADD, np.int32), np.zeros(na, np.int32), ids, scores)
                nr = int(rng.integers(0, rmvs + 1))
                for id_ in rng.integers(0, n_ids, nr):
                    for h in (ph, jh):
                        h.submit(origin, pnh.KIND_RMV, 0, int(id_), vc=frontiers[origin])
                submitted += na + nr
            pbatches, jbatches = [], []
            for r in range(n_dcs):
                po, na, nr = ph.drain_topk_rmv_ops(r, B, Br, device="cpu")
                jo, ja, jr = jh.drain_topk_rmv_ops(r, B, Br)
                assert (na, nr) == (ja, jr)
                assert_ops(po, jo)
                delivered += na + nr
                pbatches.append(po)
                jbatches.append(jo)
                o = {f: getattr(po, f)[0].numpy() for f in TopkRmvOps.__dataclass_fields__}
                for j in np.flatnonzero(o["add_ts"] > 0):
                    dc, ts = int(o["add_dc"][j]), int(o["add_ts"][j])
                    eff = ("add", (int(o["add_id"][j]), int(o["add_score"][j]), (dc, ts)))
                    scalar[r], _ = scalar_engine.update(eff, scalar[r])
                    frontiers[r, dc] = max(frontiers[r, dc], ts)
                for j in np.flatnonzero(o["rmv_id"] >= 0):
                    vc = {d: int(v) for d, v in enumerate(o["rmv_vc"][j]) if v}
                    scalar[r], _ = scalar_engine.update(("rmv", (int(o["rmv_id"][j]), vc)), scalar[r])
            pops = TopkRmvOps(*[torch.cat([getattr(b, f) for b in pbatches]) for f in TopkRmvOps.__dataclass_fields__])
            jops = jtkr.TopkRmvOps(*[jnp.concatenate([getattr(b, f) for b in jbatches])
                                     for f in TopkRmvOps.__dataclass_fields__])
            pstate = pd.apply_ops(pstate, pops, collect_dominated=False)[0]
            jstate = jd.apply_ops(jstate, jops, collect_dominated=False)[0]
            assert_tree(pstate, jstate)
            if resume and rnd == rounds // 2:
                with pck.DenseCheckpointManager(str(tmp_path / "port")) as pm, \
                        jck.DenseCheckpointManager(str(tmp_path / "jax")) as jm:
                    pm.save(rnd, pstate)
                    jm.save(rnd, jstate)
                    pstate = jstate = None  # "crash"
                    pstate = pm.restore(tree_map(torch.zeros_like, pd.init(n_dcs, 1)))
                    jstate = jm.restore(jax_tree_map(jnp.zeros_like, jd.init(n_dcs, 1)))
                assert_tree(pstate, jstate)
                resumed = True
        assert [ph.backlog(r) for r in range(n_dcs)] == [0] * n_dcs
        assert delivered == submitted * n_dcs == ph.stats()["delivered"]
    assert not bool(pstate.lossy.any())
    for r in range(n_dcs):
        assert set(pd.value(pstate)[r][0]) == set(scalar_engine.value(scalar[r]))
    acc = jax_acc = None
    for r in range(n_dcs):
        row = type(pstate)(**{f: getattr(pstate, f)[r:r + 1] for f in pstate.__dataclass_fields__})
        acc = row if acc is None else pd.merge(acc, row)
    jrows = [jtkr.TopkRmvDenseState(**{f: getattr(jstate, f)[r:r + 1] for f in jstate.__dataclass_fields__})
             for r in range(n_dcs)]
    for row in jrows:
        jax_acc = row if jax_acc is None else jd.merge(jax_acc, row)
    assert_tree(acc, jax_acc)
    assert len(pd.value(acc)[0][0]) == k
    assert resumed == resume
