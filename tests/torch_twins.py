"""Shared helpers of the host-path differential tests: states made from
one seed in both packages, and exact comparisons between them."""

import dataclasses
import os
import subprocess

import numpy as np
import torch

import jax.numpy as jnp

from antidote_ccrdt_tpu.harness.dense_replay import DenseReplay as JaxReplay
from antidote_ccrdt_tpu.harness.opgen import TopkRmvEffectGen as JaxGen
from antidote_ccrdt_tpu.harness.opgen import Workload as JaxWorkload
from antidote_ccrdt_tpu.models import average as jav
from antidote_ccrdt_tpu.models import leaderboard as jlb
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtkr
from antidote_ccrdt_tpu.models import wordcount as jwc
from antidote_ccrdt_tpu.parallel import delta as jdelta
from antidote_ccrdt_tpu.parallel import monoid as jmon
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.harness.dense_replay import DenseReplay
from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
from antidote_ccrdt_tpu_torch.models import average as pav
from antidote_ccrdt_tpu_torch.models import leaderboard as plb
from antidote_ccrdt_tpu_torch.models import wordcount as pwc
from antidote_ccrdt_tpu_torch.parallel import monoid as pmon

NEG_INF = -(2**31 - 1)


def assert_tree(port, jax_value, path="root"):
    """The same structure, dict keys, shapes, dtypes and values."""
    if isinstance(port, dict):
        assert isinstance(jax_value, dict) and sorted(port) == sorted(jax_value), path
        for k in port:
            assert_tree(port[k], jax_value[k], f"{path}[{k!r}]")
    elif dataclasses.is_dataclass(port):
        assert type(port).__name__ == type(jax_value).__name__, path
        for f in dataclasses.fields(port):
            assert_tree(getattr(port, f.name), getattr(jax_value, f.name), f"{path}.{f.name}")
    elif isinstance(port, torch.Tensor):
        got, want = port.cpu().numpy(), np.asarray(jax_value)
        assert got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want), path
    else:
        assert port == jax_value, path


TWINS = {
    "AverageState": jav.AverageState, "WordcountDenseState": jwc.WordcountDenseState,
    "TopkRmvDenseState": jtkr.TopkRmvDenseState, "LiftedMonoidState": jmon.LiftedMonoidState,
    "TopkRmvDelta": jdelta.TopkRmvDelta, "LeaderboardDenseState": jlb.LeaderboardDenseState,
}


def to_jax(port):
    """A port state (dataclass or dict of tensors, nested) as the JAX
    package's twin."""
    if isinstance(port, dict):
        return {k: to_jax(v) for k, v in port.items()}
    if isinstance(port, torch.Tensor):
        return jnp.asarray(port.cpu().numpy())
    return TWINS[type(port).__name__](**{
        f.name: (to_jax(getattr(port, f.name)) if not f.metadata.get("static") else getattr(port, f.name))
        for f in dataclasses.fields(port)
    })


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def topk_rmv_pair(seed, R=3, I=64, D=3, M=4, K=8, rounds=3):
    """Engines and [state after each round] of a JAX replay and a port
    replay fed the same seeded effect ops (a sync after round 1)."""
    args = dict(n_replicas=R, n_ids=I, zipf_a=1.2, score_max=500, seed=seed)
    jd = jtkr.make_dense(n_ids=I, n_dcs=D, size=K, slots_per_id=M)
    pd = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, size=K, slots_per_id=M, device="cpu")
    jg, pg = JaxGen(JaxWorkload(**args)), TopkRmvEffectGen(Workload(**args), device="cpu")
    jr, pr = JaxReplay(jd, R), DenseReplay(pd, R)
    js, ps = [], []
    for k in range(rounds):
        jr.apply(jg.next_batch(12, 3))
        pr.apply(pg.next_batch(12, 3))
        if k == 1:
            jr.sync()
            pr.sync()
        js.append(jr.state)
        ps.append(pr.state)
    return (jd, js), (pd, ps)


def leaderboard_pair(seed, R=2, NK=2, P=40, K=5):
    """Engines and a seeded leaderboard state in both packages."""
    rng = np.random.default_rng(seed)
    score = rng.integers(-50, 500, (R, NK, P)).astype(np.int32)
    score[rng.random((R, NK, P)) < 0.4] = NEG_INF
    banned = rng.random((R, NK, P)) < 0.2
    jd, pd = jlb.make_dense(P, K), plb.make_dense(P, K, device="cpu")
    return (jd, jlb.LeaderboardDenseState(jnp.asarray(score), jnp.asarray(banned))), (
        pd, plb.LeaderboardDenseState(t(score), t(banned)))


def wordcount_pair(seed, R=2, NK=2, V=16):
    jd, pd = jwc.make_dense(V), registry.make_dense("wordcount", n_buckets=V, device="cpu")
    rng = np.random.default_rng(seed)
    cols = dict(key=rng.integers(0, NK, (R, 30)).astype(np.int32),
                token=rng.integers(-1, V, (R, 30)).astype(np.int32))
    js = jd.apply_ops(jd.init(R, NK), jwc.WordcountOps(**{k: jnp.asarray(v) for k, v in cols.items()}))[0]
    ps = pd.apply_ops(pd.init(R, NK), convert.from_numpy(pwc.WordcountOps, cols, "cpu"))[0]
    return (jd, js), (pd, ps)


def lifted_pair(seed, R=5, NK=2, steps=4):
    """MonoidLift(average) engines and [state after each step]; step k
    writes only row k % R (the lift's single-writer contract)."""
    jl, pl = jmon.MonoidLift(jav.AverageDense()), pmon.MonoidLift(registry.make_dense("average", device="cpu"))
    rng = np.random.default_rng(seed)
    js, ps = [jl.init(R, NK)], [pl.init(R, NK)]
    for k in range(steps):
        cols = dict(key=rng.integers(0, NK, (R, 6)).astype(np.int32),
                    value=rng.integers(-20, 40, (R, 6)).astype(np.int32),
                    count=rng.integers(1, 3, (R, 6)).astype(np.int32))
        cols["count"][np.arange(R) != k % R] = 0
        js.append(jl.apply_ops(js[-1], jav.AverageOps(**{n: jnp.asarray(v) for n, v in cols.items()}),
                               owned=[k % R])[0])
        ps.append(pl.apply_ops(ps[-1], convert.from_numpy(pav.AverageOps, cols, "cpu"), owned=[k % R])[0])
    return (jl, js), (pl, ps)


# --- elastic-worker drills (the API of scripts/elastic_demo.DRILLS) ---------------

# scripts/elastic_demo.py's geometry (R, I, DCS, K, M, B, Br, NK_MONOID, V).
DR, DI, DDCS, DK, DM, DB, DBR, DNK_MONOID, DV = 4, 64, 4, 8, 2, 32, 8, 2, 32


class TopkRmvDrill:
    """A deterministic topk_rmv op stream per (step, replica) for one
    package (``"jax"`` or ``"torch"``): the same ops in both, so a log
    written by one package can be recovered by the other."""

    name = publish_name = "topk_rmv"

    def __init__(self, pkg="torch"):
        self.pkg = pkg

    def pub_state(self, dense, state):
        return state

    def set_view(self, dense, state, swept):
        return swept

    def make_engine(self):
        if self.pkg == "jax":
            return jtkr.make_dense(n_ids=DI, n_dcs=DDCS, size=DK, slots_per_id=DM)
        return registry.make_dense("topk_rmv", n_ids=DI, n_dcs=DDCS, size=DK, slots_per_id=DM, device="cpu")

    def init(self, dense):
        return dense.init(DR, 1)

    def gen_ops(self, step, owned):
        owned = set(owned)
        cols = dict(
            add_key=np.zeros((DR, DB), np.int32), add_id=np.zeros((DR, DB), np.int32),
            add_score=np.zeros((DR, DB), np.int32), add_dc=np.zeros((DR, DB), np.int32),
            add_ts=np.zeros((DR, DB), np.int32), rmv_key=np.zeros((DR, DBR), np.int32),
            rmv_id=np.full((DR, DBR), -1, np.int32), rmv_vc=np.zeros((DR, DBR, DDCS), np.int32),
        )
        for r in range(DR):
            rng = np.random.default_rng(10_000 * (step + 1) + r)
            ids, scores = rng.integers(0, DI, DB), rng.integers(1, 500, DB)
            if r in owned:
                cols["add_id"][r], cols["add_score"][r] = ids, scores
                cols["add_dc"][r] = r % DDCS
                cols["add_ts"][r] = step * DB + np.arange(DB) + 1
                cols["rmv_id"][r] = rng.integers(0, DI, DBR)
                cols["rmv_vc"][r, :, r % DDCS] = rng.integers(1, max(2, step * DB + 1), DBR)
        if self.pkg == "jax":
            return jtkr.TopkRmvOps(**{k: jnp.asarray(v) for k, v in cols.items()})
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        return convert.from_numpy(TopkRmvOps, cols, "cpu")

    def apply(self, dense, state, step, owned):
        return dense.apply_ops(state, self.gen_ops(step, owned), collect_dominated=False)[0]

    def digest(self, dense, state):
        return leaf_bytes(self.pub_state(dense, state))


class AverageDrill:
    """The lifted average drill: a MonoidContributor per worker."""

    name = "average"
    publish_name = "average_lifted"

    def __init__(self, pkg="torch"):
        self.pkg = pkg

    def make_engine(self):
        if self.pkg == "jax":
            return jmon.MonoidLift(jav.AverageDense())
        return pmon.MonoidLift(registry.make_dense("average", device="cpu"))

    def init(self, lift):
        mod = jmon if self.pkg == "jax" else pmon
        return mod.MonoidContributor(lift, DR, DNK_MONOID)

    def gen_ops(self, step, owned):
        owned = set(owned)
        cols = {k: np.zeros((DR, DB), np.int32) for k in ("key", "value", "count")}
        for r in range(DR):
            rng = np.random.default_rng(20_000 * (step + 1) + r)
            if r in owned:
                cols["key"][r] = rng.integers(0, DNK_MONOID, DB)
                cols["value"][r] = rng.integers(1, 100, DB)
                cols["count"][r] = 1
        if self.pkg == "jax":
            return jav.AverageOps(**{k: jnp.asarray(v) for k, v in cols.items()})
        return convert.from_numpy(pav.AverageOps, cols, "cpu")

    def apply(self, lift, contrib, step, owned):
        contrib.apply(self.gen_ops(step, owned), owned=sorted(owned))
        return contrib

    def pub_state(self, lift, contrib):
        return contrib.view

    def set_view(self, lift, contrib, swept):
        contrib.absorb(swept)
        return contrib

    def digest(self, lift, contrib):
        return leaf_bytes(contrib.view)


class WordcountDrill(AverageDrill):
    """The lifted wordcount drill (elastic_demo's ``_WordcountDrill``):
    2 keys, V = 32 buckets, a MonoidContributor per worker."""

    name = "wordcount"
    publish_name = "wordcount_lifted"

    def make_engine(self):
        if self.pkg == "jax":
            return jmon.MonoidLift(jwc.WordcountDense(DV))
        return pmon.MonoidLift(registry.make_dense("wordcount", n_buckets=DV, device="cpu"))

    def gen_ops(self, step, owned):
        owned = set(owned)
        key, tok = np.zeros((DR, DB), np.int32), np.full((DR, DB), -1, np.int32)
        for r in range(DR):
            rng = np.random.default_rng(30_000 * (step + 1) + r)
            if r in owned:
                key[r] = rng.integers(0, DNK_MONOID, DB)
                tok[r] = rng.integers(0, DV, DB)
        if self.pkg == "jax":
            return jwc.WordcountOps(key=jnp.asarray(key), token=jnp.asarray(tok))
        return convert.from_numpy(pwc.WordcountOps, dict(key=key, token=tok), "cpu")


def _adopt(self, dense, state, gained, upto_step):
    """elastic_demo's adoption: the gained replicas' whole history, in
    order (JOIN: re-applied in place; MONOID: into the own rows)."""
    for g in sorted(gained):
        for s in range(upto_step):
            state = self.apply(dense, state, s, [g])
    return state


TopkRmvDrill.adopt = _adopt
AverageDrill.adopt = _adopt

DRILLS = {"topk_rmv": TopkRmvDrill(), "average": AverageDrill(), "wordcount": WordcountDrill()}


# --- elastic_demo's geometry and observable digests ---------------------------

R, STEPS = DR, 10  # scripts/elastic_demo.py: R = 4 replicas, 10 steps


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DemoTopkRmvDrill(TopkRmvDrill):
    """The drill as scripts/elastic_demo.py digests it: the observable
    top-K of all R replica rows folded by the join."""

    def digest(self, dense, state):
        if self.pkg == "jax":
            from antidote_ccrdt_tpu.harness.dense_replay import fold_rows
        else:
            from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows
        obs = dense.value(fold_rows(dense, state, range(DR)))[0][0]
        return sorted((int(i), int(s)) for (i, s) in obs)


class DemoAverageDrill(AverageDrill):
    def digest(self, lift, contrib):
        tot = lift.total(contrib.view)
        return [[int(x) for x in _host(tot.sum)[0]], [int(x) for x in _host(tot.num)[0]]]


class DemoWordcountDrill(WordcountDrill):
    def digest(self, lift, contrib):
        tot = lift.total(contrib.view)
        counts = _host(tot.counts)[0]
        out = [[k, int(t), int(counts[k, t])] for k in range(DNK_MONOID) for t in np.nonzero(counts[k])[0]]
        return out + [["lost", int(_host(tot.lost).sum())]]


DEMO_DRILLS = {"topk_rmv": DemoTopkRmvDrill(), "average": DemoAverageDrill(), "wordcount": DemoWordcountDrill()}


def demo_drills(pkg):
    return {"topk_rmv": DemoTopkRmvDrill(pkg), "average": DemoAverageDrill(pkg), "wordcount": DemoWordcountDrill(pkg)}


def reference_digest(type_name="topk_rmv", pkg="torch"):
    """elastic_demo's sequential ground truth (every step, every
    replica) through `pkg`'s engines."""
    drill = demo_drills(pkg)[type_name]
    dense = drill.make_engine()
    state = drill.init(dense)
    for step in range(STEPS):
        state = drill.apply(dense, state, step, range(DR))
    return drill.digest(dense, state)


class torch_jnp:
    """The few ``jax.numpy`` names the JAX package's test files build ops
    with, as torch tensors on the CPU (for `port_copy`)."""

    int32 = torch.int32

    @staticmethod
    def asarray(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    @staticmethod
    def zeros(shape, dtype=None):
        return torch.zeros(shape, dtype=dtype)

    @staticmethod
    def full(shape, fill_value, dtype=None):
        return torch.full(shape, fill_value, dtype=dtype)

    @staticmethod
    def ones(shape, dtype=None):
        return torch.ones(shape, dtype=dtype)

    @staticmethod
    def zeros_like(x):
        return torch.zeros_like(x)

    @staticmethod
    def all(x):
        return torch.all(x)


def leaf_bytes(state):
    """(dtype, shape, bytes) of every leaf in order: equal for equal
    states of either package."""
    from antidote_ccrdt_tpu_torch.utils.tree import flatten_with_path

    if not isinstance(next(iter(flatten_with_path(state)))[1], torch.Tensor):
        import jax

        flat = [np.asarray(x) for x in jax.tree_util.tree_leaves(state)]
    else:
        flat = [leaf.cpu().numpy() for _, leaf in flatten_with_path(state)]
    return [(a.dtype.str, a.shape, a.tobytes()) for a in flat]


def port_copy(test_file, skip=(), replace=(), helpers=(), imports=True):
    """The test functions and fixtures of the JAX package's `test_file`
    (a file in this directory), compiled again with every import of
    ``antidote_ccrdt_tpu`` turned into one of ``antidote_ccrdt_tpu_torch``
    (and any further (old, new) source `replace` pairs, each of which
    must occur): the same test
    bodies, run through the port. Tests named in `skip` need a part of the
    JAX package the port does not have yet and are left out. `helpers`
    names further functions of the copy to return with the tests. A file
    that imports nothing of the package (it drives a script in a
    subprocess) is copied with ``imports=False``: only `replace` applies."""
    import os

    path = os.path.join(os.path.dirname(__file__), test_file)
    with open(path) as f:
        src = f.read()
    pairs = (("antidote_ccrdt_tpu.", "antidote_ccrdt_tpu_torch."),) if imports else ()
    for old, new in (*pairs, *replace):
        assert old in src, (test_file, old)
        src = src.replace(old, new)
    ns = {"__name__": f"{test_file[:-3]}_through_the_port", "__file__": path}
    exec(compile(src, path, "exec"), ns)
    out = {k: v for k, v in ns.items()
           if callable(v) and (k.startswith("test_") or hasattr(v, "_pytestfixturefunction")
                               or type(v).__name__ == "FixtureFunctionDefinition")}
    out.update({k: ns[k] for k in helpers})
    missing = set(skip) - set(out)
    assert not missing, missing
    return {k: v for k, v in out.items() if k not in skip}


def port_copies(*specs):
    """The merged `port_copy` of several files: each spec is a file name
    or (file name, keyword arguments). A test name that two files share
    is kept from both, each suffixed with its file's stem."""
    got = []
    for spec in specs:
        name, kw = (spec, {}) if isinstance(spec, str) else spec
        got.append((name[:-3], port_copy(name, **kw)))
    seen = {}
    for _stem, fns in got:
        for k in fns:
            seen[k] = seen.get(k, 0) + 1
    out = {}
    for stem, fns in got:
        for k, v in fns.items():
            if seen[k] > 1 and k.startswith("test_"):
                out[f"{k}__{stem}"] = v
            else:
                assert k not in out, f"fixture {k} defined by two of {specs}"
                out[k] = v
    return out


def leaves_of(state):
    """The tensor leaves of a port state, in JAX's order."""
    from antidote_ccrdt_tpu_torch.utils.tree import leaves

    return leaves(state)


# native/Makefile's flags: CXXFLAGS, then -pthread for the tokenizer, then -shared.
NATIVE_FLAGS = {"ccrdt_host": ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"),
                "ccrdt_tokenizer": ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")}


def build_native_libraries(out_dir):
    """``native/ccrdt_host.cpp`` and ``native/ccrdt_tokenizer.cpp`` compiled
    with g++ and native/Makefile's flags into `out_dir` (a directory of
    this process's own), each written through a temp file and
    `os.replace`: {name: path of lib<name>.so}. A failed build raises
    `subprocess.CalledProcessError` with the compiler's output.

    The JAX package's bindings build into the shared ``native/build/``
    with ``make`` and load whatever file is there, so a test process can
    load a library another process's g++ is still writing; a test that
    points them at this directory never does."""
    native = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
    out = {}
    for name, flags in NATIVE_FLAGS.items():
        lib = os.path.join(out_dir, f"lib{name}.so")
        tmp = f"{lib}.{os.getpid()}.tmp"
        subprocess.run(["g++", *flags, "-o", tmp, os.path.join(native, f"{name}.cpp")],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib)
        out[name] = lib
    return out


def serve_engine():
    """``tests/test_serve.py``'s engine (I = 8 ids, 2 DCs, K = 10, M = 2)
    in the port, on the device the caller's region gives it."""
    return registry.make_dense("topk_rmv", n_ids=8, n_dcs=2, size=10, slots_per_id=2)


# tests/test_serve.py's replica count (its `R`), for files that import it
# with `_engine` and `_apply`.
SERVE_R = 2
_SERVE_HELPERS = {}


def _serve_helpers():
    """``tests/test_serve.py``'s `_apply` and ``tests/test_serve_parity.py``'s
    `_frozen_plane` through the port (each engine on the device of the
    caller's region)."""
    if not _SERVE_HELPERS:
        jnp = ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp")
        serve = ("from antidote_ccrdt_tpu import serve", "from antidote_ccrdt_tpu_torch import serve")
        _SERVE_HELPERS.update(port_copy("test_serve.py", replace=[jnp, serve], helpers=["_apply"]))
        _SERVE_HELPERS.update(port_copy("test_serve_parity.py", replace=[serve, (
            "from tests.test_serve import R, _apply, _engine",
            "from torch_twins import SERVE_R as R, serve_apply as _apply, serve_engine as _engine"),
            ("BridgeServer(port=0)", 'BridgeServer(port=0, device="cpu")')], helpers=["_frozen_plane"]))
    return _SERVE_HELPERS


def serve_apply(dense, state, ids, scores, **kw):
    """``tests/test_serve.py``'s `_apply` through the port."""
    return _serve_helpers()["_apply"](dense, state, ids, scores, **kw)


def serve_frozen_plane(metrics=None):
    """``tests/test_serve_parity.py``'s `_frozen_plane` through the port."""
    return _serve_helpers()["_frozen_plane"](metrics)


class torch_jax:
    """The ``jax.tree_util`` calls the JAX package's test files make on
    states, over the port's states (for `port_copy`)."""

    class tree_util:
        @staticmethod
        def tree_map(fn, tree, *rest):
            from antidote_ccrdt_tpu_torch.utils.tree import tree_map

            return tree_map(fn, tree, *rest)

        @staticmethod
        def tree_leaves(tree):
            from antidote_ccrdt_tpu_torch.utils.tree import leaves

            return leaves(tree)


_PORT_CHAOS = []


def port_run_chaos(*args, **kwargs):
    """``tests/test_net_chaos.run_chaos`` through the port (the drills of
    this module in place of scripts/elastic_demo.py's)."""
    if not _PORT_CHAOS:
        _PORT_CHAOS.append(port_copy("test_net_chaos.py", replace=[(
            "from elastic_demo import DRILLS, R, STEPS, reference_digest",
            "from torch_twins import DEMO_DRILLS as DRILLS, R, STEPS, reference_digest")],
            helpers=["run_chaos"])["run_chaos"])
    return _PORT_CHAOS[0](*args, **kwargs)


class torch_mesh_jax(torch_jax):
    """The ``jax`` names ``tests/test_mesh.py`` calls, over the port (for
    `port_copy`): the conftest's 8 virtual CPU devices as 8 logical CPU
    devices, ``jax.tree.map`` and a row write in place of ``.at[].set``."""

    @staticmethod
    def devices():
        return [torch.device("cpu")] * 8

    class tree:
        @staticmethod
        def map(fn, tree, *rest):
            from antidote_ccrdt_tpu_torch.utils.tree import tree_map

            return tree_map(fn, tree, *rest)

    @staticmethod
    def set_rows(full, r, rows):
        """``full.at[r : r + len(rows)].set(rows)`` as a new tensor."""
        out = full.clone()
        out[r : r + rows.shape[0]] = rows
        return out


class torch_orbax_jax(torch_mesh_jax):
    """The ``jax`` names ``tests/test_orbax_ckpt.py`` and
    ``tests/test_orbax_gossip.py`` call, over the port (for `port_copy`):
    `torch_mesh_jax`'s, plus ``jax.tree.leaves``, ``jax.device_put`` onto
    a ``parallel.dist`` sharding and ``jax.ShapeDtypeStruct``."""

    class tree(torch_mesh_jax.tree):
        @staticmethod
        def leaves(tree):
            from antidote_ccrdt_tpu_torch.utils.tree import leaves

            return leaves(tree)

    @staticmethod
    def device_put(x, sharding):
        from antidote_ccrdt_tpu_torch.parallel.dist import device_put

        return device_put(x, sharding)

    @staticmethod
    def ShapeDtypeStruct(shape, dtype, sharding=None):
        from antidote_ccrdt_tpu_torch.parallel.dist import ShapeDtypeStruct

        return ShapeDtypeStruct(shape, dtype, sharding=sharding)

    @staticmethod
    def leaf_devices(leaf):
        """``leaf.devices()``: the devices of the mesh the leaf is tagged
        with; an untagged leaf (an engine's output) is on its device."""
        sharding = getattr(leaf, "sharding", None)
        return [leaf.device] if sharding is None else list(sharding.mesh.devices.flat)
