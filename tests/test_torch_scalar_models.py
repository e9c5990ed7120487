"""The port's scalar models, clock, snapshot codec and ETF/wire against the
JAX package's, which are the reference.

Seeded prepare-op streams go through `downstream` at rotating origin DCs
and every effect (and every extra op it returns) through `update` on all
replicas, in both packages at once. After each step the states must be
`==`, and `value`, `equal`, `to_binary` bytes, reference-ETF bytes and
their round trips must agree; the compaction callbacks are compared on
every adjacent pair of the effect log.
"""

import numpy as np
import pytest

import antidote_ccrdt_tpu as J
from antidote_ccrdt_tpu.core import etf as jetf
from antidote_ccrdt_tpu.core import serial as jserial
from antidote_ccrdt_tpu.core import wire as jwire
from antidote_ccrdt_tpu.models import topk as jtopk
from antidote_ccrdt_tpu.models import topk_rmv_dense as jtrd

import antidote_ccrdt_tpu_torch as T
from antidote_ccrdt_tpu_torch import convert
from antidote_ccrdt_tpu_torch.core import etf as petf
from antidote_ccrdt_tpu_torch.core import serial as pserial
from antidote_ccrdt_tpu_torch.core import wire as pwire
from antidote_ccrdt_tpu_torch.models import leaderboard as plb
from antidote_ccrdt_tpu_torch.models import topk as ptopk
from antidote_ccrdt_tpu_torch.models import topk_rmv as ptr

TYPES = ["average", "topk", "topk_rmv", "leaderboard", "wordcount", "worddocumentcount"]
SIZED = {"topk": 5, "topk_rmv": 5, "leaderboard": 4}
STATE_CLS = {"topk": ptopk.TopkState, "topk_rmv": ptr.TopkRmvState, "leaderboard": plb.LeaderboardState}


def prepare_ops(name, rng, n):
    """Seeded prepare ops of `name`; removals and bans name ids seen."""
    out = []
    words = ["a", "b", "b c", "", "d\nd", "x  y", "é"]
    for _ in range(n):
        u = rng.random()
        if name == "average":
            out.append(("add", int(rng.integers(-9, 50))) if u < 0.5
                       else ("add", (int(rng.integers(-9, 50)), int(rng.integers(0, 3)))))
        elif name in ("wordcount", "worddocumentcount"):
            out.append(("add", " ".join(rng.choice(words, int(rng.integers(0, 5))))))
        elif name == "topk":
            out.append(("add", (int(rng.integers(0, 12)), int(rng.integers(1, 60)))))
        elif name == "topk_rmv":
            out.append(("rmv", int(rng.integers(0, 12))) if u < 0.2
                       else ("add", (int(rng.integers(0, 12)), int(rng.integers(1, 60)))))
        else:
            out.append(("ban", int(rng.integers(0, 12))) if u < 0.1
                       else ("add", (int(rng.integers(0, 12)), int(rng.integers(1, 60)))))
    return out


def new_states(pkg, name, n):
    eng = pkg.registry.scalar(name)
    return [eng.new(SIZED[name]) if name in SIZED else eng.new() for _ in range(n)]


def ship(eng, states, effect):
    """Apply `effect` on every replica; extras are re-shipped to all.
    Returns the extras in order."""
    queue, extras = [effect], []
    while queue:
        eff = queue.pop(0)
        for r, st in enumerate(states):
            states[r], ex = eng.update(eff, st)
            if r == 0:
                extras += ex
                queue += ex
    return extras


def same_state(name, p, j):
    assert p == j
    cls = STATE_CLS.get(name)
    assert convert.scalar_state(j, cls) == p
    assert type(convert.scalar_state(j, cls)) is type(p)


@pytest.mark.parametrize("shared_clock", [True, False])
@pytest.mark.parametrize("name", TYPES)
def test_op_streams_match_jax(name, shared_clock):
    n_dc = 3
    rng = np.random.default_rng(10 * TYPES.index(name) + shared_clock)
    je, pe = J.registry.scalar(name), T.registry.scalar(name)
    jctx = J.make_contexts(n_dc, shared_clock=shared_clock)
    pctx = T.make_contexts(n_dc, shared_clock=shared_clock)
    js, ps = new_states(J, name, n_dc), new_states(T, name, n_dc)
    log = []
    for step, op in enumerate(prepare_ops(name, rng, 80)):
        r = step % n_dc
        assert pe.require_state_downstream(op) == je.require_state_downstream(op)
        assert pe.is_operation(op) == je.is_operation(op)
        j_eff, p_eff = je.downstream(op, js[r], jctx[r]), pe.downstream(op, ps[r], pctx[r])
        assert p_eff == j_eff
        if p_eff is None:
            continue
        log.append(p_eff)
        assert pe.is_replicate_tagged(p_eff) == je.is_replicate_tagged(j_eff)
        assert ship(pe, ps, p_eff) == ship(je, js, j_eff)
        for p, j in zip(ps, js):
            same_state(name, p, j)
    assert log
    for p, j in zip(ps, js):
        assert pe.value(p) == je.value(j)
        assert pe.equal(p, ps[0]) == je.equal(j, js[0])
        blob = pe.to_binary(p)
        assert blob == je.to_binary(j)
        assert pe.from_binary(blob) == p == pe.from_binary(je.to_binary(j))
        ref = pwire.to_reference_binary(name, p)
        assert ref == jwire.to_reference_binary(name, j)
        assert ref == pwire.to_reference_binary(name, pwire.from_reference_binary(name, ref))
        assert pwire.from_reference_binary(name, ref) == jwire.from_reference_binary(name, ref)
        assert pwire.to_reference_binary(name, p, compressed=True) == \
            jwire.to_reference_binary(name, j, compressed=True)
    for e1, e2 in zip(log, log[1:]):
        can = pe.can_compact(e1, e2)
        assert can == je.can_compact(e1, e2)
        if can:
            assert pe.compact_ops(e1, e2) == je.compact_ops(e1, e2)


@pytest.mark.parametrize("op", [
    ("add", 1), ("add", (1, 2)), ("add", (1, 2, 3)), ("add", "doc"), ("rmv", 3), ("ban", 3),
    ("add", ("x", 2)), ("nope", 1), "add", ("add",), None,
])
def test_is_operation_matches_jax(op):
    for name in TYPES:
        assert T.registry.scalar(name).is_operation(op) == J.registry.scalar(name).is_operation(op)


def test_registry_matches_jax():
    for name in TYPES + ["nope", 3, None]:
        assert T.is_type(name) == J.is_type(name)
        assert T.generates_extra_operations(name) == J.generates_extra_operations(name)
    assert set(T.registry.scalar_types()) == set(J.registry.scalar_types())
    assert {"topk", "leaderboard", "topk_rmv"} <= set(T.registry.dense_types())


def test_topk_compat_matches_jax():
    je, pe = jtopk.TopkScalarCompat(), ptopk.TopkScalarCompat()
    rng = np.random.default_rng(8)
    js, ps = je.new(), pe.new()
    ops = [("add", (int(i), int(s))) for i, s in zip(rng.integers(0, 6, 40), rng.integers(900, 1100, 40))]
    for op in ops:
        j_eff, p_eff = je.downstream(op, js, None), pe.downstream(op, ps, None)
        assert p_eff == j_eff
        if p_eff:
            js, ps = je.update(j_eff, js)[0], pe.update(p_eff, ps)[0]
            assert ps == js
    effs = [("add", o[1]) for o in ops[:6]]
    for e1, e2 in zip(effs, effs[1:]):
        assert pe.compact_ops(e1, e2) == je.compact_ops(e1, e2)


def test_logical_clock_and_contexts_match_jax():
    for shared in (True, False):
        jc, pc = J.make_contexts(4, shared), T.make_contexts(4, shared)
        assert [c.stamp() for c in pc + pc] == [c.stamp() for c in jc + jc]
    wc = T.WallClock()
    a = wc.system_time()
    b = wc.system_time()
    assert b >= a and wc.get_time() == b


TERMS = [
    0, 255, 256, -1, 2**31 - 1, -(2**31), 2**31, 1 << 80, -(1 << 200), 1.5, -0.0,
    b"", b"bin", "str", True, False, (), (1, (2, 3)), [], [1, [2.5, b"x"]],
    list(range(300)), {}, {b"k": 1, 3: (4,), (1, 2): [5]}, {i: i for i in range(40)},
]


@pytest.mark.parametrize("compressed", [False, True])
def test_etf_bytes_match_jax(compressed):
    for term in TERMS + [(petf.Atom("nil"), petf.Atom("a")), {petf.Atom("z"): 1, petf.Atom("a"): 2}]:
        blob = petf.encode(term, compressed=compressed)
        jterm = term if not isinstance(term, (tuple, dict)) else jetf.decode(blob)
        assert blob == jetf.encode(jterm, compressed=compressed)
        assert petf.encode(petf.decode(blob)) == jetf.encode(jetf.decode(blob))
    items = [(i, b"x", (i, i)) for i in range(37)]
    assert petf.encode(petf.gb_set_from_list(items)) == jetf.encode(jetf.gb_set_from_list(items))
    assert petf.encode(petf.set_from_list([1, 2, b"a"])) == jetf.encode(jetf.set_from_list([1, 2, b"a"]))
    assert petf.gb_set_to_list(petf.decode(jetf.encode(jetf.gb_set_from_list(items)))) == sorted(items)


def test_etf_malformed_inputs_raise():
    for bad in (b"", b"\x82\x61\x01", petf.encode((1, 2)) + b"junk", b"\x83\x99"):
        with pytest.raises(ValueError):
            petf.decode(bad)


def test_serial_scalar_codec_matches_jax():
    value = {"a": (1, b"x", 2.5, None, True), 3: frozenset({(1, 2), (3, 4)}), (1,): [1, {"z": -(2**70)}]}
    assert pserial.encode_term(value) == jserial.encode_term(value)
    assert pserial.decode_term(jserial.encode_term(value)) == value
    blob = pserial.dumps_scalar("topk", value)
    assert blob == jserial.dumps_scalar("topk", value)
    assert pserial.peek_name(blob) == "topk" and pserial.loads_scalar(blob) == ("topk", value)
    with pytest.raises(ValueError):
        pserial.decode_term(pserial.encode_term(1) + b"\x00")


def test_serial_dense_blobs_cross_load():
    """A dense snapshot written by either package loads in the other: the
    same npz leaves and the same treedef manifest."""
    import jax
    import jax.numpy as jnp

    je = jtrd.make_dense(n_ids=5, n_dcs=2, size=3, slots_per_id=2)
    pe = T.registry.make_dense("topk_rmv", n_ids=5, n_dcs=2, size=3, slots_per_id=2, device="cpu")
    js = je.init(2, 1)
    js = jtrd.TopkRmvDenseState(**{**vars(js), "rmv_vc": jnp.arange(20, dtype=jnp.int32).reshape(2, 1, 5, 2)})
    ps = convert.from_numpy(type(pe.init(1, 1)), js, "cpu")
    for jx, px in ((js, ps), (je.observe(js), pe.observe(ps))):
        pblob, jblob = pserial.dumps_dense("x", px), jserial.dumps_dense("x", jx)
        assert pblob[:8] == jblob[:8]
        _, back = pserial.loads_dense(jblob, px)
        assert all(np.array_equal(a, b) for a, b in zip(convert.to_numpy(back).values(), convert.to_numpy(px).values()))
        _, jback = jserial.loads_dense(pblob, jx)
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(jax.tree_util.tree_leaves(jback), jax.tree_util.tree_leaves(jx)))
    with pytest.raises(ValueError, match="treedef"):
        pserial.loads_dense(pserial.dumps_dense("x", ps), tuple(vars(ps).values()))


def test_wire_accepts_beam_style_ids():
    atom, dc = petf.Atom("p1"), (petf.Atom("replica1"), 0)
    st = ptr.TopkRmvState({atom: (5, atom, (dc, 3))}, {atom: frozenset({(5, atom, (dc, 3))})},
                          {b"\xff": {dc: 2}}, {dc: 3}, (5, atom, (dc, 3)), 7)
    blob = pwire.to_reference_binary("topk_rmv", st)
    assert pwire.from_reference_binary("topk_rmv", blob) == st
    assert jwire.to_reference_binary("topk_rmv", jwire.from_reference_binary("topk_rmv", blob)) == blob
