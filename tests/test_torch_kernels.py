"""The port's kernels K1-K3: each plain version against the JAX package's
Pallas function (interpret mode, as tests/test_pallas_kernels.py runs
them) and its XLA path, with exact equality (every leaf is int32).

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py, which shares the input makers below.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from antidote_ccrdt_tpu.models.topk_rmv_dense import _join_slots_union, _sort_slots
from antidote_ccrdt_tpu.ops import pallas_kernels as jpk
from antidote_ccrdt_tpu.ops.delta_place import delta_place_pallas
from antidote_ccrdt_tpu.ops.dense_table import scatter_max_rows_mxu
from antidote_ccrdt_tpu_torch import convert, registry
from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
from antidote_ccrdt_tpu_torch.ops import kernels
from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place
from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF, scatter_max_rows
from test_torch_cuda import I32_MAX, I32_MIN, canonical_side, k1_inputs, k2_inputs, raw_slots, t




def eq(got, want):
    return np.array_equal(np.asarray(got), np.asarray(want))


# --- K1 -------------------------------------------------------------------


@pytest.mark.parametrize("seed,vmax", [(0, 2**31 - 1), (1, 50), (2, 2**20)])
def test_k1_plain_matches_pallas_and_xla(seed, vmax):
    table, rows, upd = k1_inputs(seed, vmax=vmax)
    want_pallas = jpk.scatter_max_rows_onehot_pallas(
        jnp.asarray(table), jnp.asarray(rows), jnp.asarray(upd), True
    )
    want_xla = jax.vmap(scatter_max_rows_mxu)(
        jnp.asarray(table), jnp.asarray(rows), jnp.asarray(upd)
    )
    got = scatter_max_rows(t(table), t(rows), t(upd))
    assert eq(got, want_pallas)
    assert eq(got, want_xla)


@pytest.mark.parametrize("seed", range(3))
def test_k1_broadcast_view_matches_contiguous_and_jax(seed):
    # DenseReplay's rows after a sync: one replica row seen R times
    # (stride 0), which the out-of-place scatter-max (K1c) reads in place.
    table, rows, upd = k1_inputs(10 + seed)
    row = t(table[:1])
    view = row.expand(table.shape)
    assert view.stride(0) == 0
    got = scatter_max_rows(view, t(rows), t(upd))
    assert torch.equal(got, scatter_max_rows(view.contiguous(), t(rows), t(upd)))
    full = jnp.asarray(np.broadcast_to(table[:1], table.shape))
    want_xla = jax.vmap(scatter_max_rows_mxu)(full, jnp.asarray(rows), jnp.asarray(upd))
    want_pallas = jpk.scatter_max_rows_onehot_pallas(full, jnp.asarray(rows), jnp.asarray(upd), True)
    assert eq(got, want_xla)
    assert eq(got, want_pallas)
    assert torch.equal(row, t(table[:1]))


def test_k1c_wrapper_checks_inputs_and_takes_any_layout():
    table, rows, upd = k1_inputs(6)
    want = scatter_max_rows(t(table), t(rows), t(upd))
    # A table whose inner [T, D] block is not contiguous is taken as it is
    # on the CPU and copied first on a card.
    odd = t(table).transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(kernels.scatter_max_rows_copy(odd, t(rows), t(upd)), want)
    assert torch.equal(kernels.scatter_max_rows_copy(t(table), t(rows).T.contiguous().T, t(upd)), want)
    with pytest.raises(TypeError):
        kernels.scatter_max_rows_copy(t(table).long(), t(rows), t(upd))
    with pytest.raises(ValueError):
        kernels.scatter_max_rows_copy(t(table), t(rows)[:, :-1], t(upd))
    with pytest.raises(ValueError):
        kernels.scatter_max_rows_copy(
            torch.empty(table.shape, dtype=torch.int32, device="meta"), t(rows), t(upd)
        )


def test_k1_functional_copy_leaves_input_alone():
    table, rows, upd = k1_inputs(3)
    tt = t(table)
    before = tt.clone()
    scatter_max_rows(tt.expand(2, *tt.shape)[0], t(rows), t(upd))
    assert torch.equal(tt, before)


def test_k1_wrapper_rejects_bad_inputs():
    table, rows, upd = k1_inputs(4)
    with pytest.raises(TypeError):
        kernels.scatter_max_rows_(t(table).long(), t(rows), t(upd))
    with pytest.raises(ValueError):
        kernels.scatter_max_rows_(t(table), t(rows)[:, :-1], t(upd))
    with pytest.raises(ValueError):
        kernels.scatter_max_rows_(t(table).transpose(1, 2).contiguous().transpose(1, 2), t(rows), t(upd))
    with pytest.raises(ValueError):
        kernels.scatter_max_rows_(
            torch.empty(table.shape, dtype=torch.int32, device="meta"), t(rows), t(upd)
        )


# --- K2 -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_k2_plain_matches_pallas_and_xla(seed):
    score, ts, dc, kid, rank, keep, T, M, D = k2_inputs(seed)
    want = delta_place_pallas(
        *(jnp.asarray(x) for x in (score, ts, dc, kid, rank, keep)), T, M, D, True
    )
    # The engine's XLA path: three `.at[kid3, rank3].set(mode="drop")`.
    R, B = kid.shape
    kid3 = np.where(keep, kid, T)
    rank3 = np.where(keep, rank, M + np.arange(B, dtype=np.int32))
    xla = []
    for vals, fill in ((score, NEG_INF), (dc, 0), (ts, 0)):
        rows = [
            jnp.full((T, M), fill, jnp.int32)
            .at[kid3[r], rank3[r]].set(vals[r], mode="drop", unique_indices=True)
            for r in range(R)
        ]
        xla.append(jnp.stack(rows))
    got = delta_place(*(t(x) for x in (score, ts, dc, kid, rank, keep)), T, M)
    for g, w, x in zip(got, want, xla):
        assert eq(g, w)
        assert eq(g, x)


def engine_stream_ops(seed, R=2, NK=2, I=40, D=3, B=1200, hot=1100):
    """Adds whose sorted stream has a hot id's run longer than one tile of
    the CUDA kernel (256 ids x M=4 cells), exact duplicates that drop out
    of the rank count mid-stream, and invalid adds."""
    rng = np.random.default_rng(300 + seed)
    ops = {
        "add_key": rng.integers(0, NK, (R, B)),
        "add_id": np.minimum(rng.zipf(1.2, (R, B)) - 1, I - 1),
        "add_score": rng.integers(0, 40, (R, B)),
        "add_dc": rng.integers(0, D, (R, B)),
        "add_ts": rng.integers(1, 30, (R, B)),
        "rmv_key": np.zeros((R, 1)), "rmv_id": np.full((R, 1), -1), "rmv_vc": np.zeros((R, 1, D)),
    }
    ops["add_key"][:, :hot], ops["add_id"][:, :hot] = 1, 7
    for f in ("add_key", "add_id", "add_score", "add_dc", "add_ts"):
        ops[f][:, 1::6] = ops[f][:, 0::6][:, : ops[f][:, 1::6].shape[1]]
    ops["add_ts"][:, 5::50] = 0  # padding
    ops["add_id"][:, 7::40] = I  # out of range
    return {k: np.ascontiguousarray(v, dtype=np.int32) for k, v in ops.items()}, NK, I, D


@pytest.mark.parametrize("seed", range(3))
def test_k2_on_engine_stream_matches_pallas_and_xla(seed):
    arrs, NK, I, D = engine_stream_ops(seed)
    M = 4
    eng = registry.make_dense("topk_rmv", n_ids=I, n_dcs=D, slots_per_id=M, device="cpu")
    st = eng.add_stream(convert.from_numpy(TopkRmvOps, arrs, "cpu"), NK)
    T = NK * I
    kid, kid3, keep, rank = (x.numpy() for x in (st.kid, st.kid3, st.keep, st.rank))
    hot = (kid == 1 * I + 7).sum(1)
    assert (hot > 256 * M).all()
    assert ((kid3 != kid) & (kid < T)).any()  # dropped duplicates inside the stream
    cols = (st.score, st.ts, st.dc)
    got = delta_place(*cols, st.kid, st.rank, st.keep, T, M)
    want = delta_place_pallas(
        *(jnp.asarray(x.numpy()) for x in (*cols, st.kid, st.rank, st.keep)), T, M, D, True
    )
    # The JAX engine's three scatters (models/topk_rmv_dense.py:612-622).
    B = kid.shape[1]
    kid3d = np.where(keep, kid3, T)
    rank3 = np.where(keep, rank, M + np.arange(B, dtype=np.int32))
    for g, w, vals, fill in zip(got, want, (st.score, st.dc, st.ts), (NEG_INF, 0, 0)):
        assert eq(g, w)
        xla = jnp.stack([
            jnp.full((T, M), fill, jnp.int32)
            .at[kid3d[r], rank3[r]].set(jnp.asarray(vals[r].numpy()), mode="drop", unique_indices=True)
            for r in range(kid.shape[0])
        ])
        assert eq(g, xla)
    assert int(st.keep.sum()) > 0


# --- K3 -------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("w,m", [(6, 3), (4, 2)])
def test_k3_unfused_matches_pallas(seed, w, m):
    # (The interpreted Pallas network compiles in seconds at W <= 6 and in
    # half a minute at W = 8; W = 8 is held against `_sort_slots` below
    # and, fused, against `_join_slots_union`.)
    rng = np.random.default_rng(seed)
    score, dc, ts = raw_slots(rng, (2, 3, 17, w), 3)
    want = jpk.sort_slots_pallas(jnp.asarray(score), jnp.asarray(dc), jnp.asarray(ts), m, True, 128)
    got = kernels.sort_slots([(t(score), t(dc), t(ts))], m)
    for g, x in zip(got, want):
        assert eq(g, x)
    # Two sides are the same candidates split in place.
    k = w // 2
    got2 = kernels.sort_slots(
        [(t(score[..., :k]), t(dc[..., :k]), t(ts[..., :k])),
         (t(score[..., k:]), t(dc[..., k:]), t(ts[..., k:]))], m,
    )
    for g, x in zip(got2, want):
        assert eq(g, x)


@pytest.mark.parametrize("seed", range(2))
def test_k3_unfused_matches_xla_sort_without_int32_min(seed):
    # `_sort_slots` negates its keys, so it agrees with the direct
    # compare everywhere but at INT32_MIN scores.
    rng = np.random.default_rng(10 + seed)
    score, dc, ts = raw_slots(rng, (2, 1, 17, 8), 3)
    score = np.where(score == I32_MIN, 7, score).astype(np.int32)
    want = _sort_slots(jnp.asarray(score), jnp.asarray(dc), jnp.asarray(ts), 4)
    got = kernels.sort_slots([(t(score), t(dc), t(ts))], 4)
    for g, x in zip(got, want):
        assert eq(g, x)
    got2 = kernels.sort_slots([(t(score[..., :4]), t(dc[..., :4]), t(ts[..., :4])),
                               (t(score[..., 4:]), t(dc[..., 4:]), t(ts[..., 4:]))], 4)
    for g, x in zip(got2, want):
        assert eq(g, x)


@pytest.mark.parametrize("seed", range(3))
def test_k3_fused_matches_union_join(seed):
    rng = np.random.default_rng(20 + seed)
    D, M = 3, 4
    shape = (2, 2, 33, M)
    a = canonical_side(rng, shape, D)
    b = canonical_side(rng, shape, D)
    # Cross-side duplicates: copy some of a's rows into b.
    same = rng.random(shape[:-1])[..., None] < 0.3
    b = tuple(np.where(same, x, y) for x, y in zip(a, b))
    rmv_vc = rng.integers(0, 4, shape[:-1] + (D,)).astype(np.int32)
    want = _join_slots_union(
        tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b), jnp.asarray(rmv_vc), M
    )
    got = kernels.sort_slots([tuple(map(t, a)), tuple(map(t, b))], M, rmv_vc=t(rmv_vc))
    for g, x in zip(got, want):
        assert eq(g, x)


def test_k3_fused_dead_ranks_after_int32_min():
    # A live INT32_MIN slot must stay ahead of a filtered-out candidate,
    # which a plain direct compare of (NEG_INF, 0, 0) would put first.
    M, D = 2, 2
    a = (np.array([[[I32_MIN, NEG_INF]]], np.int32), np.array([[[1, 0]]], np.int32),
         np.array([[[5, 0]]], np.int32))
    b = (np.array([[[9, NEG_INF]]], np.int32), np.array([[[0, 0]]], np.int32),
         np.array([[[2, 0]]], np.int32))
    rmv_vc = np.array([[[3, 0]]], np.int32)  # kills b's slot (ts 2 <= 3 at dc 0)
    want = _join_slots_union(
        tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b), jnp.asarray(rmv_vc), M
    )
    got = kernels.sort_slots([tuple(map(t, a)), tuple(map(t, b))], M, rmv_vc=t(rmv_vc))
    for g, x in zip(got, want):
        assert eq(g, x)
    assert got[0].tolist() == [[[I32_MIN, NEG_INF]]] and got[3].tolist() == [[1]]


def wide_rows(rng, rows, w, D, live=0.8):
    """Raw rows of w candidates, mostly distinct and live (ts in [1, 2^20),
    scores over the int32 range without INT32_MIN, dcs in [-1, D]), with
    holes (NEG_INF, 0, 0) and exact duplicates."""
    ts = np.where(rng.random((rows, w)) < live, rng.integers(1, 1 << 20, (rows, w)), 0)
    score = np.where(ts > 0, rng.integers(I32_MIN + 1, I32_MAX, (rows, w), dtype=np.int64), NEG_INF)
    dc = np.where(ts > 0, rng.integers(-1, D + 1, (rows, w)), 0)
    out = [x.astype(np.int32) for x in (score, dc, ts)]
    for x in out:
        x[:, 1::7] = x[:, 0::7][:, : x[:, 1::7].shape[1]]
    return tuple(out)


def canonical_rows(side):
    """Each row's live slots (ts > 0) unique and best-first by (score desc,
    ts desc, dc asc), then holes: the slot invariant of an engine state."""
    score, dc, ts = side
    out = [np.full_like(score, NEG_INF), np.zeros_like(dc), np.zeros_like(ts)]
    for r in range(score.shape[0]):
        live = ts[r] > 0
        trip = np.unique(np.stack([score[r][live], ts[r][live], dc[r][live]], 1), axis=0)
        trip = trip[np.lexsort((trip[:, 2], -trip[:, 1].astype(np.int64), -trip[:, 0].astype(np.int64)))]
        n = len(trip)
        out[0][r, :n], out[2][r, :n], out[1][r, :n] = trip[:, 0], trip[:, 1], trip[:, 2]
    return tuple(out)


@pytest.mark.parametrize("w", [kernels.WIDE_MAX_SLOTS + 1, 16_800])
def test_k3_wider_than_shared_memory_fused_matches_union_join(w):
    # The rows the card's global-scratch path takes; JAX's union join
    # wants two sides of one width, so at odd W side b gets one hole more,
    # which a fused join ranks last and which changes no kept slot.
    rng = np.random.default_rng(w)
    D, rows = 5, 1
    ka, kb = (w + 1) // 2, w // 2
    a = canonical_rows(wide_rows(rng, rows, ka, D))
    b = wide_rows(rng, rows, kb, D)
    b[0][:, ::3], b[1][:, ::3], b[2][:, ::3] = (x[:, :ka:3][:, : b[0][:, ::3].shape[1]] for x in a)  # cross-side dups
    b = canonical_rows(b)
    rmv_vc = rng.integers(0, 1 << 20, (rows, D)).astype(np.int32)
    m = w // 2
    pad = tuple(np.concatenate([x, np.full((rows, ka - kb), f, np.int32)], -1) for x, f in zip(b, (NEG_INF, 0, 0)))
    want = _join_slots_union(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, pad)), jnp.asarray(rmv_vc), m)
    got = kernels.sort_slots([tuple(map(t, a)), tuple(map(t, b))], m, rmv_vc=t(rmv_vc))
    assert 0 < int(got[3][0]) < m
    for g, x in zip(got, want):
        assert eq(g, x)


@pytest.mark.parametrize("w", [kernels.WIDE_MAX_SLOTS + 1, 16_800])
def test_k3_wider_than_shared_memory_unfused_matches_xla_sort(w):
    rng = np.random.default_rng(w + 1)
    score, dc, ts = wide_rows(rng, 2, w, 5)
    m = w - w // 3
    want = _sort_slots(jnp.asarray(score), jnp.asarray(dc), jnp.asarray(ts), m)
    k = w // 2
    for sides in ([(score, dc, ts)], [(score[:, :k], dc[:, :k], ts[:, :k]), (score[:, k:], dc[:, k:], ts[:, k:])]):
        got = kernels.sort_slots([tuple(t(x) for x in s) for s in sides], m)
        for g, x in zip(got, want):
            assert eq(g, x)


def test_oddeven_network_matches_jax():
    # K3's register network for W <= 8 is spelled out in the CUDA source;
    # it must be the JAX package's oddeven_network(8), pair for pair.
    import re
    from pathlib import Path

    src = (Path(kernels.__file__).parent.parent / "csrc" / "sort_slots.cu").read_text()
    for n in (8,):
        body = re.search(rf"#define NET{n}\(X\)(.*?)\n(?:#|//)", src, re.S).group(1)
        pairs = [(int(i), int(j)) for i, j in re.findall(r"X\((\d+), (\d+)\)", body)]
        assert pairs == [tuple(p) for p in jpk.oddeven_network(n)]


def test_cpu_wrappers_do_not_count_launches():
    counters = (kernels.scatter_max_rows_, kernels.scatter_max_rows_copy, delta_place, kernels.sort_slots)
    before = [w.launches for w in counters]
    table, rows, upd = k1_inputs(5)
    scatter_max_rows(t(table), t(rows), t(upd))
    kernels.scatter_max_rows_(t(table), t(rows), t(upd))
    score, ts, dc, kid, rank, keep, T, M, _ = k2_inputs(0)
    delta_place(*(t(x) for x in (score, ts, dc, kid, rank, keep)), T, M)
    s, d, tt = raw_slots(np.random.default_rng(0), (4, 8), 3)
    kernels.sort_slots([(t(s), t(d), t(tt))], 4)
    assert [w.launches for w in counters] == before
