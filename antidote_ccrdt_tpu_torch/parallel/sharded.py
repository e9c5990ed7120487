"""Key/id-space sharding: scale one huge CRDT instance across a mesh.

Port of ``antidote_ccrdt_tpu/parallel/sharded.py``, over the port's
mesh of logical devices (``parallel.dist``: every ``shard_map`` there is
a loop over blocks here, every collective a function over the blocks of
one axis). The element-id space of a single huge instance (millions of
ids in one top-K) is sharded across the mesh's key axis the way
sequence-parallel attention shards tokens:

* **state** lives sharded: each key block owns a contiguous id range of
  the slot/tombstone tables ([..., I_local, ...]) — the big arrays never
  move; a block is a view of the global table;
* **ops** are broadcast (they are small); each shard masks the batch to
  its own id range and applies it locally with the inner engine (on a
  card, its kernels on the block) — no all-to-all of state;
* **reads** exchange only the top-K *frontier* per shard (K entries, not
  I_local) and re-rank globally with the same stable three-key order as
  JAX's ``lax.sort`` — the id-space analog of exchanging KV blocks
  instead of full activations.

`hierarchical_all_reduce` composes the inter-DC reconciliation over a
two-level (dcn, ici) mesh: a lattice all-reduce over "dc" first, then
over "dcn".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence

import torch

from ..models.topk_rmv_dense import Observed, TopkRmvDense, TopkRmvDenseState, TopkRmvOps, make_dense
from ..ops.dense_table import NEG_INF
from ..utils.tree import tree_map
from . import dist
from .dist import Mesh, P, lattice_all_reduce

I32 = torch.int32
INT32_MAX = 2**31 - 1


def make_mesh2(n_dcn: int, n_dc: int, n_key: int = 1, devices=None) -> Mesh:
    """A (dcn, dc, key) mesh: host groups x replica shards x id shards."""
    devs = list(devices) if devices is not None else dist.mesh_devices()
    n = n_dcn * n_dc * n_key
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return Mesh(dist.device_array(devs[:n], (n_dcn, n_dc, n_key)), ("dcn", "dc", "key"))


def hierarchical_all_reduce(
    grid: dist.Grid,
    merge: Callable[[Any, Any], Any],
    mesh: Mesh,
    ici_axis: str = "dc",
    dcn_axis: str = "dcn",
) -> dist.Grid:
    """All-reduce a grid of blocks with the CRDT merge over two mesh
    levels: `ici_axis` first, then one exchange per host group over
    `dcn_axis`."""
    grid = dist.along(grid, mesh, ici_axis, lambda col: lattice_all_reduce(col, merge))
    return dist.along(grid, mesh, dcn_axis, lambda col: lattice_all_reduce(col, merge))


def _join_over_mesh_axes(grid: dist.Grid, merge, mesh: Mesh, dc_axis: str) -> dist.Grid:
    """Replica join over 'dc' (and 'dcn' when the mesh has one) — shared
    by every id-sharded engine's merge_replicas."""
    out = dist.along(grid, mesh, dc_axis, lambda col: lattice_all_reduce(col, merge))
    if "dcn" in mesh.shape:
        out = dist.along(out, mesh, "dcn", lambda col: lattice_all_reduce(col, merge))
    return out


def _gather_frontier(blocks: Sequence[Any]) -> Any:
    """The [R, NK, K] frontiers of the id shards along one key line,
    all_gathered and the shard axis flattened into the trailing candidate
    axis -> [R, NK, n_shards*K]. The payload is O(K) per shard — the
    whole point of the frontier-exchange read path."""
    g = dist.all_gather(blocks)[0]
    return tree_map(lambda a: torch.movedim(a, 0, -2).reshape(a.shape[1], a.shape[2], -1), g)


def _place(mesh: Mesh, state: Any, specs: Any) -> Any:
    """`state` placed on `mesh` leaf by leaf with `specs`."""
    return tree_map(lambda a, s: dist.device_put(a, dist.NamedSharding(mesh, s)), state, specs)


def _stable_lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """The permutation along the last axis that ``lax.sort(..., num_keys=
    len(keys))`` applies: ascending by keys[0], then keys[1], ..., ties
    keeping input order (stable sorts from the least significant key)."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, -1, perm)
        order = torch.sort(k, dim=-1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, -1, order)
    return perm


def _key_lines(mesh: Mesh, key_axis: str) -> List[List[dist.Pos]]:
    """The positions of each line along `key_axis`, one line per index of
    the other axes, in mesh order."""
    lines = {}
    for pos in mesh.positions():
        rest = tuple(i for a, i in zip(mesh.axis_names, pos) if a != key_axis)
        lines.setdefault(rest, []).append(pos)
    return list(lines.values())


def _rerank(mesh: Mesh, key_axis: str, frontiers: dist.Grid, rank: Callable[[Any], Any]) -> dist.Grid:
    """Every block of a key line gets `rank` of the line's gathered
    frontiers: computed once a line, as every shard of the line computes
    the same values from the same all_gather."""
    out: dist.Grid = {}
    for line in _key_lines(mesh, key_axis):
        got = rank(_gather_frontier([frontiers[p] for p in line]))
        for p in line:
            out[p] = got
    return out


@dataclasses.dataclass(frozen=True)
class IdShardedTopkRmv:
    """One topk_rmv instance whose id space is sharded over a mesh axis.

    `inner` is the per-shard dense engine (n_ids = I_global / n_shards);
    every state it produces has layout [R, NK, I_local, ...] per shard.
    The global engine presents:

    * `init()` — sharded fresh state placed on the mesh;
    * `apply_ops(state, ops)` — ops carry GLOBAL ids; each shard masks to
      its range and rebases (ops are replicated over 'key', state stays
      put);
    * `observe(state)` — per-shard top-K, frontier gather over 'key',
      global re-rank (ids reported global);
    * `merge_replicas(state)` — the inter-DC join over 'dc' (and 'dcn' if
      present), run entirely shard-local: the join never crosses id
      ranges, so id sharding composes with replica merging for free.
    """

    inner: TopkRmvDense
    mesh: Mesh
    n_replicas: int
    key_axis: str = "key"
    dc_axis: str = "dc"

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.key_axis]

    @property
    def i_global(self) -> int:
        return self.inner.I * self.n_shards

    def _state_spec(self):
        """Per-leaf PartitionSpecs. The slot/tombstone tables shard their
        id axis (axis 2); vc and lossy have no id axis, so the sharded
        layout gives them an explicit shard axis at position 1 (each
        shard's vc covers only the adds it saw — the global vc is the max
        over shards)."""
        dc, key = self.dc_axis, self.key_axis
        table = P(dc, None, key)
        return TopkRmvDenseState(
            slot_score=table,
            slot_dc=table,
            slot_ts=table,
            rmv_vc=table,
            vc=P(dc, key),
            lossy=P(dc, key),
        )

    def init(self) -> Any:
        """Sharded fresh state: tables [R, NK, I_global, ...], vc/lossy
        carry the extra shard axis [R, n_shards, NK, ...]."""
        R, NSH, NK = self.n_replicas, self.n_shards, 1
        Dd, I_g, M = self.inner.D, self.i_global, self.inner.M
        dev = self.mesh.device
        return _place(self.mesh, TopkRmvDenseState(
            slot_score=torch.full((R, NK, I_g, M), NEG_INF, dtype=I32, device=dev),
            slot_dc=torch.zeros((R, NK, I_g, M), dtype=I32, device=dev),
            slot_ts=torch.zeros((R, NK, I_g, M), dtype=I32, device=dev),
            rmv_vc=torch.zeros((R, NK, I_g, Dd), dtype=I32, device=dev),
            vc=torch.zeros((R, NSH, NK, Dd), dtype=I32, device=dev),
            lossy=torch.zeros((R, NSH, NK), dtype=torch.bool, device=dev),
        ), self._state_spec())

    @staticmethod
    def _to_local(st):
        """Drop a block's singleton vc/lossy shard axis so the leaves
        match the inner engine's layout."""
        return TopkRmvDenseState(
            slot_score=st.slot_score,
            slot_dc=st.slot_dc,
            slot_ts=st.slot_ts,
            rmv_vc=st.rmv_vc,
            vc=st.vc[:, 0],
            lossy=st.lossy[:, 0],
        )

    @staticmethod
    def _from_local(st):
        return TopkRmvDenseState(
            slot_score=st.slot_score,
            slot_dc=st.slot_dc,
            slot_ts=st.slot_ts,
            rmv_vc=st.rmv_vc,
            vc=st.vc[:, None],
            lossy=st.lossy[:, None],
        )

    # -- sharded application ------------------------------------------------

    def _mask_to_shard(self, ops: TopkRmvOps, shard: int) -> TopkRmvOps:
        """Keep only ops whose GLOBAL id falls in `shard`'s range, rebased
        to local ids; foreign ops become padding (add_ts 0, rmv_id -1).
        O(B) elementwise work on every shard instead of an all-to-all."""
        I_loc = self.inner.I
        lo = shard * I_loc
        a_mine = (ops.add_id >= lo) & (ops.add_id < lo + I_loc)
        r_mine = (ops.rmv_id >= lo) & (ops.rmv_id < lo + I_loc)
        return TopkRmvOps(
            add_key=ops.add_key,
            add_id=torch.where(a_mine, ops.add_id - lo, 0),
            add_score=ops.add_score,
            add_dc=ops.add_dc,
            add_ts=torch.where(a_mine, ops.add_ts, 0),  # 0 = padding
            rmv_key=ops.rmv_key,
            rmv_id=torch.where(r_mine, ops.rmv_id - lo, -1),  # -1 = padding
            rmv_vc=ops.rmv_vc,
        )

    def apply_ops(self, state: Any, ops: TopkRmvOps) -> Any:
        """ops leaves are [R, B] with global ids, replicated over 'key' and
        sharded over 'dc' like the state's replica axis."""
        spec_state = self._state_spec()

        def local(pos, st, op):
            op = self._mask_to_shard(op, self.mesh.index(pos, self.key_axis))
            st2, _ = self.inner.apply_ops(self._to_local(st), op, collect_dominated=False)
            return self._from_local(st2)

        fn = dist.shard_map(lambda gs, go: dist.each(gs, local, go), self.mesh,
                            (spec_state, TopkRmvOps(*([P(self.dc_axis)] * 8))), spec_state)
        return fn(state, ops)

    # -- reads: frontier exchange ------------------------------------------

    def observe(self, state: Any) -> Observed:
        """Global observable top-K: local top-K per shard (payload K, not
        I_local), gathered over the id shards, re-ranked by the reference
        cmp order (score desc, id desc, ts desc)."""
        K, I_loc = self.inner.K, self.inner.I

        def local(pos, st):
            obs = self.inner.observe(self._to_local(st))  # [R_loc, NK, K] local ids
            shard = self.mesh.index(pos, self.key_axis)
            gids = torch.where(obs.valid, obs.ids + shard * I_loc, -1).to(I32)
            return Observed(gids, obs.scores, obs.dcs, obs.tss, obs.valid)

        def rank(cat):
            # -INT32_MIN wraps to INT32_MIN in int32, as in XLA.
            keys = (torch.where(cat.valid, -cat.scores, INT32_MAX), -cat.ids, -cat.tss)
            perm = _stable_lexsort(keys)
            ns, ni, nt, dc_f, valid_f = (torch.gather(x, -1, perm)[..., :K] for x in (*keys, cat.dcs, cat.valid))
            return Observed(ids=-ni, scores=-ns, dcs=dc_f, tss=-nt, valid=valid_f)

        out = P(self.dc_axis, None, None)
        fn = dist.shard_map(
            lambda g: _rerank(self.mesh, self.key_axis, dist.each(g, local), rank),
            self.mesh, (self._state_spec(),), Observed(out, out, out, out, out))
        return fn(state)

    # -- inter-DC reconciliation -------------------------------------------

    def merge_replicas(self, state: Any) -> Any:
        """Join all replica rows over the 'dc' axis (and 'dcn' when the
        mesh has one), shard-local in the id dimension: every replica ends
        up with the converged state for the shard's id range."""
        spec_state = self._state_spec()

        def blocks(g):
            local = dist.each(g, lambda _pos, st: self._to_local(st))
            merged = _join_over_mesh_axes(local, self.inner.merge, self.mesh, self.dc_axis)
            return dist.each(merged, lambda _pos, st: self._from_local(st))

        return dist.shard_map(blocks, self.mesh, (spec_state,), spec_state)(state)


def make_id_sharded_topk_rmv(
    mesh: Mesh,
    n_ids_global: int,
    n_dcs: int,
    size: int = 100,
    slots_per_id: int = 4,
    n_replicas: Optional[int] = None,
    key_axis: str = "key",
    dc_axis: str = "dc",
) -> IdShardedTopkRmv:
    n_shards = mesh.shape[key_axis]
    assert n_ids_global % n_shards == 0, (n_ids_global, n_shards)
    inner = make_dense(
        n_ids=n_ids_global // n_shards,
        n_dcs=n_dcs,
        size=size,
        slots_per_id=slots_per_id,
        device=mesh.device,
    )
    if n_replicas is None:
        n_replicas = mesh.shape[dc_axis]
    return IdShardedTopkRmv(
        inner=inner,
        mesh=mesh,
        n_replicas=n_replicas,
        key_axis=key_axis,
        dc_axis=dc_axis,
    )


# --- shared skeleton: score-table engines (leaderboard, topk) -------------


@dataclasses.dataclass(frozen=True)
class _ShardedScoreTable:
    """Shared id-space-sharded skeleton for the flat score-table engines
    (whose dense state is [R, NK, P]-shaped planes and whose observe
    returns (ids, scores, valid)): per-shard masked application, frontier
    exchange + (score desc, id desc) re-rank, shard-local replica join.
    Subclasses supply the state spec/init, the op masker, and the local
    id-range size."""

    inner: Any
    mesh: Mesh
    n_replicas: int
    key_axis: str = "key"
    dc_axis: str = "dc"

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.key_axis]

    def _local_size(self) -> int:
        raise NotImplementedError

    def _state_spec(self):
        raise NotImplementedError

    def _ops_spec(self):
        raise NotImplementedError

    def _mask_to_shard(self, ops: Any, shard: int) -> Any:
        raise NotImplementedError

    def _place(self, state: Any) -> Any:
        return _place(self.mesh, state, self._state_spec())

    def apply_ops(self, state: Any, ops: Any) -> Any:
        def local(pos, st, op):
            st2, _ = self.inner.apply_ops(st, self._mask_to_shard(op, self.mesh.index(pos, self.key_axis)))
            return st2

        fn = dist.shard_map(lambda gs, go: dist.each(gs, local, go), self.mesh,
                            (self._state_spec(), self._ops_spec()), self._state_spec())
        return fn(state, ops)

    def observe(self, state: Any):
        """Global top-K: per-shard masked top-K (payload K, not the local
        table width), frontier gather over the id shards, global re-rank
        by (score desc, id desc) — the shared cmp order of topk.erl:83 /
        leaderboard.erl:289-294."""
        K, loc = self.inner.K, self._local_size()

        def local(pos, st):
            ids, scores, valid = self.inner.observe(st)
            gids = torch.where(valid, ids + self.mesh.index(pos, self.key_axis) * loc, -1).to(I32)
            return gids, scores, valid

        def rank(cat):
            cat_i, cat_s, cat_v = cat
            k0 = torch.where(cat_v, -cat_s, INT32_MAX)
            perm = _stable_lexsort((k0, -cat_i))
            ns, ni, v_f = (torch.gather(x, -1, perm)[..., :K] for x in (k0, -cat_i, cat_v))
            return -ni, -ns, v_f

        out = P(self.dc_axis, None, None)
        fn = dist.shard_map(
            lambda g: _rerank(self.mesh, self.key_axis, dist.each(g, local), rank),
            self.mesh, (self._state_spec(),), (out, out, out))
        return fn(state)

    def merge_replicas(self, state: Any) -> Any:
        spec = self._state_spec()
        return dist.shard_map(
            lambda g: _join_over_mesh_axes(g, self.inner.merge, self.mesh, self.dc_axis),
            self.mesh, (spec,), spec)(state)


# --- player-space-sharded leaderboard -------------------------------------


@dataclasses.dataclass(frozen=True)
class IdShardedLeaderboard(_ShardedScoreTable):
    """One leaderboard whose PLAYER space is sharded over a mesh axis —
    the second instantiation of the long-context-analog design (cf.
    `IdShardedTopkRmv`): the lattice (per-player max, ban-or) has no
    vc/lossy side planes, so the sharded layout is purely the player axis
    and the replica join is shard-local elementwise max/or. Ban-wins
    (leaderboard.erl:21-27) survives sharding: bans live on the banned
    player's shard and mask its frontier contribution."""

    @property
    def p_global(self) -> int:
        return self.inner.P * self.n_shards

    def _local_size(self) -> int:
        return self.inner.P

    def _state_spec(self):
        from ..models.leaderboard import LeaderboardDenseState

        table = P(self.dc_axis, None, self.key_axis)
        return LeaderboardDenseState(best_score=table, banned=table)

    def _ops_spec(self):
        from ..models.leaderboard import LeaderboardOps

        return LeaderboardOps(*([P(self.dc_axis)] * 7))

    def init(self) -> Any:
        from ..models.leaderboard import LeaderboardDenseState

        R, NK, Pg = self.n_replicas, 1, self.p_global
        dev = self.mesh.device
        return self._place(
            LeaderboardDenseState(
                best_score=torch.full((R, NK, Pg), NEG_INF, dtype=I32, device=dev),
                banned=torch.zeros((R, NK, Pg), dtype=torch.bool, device=dev),
            )
        )

    def _mask_to_shard(self, ops: Any, shard: int) -> Any:
        from ..models.leaderboard import LeaderboardOps

        P_loc = self.inner.P
        lo = shard * P_loc
        a_mine = ops.add_valid & (ops.add_id >= lo) & (ops.add_id < lo + P_loc)
        b_mine = ops.ban_valid & (ops.ban_id >= lo) & (ops.ban_id < lo + P_loc)
        return LeaderboardOps(
            add_key=ops.add_key,
            add_id=torch.where(a_mine, ops.add_id - lo, 0),
            add_score=ops.add_score,
            add_valid=a_mine,
            ban_key=ops.ban_key,
            ban_id=torch.where(b_mine, ops.ban_id - lo, 0),
            ban_valid=b_mine,
        )


def make_id_sharded_leaderboard(
    mesh: Mesh,
    n_players_global: int,
    size: int = 100,
    n_replicas: Optional[int] = None,
    key_axis: str = "key",
    dc_axis: str = "dc",
) -> IdShardedLeaderboard:
    from ..models.leaderboard import make_dense as mk_lb

    n_shards = mesh.shape[key_axis]
    assert n_players_global % n_shards == 0, (n_players_global, n_shards)
    inner = mk_lb(n_players=n_players_global // n_shards, size=size, device=mesh.device)
    if n_replicas is None:
        n_replicas = mesh.shape[dc_axis]
    return IdShardedLeaderboard(
        inner=inner,
        mesh=mesh,
        n_replicas=n_replicas,
        key_axis=key_axis,
        dc_axis=dc_axis,
    )


# --- id-space-sharded topk (bounded score table, no bans) -----------------


@dataclasses.dataclass(frozen=True)
class IdShardedTopk(_ShardedScoreTable):
    """`topk`'s turn on the shared skeleton: the dense engine is a single
    best-score table (models/topk.py), i.e. the leaderboard pattern minus
    the ban plane."""

    @property
    def i_global(self) -> int:
        return self.inner.I * self.n_shards

    def _local_size(self) -> int:
        return self.inner.I

    def _state_spec(self):
        from ..models.topk import TopkDenseState

        return TopkDenseState(best_score=P(self.dc_axis, None, self.key_axis))

    def _ops_spec(self):
        from ..models.topk import TopkOps

        return TopkOps(*([P(self.dc_axis)] * 4))

    def init(self) -> Any:
        from ..models.topk import TopkDenseState

        return self._place(
            TopkDenseState(
                best_score=torch.full(
                    (self.n_replicas, 1, self.i_global), NEG_INF, dtype=I32, device=self.mesh.device
                )
            )
        )

    def _mask_to_shard(self, ops: Any, shard: int) -> Any:
        from ..models.topk import TopkOps

        I_loc = self.inner.I
        lo = shard * I_loc
        mine = ops.valid & (ops.id >= lo) & (ops.id < lo + I_loc)
        return TopkOps(
            key=ops.key,
            id=torch.where(mine, ops.id - lo, 0),
            score=ops.score,
            valid=mine,
        )


def make_id_sharded_topk(
    mesh: Mesh,
    n_ids_global: int,
    size: int = 100,
    n_replicas: Optional[int] = None,
    key_axis: str = "key",
    dc_axis: str = "dc",
) -> IdShardedTopk:
    from ..models.topk import make_dense as mk_topk

    n_shards = mesh.shape[key_axis]
    assert n_ids_global % n_shards == 0, (n_ids_global, n_shards)
    inner = mk_topk(n_ids=n_ids_global // n_shards, size=size, device=mesh.device)
    if n_replicas is None:
        n_replicas = mesh.shape[dc_axis]
    return IdShardedTopk(
        inner=inner,
        mesh=mesh,
        n_replicas=n_replicas,
        key_axis=key_axis,
        dc_axis=dc_axis,
    )


# --- vocab-space-sharded wordcount (MONOID: psum reconciliation) ----------


@dataclasses.dataclass(frozen=True)
class VocabShardedWordcount:
    """One wordcount instance whose VOCAB space is sharded over a mesh
    axis — the MONOID member of the id-space-sharding family. Same data
    movement as the JOIN engines: the count table never moves, ops are
    replicated over 'key' and each shard masks the token batch to its
    bucket range; but reconciliation is a `psum` over 'dc' (replica rows
    are deltas, MergeKind.MONOID) — no frontier exchange, reads are
    already local per shard.

    Out-of-global-range tokens are counted in `lost` by shard 0 only
    (every shard sees every op; without a canonical owner the lost
    counter would multiply by n_shards). Within-shard overflow cannot
    happen: the mask rebases tokens into [0, V_local)."""

    inner: Any  # WordcountDense over V_local buckets
    mesh: Mesh
    n_replicas: int
    key_axis: str = "key"
    dc_axis: str = "dc"

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.key_axis]

    @property
    def v_global(self) -> int:
        return self.inner.V * self.n_shards

    def _state_spec(self):
        from ..models.wordcount import WordcountDenseState

        # counts shard their bucket axis; lost gains an explicit shard
        # axis at position 1 (same move as IdShardedTopkRmv's vc/lossy).
        return WordcountDenseState(
            counts=P(self.dc_axis, None, self.key_axis),
            lost=P(self.dc_axis, self.key_axis),
        )

    def init(self) -> Any:
        from ..models.wordcount import WordcountDenseState

        R, NK = self.n_replicas, 1
        dev = self.mesh.device
        state = WordcountDenseState(
            counts=torch.zeros((R, NK, self.v_global), dtype=I32, device=dev),
            lost=torch.zeros((R, self.n_shards, NK), dtype=I32, device=dev),
        )
        return _place(self.mesh, state, self._state_spec())

    def _mask_to_shard(self, ops: Any, shard: int) -> Any:
        from ..models.wordcount import WordcountOps

        V_loc = self.inner.V
        lo = shard * V_loc
        valid = ops.token >= 0
        mine = valid & (ops.token >= lo) & (ops.token < lo + V_loc)
        # Global overflow: only shard 0 counts it (token V_loc lands in
        # the inner engine's lost path).
        over = valid & (ops.token >= self.v_global) & (shard == 0)
        token = torch.where(mine, ops.token - lo, torch.where(over, V_loc, -1)).to(I32)
        return WordcountOps(key=ops.key, token=token)

    def apply_ops(self, state: Any, ops: Any) -> Any:
        """`ops` carry GLOBAL bucket ids, one batch per replica row,
        replicated over the vocab shards (they are small; the table is
        what must not move)."""
        from ..models.wordcount import WordcountDenseState, WordcountOps

        def local(pos, st, op):
            st_l = WordcountDenseState(counts=st.counts, lost=st.lost[:, 0])
            st2, _ = self.inner.apply_ops(st_l, self._mask_to_shard(op, self.mesh.index(pos, self.key_axis)))
            return WordcountDenseState(counts=st2.counts, lost=st2.lost[:, None])

        spec = self._state_spec()
        fn = dist.shard_map(lambda gs, go: dist.each(gs, local, go), self.mesh,
                            (spec, WordcountOps(P(self.dc_axis), P(self.dc_axis))), spec)
        return fn(state, ops)

    def global_counts(self, state: Any):
        """Reconciled global (counts [NK, V_global], lost [n_shards, NK])
        — counts stay vocab-sharded on the mesh (the read is local per
        shard); `lost` sums to the global overflow count."""
        from ..models.wordcount import WordcountDenseState

        def blocks(g):
            # Replica rows are deltas: the reconciled value is their SUM
            # (psum over 'dc' — the MONOID plane), shard-local in vocab.
            rows = dist.each(g, lambda _pos, st: WordcountDenseState(
                counts=st.counts.sum(0, dtype=I32), lost=st.lost.sum(0, dtype=I32)))
            return dist.along(rows, self.mesh, self.dc_axis, dist.psum)

        out = WordcountDenseState(counts=P(None, self.key_axis), lost=P(self.key_axis))
        return dist.shard_map(blocks, self.mesh, (self._state_spec(),), out)(state)


def make_vocab_sharded_wordcount(
    mesh: Mesh,
    n_buckets_global: int,
    n_replicas: Optional[int] = None,
    key_axis: str = "key",
    dc_axis: str = "dc",
) -> VocabShardedWordcount:
    from ..models.wordcount import make_dense as mk_wc

    n_shards = mesh.shape[key_axis]
    assert n_buckets_global % n_shards == 0, (n_buckets_global, n_shards)
    inner = mk_wc(n_buckets_global // n_shards, device=mesh.device)
    if n_replicas is None:
        n_replicas = mesh.shape[dc_axis]
    return VocabShardedWordcount(
        inner=inner,
        mesh=mesh,
        n_replicas=n_replicas,
        key_axis=key_axis,
        dc_axis=dc_axis,
    )
