"""Dense topk_rmv: batched add-wins top-K over [n_replicas, n_keys]
(port of ``antidote_ccrdt_tpu/models/topk_rmv_dense.py``).

State per (replica, instance), as in the JAX engine:

* ``slot_{score,dc,ts} i32[R, NK, I, M]`` — up to M live adds per id, kept
  best-first by (score desc, ts desc, dc asc); ``ts == 0`` marks an empty
  slot.
* ``rmv_vc i32[R, NK, I, D]`` — dense vector-clock tombstones.
* ``vc i32[R, NK, D]`` — max ts per DC over all adds seen.
* ``lossy bool[R, NK]`` — capacity-overflow flag.

Every function returns the JAX engine's result bit for bit. ``apply_ops``
turns a batch into a delta table (4-key sort, dedup, rank, placement) and
joins it with the state; ``merge`` is the same join between two states.
The three steps the JAX package also wrote as Pallas kernels run as CUDA
kernels on a card: the tombstone scatter-max (K1c, out of place,
``ops.kernels.scatter_max_rows_copy``), the delta placement (K2,
``ops.delta_place.delta_place``) and the slot join (K3,
``ops.kernels.sort_slots`` with the add-wins filter fused). The rest is
plain PyTorch on either device.

States are immutable: no method writes into a tensor it was given (the
old state is read again by ``collect_promotions``, and ``DenseReplay``'s
broadcast rows are views of one row, which K1c reads in place).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.behaviour import MergeKind, registry
from ..device import DeviceLike, resolve_device
from ..ops.delta_place import delta_place
from ..ops.dense_table import (
    NEG_INF,
    masked_topk,
    neg_i32,
    observe_value,
    promotion_mask,
    scatter_max_rows,
)
from ..ops.kernels import dom_lookup, sort_slots

I32 = torch.int32


@dataclasses.dataclass
class TopkRmvDenseState:
    slot_score: torch.Tensor  # i32[R, NK, I, M]
    slot_dc: torch.Tensor  # i32[R, NK, I, M]
    slot_ts: torch.Tensor  # i32[R, NK, I, M]; 0 = empty
    rmv_vc: torch.Tensor  # i32[R, NK, I, D]
    vc: torch.Tensor  # i32[R, NK, D]
    lossy: torch.Tensor  # bool[R, NK]


@dataclasses.dataclass
class TopkRmvOps:
    """One batch of effect ops per replica. Padding: add_ts <= 0 / rmv
    invalid via rmv_id < 0."""

    add_key: torch.Tensor  # i32[R, B]   instance index
    add_id: torch.Tensor  # i32[R, B]   element id in [0, I)
    add_score: torch.Tensor  # i32[R, B]
    add_dc: torch.Tensor  # i32[R, B]
    add_ts: torch.Tensor  # i32[R, B]   <= 0 marks padding
    rmv_key: torch.Tensor  # i32[R, Br]
    rmv_id: torch.Tensor  # i32[R, Br]  < 0 marks padding
    rmv_vc: torch.Tensor  # i32[R, Br, D]


class Observed(NamedTuple):
    """Derived observable top-K (score-desc order)."""

    ids: torch.Tensor  # i32[..., K]
    scores: torch.Tensor  # i32[..., K]
    dcs: torch.Tensor  # i32[..., K]
    tss: torch.Tensor  # i32[..., K]
    valid: torch.Tensor  # bool[..., K]


class TopkRmvExtras(NamedTuple):
    """Extra effect ops generated by a batch (see the JAX engine's
    ``TopkRmvExtras``): op-aligned dominated flags and vcs
    (``collect_dominated=True``), the id-keyed dominated table
    (``"table"``) and the promoted observable (``collect_promotions``)."""

    dominated: Optional[torch.Tensor]  # bool[R, B]
    dominated_vc: Optional[torch.Tensor]  # i32[R, B, D]
    promoted: Optional[Observed]
    dominated_tbl: Optional[torch.Tensor] = None  # bool[R, NK, I]


class AddStream(NamedTuple):
    """A batch's adds in delta order, per replica ([R, B] each)."""

    score: torch.Tensor  # i32
    ts: torch.Tensor  # i32
    dc: torch.Tensor  # i32
    kid: torch.Tensor  # i32: the sort key key*I + id, NK*I for invalid adds (nondecreasing)
    kid3: torch.Tensor  # i32: kid of live entries, NK*I otherwise
    rank: torch.Tensor  # i32: rank within the kid group
    keep: torch.Tensor  # bool: live and rank < M (placed)
    overflow: torch.Tensor  # bool: live and rank >= M (dropped; lossy)


def _live_mask(dc, ts, rmv_vc):
    """Add-wins survival predicate: ts strictly newer than the tombstone
    at the slot's origin DC. rmv_vc [..., D] broadcasts over the slot
    axis of dc/ts [..., M]."""
    M = dc.shape[-1]
    rv = rmv_vc.unsqueeze(-2).expand(*rmv_vc.shape[:-1], M, rmv_vc.shape[-1])
    return ts > dom_lookup(dc[..., None], rv)[..., 0]


def _cmp_better(s1, t1, d1, s2, t2, d2):
    """Strictly-better under the slot order (score desc, ts desc, dc asc)."""
    return (s1 > s2) | ((s1 == s2) & (t1 > t2)) | ((s1 == s2) & (t1 == t2) & (d1 < d2))


def _join_slots(a, b, rmv_vc, m_keep: int):
    """Join two per-id slot lists that each keep the slot invariant
    (sorted, exact-dup-free, holes at the end): add-wins filter ->
    cross-side dedup -> rank-arithmetic merge of the two sorted lists ->
    keep best m_keep. The independent reference the union join (K3 fused,
    ``sort_slots``) is tested against, as in the JAX package. Returns
    (score, dc, ts, n_live)."""
    a_s, a_d, a_t = a
    b_s, b_d, b_t = b
    live_a = _live_mask(a_d, a_t, rmv_vc)
    live_b = _live_mask(b_d, b_t, rmv_vc)

    def A(x):
        return x[..., :, None]

    def B(x):
        return x[..., None, :]

    a_beats_b = _cmp_better(A(a_s), A(a_t), A(a_d), B(b_s), B(b_t), B(b_d))
    eq = (A(a_s) == B(b_s)) & (A(a_t) == B(b_t)) & (A(a_d) == B(b_d))
    live_b = live_b & ~(eq & A(live_a)).any(-2)
    b_beats_a = ~a_beats_b & ~eq

    la = live_a.to(I32)
    lb = live_b.to(I32)
    pref_a = torch.cumsum(la, -1, dtype=I32) - la
    pref_b = torch.cumsum(lb, -1, dtype=I32) - lb
    r_a = pref_a + (b_beats_a & B(live_b)).sum(-1, dtype=I32)
    r_b = pref_b + (a_beats_b & A(live_a)).sum(-2, dtype=I32)
    r_a = torch.where(live_a, r_a, 2 * a_s.shape[-1])
    r_b = torch.where(live_b, r_b, 2 * b_s.shape[-1])

    ranks = torch.arange(m_keep, dtype=I32, device=a_s.device)
    oh_a = r_a[..., :, None] == ranks
    oh_b = r_b[..., :, None] == ranks

    def place(xa, xb, empty):
        out = torch.where(oh_a, xa[..., :, None], 0).sum(-2, dtype=I32) + torch.where(
            oh_b, xb[..., :, None], 0
        ).sum(-2, dtype=I32)
        filled = oh_a.any(-2) | oh_b.any(-2)
        return torch.where(filled, out, empty)

    n_live = la.sum(-1, dtype=I32) + lb.sum(-1, dtype=I32)
    return place(a_s, b_s, NEG_INF), place(a_d, b_d, 0), place(a_t, b_t, 0), n_live


def _roll1(x: torch.Tensor) -> torch.Tensor:
    """x shifted right by one along the last axis (jnp.roll(x, 1))."""
    return torch.roll(x, 1, dims=-1)


def _first_false(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0] = False
    return x


def _sort_adds(kid, score, ts, dc):
    """Permutation sorting each replica's adds by (kid asc, -score asc,
    -ts asc, dc asc), negations in int32 — JAX's 4-key ``lax.sort``
    (:567). Two stable int64 sorts of exactly packed key pairs, the minor
    pair first."""
    low = neg_i32(ts) * 2**32 + (dc.to(torch.int64) + 2**31)
    high = kid.to(torch.int64) * 2**32 + (neg_i32(score) + 2**31)
    p1 = torch.sort(low, dim=-1, stable=True).indices
    p2 = torch.sort(torch.gather(high, -1, p1), dim=-1, stable=True).indices
    return torch.gather(p1, -1, p2)


class TopkRmvDense:
    """Batched topk_rmv over a [n_replicas, n_keys] grid of instances.

    Static config: I = element-id space per instance, M = live-add capacity
    per id, D = number of DCs, K = observable top-K size. ``device``: where
    `init` puts states (default: the CUDA card; raises without one). On a
    card the slot join's kernel takes 2M <= ``ops.kernels.GLOBAL_MAX_SLOTS``
    candidates.
    """

    type_name = "topk_rmv"
    merge_kind = MergeKind.JOIN
    # The extras mode that carries replication at replication-realistic
    # cost (DenseReplay reads it).
    replication_extras_kwargs = {"collect_dominated": "table"}

    def __init__(
        self,
        n_ids: int,
        n_dcs: int,
        size: int = 100,
        slots_per_id: int = 4,
        device: DeviceLike = None,
    ):
        self.I = n_ids
        self.D = n_dcs
        self.K = size
        self.M = slots_per_id
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int = 1) -> TopkRmvDenseState:
        shape = (n_replicas, n_keys, self.I, self.M)
        dev = self.device
        return TopkRmvDenseState(
            slot_score=torch.full(shape, NEG_INF, dtype=I32, device=dev),
            slot_dc=torch.zeros(shape, dtype=I32, device=dev),
            slot_ts=torch.zeros(shape, dtype=I32, device=dev),
            rmv_vc=torch.zeros((n_replicas, n_keys, self.I, self.D), dtype=I32, device=dev),
            vc=torch.zeros((n_replicas, n_keys, self.D), dtype=I32, device=dev),
            lossy=torch.zeros((n_replicas, n_keys), dtype=torch.bool, device=dev),
        )

    # -- op application ----------------------------------------------------

    def apply_ops(
        self,
        state: TopkRmvDenseState,
        ops: TopkRmvOps,
        collect_promotions: bool = False,
        collect_dominated=True,
    ) -> Tuple[TopkRmvDenseState, TopkRmvExtras]:
        """Apply one effect-op batch per replica.

        `collect_dominated`: ``False`` (no dominated extras), ``"table"``
        (id-keyed dominated table, the replication default) or ``True``
        (op-aligned flags + per-op vc rows). The state result is identical
        in all three."""
        if collect_dominated not in (False, True, "table"):
            raise ValueError(f"collect_dominated must be False, True or 'table', not {collect_dominated!r}")
        old_observed = self.observe(state) if collect_promotions else None

        rmv_vc_new = self._updated_tombstones_batched(state, ops)
        new_state, dom_tbl = self._apply_replicas(
            state, ops, rmv_vc_new, want_dominated_tbl=collect_dominated == "table"
        )

        dominated = dom_vc = None
        if collect_dominated is True:
            dominated, dom_vc = self._dominated(ops, rmv_vc_new)
        promoted = None
        if collect_promotions:
            promoted = self._promotions(old_observed, self.observe(new_state), ops)
        return new_state, TopkRmvExtras(dominated, dom_vc, promoted, dom_tbl)

    def _add_valid(self, ops: TopkRmvOps, NK: int) -> torch.Tensor:
        return (
            (ops.add_ts > 0)
            & (ops.add_key >= 0) & (ops.add_key < NK)
            & (ops.add_id >= 0) & (ops.add_id < self.I)
            & (ops.add_dc >= 0) & (ops.add_dc < self.D)
        )

    def _updated_tombstones_batched(self, state: TopkRmvDenseState, ops: TopkRmvOps) -> torch.Tensor:
        """Post-batch tombstone table [R, NK, I, D]: stored vcs merged with
        this batch's removals (K1c). Invalid removals map to the sentinel
        row NK*I, which the scatter drops."""
        R, NK = state.rmv_vc.shape[:2]
        I, D = self.I, self.D
        rmv_valid = (
            (ops.rmv_id >= 0) & (ops.rmv_id < I) & (ops.rmv_key >= 0) & (ops.rmv_key < NK)
        )
        rrow = torch.where(rmv_valid, ops.rmv_key * I + ops.rmv_id, NK * I).to(I32)
        table = state.rmv_vc.reshape(R, NK * I, D)
        out = scatter_max_rows(table, rrow, ops.rmv_vc.to(I32))
        return out.view(R, NK, I, D)

    def _dominated(self, ops: TopkRmvOps, rmv_vc: torch.Tensor):
        """Extras-only: which adds hit a stored-or-batch tombstone (:234),
        and the removal vc each should re-broadcast. Invalid adds gather
        nothing."""
        R, NK = rmv_vc.shape[:2]
        I, D = self.I, self.D
        valid = self._add_valid(ops, NK)
        row = torch.where(valid, ops.add_key * I + ops.add_id, 0).to(torch.int64)
        table = rmv_vc.reshape(R, NK * I, D)
        dom_vc_row = torch.gather(table, 1, row[..., None].expand(R, row.shape[1], D))
        dom_vc_row = torch.where(valid[..., None], dom_vc_row, 0)
        dc = ops.add_dc.clamp(0, D - 1).to(torch.int64)
        dom_at_dc = torch.gather(dom_vc_row, -1, dc[..., None])[..., 0]
        return valid & (dom_at_dc >= ops.add_ts), dom_vc_row

    def add_stream(self, ops: TopkRmvOps, n_keys: int, add_valid: Optional[torch.Tensor] = None) -> "AddStream":
        """Each replica's adds sorted by (kid, score desc, ts desc, dc
        asc), exact duplicates dropped (they must not consume a rank),
        ranked within each kid group (cumsum + running group base). The
        input of the delta placement (K2); invalid adds sort last under
        the sentinel kid NK*I."""
        NK, I, M = n_keys, self.I, self.M
        if (NK + 1) * I >= 2**31:
            raise ValueError("kid packing overflows int32; shrink n_keys * n_ids")
        if add_valid is None:
            add_valid = self._add_valid(ops, NK)
        kid = torch.where(add_valid, ops.add_key * I + ops.add_id, NK * I).to(I32)
        perm = _sort_adds(kid, ops.add_score, ops.add_ts, ops.add_dc)
        s_kid = torch.gather(kid, -1, perm)
        s_score = torch.gather(ops.add_score.to(I32), -1, perm)
        s_ts = torch.gather(ops.add_ts.to(I32), -1, perm)
        s_dc = torch.gather(ops.add_dc.to(I32), -1, perm)
        dup = _first_false(
            (s_kid == _roll1(s_kid)) & (s_score == _roll1(s_score))
            & (s_ts == _roll1(s_ts)) & (s_dc == _roll1(s_dc))
        )
        live = (s_kid < NK * I) & ~dup
        li = live.to(I32)
        grp_start = ~_first_false(s_kid == _roll1(s_kid))
        c = torch.cumsum(li, -1, dtype=I32)
        base = torch.cummax(torch.where(grp_start, c - li, -1), -1).values
        rank = (c - li - base).to(I32)
        return AddStream(
            score=s_score, ts=s_ts, dc=s_dc,
            kid=s_kid,
            kid3=torch.where(live, s_kid, NK * I).to(I32),
            rank=rank,
            keep=live & (rank < M),
            overflow=live & (rank >= M),
        )

    def _apply_replicas(self, state, ops, rmv_vc, want_dominated_tbl: bool = False):
        """Every replica at once (JAX's vmapped ``_apply_one_replica``):
        state leaves [R, NK, I, ...], op leaves [R, B]; `rmv_vc` is the
        post-batch tombstone table [R, NK, I, D]."""
        R, NK = state.slot_score.shape[:2]
        I, M, D = self.I, self.M, self.D
        dev = state.slot_score.device

        # 2. State vc advances on every valid add, dominated or not (:233):
        #    a max-scatter into [R, NK*D] with a trash column for invalid adds.
        add_valid = self._add_valid(ops, NK)
        slot = torch.where(add_valid, ops.add_key * D + ops.add_dc, NK * D).to(torch.int64)
        contrib = torch.where(add_valid, ops.add_ts, 0).to(I32)
        vc_hit = torch.zeros((R, NK * D + 1), dtype=I32, device=dev)
        vc_hit.scatter_reduce_(1, slot, contrib, "amax")
        vc = torch.maximum(state.vc, vc_hit[:, : NK * D].reshape(R, NK, D))

        # 3. Delta table: the sorted, deduped, ranked add stream, placed
        #    (K2) at (kid, rank) for its best M entries per kid. K2 takes the
        #    nondecreasing sort key `kid`; kid3 breaks the order at every
        #    dropped duplicate, and both agree on every kept entry.
        stream = self.add_stream(ops, NK, add_valid)
        s_key = torch.div(stream.kid3, I, rounding_mode="floor")
        key_hit = s_key[..., None] == torch.arange(NK, dtype=I32, device=dev)
        lossy = state.lossy | (stream.overflow[..., None] & key_hit).any(1)
        d_score, d_dc, d_ts = (
            x.view(R, NK, I, M)
            for x in delta_place(
                stream.score, stream.ts, stream.dc, stream.kid, stream.rank, stream.keep, NK * I, M
            )
        )

        # 4. Join (K3 fused): add-wins filter over both sides, sort, dedup,
        #    keep best M.
        f_score, f_dc, f_ts, n_live = sort_slots(
            (
                (state.slot_score.contiguous(), state.slot_dc.contiguous(), state.slot_ts.contiguous()),
                (d_score, d_dc, d_ts),
            ),
            M,
            rmv_vc=rmv_vc,
        )
        lossy = lossy | (n_live > M).any(-1)

        # 5. ("table" extras) a delta entry the add-wins filter kills is a
        #    dominated add.
        dom_tbl = None
        if want_dominated_tbl:
            dom_tbl = ((d_ts > 0) & ~_live_mask(d_dc, d_ts, rmv_vc)).any(-1)

        return TopkRmvDenseState(f_score, f_dc, f_ts, rmv_vc, vc, lossy), dom_tbl

    def coalesce_ops(
        self,
        ops_list,
        out_adds: Optional[int] = None,
        out_rmvs: Optional[int] = None,
    ):
        """Fuse several op batches into ONE compacted batch (whole-log
        compaction, `ops.compaction.coalesce_topk_rmv_ops`): removals fuse
        per id, dominated/duplicate adds are deleted, survivors keep the
        best M per id — the pre-ship pass standing in for the reference's
        `can_compact/2`/`compact_ops/2` log walk (antidote_ccrdt.erl:55-56,
        topk_rmv.erl:178-223). Generic harnesses use it through
        `DenseReplay.apply_coalesced` and `pipeline.stream_apply(coalesce=k)`.

        Default output windows are the concatenated input sizes (never
        overflows); smaller windows raise when a replica's live ops do not
        fit. Runs on the batches' device. Returns (ops, n_add[R], n_rmv[R])."""
        from ..ops.compaction import coalesce_topk_rmv_ops

        ops_list = list(ops_list)
        if out_adds is None:
            out_adds = sum(o.add_key.shape[1] for o in ops_list)
        if out_rmvs is None:
            out_rmvs = sum(o.rmv_key.shape[1] for o in ops_list)
        return coalesce_topk_rmv_ops(
            ops_list, n_dcs=self.D, m_keep=self.M, out_adds=out_adds, out_rmvs=out_rmvs
        )

    # -- merge (the batched replica-state join) ----------------------------

    def merge(self, a: TopkRmvDenseState, b: TopkRmvDenseState) -> TopkRmvDenseState:
        rmv_vc = torch.maximum(a.rmv_vc, b.rmv_vc)
        vc = torch.maximum(a.vc, b.vc)
        f_score, f_dc, f_ts, n_live = sort_slots(
            (
                (a.slot_score.contiguous(), a.slot_dc.contiguous(), a.slot_ts.contiguous()),
                (b.slot_score.contiguous(), b.slot_dc.contiguous(), b.slot_ts.contiguous()),
            ),
            self.M,
            rmv_vc=rmv_vc,
        )
        lossy = a.lossy | b.lossy | (n_live > self.M).any(-1)
        return TopkRmvDenseState(f_score, f_dc, f_ts, rmv_vc, vc, lossy)

    # -- reads -------------------------------------------------------------

    def observe(self, state: TopkRmvDenseState) -> Observed:
        """Observable top-K per (replica, instance): the best live add of
        each id (slot 0) ranked by (score desc, id desc); ts/dc ride along
        by positional gather. Id -1 never occurs here; valid is
        ``(ts > 0) & (id >= 0)`` as in JAX."""
        best_score = state.slot_score[..., 0]
        id_f, score_f, _ = masked_topk(best_score, min(self.K, self.I))
        gi = id_f.clamp_min(0).to(torch.int64)
        ts_f = torch.gather(state.slot_ts[..., 0], -1, gi)
        dc_f = torch.gather(state.slot_dc[..., 0], -1, gi)
        valid = (ts_f > 0) & (id_f >= 0)
        return Observed(ids=id_f, scores=score_f, dcs=dc_f, tss=ts_f, valid=valid)

    def value(self, state: TopkRmvDenseState):
        """[(id, score)] per (replica, instance), as the reference's
        value/1 (:91-95) — materialized to host."""

        def triple(s):
            o = self.observe(s)
            return o.ids, o.scores, o.valid

        return observe_value(triple, state)

    def equal(self, a: TopkRmvDenseState, b: TopkRmvDenseState) -> bool:
        """Observable-state comparison (topk_rmv.erl:151-153)."""
        oa, ob = self.observe(a), self.observe(b)
        same = (
            (oa.valid == ob.valid)
            & torch.where(oa.valid, oa.ids == ob.ids, True)
            & torch.where(oa.valid, oa.scores == ob.scores, True)
        )
        return bool(same.all())

    # -- extras ------------------------------------------------------------

    def _promotions(self, old: Observed, new: Observed, ops: TopkRmvOps) -> Observed:
        """Elements in new observed that neither were observed before nor
        arrived as adds in this batch (reference :291-295)."""
        keep = promotion_mask(
            (new.ids, new.dcs, new.tss),
            new.valid,
            (old.ids, old.dcs, old.tss),
            old.valid,
            ops.add_key,
            (ops.add_id, ops.add_dc, ops.add_ts),
            ops.add_ts > 0,
        )
        return Observed(new.ids, new.scores, new.dcs, new.tss, keep)


def make_dense(
    n_ids: int,
    n_dcs: int,
    size: int = 100,
    slots_per_id: int = 4,
    device: DeviceLike = None,
) -> TopkRmvDense:
    """Dense topk_rmv engines carry static shape config, so they are
    constructed per deployment rather than registered as a singleton."""
    return TopkRmvDense(n_ids=n_ids, n_dcs=n_dcs, size=size, slots_per_id=slots_per_id, device=device)


registry.register("topk_rmv", dense_factory=make_dense)
