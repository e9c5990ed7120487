"""The partition plane: fixed hash partitions over each instance's id space
(port of ``antidote_ccrdt_tpu/core/partition.py``).

Big(ger) Sets (arxiv 1605.06424, PAPERS.md) decomposes one large CRDT
into independently replicated partitions so anti-entropy, digests, and
rejoin streaming operate on slices instead of the whole instance. This
module is the single source of truth for that decomposition:

* ``part_of(ids, P)`` — the stable id→partition map (Knuth multiplicative
  hash; NEVER python ``hash()``, which is salted per process).
* a per-engine *item plan* describing which leaf axes are item-indexed:
  - ``TopkRmvDenseState``: the I axis (axis 2) of the slot/tombstone
    leaves; ``vc``/``lossy`` are whole-instance.
  - table engines (topk / leaderboard / wordcount): the last axis of
    every 3-D ``[R, NK, P]`` plane; other leaves are whole-instance.
  - ``LiftedMonoidState``: the replica-row axis (axis 0) of every inner
    leaf plus ``ver`` — a row is the row-replace unit, so a partition of
    rows is the finest slice the lifted join can exchange.
* ``state_digests`` — a ``P+1``-entry crc32 vector. Index ``P`` is the
  **meta partition**: the whole-instance leaves (vc, lossy, loss
  counters...). Isolating them keeps one divergent id from dirtying every
  digest while still making whole-leaf drift detectable and cheap to
  repair (meta payloads are O(R·NK), not O(I)).
* ``restrict_psnap`` / ``apply_psnap`` — partial snapshots. A psnap is
  delta-SHAPED (`TopkRmvDelta`, the table-delta dict, or a monoid row
  delta) restricted to one partition, so the existing expand+join /
  row-replace machinery applies it and ``like_delta_for`` decodes it; no
  new kernels. Join semantics make application idempotent and
  order-free: merging a peer's psnap for partition p yields a local
  state ⊇ the peer's state on p.
* ``delta_parts`` — the partition set a decoded delta touches (computed
  receiver-side; deltas need no wire change to "carry" their partitions).
* the ``CCPT`` blob container for digest vectors, psnaps, and checkpoint
  shards — first-bytes magic disambiguation mirroring ``topo/codec.py``'s
  bare-ETF fallback, so legacy whole-instance blobs keep decoding.

Digest contract: two states with equal leaves have equal digest vectors,
and a state change confined to ids of partition p (resp. whole leaves)
perturbs only entry p (resp. entry P). The whole-instance digest
disagrees iff some vector entry disagrees.

Mixed fleets: leaf paths are the strings ``jax.tree_util.keystr`` gives
(``utils/tree.py``), leaves are hashed as their numpy bytes, and psnaps
carry the same rows and values as the JAX package's, so digest vectors,
psnap payloads and CCPT blobs are byte-equal across the two packages.
Digests read each leaf to the host once; psnaps and split deltas are cut
on the state's device.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..utils.tree import as_numpy, flatten_with_path, leaves

# Fibonacci/Knuth multiplicative constant: stable across processes,
# well-mixed low bits after the multiply for power-of-two P too.
_KNUTH = np.uint64(2654435761)
_MASK32 = np.uint64(0xFFFFFFFF)

DEFAULT_PARTITIONS = 8


def n_partitions(default: int = DEFAULT_PARTITIONS) -> int:
    """The fleet-wide partition count, env-tunable (``CCRDT_PARTITIONS``).
    Every member of a fleet must agree on it (it is a wire/digest
    parameter, like R or I)."""
    try:
        p = int(os.environ.get("CCRDT_PARTITIONS", default))
    except ValueError:
        p = default
    return max(1, p)


def part_of(ids: Any, P: int) -> np.ndarray:
    """Stable id→partition map, vectorized. int array in, int32 out."""
    a = np.asarray(ids, np.int64).astype(np.uint64)
    return (((a * _KNUTH) & _MASK32) % np.uint64(P)).astype(np.int32)


def meta_part(P: int) -> int:
    """Index of the meta partition (whole-instance leaves) in a
    ``P+1``-entry digest vector."""
    return P


# --- per-engine item plans -------------------------------------------------


def _is_topk_rmv(state: Any) -> bool:
    from ..models.topk_rmv_dense import TopkRmvDenseState

    return isinstance(state, TopkRmvDenseState)


def _is_lifted(state: Any) -> bool:
    from ..parallel.monoid import LiftedMonoidState

    return isinstance(state, LiftedMonoidState)


def _item_plan(state: Any) -> Tuple[List[Tuple[str, Any, int]], List[Tuple[str, Any]], int]:
    """((path, leaf, item_axis)[], (path, whole_leaf)[], item_count).

    The item axis is the axis whose index IS the partitionable id; all
    item leaves of one state share its extent (checked)."""
    if _is_topk_rmv(state):
        I = int(state.slot_score.shape[2])
        items = [
            ("slot_score", state.slot_score, 2),
            ("slot_dc", state.slot_dc, 2),
            ("slot_ts", state.slot_ts, 2),
            ("rmv_vc", state.rmv_vc, 2),
        ]
        whole = [("vc", state.vc), ("lossy", state.lossy)]
        return items, whole, I
    if _is_lifted(state):
        R = int(state.ver.shape[0])
        items = [(path, leaf, 0) for path, leaf in flatten_with_path(state.inner)]
        items.append((".ver", state.ver, 0))
        return items, [], R
    items, whole, extent = [], [], None
    for path, leaf in flatten_with_path(state):
        if leaf.dim() == 3:
            items.append((path, leaf, 2))
            n = int(leaf.shape[2])
            if extent is None:
                extent = n
            elif extent != n:
                raise ValueError(
                    f"table planes disagree on item extent: {extent} vs {n}"
                )
        else:
            whole.append((path, leaf))
    return items, whole, (extent or 0)


# --- per-partition digest vectors ------------------------------------------


def digest_entries(
    state: Any, P: int, parts: Sequence[int]
) -> Dict[int, int]:
    """crc32 digest entries for a SUBSET of partitions — ``{part: crc}``,
    ``part == P`` being the meta partition. This is the byte walk
    `state_digests` runs for every entry, exposed per-partition so a
    shard can produce exactly the slice of the vector it owns; slices
    stitched back together are bitwise equal to the full vector because
    they ARE the full vector's entries. Each leaf is read to the host
    once, however many entries are asked for: only the asked
    partitions' id-slices of an item leaf (gathered on its device) and
    the whole leaves only when the meta entry is asked."""
    items, whole, extent = _item_plan(state)
    parts = [int(p) for p in parts]
    id_parts = part_of(np.arange(extent), P) if extent else np.zeros(0, np.int32)
    sel = np.nonzero(np.isin(id_parts, [p for p in parts if p != P]))[0]
    if sel.size < id_parts.size:
        id_parts = id_parts[sel]
        host_items = [
            (path, as_numpy(leaf.index_select(axis, torch.from_numpy(sel).to(leaf.device))), axis)
            for path, leaf, axis in items
        ]
    else:
        host_items = [(path, as_numpy(leaf), axis) for path, leaf, axis in items]
    host_whole = (
        [(path, np.ascontiguousarray(as_numpy(leaf))) for path, leaf in whole]
        if P in parts else []
    )
    out: Dict[int, int] = {}
    for part in parts:
        crc = 0
        if part == P:
            for path, arr in host_whole:
                crc = zlib.crc32(arr.tobytes(), zlib.crc32(path.encode(), crc))
        else:
            idx = np.nonzero(id_parts == part)[0]
            for path, leaf, axis in host_items:
                sl = np.ascontiguousarray(np.take(leaf, idx, axis=axis))
                crc = zlib.crc32(sl.tobytes(), zlib.crc32(path.encode(), crc))
        out[part] = crc & 0xFFFFFFFF
    return out


def state_digests(state: Any, P: int) -> np.ndarray:
    """``uint32[P+1]`` crc32 digest vector; entry P is the meta partition
    (whole-instance leaves). Pure function of the state's leaves."""
    entries = digest_entries(state, P, range(P + 1))
    vec = np.zeros(P + 1, np.uint32)
    for part, crc in entries.items():
        vec[part] = crc
    return vec


def divergent_parts(a: Any, b: Any) -> List[int]:
    """Indices where two digest vectors disagree (length mismatch = all)."""
    av, bv = np.asarray(a), np.asarray(b)
    if av.shape != bv.shape:
        return list(range(max(av.size, bv.size)))
    return [int(i) for i in np.nonzero(av != bv)[0]]


class DigestSampler:
    """Bounded-cadence memo of `state_digests` for the audit plane.

    `state_digests` is a host-side crc sweep over every leaf — cheap at
    anchor cadence, not at per-round watchdog cadence. The sampler
    memoizes the vector keyed on the caller's own progress seq (the
    publisher seq: the state cannot have changed without it advancing)
    and, when no seq is available, rate-limits recomputation to
    `min_interval_s` on the monotonic clock. The staleness this trades
    is exactly one publish interval — the same freshness the digest a
    PEER fetched has, so watchdog comparisons stay apples-to-apples."""

    def __init__(
        self, P: Optional[int] = None, min_interval_s: float = 0.25,
        mono: Any = None,
    ) -> None:
        import time

        self.P = P if P else n_partitions()
        self.min_interval_s = float(min_interval_s)
        self._mono = mono if mono is not None else time.monotonic
        self._seq: Optional[int] = None
        self._at: float = float("-inf")
        self._vec: Optional[np.ndarray] = None
        self.computes = 0  # recomputation count (bench: sampling cost)

    def sample(self, state: Any, seq: Optional[int] = None) -> np.ndarray:
        now = self._mono()
        if self._vec is not None:
            if seq is not None and seq == self._seq:
                return self._vec
            if seq is None and now - self._at < self.min_interval_s:
                return self._vec
        self._vec = state_digests(state, self.P)
        self._seq, self._at = seq, now
        self.computes += 1
        return self._vec

    def invalidate(self) -> None:
        """Force the next `sample` to recompute (e.g. after applying a
        repair outside the seq axis)."""
        self._seq, self._at, self._vec = None, float("-inf"), None


# --- partition-restricted partial snapshots (psnaps) -----------------------


def _on(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def restrict_psnap(dense: Any, state: Any, part: int, P: int) -> Any:
    """The slice of `state` belonging to partition `part`, as a
    delta-shaped payload (apply with ``apply_psnap`` / decode against
    ``parallel.delta.like_delta_for``). ``part == P`` is the meta
    partition: whole-instance leaves with an empty item slice. Rows are
    gathered on the state's device; row indices are int32."""
    from ..core.behaviour import MergeKind
    from ..parallel.delta import TopkRmvDelta, _split_leaves

    meta = part == P
    if _is_topk_rmv(state):
        from ..ops.dense_table import NEG_INF

        R, NK, I, M = state.slot_score.shape
        D = state.rmv_vc.shape[-1]
        dev = state.slot_score.device
        if meta:
            rows = np.zeros(0, np.int64)
        else:
            ids = np.nonzero(part_of(np.arange(I), P) == part)[0]
            # all (r, k) rows for the partition's ids
            rows = (np.arange(R * NK)[:, None] * I + ids[None, :]).reshape(-1)
        at = _on(dev, rows)
        score = state.slot_score.reshape(R * NK * I, M)[at]
        dc = state.slot_dc.reshape(R * NK * I, M)[at]
        ts = state.slot_ts.reshape(R * NK * I, M)[at]
        rvc = state.rmv_vc.reshape(R * NK * I, D)[at]
        # identity rows are dropped (they join as no-ops and only cost
        # bytes)
        live = (
            (score != NEG_INF).any(1) | (dc != 0).any(1)
            | (ts != 0).any(1) | (rvc != 0).any(1)
        )
        keep = live.nonzero().reshape(-1)
        return TopkRmvDelta(
            rows=at[keep].to(torch.int32),
            slot_score=score[keep],
            slot_dc=dc[keep],
            slot_ts=ts[keep],
            rmv_vc=rvc[keep],
            # zeros are the join identity for vc/lossy: a non-meta psnap
            # asserts nothing about the whole-instance leaves
            vc=state.vc if meta else torch.zeros_like(state.vc),
            lossy=state.lossy if meta else torch.zeros_like(state.lossy),
        )
    if _is_lifted(state):
        R = int(state.ver.shape[0])
        if meta:
            rows = np.zeros(0, np.int64)
        else:
            rows = np.nonzero(part_of(np.arange(R), P) == part)[0]
        at = _on(state.ver.device, rows)
        return {
            "rows": at.to(torch.int32),
            "ver": state.ver[at],
            "leaves": {p: leaf[at] for p, leaf in flatten_with_path(state.inner)},
        }
    if getattr(dense, "merge_kind", None) == MergeKind.MONOID:
        raise ValueError(
            "psnaps for bare MONOID engines are unsound (re-merge "
            "double-counts); gossip monoid engines through MonoidLift"
        )
    paths, vals, table_paths = _split_leaves(state)
    by_path = dict(zip(paths, vals))
    extent = None
    for p in table_paths:
        extent = int(by_path[p].shape[2])
        break
    out: Dict[str, Any] = {"idx": None, "table": {}, "whole": {}}
    if meta or extent is None:
        idx = np.zeros(0, np.int64)
    else:
        ids = np.nonzero(part_of(np.arange(extent), P) == part)[0]
        lead = 1
        for p in table_paths:
            lead = int(np.prod(by_path[p].shape[:2]))
            break
        idx = (np.arange(lead)[:, None] * extent + ids[None, :]).reshape(-1)
    at = _on(vals[0].device, idx)
    out["idx"] = at.to(torch.int32)
    for p in paths:
        leaf = by_path[p]
        if p in table_paths:
            out["table"][p] = leaf.reshape(-1)[at]
        else:
            # identity (init) whole leaves unless this IS the meta psnap
            out["whole"][p] = leaf if meta else None
    if not meta:
        R, NK = vals[0].shape[:2]
        ipaths, ileaves, _ = _split_leaves(dense.init(R, NK))
        ident_by = dict(zip(ipaths, ileaves))
        for p in list(out["whole"]):
            out["whole"][p] = ident_by[p]
    return out


def apply_psnap(dense: Any, state: Any, payload: Any) -> Any:
    """Join a psnap payload into `state` (idempotent; order-free)."""
    from ..parallel.delta import apply_any_delta

    return apply_any_delta(dense, state, payload)


def delta_parts(dense: Any, like_state: Any, delta: Any, P: int) -> Set[int]:
    """The partitions a decoded delta touches — computed receiver-side,
    so deltas "carry" their partition set with no wire change. JOIN
    deltas always touch the meta partition (they ship vc/whole leaves)."""
    from ..parallel.delta import TopkRmvDelta, _is_monoid_row_delta

    if isinstance(delta, TopkRmvDelta):
        I = dense.I
        ids = as_numpy(delta.rows) % I
        return set(int(x) for x in np.unique(part_of(ids, P))) | {P}
    if _is_monoid_row_delta(delta):
        rows = as_numpy(delta["rows"])
        return set(int(x) for x in np.unique(part_of(rows, P)))
    items, _, extent = _item_plan(like_state)
    idx = as_numpy(delta.get("idx", np.zeros(0, np.int64)))
    if extent:
        ids = idx % extent
        parts = set(int(x) for x in np.unique(part_of(ids, P)))
    else:
        parts = set()
    return parts | {P}


def split_delta(
    dense: Any, like_state: Any, delta: Any, P: int, parts: Sequence[int]
) -> Tuple[Any, Optional[Any]]:
    """Split a decoded delta (or delta-shaped psnap) into ``(hot, cold)``
    halves around a partition set: rows/entries whose id hashes into
    `parts` go to the cold half, everything else stays hot. The meta
    payload (vc / whole leaves) rides the HOT half — the meta partition
    is pinned resident by the pager — and the cold half asserts nothing
    about it (join-identity leaves, same move as a non-meta psnap).
    Either return slot may be the original delta / None when one side is
    empty. Joining both halves into the same state equals joining the
    original delta: the split is along the item axis, where every leaf
    row joins independently. The halves are cut on the delta's device.

    Lifted monoid row deltas are rejected: a lifted state partitions by
    replica row, which the pager does not page."""
    from ..parallel.delta import TopkRmvDelta, _is_monoid_row_delta, _split_leaves

    cold_set = np.asarray(sorted(int(p) for p in parts), np.int64)
    if cold_set.size == 0:
        return delta, None
    if isinstance(delta, TopkRmvDelta):
        rows = as_numpy(delta.rows)
        in_cold = np.isin(part_of(rows % dense.I, P), cold_set)
        if not in_cold.any():
            return delta, None
        dev = delta.slot_score.device

        def _take(mask: np.ndarray) -> Dict[str, Any]:
            sel = np.nonzero(mask)[0]
            at = _on(dev, sel)
            return {
                "rows": _on(dev, rows[sel].astype(np.int32)),
                "slot_score": delta.slot_score[at],
                "slot_dc": delta.slot_dc[at],
                "slot_ts": delta.slot_ts[at],
                "rmv_vc": delta.rmv_vc[at],
            }

        hot = TopkRmvDelta(**_take(~in_cold), vc=delta.vc, lossy=delta.lossy)
        cold = TopkRmvDelta(
            **_take(in_cold),
            vc=torch.zeros_like(delta.vc),
            lossy=torch.zeros_like(delta.lossy),
        )
        return hot, cold
    if _is_monoid_row_delta(delta):
        raise ValueError("cannot split a lifted monoid row delta by partition")
    _items, _whole, extent = _item_plan(like_state)
    idx_t = delta.get("idx", None)
    idx = as_numpy(idx_t) if idx_t is not None else np.zeros(0, np.int64)
    if extent == 0 or idx.size == 0:
        return delta, None
    in_cold = np.isin(part_of(idx % extent, P), cold_set)
    if not in_cold.any():
        return delta, None
    dev = idx_t.device
    hot_sel = _on(dev, np.nonzero(~in_cold)[0])
    cold_sel = _on(dev, np.nonzero(in_cold)[0])
    hot = {
        "idx": idx_t[hot_sel].to(torch.int32),
        "table": {p: v[hot_sel] for p, v in delta["table"].items()},
        "whole": dict(delta["whole"]),
    }
    R, NK = leaves(like_state)[0].shape[:2]
    ipaths, ileaves, _t = _split_leaves(dense.init(R, NK))
    ident_by = dict(zip(ipaths, ileaves))
    cold = {
        "idx": idx_t[cold_sel].to(torch.int32),
        "table": {p: v[cold_sel] for p, v in delta["table"].items()},
        "whole": {p: ident_by[p] for p in delta["whole"]},
    }
    return hot, cold


# --- CCPT blob container ---------------------------------------------------
# First-bytes disambiguation, same move as topo/codec.py's bare-ETF
# fallback: new blobs open with b"CCPT"; legacy whole-instance snapshot
# blobs open with an 8-byte step header followed by serial.MAGIC
# (b"CCRD" at offset 8). `is_partition_blob` keys the dispatch.

PART_MAGIC = b"CCPT"
# Version 1: raw payload. Version 2: zlib-deflated payload (psnaps only
# — the 18-byte header stays uncompressed so `seq` keeps parsing at a
# fixed offset on every transport). The encoder picks whichever is
# smaller per blob; decoders accept both, so v1 artifacts (old
# checkpoint shards, mixed-version peers) stay readable.
PART_VERSION = 2
KIND_DIGESTS = 0
KIND_PSNAP = 1


def is_partition_blob(blob: bytes) -> bool:
    return bytes(blob[:4]) == PART_MAGIC


def encode_digest_blob(seq: int, vec: Any) -> bytes:
    # Digest vectors are 4(P+1) bytes — deflate cannot help, write v1.
    v = np.asarray(vec, np.uint32)
    return (
        PART_MAGIC
        + bytes([1, KIND_DIGESTS])
        + struct.pack("<QI", int(seq), int(v.size))
        + v.astype("<u4").tobytes()
    )


def decode_digest_blob(blob: bytes) -> Tuple[int, np.ndarray]:
    _check_header(blob, KIND_DIGESTS)
    seq, n = struct.unpack_from("<QI", blob, 6)
    vec = np.frombuffer(blob, dtype="<u4", count=n, offset=18).astype(np.uint32)
    return int(seq), vec


def encode_psnap_blob(seq: int, part: int, dense_payload: bytes) -> bytes:
    """`dense_payload` is a ``serial.dumps_dense`` blob of the restricted
    delta-shaped psnap. The flat-serial envelope (leaf paths, dtypes)
    dominates small psnaps — a meta psnap is ~70 bytes of arrays in a
    ~2 KB blob — so the payload ships deflated (v2) whenever that is
    actually smaller, raw (v1) otherwise."""
    header = struct.pack("<QI", int(seq), int(part))
    packed = zlib.compress(dense_payload, 6)
    if len(packed) < len(dense_payload):
        return PART_MAGIC + bytes([2, KIND_PSNAP]) + header + packed
    return PART_MAGIC + bytes([1, KIND_PSNAP]) + header + dense_payload


def decode_psnap_blob(blob: bytes) -> Tuple[int, int, bytes]:
    """(seq, part, dense_payload). Accepts v1 (raw) and v2 (deflated)."""
    _check_header(blob, KIND_PSNAP)
    seq, part = struct.unpack_from("<QI", blob, 6)
    payload = bytes(blob[18:])
    if blob[4] >= 2:
        payload = zlib.decompress(payload)
    return int(seq), int(part), payload


def _check_header(blob: bytes, kind: int) -> None:
    if not is_partition_blob(blob):
        raise ValueError("not a CCPT partition blob (bad magic)")
    version, k = blob[4], blob[5]
    if version > PART_VERSION:
        raise ValueError(
            f"partition blob version {version} newer than supported "
            f"{PART_VERSION}"
        )
    if k != kind:
        raise ValueError(f"partition blob kind {k} != expected {kind}")
