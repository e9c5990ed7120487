"""Python binding for the native (C++) host runtime (port of
``antidote_ccrdt_tpu/harness/native_host.py``).

``native/ccrdt_host.cpp`` implements the op-log store, causal delivery
scheduler, and dense batch builder — the host services Antidote provides to
the reference library (SURVEY.md §1) — as a shared library. The port
builds the same source with g++ into its own ``build/`` at first use
(``ops/_build.load_host_library``), binds it via ctypes, and adapts
drained batches to the dense op structs the engine consumes, on the
device the caller names.

The boundary is batched in both directions: ``submit_batch`` hands N ops to
C++ in one call; ``drain`` returns a struct-of-arrays batch ready to wrap as
``TopkRmvOps``. Python never loops over individual ops on the hot path.

If the toolchain is unavailable the import still succeeds; ``available()``
reports False, ``build_error()`` says why, and the pure-Python
``ScalarReplay`` pipeline remains the host for library callers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

# Op kinds shared with ops/compaction.py (KIND_* there) and, by convention,
# reinterpreted per type: for average, score=value aux=n; for wordcount,
# id=token score=count.
KIND_ADD = 0
KIND_ADD_R = 1
KIND_RMV = 2
KIND_RMV_R = 3

_lib = None
_build_error: Optional[str] = None


def _ensure_lib():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    from ..ops import _build

    try:
        lib = _build.load_host_library("ccrdt_host")
    except (RuntimeError, OSError) as e:
        _build_error = str(e)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ccrdt_host_new.restype = ctypes.c_void_p
    lib.ccrdt_host_new.argtypes = [ctypes.c_int]
    lib.ccrdt_host_free.argtypes = [ctypes.c_void_p]
    lib.ccrdt_host_submit.restype = ctypes.c_int32
    lib.ccrdt_host_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
    ]
    lib.ccrdt_host_submit_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.ccrdt_host_drain.restype = ctypes.c_int
    lib.ccrdt_host_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.ccrdt_host_backlog.restype = ctypes.c_int64
    lib.ccrdt_host_backlog.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ccrdt_host_stats.argtypes = [ctypes.c_void_p, i64p]
    _lib = lib
    return _lib


def available() -> bool:
    """True iff the native library built (or was already built)."""
    return _ensure_lib() is not None


def build_error() -> Optional[str]:
    _ensure_lib()
    return _build_error


def _i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeHost:
    """One multi-master host: D replicas, each a DC.

    Ops are effect ops (already through ``downstream``); the host stamps
    adds with the origin's lamport time, tracks causal dependencies, and
    delivers per replica in causal order, exactly once.
    """

    def __init__(self, n_dcs: int):
        lib = _ensure_lib()
        if lib is None:
            raise RuntimeError(f"native host unavailable: {_build_error}")
        self._lib = lib
        self.D = n_dcs
        self._h = lib.ccrdt_host_new(n_dcs)
        if not self._h:
            raise RuntimeError("ccrdt_host_new failed")
        # Delivered-but-not-yet-batched ops per replica (SoA dicts): the
        # drain is exactly-once, so overflow from a batch split must be
        # carried, never dropped or re-requested (see drain_topk_rmv_ops).
        self._carry: dict = {}

    def close(self) -> None:
        if self._h:
            self._lib.ccrdt_host_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- submit ------------------------------------------------------------

    def submit(self, origin: int, kind: int, key: int, id_: int,
               score: int = 0, aux: int = 0,
               vc: Optional[np.ndarray] = None) -> int:
        """Submit one effect op at `origin`; returns the lamport stamp."""
        vcp = None
        if vc is not None:
            vc = np.ascontiguousarray(vc, dtype=np.int32)
            assert vc.shape == (self.D,)
            vcp = _i32(vc)
        return self._lib.ccrdt_host_submit(
            self._h, origin, kind, key, id_, score, aux, vcp
        )

    def submit_batch(self, origin: int, kinds, keys, ids, scores=None,
                     auxs=None, vcs=None) -> np.ndarray:
        """Submit N ops in one native call; returns their lamport stamps."""
        kinds = np.ascontiguousarray(kinds, dtype=np.int32)
        n = kinds.shape[0]

        def arr(x):
            if x is None:
                return np.zeros(n, np.int32)
            return np.ascontiguousarray(x, dtype=np.int32)

        keys, ids, scores, auxs = arr(keys), arr(ids), arr(scores), arr(auxs)
        vcp = None
        if vcs is not None:
            vcs = np.ascontiguousarray(vcs, dtype=np.int32)
            assert vcs.shape == (n, self.D)
            vcp = _i32(vcs)
        out_ts = np.zeros(n, np.int32)
        self._lib.ccrdt_host_submit_batch(
            self._h, origin, n, _i32(kinds), _i32(keys), _i32(ids),
            _i32(scores), _i32(auxs), vcp, _i32(out_ts),
        )
        return out_ts

    # -- drain -------------------------------------------------------------

    def drain(self, replica: int, max_n: int):
        """Deliver up to max_n causally-ready ops for `replica`.

        Returns a dict of SoA numpy arrays sliced to the delivered count:
        kind, key, id, score, aux, dc, ts ([n]) and vc ([n, D]).
        """
        bufs = {name: np.zeros(max_n, np.int32)
                for name in ("kind", "key", "id", "score", "aux", "dc", "ts")}
        vc = np.zeros((max_n, self.D), np.int32)
        n = self._lib.ccrdt_host_drain(
            self._h, replica, max_n,
            _i32(bufs["kind"]), _i32(bufs["key"]), _i32(bufs["id"]),
            _i32(bufs["score"]), _i32(bufs["aux"]), _i32(bufs["dc"]),
            _i32(bufs["ts"]), _i32(vc),
        )
        out = {k: v[:n] for k, v in bufs.items()}
        out["vc"] = vc[:n]
        return out

    def drain_topk_rmv_ops(self, replica: int, batch_adds: int,
                           batch_rmvs: int,
                           device: DeviceLike = None) -> Tuple[object, int, int]:
        """Drain into a padded single-replica ``TopkRmvOps`` batch (leading
        replica axis of 1, stackable across replicas) on `device` (the
        card unless the caller names another). Returns (ops, n_adds,
        n_rmvs).

        Delivers at most batch_adds adds and batch_rmvs rmvs per call
        (backpressure; the rest arrives next call). The drain itself is
        exactly-once, so when the drained window's add/rmv split overflows
        one side, the excess is CARRIED to the next call — never dropped.
        Both the adds/rmvs split and the carry delay are safe because the
        dense kernel applies batches as a lattice join: tombstone
        domination (``ts > vc[dc]``) is order-independent, so delivering a
        removal before a causally-prior add converges identically.
        """
        from ..models.topk_rmv_dense import TopkRmvOps

        dev = resolve_device(device)
        carry = self._carry.pop(replica, None)
        room = batch_adds + batch_rmvs - (len(carry["kind"]) if carry else 0)
        got = self.drain(replica, max(room, 0))
        if carry is not None:
            got = {
                k: np.concatenate([carry[k], got[k]], axis=0) for k in got
            }
        is_add = got["kind"] <= KIND_ADD_R
        a_idx = np.flatnonzero(is_add)
        r_idx = np.flatnonzero(~is_add)
        # A kind with zero capacity can never leave the carry — the
        # caller's drain loop would livelock on a stuck backlog. Park the
        # WHOLE window back in the carry (exactly-once: nothing may be
        # lost) and fail loudly so the caller retries with usable sizes.
        if (batch_adds == 0 and a_idx.size) or (batch_rmvs == 0 and r_idx.size):
            self._carry[replica] = {k: v.copy() for k, v in got.items()}
            raise ValueError(
                "zero-capacity batch side for ops present in the stream "
                f"(batch_adds={batch_adds}, batch_rmvs={batch_rmvs}); "
                "carried ops retained — retry with nonzero capacities"
            )
        over = np.concatenate([a_idx[batch_adds:], r_idx[batch_rmvs:]])
        if len(over):
            over.sort()  # keep the carried ops in delivery order
            self._carry[replica] = {k: got[k][over].copy() for k in got}
            keep = np.ones(len(is_add), bool)
            keep[over] = False
            got = {k: got[k][keep] for k in got}
            is_add = got["kind"] <= KIND_ADD_R
        adds = {k: got[k][is_add] for k in ("key", "id", "score", "dc", "ts")}
        rmvs = {k: got[k][~is_add] for k in ("key", "id")}
        rmv_vc = got["vc"][~is_add]
        na, nr = int(is_add.sum()), int((~is_add).sum())

        def pad(a, n, fill):
            out = np.full(n, fill, np.int32)
            out[: len(a)] = a
            return out[None]  # [1, n]

        def put(a):
            return torch.from_numpy(a).to(dev)

        ops = TopkRmvOps(
            add_key=put(pad(adds["key"], batch_adds, 0)),
            add_id=put(pad(adds["id"], batch_adds, 0)),
            add_score=put(pad(adds["score"], batch_adds, 0)),
            add_dc=put(pad(adds["dc"], batch_adds, 0)),
            add_ts=put(pad(adds["ts"], batch_adds, 0)),  # 0 pad = invalid
            rmv_key=put(pad(rmvs["key"], batch_rmvs, 0)),
            rmv_id=put(pad(rmvs["id"], batch_rmvs, -1)),  # -1 pad
            rmv_vc=put(
                np.concatenate(
                    [rmv_vc, np.zeros((batch_rmvs - nr, self.D), np.int32)], axis=0
                )[None]
            ),
        )
        return ops, na, nr

    # -- introspection -----------------------------------------------------

    def backlog(self, replica: int) -> int:
        """Undelivered-to-batch ops: native causal backlog plus any ops
        carried over from a previous drain's batch-split overflow."""
        carry = self._carry.get(replica)
        return int(self._lib.ccrdt_host_backlog(self._h, replica)) + (
            len(carry["kind"]) if carry else 0
        )

    def stats(self):
        out = np.zeros(3, np.int64)
        self._lib.ccrdt_host_stats(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        return {"submitted": int(out[0]), "delivered": int(out[1]),
                "pending": int(out[2])}
