"""Blocking bridge client (the shape an erlport/gen_tcp client takes); the
port of ``antidote_ccrdt_tpu/bridge/client.py``, pure host code.

Failure semantics: a server-REPORTED error (the stream stays in sync)
raises `BridgeError` and the client remains usable. A TRANSPORT-class
failure — timeout, reset, corrupt frame, desynced request id — leaves
the reply stream unusable; with `retries=0` (the default) the client is
poisoned, exactly the pre-reconnect behavior. With `retries>0` the
client reconnects with capped exponential backoff and RESENDS the same
request under the idempotent `icall` form: a client-chosen random token
plus the request id lets the server dedup, so a request whose reply was
lost in the reset is not executed twice (grid_apply is not idempotent).

The `timeout` applies end to end: to the initial connect, to every recv
while waiting for a reply, and to every reconnect.
"""

from __future__ import annotations

import os
import socket
import time
from typing import Any, List, Optional, Tuple

from ..core.etf import Atom
from ..obs import events as obs_events
from ..utils import faults
from ..utils.metrics import Metrics
from . import protocol as P


class BridgeError(RuntimeError):
    pass


class _ServerError(Exception):
    """Internal: an error the *server* reported over an in-sync stream —
    re-raised as BridgeError without poisoning the connection."""


class BridgeClient:
    def __init__(
        self,
        host: str,
        port: int,
        timeout: float = 30.0,
        retries: int = 0,
        backoff_base: float = 0.05,
        backoff_max: float = 1.0,
        metrics: Optional[Metrics] = None,
    ):
        self._host, self._port = host, port
        self._timeout = timeout
        self._retries = int(retries)
        self._backoff_base = backoff_base
        self._backoff_max = backoff_max
        self.metrics = metrics if metrics is not None else Metrics()
        # Client-incarnation token for idempotent resends (icall dedup key
        # on the server). Fresh per client object: a NEW client must not
        # collide with a previous incarnation's cached replies.
        self._token = os.urandom(8)
        self._sock: Optional[socket.socket] = None
        self._buf = bytearray()
        self._req = 0
        self._closed = False
        self._connect()

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self._host, self._port), timeout=self._timeout
        )
        self._buf = bytearray()

    def _drop_sock(self) -> None:
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._buf = bytearray()

    def close(self) -> None:
        self._closed = True
        self._drop_sock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def call(self, op: Any) -> Any:
        if self._closed:
            raise BridgeError("client is closed")
        self._req += 1
        req_id = self._req
        attempt = 0
        while True:
            try:
                if self._sock is None:
                    self._connect()
                return self._roundtrip(req_id, op)
            except _ServerError as e:
                raise BridgeError(str(e)) from None
            except Exception:
                # Transport-class failure: the reply stream is unusable.
                self._drop_sock()
                if attempt >= self._retries:
                    self._closed = True
                    raise
                attempt += 1
                self.metrics.count("bridge.reconnects")
                obs_events.emit(
                    "bridge.reconnect", req_id=req_id, attempt=attempt
                )
                time.sleep(
                    min(self._backoff_max,
                        self._backoff_base * (2.0 ** (attempt - 1)))
                )

    def _roundtrip(self, req_id: int, op: Any) -> Any:
        # icall (not call): resends after a reconnect must dedup on the
        # server — see module docstring.
        self._sock.sendall(P.pack_frame(P.icall(self._token, req_id, op)))
        while True:
            for term in P.unpack_frames(self._buf):
                rid, ok, payload = P.parse_reply(term)
                if rid != req_id:
                    raise BridgeError(f"reply for {rid}, expected {req_id}")
                if not ok:
                    raise _ServerError(P.error_text(payload))
                return payload
            if faults.ACTIVE:
                faults.fire("bridge.read")
            chunk = self._sock.recv(1 << 16)
            if not chunk:
                raise BridgeError("connection closed")
            self._buf += chunk

    # -- scalar surface ----------------------------------------------------

    def new(self, type_name: str, *args: Any) -> Any:
        return self.call((Atom("new"), Atom(type_name), list(args)))

    def from_binary(self, type_name: str, blob: bytes) -> Any:
        return self.call((Atom("from_binary"), Atom(type_name), blob))

    def downstream(self, handle: Any, op: Tuple[str, Any], dc: Any, ts: int) -> Any:
        return self.call((Atom("downstream"), handle, P.op_to_term(op), dc, ts))

    def update(self, handle: Any, effect_term: Any) -> List[Any]:
        return self.call((Atom("update"), handle, effect_term))

    def value(self, handle: Any) -> Any:
        return self.call((Atom("value"), handle))

    def to_binary(self, handle: Any) -> bytes:
        return self.call((Atom("to_binary"), handle))

    def equal(self, h1: Any, h2: Any) -> bool:
        return self.call((Atom("equal"), h1, h2))

    def metrics_text(self) -> str:
        """Scrape the server's live registry in-band: OpenMetrics text
        over the data-plane connection (the {metrics} op)."""
        out = self.call((Atom("metrics"),))
        return bytes(out).decode("utf-8")

    def query(self, payload: bytes) -> bytes:
        """Serve-plane read over the data-plane connection: {query,
        Payload} -> canonical response bytes, byte-identical to the tcp
        query frame and POST /query for the same request."""
        return bytes(self.call((Atom("query"), bytes(payload))))

    def compact(self, handle: Any, effect_terms: List[Any]) -> List[Any]:
        return self.call((Atom("compact"), handle, effect_terms))

    def grid_compact(
        self, type_name: str, effect_terms: List[Any], m_keep: int = 0
    ) -> List[Any]:
        """Whole-log vectorized compaction of an effect-op log (no handle:
        stateless). m_keep=0 keeps every non-dominated add (reference
        compaction semantics); >0 bounds survivors per id."""
        params = [(Atom("m_keep"), m_keep)] if m_keep else []
        return self.call(
            (Atom("grid_compact"), Atom(type_name), params, effect_terms)
        )

    def free(self, handle: Any) -> None:
        self.call((Atom("free"), handle))

    # -- registry / per-type predicates ------------------------------------

    def is_type(self, type_name: str) -> bool:
        return self.call((Atom("is_type"), Atom(type_name)))

    def generates_extra_operations(self, type_name: str) -> bool:
        return self.call((Atom("generates_extra_operations"), Atom(type_name)))

    def is_operation(self, type_name: str, op: Tuple[str, Any]) -> bool:
        return self.call((Atom("is_operation"), Atom(type_name), P.op_to_term(op)))

    def require_state_downstream(self, type_name: str, op: Tuple[str, Any]) -> bool:
        return self.call(
            (Atom("require_state_downstream"), Atom(type_name), P.op_to_term(op))
        )

    def is_replicate_tagged(self, type_name: str, effect_term: Any) -> bool:
        return self.call(
            (Atom("is_replicate_tagged"), Atom(type_name), effect_term)
        )

    def batch_merge(self, type_name: str, items: List[Any]) -> Any:
        """Join N states (handles and/or `to_binary` blobs) in one batched
        device pass on the worker; returns a new handle to the merged
        state — the north-star `batch_merge` entry point. For the MONOID
        types (average, wordcounts) the inputs' op histories must be
        disjoint (+ is not idempotent — see core.batch_merge); the JOIN
        types tolerate arbitrary overlap."""
        return self.call((Atom("batch_merge"), Atom(type_name), list(items)))

    # -- dense grid surface ------------------------------------------------

    def grid_new(self, name: str, type_name: str = "topk_rmv", **params: int) -> None:
        """Create a dense grid of any registered type (topk_rmv, topk,
        leaderboard, average, wordcount, worddocumentcount); `params` are
        the type's geometry keys (see server._GRID_GEOMETRY)."""
        self.call(
            (
                Atom("grid_new"),
                name.encode(),
                Atom(type_name),
                {Atom(k): v for k, v in params.items()},
            )
        )

    def grid_apply(self, name: str, per_replica_ops: List[List[Any]]) -> int:
        return self.call((Atom("grid_apply"), name.encode(), per_replica_ops))

    def grid_apply_extras(self, name: str, per_replica_ops: List[List[Any]]):
        """Like grid_apply, but returns the generated extra effect ops
        per replica, in the grid's own op shapes so they feed straight
        back into grid_apply: topk_rmv yields dominated-add re-broadcast
        rmvs and rmv-driven promotion adds; leaderboard yields
        ban-promotion adds; the other types []."""
        return self.call(
            (Atom("grid_apply_extras"), name.encode(), per_replica_ops)
        )

    def grid_apply_packed(self, name: str, groups) -> int:
        """The packed-columns throughput surface (server._PACKED_COLUMNS):
        `groups` is a list of (tag, per_replica_counts, [column, ...])
        with numpy/sequence int data; each column carries that field for
        every op, concatenated in replica order, and ships as ONE i32-LE
        binary instead of per-op ETF tuples."""
        return self.call(
            (Atom("grid_apply_packed"), name.encode(), _pack_groups(groups))
        )

    def grid_apply_packed_multi(self, name: str, batches) -> int:
        """Multi-batch `grid_apply_packed` in ONE wire call. For topk_rmv
        the server validates every batch up front (all-or-nothing), then
        uploads the stacked batches once and applies them in order on
        the device with one dominated-count readback — wire round-trip,
        upload and sync all amortize over len(batches). Returns the
        total extras count (topk_rmv dominated elements)."""
        return self.call(
            (Atom("grid_apply_packed_multi"), name.encode(),
             [_pack_groups(groups) for groups in batches])
        )

    def grid_apply_extras_packed(self, name: str, groups):
        """Packed `grid_apply_extras`: same input form as
        grid_apply_packed; the generated extras come back as packed
        groups in the grid's own packed column orders (decoded here to
        (tag, counts, [columns]) numpy tuples), so they feed straight
        back into grid_apply_packed."""
        import numpy as np

        reply = self.call(
            (Atom("grid_apply_extras_packed"), name.encode(),
             _pack_groups(groups))
        )
        return [
            (
                str(tag),
                np.frombuffer(counts_bin, dtype="<i4"),
                [np.frombuffer(cb, dtype="<i4") for cb in col_bins],
            )
            for tag, counts_bin, col_bins in reply
        ]

    def grid_merge_all(self, name: str) -> None:
        self.call((Atom("grid_merge_all"), name.encode()))

    def grid_observe(self, name: str, replica: int = 0, key: int = 0):
        return self.call((Atom("grid_observe"), name.encode(), replica, key))

    def grid_to_binary(self, name: str) -> bytes:
        """Self-contained (geometry + state) snapshot of a dense grid."""
        return self.call((Atom("grid_to_binary"), name.encode()))

    def grid_from_binary(self, name: str, blob: bytes) -> None:
        """Rebuild a grid (geometry included in the blob) — the worker
        restart / site-clone path."""
        self.call((Atom("grid_from_binary"), name.encode(), blob))


def add(key: int, id_: Any, score: int, dc: int, ts: int):
    """Grid add op term."""
    return (Atom("add"), key, id_, score, dc, ts)


def rmv(key: int, id_: Any, vc: dict):
    """Grid removal op term; vc maps dc -> ts."""
    return (Atom("rmv"), key, id_, [(d, t) for d, t in sorted(vc.items())])

def _pack_i32_col(x) -> bytes:
    """One packed wire column: i32-LE bytes, loud on out-of-range values
    (a silent astype would truncate 2**40+7 to 7 and corrupt CRDT state
    undetectably; the tuple wire's ETF encoder raises on such ints too)."""
    import numpy as np

    arr = np.asarray(x)
    if arr.size and not np.issubdtype(arr.dtype, np.integer):
        # A float column (e.g. 3.7) would pass the range check below and
        # astype would silently truncate it to 3; the tuple wire's ETF
        # encoder rejects non-integers, so the packed wire must too.
        raise ValueError(f"packed column requires integer dtype, got {arr.dtype}")
    if arr.size and (int(arr.min()) < -(2**31) or int(arr.max()) >= 2**31):
        raise ValueError("packed column value out of i32 range")
    return arr.astype("<i4").tobytes()


def _pack_groups(groups):
    """Pack (tag, counts, [cols]) groups to the wire form — the Python
    twin of the Erlang client's pack_groups/1."""
    return [
        (Atom(tag), _pack_i32_col(counts), [_pack_i32_col(c) for c in cols])
        for tag, counts, cols in groups
    ]
