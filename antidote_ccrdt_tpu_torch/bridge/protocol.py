"""Bridge wire protocol: Erlang `{packet, 4}` framing + ETF terms.

The north-star integration path (SURVEY.md §5 "Distributed communication
backend") is a bridge feeding op batches from a BEAM-shaped host into the
persistent worker. The protocol is what an Erlang port/socket client
speaks natively:

    frame   := u32_be length ++ payload
    payload := term_to_binary(Request | Reply)

Requests are tagged tuples `{call, ReqId, Op}` or `{icall, Token, ReqId,
Op}`; replies are `{reply, ReqId, {ok, Result} | {error, Binary |
{Kind, Binary}}}`. ReqIds let a client pipeline requests.

`icall` is the IDEMPOTENT request form: `Token` is a client-chosen
random binary identifying the client incarnation, and the server keeps
a bounded (Token, ReqId) -> Reply cache, so a request RESENT after a
reconnect (the client cannot know whether the first send executed)
returns the original reply instead of executing twice — required for
non-idempotent ops like grid_apply. `call` stays for one-shot clients
and BEAM hosts that manage their own retries.

Error replies carry `{Kind, Message}` where Kind is an atom naming the
exception class (`badarg`-style structured errors a host can switch
on); the bare-binary form remains accepted on decode for old peers. Op shapes (atoms abbreviated as Python `Atom`):

    {new, Type, Args}                 -> {ok, Handle}      scalar instance
    {from_binary, Type, Bin}          -> {ok, Handle}      load BEAM snapshot
    {downstream, Handle, Op, Dc, Ts}  -> {ok, Effect | nil}
    {update, Handle, Effect}          -> {ok, [ExtraOps]}
    {value, Handle}                   -> {ok, Value}
    {to_binary, Handle}               -> {ok, Bin}         reference format
    {equal, H1, H2}                   -> {ok, Bool}
    {compact, Handle, [Effect]}       -> {ok, [Effect]}    whole-log compaction
    {free, Handle}                    -> {ok, true}
    {batch_merge, Type, [H | Bin]}    -> {ok, Handle}      join N states, one pass
    {is_type, Type}                   -> {ok, Bool}        registry predicates
    {generates_extra_operations, Type}-> {ok, Bool}
    {is_operation, Type, Op}          -> {ok, Bool}        per-type predicates
    {require_state_downstream, Type, Op} -> {ok, Bool}
    {is_replicate_tagged, Type, Effect} -> {ok, Bool}
    {grid_new, Grid, Type, Params}    -> {ok, true}        dense grid (device)
    {grid_apply, Grid, OpsPerReplica} -> {ok, NDominated}
    {grid_merge_all, Grid}            -> {ok, true}        fold replicas (join)
    {grid_observe, Grid, Replica, Key}-> {ok, [{Id, Score}]}

Handles and grid names are arbitrary terms chosen by the server/client.
"""

from __future__ import annotations

import struct
from typing import Any, Optional, Tuple

from ..core import etf
from ..core.etf import Atom

A_CALL = Atom("call")
A_ICALL = Atom("icall")
A_REPLY = Atom("reply")
A_OK = Atom("ok")
A_ERROR = Atom("error")
A_NIL = Atom("nil")

MAX_FRAME = 256 * 1024 * 1024


def pack_frame(term: Any) -> bytes:
    payload = etf.encode(term)
    return struct.pack(">I", len(payload)) + payload


def unpack_frames(buf: bytearray):
    """Yield decoded terms from `buf`, consuming complete frames in place."""
    while True:
        if len(buf) < 4:
            return
        (n,) = struct.unpack(">I", bytes(buf[:4]))
        if n > MAX_FRAME:
            raise ValueError(f"frame of {n} bytes exceeds limit")
        if len(buf) < 4 + n:
            return
        payload = bytes(buf[4 : 4 + n])
        del buf[: 4 + n]
        yield etf.decode(payload)


def call(req_id: int, op: Any) -> Any:
    return (A_CALL, req_id, op)


def icall(token: bytes, req_id: int, op: Any) -> Any:
    """Idempotent request: the server dedups on (token, req_id)."""
    return (A_ICALL, token, req_id, op)


def reply_ok(req_id: int, result: Any) -> Any:
    return (A_REPLY, req_id, (A_OK, result))


def reply_error(req_id: Any, message: str, kind: str = "error") -> Any:
    """Structured error frame: {error, {Kind, Message}}. Kind is an atom
    (typically the exception class name) a host can dispatch on without
    parsing the human-readable message."""
    return (A_REPLY, req_id, (A_ERROR, (Atom(kind), message.encode("utf-8"))))


def error_text(payload: Any) -> str:
    """Render an error payload — structured {Kind, Msg} or legacy bare
    binary — as the "Kind: message" string clients raise."""
    if (
        isinstance(payload, tuple)
        and len(payload) == 2
        and isinstance(payload[0], Atom)
    ):
        kind, msg = payload
        if isinstance(msg, bytes):
            msg = msg.decode("utf-8", "replace")
        return f"{kind}: {msg}"
    if isinstance(payload, bytes):
        return payload.decode("utf-8", "replace")
    return repr(payload)


# --- term <-> op conversion (shared by server and client) -----------------


def term_to_py(x: Any) -> Any:
    """Wire term -> python payload: atoms stay Atom, utf-8 binaries become
    str (non-utf-8 stay bytes), containers recurse."""
    if isinstance(x, bytes):
        try:
            return x.decode("utf-8")
        except UnicodeDecodeError:
            return x
    if isinstance(x, tuple):
        return tuple(term_to_py(e) for e in x)
    if isinstance(x, list):
        return [term_to_py(e) for e in x]
    if isinstance(x, dict):
        return {term_to_py(k): term_to_py(v) for k, v in x.items()}
    return x


def py_to_term(x: Any) -> Any:
    if isinstance(x, str) and not isinstance(x, Atom):
        return x.encode("utf-8")
    if isinstance(x, tuple):
        return tuple(py_to_term(e) for e in x)
    if isinstance(x, (list, frozenset, set)):
        return [py_to_term(e) for e in x]
    if isinstance(x, dict):
        return {py_to_term(k): py_to_term(v) for k, v in x.items()}
    return x


def op_from_term(t: Any) -> Tuple[str, Any]:
    """{add, Payload} -> ("add", payload)."""
    if not (isinstance(t, tuple) and len(t) == 2 and isinstance(t[0], Atom)):
        raise ValueError(f"bad op term: {t!r}")
    return (str(t[0]), term_to_py(t[1]))


def op_to_term(op: Optional[Tuple[str, Any]]) -> Any:
    if op is None:
        return A_NIL
    return (Atom(op[0]), py_to_term(op[1]))


def parse_reply(term: Any) -> Tuple[int, bool, Any]:
    """-> (req_id, ok, result_or_error_message)"""
    if not (isinstance(term, tuple) and len(term) == 3 and term[0] == A_REPLY):
        raise ValueError(f"not a reply term: {term!r}")
    _, req_id, body = term
    tag, payload = body
    if tag == A_OK:
        return req_id, True, payload
    return req_id, False, payload
