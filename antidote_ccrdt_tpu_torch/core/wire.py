"""Reference-wire state conversion: our scalar states <-> the exact Erlang
terms the reference's ``to_binary/1`` produces.

Each CRDT's reference state shape (SURVEY.md §2):

    average            {Sum, Num}                       average.erl:57-58
    topk               {#{Id => Score}, Size}           topk.erl:55-58
    topk_rmv           {Obs, Masked, Removals, Vc,      topk_rmv.erl:67-74
                        Min, Size}
                         Obs      #{Id => {S,Id,{Dc,Ts}}}
                         Masked   #{Id => gb_set({S,Id,{Dc,Ts}})}
                         Removals #{Id => #{Dc => Ts}}
                         Vc       #{Dc => Ts}
                         Min      {S,Id,{Dc,Ts}} | {nil,nil,nil}
    leaderboard        {Obs, Masked, Bans, Min, Size}   leaderboard.erl:62-68
                         Obs/Masked #{Id => Score},
                         Bans sets:set(), Min {Id,S} | {nil,nil}
    wordcount          #{Word(binary) => Count}         wordcount.erl:44-48
    worddocumentcount  same shape                       worddocumentcount.erl

So a state snapshotted by a BEAM node via ``term_to_binary`` loads here
with ``from_reference_binary``, and states written by ``to_reference_binary``
load on the BEAM side with ``binary_to_term``. DC ids and element ids pass
through opaquely (ints, atoms, tuples, binaries all work — Antidote dcids
are arbitrary terms).

A copy of ``antidote_ccrdt_tpu/core/wire.py`` that loads into this
package's scalar states.
"""

from __future__ import annotations

from typing import Any, Dict

from . import etf
from .etf import Atom, NIL_ATOM

_NIL3 = (NIL_ATOM, NIL_ATOM, NIL_ATOM)
_NIL2 = (NIL_ATOM, NIL_ATOM)


def _id_to_term(x: Any) -> Any:
    return x.encode("utf-8") if isinstance(x, str) and not isinstance(x, Atom) else x


def _id_from_term(x: Any) -> Any:
    # Erlang has no string type — str ids encode as utf-8 binaries, so
    # utf-8 binaries decode back to str (non-utf-8 binaries stay bytes).
    # This makes state round-trips identity for str-keyed states and
    # term-level identity for BEAM snapshots (b"x" normalizes to "x" in
    # Python but re-encodes to the same binary).
    if isinstance(x, bytes):
        try:
            return x.decode("utf-8")
        except UnicodeDecodeError:
            return x
    return x


def _elem_to_term(e: Any) -> Any:
    if e is None or e == (None, None, None):
        return _NIL3
    s, i, (dc, ts) = e
    return (s, _id_to_term(i), (dc, ts))


def _elem_from_term(t: Any) -> Any:
    if t == _NIL3:
        return (None, None, None)
    s, i, (dc, ts) = t
    return (s, _id_from_term(i), (dc, ts))


# --- per-type converters --------------------------------------------------


def _average_to_term(state: Any) -> Any:
    s, n = state
    return (s, n)


def _average_from_term(term: Any) -> Any:
    s, n = term
    return (int(s), int(n))


def _topk_to_term(state: Any) -> Any:
    return ({_id_to_term(k): v for k, v in state.entries.items()}, state.size)


def _topk_from_term(term: Any) -> Any:
    from ..models.topk import TopkState

    entries, size = term
    return TopkState({_id_from_term(k): int(v) for k, v in entries.items()}, int(size))


def _topk_rmv_to_term(state: Any) -> Any:
    obs = {_id_to_term(k): _elem_to_term(v) for k, v in state.observed.items()}
    masked = {
        _id_to_term(k): etf.gb_set_from_list([_elem_to_term(e) for e in v])
        for k, v in state.masked.items()
    }
    removals = {_id_to_term(k): dict(v) for k, v in state.removals.items()}
    return (obs, masked, removals, dict(state.vc), _elem_to_term(state.min), state.size)


def _topk_rmv_from_term(term: Any) -> Any:
    from ..models.topk_rmv import TopkRmvState

    obs_t, masked_t, removals_t, vc_t, min_t, size = term
    obs = {_id_from_term(k): _elem_from_term(v) for k, v in obs_t.items()}
    masked = {
        _id_from_term(k): frozenset(_elem_from_term(e) for e in etf.gb_set_to_list(v))
        for k, v in masked_t.items()
    }
    removals = {_id_from_term(k): {dc: int(ts) for dc, ts in v.items()} for k, v in removals_t.items()}
    vc = {dc: int(ts) for dc, ts in vc_t.items()}
    return TopkRmvState(obs, masked, removals, vc, _elem_from_term(min_t), int(size))


def _leaderboard_to_term(state: Any) -> Any:
    obs = {_id_to_term(k): v for k, v in state.observed.items()}
    masked = {_id_to_term(k): v for k, v in state.masked.items()}
    bans = etf.set_from_list(_id_to_term(x) for x in state.bans)
    mn = _NIL2 if state.min == (None, None) else (_id_to_term(state.min[0]), state.min[1])
    return (obs, masked, bans, mn, state.size)


def _leaderboard_from_term(term: Any) -> Any:
    from ..models.leaderboard import LeaderboardState

    obs_t, masked_t, bans_t, min_t, size = term
    mn = (None, None) if min_t == _NIL2 else (_id_from_term(min_t[0]), int(min_t[1]))
    return LeaderboardState(
        {_id_from_term(k): int(v) for k, v in obs_t.items()},
        {_id_from_term(k): int(v) for k, v in masked_t.items()},
        frozenset(_id_from_term(x) for x in etf.set_to_list(bans_t)),
        mn,
        int(size),
    )


def _wordcount_to_term(state: Dict[str, int]) -> Any:
    return {_id_to_term(k): v for k, v in state.items()}


def _wordcount_from_term(term: Any) -> Any:
    return {_id_from_term(k): int(v) for k, v in term.items()}


_TO = {
    "average": _average_to_term,
    "topk": _topk_to_term,
    "topk_rmv": _topk_rmv_to_term,
    "leaderboard": _leaderboard_to_term,
    "wordcount": _wordcount_to_term,
    "worddocumentcount": _wordcount_to_term,
}

_FROM = {
    "average": _average_from_term,
    "topk": _topk_from_term,
    "topk_rmv": _topk_rmv_from_term,
    "leaderboard": _leaderboard_from_term,
    "wordcount": _wordcount_from_term,
    "worddocumentcount": _wordcount_from_term,
}


def state_to_term(name: str, state: Any) -> Any:
    """Our scalar state -> the reference's internal state term."""
    return _TO[name](state)


def state_from_term(name: str, term: Any) -> Any:
    """The reference's internal state term -> our scalar state."""
    return _FROM[name](term)


def to_reference_binary(name: str, state: Any, compressed: bool = False) -> bytes:
    """``Mod:to_binary(State)``-compatible bytes for our scalar state."""
    return etf.encode(state_to_term(name, state), compressed=compressed)


def from_reference_binary(name: str, data: bytes) -> Any:
    """Load bytes produced by the reference's ``to_binary/1`` (or ours)."""
    return state_from_term(name, etf.decode(data))
