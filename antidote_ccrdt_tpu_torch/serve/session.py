"""Client session guarantees for the fleet read tier.

A fleet of read replicas converges *eventually*; a single client still
wants two per-session promises on top (the CRDT session-guarantee
taxonomy of arxiv 2310.18220):

* **read-your-writes** — after this session wrote (origin o, seq s), a
  later read must reflect o's stream through s;
* **monotonic-reads** — a later read never observes LESS of any origin's
  stream than an earlier read in the same session did.

Both reduce to one mechanism because every serve response already
carries provenance: the answering replica stamps its response with the
per-origin **applied watermarks** of the snapshot it served from
(`ServePlane.swap` records them from `obs/lag.py`). A session then
carries a `SessionToken` — a per-origin floor `{origin: seq}` — and the
router only accepts answers from replicas whose served watermarks
*cover* the token (`covers`). Writes raise the floor directly
(`note_write`); reads raise it to the served watermarks when
monotonic-reads is on (`note_read`).

The token is plain JSON (`{origin: seq}`), rides the query request under
the ``"session"`` key, and is enforced twice: the router routes only to
peers whose last-known watermarks cover it, and the serving plane
double-checks against the live snapshot (`session_uncovered` error
instead of a silently-stale answer). Every write and every accepted
read is flight-recorded (``session.write`` / ``session.read`` events),
which is what lets `obs.audit.certify_sessions` replay the log and
certify — or produce a counterexample for — the two guarantees after
the fact.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional, Tuple

from ..obs import events as obs_events

_session_ids = itertools.count()


def covers(served: Dict[str, int], token: Dict[str, int]) -> bool:
    """Does a replica's applied-watermark map satisfy a token? Every
    origin the token names must be applied at least through the token's
    floor; an origin the replica has never heard of counts as -1 (it
    cannot prove coverage by silence)."""
    return all(int(served.get(o, -1)) >= int(s) for o, s in token.items())


def gaps(
    served: Dict[str, int], token: Dict[str, int]
) -> Dict[str, Tuple[int, int]]:
    """The uncovered origins: {origin: (have, want)} — empty iff
    `covers`. This is the counterexample shape the audit layer and the
    honest `session_unsatisfiable` error both name."""
    out: Dict[str, Tuple[int, int]] = {}
    for o, want in token.items():
        have = int(served.get(o, -1))
        if have < int(want):
            out[o] = (have, int(want))
    return out


def merge_floor(a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    """Pointwise max of two per-origin floors (the token join)."""
    out = dict(a)
    for o, s in b.items():
        if int(s) > int(out.get(o, -1)):
            out[o] = int(s)
    return out


class SessionToken:
    """A per-origin seq floor `{origin: seq}`, the wire form of a
    session's accumulated requirement. Thread-safe: router worker
    threads may advance it while the client issues the next read."""

    def __init__(self, floor: Optional[Dict[str, int]] = None):
        self._floor: Dict[str, int] = {
            str(o): int(s) for o, s in (floor or {}).items()
        }
        self._lock = threading.Lock()

    def advance(self, origin: str, seq: int) -> None:
        with self._lock:
            if int(seq) > self._floor.get(origin, -1):
                self._floor[origin] = int(seq)

    def absorb(self, watermarks: Dict[str, int]) -> None:
        """Raise the floor to `watermarks` pointwise (monotonic-reads:
        what one read observed, every later read must re-observe)."""
        with self._lock:
            self._floor = merge_floor(self._floor, watermarks)

    def floor(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._floor)

    def covered_by(self, served: Dict[str, int]) -> bool:
        return covers(served, self.floor())

    def __bool__(self) -> bool:
        with self._lock:
            return bool(self._floor)

    def __repr__(self) -> str:
        return f"SessionToken({self.floor()!r})"


class ClientSession:
    """One client's session state + the flight-record feed the audit
    layer certifies from.

    `guarantees` picks which promises the session demands:
    ``read_your_writes`` makes `note_write` raise the token floor;
    ``monotonic_reads`` makes `note_read` absorb served watermarks.
    Either may be disabled to price exactly the contract a caller wants
    (both off = a plain eventually-consistent session whose reads are
    still recorded, so certification stays possible)."""

    def __init__(
        self,
        session_id: Optional[str] = None,
        read_your_writes: bool = True,
        monotonic_reads: bool = True,
    ):
        self.session_id = (
            session_id
            if session_id is not None
            else f"s{next(_session_ids)}"
        )
        self.read_your_writes = bool(read_your_writes)
        self.monotonic_reads = bool(monotonic_reads)
        self.token = SessionToken()

    # -- the client-visible surface -----------------------------------------

    def note_write(self, origin: str, seq: int) -> None:
        """This session observed its own write land as (origin, seq) —
        e.g. the ack of an op it pushed to worker `origin`. Later reads
        must cover it (read-your-writes)."""
        if self.read_your_writes:
            self.token.advance(origin, int(seq))
        # `wseq`, not `seq`: the flight recorder stamps its own per-
        # process `seq` ordinal on every event (same convention as
        # wal.append).
        obs_events.emit(
            "session.write", session=self.session_id, origin=str(origin),
            wseq=int(seq),
        )

    def note_read(
        self, peer: str, served_watermarks: Dict[str, int],
        required: Optional[Dict[str, int]] = None,
    ) -> None:
        """An accepted read answered by `peer` claiming
        `served_watermarks`. Recorded BEFORE the token absorbs the
        watermarks, so the event's `require` field is exactly what this
        read had to satisfy — the replay certifier recomputes the same
        floor independently and cross-checks."""
        obs_events.emit(
            "session.read", session=self.session_id, peer=str(peer),
            require=(required if required is not None else self.token.floor()),
            served={str(o): int(s) for o, s in served_watermarks.items()},
            rw=self.read_your_writes, mono=self.monotonic_reads,
        )
        if self.monotonic_reads:
            self.token.absorb(served_watermarks)

    def requirement(self) -> Dict[str, int]:
        """The floor a read issued NOW must satisfy."""
        return self.token.floor()


def session_doc(token: Any) -> Optional[Dict[str, int]]:
    """Normalize a token (SessionToken | dict | None) to its wire dict,
    None when empty — request encoders call this so an empty session
    adds no bytes to the frame."""
    if token is None:
        return None
    floor = token.floor() if isinstance(token, SessionToken) else dict(token)
    return {str(o): int(s) for o, s in floor.items()} or None
