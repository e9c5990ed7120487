"""Erlang External Term Format (ETF) codec — wire parity with the reference.

The reference serializes every CRDT state with ``term_to_binary`` /
``binary_to_term`` (e.g. ``antidote_ccrdt_topk_rmv.erl:156-163``,
``antidote_ccrdt_wordcount.erl:59-64``). This module implements the subset
of ETF those states use, so snapshots written by a real Antidote/BEAM node
can be loaded into this framework and vice versa:

* integers (small / 32-bit / bignum), new floats, atoms (all three atom
  tags on decode, SMALL_ATOM_UTF8 on encode — what modern OTP emits),
  tuples, nil / proper lists / STRING_EXT byte-lists, binaries, maps,
  and zlib-compressed terms (decode).

Python <-> Erlang mapping:

    int    <-> SMALL_INTEGER/INTEGER/SMALL_BIG/LARGE_BIG
    float  <-> NEW_FLOAT
    Atom   <-> atom (Atom is a str subclass; ``Atom('nil')`` etc.)
    bytes  <-> BINARY
    str    -->  BINARY (utf-8); decode always yields bytes
    tuple  <-> SMALL_TUPLE/LARGE_TUPLE
    list   <-> NIL/LIST/STRING (STRING decodes to a list of ints,
               preserving Erlang's list-of-bytes semantics)
    dict   <-> MAP (encode orders keys by Erlang term order, matching
               how OTP flatmaps serialize — canonical bytes for <=32 keys)

Container helpers for the two stdlib structures reference states embed:

* ``gb_sets`` — ``{Size, Tree}`` with ``Tree = {Key, Smaller, Bigger} | nil``.
  ``gb_set_from_list`` rebuilds the exact balanced tree of
  ``gb_sets:from_ordset`` (the deterministic complete-tree construction),
  so encode(decode(x)) is byte-stable for sets built that way.
* ``sets`` — decode supports both the pre-OTP-24 record form (``{set, ...}``
  walked structurally) and the OTP-24+ map form (``#{Elem => []}``);
  encode always emits the map form (v2), which ``sets:is_element/2`` et al.
  accept on any modern OTP.

A copy of ``antidote_ccrdt_tpu/core/etf.py``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, Iterable, List, Tuple

VERSION_MAGIC = 131

# Term tags (subset).
NEW_FLOAT_EXT = 70
COMPRESSED = 80
SMALL_INTEGER_EXT = 97
INTEGER_EXT = 98
FLOAT_EXT = 99
ATOM_EXT = 100
SMALL_TUPLE_EXT = 104
LARGE_TUPLE_EXT = 105
NIL_EXT = 106
STRING_EXT = 107
LIST_EXT = 108
BINARY_EXT = 109
SMALL_BIG_EXT = 110
LARGE_BIG_EXT = 111
MAP_EXT = 116
ATOM_UTF8_EXT = 118
SMALL_ATOM_UTF8_EXT = 119


class Atom(str):
    """An Erlang atom. Equality and hashing are type-strict: ``Atom('x') !=
    'x'`` and the two can coexist as distinct dict keys, mirroring how the
    atom ``x`` and the binary ``<<"x">>`` are distinct Erlang terms (ids
    decode utf-8 binaries to plain str, so without this a state keyed by
    both would silently merge)."""

    __slots__ = ()

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Atom):
            return str.__eq__(self, other)
        return NotImplemented if not isinstance(other, str) else False

    def __ne__(self, other: Any) -> bool:
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __hash__(self) -> int:
        return hash(("\x00erlang-atom", str(self)))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Atom({str.__repr__(self)})"


NIL_ATOM = Atom("nil")


# --- encode ---------------------------------------------------------------


def _term_rank(x: Any) -> int:
    """Erlang term-order rank for the subset we encode:
    number < atom < tuple < map < nil/list < binary."""
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return 0
    if isinstance(x, (Atom, bool)):
        return 1
    if isinstance(x, tuple):
        return 2
    if isinstance(x, dict):
        return 3
    if isinstance(x, list):
        return 4
    if isinstance(x, (bytes, str)):
        return 5
    raise TypeError(f"not an encodable term: {type(x)!r}")


def _term_sort_key(x: Any):
    r = _term_rank(x)
    if r == 0:
        return (r, x)
    if r == 1:
        if isinstance(x, bool):
            return (r, "true" if x else "false")
        return (r, str(x))
    if r == 2:
        return (r, len(x), tuple(_term_sort_key(e) for e in x))
    if r == 3:
        return (r, len(x), tuple(sorted(_term_sort_key(k) for k in x)))
    if r == 4:
        return (r, tuple(_term_sort_key(e) for e in x))
    b = x.encode("utf-8") if isinstance(x, str) else x
    return (r, b)


def _enc_int(n: int, out: bytearray) -> None:
    if 0 <= n <= 255:
        out.append(SMALL_INTEGER_EXT)
        out.append(n)
    elif -(1 << 31) <= n < (1 << 31):
        out.append(INTEGER_EXT)
        out += struct.pack(">i", n)
    else:
        sign = 1 if n < 0 else 0
        mag = -n if sign else n
        b = mag.to_bytes((mag.bit_length() + 7) // 8, "little")
        if len(b) <= 255:
            out.append(SMALL_BIG_EXT)
            out.append(len(b))
        else:
            out.append(LARGE_BIG_EXT)
            out += struct.pack(">I", len(b))
        out.append(sign)
        out += b


def _enc(term: Any, out: bytearray) -> None:
    if isinstance(term, bool):
        # Erlang booleans are the atoms true/false.
        _enc(Atom("true" if term else "false"), out)
    elif isinstance(term, Atom):
        b = term.encode("utf-8")
        if len(b) <= 255:
            out.append(SMALL_ATOM_UTF8_EXT)
            out.append(len(b))
        else:
            out.append(ATOM_UTF8_EXT)
            out += struct.pack(">H", len(b))
        out += b
    elif isinstance(term, int):
        _enc_int(term, out)
    elif isinstance(term, float):
        out.append(NEW_FLOAT_EXT)
        out += struct.pack(">d", term)
    elif isinstance(term, (bytes, str)):
        b = term.encode("utf-8") if isinstance(term, str) else term
        out.append(BINARY_EXT)
        out += struct.pack(">I", len(b))
        out += b
    elif isinstance(term, tuple):
        if len(term) <= 255:
            out.append(SMALL_TUPLE_EXT)
            out.append(len(term))
        else:
            out.append(LARGE_TUPLE_EXT)
            out += struct.pack(">I", len(term))
        for x in term:
            _enc(x, out)
    elif isinstance(term, list):
        if not term:
            out.append(NIL_EXT)
            return
        if all(isinstance(x, int) and not isinstance(x, bool) and 0 <= x <= 255 for x in term) and len(term) <= 65535:
            # Erlang encodes lists of bytes as STRING_EXT; match it so our
            # bytes are identical to term_to_binary's.
            out.append(STRING_EXT)
            out += struct.pack(">H", len(term))
            out += bytes(term)
            return
        out.append(LIST_EXT)
        out += struct.pack(">I", len(term))
        for x in term:
            _enc(x, out)
        out.append(NIL_EXT)
    elif isinstance(term, dict):
        out.append(MAP_EXT)
        out += struct.pack(">I", len(term))
        # Canonical key order = Erlang term order (how OTP flatmaps with
        # <=32 keys serialize). For bigger maps OTP uses hash order, which
        # we cannot (and need not) reproduce — any order decodes fine.
        for k in sorted(term.keys(), key=_term_sort_key):
            _enc(k, out)
            _enc(term[k], out)
    else:
        raise TypeError(f"cannot encode {type(term)!r} as an Erlang term")


def encode(term: Any, compressed: bool = False) -> bytes:
    """``term_to_binary/1`` for the supported subset."""
    out = bytearray()
    _enc(term, out)
    if compressed:
        z = zlib.compress(bytes(out))
        if len(z) + 5 < len(out):
            return bytes([VERSION_MAGIC, COMPRESSED]) + struct.pack(">I", len(out)) + z
    return bytes([VERSION_MAGIC]) + bytes(out)


# --- decode ---------------------------------------------------------------


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated ETF term")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]


def _dec(r: _Reader) -> Any:
    tag = r.u8()
    if tag == SMALL_INTEGER_EXT:
        return r.u8()
    if tag == INTEGER_EXT:
        return struct.unpack(">i", r.read(4))[0]
    if tag == NEW_FLOAT_EXT:
        return struct.unpack(">d", r.read(8))[0]
    if tag == FLOAT_EXT:
        return float(r.read(31).split(b"\x00", 1)[0].decode("ascii"))
    if tag in (SMALL_BIG_EXT, LARGE_BIG_EXT):
        n = r.u8() if tag == SMALL_BIG_EXT else r.u32()
        sign = r.u8()
        mag = int.from_bytes(r.read(n), "little")
        return -mag if sign else mag
    if tag == ATOM_EXT:
        return _atom(r.read(r.u16()).decode("latin-1"))
    if tag == ATOM_UTF8_EXT:
        return _atom(r.read(r.u16()).decode("utf-8"))
    if tag == SMALL_ATOM_UTF8_EXT:
        return _atom(r.read(r.u8()).decode("utf-8"))
    if tag in (SMALL_TUPLE_EXT, LARGE_TUPLE_EXT):
        n = r.u8() if tag == SMALL_TUPLE_EXT else r.u32()
        return tuple(_dec(r) for _ in range(n))
    if tag == NIL_EXT:
        return []
    if tag == STRING_EXT:
        return list(r.read(r.u16()))
    if tag == LIST_EXT:
        n = r.u32()
        items = [_dec(r) for _ in range(n)]
        tail = _dec(r)
        if tail != []:
            raise ValueError("improper lists are not supported")
        return items
    if tag == BINARY_EXT:
        return r.read(r.u32())
    if tag == MAP_EXT:
        n = r.u32()
        out = {}
        for _ in range(n):
            k = _dec(r)
            out[_hashable(k)] = _dec(r)
        return out
    raise ValueError(f"unsupported ETF tag {tag}")


def _atom(name: str) -> Any:
    if name == "true":
        return True
    if name == "false":
        return False
    return Atom(name)


def _hashable(k: Any) -> Any:
    """Map keys must be hashable in Python: lists (including charlists from
    STRING_EXT) and dicts anywhere inside the key become tuples. States in
    the reference never use list keys, so this is a corner-case guard — it
    loses the list/tuple distinction on re-encode, not a round-trip path."""
    if isinstance(k, (list, tuple)):
        return tuple(_hashable(x) for x in k)
    if isinstance(k, dict):
        return tuple(
            (_hashable(kk), _hashable(vv))
            for kk, vv in sorted(k.items(), key=lambda kv: _term_sort_key(kv[0]))
        )
    return k


def decode(data: bytes) -> Any:
    """``binary_to_term/1`` for the supported subset."""
    if not data or data[0] != VERSION_MAGIC:
        raise ValueError("not an ETF term (bad version magic)")
    if len(data) < 2:
        raise ValueError("truncated ETF term")
    r = _Reader(data)
    r.u8()
    if r.data[r.pos] == COMPRESSED:
        r.u8()
        size = r.u32()
        z = zlib.decompressobj()
        plain = z.decompress(data[r.pos :])
        if len(plain) != size or z.unused_data or not z.eof:
            raise ValueError("bad compressed ETF payload")
        r = _Reader(plain)
        r.pos = 0
        term = _dec(r)
        if r.pos != len(plain):
            raise ValueError("trailing bytes after ETF term")
        return term
    term = _dec(r)
    if r.pos != len(data):
        raise ValueError("trailing bytes after ETF term")
    return term


# --- gb_sets --------------------------------------------------------------


def gb_set_to_list(term: Any) -> List[Any]:
    """Elements of a ``gb_sets:set()`` term ``{Size, Tree}``, in order."""
    size, tree = term
    out: List[Any] = []

    def walk(t: Any) -> None:
        if t == NIL_ATOM or t == []:
            return
        k, smaller, bigger = t
        walk(smaller)
        out.append(k)
        walk(bigger)

    walk(tree)
    if len(out) != size:
        raise ValueError(f"gb_set size {size} != {len(out)} elements")
    return out


def gb_set_from_list(items: Iterable[Any]) -> Tuple[int, Any]:
    """Build the ``{Size, Tree}`` term exactly as ``gb_sets:from_ordset/1``
    does (complete-tree construction over the sorted input)."""
    xs = sorted(items, key=_term_sort_key)

    def balance(lst: List[Any], s: int) -> Tuple[Any, List[Any]]:
        if s > 1:
            sm = s - 1
            s2 = sm // 2
            s1 = sm - s2
            t1, rest = balance(lst, s1)
            k, rest = rest[0], rest[1:]
            t2, rest = balance(rest, s2)
            return (k, t1, t2), rest
        if s == 1:
            return (lst[0], NIL_ATOM, NIL_ATOM), lst[1:]
        return NIL_ATOM, lst

    tree, rest = balance(xs, len(xs))
    assert not rest
    return (len(xs), tree)


# --- sets -----------------------------------------------------------------


def set_to_list(term: Any) -> List[Any]:
    """Elements of a ``sets:set()`` term — either the pre-OTP-24 record
    ``{set, Size, ..., Segs}`` (walked structurally, no hashing needed) or
    the OTP-24+ map form ``#{Elem => []}``."""
    if isinstance(term, dict):
        return list(term.keys())
    if isinstance(term, tuple) and len(term) == 9 and term[0] == Atom("set"):
        size = term[1]
        segs = term[8]
        out: List[Any] = []
        for seg in segs:
            for bucket in seg:
                out.extend(bucket)
        if len(out) != size:
            raise ValueError(f"sets record size {size} != {len(out)} elements")
        return out
    raise ValueError("not a sets:set() term")


def set_from_list(items: Iterable[Any]) -> dict:
    """Encode as the OTP-24+ map form ``#{Elem => []}`` — accepted by the
    ``sets`` module on any modern OTP (version-2 sets)."""
    return {x: [] for x in items}
