"""Versioned state serialization.

The reference serializes whole states with ``term_to_binary`` /
``binary_to_term`` in every type (e.g. ``antidote_ccrdt_topk_rmv.erl:156-163``)
— no schema, no version tag. SURVEY.md §5 flags this for repair: snapshots
must carry enough header to survive format evolution.

Wire layout (little-endian):

    magic   b"CCRD"             4 bytes
    version u8                  format version (currently 1)
    kind    u8                  0 = scalar (msgpack-less python payload),
                                1 = dense (npz payload)
    name    u8 len + utf-8      registered type name
    payload rest

Scalar payloads are encoded with a small self-describing codec (no pickle:
pickle is neither stable across versions nor safe to load from an untrusted
replica). Dense payloads are ``np.savez`` archives of the pytree leaves plus
a JSON treedef manifest.

A port of ``antidote_ccrdt_tpu/core/serial.py``: the scalar codec is the
same code, so its bytes equal the JAX package's. Dense states are this
package's dataclasses and NamedTuples of tensors; their leaves go through
numpy into the same npz layout, and the manifest carries the treedef
string JAX writes for the same structure, so a blob loads on either side.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Any, List, Tuple

import numpy as np

MAGIC = b"CCRD"
VERSION = 1
KIND_SCALAR = 0
KIND_DENSE = 1

# --- scalar payload codec -------------------------------------------------
# Self-describing, canonical (sorted map keys), covering the value shapes
# scalar CRDT states use: ints, strings, bytes, floats, bools, None,
# tuples, lists, dicts, frozensets.

_T_NONE, _T_INT, _T_STR, _T_BYTES, _T_FLOAT, _T_BOOL = 0, 1, 2, 3, 4, 5
_T_TUPLE, _T_LIST, _T_DICT, _T_FSET = 6, 7, 8, 9


def _enc(obj: Any, out: io.BytesIO) -> None:
    if obj is None:
        out.write(bytes([_T_NONE]))
    elif isinstance(obj, bool):
        out.write(bytes([_T_BOOL, int(obj)]))
    elif isinstance(obj, int):
        b = obj.to_bytes((obj.bit_length() + 8) // 8 + 1, "little", signed=True)
        out.write(bytes([_T_INT]))
        out.write(struct.pack("<I", len(b)))
        out.write(b)
    elif isinstance(obj, float):
        out.write(bytes([_T_FLOAT]))
        out.write(struct.pack("<d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        out.write(bytes([_T_STR]))
        out.write(struct.pack("<I", len(b)))
        out.write(b)
    elif isinstance(obj, bytes):
        out.write(bytes([_T_BYTES]))
        out.write(struct.pack("<I", len(obj)))
        out.write(obj)
    elif isinstance(obj, tuple):
        out.write(bytes([_T_TUPLE]))
        out.write(struct.pack("<I", len(obj)))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, list):
        out.write(bytes([_T_LIST]))
        out.write(struct.pack("<I", len(obj)))
        for x in obj:
            _enc(x, out)
    elif isinstance(obj, dict):
        out.write(bytes([_T_DICT]))
        out.write(struct.pack("<I", len(obj)))
        for k in sorted(obj.keys(), key=repr):
            _enc(k, out)
            _enc(obj[k], out)
    elif isinstance(obj, frozenset):
        out.write(bytes([_T_FSET]))
        out.write(struct.pack("<I", len(obj)))
        for x in sorted(obj, key=repr):
            _enc(x, out)
    else:
        raise TypeError(f"unserializable scalar-state value: {type(obj)!r}")


def _dec(buf: io.BytesIO) -> Any:
    tag = buf.read(1)[0]
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return bool(buf.read(1)[0])
    if tag == _T_INT:
        (n,) = struct.unpack("<I", buf.read(4))
        return int.from_bytes(buf.read(n), "little", signed=True)
    if tag == _T_FLOAT:
        return struct.unpack("<d", buf.read(8))[0]
    if tag == _T_STR:
        (n,) = struct.unpack("<I", buf.read(4))
        return buf.read(n).decode("utf-8")
    if tag == _T_BYTES:
        (n,) = struct.unpack("<I", buf.read(4))
        return buf.read(n)
    if tag == _T_TUPLE:
        (n,) = struct.unpack("<I", buf.read(4))
        return tuple(_dec(buf) for _ in range(n))
    if tag == _T_LIST:
        (n,) = struct.unpack("<I", buf.read(4))
        return [_dec(buf) for _ in range(n)]
    if tag == _T_DICT:
        (n,) = struct.unpack("<I", buf.read(4))
        return {(_dec(buf)): _dec(buf) for _ in range(n)}
    if tag == _T_FSET:
        (n,) = struct.unpack("<I", buf.read(4))
        return frozenset(_dec(buf) for _ in range(n))
    raise ValueError(f"bad tag {tag}")


def encode_term(obj: Any) -> bytes:
    """Bare canonical encoding of one python value (no snapshot header) —
    the framing used by op-log journals and the bridge wire protocol."""
    out = io.BytesIO()
    _enc(obj, out)
    return out.getvalue()


def decode_term(data: bytes) -> Any:
    buf = io.BytesIO(data)
    obj = _dec(buf)
    if buf.read(1):
        raise ValueError("trailing bytes after encoded term")
    return obj


def _header(kind: int, name: str) -> bytes:
    nb = name.encode("utf-8")
    return MAGIC + bytes([VERSION, kind, len(nb)]) + nb


def _parse_header(data: bytes) -> tuple[int, str, int]:
    if data[:4] != MAGIC:
        raise ValueError("not a CCRDT snapshot (bad magic)")
    version, kind, nlen = data[4], data[5], data[6]
    if version > VERSION:
        raise ValueError(f"snapshot version {version} is newer than supported {VERSION}")
    name = data[7 : 7 + nlen].decode("utf-8")
    return kind, name, 7 + nlen


def dumps_scalar(name: str, state: Any) -> bytes:
    out = io.BytesIO()
    out.write(_header(KIND_SCALAR, name))
    _enc(state, out)
    return out.getvalue()


def loads_scalar(data: bytes) -> tuple[str, Any]:
    kind, name, off = _parse_header(data)
    if kind != KIND_SCALAR:
        raise ValueError("snapshot is not a scalar state")
    return name, _dec(io.BytesIO(data[off:]))


def _flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, treedef string) of a state (the nodes `utils.tree.children`
    walks), with None for an absent leaf. The string is the one
    ``str(jax.tree_util.tree_flatten(x)[1])`` gives for the JAX package's
    twin of the same structure."""
    from ..utils.tree import children, dataclass_fields

    leaves: List[Any] = []

    def walk(x: Any) -> str:
        kind, kids = children(x)
        if kind is None:
            leaves.append(x)
            return "*"
        if kind == "none":
            return "None"
        subs = [walk(child) for _, child in kids]
        if kind == "dataclass":
            # Static fields are treedef metadata, as in
            # jax.tree_util.register_dataclass: "Name[(False,)]".
            meta = tuple(getattr(x, k) for k in dataclass_fields(type(x))[1])
            return f"CustomNode({type(x).__name__}[{meta!r}], [{', '.join(subs)}])"
        if kind == "namedtuple":
            return f"CustomNode(namedtuple[{type(x).__name__}], [{', '.join(subs)}])"
        if kind == "tuple":
            return f"({subs[0]},)" if len(subs) == 1 else f"({', '.join(subs)})"
        if kind == "list":
            return f"[{', '.join(subs)}]"
        return "{" + ", ".join(f"{k!r}: {s}" for k, s in zip(sorted(x), subs)) + "}"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like: Any, leaves: List[Any]) -> Any:
    """A structure like `like` with its leaves taken in order from
    `leaves` (numpy arrays), each a tensor on the device of the leaf it
    replaces."""
    import torch

    from ..utils.tree import map_with_path

    it = iter(leaves)

    def build(_path: str, x: Any) -> Any:
        dev = x.device if isinstance(x, torch.Tensor) else "cpu"
        return torch.from_numpy(next(it)).to(dev)

    return map_with_path(build, like)


def dumps_dense(name: str, state: Any) -> bytes:
    """Serialize a state of tensors: npz of leaves + JSON treedef manifest."""
    from ..utils.tree import as_numpy

    leaves, treedef = _flatten(state)
    arrs = {f"leaf{i}": as_numpy(x) for i, x in enumerate(leaves)}
    bio = io.BytesIO()
    np.savez(bio, manifest=np.frombuffer(
        json.dumps({"treedef": treedef, "n": len(leaves)}).encode(), dtype=np.uint8
    ), **arrs)
    return _header(KIND_DENSE, name) + bio.getvalue()


def peek_name(data: bytes) -> str:
    """The type name a dumps_scalar/dumps_dense blob was written under,
    without decoding the payload — the dispatch key for embedders that
    store heterogeneous snapshots (e.g. the bridge's grid restore)."""
    _kind, name, _off = _parse_header(bytes(data))
    return name


def loads_dense(data: bytes, like: Any) -> tuple[str, Any]:
    """Restore a dense state into the structure of `like` (same treedef);
    each leaf lands on the device of `like`'s leaf."""
    kind, name, off = _parse_header(data)
    if kind != KIND_DENSE:
        raise ValueError("snapshot is not a dense state")
    npz = np.load(io.BytesIO(data[off:]))
    manifest = json.loads(bytes(npz["manifest"]).decode())
    like_leaves, treedef = _flatten(like)
    if manifest["n"] != len(like_leaves):
        raise ValueError(
            f"snapshot has {manifest['n']} leaves but target structure has "
            f"{len(like_leaves)}"
        )
    if manifest["treedef"] != treedef:
        raise ValueError(
            f"snapshot treedef mismatch: stored {manifest['treedef']!r} vs "
            f"target {treedef!r}"
        )
    leaves = [npz[f"leaf{i}"] for i in range(manifest["n"])]
    return name, _unflatten(like, leaves)
