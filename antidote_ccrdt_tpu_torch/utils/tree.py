"""Leaf-wise maps over the port's states, with JAX's leaf paths.

A state here is a dataclass, NamedTuple, tuple, list or dict of tensors
(nested), the shapes the JAX package registers as pytrees. A dataclass
field whose metadata says ``static=True`` is structure, not a leaf (as
``jax.tree_util.register_dataclass`` treats it); None is an empty node.
Paths are the strings ``jax.tree_util.keystr`` gives for the JAX twin of
the structure (``.counts``, ``.inner.sum``, ``['x']``, ``[0]``), so a dict
keyed by them means the same leaves in both packages. `children` is the
one walk of that structure: the maps here, the dense blobs'
treedef (``core/serial.py``) and ``convert.py`` all go through it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def as_numpy(x: Any) -> np.ndarray:
    """A tensor's values on the host as numpy; anything else through
    ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def dataclass_fields(cls: type) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(leaf field names, static field names) of a dataclass type."""
    fields = dataclasses.fields(cls)
    static = tuple(f.name for f in fields if f.metadata.get("static", False))
    return tuple(f.name for f in fields if f.name not in static), static


def children(x: Any):
    """(kind, [(path suffix, child)]) of a node. Kind None is a leaf (a
    tensor, an array or any other value); "none" is None; the others are
    "dataclass", "namedtuple", "tuple", "list" and "dict"."""
    if isinstance(x, torch.Tensor):
        return None, []
    if x is None:
        return "none", []
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return "dataclass", [(f".{k}", getattr(x, k)) for k in dataclass_fields(type(x))[0]]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return "namedtuple", [(f".{k}", v) for k, v in zip(x._fields, x)]
    if isinstance(x, (tuple, list)):
        return type(x).__name__, [(f"[{i}]", v) for i, v in enumerate(x)]
    if isinstance(x, dict):
        return "dict", [(f"[{k!r}]", x[k]) for k in sorted(x)]
    return None, []


def flatten_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's leaf order."""
    kind, kids = children(tree)
    if kind is None:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for suffix, child in kids:
        out.extend(flatten_with_path(child, prefix + suffix))
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def map_with_path(fn: Callable[..., Any], tree: Any, *rest: Any, prefix: str = "") -> Any:
    """A structure like `tree` whose leaf at path p is ``fn(p, leaf,
    *same leaves of rest)``. Static dataclass fields are taken from
    `tree`."""
    kind, kids = children(tree)
    if kind is None:
        return fn(prefix, tree, *rest)
    if kind == "none":
        return None
    rest_kids = [children(r)[1] for r in rest]
    if any(len(rk) != len(kids) for rk in rest_kids):
        raise ValueError(f"structures differ at {prefix or 'the root'}")
    mapped = [
        map_with_path(fn, child, *(rk[i][1] for rk in rest_kids), prefix=prefix + suffix)
        for i, (suffix, child) in enumerate(kids)
    ]
    if kind == "dataclass":
        names, static = dataclass_fields(type(tree))
        return type(tree)(**dict(zip(names, mapped)), **{k: getattr(tree, k) for k in static})
    if kind == "namedtuple":
        return type(tree)(*mapped)
    if kind in ("tuple", "list"):
        return type(tree)(mapped)
    return dict(zip(sorted(tree), mapped))


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` leaf by leaf over states of one structure."""
    return map_with_path(lambda _p, *xs: fn(*xs), tree, *rest)
