"""Carry states and op batches between the JAX package and this port.

The JAX package's pytrees (dataclasses and NamedTuples of arrays) leave
through ``np.asarray(leaf)`` — any object with the port's field names as
attributes and array-like leaves will do, so this module needs no jax.
Back the other way, `to_numpy` gives a dict of numpy arrays that the JAX
side rebuilds with ``JaxCls(**{k: jnp.asarray(v) ...})``. Dense states of
every ported engine (``TopkRmvDenseState``, ``TopkDenseState``,
``LeaderboardDenseState``, ``AverageState``, ``WordcountDenseState``), the
compaction log ``TopkRmvLog`` and the delta ``TopkRmvDelta`` cross this
way; a nested state (``LiftedMonoidState``) names the class of each
nested field, and its static fields (``swept``) cross as they are.

Scalar states are plain Python: NamedTuples cross field by field with
`scalar_state` (the JAX package's ``TopkState`` becomes this package's,
and back), tuples and dicts as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .utils.tree import as_numpy, children, dataclass_fields


def _fields(cls) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(leaf field names, static field names) of a dataclass or NamedTuple
    type, by `utils.tree`'s rule."""
    if dataclasses.is_dataclass(cls):
        return dataclass_fields(cls)
    return tuple(cls._fields), ()


def from_numpy(cls, src: Any, device: DeviceLike = None, nested: Optional[Dict[str, type]] = None):
    """Build the port's `cls` (a state, ops, log, delta or Observed type)
    on `device` from an object whose attributes carry `cls`'s field names,
    or from a dict keyed by them. None leaves stay None; a static
    dataclass field is taken as it is; a field named in `nested` is built
    as that class (e.g. ``nested={"inner": AverageState}``)."""
    dev = resolve_device(device)
    nested = nested or {}
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    names, static = _fields(cls)
    out = {name: get(name) for name in static}
    for name in names:
        leaf = get(name)
        if name in nested:
            out[name] = from_numpy(nested[name], leaf, dev)
        else:
            out[name] = None if leaf is None else torch.from_numpy(np.array(leaf)).to(dev)
    return cls(**out)


def to_numpy(obj: Any) -> Dict[str, Optional[Any]]:
    """The port's dataclass or NamedTuple as {field: numpy array}; nested
    states become nested dicts, None and static values (``swept``) stay as
    they are."""
    out: Dict[str, Optional[Any]] = {}
    for suffix, leaf in children(obj)[1]:
        if isinstance(leaf, torch.Tensor):
            leaf = as_numpy(leaf)
        elif children(leaf)[0] in ("dataclass", "namedtuple"):
            leaf = to_numpy(leaf)
        out[suffix[1:]] = leaf
    out.update({k: getattr(obj, k) for k in _fields(type(obj))[1]})
    return out


def scalar_state(state: Any, cls: Optional[type] = None) -> Any:
    """A scalar state as an instance of `cls`, field by field: a
    NamedTuple state of one package becomes the other's class of the same
    fields. Without `cls` (average's tuple, the wordcounts' dict) the state
    is returned as it is; its values are plain Python either way."""
    if cls is None:
        return state
    return cls(*state)
