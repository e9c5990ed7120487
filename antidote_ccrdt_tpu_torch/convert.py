"""Carry states and op batches between the JAX package and this port.

The JAX package's pytrees (dataclasses and NamedTuples of arrays) leave
through ``np.asarray(leaf)`` — any object with the port's field names as
attributes and array-like leaves will do, so this module needs no jax.
Back the other way, `to_numpy` gives a dict of numpy arrays that the JAX
side rebuilds with ``JaxCls(**{k: jnp.asarray(v) ...})``. Dense states of
every ported engine (``TopkRmvDenseState``, ``TopkDenseState``,
``LeaderboardDenseState``) cross this way.

Scalar states are plain Python: NamedTuples cross field by field with
`scalar_state` (the JAX package's ``TopkState`` becomes this package's,
and back), tuples and dicts as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device


def _fields(cls) -> list:
    if dataclasses.is_dataclass(cls):
        return [f.name for f in dataclasses.fields(cls)]
    return list(cls._fields)  # NamedTuple


def from_numpy(cls, src: Any, device: DeviceLike = None):
    """Build the port's flat `cls` (a state, ops or Observed type) on
    `device` from an object whose attributes carry `cls`'s field names,
    or from a dict keyed by them. None leaves stay None."""
    dev = resolve_device(device)
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    out = {}
    for name in _fields(cls):
        leaf = get(name)
        out[name] = None if leaf is None else torch.from_numpy(np.array(leaf)).to(dev)
    return cls(**out)


def to_numpy(obj: Any) -> Dict[str, Optional[Any]]:
    """The port's dataclass or NamedTuple as {field: numpy array}; nested
    NamedTuples become nested dicts, None stays None."""
    out: Dict[str, Optional[Any]] = {}
    for name in _fields(type(obj)):
        leaf = getattr(obj, name)
        if leaf is None:
            out[name] = None
        elif isinstance(leaf, torch.Tensor):
            out[name] = leaf.detach().cpu().numpy()
        else:
            out[name] = to_numpy(leaf)
    return out


def scalar_state(state: Any, cls: Optional[type] = None) -> Any:
    """A scalar state as an instance of `cls`, field by field: a
    NamedTuple state of one package becomes the other's class of the same
    fields. Without `cls` (average's tuple, the wordcounts' dict) the state
    is returned as it is; its values are plain Python either way."""
    if cls is None:
        return state
    return cls(*state)
