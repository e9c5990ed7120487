"""Shape/dtype validation of host data and the count of silently dropped
ops (port of ``antidote_ccrdt_tpu/utils/validate.py``).

Two failure classes are covered where host data (wire input, checkpoint
restores, generated op batches) becomes device tensors:

* **Structural** (`check_state`, `check_ops`): wrong dtype, wrong rank,
  mismatched batch axes, a rmv_vc whose DC width disagrees with the
  engine config. These raise with a path-qualified message (the paths
  are ``jax.tree_util.keystr``'s, as the JAX package prints them).
* **Semantic drops** (`topk_rmv_drop_report`): the engine drops
  out-of-range and padding ops on purpose (convergence-safe), silently.
  The report counts them by reason in one reduction on the ops' device,
  so a harness can tell "all padding" from "a feed is emitting garbage"
  (wire it to ``utils.metrics.Metrics.count``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict

import torch

from .tree import flatten_with_path, leaves


def _dtype(leaf: Any) -> torch.dtype:
    """A leaf's dtype; a Python scalar takes JAX's default (32-bit) type."""
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    if isinstance(leaf, bool):
        return torch.bool
    if isinstance(leaf, int):
        return torch.int32
    if isinstance(leaf, float):
        return torch.float32
    return torch.as_tensor(leaf).dtype


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _shape(leaf: Any) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def check_tree_dtype(tree: Any, what: str, dtype: torch.dtype = torch.int32) -> None:
    """Every leaf of `tree` must have exactly `dtype` (bool leaves are
    allowed: they are masks, not payloads)."""
    for path, leaf in flatten_with_path(tree):
        got = _dtype(leaf)
        if got == torch.bool:
            continue
        if got != dtype:
            raise TypeError(
                f"{what}{path}: dtype {_name(got)}, expected {_name(dtype)} "
                f"(host ints silently upcast to i64 break jit caches and "
                f"double HBM traffic)"
            )


def check_state(dense: Any, state: Any) -> None:
    """Structural check of a dense state against its engine config: dtype,
    the shared [R, NK] leading batch axes, and the config-derived
    trailing dims, by comparison with the structure the engine's own
    ``init`` builds (on the meta device: nothing is allocated), so it
    works for every registered dense engine. Use after a checkpoint
    restore or any host-side state surgery."""
    check_tree_dtype(state, type(state).__name__)
    flat = leaves(state)
    if not flat:
        raise ValueError("empty state pytree")
    lead = _shape(flat[0])[:2]
    if len(lead) < 2:
        raise ValueError(
            f"state leaves must carry [n_replicas, n_keys, ...] batch axes; "
            f"got shape {_shape(flat[0])}"
        )
    shapes_only = copy.copy(dense)
    shapes_only.device = torch.device("meta")
    ref = shapes_only.init(lead[0], lead[1])
    got_paths = dict(flatten_with_path(state))
    for path, ref_leaf in flatten_with_path(ref):
        if path not in got_paths:
            raise ValueError(f"state is missing leaf {path}")
        got_shape = _shape(got_paths[path])
        if got_shape != _shape(ref_leaf):
            raise ValueError(
                f"state{path}: shape {got_shape}, engine config expects "
                f"{_shape(ref_leaf)}"
            )


def check_ops(state_or_replicas: Any, ops: Any, dense: Any = None) -> None:
    """Structural check of an op batch: i32 leaves, a leading replica axis
    matching the state's and, when the engine is passed, config-derived
    trailing dims (a rmv_vc whose DC width disagrees with the engine's D
    would otherwise fail deep inside the engine with an opaque error)."""
    check_tree_dtype(ops, type(ops).__name__)
    if dataclasses.is_dataclass(state_or_replicas):
        n_replicas = _shape(leaves(state_or_replicas)[0])[0]
    else:
        n_replicas = int(state_or_replicas)
    for path, leaf in flatten_with_path(ops):
        shape = _shape(leaf)
        if not shape or shape[0] != n_replicas:
            raise ValueError(
                f"ops{path}: leading axis {shape[:1] or '()'} != n_replicas "
                f"{n_replicas}"
            )
    if dense is not None and hasattr(ops, "rmv_vc"):
        got_d = _shape(ops.rmv_vc)[-1]
        if got_d != dense.D:
            raise ValueError(
                f"ops.rmv_vc DC width {got_d} != engine n_dcs {dense.D}"
            )


def topk_rmv_drop_report(dense: Any, state: Any, ops: Any) -> Dict[str, int]:
    """Count the ops the engine will drop, by reason, in one reduction on
    the ops' device. Padding (add_ts <= 0, rmv_id < 0) is counted apart
    from genuine range violations, so a monitor can alert on the latter
    while ignoring the former. Returns plain ints (read back to the host)."""
    NK = _shape(leaves(state)[0])[1]
    I, D = dense.I, dense.D
    add_pad = ops.add_ts <= 0
    bad_key = (ops.add_key < 0) | (ops.add_key >= NK)
    bad_id = (ops.add_id < 0) | (ops.add_id >= I)
    bad_dc = (ops.add_dc < 0) | (ops.add_dc >= D)
    add_bad = ~add_pad & (bad_key | bad_id | bad_dc)
    rmv_pad = ops.rmv_id < 0
    rmv_bad = ~rmv_pad & ((ops.rmv_key < 0) | (ops.rmv_key >= NK) | (ops.rmv_id >= I))
    counts = torch.stack([
        add_pad.sum(), add_bad.sum(), (~add_pad & bad_key).sum(), (~add_pad & bad_id).sum(),
        (~add_pad & bad_dc).sum(), rmv_pad.sum(), rmv_bad.sum(),
    ]).tolist()
    names = ("add_padding", "add_dropped_out_of_range", "add_bad_key", "add_bad_id", "add_bad_dc",
             "rmv_padding", "rmv_dropped_out_of_range")
    return {k: int(v) for k, v in zip(names, counts)}
