"""mesh/: device-sharded elastic workers.

Port of ``antidote_ccrdt_tpu/mesh/``. Partitions (core/partition.py)
pinned to key-axis shards of a (dc, key) mesh (`plan.MeshPlan`, logical
devices on one physical device: ``parallel.dist``), intra-slice
reconciliation as a batched JOIN collective (`reduce.ici_reduce`),
cross-slice anti-entropy through the existing gossip plane (`gossip`).
Armed by `CCRDT_MESH=1` when more than one device is visible (the cards,
or the logical devices of a ``parallel.dist.logical_devices`` region);
otherwise every caller takes today's exact single-device path —
`install_from_env` returns None and nothing else in the worker changes.
On one card it is None, as the JAX package's is on one device.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from .plan import MeshPlan  # noqa: F401
from . import gossip, reduce  # noqa: F401
from .reduce import ici_reduce, psum_reduce, supports, try_ici_reduce  # noqa: F401

ENV_FLAG = "CCRDT_MESH"


def enabled(override: Optional[bool] = None) -> bool:
    """True when mesh sharding should arm: explicit override, else
    `CCRDT_MESH=1` — and, either way, only with more than one device
    (a 1-device mesh is the single-device path; arming it would only
    add dispatch overhead for bit-identical results)."""
    if override is None:
        if os.environ.get(ENV_FLAG, "0") != "1":
            return False
    elif not override:
        return False
    from ..parallel.dist import mesh_devices

    return len(mesh_devices()) > 1


def install_from_env(
    dense: Any,
    partitions: Optional[int] = None,
    override: Optional[bool] = None,
    metrics: Optional[Any] = None,
) -> Optional[MeshPlan]:
    """The worker's single mesh entry point: a ready `MeshPlan` when the
    mesh should arm for this engine, None otherwise (single device,
    `CCRDT_MESH` unset, or a MONOID engine the JOIN reduce excludes)."""
    if not enabled(override) or not supports(dense):
        return None
    plan = MeshPlan.from_env(partitions=partitions)
    if metrics is not None:
        plan.export_gauges(metrics)
    return plan
