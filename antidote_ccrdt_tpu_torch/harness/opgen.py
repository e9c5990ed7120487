"""Synthetic topk_rmv effect-op batches for the dense engine (port of
``antidote_ccrdt_tpu/harness/opgen.py``: ``Workload``, ``_draw_ids``,
``TopkRmvEffectGen``).

The draws are the JAX generator's, call for call, from the same numpy
``default_rng(seed)``: both packages produce the same ops for one seed.
Only the last step differs — the arrays become tensors on a device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.topk_rmv_dense import TopkRmvOps


@dataclasses.dataclass
class Workload:
    n_replicas: int
    n_ids: int
    rmv_frac: float = 0.0
    rmv_kind: str = "rmv"  # "ban" for leaderboard
    zipf_a: float = 1.2  # Zipf exponent; <= 1.0 means uniform
    score_max: int = 10_000
    seed: int = 0


def _draw_ids(rng: np.random.Generator, wl: Workload, n: int) -> np.ndarray:
    if wl.zipf_a <= 1.0:
        return rng.integers(0, wl.n_ids, size=n).astype(np.int32)
    # Zipf over the id space: rejection-free via truncated zipf mod n_ids.
    raw = rng.zipf(wl.zipf_a, size=n)
    return ((raw - 1) % wl.n_ids).astype(np.int32)


class TopkRmvEffectGen:
    """Pre-stamped topk_rmv effect batches for the dense engine.

    Each replica r is a DC with its own monotone clock; removal vcs carry
    the generator's frontier (max ts emitted per DC before the rmv), the
    state vc a replica would hold under in-order broadcast delivery.
    Batches land on `device` (default: the CUDA card; raises without one).
    """

    def __init__(self, wl: Workload, device: DeviceLike = None):
        if wl.n_replicas < 1:
            raise ValueError("a workload needs at least one replica")
        self.wl = wl
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(wl.seed)
        self.clock = np.zeros(wl.n_replicas, dtype=np.int64)  # per-DC ts
        self.frontier = np.zeros(wl.n_replicas, dtype=np.int32)

    def next_batch(self, adds_per_replica: int, rmvs_per_replica: int) -> TopkRmvOps:
        """Build one TopkRmvOps batch [R, B] / [R, Br]."""
        wl, rng = self.wl, self.rng
        R, B, Br = wl.n_replicas, adds_per_replica, rmvs_per_replica
        add_id = np.stack([_draw_ids(rng, wl, B) for _ in range(R)])
        add_score = rng.integers(1, wl.score_max, size=(R, B)).astype(np.int32)
        add_dc = np.broadcast_to(np.arange(R, dtype=np.int32)[:, None], (R, B)).copy()
        add_ts = np.empty((R, B), dtype=np.int32)
        for r in range(R):
            add_ts[r] = np.arange(1, B + 1, dtype=np.int32) + self.clock[r]
            self.clock[r] += B
        rmv_id = (
            np.stack([_draw_ids(rng, wl, Br) for _ in range(R)])
            if Br else np.full((R, 1), -1, np.int32)
        )
        # Removal vc: the emitting DC's causal frontier — everything emitted
        # in earlier batches (all DCs) plus its own adds in this batch.
        rmv_vc = np.broadcast_to(self.frontier[None, None, :], (R, Br, R)).copy()
        for r in range(R):
            rmv_vc[r, :, r] = self.clock[r]
        self.frontier = self.clock.astype(np.int32).copy()
        # Br == 0 still ships one padded rmv column, as the JAX generator
        # does (its shapes are static).
        if not Br:
            rmv_vc = np.zeros((R, 1, R), np.int32)

        def t(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

        return TopkRmvOps(
            add_key=t(np.zeros((R, B), np.int32)),
            add_id=t(add_id),
            add_score=t(add_score),
            add_dc=t(add_dc),
            add_ts=t(add_ts),
            rmv_key=t(np.zeros((R, max(Br, 1)), np.int32)),
            rmv_id=t(rmv_id),
            rmv_vc=t(rmv_vc),
        )
