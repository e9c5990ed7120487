"""Timing discipline on a CUDA card (port of
``antidote_ccrdt_tpu/utils/benchtime.py``).

PyTorch returns before the card finishes, so a host-clock region must end
in `sync()`; a kernel's own time comes from CUDA events around many
launches (`cuda_time_ms`). `windowed` times windows of rounds stacked by
`stack_rounds`, each window in one timed region, with the first window
as the untimed warm-up.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from .tree import leaves, tree_map


def sync(device=None) -> None:
    """Wait until the card has finished all queued work."""
    torch.cuda.synchronize(device)


def cuda_time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream, from CUDA
    events around `reps` calls after `warmup` untimed ones. Python's
    garbage collector is run before and held off during the timed calls:
    a short call is host-bound, and a collection of a caller's garbage
    inside the region would be timed as the call's."""
    for _ in range(warmup):
        fn()
    gc.collect()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    enabled = gc.isenabled()
    gc.disable()
    try:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    finally:
        if enabled:
            gc.enable()
    return start.elapsed_time(end) / reps


def _sync_tree(tree: Any) -> None:
    """Wait for the card where a leaf of `tree` lies on one."""
    for x in leaves(tree):
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)
            return


def stack_rounds(batches: Sequence[Any]) -> Any:
    """Stack per-round op trees into one [W, ...] window tree."""
    return tree_map(lambda *xs: torch.stack(xs), *batches)


def windowed(
    apply_fn: Callable[[Any, Any], Any],
    state: Any,
    stacked_windows: Sequence[Any],
    ops_per_round: int,
) -> Tuple[float, float]:
    """Time windows of W rounds; returns (ops/sec, ms/round p50).

    Each window's rounds run one after another through ``apply_fn(state,
    ops)`` inside one timed region that ends in a synchronize.
    `stacked_windows[0]` is the warm-up window and is not timed. The
    per-round latency is window time / W, a smoothed estimator: single
    rounds inside a window are not timed apart."""

    def run(st, stacked):
        for k in range(len(leaves(stacked)[0])):
            st = apply_fn(st, tree_map(lambda x: x[k], stacked))
        return st

    W = len(leaves(stacked_windows[0])[0])
    state = run(state, stacked_windows[0])  # warm-up
    _sync_tree(state)
    times = []
    for stacked in stacked_windows[1:]:
        t0 = time.perf_counter()
        state = run(state, stacked)
        _sync_tree(state)
        times.append((time.perf_counter() - t0) / W)
    per_round = float(np.percentile(times, 50))
    total_ops = ops_per_round * W * len(times)
    return total_ops / (sum(times) * W), per_round * 1e3
