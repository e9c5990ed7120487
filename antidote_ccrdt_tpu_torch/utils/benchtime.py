"""Timing discipline on a CUDA card.

PyTorch returns before the card finishes, so a host-clock region must end
in `sync()`; a kernel's own time comes from CUDA events around many
launches (`cuda_time_ms`).
"""

from __future__ import annotations

from typing import Callable

import torch


def sync(device=None) -> None:
    """Wait until the card has finished all queued work."""
    torch.cuda.synchronize(device)


def cuda_time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream, from CUDA
    events around `reps` calls after `warmup` untimed ones."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps
