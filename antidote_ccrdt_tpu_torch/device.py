"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, the given
    one otherwise. Without a card and without an explicit device this
    raises: the port never falls back to the CPU quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def cuda_stream_handle(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on the tensor's device, for
    a kernel launched through a plain C interface."""
    return torch.cuda.current_stream(t.device).cuda_stream

