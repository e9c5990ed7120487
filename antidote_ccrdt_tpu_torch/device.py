"""Device resolution for the port's entry points."""

from __future__ import annotations

import contextvars
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# Set inside ``core.batch_merge.host_device``: entry points called without
# a device run on the CPU.
HOST_ONLY: contextvars.ContextVar[bool] = contextvars.ContextVar("host_only", default=False)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default (the CPU
    inside ``core.batch_merge.host_device``), the given one otherwise.
    Without a card and without an explicit device this raises: the port
    never falls back to the CPU quietly."""
    if device is None and HOST_ONLY.get():
        return torch.device("cpu")
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
    a kernel launched through a plain C interface. Read through the call
    Triton uses for its launches: ``torch.cuda.current_stream`` builds a
    Stream object, several microseconds of host time a launch."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)

