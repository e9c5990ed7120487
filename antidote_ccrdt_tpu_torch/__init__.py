"""antidote_ccrdt_tpu_torch: the PyTorch + CUDA twin of ``antidote_ccrdt_tpu``.

The JAX package is the reference; this package computes the same
functions bit for bit (every leaf is int32 or bool) on an NVIDIA Hopper
card. Plain tensor code is PyTorch; each function the JAX package wrote
as a Pallas kernel is a CUDA C++ kernel here (``csrc/``, built with nvcc
at first use and bound with ctypes, see ``ops/_build.py``).

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device they
raise. A kernel wrapper launches its kernel for a CUDA tensor and takes
its plain PyTorch version only for a tensor that lies on the CPU.

This package imports torch and numpy only: never jax, never any module
of ``antidote_ccrdt_tpu`` (whose package ``__init__`` imports jax).

Ported so far: the dense topk_rmv engine (``apply_ops``, ``merge``,
``observe``), its effect-op generator and the multi-DC ``DenseReplay``;
``batch_merge`` for the six type names, with the scalar models, the clock,
the snapshot codec, ETF/wire, and the topk and leaderboard dense engines.
"""

from .core.batch_merge import batch_merge  # noqa: F401
from .core.behaviour import (  # noqa: F401
    DenseCCRDT,
    MergeKind,
    Registry,
    ScalarCCRDT,
    registry,
)
from .core.clock import LogicalClock, ReplicaContext, WallClock, make_contexts  # noqa: F401
from .device import resolve_device  # noqa: F401

# Importing the model modules registers every ported type.
from .models import average, leaderboard, topk, topk_rmv, topk_rmv_dense, wordcount  # noqa: F401,E402


def is_type(name) -> bool:
    """Rebuild of ``antidote_ccrdt:is_type/1`` (``antidote_ccrdt.erl:61-62``)."""
    return registry.is_type(name)


def generates_extra_operations(name) -> bool:
    """Rebuild of ``antidote_ccrdt:generates_extra_operations/1``
    (``antidote_ccrdt.erl:64-65``)."""
    return registry.generates_extra_operations(name)


__version__ = "0.1.0"
