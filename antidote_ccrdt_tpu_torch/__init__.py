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
``observe``, ``coalesce_ops``), its effect-op and prepare-op generators
and the multi-DC ``DenseReplay`` (with its drop report); ``batch_merge``
for the six type names and its ``host_device`` region, with the scalar
models, the clock, the snapshot codec, ETF/wire, and the topk,
leaderboard, average and wordcount dense engines; whole-log op compaction
(``ops/compaction.py``, ``ops/segment.py``), delta-state replication
(``parallel/``) and the merge-law checker (``ops/laws.py``); the
validation checks (``utils/validate.py``), metrics with profiler hooks
and the timing helpers (``utils/``); the durable host path: the
flight-event log and span tracer (``obs/``), seeded fault points
(``utils/faults.py``), the scalar replay host (``harness/replay.py``),
partition digests and psnaps (``core/partition.py``, with the pager's
spill names in ``core/pager.py``), the op journal and dense and
partitioned checkpoints (``harness/checkpoint.py``), the write-ahead
delta log and its recovery (``harness/wal.py``), and the bindings of the
native C++ op log, causal scheduler and corpus tokenizer
(``harness/native_host.py``, ``harness/native_tokenizer.py``; built
from ``native/*.cpp`` with g++ at first use); the gossip plane: the
zone topology (``topo/``), the bridge's frame protocol
(``bridge/protocol.py``), SWIM membership and the file, simulator and
TCP transports with the ``GossipNode`` facade (``net/``), replication
lag, metrics export, request traces and the HTTP scrape endpoint
(``obs/{lag,export,rtrace,http}.py``), the dispatch profiler and device
observatory (``obs/{profile,devprof}.py``, hooked into
``core/batch_merge.py``), and the delta publisher, partial
anti-entropy and sweeps (``parallel/elastic.py``); the serve plane: snapshot
replicas, the one fold-and-observe materialization, the query plane and
its batcher, hot-key cache, sessions, the fleet read router, the ingest
plane and write router with tiered acks and the client write sessions
(``serve/``), and the audit certifiers and law checker
(``obs/audit.py``). The kernels: K1 and K1c (tombstone
scatter-max), K2 (delta placement) and K3 (the slot sort, a path for
each range of row widths) in ``csrc/``.
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
