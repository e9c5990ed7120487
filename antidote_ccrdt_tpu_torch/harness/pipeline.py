"""Streaming ingest pipeline: overlap host batch-building with device work
(port of ``antidote_ccrdt_tpu/harness/pipeline.py``, pure Python).

PyTorch launches CUDA work asynchronously, so a plain loop already
overlaps *launches* with host work — but a host-side producer that only
yields the next batch after the previous `apply` was launched still
serializes its own work (op generation, tokenization) with any device
sync at the loop head. `Prefetcher` runs the producer on a background
thread with a bounded queue, so batch k+1 is built while batch k runs.

`stream_apply` is the standard consume loop: prefetch -> apply -> periodic
reconcile, returning the final state.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

_SENTINEL = object()


class Prefetcher:
    """Iterate `source` on a background thread, `depth` batches ahead.

    Exceptions in the producer propagate to the consumer at the point of
    `next()`. Close (or exhaust) to join the thread; usable as a context
    manager, for one pass only."""

    def __init__(self, source: Iterable[Any], depth: int = 2):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, depth))
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._done = False

        def worker():
            try:
                for item in source:
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 - forwarded to consumer
                self._err = e
            finally:
                # Never block on the sentinel: a closing consumer stops
                # draining, and an unbounded put here would deadlock the
                # join in close() (the queue can be full at depth=1).
                while not self._stop.is_set():
                    try:
                        self._q.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._done:  # iterator protocol: keep raising after exhaustion
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _SENTINEL:
            self._done = True
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # Drain so the producer's pending put can finish, then join.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stream_apply(
    engine: Any,
    state: Any,
    batches: Iterable[Any],
    *,
    depth: int = 2,
    reconcile_every: int = 0,
    reconcile: Optional[Callable[[Any], Any]] = None,
    apply_kwargs: Optional[dict] = None,
    coalesce: int = 0,
    coalesce_kwargs: Optional[dict] = None,
):
    """Fold a stream of op batches into `state` with prefetch overlap:
    ``state = engine.apply_ops(state, batch)[0]`` per batch, calling
    `reconcile(state)` every `reconcile_every` batches (0 = never).

    `coalesce=k` buffers k batches and pre-compacts them into ONE batch
    via the engine's whole-log `coalesce_ops` (ops/compaction.py) before
    applying — the pre-ship log-compaction pass (the reference host's
    can_compact/compact_ops walk, antidote_ccrdt.erl:55-56). The final
    partial group is coalesced too. `reconcile_every` then counts
    coalesced applications. Returns (state, n_batches) with n_batches
    the RAW batch count consumed."""
    kw = apply_kwargs or {}
    n = 0
    applied = 0

    def do_apply(ops):
        nonlocal state, applied
        state, _ = engine.apply_ops(state, ops, **kw)
        applied += 1
        if reconcile_every and reconcile is not None and applied % reconcile_every == 0:
            state = reconcile(state)

    buf = []
    with Prefetcher(batches, depth=depth) as pf:
        for ops in pf:
            n += 1
            if coalesce and coalesce > 1:
                buf.append(ops)
                if len(buf) == coalesce:
                    fused, _, _ = engine.coalesce_ops(buf, **(coalesce_kwargs or {}))
                    buf = []
                    do_apply(fused)
            else:
                do_apply(ops)
    if buf:
        fused, _, _ = engine.coalesce_ops(buf, **(coalesce_kwargs or {}))
        do_apply(fused)
    return state, n
