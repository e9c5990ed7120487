"""Counters, latency recorders and profiler hooks (port of
``antidote_ccrdt_tpu/utils/metrics.py``).

    m = Metrics()
    with m.timer("sync"):
        rp.sync()
    m.count("ops_applied", n)
    m.summary()                       # {"sync": {"p50_ms": ...}, ...}

Timers read the host clock: around work on a card they measure the
enqueue unless the region ends in a synchronize (``utils.benchtime``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


class LatencyRecorder:
    """Append-only duration series with percentile summaries."""

    __slots__ = ("samples",)

    def __init__(self) -> None:
        self.samples: List[float] = []

    def record(self, seconds: float) -> None:
        self.samples.append(seconds)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"n": 0}
        a = np.asarray(self.samples)
        return {
            "n": int(a.size),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p90_ms": float(np.percentile(a, 90) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "total_s": float(a.sum()),
        }


class Metrics:
    """Named counters + latency recorders. One instance per harness run.
    Counter updates hold a lock: a += on a dict slot is not atomic."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.latencies: Dict[str, LatencyRecorder] = {}
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def count(self, name: str, delta: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + delta

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self.counters[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one sample into a named distribution."""
        with self._lock:
            rec = self.latencies.setdefault(name, LatencyRecorder())
        rec.record(float(value))

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        with self._lock:
            rec = self.latencies.setdefault(name, LatencyRecorder())
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec.record(time.perf_counter() - t0)

    def rate(self, counter: str, timer: Optional[str] = None) -> float:
        """counter / (timer's total seconds, or wall time since creation)."""
        n = self.counters.get(counter, 0.0)
        if timer is not None:
            total = sum(self.latencies[timer].samples) if timer in self.latencies else 0.0
        else:
            total = time.perf_counter() - self._t0
        return n / total if total > 0 else 0.0

    def snapshot(self) -> Dict[str, Any]:
        """Consistent point-in-time copy of counters and raw samples."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "latencies": {n: list(r.samples) for n, r in self.latencies.items()},
            }

    def merge(self, snap: Dict[str, Any]) -> None:
        """Fold another registry's `snapshot()` into this one: counters
        sum, latency samples concatenate."""
        with self._lock:
            for name, v in snap.get("counters", {}).items():
                self.counters[name] = self.counters.get(name, 0.0) + float(v)
            for name, samples in snap.get("latencies", {}).items():
                rec = self.latencies.setdefault(name, LatencyRecorder())
                rec.samples.extend(float(s) for s in samples)

    def summary(self) -> Dict[str, Any]:
        snap = self.snapshot()
        out: Dict[str, Any] = dict(snap["counters"])
        for name, samples in snap["latencies"].items():
            rec = LatencyRecorder()
            rec.samples = samples
            out[name] = rec.summary()
        return out


# --- profiler hooks ---------------------------------------------------------


@contextlib.contextmanager
def device_trace(name: str) -> Iterator[None]:
    """Annotate a region so that it appears as a named span in profiler
    traces (``torch.profiler.record_function``; next to nothing when no
    trace is being captured)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[None]:
    """Capture a full torch.profiler trace of the enclosed region (the
    host, and the card where there is one), written to `log_dir` in the
    TensorBoard trace format."""
    import torch
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
