"""Hot-path profiler: what the batched dispatch actually costs (port of
``antidote_ccrdt_tpu/obs/profile.py``).

This module wraps the dispatch sites of `core.batch_merge` and the
elastic sweeps and feeds `Metrics` with:

* ``profile.dispatch.<site>`` latency histograms — wall time of each
  dispatch, split into ``profile.compile.<site>`` (the dispatch grew
  its cache: in the port, it loaded a kernel) vs ``profile.execute.
  <site>`` (cache hit);
* ``profile.jit_hits`` / ``profile.jit_misses`` counters — cache-size
  deltas around each dispatch (the JAX package's names, kept so both
  packages scrape alike);
* ``profile.h2d_bytes`` — bytes of the operands handed to a dispatch.

Overhead discipline copies `utils.faults` exactly: a module-level
``ACTIVE`` bool that call sites check FIRST (``if profile.ACTIVE:``), so
the disabled path costs one global load and a branch — no function
call, no context-manager allocation, nothing on the per-merge hot path.
Enable per-process with `install(metrics)` / `installed()` /
`install_from_env` (``CCRDT_PROFILE=1``).

The compile/execute classification lives in `obs/devprof.py`:
`dispatch` delegates to :func:`devprof.observe`, which samples the
cache ONCE and feeds both the ``profile.*`` family and the devprof
compile events. One source of truth, no double counting.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterable, Optional

from ..utils.metrics import Metrics
from . import devprof
from .devprof import _cache_size, _leaf_nbytes  # noqa: F401 — re-exported

ENV_FLAG = "CCRDT_PROFILE"

# Hot-path gate — call sites must check `if profile.ACTIVE:` before
# touching anything else in this module.
ACTIVE = False

_METRICS: Optional[Metrics] = None


def install(metrics: Metrics) -> None:
    """Route profiler samples into `metrics` and flip the gate on."""
    global ACTIVE, _METRICS
    _METRICS = metrics
    ACTIVE = True


def uninstall() -> None:
    global ACTIVE, _METRICS
    ACTIVE = False
    _METRICS = None


@contextlib.contextmanager
def installed(metrics: Metrics):
    """Scoped enable for tests: always restores the previous state."""
    prev = (ACTIVE, _METRICS)
    install(metrics)
    try:
        yield metrics
    finally:
        uninstall()
        if prev[0]:
            install(prev[1])


def install_from_env(
    metrics: Metrics, env: Optional[dict] = None
) -> bool:
    """Enable iff ``CCRDT_PROFILE`` is set to a truthy value ("1",
    "true", ...). Returns whether profiling was armed."""
    raw = (env if env is not None else os.environ).get(ENV_FLAG, "")
    if raw.strip().lower() not in ("1", "true", "yes", "on"):
        return False
    install(metrics)
    return True


# -- the dispatch wrapper ---------------------------------------------------
#
# The cache-introspection helpers (`_cache_size`, `_leaf_nbytes`) moved
# to obs/devprof.py and are re-exported above unchanged.


@contextlib.contextmanager
def dispatch(
    name: str,
    fn: Any = None,
    operands: Iterable[Any] = (),
    donation: str = "",
):
    """Time one dispatch of `name`. Guard the call site with
    ``if profile.ACTIVE or devprof.ACTIVE:`` — this context manager
    assumes at least one plane is on (it silently no-ops if raced with
    `uninstall`).

    Thin delegation to `devprof.observe`: the observatory samples the
    cache once, classifies compile vs execute, and — when profiling
    is installed — emits the legacy ``profile.dispatch.<name>`` /
    ``profile.compile.<name>`` / ``profile.execute.<name>`` histograms,
    ``profile.jit_hits``/``profile.jit_misses`` counters, and
    ``profile.h2d_bytes`` exactly as before."""
    m = _METRICS
    if m is None and not devprof.ACTIVE:
        yield
        return
    with devprof.observe(
        name, fn=fn, operands=operands, donation=donation, profile_metrics=m
    ):
        yield
