"""Device observatory: compile-churn attribution, per-kernel cost
accounting, and device-memory telemetry (port of
``antidote_ccrdt_tpu/obs/devprof.py``).

Every dispatch site of the hot path (`core/batch_merge.py`'s snapshot,
into and fold merges, and the elastic sweeps' delta applies and
snapshot merges) dispatches through :func:`observe`, and each compile
event records

* the **site** (the dispatch call site's stable name),
* the full **abstract signature** that triggered it — per-leaf shapes,
  dtypes (under JAX's names: ``int32``, ``bool``), devices (where the
  JAX package records the sharding), and the donation mode of the slot,
* a structural **DIFF against the site's previous signature** naming
  the axis that changed (``arg0.slot_score axis3 4->8`` is topk_rmv
  capacity growth), ``first_trace`` for a site's first compile and
  ``retrace`` when the signature is unchanged but the cache still grew,
* **compile-vs-execute wall time** and the cache depth after the
  compile,

emitted three ways at once: a typed ``devprof.compile`` flight-recorder
event, per-site OpenMetrics histograms/counters
(``devprof.compile.<site>`` / ``devprof.execute.<site>`` /
``devprof.compiles.<site>``), and `/healthz` fields via
:func:`health_fields`.

The port has no jit cache. Its compile is the first launch of a kernel
in a process, which builds (nvcc) or loads the kernel's library: the
cache a dispatch watches is the kernel build cache (``ops/_build.py``,
:func:`_cache_size`). On the CPU no kernel is loaded, so every dispatch
of an engine reads as an execute.

Device-memory telemetry rides along: ``devprof.live_buffer_bytes``
(+peak high-watermark, ``torch.cuda.memory_allocated()`` sampled only on
compile events; None on a process without a card),
``devprof.retained_bytes.<site>`` (operand bytes seen per site), and
pager occupancy pushed in by :func:`note_pager`.

Overhead discipline copies `obs/profile.py` exactly: ``CCRDT_DEVPROF=0``
is a zero-cost kill switch behind the module-level ``ACTIVE`` bool that
call sites check FIRST; the disabled path costs one global load and a
branch. Unlike ``CCRDT_PROFILE`` (opt-in), the observatory defaults ON
when `install_from_env` runs — set ``CCRDT_DEVPROF=0`` to kill it.
Every record path is additionally guarded by the ``devprof.record``
fault point and a blanket except: an injected or real recording failure
degrades to ``devprof.unobserved`` and NEVER blocks the dispatch.

`obs/profile.py`'s compile/execute split delegates here
(:func:`observe`'s ``profile_metrics`` parameter) so one cache-size
sample is the single source of truth for both counter families.

``CCRDT_DEVPROF_WARMUP=1`` arms the warm-up: `batch_merge` pads
topk_rmv capacities to the next power of two (bit-identity safe —
padding carries the absent-entry sentinels its extraction loops already
skip), so the port's results and dispatch shapes stay the JAX package's.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Deque, Dict, Iterable, List, Optional, Tuple

import torch

from ..utils.metrics import Metrics
from ..utils import faults
from ..utils.tree import flatten_with_path
from ..utils.tree import leaves as tree_leaves
from . import events

ENV_FLAG = "CCRDT_DEVPROF"
ENV_WARMUP = "CCRDT_DEVPROF_WARMUP"

FAULT_RECORD = "devprof.record"

# Hot-path gates — call sites check `if devprof.ACTIVE:` (or
# `profile.ACTIVE or devprof.ACTIVE`) before touching anything else.
ACTIVE = False
# Warm-up arm: batch_merge pads topk_rmv capacities to power-of-two
# buckets and boot code may call prewarm_topk_rmv. Independent of
# ACTIVE — padding changes dispatch shapes (never results), observation
# does not.
WARMUP = False

# Timeline entries kept per site and recent-compile entries kept for
# rtrace window matching. Bounded so a pathological storm cannot grow
# the observatory itself without bound.
_TIMELINE_MAX = 256
_RECENT_MAX = 4096


class _Observatory:
    """One process's device observatory state (metrics + per-site map)."""

    def __init__(self, metrics: Metrics) -> None:
        self.metrics = metrics
        self.lock = threading.Lock()
        # site -> {"sig", "compiles", "dispatches", "retained_bytes",
        #          "timeline": [{"t", "axis", "ms", "depth"}...]}
        self.sites: Dict[str, Dict[str, Any]] = {}
        # (monotonic stamp, site, compile_ms) — rtrace hop-window lookup.
        self.recent: Deque[Tuple[float, str, float]] = collections.deque(
            maxlen=_RECENT_MAX
        )
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self.hbm_used = 0.0
        self.hbm_budget = 0.0
        self.peak_hbm_used = 0.0


_OBS: Optional[_Observatory] = None


def install(metrics: Metrics) -> None:
    """Route observatory records into `metrics` and flip the gate on."""
    global ACTIVE, _OBS
    _OBS = _Observatory(metrics)
    ACTIVE = True


def uninstall() -> None:
    global ACTIVE, _OBS
    ACTIVE = False
    _OBS = None


def set_warmup(flag: bool) -> None:
    global WARMUP
    WARMUP = bool(flag)


def _restore(prev) -> None:
    global ACTIVE, _OBS, WARMUP
    ACTIVE, _OBS, WARMUP = prev


@contextlib.contextmanager
def installed(metrics: Metrics):
    """Scoped enable for tests: always restores the previous state."""
    prev = (ACTIVE, _OBS, WARMUP)
    install(metrics)
    try:
        yield metrics
    finally:
        _restore(prev)


def _killed(raw: Optional[str]) -> bool:
    return (raw or "").strip().lower() in ("0", "false", "off", "no")


def install_from_env(
    metrics: Metrics, env: Optional[dict] = None
) -> bool:
    """Default-armed kill-switch semantics (the opposite polarity of
    ``CCRDT_PROFILE``): the observatory installs unless
    ``CCRDT_DEVPROF`` is explicitly "0"/"false"/"off". Also arms the
    warm-up bucket padding when ``CCRDT_DEVPROF_WARMUP`` is truthy.
    Returns whether the observatory was armed."""
    e = env if env is not None else os.environ
    set_warmup(
        e.get(ENV_WARMUP, "").strip().lower() in ("1", "true", "yes", "on")
    )
    if _killed(e.get(ENV_FLAG)):
        return False
    install(metrics)
    return True


# -- introspection helpers (shared with obs/profile.py) ---------------------


def _cache_size(fn: Any) -> Optional[int]:
    """Size of the cache a dispatch of `fn` may grow, or None when it
    has none. A callable exposing ``_cache_size()`` reports its own; a
    method of an engine (an object with a torch ``device``) reports the
    kernel build cache — the kernel entry points loaded in this process
    (``ops._build.loaded()``), which its first launch of a kernel grows;
    plain functions and partials report None. Defensive on purpose:
    observation must never break a dispatch."""
    try:
        sizer = getattr(fn, "_cache_size", None)
        if sizer is not None:
            return int(sizer())
        if isinstance(getattr(getattr(fn, "__self__", None), "device", None), torch.device):
            from ..ops import _build

            return _build.loaded()
    except Exception:  # noqa: BLE001 — any introspection failure = unknown
        return None
    return None


def _leaf_nbytes(operands: Iterable[Any]) -> int:
    """Total .nbytes across array leaves of `operands` (tensors and
    numpy arrays in the port's state structures, ``utils.tree``)."""
    try:
        leaves = tree_leaves(list(operands))
    except Exception:  # noqa: BLE001 — must never break a dispatch
        leaves = []
    total = 0
    for x in leaves:
        nb = getattr(x, "nbytes", None)
        if isinstance(nb, int):
            total += nb
    return total


def pad_dim(n: int) -> int:
    """Next power of two >= n (min 1): the warm-up capacity bucket."""
    n = max(int(n), 1)
    p = 1
    while p < n:
        p <<= 1
    return p


# -- abstract signatures and structural diffs -------------------------------


def _describe(x: Any) -> Tuple[Tuple[int, ...], str, str]:
    """(shape, dtype under JAX's name, placement): a tensor's placement
    is its device, where a JAX array's is its sharding."""
    shape = tuple(int(d) for d in (getattr(x, "shape", ()) or ()))
    dtype = str(getattr(x, "dtype", type(x).__name__))
    if isinstance(x, torch.Tensor):
        dtype = dtype.removeprefix("torch.")
        return shape, dtype, str(x.device)
    sh = getattr(x, "sharding", None)
    return shape, dtype, (str(sh) if sh is not None else "")


def signature(operands: Iterable[Any], donation: str = "") -> Dict[str, Any]:
    """The abstract signature of a dispatch: per-leaf (name, shape,
    dtype, placement) across the operand structures, plus the slot's
    donation mode. Leaf names are JAX's pytree paths
    (``arg0.slot_score``, ``utils.tree``), so a diff can name the exact
    field whose axis grew."""
    leaves: List[Tuple[str, Tuple[int, ...], str, str]] = []
    try:
        for i, op in enumerate(operands):
            for path, leaf in flatten_with_path(op):
                leaves.append((f"arg{i}{path}", *_describe(leaf)))
    except Exception:  # noqa: BLE001 — degrade to opaque per-operand leaves
        for i, op in enumerate(operands):
            leaves.append((f"arg{i}", *_describe(op)))
    return {"leaves": tuple(leaves), "donation": donation}


def signature_diff(
    prev: Optional[Dict[str, Any]], cur: Dict[str, Any]
) -> List[str]:
    """Structural diff of two signatures as human-readable change
    strings, most significant first. ``["first_trace"]`` when the site
    had no previous signature; ``["retrace"]`` when nothing structural
    changed but the cache still grew (e.g. a kernel first launched by
    a call of a shape seen before)."""
    if prev is None:
        return ["first_trace"]
    changed: List[str] = []
    pd = {l[0]: l[1:] for l in prev["leaves"]}
    cd = {l[0]: l[1:] for l in cur["leaves"]}
    for name, (shape, dtype, shard) in cd.items():
        old = pd.get(name)
        if old is None:
            changed.append(f"+{name} {list(shape)}")
            continue
        oshape, odtype, oshard = old
        if oshape != shape:
            if len(oshape) == len(shape):
                for ax, (a, b) in enumerate(zip(oshape, shape)):
                    if a != b:
                        changed.append(f"{name} axis{ax} {a}->{b}")
            else:
                changed.append(f"{name} rank {len(oshape)}->{len(shape)}")
        if odtype != dtype:
            changed.append(f"{name} dtype {odtype}->{dtype}")
        if oshard != shard:
            changed.append(f"{name} sharding {oshard or '-'}->{shard or '-'}")
    for name in pd:
        if name not in cd:
            changed.append(f"-{name}")
    if prev.get("donation", "") != cur.get("donation", ""):
        changed.append(
            f"donation {prev.get('donation', '') or '-'}"
            f"->{cur.get('donation', '') or '-'}"
        )
    return changed or ["retrace"]


# -- the dispatch observer --------------------------------------------------


@contextlib.contextmanager
def observe(
    site: str,
    fn: Any = None,
    operands: Iterable[Any] = (),
    donation: str = "",
    profile_metrics: Optional[Metrics] = None,
):
    """Observe one dispatch at `site`. Guard the call site with
    ``if devprof.ACTIVE:`` (or ``profile.ACTIVE or devprof.ACTIVE``
    when going through `profile.dispatch`).

    With `fn` (the callable actually dispatched), its cache size
    (:func:`_cache_size`) is sampled before/after to classify compile (cache grew) vs
    execute — ONE sample pair serving both the devprof record and, when
    `profile_metrics` is given, the legacy ``profile.*`` counter family
    (obs/profile.py delegates here; no double bookkeeping)."""
    obs = _OBS if ACTIVE else None
    if obs is None and profile_metrics is None:
        yield
        return
    before = _cache_size(fn) if fn is not None else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        compiled: Optional[bool] = None
        depth: Optional[int] = None
        if before is not None:
            depth = _cache_size(fn)
            if depth is not None:
                compiled = depth > before
        if profile_metrics is not None:
            _profile_record(
                profile_metrics, site, dt, before, compiled, operands
            )
        if obs is not None:
            try:
                if faults.ACTIVE and faults.fire(FAULT_RECORD) == "drop":
                    obs.metrics.count("devprof.unobserved")
                else:
                    _record(obs, site, dt, compiled, depth, operands, donation)
            except Exception:  # noqa: BLE001 — degrade to unobserved,
                try:  # never block the dispatch
                    obs.metrics.count("devprof.unobserved")
                except Exception:  # noqa: BLE001
                    pass


def _lat(m: Metrics, name: str, dt: float) -> None:
    # observe(), not merge(): this sits on the execute hot path, where
    # the dict-and-generator cost of a one-sample merge is measurable.
    m.observe(name, dt)


def _profile_record(
    m: Metrics,
    name: str,
    dt: float,
    before: Optional[int],
    compiled: Optional[bool],
    operands: Iterable[Any],
) -> None:
    """The legacy ``profile.*`` family, emitted from the same cache-size
    sample devprof classified with — names and semantics unchanged from
    the pre-devprof obs/profile.py (the parity test pins this)."""
    _lat(m, f"profile.dispatch.{name}", dt)
    if before is not None:
        if compiled:
            m.count("profile.jit_misses")
            _lat(m, f"profile.compile.{name}", dt)
        else:
            m.count("profile.jit_hits")
            _lat(m, f"profile.execute.{name}", dt)
    nbytes = _leaf_nbytes(operands)
    if nbytes:
        m.count("profile.h2d_bytes", nbytes)


def _live_buffer_bytes() -> Optional[float]:
    """Bytes the caching allocator holds in tensors on the current card,
    or None in a process that has not initialised one."""
    try:
        if not torch.cuda.is_initialized():
            return None
        return float(torch.cuda.memory_allocated())
    except Exception:  # noqa: BLE001 — telemetry only
        return None


def _record(
    obs: _Observatory,
    site: str,
    dt: float,
    compiled: Optional[bool],
    depth: Optional[int],
    operands: Iterable[Any],
    donation: str,
) -> None:
    m = obs.metrics
    ms = dt * 1e3
    m.count("devprof.dispatches")
    if not compiled:
        # Execute path (or no cache introspection): one histogram sample,
        # nothing else — this is the ≤2% overhead budget's hot case.
        _lat(m, f"devprof.execute.{site}", dt)
        with obs.lock:
            st = obs.sites.get(site)
            if st is not None:
                st["dispatches"] += 1
        return
    # Compile path: capture the signature that triggered it (operands are
    # still live), diff against the site's previous one, and emit on all
    # three surfaces. Compiles are rare, so the pytree walk and the
    # live-buffer sweep are off the steady-state hot path.
    sig = signature(operands, donation)
    nbytes = _leaf_nbytes(operands)
    now_mono = time.monotonic()
    with obs.lock:
        st = obs.sites.get(site)
        if st is None:
            st = obs.sites[site] = {
                "sig": None,
                "compiles": 0,
                "dispatches": 0,
                "retained_bytes": 0,
                "timeline": [],
            }
        changed = signature_diff(st["sig"], sig)
        axis = changed[0]
        st["sig"] = sig
        st["compiles"] += 1
        st["dispatches"] += 1
        st["retained_bytes"] += nbytes
        tl = st["timeline"]
        tl.append(
            {"t": round(time.time(), 6), "axis": axis,
             "ms": round(ms, 3), "depth": depth}
        )
        if len(tl) > _TIMELINE_MAX:
            del tl[: len(tl) - _TIMELINE_MAX]
        retained = st["retained_bytes"]
        obs.recent.append((now_mono, site, ms))
        live = _live_buffer_bytes()
        if live is not None:
            obs.live_bytes = live
            if live > obs.peak_live_bytes:
                obs.peak_live_bytes = live
        peak_live = obs.peak_live_bytes
    m.count("devprof.compiles")
    m.count(f"devprof.compiles.{site}")
    _lat(m, f"devprof.compile.{site}", dt)
    if depth is not None:
        m.set(f"devprof.cache_depth.{site}", float(depth))
    m.set(f"devprof.retained_bytes.{site}", float(retained))
    if live is not None:
        m.set("devprof.live_buffer_bytes", float(live))
        m.set("devprof.live_buffer_peak_bytes", float(peak_live))
    events.emit(
        "devprof.compile",
        site=site,
        ms=round(ms, 3),
        axis=axis,
        changed=changed[:8],
        cache_depth=depth,
        mono=round(now_mono, 6),
        signature=[
            [name, list(shape), dtype, shard]
            for name, shape, dtype, shard in sig["leaves"]
        ],
        donation=donation,
    )


# -- device-memory telemetry ------------------------------------------------


def note_pager(resident_bytes: int, budget: int) -> None:
    """Pager HBM occupancy push (core/pager.py gauge export): resident
    device bytes vs ``CCRDT_PAGER_HBM_BUDGET``, with a high-watermark."""
    obs = _OBS
    if obs is None:
        return
    try:
        used = float(resident_bytes)
        cap = float(budget or 0)
        with obs.lock:
            obs.hbm_used = used
            obs.hbm_budget = cap
            if used > obs.peak_hbm_used:
                obs.peak_hbm_used = used
            peak = obs.peak_hbm_used
        m = obs.metrics
        m.set("devprof.hbm_used_bytes", used)
        m.set("devprof.hbm_budget_bytes", cap)
        m.set("devprof.hbm_occupancy", round(used / cap, 6) if cap else 0.0)
        m.set("devprof.hbm_peak_bytes", peak)
    except Exception:  # noqa: BLE001 — telemetry must never break paging
        pass


# -- rtrace integration -----------------------------------------------------


def compile_ms_in_window(t0: float, t1: float) -> float:
    """Total compile milliseconds whose monotonic stamp landed inside
    [t0, t1] — the rtrace hop window. The serve/ingest echo sites attach
    this as the ``compile_ms`` extra so tail attribution can split
    compile-storm latency out of the ``kernel`` bucket."""
    obs = _OBS
    if obs is None:
        return 0.0
    total = 0.0
    with obs.lock:
        for mono, _site, ms in obs.recent:
            if t0 <= mono <= t1:
                total += ms
    return round(total, 3)


# -- reporting surfaces -----------------------------------------------------


def _totals(obs: _Observatory) -> Tuple[int, int, str, int]:
    compiles = dispatches = 0
    worst, worst_n = "", 0
    for site, st in obs.sites.items():
        compiles += st["compiles"]
        dispatches += st["dispatches"]
        if st["compiles"] > worst_n:
            worst, worst_n = site, st["compiles"]
    return compiles, dispatches, worst, worst_n


def health_fields() -> Dict[str, Any]:
    """`/healthz` block: compile totals, worst churn site, and the
    device-memory gauges (live buffers, HBM occupancy, watermarks)."""
    obs = _OBS
    if obs is None:
        return {}
    with obs.lock:
        compiles, dispatches, worst, worst_n = _totals(obs)
        out = {
            "devprof_compiles": compiles,
            "devprof_dispatches": dispatches,
            "devprof_worst_site": worst,
            "devprof_worst_site_compiles": worst_n,
            "devprof_live_buffer_bytes": int(obs.live_bytes),
            "devprof_live_buffer_peak_bytes": int(obs.peak_live_bytes),
            "devprof_hbm_used_bytes": int(obs.hbm_used),
            "devprof_hbm_budget_bytes": int(obs.hbm_budget),
            "devprof_hbm_peak_bytes": int(obs.peak_hbm_used),
            "devprof_hbm_occupancy": (
                round(obs.hbm_used / obs.hbm_budget, 4)
                if obs.hbm_budget
                else 0.0
            ),
        }
    return out


def status_fields() -> Dict[str, Any]:
    """Dashboard block (obs-<member>.json "devprof"): recompiles/min
    over the trailing minute, worst site, HBM occupancy."""
    obs = _OBS
    if obs is None:
        return {}
    cutoff = time.monotonic() - 60.0
    with obs.lock:
        compiles, _disp, worst, worst_n = _totals(obs)
        per_min = sum(1 for mono, _s, _ms in obs.recent if mono >= cutoff)
        occ = (
            round(obs.hbm_used / obs.hbm_budget, 4) if obs.hbm_budget else 0.0
        )
    return {
        "compiles": compiles,
        "recompiles_per_min": per_min,
        "worst_site": worst,
        "worst_site_compiles": worst_n,
        "hbm_occupancy": occ,
    }


def sites_report() -> Dict[str, Dict[str, Any]]:
    """Per-site snapshot for tests/CLI: compiles, dispatches, retained
    bytes, latest axis, bounded timeline."""
    obs = _OBS
    if obs is None:
        return {}
    out: Dict[str, Dict[str, Any]] = {}
    with obs.lock:
        for site, st in obs.sites.items():
            tl = list(st["timeline"])
            out[site] = {
                "compiles": st["compiles"],
                "dispatches": st["dispatches"],
                "retained_bytes": st["retained_bytes"],
                "last_axis": tl[-1]["axis"] if tl else "",
                "timeline": tl,
            }
    return out
