"""Deterministic, seeded fault injection for the whole op path.

The elastic tier's correctness story is "everything is a join, so any
failure is just a retry" — but the seed repo only ever *simulated*
failures inside `net.sim`. This registry lets the REAL code paths fail:
named injection points are compiled into the production modules
(`net.transport.FsTransport`, `net.tcp._PeerLink`, `bridge.client
.BridgeClient`, `harness.checkpoint`, `harness.wal`) and stay dormant
until a plan is installed. The canonical points:

    transport.publish        FsTransport snapshot write
    transport.publish_delta  FsTransport delta write
    transport.fetch_delta    FsTransport delta read
    tcp.send                 _PeerLink frame send
    bridge.read              BridgeClient reply read
    wal.fsync                WriteAheadLog record fsync
    ckpt.replace             checkpoint/WAL atomic-replace commit
    pager.hydrate            out-of-core partition page-in (core/pager.py)
    router.route             fleet-router per-attempt routing decision
                             (serve/router.py: drop == connection loss,
                             raise == attempt failure, delay == stall)

(Any other dotted name works — the registry is generic; these are the
wired ones.)

Design constraints, in order:

* **Zero cost when disabled.** Call sites guard with the module-level
  ``if faults.ACTIVE:`` bool — one global load on the hot path, no
  function call, no dict lookup. `install` flips it.
* **Deterministic and replayable.** Every point owns a counter of hits
  and an RNG seeded from (plan seed, point name) only — independent of
  wall clock, PIDs, or interleaving of OTHER points. A spec fires at
  explicit hit indices (``at``) and/or with probability ``rate`` drawn
  from that per-point RNG; the decision sequence for a point is a pure
  function of (seed, its own hit ordinal), so a re-run with the same
  seed and the same per-point traffic replays the same schedule. The
  registry records a bounded trace of fired actions for assertions.
* **Crash-shaped actions.** ``raise`` throws OSError (the shape real
  infrastructure failures take: fsync EIO, ECONNRESET, torn NFS);
  ``truncate`` hands the call site a prefix of its payload (a torn
  write/read); ``delay`` sleeps (a stalled disk or peer); ``drop``
  tells the call site to silently skip the operation (a lost frame).

Call-site contract:

    if faults.ACTIVE:
        faults.fire("tcp.send")          # may raise / sleep; "drop" -> skip
    ...
    if faults.ACTIVE:
        blob = faults.mangle("transport.publish", blob)
        if blob is None:                  # dropped
            return

Subprocess drills opt in via the ``CCRDT_FAULTS`` env var (a JSON plan,
see `install_from_env`), so a supervisor can inject the same seeded
schedule into every worker it spawns.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ..obs import events as obs_events

# The one-global-load hot-path gate. True iff a plan is installed.
ACTIVE = False

_ACTIONS = ("raise", "truncate", "delay", "drop")
_TRACE_MAX = 4096

ENV_VAR = "CCRDT_FAULTS"


class InjectedFault(OSError):
    """The OSError subclass injected `raise` actions throw — call sites
    treat it exactly like a real OSError (that is the point), tests can
    still tell it apart from an accidental genuine failure."""


class FaultSpec:
    """One rule at one point.

    action   one of raise | truncate | delay | drop
    at       explicit hit ordinals (0-based) this spec fires on
    rate     probability of firing on any hit (drawn from the point RNG;
             evaluated after `at`); 0 disables the probabilistic path
    max_fires  cap on total fires (None = unbounded)
    delay_s  sleep duration for `delay`
    keep     bytes kept by `truncate`: int >= 0 (prefix length) or a
             float in (0, 1) (fraction of the payload, floor)
    message  text for the injected OSError
    """

    __slots__ = (
        "action", "at", "rate", "max_fires", "delay_s", "keep", "message",
        "fires",
    )

    def __init__(
        self,
        action: str,
        at: Optional[List[int]] = None,
        rate: float = 0.0,
        max_fires: Optional[int] = None,
        delay_s: float = 0.0,
        keep: Any = 0,
        message: str = "injected fault",
    ):
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r} (use {_ACTIONS})")
        self.action = action
        self.at = frozenset(at or ())
        self.rate = float(rate)
        self.max_fires = max_fires
        self.delay_s = float(delay_s)
        self.keep = keep
        self.message = message
        self.fires = 0

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(
            action=d["action"],
            at=list(d.get("at", ())),
            rate=float(d.get("rate", 0.0)),
            max_fires=d.get("max_fires"),
            delay_s=float(d.get("delay_s", 0.0)),
            keep=d.get("keep", 0),
            message=d.get("message", "injected fault"),
        )


class _Point:
    """Per-point state: hit counter, its own RNG, its specs."""

    __slots__ = ("name", "specs", "rng", "hits")

    def __init__(self, name: str, specs: List[FaultSpec], seed: int):
        self.name = name
        self.specs = specs
        # Seed from (plan seed, point name) ONLY: a point's schedule must
        # not depend on how often other points were hit. zlib.crc32 is
        # stable across processes (unlike hash()).
        self.rng = random.Random((seed << 32) ^ zlib.crc32(name.encode()))
        self.hits = 0


class _Registry:
    def __init__(self, plan: Dict[str, List[FaultSpec]], seed: int):
        self.seed = seed
        self.points = {n: _Point(n, specs, seed) for n, specs in plan.items()}
        self.trace: List[Tuple[str, int, str]] = []  # (point, hit, action)
        self.lock = threading.Lock()

    def decide(self, name: str) -> Optional[FaultSpec]:
        """Advance the point's hit counter and pick the firing spec (or
        None). One RNG draw per rate-bearing spec per hit, fired or not —
        the decision sequence is a pure function of the hit ordinal."""
        pt = self.points.get(name)
        if pt is None:
            return None
        with self.lock:
            hit = pt.hits
            pt.hits += 1
            chosen: Optional[FaultSpec] = None
            for spec in pt.specs:
                fires = hit in spec.at
                if spec.rate > 0.0:
                    draw = pt.rng.random()
                    fires = fires or draw < spec.rate
                if fires and (
                    spec.max_fires is None or spec.fires < spec.max_fires
                ):
                    if chosen is None:  # first matching spec wins; later
                        chosen = spec   # rate draws still consumed above
            if chosen is not None:
                chosen.fires += 1
                if len(self.trace) < _TRACE_MAX:
                    self.trace.append((name, hit, chosen.action))
                # Flight-record every firing: seeing *which* injected
                # fault preceded a failure is the whole point of pairing
                # the chaos plan with the obs plane.
                obs_events.emit(
                    "fault.hit", point=name, hit=hit, action=chosen.action
                )
            return chosen


_registry: Optional[_Registry] = None
_install_lock = threading.Lock()


def install(plan: Dict[str, Any], seed: int = 0) -> None:
    """Install a fault plan: {point: [FaultSpec | dict, ...]}. Replaces
    any existing plan. Flips the hot-path gate on."""
    global _registry, ACTIVE
    norm: Dict[str, List[FaultSpec]] = {}
    for name, specs in plan.items():
        norm[name] = [
            s if isinstance(s, FaultSpec) else FaultSpec.from_dict(s)
            for s in specs
        ]
    with _install_lock:
        _registry = _Registry(norm, seed)
        ACTIVE = True


def uninstall() -> None:
    global _registry, ACTIVE
    with _install_lock:
        ACTIVE = False
        _registry = None


class injected:
    """Context manager for tests: install on enter, uninstall on exit."""

    def __init__(self, plan: Dict[str, Any], seed: int = 0):
        self.plan, self.seed = plan, seed

    def __enter__(self):
        install(self.plan, seed=self.seed)
        return self

    def __exit__(self, *exc):
        uninstall()
        return False


def install_from_env(env: Optional[Dict[str, str]] = None) -> bool:
    """Install the plan in ``CCRDT_FAULTS`` (JSON: {"seed": int,
    "points": {point: [spec-dict, ...]}}), if set. Returns whether a
    plan was installed — drills call this once at startup so a
    supervisor controls the whole fleet's schedule."""
    raw = (env if env is not None else os.environ).get(ENV_VAR)
    if not raw:
        return False
    cfg = json.loads(raw)
    install(cfg.get("points", {}), seed=int(cfg.get("seed", 0)))
    return True


def plan_to_env(points: Dict[str, List[Dict[str, Any]]], seed: int = 0) -> str:
    """The env-var payload for `install_from_env` (dict specs only —
    JSON round-trip)."""
    return json.dumps({"seed": seed, "points": points})


# -- call-site surface -----------------------------------------------------


def fire(point: str) -> str:
    """Evaluate `point` for this hit. Returns the action taken: "ok"
    (nothing fired), "drop" (caller must skip the operation), or "delay"
    (the sleep already happened). `raise` actions raise InjectedFault.
    `truncate` at a payload-less site degrades to "ok" — use `mangle`
    where there are bytes to tear."""
    reg = _registry
    if reg is None:
        return "ok"
    spec = reg.decide(point)
    if spec is None:
        return "ok"
    if spec.action == "raise":
        raise InjectedFault(f"{point}: {spec.message}")
    if spec.action == "delay":
        time.sleep(spec.delay_s)
        return "delay"
    if spec.action == "drop":
        return "drop"
    return "ok"  # truncate without a payload


def mangle(point: str, data: bytes) -> Optional[bytes]:
    """Evaluate `point` against a byte payload. Returns the (possibly
    torn) payload, or None when the operation must be dropped entirely.
    raise/delay behave as in `fire`."""
    reg = _registry
    if reg is None:
        return data
    spec = reg.decide(point)
    if spec is None:
        return data
    if spec.action == "raise":
        raise InjectedFault(f"{point}: {spec.message}")
    if spec.action == "delay":
        time.sleep(spec.delay_s)
        return data
    if spec.action == "drop":
        return None
    # truncate
    keep = spec.keep
    if isinstance(keep, float):
        keep = int(len(data) * keep)
    return data[: max(0, int(keep))]


# -- introspection (tests / drills) ----------------------------------------


def trace() -> List[Tuple[str, int, str]]:
    """Bounded log of (point, hit ordinal, action) for every fire so
    far — the replay-determinism assertion surface."""
    reg = _registry
    return list(reg.trace) if reg is not None else []


def hits(point: str) -> int:
    reg = _registry
    if reg is None or point not in reg.points:
        return 0
    return reg.points[point].hits
