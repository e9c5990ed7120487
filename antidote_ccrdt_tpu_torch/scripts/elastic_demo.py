"""Elastic-recovery drill worker (see parallel/elastic.py).

    python -m antidote_ccrdt_tpu_torch.scripts.elastic_demo --root DIR --member w0 --n-members 3
        [--type topk_rmv|average|wordcount] [--die-at N] [--join-late S] [--delta] [--wal-dir DIR]
        [--device cpu|cuda] [--shape demo|main|R,I,B,BR,M,K] [--report FILE] [--hold] [--settle-s S] [--local N]

Port of ``scripts/elastic_demo.py``. N workers gossip a dense CRDT grid
through a shared directory. Each step, each worker applies a
*deterministic* op batch for the replicas it owns under the current alive
set, heartbeats, and periodically publishes/sweeps. A worker started with
--die-at crashes (os._exit) at that step; survivors detect the stale
heartbeat, adopt its replicas, and, because op generation is
deterministic, regenerate the adopted replicas' entire op history.
Duplicated application of steps the victim already published is
harmless: for JOIN engines by idempotence of the join, for MONOID engines
(--type average/wordcount) because the versioned-row lift
(parallel/monoid.py) replaces rows by version instead of adding them.

Options of the port only:

* ``--device`` (default: the card; without one the worker raises) is the
  device of the engine, the state and every op batch.
* ``--shape`` (topk_rmv only) is the drill's width: ``demo`` (default) is
  elastic_demo's own (R = D = 4, 64 ids, K = 8, M = 2, 32 uniform adds
  and 8 removals a replica and step); ``main`` is the main path's (R = D =
  32, 100 000 ids, K = 100, M = 4, 32 768 Zipf(1.2) adds and 2 048
  removals); ``R,I,B,BR,M,K`` is that stream at other sizes.
* ``--report FILE``: this worker's step, publish, sweep and first-apply
  times, adoptions, WAL recovery, kernel launches and peak memory (JSON).
* ``--hold``: the first call of each kernel the engine makes (K1c, K2,
  K3) also runs its plain version; the two must be equal (in the report).
* ``--settle-s``: the final barrier's progress window (10 s, as the JAX
  worker's); it gives up after six windows.
* ``--local N``: the worker's device as N logical devices (default 1),
  JAX's ``--xla_force_host_platform_device_count=N``: with
  ``CCRDT_MESH=1`` (or ``--mesh``) and N > 1 the mesh plane arms over
  them (multichip_demo's phase B runs its workers with ``--local 8``).

The supervising tests (tests/test_torch_elastic_worker.py) launch several
and check every survivor converges to the sequential reference.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time
from typing import NamedTuple

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

# Demo geometry (shared with the test's reference computation).
R, NK, I, DCS, K, M, B, Br = 4, 1, 64, 4, 8, 2, 32, 8
NK_MONOID, V = 2, 32  # monoid drills: 2 keys, 32 wordcount buckets
STEPS = 10


class Geometry(NamedTuple):
    """A topk_rmv drill's width: replicas, keys, ids, DCs, top K, slots an
    id, adds and removals a replica and step, and the id draw (Zipf(1.2)
    folded onto the id space, or uniform as elastic_demo draws)."""

    R: int
    NK: int
    I: int
    DCS: int
    K: int
    M: int
    B: int
    Br: int
    zipf: bool


DEMO = Geometry(R, NK, I, DCS, K, M, B, Br, False)
# The main path's width (bench.py main()), with the op stream of
# chip_smoke.py's gossip phase (GossipOps).
MAIN = Geometry(32, 1, 100_000, 32, 100, 4, 32_768, 2_048, True)


def parse_shape(text: str) -> Geometry:
    """``demo``, ``main`` or ``R,I,B,BR,M,K`` (D = R, Zipf ids, K on top)."""
    if text in ("", "demo"):
        return DEMO
    if text == "main":
        return MAIN
    r, ids, b, br, m, k = (int(x) for x in text.split(","))
    return Geometry(r, 1, ids, r, k, m, b, br, True)


def _host(x):
    import numpy as np

    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


# --- per-type drill adapters ----------------------------------------------


class _TopkRmvDrill:
    """The JOIN flagship: in-place history re-apply on adoption (the join
    dedups duplicated application). JOIN states need no own/gossip split,
    so the view IS the state."""

    name = publish_name = "topk_rmv"

    def __init__(self, device=None, geo: Geometry = DEMO):
        self.device, self.geo, self.R = device, geo, geo.R

    def pub_state(self, dense, state):
        return state

    def set_view(self, dense, state, swept):
        return swept

    def make_engine(self):
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense

        g = self.geo
        return make_dense(n_ids=g.I, n_dcs=g.DCS, size=g.K, slots_per_id=g.M, device=self.device)

    def init(self, dense):
        return dense.init(self.R, self.geo.NK)

    def op_columns(self, step: int, owned):
        """Deterministic [R, ...] op columns for `step` (numpy); replicas
        not in `owned` are padding (add_ts=0 / rmv_id=-1). Any member can
        generate any replica's stream — the durable op source."""
        import numpy as np

        g = self.geo
        cols = dict(
            add_key=np.zeros((g.R, g.B), np.int32), add_id=np.zeros((g.R, g.B), np.int32),
            add_score=np.zeros((g.R, g.B), np.int32), add_dc=np.zeros((g.R, g.B), np.int32),
            add_ts=np.zeros((g.R, g.B), np.int32), rmv_key=np.zeros((g.R, g.Br), np.int32),
            rmv_id=np.full((g.R, g.Br), -1, np.int32), rmv_vc=np.zeros((g.R, g.Br, g.DCS), np.int32),
        )
        for r in sorted(set(owned)):
            rng = np.random.default_rng(10_000 * (step + 1) + r)
            if g.zipf:
                ids = (rng.zipf(1.2, g.B) - 1) % g.I
            else:
                ids = rng.integers(0, g.I, g.B)
            cols["add_id"][r], cols["add_score"][r] = ids, rng.integers(1, 500, g.B)
            cols["add_dc"][r] = r % g.DCS
            cols["add_ts"][r] = step * g.B + np.arange(g.B) + 1  # unique, monotone
            cols["rmv_id"][r] = rng.integers(0, g.I, g.Br)
            cols["rmv_vc"][r, :, r % g.DCS] = rng.integers(1, max(2, step * g.B + 1), g.Br)
        return cols

    def gen_ops(self, step: int, owned):
        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        return convert.from_numpy(TopkRmvOps, self.op_columns(step, owned), self.device)

    def apply(self, dense, state, step: int, owned):
        state, _ = dense.apply_ops(state, self.gen_ops(step, owned), collect_dominated=False)
        return state

    def adopt(self, dense, state, gained, upto_step: int):
        for g in sorted(gained):
            for s in range(upto_step):
                state = self.apply(dense, state, s, [g])
        return state

    def ingest(self, dense, state, effects, step: int, owned):
        """Fold CLIENT effect ops (the write tier) into the lowest owned
        replica row at `step` — one batched apply_ops dispatch, so the fold
        lands inside this step's WAL record and delta window. Effects are
        scalar topk_rmv tuples (`serve.effect_from_wire`): ("add"|"add_r",
        (id, score, (dc, ts))) / ("rmv"|"rmv_r", (id, {dc: ts})). Client ts
        stamps must be distinct from the drill streams' (the demo writers
        use a 1e6+ ts base) — identical (dc, ts) stamps would dedup."""
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps

        g = self.geo
        adds = [p for k, p in effects if k in ("add", "add_r")]
        rmvs = [p for k, p in effects if k in ("rmv", "rmv_r")]
        r = min(owned) if owned else 0
        nb, nr = max(len(adds), 1), max(len(rmvs), 1)
        cols = dict(
            add_key=np.zeros((g.R, nb), np.int32), add_id=np.zeros((g.R, nb), np.int32),
            add_score=np.zeros((g.R, nb), np.int32), add_dc=np.zeros((g.R, nb), np.int32),
            add_ts=np.zeros((g.R, nb), np.int32),  # ts=0 padding elsewhere
            rmv_key=np.zeros((g.R, nr), np.int32), rmv_id=np.full((g.R, nr), -1, np.int32),  # id=-1 padding
            rmv_vc=np.zeros((g.R, nr, g.DCS), np.int32),
        )
        for j, (id_, score, (dc, ts)) in enumerate(adds):
            cols["add_id"][r, j], cols["add_score"][r, j] = int(id_), int(score)
            cols["add_dc"][r, j] = int(dc) % g.DCS
            cols["add_ts"][r, j] = int(ts)
        for j, (id_, vc) in enumerate(rmvs):
            cols["rmv_id"][r, j] = int(id_)
            for d, t in vc.items():
                if 0 <= int(d) < g.DCS:
                    cols["rmv_vc"][r, j, int(d)] = int(t)
        state, _ = dense.apply_ops(state, convert.from_numpy(TopkRmvOps, cols, self.device), collect_dominated=False)
        return state

    def digest(self, dense, state):
        from antidote_ccrdt_tpu_torch.harness.dense_replay import fold_rows

        obs = dense.value(fold_rows(dense, state, range(self.R)))[0][0]
        return sorted((int(i), int(s)) for (i, s) in obs)


class _MonoidDrill:
    """Shared machinery for the MONOID types through the versioned-row
    lift: ops for non-owned rows are padding, versions bump only for owned
    rows. The drill state is a `MonoidContributor` — ops apply to the
    member's own contribution rows (never to swept-in peer copies; see
    parallel/monoid.py for why that would double-count), gossip lands on
    the peers side, publishes/reads use the merged view."""

    R = R

    def __init__(self, device=None):
        self.device = device

    def init(self, lift):
        from antidote_ccrdt_tpu_torch.parallel.monoid import MonoidContributor

        return MonoidContributor(lift, R, NK_MONOID)

    def apply(self, lift, contrib, step: int, owned):
        contrib.apply(self.gen_ops(step, owned), owned=sorted(owned))
        return contrib

    def adopt(self, lift, contrib, gained, upto_step: int):
        # Regenerate the gained rows' history into `own`, where they are
        # still identity/ver-0 — the regenerated version supersedes the
        # victim's published prefix by row-replace.
        for s in range(upto_step):
            contrib.apply(self.gen_ops(s, gained), owned=sorted(gained))
        return contrib

    def pub_state(self, lift, contrib):
        return contrib.view

    def set_view(self, lift, contrib, swept):
        contrib.absorb(swept)
        return contrib


class _AverageDrill(_MonoidDrill):
    name = "average"
    publish_name = "average_lifted"

    def make_engine(self):
        from antidote_ccrdt_tpu_torch.models.average import AverageDense
        from antidote_ccrdt_tpu_torch.parallel.monoid import MonoidLift

        return MonoidLift(AverageDense(device=self.device))

    def gen_ops(self, step: int, owned):
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.average import AverageOps

        cols = {k: np.zeros((R, B), np.int32) for k in ("key", "value", "count")}
        for r in sorted(set(owned)):
            rng = np.random.default_rng(20_000 * (step + 1) + r)
            cols["key"][r] = rng.integers(0, NK_MONOID, B)
            cols["value"][r] = rng.integers(1, 100, B)
            cols["count"][r] = 1  # count==0 is the padding/no-op sentinel
        return convert.from_numpy(AverageOps, cols, self.device)

    def digest(self, lift, contrib):
        tot = lift.total(contrib.view)  # [1, NK_MONOID] sum/num
        return [[int(x) for x in _host(tot.sum)[0]], [int(x) for x in _host(tot.num)[0]]]


class _WordcountDrill(_MonoidDrill):
    name = "wordcount"
    publish_name = "wordcount_lifted"

    def make_engine(self):
        from antidote_ccrdt_tpu_torch.models.wordcount import WordcountDense
        from antidote_ccrdt_tpu_torch.parallel.monoid import MonoidLift

        return MonoidLift(WordcountDense(V, device=self.device))

    def gen_ops(self, step: int, owned):
        import numpy as np

        from antidote_ccrdt_tpu_torch import convert
        from antidote_ccrdt_tpu_torch.models.wordcount import WordcountOps

        key = np.zeros((R, B), np.int32)
        tok = np.full((R, B), -1, np.int32)  # token<0 is padding
        for r in sorted(set(owned)):
            rng = np.random.default_rng(30_000 * (step + 1) + r)
            key[r] = rng.integers(0, NK_MONOID, B)
            tok[r] = rng.integers(0, V, B)
        return convert.from_numpy(WordcountOps, dict(key=key, token=tok), self.device)

    def digest(self, lift, contrib):
        import numpy as np

        tot = lift.total(contrib.view)  # counts [1, NK, V], lost [1, NK]
        counts = _host(tot.counts)[0]
        out = [[k, int(t), int(counts[k, t])] for k in range(NK_MONOID) for t in np.nonzero(counts[k])[0]]
        return out + [["lost", int(_host(tot.lost).sum())]]


def drills(device=None, geo: Geometry = DEMO) -> dict:
    """The three drills with their engines on `device` (None: the card);
    `geo` is the topk_rmv drill's width."""
    return {d.name: d for d in (_TopkRmvDrill(device, geo), _AverageDrill(device), _WordcountDrill(device))}


DRILLS = drills()


# Back-compat shims (tests and docs import these for the flagship drill).
def make_engine():
    return DRILLS["topk_rmv"].make_engine()


def gen_step_ops(step: int, owned):
    return DRILLS["topk_rmv"].gen_ops(step, owned)


def observable_digest(dense, state):
    return DRILLS["topk_rmv"].digest(dense, state)


def reference_digest(type_name: str = "topk_rmv", device=None, geo: Geometry = DEMO, steps: int = STEPS):
    """Sequential single-process ground truth: every step, every replica."""
    drill = drills(device, geo)[type_name]
    dense = drill.make_engine()
    state = drill.init(dense)
    for step in range(steps):
        state = drill.apply(dense, state, step, range(drill.R))
    return drill.digest(dense, state)


# --- the port's instrumentation --------------------------------------------


def _tensors(args):
    """The tensors of `args`, nested tuples and lists walked in order."""
    for a in args:
        if isinstance(a, (tuple, list)):
            yield from _tensors(a)
        elif hasattr(a, "shape"):
            yield a


@contextlib.contextmanager
def hold_first_calls(checks: dict):
    """While open, the first call the topk_rmv engine makes to each of
    K1c, K2 and K3 also runs the kernel's plain version on the same
    arguments; the two must be equal, and `checks` gets each kernel's
    shape and max_abs_err. Later calls go straight to the kernels."""
    import torch

    from antidote_ccrdt_tpu_torch.models import topk_rmv_dense as trd
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place_plain

    saved = {attr: getattr(trd, attr) for attr in ("scatter_max_rows", "delta_place", "sort_slots")}
    plain = {"scatter_max_rows": ("K1c", kernels.scatter_max_rows_copy_plain),
             "delta_place": ("K2", delta_place_plain), "sort_slots": ("K3", kernels.sort_slots_plain)}

    def held(attr):
        name, plain_fn = plain[attr]

        def call(*args, **kw):
            setattr(trd, attr, saved[attr])  # one call held
            got = saved[attr](*args, **kw)
            want = plain_fn(*args, **kw)
            got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0 for g, w in zip(got_t, want_t))
            equal = all(torch.equal(g, w) for g, w in zip(got_t, want_t))
            checks[name] = dict(shapes=[list(a.shape) for a in _tensors(args)], max_abs_err=err, equal=equal)
            if not equal:
                raise AssertionError(f"{name} disagrees with its plain version: {checks[name]}")
            return got
        return call

    try:
        for attr in saved:
            setattr(trd, attr, held(attr))
        yield checks
    finally:
        for attr, fn in saved.items():
            setattr(trd, attr, fn)


class Report:
    """The port's numbers of one worker (``--report``); host clock, the
    device synced around each timed span on a card."""

    def __init__(self, args, device):
        import torch

        self.torch, self.device = torch, device
        self.on_card = device is not None and device.type == "cuda"
        self.active = bool(getattr(args, "report", ""))  # syncs only for a report
        self.doc = dict(member=args.member, pid=os.getpid(), device=str(device), type=args.type,
                        shape=getattr(args, "shape", "demo") or "demo", step_ms=[], publish_ms=[], sweep_ms=[],
                        close_ms=[], barrier_publish_ms=[], barrier_sweep_ms=[], adoptions=[], first_apply_ms=None,
                        held={})
        from antidote_ccrdt_tpu_torch.scripts.multihost_demo import launch_counts

        self.launch_counts = launch_counts
        self.launches0 = launch_counts()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(device)

    def device_sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)

    def sync(self) -> None:
        if self.active:
            self.device_sync()

    @contextlib.contextmanager
    def timed(self, key: str):
        self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.doc[key].append((time.perf_counter() - t0) * 1e3)

    def write(self, path: str, **extra) -> None:
        now = self.launch_counts()
        self.doc.update(extra, launches={n: v - self.launches0[n] for n, v in now.items()},
                        peak_gb=(self.torch.cuda.max_memory_allocated(self.device) / 1e9) if self.on_card else 0.0)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.doc, f)
        os.replace(tmp, path)


def resolve_worker_device(name):
    """`--device` as a torch device: the card by default; without one
    (or asked for "cuda" without one) this raises."""
    import torch

    from antidote_ccrdt_tpu_torch.device import resolve_device

    dev = resolve_device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def add_port_args(ap: argparse.ArgumentParser) -> None:
    """The port's own options, shared with net_gossip_demo.py."""
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card; raises without one)")
    ap.add_argument("--shape", default="demo", help="the topk_rmv drill's width: demo, main or R,I,B,BR,M,K")
    ap.add_argument("--report", default="", help="write this worker's timings and launches here (JSON)")
    ap.add_argument("--hold", action="store_true",
                    help="hold the first K1c, K2 and K3 call against its plain version")
    ap.add_argument("--settle-s", type=float, default=10.0,
                    help="the final barrier's progress window in seconds (six of them at most)")
    ap.add_argument("--local", type=int, default=1,
                    help="logical devices of the worker's device, for the mesh plane (CCRDT_MESH=1 or --mesh "
                    "arms it over more than one); default 1")


def worker_setup(args):
    """(device, geometry) of a worker's arguments, after installing the
    supervisor-injected deterministic faults (CCRDT_FAULTS)."""
    dev = resolve_worker_device(args.device)
    geo = parse_shape(args.shape)
    if geo != DEMO and args.type != "topk_rmv":
        raise SystemExit("--shape is a topk_rmv drill's")
    from antidote_ccrdt_tpu_torch.utils import faults

    faults.install_from_env()
    return dev, geo


@contextlib.contextmanager
def on_device(dev, local: int = 1):
    """The worker's region: on the CPU, entry points called without a
    device run their plain path there (threads started inside included
    as far as they pass the state's device on). With `local` > 1 the
    region's meshes are built over that many logical devices of `dev`
    (``parallel.dist.logical_devices``, JAX's forced host devices). Like
    the CPU region, it is a context variable, which a thread started
    inside does not see: the worker builds its `MeshPlan` once, in this
    thread, and hands the plan to every stage that runs on another."""
    with contextlib.ExitStack() as stack:
        if dev.type == "cpu":
            from antidote_ccrdt_tpu_torch.core.batch_merge import host_device

            stack.enter_context(host_device())
        else:
            import torch

            torch.cuda.set_device(dev)
        if local > 1:
            from antidote_ccrdt_tpu_torch.parallel.dist import logical_devices

            stack.enter_context(logical_devices([dev] * local))
        yield


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--member", required=True)
    ap.add_argument("--n-members", type=int, required=True)
    ap.add_argument("--type", default="topk_rmv", choices=sorted(DRILLS))
    ap.add_argument("--die-at", type=int, default=-1)
    ap.add_argument(
        "--join-late", type=float, default=0.0,
        help="delay registration this many seconds: the member joins an already-running gossip (scale-UP "
        "elasticity); it adopts whatever replicas the ownership map hands it and catches up by full history "
        "re-apply + sweep",
    )
    ap.add_argument("--hb-interval", type=float, default=0.05)
    ap.add_argument("--timeout", type=float, default=0.4)
    ap.add_argument("--step-sleep", type=float, default=0.15)
    ap.add_argument("--publish-every", type=int, default=2)
    ap.add_argument("--delta", action="store_true",
                    help="gossip chained deltas (DeltaPublisher) instead of full snapshots on every publish")
    ap.add_argument(
        "--overlap", dest="overlap", action="store_true", default=None,
        help="overlapped round pipeline (parallel/overlap.py): WAL append, delta encode and gossip send run on a "
        "background host stage, inbound peer deltas are prefetched+pre-decoded into a bounded apply queue, and "
        "queued windows fold in one batched dispatch. Default: on unless CCRDT_OVERLAP=0",
    )
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="force the serial round loop (every phase on the round thread) regardless of CCRDT_OVERLAP")
    ap.add_argument(
        "--lag-anchor-ops", type=float, default=0.0,
        help="lag-driven backpressure (needs --delta): when the lag tracker shows any peer >= this many ops "
        "behind, the publisher cuts full anchors every 2 publishes instead of every 4; 0 disables",
    )
    ap.add_argument(
        "--partitions", type=int, default=0,
        help="arm the partition plane (needs --delta): every full anchor also publishes the P-partition digest "
        "vector + psnaps, delta-chain gaps repair partition-granularly (PartialAntiEntropy), and the divergence "
        "watchdog (obs/audit.py) rides the digest exchanges; 0 disables",
    )
    ap.add_argument(
        "--wal-dir", default="",
        help="enable the crash-consistent write-ahead delta log (harness/wal.py) under this directory: every "
        "applied op batch is appended (CRC-framed, fsynced) BEFORE the publish, and a restart recovers state = "
        "checkpoint ⊔ WAL suffix then resumes at the step after the last durable record",
    )
    ap.add_argument("--wal-segment-bytes", type=int, default=256 << 10)
    ap.add_argument("--steps", type=int, default=0,
                    help="per-worker step count override (0 = the 10-step default; every member of one fleet "
                    "must agree)")
    ap.add_argument(
        "--wal-durability", default="", choices=("", "sync", "group", "async"),
        help="WAL durability mode (harness/wal.py): sync = fsync per append, group = group commit at the publish "
        "boundary (default), async = publish may ship before the fsync (the durable watermark is published and "
        "recovery truncates to it). Empty = CCRDT_WAL_DURABILITY env, else group",
    )
    ap.add_argument(
        "--mesh", action="store_true",
        help="force the device-mesh plane on (mesh/). Default: CCRDT_MESH env; either way needs >1 visible "
        "device and a JOIN engine",
    )
    add_port_args(ap)
    args = ap.parse_args(argv)
    dev, geo = worker_setup(args)

    from antidote_ccrdt_tpu_torch.parallel.elastic import GossipStore

    with on_device(dev, args.local):
        report = Report(args, dev)
        drill = drills(dev, geo)[args.type]
        dense = drill.make_engine()
        state = drill.init(dense)
        if args.join_late > 0:
            # Late join: warm the engine first (apply a no-op batch), THEN
            # register — from the fleet's view the member appears and is
            # immediately productive.
            state = drill.apply(dense, state, 0, [])
            time.sleep(args.join_late)
        store = GossipStore(args.root, args.member)
        run_worker(store, drill, dense, state, args, result_dir=args.root, report=report)


def run_worker(store, drill, dense, state, args, result_dir, report=None):
    """The drill body, transport-agnostic: `store` is any GossipNode
    (shared-directory here; net_gossip_demo.py reuses this loop over TCP).
    Heartbeats in a daemon thread, deterministic op streams for owned
    replicas, ownership-grows adoption, publish/sweep rounds, and a final
    convergence barrier; writes final-<member>.json (digest + alive view +
    metrics counters) into `result_dir`, and with `report` (a `Report`)
    the port's numbers to ``args.report``."""
    # An `--steps` override shadows the module default for this worker
    # (every peer must agree — the final barrier seq is STEPS + dead_n).
    STEPS = int(getattr(args, "steps", 0) or globals()["STEPS"])
    R = drill.R
    from antidote_ccrdt_tpu_torch.obs import events as obs_events
    from antidote_ccrdt_tpu_torch.obs import export as obs_export
    from antidote_ccrdt_tpu_torch.obs.audit import DivergenceWatchdog
    from antidote_ccrdt_tpu_torch.obs.lag import LagTracker
    from antidote_ccrdt_tpu_torch.parallel.elastic import (
        DeltaPublisher,
        PartialAntiEntropy,
        my_replicas,
        owners,
        sweep,
        sweep_deltas,
    )
    from antidote_ccrdt_tpu_torch.parallel.monoid import MonoidLift

    from antidote_ccrdt_tpu_torch.obs import http as obs_http
    from antidote_ccrdt_tpu_torch.obs import profile as obs_profile

    if report is None:
        report = Report(args, None)
    held = contextlib.ExitStack()
    if getattr(args, "hold", False):
        held.enter_context(hold_first_calls(report.doc["held"]))
    # Observability plane (all env-gated, like CCRDT_FAULTS): the flight
    # recorder spills every event to $CCRDT_OBS_DIR as it happens (so a
    # SIGKILL still leaves the full record), a metrics snapshot lands in
    # $CCRDT_METRICS_DIR at clean exit for the supervisor to merge, a live
    # OpenMetrics endpoint serves /metrics when $CCRDT_HTTP_PORT is set,
    # and the hot-path profiler arms on $CCRDT_PROFILE.
    obs_events.install_from_env(args.member)
    obs_export.install_atexit_dump(store.metrics, args.member)
    obs_profile.install_from_env(store.metrics)
    # Device observatory (CCRDT_DEVPROF, default-armed; =0 kills).
    from antidote_ccrdt_tpu_torch.obs import devprof as obs_devprof

    obs_devprof.install_from_env(store.metrics)

    def apply_owned(state, step, owned):
        """The step's op apply, observed as dispatch site "drill.apply":
        the worker's first kernel launches happen here, and a kernel's
        first load is the port's compile event (obs/devprof.py)."""
        if obs_profile.ACTIVE or obs_devprof.ACTIVE:
            with obs_profile.dispatch("drill.apply", fn=getattr(dense, "apply_ops", None)):
                return drill.apply(dense, state, step, owned)
        return drill.apply(dense, state, step, owned)
    # Span plane (CCRDT_SPANS): round-phase spans spill next to the flight
    # log and mirror into metrics as span.* latency series.
    from antidote_ccrdt_tpu_torch.obs import spans as obs_spans

    if obs_spans.ACTIVE:
        # The tcp entrypoint arms the plane before building its transport
        # (hello-exchange clock offsets must be recorded); just attach the
        # metrics mirror it could not have yet.
        obs_spans.set_metrics(store.metrics)
    else:
        obs_spans.install_from_env(args.member, store.metrics)
    # Request-trace plane (CCRDT_RTRACE): per-request hop records + server
    # echoes on the serve/ingest planes below.
    from antidote_ccrdt_tpu_torch.obs import rtrace as obs_rtrace

    obs_rtrace.install_from_env(args.member, metrics=store.metrics)
    lag_tracker = LagTracker(args.member)
    confident_stale = max(1.5 * args.timeout, 0.6)
    # Divergence watchdog (obs/audit.py): always armed — with no partition
    # plane it just exports the OK gauges; with --partitions the partial
    # anti-entropy tier feeds it a per-peer digest-vector observation on
    # every fetch.
    watchdog = DivergenceWatchdog(args.member, metrics=store.metrics)

    pub = None  # set below when --delta
    pae = None  # set below when --delta --partitions
    cursors: dict = {}
    owned_prev: set = set()

    # --- read-serving plane: CCRDT_SERVE=1 attaches a ServePlane — the
    # replica swaps to the merged view at every publish boundary, and the
    # wire surfaces (tcp {query} frame, bridge {query} op, POST /query)
    # answer off it with bounded-staleness pedigrees fed by the lag tracker.
    from antidote_ccrdt_tpu_torch import serve as serve_mod

    plane = serve_mod.install_from_env(dense, args.member, metrics=store.metrics, lag_tracker=lag_tracker)
    # health_extra closes over these cells (the scrape server may call
    # before they are assigned, so the dict — not late locals — carries them)
    ctx = {"ovl": None, "wal": None, "ingest_step": -1, "published_step": -1}

    def _serve_swap(view, seq) -> None:
        if plane is not None:
            plane.swap(view, seq)

    # --- write-ingest plane: CCRDT_INGEST=1 attaches an IngestPlane —
    # client {write} frames park in its queue, the step loop folds them
    # BEFORE wal.log_step captures the post view (so a write's seq IS the
    # step whose WAL record and delta carry it), and tiered acks pin
    # `durable` to the WAL's fsync watermark. Admission control sheds
    # writers on WAL durability lag and overlap-queue depth.
    _ING_MAX_WAL_LAG = int(os.environ.get("CCRDT_INGEST_MAX_WAL_LAG", "64"))
    _ING_MAX_OVL_DEPTH = int(os.environ.get("CCRDT_INGEST_MAX_OVL_DEPTH", "8"))

    def _wal_pressure():
        w = ctx["wal"]
        if w is None:
            return None
        lag = max(0, int(w._last_appended) - int(w.durable_seq))
        if lag > _ING_MAX_WAL_LAG:
            return min(5000, 25 * lag)
        return None

    def _ovl_pressure():
        o = ctx["ovl"]
        if o is None:
            return None
        depth = o.pressure_depth()
        if depth > _ING_MAX_OVL_DEPTH:
            return min(5000, 100 * depth)
        return None

    def _durable_seq() -> int:
        """The WAL's fsync watermark (-1 without a WAL). With the read
        plane on, no further than the last step whose publish swapped the
        read replica: a read sent on a durable ack's heels then finds the
        write (`FleetRouter` never asks a refusing peer again). JAX's
        worker acks at the fsync alone."""
        w = ctx["wal"]
        if w is None:
            return -1
        durable = int(w.durable_seq)
        return min(durable, ctx["published_step"]) if plane is not None else durable

    def _ingest_watermarks() -> dict:
        out = {str(k): int(v) for k, v in cursors.items()}
        out[args.member] = int(ctx["ingest_step"])
        return out

    iplane = (
        serve_mod.install_ingest_from_env(
            args.member,
            metrics=store.metrics,
            durable_fn=_durable_seq,
            watermarks_fn=_ingest_watermarks,
            pressure_fns=(_wal_pressure, _ovl_pressure),
        )
        if hasattr(drill, "ingest")
        else None
    )

    def health_extra() -> dict:
        """Serving-readiness: can a load balancer route reads here?"""
        lag = lag_tracker.report()
        doc = {
            "max_peer_staleness_s": round(max((r["staleness_s"] for r in lag.values()), default=0.0), 6),
            "applied_watermark": max(cursors.values(), default=-1) if cursors else -1,
            "overlap_queue_depth": (len(ctx["ovl"].apq) if ctx["ovl"] is not None else 0),
        }
        w = ctx["wal"]
        if w is not None:
            # Durability readiness: how exposed is this worker right now
            # (async mode: appended-but-unfsynced records a crash would
            # truncate; sync/group: always 0 outside a staged batch).
            doc["wal_durability"] = w.durability
            doc["wal_durable_seq"] = int(w.durable_seq)
            doc["wal_durability_lag"] = int(max(0, w._last_appended - w.durable_seq))
        doc.update(watchdog.health_fields())
        if plane is not None:
            doc.update(plane.health_fields())
        if iplane is not None:
            doc.update(iplane.health_fields())
        doc.update(obs_rtrace.health_fields())
        return doc

    obs_http.install_from_env(
        store.metrics,
        args.member,
        addr_dir=result_dir,
        query_handler=plane.handler_for("http") if plane is not None else None,
        health_extra=health_extra,
        write_handler=(iplane.handler_for("http") if iplane is not None else None),
    )
    tr = getattr(store, "transport", None)
    if plane is not None and tr is not None and hasattr(tr, "install_serve"):
        tr.install_serve(plane)  # TCP fleets also answer {query} frames in-band
    if iplane is not None and tr is not None and hasattr(tr, "install_ingest"):
        tr.install_ingest(iplane)  # ... and {write} frames via the ingest plane

    # --- mesh plane: CCRDT_MESH=1 (or --mesh) pins this worker's state onto
    # a (dc, key) device mesh: partitions map whole onto key shards,
    # intra-slice reconciliation is one batched JOIN all-reduce per publish
    # boundary (mesh/reduce), and the anchor/anti-entropy plumbing goes
    # per-shard. JOIN engines only. With the flag off, on one device, or
    # for MONOID engines this is None and every path below is the
    # mesh-free worker's.
    from antidote_ccrdt_tpu_torch import mesh as mesh_mod

    mplan = mesh_mod.install_from_env(
        dense,
        partitions=int(getattr(args, "partitions", 0) or 0) or None,
        override=(True if getattr(args, "mesh", False) else None),
        metrics=store.metrics,
    )

    def _mesh_tick(st, donate=False):
        """One intra-slice reduce at a publish boundary. Total: an injected
        `mesh.reduce` failure degrades to plain gossip. Donate only on the
        serial path — the overlap host stage may still be serializing
        buffers a submitted WAL task holds."""
        if mplan is None:
            return st
        view = drill.pub_state(dense, st)
        red = mesh_mod.try_ici_reduce(dense, mplan, view, donate=donate, metrics=store.metrics)
        return drill.set_view(dense, st, red) if red is not view else st

    # --- crash-consistent WAL: recover checkpoint ⊔ delta suffix, resume
    # AFTER the last durable step. Peer adoption stays the fallback: with
    # no (or a deleted) WAL this block recovers nothing and the worker
    # rebuilds via the ownership/adopt path below.
    wal = None
    start_step = 0
    wal_dir = getattr(args, "wal_dir", "")
    if wal_dir:
        from antidote_ccrdt_tpu_torch.harness.wal import ElasticWal

        wal = ElasticWal(
            wal_dir, args.member, dense, drill.publish_name,
            segment_bytes=getattr(args, "wal_segment_bytes", 256 << 10),
            metrics=store.metrics,
            partitions=int(getattr(args, "partitions", 0) or 0) or None,
            durability=getattr(args, "wal_durability", "") or None,
            mesh_plan=mplan,
        )
        ctx["wal"] = wal
        from antidote_ccrdt_tpu_torch.parallel.overlap import CommitCoalescer

        coalescer = CommitCoalescer(metrics=store.metrics)
        coalescer.add(wal)
        report.sync()
        t0 = time.perf_counter()
        rec_state, last_step, rec_owned = wal.recover(drill.pub_state(dense, state))
        report.sync()
        report.doc["wal_recover_s"] = time.perf_counter() - t0
        if last_step >= 0 and rec_state is not None:
            state = drill.set_view(dense, state, rec_state)
            start_step = last_step + 1
            store.metrics.set("wal.resume_step", start_step)
            if not isinstance(dense, MonoidLift):
                # JOIN engines: the recovered state already holds these
                # replicas' history, so they are NOT "gained" (no full
                # regeneration — that is the WAL's whole point).
                owned_prev = set(rec_owned)
            # MONOID engines keep owned_prev empty: the recovered view is
            # absorbed as peer rows (set_view), and the adopt path below
            # regenerates the own-side contribution with versions identical
            # to the lost incarnation's — row-replace dedups the overlap.

    if mplan is not None:
        # Pin the (possibly WAL-recovered) state onto the mesh once up
        # front; `ici_reduce` re-pins drifted leaves lazily at each boundary.
        state = drill.set_view(dense, state, mplan.place(drill.pub_state(dense, state)))

    def do_publish(store, seq_hint):
        view = drill.pub_state(dense, state)
        with report.timed("publish_ms"):
            if pub is not None:
                pub.publish(view)  # pub.on_publish swaps the read replica
            else:
                store.publish(drill.publish_name, view, seq_hint)
        if pub is None:
            _serve_swap(view, seq_hint)

    def do_sweep(store, st):
        view = drill.pub_state(dense, st)
        with report.timed("sweep_ms"):
            if pub is not None:
                swept, stats = sweep_deltas(store, dense, view, cursors, partial=pae)
            else:
                swept, stats = sweep(store, dense, view)
        return drill.set_view(dense, st, swept), stats

    def feed_lag() -> None:
        if obs_spans.ACTIVE:
            with obs_spans.span("round.lag_update"):
                _feed_lag()
        else:
            _feed_lag()

    def _feed_lag() -> None:
        """Watermarks from the transport vs what this worker merged. Delta
        mode: published = the peer's highest visible delta/anchor seq,
        applied = sweep_deltas' cursor. Snapshot mode: both sides are the
        snapshot header seq (sweep merges latest-wins whole states)."""
        for m in set(store.delta_members()) | set(store.snapshot_members()):
            if m == args.member:
                continue
            snap = store.snapshot_seq(m)
            seqs = store.delta_seqs(m)
            hi = max(seqs + ([snap] if snap is not None else [-1]))
            if hi >= 0:
                lag_tracker.observe_published(m, hi)
            # Every feed_lag call site directly follows a sweep, so the
            # visible snapshot has just been merged: the applied watermark
            # is the delta cursor OR that snapshot seq, whichever is ahead.
            applied = max(cursors.get(m, -1) if pub is not None else -1, snap if snap is not None else -1)
            if applied >= 0:
                lag_tracker.observe_applied(m, applied)
        # A confidently-dead peer's frozen watermark must not read as
        # ever-growing lag in the exported gauges.
        alive_now = set(store.alive_members(confident_stale))
        for m in list(lag_tracker.report()):
            if m != args.member and m not in alive_now:
                lag_tracker.drop(m)
        lag_tracker.export_to(store.metrics)

    def drop_status(step, owned) -> None:
        """Periodic machine-readable status for the live dashboard:
        obs-<member>.json in the result dir (atomic replace)."""
        snap = store.metrics.snapshot()
        counters = snap["counters"]
        serve_doc = {k[len("serve."):]: v for k, v in counters.items() if k.startswith("serve.")}
        reads = sorted(snap["latencies"].get("serve.read", []))
        if reads:
            serve_doc["read_p99_ms"] = round(reads[int(0.99 * (len(reads) - 1))] * 1e3, 3)
        bounds = sorted(snap["latencies"].get("serve.staleness_bound", []))
        if bounds:
            serve_doc["staleness_p99_s"] = round(bounds[int(0.99 * (len(bounds) - 1))], 6)

        def prefixed(p):
            return {k[len(p):]: v for k, v in counters.items() if k.startswith(p)}

        doc = {
            "member": args.member,
            "zone": getattr(store, "zone", None),
            "t": time.time(),
            "step": step,
            "owned": sorted(int(r) for r in owned),
            "alive": store.alive_members(args.timeout),
            "lag": lag_tracker.report(),
            "sendq": prefixed("net.sendq."),
            "wal_last_seq": counters.get("wal.last_seq"),
            "wal_durable_seq": counters.get("wal.durable_seq"),
            "wal_durability_lag": counters.get("wal.durability_lag"),
            "wal_durability": (ctx["wal"].durability if ctx["wal"] is not None else None),
            "serve": serve_doc,
            "mesh": prefixed("mesh."),
            "audit": watchdog.status_fields(),
            "rtrace": prefixed("rtrace."),
            # Device observatory: trailing-minute recompiles, worst churn
            # site, and the device-memory gauges.
            "devprof": (
                dict(obs_devprof.status_fields(),
                     **{k[len("devprof_"):]: v for k, v in obs_devprof.health_fields().items()})
                if obs_devprof.ACTIVE
                else {}
            ),
        }
        path = os.path.join(result_dir, f"obs-{args.member}.json")
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    if args.delta:
        # Lag-driven backpressure: the drill's pressure signal is this
        # worker's own worst peer lag — when convergence is straining,
        # anchors come sooner so whoever is behind resyncs from a snapshot.
        lag_anchor_ops = float(getattr(args, "lag_anchor_ops", 0) or 0)
        lag_source = None
        if lag_anchor_ops > 0:
            def lag_source():
                return max((r["lag_ops"] for r in lag_tracker.report().values()), default=0)
        P = int(getattr(args, "partitions", 0) or 0)
        pub = DeltaPublisher(
            store, dense, name=drill.publish_name, full_every=4,
            lag_source=lag_source, lag_threshold=lag_anchor_ops,
            partitions=P or None, mesh_plan=mplan,
        )
        pub.on_publish = _serve_swap
        if P:
            # Gap repairs go partition-granular, and every digest fetch
            # feeds the watchdog's per-peer divergence state machine.
            pae = PartialAntiEntropy(store, partitions=P, watchdog=watchdog, mesh_plan=mplan)
        if start_step > 0:
            # Resume the delta-seq lineage PAST anything the lost
            # incarnation published: peers' per-member cursors sit at the
            # old high seq, so a seq restart from 0 would read as
            # already-seen. A fresh incarnation's first publish is a full
            # snapshot (no _prev), which resyncs every peer.
            pub.seq = start_step

    # --- overlapped round pipeline: WAL append, delta encode and gossip
    # send off the round thread (one FIFO host stage preserves
    # durable-before-visible), inbound peer deltas prefetched and
    # pre-decoded into a bounded apply queue, queued windows folded in one
    # batched dispatch. Default ON (CCRDT_OVERLAP=0 or --no-overlap forces
    # the serial loop). Convergence is bit-identical either way.
    from antidote_ccrdt_tpu_torch.parallel import overlap as overlap_mod

    ovl = None
    if overlap_mod.enabled(getattr(args, "overlap", None)):
        ovl = overlap_mod.OverlapPipeline(
            store, dense, drill.pub_state(dense, state),
            post_fold=(
                (lambda s: mesh_mod.try_ici_reduce(dense, mplan, s, donate=False, metrics=store.metrics))
                if mplan is not None
                else None
            ),
        )
        # feed_lag's applied watermarks are now the pipeline's (what
        # drain_into actually folded), not sweep_deltas' cursor dict.
        cursors = ovl.cursors
        ctx["ovl"] = ovl  # healthz readiness reads the live queue depth

    def _overlap_boundary(view, step, owned_snapshot):
        """The publish boundary as ONE host-stage task, FIFO after this
        step's WAL append: a device sync at the boundary only (the round
        thread never waits for readback), then publish, lag/status
        bookkeeping, and the post-publish compaction checkpoint."""
        with store.metrics.timer("net.round"):
            tok = (obs_spans.begin("round.device_sync", step=step, via="overlap") if obs_spans.ACTIVE else None)
            try:
                report.device_sync()
            finally:
                obs_spans.end(tok)
            if wal is not None and wal.durability != "async":
                # Group commit: this boundary task runs FIFO-after every
                # append it covers, so ONE flush here makes the whole batch
                # durable BEFORE the publish below makes any of it visible.
                # Async mode skips it on purpose — the publish may overtake
                # the fsync, and the published wal.durable_seq watermark
                # plus the certifier account for exactly that window.
                coalescer.flush()
            with report.timed("publish_ms"):
                if pub is not None:
                    # defer=True (ingest fast path): delta windows stage
                    # host-side and ship as ONE coalesced range frame when
                    # the coalesce cap fills or an anchor lands.
                    pub.publish(view, defer=True)
                else:
                    store.publish(drill.publish_name, view, step)
            if pub is None:
                _serve_swap(view, step)
            ctx["published_step"] = step
        feed_lag()
        drop_status(step, owned_snapshot)
        if wal is not None:
            # Anchor AFTER the publish: the compaction watermark must
            # never pass what gossip has seen.
            wal.checkpoint(view, step)

    # Background heartbeat: dies with the process, so a crash goes stale.
    def beat():
        while True:
            store.heartbeat()
            time.sleep(args.hb_interval)

    threading.Thread(target=beat, daemon=True).start()

    # Start barrier: wait until the whole initial membership has joined
    # (late joiners skip it — the fleet is already running).
    while args.join_late == 0 and len(store.members()) < args.n_members:
        time.sleep(0.02)

    for step in range(start_step, STEPS):
        if step == args.die_at:
            os._exit(1)  # crash: no cleanup, heartbeat goes stale
        report.sync()
        t_step = time.perf_counter()
        # The attribution denominator: everything the step does except the
        # pacing sleep.
        e2e_tok = obs_spans.begin("round.e2e", step=step) if obs_spans.ACTIVE else None
        pre_view = drill.pub_state(dense, state) if wal is not None else None
        # Ownership only ever GROWS during a run: dropping a replica on a
        # membership change is unsafe under asymmetric views (member A may
        # drop r for new owner B before B has even seen the new map — r's
        # trailing steps would be applied by no one). Keeping it means the
        # old and new owner briefly both apply r's deterministic stream,
        # which dedups: JOIN by idempotence, MONOID because identical
        # streams produce identical (version, content) rows under the lift.
        owned = owned_prev | set(my_replicas(store, R, args.timeout))
        # Adoption: replicas gained since last step get their FULL history
        # regenerated — steps the previous owner already published merge
        # in harmlessly, steps it lost in the crash are recreated from the
        # durable op source.
        gained = owned - owned_prev
        if gained:
            t0 = time.perf_counter()
            state = drill.adopt(dense, state, sorted(gained), step)
            report.sync()
            report.doc["adoptions"].append(dict(t=time.time(), step=step, gained=sorted(gained),
                                                ms=(time.perf_counter() - t0) * 1e3))
        owned_prev = owned
        first = report.doc["first_apply_ms"] is None
        t0 = time.perf_counter()
        if obs_spans.ACTIVE:
            # Honest split of the device side of the round: dispatch =
            # handing the batched op application to the device, sync =
            # waiting for it. The sync point exists only when the span
            # plane is on — the untraced path is untouched.
            with obs_spans.span("round.device_dispatch", step=step, site="drill.apply"):
                state = apply_owned(state, step, sorted(owned))
            with obs_spans.span("round.device_sync", step=step):
                report.device_sync()
        else:
            state = apply_owned(state, step, sorted(owned))
        if first:
            report.sync()
            report.doc["first_apply_ms"] = (time.perf_counter() - t0) * 1e3
        if iplane is not None:
            # Fold parked client writes NOW — after the drill stream, BEFORE
            # wal.log_step captures post_view below — so every write acked
            # at this step is inside the step's WAL record and its next
            # published delta.
            def _fold_ingest(ops, _s=step, _o=tuple(sorted(owned))):
                nonlocal state
                effects = [serve_mod.effect_from_wire(o) for o in ops]
                state = drill.ingest(dense, state, effects, _s, _o)

            iplane.drain(step, _fold_ingest)
            ctx["ingest_step"] = step
        if ovl is not None:
            # Overlapped round: fold whatever peer windows the prefetcher
            # queued (device work — the round thread's only job), then hand
            # every host phase to the pipeline. WAL append is submitted
            # FIRST, so on the FIFO host stage this step's delta is durable
            # before the publish makes it visible.
            view = drill.pub_state(dense, state)
            with report.timed("sweep_ms"):
                swept = ovl.drain_into(view)
            if swept is not view:
                state = drill.set_view(dense, state, swept)
            if wal is not None:
                ovl.submit(wal.log_step, step, sorted(owned), pre_view, drill.pub_state(dense, state))
            if step % args.publish_every == 0:
                # Pre-join the dc blocks BEFORE the boundary ships. No
                # donation — the WAL submit above may still hold these
                # buffers on the host stage.
                state = _mesh_tick(state, donate=False)
                ovl.submit(_overlap_boundary, drill.pub_state(dense, state), step, sorted(owned))
        else:
            if wal is not None:
                # Write-ahead: this step's adopt+apply delta must be
                # durable BEFORE the publish makes it externally visible.
                wal.log_step(step, sorted(owned), pre_view, drill.pub_state(dense, state))
            if step % args.publish_every == 0:
                # Pre-join the dc blocks before publishing. Donation is safe
                # here: log_step above serialized its record synchronously.
                state = _mesh_tick(state, donate=True)
                with store.metrics.timer("net.round"):
                    if wal is not None and wal.durability != "async":
                        coalescer.flush()  # durable before visible
                    do_publish(store, step)
                    ctx["published_step"] = step
                    state, _ = do_sweep(store, state)
                feed_lag()
                drop_status(step, owned)
                if wal is not None:
                    # Anchor AFTER the publish: the compaction watermark
                    # must never pass what gossip has seen.
                    wal.checkpoint(drill.pub_state(dense, state), step)
        obs_spans.end(e2e_tok)
        report.sync()
        report.doc["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        time.sleep(args.step_sleep)

    if ovl is not None:
        # Flush the pipeline before settling: host tasks durable (WAL tail
        # + last publishes), prefetcher stopped, queued windows folded in.
        # The convergence loop below is the ordinary SERIAL path on purpose
        # — it must keep adopting late-detected deaths, and it sweeps full
        # snapshots without needing the pipeline.
        view = drill.pub_state(dense, state)
        with report.timed("close_ms"):
            swept = ovl.close(view)
        if swept is not view:
            state = drill.set_view(dense, state, swept)
        if pub is not None:
            # Ship any wire windows the deferred boundaries left staged (a
            # full anchor landing first would DISCARD them).
            pub.flush_wire()

    # Final convergence: publish/sweep until every member that ever
    # published has either published its FINAL state or is confidently
    # dead. "Final" is STEPS + the number of members THIS worker believes
    # confidently dead, published only AFTER an adopt pass under that
    # belief: a bare seq==STEPS barrier would let a peer sweep a
    # pre-adoption snapshot and exit without the victim's trailing steps.
    # Death is STICKY: a member once confirmed stale-beyond-doubt has had
    # its replicas adopted, so a late heartbeat from it must not resurrect
    # it into the pending set or the exit-time alive report. The deadline
    # extends while the barrier observes progress (pending membership or
    # peer seqs changing); a truly wedged fleet still exits.
    if wal is not None and wal.durability != "async":
        # The trailing steps since the last publish boundary are still
        # staged; commit the batch before anything ships.
        coalescer.flush()
    settle_s = float(getattr(args, "settle_s", 10.0) or 10.0)
    deadline = time.time() + settle_s
    hard_deadline = time.time() + 6 * settle_s
    confirmed_dead: set = set()
    last_progress = None
    t_barrier = time.time()
    while time.time() < min(deadline, hard_deadline):
        # Keep adopting here too: a victim whose death is only DETECTED
        # after the step loop ended would otherwise leave its trailing
        # steps applied by no one.
        owned = owned_prev | set(my_replicas(store, R, args.timeout))
        gained = owned - owned_prev
        if gained:
            t0 = time.perf_counter()
            state = drill.adopt(dense, state, sorted(gained), STEPS)
            report.sync()
            report.doc["adoptions"].append(dict(t=time.time(), step=STEPS, gained=sorted(gained),
                                                ms=(time.perf_counter() - t0) * 1e3))
        owned_prev = owned
        with report.timed("barrier_sweep_ms"):
            swept, _ = sweep(store, dense, drill.pub_state(dense, state))
        state = drill.set_view(dense, state, swept)
        alive_now = set(store.alive_members(confident_stale))
        confirmed_dead |= {m for m in store.members() if m != args.member and m not in alive_now}
        dead_n = len(confirmed_dead)
        for m in confirmed_dead:
            # A dead peer's frozen digest vector must not age into a
            # wedged-divergence alarm; adoption already owns its ops.
            watchdog.drop(m)
        # Adopt under the SAME belief the publish below advertises: the
        # my_replicas pass above and the death confirmation read
        # heartbeats at two moments, and a peer satisfied by STEPS + dead_n
        # must find this worker's post-adoption state under that seq.
        # Over-adoption is idempotent, so the extra pass is free.
        owned = owned_prev | {
            r for r, m in owners(sorted((alive_now | {args.member}) - confirmed_dead), R).items()
            if m == args.member
        }
        gained = owned - owned_prev
        if gained:
            t0 = time.perf_counter()
            state = drill.adopt(dense, state, sorted(gained), STEPS)
            report.sync()
            report.doc["adoptions"].append(dict(t=time.time(), step=STEPS, gained=sorted(gained),
                                                ms=(time.perf_counter() - t0) * 1e3))
        owned_prev = owned
        final_view = drill.pub_state(dense, state)
        with report.timed("barrier_publish_ms"):
            store.publish(drill.publish_name, final_view, STEPS + dead_n)
        _serve_swap(final_view, STEPS + dead_n)
        feed_lag()
        drop_status(STEPS, owned)
        pending = []
        seqs = {}
        # Registered members count even before their first snapshot: a
        # fast worker can reach this barrier while peers are still warming
        # up — with snapshot_members() alone it would exit without
        # sweeping anyone.
        for m in set(store.members()) | set(store.snapshot_members()):
            if m == args.member:
                continue
            seq = store.snapshot_seq(m)  # the 8-byte seq header only
            seqs[m] = seq
            finished = seq is not None and seq >= STEPS + dead_n
            if not finished and m in alive_now and m not in confirmed_dead:
                pending.append(m)
        if not pending:
            break
        progress = (frozenset(pending), tuple(sorted(seqs.items())))
        if progress != last_progress:
            last_progress = progress
            deadline = time.time() + settle_s
        time.sleep(0.1)
    swept, _ = sweep(store, dense, drill.pub_state(dense, state))
    state = drill.set_view(dense, state, swept)
    if wal is not None:
        wal.close()
    held.close()

    out = {
        "member": args.member,
        "zone": getattr(store, "zone", None),
        # Confirmed deaths stay dead in the exit report: replicas were
        # already adopted irreversibly.
        "alive": [m for m in store.alive_members(args.timeout) if m not in confirmed_dead],
        "digest": drill.digest(dense, state),
        "metrics": store.metrics.snapshot()["counters"],
        "lag": lag_tracker.report(),
    }
    with open(os.path.join(result_dir, f"final-{args.member}.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)
    if getattr(args, "report", ""):
        report.write(args.report, t_barrier_start=t_barrier, t_barrier_end=time.time(), start_step=start_step,
                     steps=STEPS, confirmed_dead=sorted(confirmed_dead), digest=out["digest"],
                     wal_recovered_records=out["metrics"].get("wal.recovered_records", 0),
                     wal_resume_step=out["metrics"].get("wal.resume_step"))

    # Env-gated post-drill serve linger: keep the process (and its daemon
    # serve plane) alive after the final barrier so a supervisor can
    # measure the serve path against a QUIESCED worker. The supervisor ends
    # the linger early by dropping <root>/serve-stop; the deadline bounds
    # it if the supervisor dies first.
    try:
        linger_s = float(os.environ.get("CCRDT_SERVE_LINGER_S", "0") or 0.0)
    except ValueError:
        linger_s = 0.0
    if linger_s > 0:
        stop_f = os.path.join(result_dir, "serve-stop")
        deadline = time.time() + linger_s
        while time.time() < deadline and not os.path.exists(stop_f):
            time.sleep(0.1)


if __name__ == "__main__":
    main()
