"""Multi-process convergence demo/check: one OS process per simulated host.

    python -m antidote_ccrdt_tpu_torch.scripts.multihost_demo <process_id> <num_processes> <port>
        [--device cpu|cuda] [--backend gloo|nccl] [--local N] [--n-key N]
        [--shape small|I,B,BR,M,K] [--ckpt DIR] [--report FILE]

Port of ``scripts/multihost_demo.py``: run one per process, all with the
same port on localhost (rank 0 listens there). Each process owns
``--local`` logical devices of its device (default 4); with ``--n-key``
n they form a (dc, key) = (local / n, n) grid, one replica a dc. Every replica applies a DIFFERENT deterministic op batch
(seeded by global replica id, so any process can rebuild the whole
workload for the reference check), then `hierarchical_reconcile` joins
all replicas — inside each process, then across processes over
``torch.distributed``. Each process asserts its rows' observables equal a
single-process reference that applied and merged everything, checks that
every process holds the same rows, and prints ``MULTIHOST-OK <pid>``.

* ``--shape small`` is ``tests/test_multihost.py``'s workload (256 ids, 8
  DCs, K = 8, M = 2, 64 adds and 4 removals a replica, `replica_ops`);
  with ``--n-key`` n > 1 the state holds n instances and the ops go round
  them; ``I,B,BR,M,K`` is one round of the main path's stream at those
  sizes (I ids, D = R, M slots, top K, B Zipf(1.2) adds and BR removals a
  replica, seed 7; the main path's own is ``100000,32768,2048,4,100``).
  Every process builds the whole round and keeps its rows.
* ``--device`` defaults to the card (the worker raises without one);
  ``cpu`` is JAX's CI rig (``gloo``). ``--backend`` is ``gloo`` or
  ``nccl`` (one rank per card).
* ``--ckpt DIR``: the world saves the reconciled global state there as
  step 0, each process its block (``harness.orbax_ckpt``).
* ``--report FILE``: this process's timings, bytes, peak memory and
  kernel launches as JSON; with ``--shape small`` also its reconciled
  block's leaves in ``FILE.npz``.

`run_world` starts a world of these workers (as the tests and
chip_smoke.py do).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Sequence, Tuple, Union

MODULE = "antidote_ccrdt_tpu_torch.scripts.multihost_demo"
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_DEVICES = 4
I, DCS, K, M, B = 256, 8, 8, 2, 64
# The main path's stream (bench.py main()): Zipf(1.2) ids, scores below
# 100 000, seed 7; ``--shape I,B,BR,M,K`` sets its sizes.
STREAM_ZIPF, STREAM_SCORE_MAX, STREAM_SEED = 1.2, 100_000, 7


def replica_ops(r: int, n_dcs: int, n_keys: int = 1):
    """Deterministic per-replica op batch (any process can rebuild all);
    ops go round the `n_keys` instances (all to instance 0 with one)."""
    import numpy as np

    rng = np.random.default_rng(1000 + r)
    return dict(
        add_key=(np.arange(B, dtype=np.int32) % n_keys).reshape(1, B),
        add_id=rng.integers(0, I, (1, B)).astype(np.int32),
        add_score=rng.integers(1, 10_000, (1, B)).astype(np.int32),
        add_dc=np.full((1, B), r % n_dcs, np.int32),
        add_ts=np.arange(1, B + 1, dtype=np.int32).reshape(1, B),
        rmv_key=(np.arange(4, dtype=np.int32) % n_keys).reshape(1, 4),
        rmv_id=rng.integers(0, I, (1, 4)).astype(np.int32),
        rmv_vc=rng.integers(0, B // 2, (1, 4, DCS)).astype(np.int32),
    )


def launch_counts() -> dict:
    """The launch counters of the kernels the demo's path drives."""
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.delta_place import delta_place

    return {"scatter_max_rows_copy": kernels.scatter_max_rows_copy.launches, "delta_place": delta_place.launches,
            "sort_slots": kernels.sort_slots.launches}


def workload(shape: str, R: int, device, n_keys: int = 1):
    """(engine, all R replicas' ops over `n_keys` instances, geometry) of
    `shape` (``I,B,BR,M,K`` has one instance)."""
    import numpy as np

    from antidote_ccrdt_tpu_torch import convert
    from antidote_ccrdt_tpu_torch.harness.opgen import TopkRmvEffectGen, Workload
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps, make_dense

    if shape == "small":
        dense = make_dense(n_ids=I, n_dcs=DCS, size=K, slots_per_id=M, device=device)
        every = [replica_ops(r, DCS, n_keys) for r in range(R)]
        cols = {k: np.concatenate([o[k] for o in every], axis=0) for k in every[0]}
        return dense, convert.from_numpy(TopkRmvOps, cols, device), dict(I=I, D=DCS, K=K, M=M, B=B, Br=4, NK=n_keys)
    ids, b, br, m, k = (int(x) for x in shape.split(","))
    dense = make_dense(n_ids=ids, n_dcs=R, size=k, slots_per_id=m, device=device)
    gen = TopkRmvEffectGen(Workload(R, ids, zipf_a=STREAM_ZIPF, score_max=STREAM_SCORE_MAX, seed=STREAM_SEED),
                           device=device)
    return dense, gen.next_batch(b, br), dict(I=ids, D=R, K=k, M=m, B=b, Br=br, NK=1)


def main(argv: Sequence[str] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pid", type=int)
    ap.add_argument("nproc", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    ap.add_argument("--backend", default=None, help="gloo or nccl (default: nccl on a card, gloo on the CPU)")
    ap.add_argument("--local", type=int, default=LOCAL_DEVICES, help="logical devices (replicas) a process")
    ap.add_argument("--n-key", type=int, default=1, help="the key axis of the mesh")
    ap.add_argument("--shape", default="small", help="small or I,B,BR,M,K")
    ap.add_argument("--ckpt", default=None, help="save the reconciled state here")
    ap.add_argument("--report", default=None, help="write timings and launches here (JSON)")
    args = ap.parse_args(argv)
    pid, nproc = args.pid, args.nproc

    import numpy as np
    import torch

    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import TopkRmvOps
    from antidote_ccrdt_tpu_torch.parallel import multihost as mh
    from antidote_ccrdt_tpu_torch.utils.tree import flatten_with_path, tree_map

    addr = f"localhost:{args.port}"
    if args.device == "cpu":
        mh.initialize(addr, nproc, pid, cpu_devices_per_process=args.local, backend=args.backend)
    else:
        mh.initialize(addr, nproc, pid, backend=args.backend, device=args.device, local_devices=args.local)
    try:
        mesh = mh.global_replica_mesh(args.n_key)
        dev = mesh.device
        on_card = dev.type == "cuda"

        def now() -> float:
            if on_card:
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        assert mesh.shape == {"dcn": nproc, "dc": args.local // args.n_key, "key": args.n_key}, mesh.shape
        n_local = mesh.shape["dc"]  # replicas a process: one a (dc, key) column
        R = nproc * n_local
        D, all_ops, geo = workload(args.shape, R, dev, args.n_key if args.shape == "small" else 1)
        nk = geo["NK"]
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        mem_base = torch.cuda.memory_allocated(dev) if on_card else 0

        state = mh.init_global_state(lambda: D.init(n_replicas=R, n_keys=nk), mesh)
        lo, hi = pid * n_local, (pid + 1) * n_local
        mine = {f: getattr(all_ops, f)[lo:hi] for f in TopkRmvOps.__dataclass_fields__}
        ops = TopkRmvOps(**mh.ops_from_process_local(mine, mesh))

        before = launch_counts()
        t0 = now()
        state = D.apply_ops(state, ops, collect_dominated=False)[0]
        apply_ms = (now() - t0) * 1e3
        stats: dict = {}
        state = mh.hierarchical_reconcile(state, D.merge, mesh, stats=stats)
        launches = {n: v - before[n] for n, v in launch_counts().items()}
        peak_gb = (torch.cuda.max_memory_allocated(dev) - mem_base) / 1e9 if on_card else 0.0

        save_s = save_bytes = None
        if args.ckpt:
            from antidote_ccrdt_tpu_torch.harness.orbax_ckpt import DenseCheckpointManager, dir_bytes

            t0 = time.perf_counter()
            with DenseCheckpointManager(args.ckpt) as mgr:
                mgr.save(0, state)
            save_s = time.perf_counter() - t0
            save_bytes = dir_bytes(os.path.join(args.ckpt, "0"))

        # Single-process reference: apply every replica's ops, fold all merges.
        obs_mine = D.observe(state)
        ref_state = D.apply_ops(D.init(n_replicas=R, n_keys=nk), all_ops, collect_dominated=False)[0]
        folded = tree_map(lambda a: a[:1], ref_state)
        for r in range(1, R):
            folded = D.merge(folded, tree_map(lambda a, r=r: a[r:r + 1], ref_state))
        obs_ref = D.observe(folded)
        v = obs_ref.valid[0]
        for r in range(n_local):
            assert torch.equal(obs_mine.valid[r], v)
            assert torch.equal(obs_mine.ids[r][v], obs_ref.ids[0][v])
            assert torch.equal(obs_mine.scores[r][v], obs_ref.scores[0][v])
        # Every process holds the same rows (a collective over the world's
        # own backend, device tensors under nccl).
        buf, _layout = mh._pack(state)
        assert all(torch.equal(b, buf) for b in mh._gather(buf, nproc, mesh.backend))

        if args.report:
            report = dict(pid=pid, nproc=nproc, device=str(dev), backend=mesh.backend, local=args.local,
                          n_key=args.n_key, shape=args.shape, geometry=geo, apply_ms=apply_ms, **stats,
                          save_s=save_s, save_bytes=save_bytes, peak_gb=peak_gb, launches=launches,
                          block_rows=[lo, hi], valid_observed=int(v.sum()))
            with open(args.report, "w") as f:
                json.dump(report, f)
            if args.shape == "small":
                np.savez(args.report + ".npz", **{p: a for p, a in flatten_with_path(mh.process_local_shards(state))})
    finally:
        mh.shutdown()
    print(f"MULTIHOST-OK {pid}", flush=True)


# --- starting a world ----------------------------------------------------------


EPHEMERAL_RANGE = "/proc/sys/net/ipv4/ip_local_port_range"


def free_port() -> int:
    """A port nothing on this host holds. Where the kernel names its range
    of ephemeral ports (Linux), one below it: an outgoing connection of
    another process takes its local port from that range, and could take
    one picked inside it in the seconds before rank 0 binds it. Elsewhere,
    one the system picks."""
    try:
        with open(EPHEMERAL_RANGE) as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 0
    pick = random.SystemRandom()  # independent of any seeded `random`
    for _ in range(64 if low > 10_000 else 0):
        port = pick.randrange(10_000, low)
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _address_taken(out: str) -> bool:
    low = out.lower()
    return "eaddrinuse" in low or "address already in use" in low


def _start(nproc: int, args, timeout_s: float, env: dict) -> List[Tuple[int, str]]:
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"w{pid}.log"), "w+") for pid in range(nproc)]
        procs = []
        try:
            for pid in range(nproc):
                extra = args(pid) if callable(args) else args
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", MODULE, str(pid), str(nproc), str(port), *extra],
                    stdout=logs[pid], stderr=subprocess.STDOUT, cwd=ROOT, env=env))
            deadline = time.monotonic() + timeout_s
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"a world of {nproc} workers outlived {timeout_s} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def run_world(
    nproc: int,
    args: Union[Sequence[str], Callable[[int], Sequence[str]]] = (),
    *,
    timeout_s: float = 300.0,
    env: dict = None,
) -> List[Tuple[int, str]]:
    """Start `nproc` workers (``python -m`` this module, from the
    repository root) on a free port, each with `args` (or ``args(pid)``),
    and wait for them: [(exit code, output)] in process order. A world
    that outlives `timeout_s` is killed and raises; a world whose port
    was taken before rank 0 bound it is started once more on another
    port. Every worker is dead when this returns."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [ROOT, env.get("PYTHONPATH")]))
    got = _start(nproc, args, timeout_s, env)
    if any(rc != 0 and _address_taken(out) for rc, out in got):
        got = _start(nproc, args, timeout_s, env)
    return got


if __name__ == "__main__":
    main()
