"""Multi-host (multi-process) distribution: the cross-host communication
backend the reference delegates to NCCL/MPI-style infrastructure in other
systems (SURVEY.md §5 "Distributed communication backend").

Port of ``antidote_ccrdt_tpu/parallel/multihost.py`` over
``torch.distributed``. One process runs per host (or per card); a world
of them is joined by `initialize` (``init_process_group`` over TCP,
``gloo``, or ``nccl`` with one rank per card). Inside a process the
host's local devices are logical devices of one physical device, as in
``parallel.dist``.

Layout: the global replica axis factors as (dcn, dc) = (process, local
device), matching the hierarchical reconciliation in `sharded.py` —
lattice all-reduce inside each host first, then across hosts, so the
cross-host hop carries one already-locally-merged state per host rather
than every replica.

The public pieces:
* `initialize` — one call per process; ``cpu_devices_per_process=n`` is
  JAX's CI rig (the CPU, n logical devices, ``gloo``); otherwise the card
  (or it raises) with ``local_devices`` logical devices of it.
* `global_replica_mesh` — a `GlobalMesh`, ("dcn", "dc", "key") over all
  processes.
* **a global leaf** is this process's block of a global array: an
  ordinary tensor carrying its `NamedSharding` (``leaf.sharding``) and the
  global shape (``leaf.global_shape``). For ``P(("dcn", "dc"), ...)`` the
  block is rows ``[p*R/n, (p+1)*R/n)``; the key axis lies inside the
  process, so the block holds every key column. A process keeps only its
  blocks: `state_sharding` / `init_global_state` /
  `ops_from_process_local` tag them (`init_global_state` evaluates the
  full-shape init once, transiently, and keeps its rows; the ops a
  process passes never leave it).
* `hierarchical_reconcile` — the inter-DC merge as a two-level lattice
  all-reduce: over "dc" inside the process (one merge of the local rows
  with their ``i ^ k`` permutation a round), then over "dcn" across
  processes (each pair swaps its whole local block, packed into one byte
  buffer, with ``batch_isend_irecv``; under ``gloo`` a card's buffer is
  staged through pinned host memory, under ``nccl`` it goes as it is).
* `process_local_shards` — this process's block as numpy.
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tree import leaves, tree_map
from .dist import Mesh, NamedSharding, P, _physical, device_array, mesh_devices

TIMEOUT_S = 120.0  # bounds the rendezvous and every collective of a world


class World(NamedTuple):
    """This process's place in the world: its rank, the world size, its
    local (logical) devices and the backend (None outside a world)."""

    process_index: int
    process_count: int
    devices: Tuple[torch.device, ...]
    backend: Optional[str]


_WORLD: Optional[World] = None


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    cpu_devices_per_process: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device: Any = None,
    local_devices: Optional[int] = None,
) -> None:
    """Join this process to the world at ``tcp://<coordinator_address>``.
    `cpu_devices_per_process` forces the CPU with n logical devices over
    ``gloo`` (the CI/multi-process-CPU rig). Otherwise the device resolves
    as every entry point resolves it (the card, or it raises), with
    `local_devices` logical devices of it (default 1), over `backend`
    (default ``nccl`` on a card, ``gloo`` on the CPU). TIMEOUT_S bounds
    the rendezvous and every collective."""
    global _WORLD
    import torch.distributed as tdist

    if cpu_devices_per_process is not None:
        dev, n_local = torch.device("cpu"), int(cpu_devices_per_process)
    else:
        dev, n_local = _physical(resolve_device(device)), int(local_devices or 1)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tdist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=TIMEOUT_S),
    )
    _WORLD = World(process_id, num_processes, (dev,) * n_local, backend)


def shutdown() -> None:
    """Leave the world `initialize` joined (``destroy_process_group``)."""
    global _WORLD
    import torch.distributed as tdist

    from ..harness import orbax_ckpt

    if tdist.is_initialized():
        tdist.destroy_process_group()
    orbax_ckpt._GLOO.clear()  # its gloo group died with the world
    _WORLD = None


def world() -> World:
    """The world this process joined; outside one, a world of one process
    whose local devices are ``parallel.dist.mesh_devices()``."""
    import torch.distributed as tdist

    if _WORLD is not None and tdist.is_initialized():
        return _WORLD
    return World(0, 1, tuple(mesh_devices()), None)


class GlobalMesh:
    """("dcn", "dc", "key") over every process: dcn = process, dc x key =
    the process's local devices (`local`, a ``parallel.dist.Mesh`` of
    logical devices of one physical device)."""

    axis_names = ("dcn", "dc", "key")

    def __init__(self, w: World, n_key: int = 1):
        n_local = len(w.devices)
        assert n_local % n_key == 0, (n_local, n_key)
        self.process_index, self.process_count = w.process_index, w.process_count
        self.backend = w.backend
        self.local = Mesh(device_array(w.devices, (n_local // n_key, n_key)), ("dc", "key"))
        self.device = self.local.device
        self.shape = {"dcn": w.process_count, "dc": n_local // n_key, "key": n_key}

    def _key(self):
        return (self.process_count, self.process_index, tuple(self.shape.values()), self.device)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, GlobalMesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"GlobalMesh({self.shape}, process={self.process_index}, device={self.device})"


def global_replica_mesh(n_key: int = 1) -> GlobalMesh:
    """("dcn", "dc", "key") mesh over every device of every process:
    dcn = process (cross-host hops), dc = local device, key = instance
    shards carved out of each host's local devices."""
    return GlobalMesh(world(), n_key)


def state_sharding(mesh: GlobalMesh) -> NamedSharding:
    """[R, NK, ...] pytrees: replicas split over (dcn, dc), instances over
    key."""
    return NamedSharding(mesh, P(("dcn", "dc"), "key"))


# --- global leaves: this process's block, tagged ------------------------------


def _axes(part: Any) -> Tuple[str, ...]:
    return tuple(part) if isinstance(part, tuple) else (() if part is None else (part,))


def _region(global_shape: Sequence[int], spec: Any, mesh: GlobalMesh) -> Tuple[List[int], List[int]]:
    """(starts, stops) of this process's block of a leaf of `global_shape`
    laid out by `spec`: a dim whose spec names "dcn" (as its major axis)
    is split into one contiguous range a process; "dc" and "key" lie
    inside the process."""
    parts = tuple(spec)
    starts, stops = [], []
    for dim, n in enumerate(global_shape):
        axes = _axes(parts[dim] if dim < len(parts) else None)
        if "dcn" not in axes:
            starts.append(0)
            stops.append(int(n))
            continue
        if axes[0] != "dcn":
            raise NotImplementedError(f"'dcn' must be the major axis of {axes}")
        per, rem = divmod(int(n), mesh.shape["dcn"])
        if rem:
            raise ValueError(f"dim {dim} of size {n} does not split over {mesh.shape['dcn']} processes")
        starts.append(mesh.process_index * per)
        stops.append((mesh.process_index + 1) * per)
    return starts, stops


def _tag(block: torch.Tensor, sharding: NamedSharding, global_shape: Sequence[int]) -> torch.Tensor:
    """A fresh alias of `block` tagged as the process's block of a global
    leaf."""
    out = block.view(block.shape)
    out.sharding = sharding
    out.global_shape = torch.Size(global_shape)
    return out


def global_region(leaf: Any) -> Optional[Tuple[List[int], List[int], torch.Size]]:
    """(starts, stops, global shape) of a global leaf's block; None for
    any other leaf."""
    shape = getattr(leaf, "global_shape", None)
    sharding = getattr(leaf, "sharding", None)
    if shape is None or sharding is None or not isinstance(sharding.mesh, GlobalMesh):
        return None
    starts, stops = _region(shape, sharding.spec, sharding.mesh)
    return starts, stops, shape


def init_global_state(init_fn: Callable[[], Any], mesh: GlobalMesh) -> Any:
    """A sharded global state: `init_fn()` gives the full-shape (cheap,
    identity) pytree; this process keeps its block of each leaf, tagged."""
    sh = state_sharding(mesh)

    def block(a):
        starts, stops = _region(a.shape, sh.spec, mesh)
        local = a[tuple(slice(lo, hi) for lo, hi in zip(starts, stops))].to(mesh.device).clone()
        return _tag(local, sh, a.shape)

    return tree_map(block, init_fn())


def ops_from_process_local(local_ops: Any, mesh: GlobalMesh) -> Any:
    """Global [R, B, ...] op batches from each process's [R_local, B, ...]
    contribution: every process passes the ops for ITS replicas only and
    keeps them (on its device, tagged); no op crosses processes."""
    sh = NamedSharding(mesh, P(("dcn", "dc")))

    def one(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        t = t.to(mesh.device)
        return _tag(t, sh, (t.shape[0] * mesh.shape["dcn"],) + tuple(t.shape[1:]))

    return tree_map(one, local_ops)


def process_local_shards(x: Any):
    """The addressable block of a sharded global pytree, as numpy (for
    assertions / host-side reads on each process)."""
    return tree_map(lambda a: a.detach().cpu().numpy(), x)


# --- the exchange across processes -------------------------------------------


def _pack(tree: Any) -> Tuple[torch.Tensor, List[Tuple[torch.dtype, torch.Size, int]]]:
    """Every leaf's bytes in one uint8 buffer (each padded to 8 bytes, so
    that every leaf's view back is aligned), and the layout to unpack."""
    parts, layout = [], []
    for a in leaves(tree):
        b = a.contiguous().reshape(-1).view(torch.uint8)
        parts.append(b)
        pad = -b.numel() % 8
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=b.device))
        layout.append((a.dtype, a.shape, b.numel()))
    return torch.cat(parts), layout


def _unpack(buf: torch.Tensor, layout, like: Any) -> Any:
    out, off = [], 0
    for dtype, shape, n in layout:
        out.append(buf[off:off + n].view(dtype).reshape(shape))
        off += n + (-n % 8)
    it = iter(out)
    return tree_map(lambda _a: next(it), like)


def _staged(buf: torch.Tensor, backend: Optional[str]) -> bool:
    """Whether `buf` goes through host memory: a card's buffer under any
    backend but ``nccl`` (gloo is not counted on to take CUDA tensors)."""
    return buf.device.type == "cuda" and backend != "nccl"


def _host_buffer(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(n, dtype=torch.uint8, pin_memory=like.device.type == "cuda")


def _swap(buf: torch.Tensor, peer: int, backend: Optional[str]) -> torch.Tensor:
    """Send `buf` to `peer` and receive the peer's buffer of the same
    size, both posted at once (``batch_isend_irecv``), so that neither
    side can deadlock."""
    import torch.distributed as tdist

    stage = _staged(buf, backend)
    send = _host_buffer(buf.numel(), buf).copy_(buf) if stage else buf
    recv = _host_buffer(buf.numel(), buf) if stage else torch.empty_like(buf)
    for work in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, send, peer), tdist.P2POp(tdist.irecv, recv, peer)]):
        work.wait()
    return recv.to(buf.device) if stage else recv


def _gather(buf: torch.Tensor, n: int, backend: Optional[str]) -> List[torch.Tensor]:
    """Every process's buffer (all of one size), in process order."""
    import torch.distributed as tdist

    stage = _staged(buf, backend)
    send = _host_buffer(buf.numel(), buf).copy_(buf) if stage else buf
    got = [_host_buffer(buf.numel(), buf) if stage else torch.empty_like(buf) for _ in range(n)]
    tdist.all_gather(got, send)
    return [g.to(buf.device) for g in got] if stage else got


def _pow2(n: int) -> bool:
    return n & (n - 1) == 0


def _dc_reduce(local: Any, merge: Callable[[Any, Any], Any], n: int, device: torch.device) -> Any:
    """The lattice all-reduce over "dc": the local rows are the dc blocks
    (one replica each). Round k joins every row with row ``i ^ k``, own
    side first, in one merge; a non-power-of-two axis folds rows 0..n-1
    in order and every row takes the result."""
    if n == 1:
        return local
    if _pow2(n):
        k = 1
        while k < n:
            perm = torch.tensor([i ^ k for i in range(n)], device=device)
            local = merge(local, tree_map(lambda a, perm=perm: a.index_select(0, perm), local))
            k *= 2
        return local
    acc = tree_map(lambda a: a[:1], local)
    for i in range(1, n):
        acc = merge(acc, tree_map(lambda a, i=i: a[i:i + 1], local))
    return tree_map(lambda a: a.expand((n,) + tuple(a.shape[1:])).contiguous(), acc)


def hierarchical_reconcile(
    state: Any, merge: Callable[[Any, Any], Any], mesh: GlobalMesh, *, stats: Optional[Dict[str, float]] = None
) -> Any:
    """Inter-DC reconciliation over the (dcn, dc) replica grid: lattice
    all-reduce with the CRDT join inside each host first, then across
    hosts. After it, every replica holds the global join.

    `merge` joins two states row by row ([rows, NK, ...] leaves). Requires
    R == n_dcn * n_dc (one replica per device on the replica grid): with
    more, co-resident replicas would never be merged — rejected loudly
    here rather than silently under-joining. With `stats` (port only),
    the device is synced around each level and the dict gets ``dc_ms``,
    ``dcn_ms``, ``dcn_exchange_ms``, ``dcn_bytes`` (sent) and
    ``reconcile_ms``."""
    n_rep = mesh.shape["dcn"] * mesh.shape["dc"]
    first = leaves(state)[0]
    R = first.global_shape[0] if hasattr(first, "global_shape") else first.shape[0] * mesh.shape["dcn"]
    if R != n_rep:
        raise ValueError(
            f"hierarchical_reconcile needs R == n_dcn*n_dc ({n_rep}), got "
            f"R={R}: co-resident replicas would never merge"
        )
    device = mesh.device

    def now() -> float:
        if stats is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = now()
    local = _dc_reduce(state, merge, mesh.shape["dc"], device)
    t1 = now()
    n, p = mesh.shape["dcn"], mesh.process_index
    sent, exchange_s = 0, 0.0
    if n > 1:
        buf, layout = _pack(local)
        if _pow2(n):
            k = 1
            while k < n:
                t = now()
                peer = _unpack(_swap(buf, p ^ k, mesh.backend), layout, local)
                exchange_s += now() - t
                sent += buf.numel()
                local = merge(local, peer)
                k *= 2
                if k < n:
                    buf, layout = _pack(local)
        else:
            t = now()
            blocks = [_unpack(b, layout, local) for b in _gather(buf, n, mesh.backend)]
            exchange_s += now() - t
            sent += buf.numel()
            acc = blocks[0]
            for b in blocks[1:]:
                acc = merge(acc, b)
            local = acc
    t2 = now()
    if stats is not None:
        stats.update(dc_ms=(t1 - t0) * 1e3, dcn_ms=(t2 - t1) * 1e3, dcn_exchange_ms=exchange_s * 1e3,
                     dcn_bytes=sent, reconcile_ms=(t2 - t0) * 1e3)
    sh = state_sharding(mesh)
    return tree_map(lambda a: _tag(a, sh, (a.shape[0] * n,) + tuple(a.shape[1:])), local)
