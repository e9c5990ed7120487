"""Distribution layer: replica/key sharding over a mesh of logical devices,
with the collective merges as functions over blocks.

Port of ``antidote_ccrdt_tpu/parallel/dist.py``. The JAX package places
state on a ``jax.sharding.Mesh`` and runs the merges inside ``shard_map``,
one program per device. In one torch process the same layout is kept
like this:

* **the mesh** (`Mesh`) is an array of ``torch.device`` entries with axis
  names, ``mesh.shape["dc"]`` read as in JAX. Entries may repeat: one
  card (or the CPU) carries several *logical* devices, the way the JAX
  tests' conftest gives the CPU 8 virtual devices. A mesh whose entries
  name more than one physical device raises `NotImplementedError`;
* **a placed leaf** is an ordinary tensor on the mesh's device that
  carries its `NamedSharding` as a ``sharding`` attribute (`device_put`
  tags a fresh alias, never the caller's tensor). Anything computed from
  it carries no tag, as a JAX result built outside the mesh carries no
  mesh sharding;
* **shard_map** is a loop over the mesh's blocks (`split`, `each`,
  `along`, `assemble`). A block is the contiguous slice of a leaf that
  JAX's `NamedSharding` puts on one device: block d of a ``P("dc")`` leaf
  holds rows ``[d*R/n, (d+1)*R/n)``. Blocks are views, never copies
  through the host. Reassembled, an axis the out spec does not name is
  read from its index 0, as JAX reads a replicated result back;
* **the collectives** take the list of blocks along one axis and return
  what each of JAX's devices holds afterwards, bit for bit:
  `lattice_all_reduce` pairs block i with block i ^ k, own side first;
  `all_gather_reduce` folds blocks 0..n-1 in order; `all_gather`
  stacks in shard order; `psum` is an int32 sum that wraps as XLA's.

The dc axis shards replicas (the inter-DC exchange becomes the
collective); the key axis shards the CRDT instance grid or an instance's
id space and needs no collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.tree import tree_map

Pos = Tuple[int, ...]
Grid = Dict[Pos, Any]

# Set by `logical_devices`: the device list meshes are built over by default.
_LOGICAL: contextvars.ContextVar[Optional[Tuple[torch.device, ...]]] = contextvars.ContextVar(
    "mesh_logical_devices", default=None
)


def _physical(device: Any) -> torch.device:
    """A device with its index filled in (``cuda`` -> ``cuda:<current>``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_devices() -> List[torch.device]:
    """The devices a mesh is built over when the caller names none (JAX's
    ``jax.devices()``): the logical devices of the innermost
    `logical_devices` region, else every card (the CPU inside
    ``core.batch_merge.host_device``). Raises without a card and outside
    both, as `device.resolve_device` does."""
    got = _LOGICAL.get()
    if got is not None:
        return list(got)
    dev = resolve_device()
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@contextlib.contextmanager
def logical_devices(devs: Sequence[Any]) -> Iterator[None]:
    """A region in which `mesh_devices()` is `devs`: e.g. ``["cpu"] * 8`` for
    the 8-device rig the JAX tests run on, or ``[card] * 8`` for eight
    logical devices on one card."""
    token = _LOGICAL.set(tuple(_physical(d) for d in devs))
    try:
        yield
    finally:
        _LOGICAL.reset(token)


class LogicalDevice(NamedTuple):
    """One position of a mesh: its flat index and the device holding it."""

    id: int
    device: torch.device


class Mesh:
    """A named-axis array of logical devices, all on one physical device."""

    def __init__(self, devs: Any, axis_names: Sequence[str]):
        arr = devs if isinstance(devs, np.ndarray) else np.asarray(devs, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = _physical(arr[idx])
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in arr.shape)))
        physical = {d for d in self.devices.flat}
        if len(physical) != 1:
            raise NotImplementedError(
                f"a mesh over {len(physical)} physical devices ({sorted(map(str, physical))}): "
                "the port runs a mesh of logical devices on one device"
            )
        self.device = physical.pop()

    def positions(self) -> List[Pos]:
        """Every block position, in the mesh's flat (C) order."""
        return list(np.ndindex(self.devices.shape))

    def index(self, pos: Pos, axis: str) -> int:
        """The index along `axis` of the block at `pos` (``lax.axis_index``)."""
        return pos[self.axis_names.index(axis)]

    def _key(self):
        return (self.axis_names, self.devices.shape, self.device)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


class PartitionSpec:
    """Which mesh axis (or None) each leading axis of a leaf is split over.
    Not a tuple, so that the port's tree walks treat it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Optional[str]):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, PartitionSpec) and self.parts == other.parts

    def __hash__(self) -> int:
        return hash(("PartitionSpec", self.parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


class NamedSharding:
    """A leaf's layout: `spec` over `mesh`. Its `device_set` is the mesh's
    logical devices (every one holds a block or a replica)."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def device_set(self) -> frozenset:
        return frozenset(LogicalDevice(i, d) for i, d in enumerate(self.mesh.devices.flat))

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, NamedSharding) and self.mesh == other.mesh and self.spec == other.spec

    def __hash__(self) -> int:
        return hash((self.mesh, self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class ShapeDtypeStruct:
    """``jax.ShapeDtypeStruct``: an abstract leaf (shape, dtype and an
    optional sharding) for a restore to fill. Not a tuple, so that the
    port's tree walks treat it as a leaf."""

    __slots__ = ("shape", "dtype", "sharding")

    def __init__(self, shape: Sequence[int], dtype: torch.dtype, sharding: Optional[NamedSharding] = None):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding

    def __repr__(self) -> str:
        return f"ShapeDtypeStruct(shape={tuple(self.shape)}, dtype={self.dtype}, sharding={self.sharding!r})"


def device_put(leaf: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """`leaf` on the mesh's device, tagged with `sharding`: a new tensor
    object (an alias when the leaf is there already); `leaf` itself is
    not touched."""
    out = leaf.to(sharding.mesh.device)
    if out is leaf:
        out = leaf.view(leaf.shape)
    out.sharding = sharding
    return out


def make_mesh(n_dc: int, n_key: int = 1, devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A (dc, key) mesh: replicas x instance-shards."""
    devs = list(devices) if devices is not None else mesh_devices()
    n = n_dc * n_key
    assert len(devs) >= n, f"need {n} devices, have {len(devs)}"
    return Mesh(device_array(devs[:n], (n_dc, n_key)), ("dc", "key"))


def device_array(devs: Sequence[Any], shape: Tuple[int, ...]) -> np.ndarray:
    """`devs` as an object array of `shape` (numpy would read a list of
    devices as a list of sequences)."""
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


# --- blocks ------------------------------------------------------------------


def _slices(leaf: torch.Tensor, spec: PartitionSpec, mesh: Mesh, pos: Pos) -> tuple:
    out = []
    for dim, name in enumerate(spec):
        if name is None:
            out.append(slice(None))
            continue
        n = leaf.shape[dim] // mesh.shape[name]
        i = mesh.index(pos, name)
        out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def split(tree: Any, specs: Any, mesh: Mesh) -> Grid:
    """{position: the tree's block there}: each leaf sliced along the
    axes its spec names (views)."""
    return {
        pos: tree_map(lambda leaf, spec, pos=pos: leaf[_slices(leaf, spec, mesh, pos)], tree, specs)
        for pos in mesh.positions()
    }


def _join_leaf(spec: PartitionSpec, mesh: Mesh, blocks: Dict[Pos, torch.Tensor]) -> torch.Tensor:
    named = {n for n in spec if n is not None}
    first = blocks[mesh.positions()[0]]
    if not named:
        out = first.view(first.shape)
    else:
        shape = list(first.shape)
        for dim, name in enumerate(spec):
            if name is not None:
                shape[dim] *= mesh.shape[name]
        out = torch.empty(shape, dtype=first.dtype, device=first.device)
        for pos, blk in blocks.items():
            if any(pos[a] for a, name in enumerate(mesh.axis_names) if name not in named):
                continue  # a replica: JAX reads the axis back from index 0
            out[_slices(out, spec, mesh, pos)] = blk
    out.sharding = NamedSharding(mesh, spec)
    return out


def assemble(grid: Grid, specs: Any, mesh: Mesh) -> Any:
    """The global tree of a grid of blocks, each leaf tagged with its
    `NamedSharding` (the out specs of a ``shard_map``)."""
    order = mesh.positions()
    return tree_map(
        lambda spec, *blocks: _join_leaf(spec, mesh, dict(zip(order, blocks))),
        specs, *(grid[p] for p in order),
    )


def each(grid: Grid, fn: Callable[..., Any], *more: Grid) -> Grid:
    """``fn(pos, block, *same position of more)`` at every position."""
    return {pos: fn(pos, blk, *(g[pos] for g in more)) for pos, blk in grid.items()}


def along(grid: Grid, mesh: Mesh, axis: str, fn: Callable[[List[Any]], List[Any]]) -> Grid:
    """A collective over `axis`: for every index of the other axes, the
    blocks along `axis` (in axis order) go through `fn`, which returns
    what each of those positions holds afterwards."""
    a = mesh.axis_names.index(axis)
    others = [range(n) for i, n in enumerate(mesh.devices.shape) if i != a]
    out: Grid = {}
    for rest in itertools.product(*others):
        line = [rest[:a] + (i,) + rest[a:] for i in range(mesh.devices.shape[a])]
        for pos, blk in zip(line, fn([grid[p] for p in line])):
            out[pos] = blk
    return out


def shard_map(fn: Callable[..., Grid], mesh: Mesh, in_specs: Sequence[Any], out_specs: Any):
    """``shard_map`` over a block program: the returned function splits
    each argument by its in spec, calls ``fn(*grids)`` (which uses `each`
    and `along`) and assembles the result by `out_specs`."""

    def run(*args: Any) -> Any:
        grids = [split(a, s, mesh) for a, s in zip(args, in_specs)]
        return assemble(fn(*grids), out_specs, mesh)

    return run


# --- collectives over the blocks of one axis ---------------------------------


def lattice_all_reduce(blocks: Sequence[Any], merge: Callable[[Any, Any], Any]) -> List[Any]:
    """All-reduce with an associative, commutative combiner (the CRDT
    merge). Recursive doubling: in round k block i becomes
    ``merge(block[i], block[i ^ k])``, so after log2(n) rounds every block
    holds the full merge. A non-power-of-two axis falls back to
    `all_gather_reduce`."""
    n = len(blocks)
    if n & (n - 1) != 0:
        return all_gather_reduce(blocks, merge)
    xs = list(blocks)
    k = 1
    while k < n:
        xs = [merge(xs[i], xs[i ^ k]) for i in range(n)]
        k *= 2
    return xs


def all_gather_reduce(blocks: Sequence[Any], merge: Callable[[Any, Any], Any]) -> List[Any]:
    """Fallback all-reduce for non-power-of-two axes: every block folds
    blocks 0..n-1 in order, so all hold one result."""
    acc = blocks[0]
    for b in blocks[1:]:
        acc = merge(acc, b)
    return [acc] * len(blocks)


def all_gather(blocks: Sequence[Any]) -> List[Any]:
    """``lax.all_gather``: every block gets the blocks stacked on a new
    leading axis, in shard order."""
    g = tree_map(lambda *xs: torch.stack(xs), *blocks)
    return [g] * len(blocks)


def psum(blocks: Sequence[Any]) -> List[Any]:
    """``lax.psum``: every block gets the elementwise sum of all blocks,
    in their dtype (int32 wraps)."""

    def add(*xs):
        acc = xs[0]
        for x in xs[1:]:
            acc = acc + x
        return acc.to(xs[0].dtype)

    s = tree_map(add, *blocks)
    return [s] * len(blocks)


# --- placement ---------------------------------------------------------------


def replica_sharding(mesh: Mesh) -> NamedSharding:
    """State pytrees [R, NK, ...]: replicas on 'dc', instances on 'key'."""
    return NamedSharding(mesh, P("dc", "key"))


def shard_state(state: Any, mesh: Mesh) -> Any:
    """Place a [R, NK, ...] state pytree onto the mesh (dc x key)."""
    sh = replica_sharding(mesh)
    return tree_map(lambda a: device_put(a, sh), state)


def shard_ops(ops: Any, mesh: Mesh) -> Any:
    """Op batches are [R, B...]: replicas on 'dc', replicated over 'key'
    (each key-shard filters by instance index)."""
    sh = NamedSharding(mesh, P("dc"))
    return tree_map(lambda a: device_put(a, sh), ops)
