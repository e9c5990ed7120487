"""Dense-state checkpointing over ``torch.distributed.checkpoint`` (DCP):
sharded, retained, step-indexed.

Port of ``antidote_ccrdt_tpu/harness/orbax_ckpt.py``; the module keeps
its JAX name so that a reader finds the counterpart, but the files are
DCP's, not Orbax's, and neither package reads the other's. Values, step
lists, retention and errors are JAX's.

`harness.checkpoint` covers the single-process story (WAL journal +
versioned npz snapshots). This module is the distributed tier: dense
pytree states, host-local, placed on a ``parallel.dist`` mesh, or global
(``parallel.multihost``: each process holds its block), checkpoint with
step indexing and retention (`max_to_keep`), pairing with the WAL as
``checkpoint.resume`` does: restore the latest step, then replay the
journal suffix.

Layout: ``<directory>/<step>/`` holds one DCP checkpoint whose keys are
the state's leaf paths (``.slot_score``); a global leaf is saved by every
process collectively, each writing its own block under
``<path>@<start>:<stop>,...`` (its global range on every dim), so that
any process, or one process alone, restores any region of it. A step is
written under ``.tmp-<step>`` and renamed once DCP has written its
``.metadata`` (last), so a reader never lists a half-written step: only
a numeric directory holding ``.metadata`` is a step. In a world only
rank 0 renames and prunes.

Gated as JAX's is: `available()` is False when DCP does not import.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..device import resolve_device
from ..utils.tree import flatten_with_path, map_with_path

try:
    import torch.distributed.checkpoint as _dcp

    _IMPORT_ERROR: Optional[str] = None
except Exception as e:  # pragma: no cover - exercised only without DCP
    _dcp = None
    _IMPORT_ERROR = str(e)

METADATA = ".metadata"  # DCP writes it last: its presence finalizes a step
_GLOO = {}  # the gloo group DCP plans over when the world's backend is another


def available() -> bool:
    return _dcp is not None


def _require():
    if _dcp is None:
        raise RuntimeError(
            f"orbax-checkpoint unavailable ({_IMPORT_ERROR}); "
            "use harness.checkpoint.save_dense_checkpoint instead"
        )
    return _dcp


@contextlib.contextmanager
def _quiet():
    """DCP warns that it assumes one process whenever no world is set up."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _world():
    """(rank, DCP's process group) of the world a collective save runs
    in; DCP plans with object collectives, which run over gloo."""
    import torch.distributed as tdist

    if tdist.get_backend() == "gloo":
        return tdist.get_rank(), None
    if "group" not in _GLOO:
        _GLOO["group"] = tdist.new_group(backend="gloo")
    return tdist.get_rank(), _GLOO["group"]


def _scan(directory: str) -> List[int]:
    """The finalized steps on disk."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n) for n in os.listdir(directory)
        if n.isdigit() and os.path.isfile(os.path.join(directory, n, METADATA))
    )


def _key(path: str) -> str:
    return path or "."


def _ranges(key: str, path_key: str) -> Optional[List[Tuple[int, int]]]:
    """The block ranges a key names for the leaf at `path_key`, or None."""
    head, sep, tail = key.rpartition("@")
    if not sep or head != path_key:
        return None
    try:
        return [(int(a), int(b)) for a, b in (r.split(":") for r in tail.split(","))]
    except ValueError:
        return None


def dir_bytes(path: str) -> int:
    """Bytes of the files under `path`."""
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


class DenseCheckpointManager:
    """Step-indexed, retention-managed checkpoints of one dense-state pytree.

    The state may be host-local, placed on a ``parallel.dist`` mesh, or
    global over a ``parallel.multihost`` world (each process saving its
    block); `restore(like=...)` lays the values out as `like`'s leaves
    (their device and sharding tags), so a checkpoint written from one
    mesh restores onto a differently shaped one, and one process can
    restore a state a world wrote.

    As Orbax's manager does, it caches the step list: its own saves and
    `reload()` refresh it, so a reader of a directory another process
    writes must reload before `latest_step`/`restore`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dcp = _require()
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._steps = _scan(self.directory)
        self._pending: Optional[Tuple[threading.Thread, list, int, str]] = None

    # -- saving ------------------------------------------------------------

    def save(self, step: int, state: Any, *, wait: bool = True) -> None:
        """Save `state` as `step` (skipped, as Orbax skips it, when the
        step is not past the latest). A state holding global leaves saves
        collectively: every process of the world calls this. `wait=False`
        writes a host copy on a thread; the next save, a restore, a look at
        the step list, `close()` and `wait_until_finished()` wait for it (a
        collective save always waits)."""
        from ..parallel.multihost import global_region

        self.wait_until_finished()
        if self._steps and step <= self._steps[-1]:
            return
        sd: Dict[str, torch.Tensor] = {}
        collective = False
        for path, leaf in flatten_with_path(state):
            t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
            key = _key(path)
            region = global_region(leaf)
            if region is not None:
                starts, stops, _shape = region
                key += "@" + ",".join(f"{a}:{b}" for a, b in zip(starts, stops))
                collective = True
            # A card's leaf is staged to host memory before DCP writes it.
            sd[key] = t.detach().to("cpu", copy=not wait or t.device.type != "cpu")
        import torch.distributed as tdist

        in_world = collective and tdist.is_initialized() and tdist.get_world_size() > 1
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if not in_world:
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            if wait:
                self._write(sd, tmp, None, True)
                self._commit(step, tmp, True)
                return
            err: list = []
            th = threading.Thread(target=self._write, args=(sd, tmp, None, True, err), daemon=True)
            th.start()
            self._pending = (th, err, step, tmp)
            return
        rank, group = _world()
        if rank == 0 and os.path.exists(tmp):
            shutil.rmtree(tmp)
        tdist.barrier(group=group)
        self._write(sd, tmp, group, False)
        self._commit(step, tmp, rank == 0)
        tdist.barrier(group=group)

    def _write(self, sd: Dict[str, torch.Tensor], tmp: str, group: Any, no_dist: bool,
               err: Optional[list] = None) -> None:
        try:
            with _quiet():
                self._dcp.save(sd, storage_writer=self._dcp.FileSystemWriter(tmp), process_group=group,
                               no_dist=no_dist)
        except BaseException as e:  # noqa: BLE001 — handed to the waiting caller
            if err is None:
                raise
            err.append(e)

    def _commit(self, step: int, tmp: str, owner: bool) -> None:
        """Finalize `step` (rename it into place) and prune the cached
        list to `max_to_keep`, deleting the aged-out steps; only `owner`
        (rank 0 in a world) touches the disk."""
        if owner:
            os.replace(tmp, os.path.join(self.directory, str(step)))
        self._steps = sorted(set(self._steps) | {step})
        while len(self._steps) > self.max_to_keep:
            old = self._steps.pop(0)
            if owner:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)

    def wait_until_finished(self) -> None:
        """Wait for a `save(wait=False)` and finalize its step."""
        if self._pending is None:
            return
        th, err, step, tmp = self._pending
        self._pending = None
        th.join()
        if err:
            raise err[0]
        self._commit(step, tmp, True)

    # -- restoring ---------------------------------------------------------

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore `step` (default: latest) into the structure, dtypes,
        devices and shardings of `like` (a concrete pytree or one of
        ``parallel.dist.ShapeDtypeStruct``; a global leaf of `like` gets
        this process's block)."""
        from ..parallel import dist
        from ..parallel.multihost import _tag, global_region

        self.wait_until_finished()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint steps in directory")
        path = os.path.join(self.directory, str(step))
        if not os.path.isfile(os.path.join(path, METADATA)):
            raise FileNotFoundError(f"Checkpoint at {path} not found.")
        reader = self._dcp.FileSystemReader(path)
        stored = reader.read_metadata().state_dict_metadata

        plans = []  # (region starts, stops, global shape, [(key, ranges) overlapping the region])
        for p, leaf in flatten_with_path(like):
            region = global_region(leaf)
            if region is not None:
                starts, stops, shape = region
            else:
                shape = torch.Size(leaf.shape)
                starts, stops = [0] * len(shape), list(shape)
            k = _key(p)
            if k in stored:
                pieces = [(k, [(0, int(n)) for n in stored[k].size])]
            else:
                pieces = [(key, r) for key in stored if (r := _ranges(key, k)) is not None]
            if not pieces:
                raise KeyError(f"checkpoint step {step} has no leaf {k}")
            for key, r in pieces:
                if len(r) != len(shape) or any(b > n for (_a, b), n in zip(r, shape)):
                    raise ValueError(f"checkpoint leaf {key} does not fit the shape {tuple(shape)} of {k}")
            plans.append((starts, stops, shape, [(key, r) for key, r in pieces
                                                 if all(a < hi and lo < b for (a, b), lo, hi in zip(r, starts, stops))]))
        bufs = {key: torch.empty(tuple(stored[key].size), dtype=stored[key].properties.dtype)
                for *_x, pieces in plans for key, _r in pieces}
        with _quiet():
            self._dcp.load(bufs, storage_reader=reader, no_dist=True)

        it = iter(plans)

        def one(_p, leaf):
            starts, stops, shape, pieces = next(it)
            out = torch.empty([hi - lo for lo, hi in zip(starts, stops)], dtype=leaf.dtype)
            filled = 0
            for key, r in pieces:
                lo = [max(a, s) for (a, _b), s in zip(r, starts)]
                hi = [min(b, e) for (_a, b), e in zip(r, stops)]
                src = tuple(slice(x - a, y - a) for x, y, (a, _b) in zip(lo, hi, r))
                dst = tuple(slice(x - s, y - s) for x, y, s in zip(lo, hi, starts))
                out[dst] = bufs[key][src].to(leaf.dtype)
                filled += int(torch.Size([y - x for x, y in zip(lo, hi)]).numel())
            if filled != out.numel():
                raise ValueError(f"checkpoint step {step} does not cover {_p or 'the root'}")
            sharding = getattr(leaf, "sharding", None)
            if isinstance(leaf, torch.Tensor):
                device = leaf.device
            elif sharding is not None:
                device = sharding.mesh.device
            else:
                device = resolve_device()
            out = out.to(device)
            if global_region(leaf) is not None:
                return _tag(out, sharding, shape)
            return dist.device_put(out, sharding) if sharding is not None else out

        return map_with_path(one, like)

    # -- the cached step list ----------------------------------------------

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        return self._steps[-1] if self._steps else None

    def reload(self) -> None:
        """Refresh the cached step list. It is read at construction and
        updated only on this manager's own saves — a READER of a directory
        another process (or manager) writes must reload before
        `latest_step`/`restore`, or it pins the steps it saw first."""
        self._steps = _scan(self.directory)

    def all_steps(self):
        self.wait_until_finished()
        return sorted(self._steps)

    def close(self) -> None:
        self.wait_until_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
