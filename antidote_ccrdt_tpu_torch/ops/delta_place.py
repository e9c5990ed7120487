"""Wrapper of the hand-written CUDA kernel K2 (``delta_place``), with its
plain PyTorch version.

The delta build of ``TopkRmvDense.apply_ops`` places the kept entries of
the sorted add stream into three [R, T, M] tables at (kid, rank) — the
three ``.at[kid3, rank3].set(..., mode="drop")`` scatters of the JAX
engine (models/topk_rmv_dense.py:593-622) and the function of
``delta_place_pallas`` (ops/delta_place.py:136). Kept addresses are
unique by construction, so the placement has no conflicts. On a card one
launch writes every cell of the three tables; nothing fills them first.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dense_table import NEG_INF
from .kernels import _check, _ptr, kernel_device
from ..device import cuda_stream_handle

I32 = torch.int32


def delta_place(s_score, s_ts, s_dc, kid, rank, keep, T: int, M: int):
    """Build (d_score, d_dc, d_ts) i32[R, T, M] from the sorted add stream.

    s_score, s_ts, s_dc, kid, rank: i32[R, B]; keep: bool[R, B]. A kept
    entry j of replica r writes its values at [r, kid[r, j], rank[r, j]];
    kept entries must have unique addresses, and those outside [0, T) x
    [0, M) are dropped. Unwritten cells are (NEG_INF, 0, 0).

    Precondition: each replica's `kid` is nondecreasing (``AddStream.kid``,
    the stream's sort key, not ``kid3``). The kernel finds each tile's
    entries by binary search and does not check the order, which would
    cost a host sync; the plain version does not need it."""
    R, B = kid.shape
    for name, t in (("s_score", s_score), ("s_ts", s_ts), ("s_dc", s_dc),
                    ("kid", kid), ("rank", rank)):
        _check(name, t, I32, (R, B))
    _check("keep", keep, torch.bool, (R, B))
    if not kernel_device(s_score, s_ts, s_dc, kid, rank, keep):
        return delta_place_plain(s_score, s_ts, s_dc, kid, rank, keep, T, M)
    if not 1 <= M <= K2_MAX_M:
        raise ValueError(f"the CUDA kernel takes 1 <= M <= {K2_MAX_M}, not {M}")
    d_score, d_dc, d_ts = (torch.empty((R, T, M), dtype=I32, device=kid.device) for _ in range(3))
    if R * T == 0:
        return d_score, d_dc, d_ts
    fn = _build.load("delta_place", _K2_ARGS)
    rc = fn(
        _ptr(s_score), _ptr(s_ts), _ptr(s_dc), _ptr(kid), _ptr(rank), _ptr(keep),
        _ptr(d_score), _ptr(d_dc), _ptr(d_ts), R, B, T, M,
        ctypes.c_void_p(cuda_stream_handle(kid)),
    )
    _build.check(rc, "delta_place")
    delta_place.launches += 1
    return d_score, d_dc, d_ts


delta_place.launches = 0
K2_MAX_M = 1024  # the kernel's shared-memory tile holds at least one [M] row
_K2_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def delta_place_plain(s_score, s_ts, s_dc, kid, rank, keep, T: int, M: int):
    """Plain version of K2: one flat ``scatter_`` per table, dropped
    entries pointed at a trash cell past the end."""
    R, B = kid.shape
    dev = kid.device
    n = R * T * M
    ok = keep & (kid >= 0) & (kid < T) & (rank >= 0) & (rank < M)
    r = torch.arange(R, device=dev, dtype=torch.int64)[:, None]
    addr = (r * T + kid.to(torch.int64)) * M + rank.to(torch.int64)
    addr = torch.where(ok, addr, torch.full_like(addr, n)).reshape(-1)
    out = []
    for src, fill in ((s_score, NEG_INF), (s_dc, 0), (s_ts, 0)):
        flat = torch.full((n + 1,), fill, dtype=I32, device=dev)
        flat.scatter_(0, addr, src.reshape(-1))
        out.append(flat[:n].view(R, T, M))
    return tuple(out)
