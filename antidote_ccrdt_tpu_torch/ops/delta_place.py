"""Wrapper of the hand-written CUDA kernel K2 (``delta_place``), with its
plain PyTorch version.

The delta build of ``TopkRmvDense.apply_ops`` places the kept entries of
the sorted add stream into three [R, T, M] tables at (kid, rank) — the
three ``.at[kid3, rank3].set(..., mode="drop")`` scatters of the JAX
engine (models/topk_rmv_dense.py:593-622) and the function of
``delta_place_pallas`` (ops/delta_place.py:136). Kept addresses are
unique by construction, so the placement has no conflicts.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .dense_table import NEG_INF
from .kernels import _check, _ptr, kernel_device
from ..device import cuda_stream_handle

I32 = torch.int32


def _alloc(R: int, T: int, M: int, device: torch.device):
    return (
        torch.full((R, T, M), NEG_INF, dtype=I32, device=device),
        torch.zeros((R, T, M), dtype=I32, device=device),
        torch.zeros((R, T, M), dtype=I32, device=device),
    )


def delta_place(s_score, s_ts, s_dc, kid3, rank, keep, T: int, M: int):
    """Build (d_score, d_dc, d_ts) i32[R, T, M] from the sorted add stream.

    s_score, s_ts, s_dc, kid3, rank: i32[R, B]; keep: bool[R, B]. A kept
    entry j of replica r writes its values at [r, kid3[r, j], rank[r, j]];
    kept entries must have unique addresses, and those outside [0, T) x
    [0, M) are dropped. Unwritten cells are (NEG_INF, 0, 0)."""
    R, B = kid3.shape
    for name, t in (("s_score", s_score), ("s_ts", s_ts), ("s_dc", s_dc),
                    ("kid3", kid3), ("rank", rank)):
        _check(name, t, I32, (R, B))
    _check("keep", keep, torch.bool, (R, B))
    if not kernel_device(s_score, s_ts, s_dc, kid3, rank, keep):
        return delta_place_plain(s_score, s_ts, s_dc, kid3, rank, keep, T, M)
    d_score, d_dc, d_ts = _alloc(R, T, M, kid3.device)
    if R * B == 0:
        return d_score, d_dc, d_ts
    fn = _build.load("delta_place", _K2_ARGS)
    rc = fn(
        _ptr(s_score), _ptr(s_ts), _ptr(s_dc), _ptr(kid3), _ptr(rank), _ptr(keep),
        _ptr(d_score), _ptr(d_dc), _ptr(d_ts), R, B, T, M,
        ctypes.c_void_p(cuda_stream_handle(kid3)),
    )
    _build.check(rc, "delta_place")
    delta_place.launches += 1
    return d_score, d_dc, d_ts


delta_place.launches = 0
_K2_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def delta_place_plain(s_score, s_ts, s_dc, kid3, rank, keep, T: int, M: int):
    """Plain version of K2: one flat ``scatter_`` per table, dropped
    entries pointed at a trash cell past the end."""
    R, B = kid3.shape
    dev = kid3.device
    n = R * T * M
    ok = keep & (kid3 >= 0) & (kid3 < T) & (rank >= 0) & (rank < M)
    r = torch.arange(R, device=dev, dtype=torch.int64)[:, None]
    addr = (r * T + kid3.to(torch.int64)) * M + rank.to(torch.int64)
    addr = torch.where(ok, addr, torch.full_like(addr, n)).reshape(-1)
    out = []
    for src, fill in ((s_score, NEG_INF), (s_dc, 0), (s_ts, 0)):
        flat = torch.full((n + 1,), fill, dtype=I32, device=dev)
        flat.scatter_(0, addr, src.reshape(-1))
        out.append(flat[:n].view(R, T, M))
    return tuple(out)
