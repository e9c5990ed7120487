"""Sort/segment primitives shared by the dense CRDT kernels (port of
``antidote_ccrdt_tpu/ops/segment.py``).

Group boundaries and ranks of already sorted key columns, from
roll-compares, cumulative sums and maxima: no data-dependent shapes. Each
function works along the last axis of its [..., L] columns, so a leading
batch axis (the replicas) rides along where JAX vmaps the 1-D function.
Every result is the JAX function's, bit for bit, int32 where JAX's is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

I32 = torch.int32


def segment_starts(*keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group structure of *already sorted* key columns [..., L].

    Elements of one group (equal on every key) must be contiguous. Returns
    ``(first, start, seg)``: per-row first-in-group flag, index of the
    group's first row, and dense segment id (0, 1, 2, ...), both int32.
    Row 0 always starts a group (JAX's roll compares it with the last row,
    and ``first.at[0].set(True)`` overrides that)."""
    L = keys[0].shape[-1]
    idx = torch.arange(L, dtype=I32, device=keys[0].device)
    first = torch.zeros(keys[0].shape, dtype=torch.bool, device=keys[0].device)
    for k in keys:
        first = first | (k != torch.roll(k, 1, dims=-1))
    if L:
        first[..., 0] = True
    start = torch.cummax(torch.where(first, idx, 0), dim=-1).values
    seg = torch.cumsum(first, dim=-1, dtype=I32) - 1
    return first, start, seg


def prefix_rank(flag: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Rank of each True `flag` row among the True rows of its segment
    (segments given by per-row group-start indices from segment_starts)."""
    f = flag.to(I32)
    excl = torch.cumsum(f, dim=-1, dtype=I32) - f
    return excl - torch.gather(excl, -1, start.to(torch.int64))


def run_max(vals: torch.Tensor, seg: torch.Tensor, direction: str = "both") -> torch.Tensor:
    """Per-row max over the row's segment, for *already sorted* segment
    ids: ``out[i] = max(vals[j] for j where seg[j] == seg[i])``.

    `direction`: "both" covers the whole segment; "prefix" only [segment
    start, i]; "suffix" only [i, segment end]. `vals` is [..., L] or
    [..., L, D] (the segment axis is the one `seg` [..., L] ends on);
    `seg` is any nondecreasing int32 run id, such as `segment_starts`'s
    dense id or sorted row ids. Values are non-negative, as in JAX (whose
    doubling scan shifts in 0 beside a -1 fill that a run id of -1 would
    match); with run ids >= 0 any int32 value gives the JAX result.

    Max is exact in any order, so the formulation is free: "both" is one
    scatter-max into per-run cells and a gather back; "prefix" and
    "suffix" are one cumulative max of (run id, value) packed exactly
    into int64, which never reaches across a run boundary because the
    run ids rise along the axis."""
    assert direction in ("both", "prefix", "suffix"), direction
    if seg.numel() == 0:
        return vals.clone()
    wide = vals.dim() == seg.dim() + 1
    axis = seg.dim() - 1
    if direction == "both":
        seg = segment_starts(seg)[2]
    if direction == "both":
        # One row of cells per (batch row, run): the run ids offset by
        # L per batch row, flattened onto axis 0.
        L = seg.shape[-1]
        n = seg.numel()
        off = torch.arange(0, n, L, device=seg.device, dtype=torch.int64).view(seg.shape[:-1] + (1,))
        gseg = (seg.to(torch.int64) + off).reshape(n)
        flat = vals.reshape((n,) + tuple(vals.shape[axis + 1:]))
        red = torch.full(flat.shape, torch.iinfo(vals.dtype).min, dtype=vals.dtype, device=vals.device)
        red.index_reduce_(0, gseg, flat, "amax")
        return red.index_select(0, gseg).reshape(vals.shape)
    segx = seg.to(torch.int64)
    if wide:
        segx = segx.unsqueeze(-1).expand(vals.shape)
    if direction == "suffix":
        # Backwards along the axis the negated segment ids rise.
        hi = -segx * 2**32
        packed = torch.flip(hi + (vals.to(torch.int64) + 2**31), dims=(axis,))
        out = torch.flip(torch.cummax(packed, dim=axis).values, dims=(axis,))
    else:
        hi = segx * 2**32
        out = torch.cummax(hi + (vals.to(torch.int64) + 2**31), dim=axis).values
    return (out - hi - 2**31).to(vals.dtype)


def group_rank(group_keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Rank of each element within its group, for *already sorted* inputs:
    int32 ranks 0,1,2,... restarting at each group boundary."""
    L = group_keys[0].shape[-1]
    _, start, _ = segment_starts(*group_keys)
    return torch.arange(L, dtype=I32, device=start.device) - start
