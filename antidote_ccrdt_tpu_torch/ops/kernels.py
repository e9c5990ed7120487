"""Wrappers of the hand-written CUDA kernels K1 (``scatter_max_rows_``, in
place), K1c (``scatter_max_rows_copy``, out of place: the main path's
tombstone update) and K3 (``sort_slots``: a thread a row up to 8
candidates, a warp a row up to 256, tiles of a row over many blocks
above), with their plain PyTorch versions.

A wrapper checks device, dtype, shape and contiguity and raises on what it
does not take. For CUDA tensors it launches its kernel (built from
``csrc/`` at first use) and adds one to its ``launches`` count; for CPU
tensors it runs the plain version, which the CPU tests hold against the JAX
package and ``chip_smoke.py`` holds against the kernel on the card. There
is no other switch between the two.

K2 (delta placement) lives in ``ops/delta_place.py``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from ..device import cuda_stream_handle
from . import _build
from .dense_table import NEG_INF

I32 = torch.int32
Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

MAX_SLOTS = 16  # the widest row counted in ``sort_slots.launches``
WARP_MAX_SLOTS = 256  # the widest row a warp owns; wider ones take the row paths
WIDE_MAX_SLOTS = 8192  # the widest row counted in ``sort_slots.block_launches``
GLOBAL_MAX_SLOTS = 1 << 30  # the widest row K3's int32 in-row indices address
GLOBAL_SCRATCH_BYTES = 1 << 28  # device scratch of one chunk of rows wider than one tile
ROW_TILE_MAX = 8192  # the widest tile of K3's row paths (two tiles of 12-byte candidates in shared memory)
ROW_TILE = 4096  # the tile of a row wider than ROW_TILE_MAX
ROW_SPAN = 1024  # sorted candidates a block of the row paths' merge and place kernels (epilogue sums each)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address for a ``c_void_p`` argument (None: NULL)."""
    return t.data_ptr() if t is not None else None


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Sequence[int]) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_device(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises for mixed or other devices. None entries are
    skipped."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


# --- K1: tombstone row scatter-max ----------------------------------------


def scatter_max_rows_(table: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """In place: ``table[r, rows[r, j]] = max(table[r, rows[r, j]], upd[r, j])``
    for rows in [0, T); other rows are dropped. Duplicate rows are allowed.

    table i32[R, T, D], rows i32[R, B], upd i32[R, B, D]; all contiguous.
    Returns `table`."""
    R, T, D = table.shape
    B = rows.shape[-1]
    _check("table", table, I32, (R, T, D))
    _check("rows", rows, I32, (R, B))
    _check("upd", upd, I32, (R, B, D))
    if not kernel_device(table, rows, upd):
        return scatter_max_rows_plain_(table, rows, upd)
    if R * B * D == 0:
        return table
    fn = _build.load("scatter_max_rows", _K1_ARGS)
    rc = fn(_ptr(table), _ptr(rows), _ptr(upd), R, T, D, B,
            ctypes.c_void_p(cuda_stream_handle(table)))
    _build.check(rc, "scatter_max_rows")
    scatter_max_rows_.launches += 1
    return table


scatter_max_rows_.launches = 0
_K1_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]


def scatter_max_rows_plain_(table: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: a row-wise ``index_reduce_`` amax over the
    valid rows of the flattened [R*T, D] table."""
    R, T, D = table.shape
    valid = (rows >= 0) & (rows < T)
    base = torch.arange(R, device=table.device, dtype=torch.int64)[:, None] * T
    flat = (base + rows.to(torch.int64))[valid]
    table.view(R * T, D).index_reduce_(0, flat, upd[valid], "amax")
    return table


# --- K1c: tombstone row scatter-max, out of place --------------------------

K1C_MAX_D = 8192  # a block of the kernel copies at least one [D] row


def scatter_max_rows_copy(table: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Out of place: a new table ``out`` with ``out[r] = table[r]`` and
    ``out[r, rows[r, j]] = max(out[r, rows[r, j]], upd[r, j])`` for rows in
    [0, T); other rows are dropped, duplicates allowed. `table` is not
    written.

    table i32[R, T, D] with any replica stride (0 for a broadcast view)
    whose inner [T, D] block is contiguous; a table laid out otherwise is
    copied first. rows i32[R, B], upd i32[R, B, D]. Returns a contiguous
    i32[R, T, D]."""
    R, T, D = table.shape
    B = rows.shape[-1]
    if table.dtype != I32:
        raise TypeError(f"table: dtype {table.dtype}, expected {I32}")
    rows, upd = rows.contiguous(), upd.contiguous()
    _check("rows", rows, I32, (R, B))
    _check("upd", upd, I32, (R, B, D))
    if not kernel_device(table, rows, upd):
        return scatter_max_rows_copy_plain(table, rows, upd)
    if D > K1C_MAX_D:
        raise ValueError(f"the CUDA kernel takes D <= {K1C_MAX_D}, not {D}")
    out = torch.empty((R, T, D), dtype=I32, device=table.device)
    if out.numel() == 0:
        return out
    if not table[0].is_contiguous():
        table = table.contiguous()
    fn = _build.load("scatter_max_rows", _K1C_ARGS, "scatter_max_rows_copy")
    rc = fn(_ptr(table), table.stride(0), _ptr(rows), _ptr(upd), _ptr(out), R, T, D, B,
            ctypes.c_void_p(cuda_stream_handle(out)))
    _build.check(rc, "scatter_max_rows_copy")
    scatter_max_rows_copy.launches += 1
    return out


scatter_max_rows_copy.launches = 0
_K1C_ARGS = (
    [ctypes.c_void_p, ctypes.c_int64]  # table, replica stride
    + [ctypes.c_void_p] * 3  # rows, upd, out
    + [ctypes.c_int64] * 4 + [ctypes.c_void_p]  # R, T, D, B, stream
)


def scatter_max_rows_copy_plain(table: torch.Tensor, rows: torch.Tensor, upd: torch.Tensor) -> torch.Tensor:
    """Plain version of K1c: a contiguous copy of the table, then K1's
    plain version on it."""
    return scatter_max_rows_plain_(table.clone(memory_format=torch.contiguous_format), rows, upd)


# --- K3: slot sort (+ fused add-wins filter) ------------------------------


def dom_lookup(dc: torch.Tensor, rmv_vc: torch.Tensor) -> torch.Tensor:
    """Per-slot tombstone bound ``max(rmv_vc[..., dc], 0)``, and 0 for dc
    outside [0, D) (``_dom_lookup``, models/topk_rmv_dense.py:133)."""
    D = rmv_vc.shape[-1]
    inside = (dc >= 0) & (dc < D)
    got = torch.gather(rmv_vc, -1, dc.clamp(0, D - 1).to(torch.int64))
    return torch.where(inside, got.clamp_min(0), torch.zeros_like(got))


def _sides_shape(sides: Sequence[Triple]) -> Tuple[Tuple[int, ...], List[int]]:
    if not 1 <= len(sides) <= 2:
        raise ValueError("sort_slots takes one or two (score, dc, ts) sides")
    lead = tuple(sides[0][0].shape[:-1])
    widths = []
    for k, side in enumerate(sides):
        w = side[0].shape[-1]
        for name, t in zip(("score", "dc", "ts"), side):
            _check(f"side {k} {name}", t, I32, lead + (w,))
        widths.append(w)
    return lead, widths


def sort_slots(
    sides: Sequence[Triple],
    m_keep: int,
    rmv_vc: Optional[torch.Tensor] = None,
):
    """Sort each row's candidates best-first by (score desc, ts desc, dc
    asc), blank exact duplicates with ts > 0, keep the best `m_keep`.

    `sides` is one or two (score, dc, ts) triples of i32[..., w] with
    the same leading shape; the row's candidates are side a's w_a
    followed by side b's w_b (W = w_a + w_b). On a card, rows of W <=
    MAX_SLOTS count in ``launches`` (a thread a row up to 8, a half-warp
    up to 16), wider rows up to WIDE_MAX_SLOTS in ``wide_launches`` (a
    warp a row up to WARP_MAX_SLOTS = 256; above, the row paths, whose
    launches up to WIDE_MAX_SLOTS also count in ``block_launches``), and
    wider rows up to GLOBAL_MAX_SLOTS in ``global_launches``. The row
    paths cut a row into tiles of ``row_tile(W)`` candidates, many
    blocks a row; a row wider than its tile is merged through a device
    scratch of at most GLOBAL_SCRATCH_BYTES per chunk of rows. The plain
    version takes any W. With `rmv_vc` i32[..., D] the add-wins filter
    ``ts > dom_lookup(dc, rmv_vc)`` runs first and filtered candidates rank
    after every live one: for two sides that each keep the slot
    invariant this is the union join (``_join_slots_union``); without
    it, ``sort_slots_pallas``.

    Returns (score, dc, ts) i32[..., m_keep] and n_live i32[...], the
    number of slots with ts > 0 before truncation."""
    lead, widths = _sides_shape(sides)
    W = sum(widths)
    if not 1 <= m_keep <= W:
        raise ValueError(f"need 1 <= m_keep ({m_keep}) <= W ({W})")
    flat = [t for side in sides for t in side]
    if rmv_vc is not None:
        _check("rmv_vc", rmv_vc, I32, lead + (rmv_vc.shape[-1],))
    if not kernel_device(*flat, rmv_vc):
        return sort_slots_plain(sides, m_keep, rmv_vc)
    if W > GLOBAL_MAX_SLOTS:
        raise ValueError(f"the CUDA kernel takes W <= {GLOBAL_MAX_SLOTS} candidates per row, not {W}")
    dev = flat[0].device
    # One allocation for the three slot outputs (disjoint contiguous views):
    # allocations are most of the wrapper's host time on a short call.
    o_s, o_d, o_t = torch.empty((3,) + lead + (m_keep,), dtype=I32, device=dev).unbind(0)
    n_live = torch.empty(lead, dtype=I32, device=dev)
    N = n_live.numel()
    if N == 0:
        return o_s, o_d, o_t, n_live
    a = sides[0]
    b = sides[1] if len(sides) == 2 else (None, None, None)
    wb = widths[1] if len(sides) == 2 else 0
    D = rmv_vc.shape[-1] if rmv_vc is not None else 0
    args = [
        _ptr(a[0]), _ptr(a[1]), _ptr(a[2]), widths[0],
        _ptr(b[0]), _ptr(b[1]), _ptr(b[2]), wb,
        _ptr(rmv_vc), D,
        _ptr(o_s), _ptr(o_d), _ptr(o_t), _ptr(n_live),
        N, m_keep,
    ]
    stream = ctypes.c_void_p(cuda_stream_handle(o_s))
    if W <= WARP_MAX_SLOTS:
        symbol, counter = ("sort_slots", "launches") if W <= MAX_SLOTS else ("sort_slots_wide", "wide_launches")
        rc = _build.load("sort_slots", _K3_ARGS + [ctypes.c_void_p], symbol)(*args, stream)
    else:
        # The row paths: tiles of T candidates; a row wider than one tile
        # is merged through a scratch of 2W + ceil(W / ROW_SPAN) 16-byte
        # cells, rows in chunks whose scratch stays within
        # GLOBAL_SCRATCH_BYTES.
        symbol = "sort_slots_rows"
        counter = "block_launches" if W <= WIDE_MAX_SLOTS else "global_launches"
        tile = row_tile(W)
        scratch, chunk = None, N
        if W > tile:
            row_bytes = 16 * (2 * W + -(-W // ROW_SPAN))
            chunk = max(1, min(N, GLOBAL_SCRATCH_BYTES // row_bytes))
            scratch = torch.empty(chunk * row_bytes, dtype=torch.uint8, device=dev)
        fn = _build.load("sort_slots", _K3_ARGS + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p],
                         symbol)
        rc = fn(*args, tile, _ptr(scratch), chunk, stream)
    _build.check(rc, symbol)
    setattr(sort_slots, counter, getattr(sort_slots, counter) + 1)
    if WARP_MAX_SLOTS < W <= WIDE_MAX_SLOTS:
        sort_slots.wide_launches += 1
    return o_s, o_d, o_t, n_live


def row_tile(W: int) -> int:
    """The tile T of K3's row paths (W > WARP_MAX_SLOTS) for rows of W
    candidates: the whole row, padded to a power of
    two, while it fits one block's shared memory (one launch, no
    scratch), else ROW_TILE candidates: the fastest choices at
    chip_smoke.py phase 8's calls (``utils/time_k3.py --tiles``)."""
    P = 1 << (W - 1).bit_length()
    return P if P <= ROW_TILE_MAX else ROW_TILE


sort_slots.launches = 0
sort_slots.wide_launches = 0
sort_slots.block_launches = 0
sort_slots.global_launches = 0
_K3_ARGS = (
    [ctypes.c_void_p] * 3 + [ctypes.c_int]  # side a, w_a
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]  # side b, w_b
    + [ctypes.c_void_p, ctypes.c_int]  # rmv_vc, D
    + [ctypes.c_void_p] * 4  # outputs
    + [ctypes.c_int64, ctypes.c_int]  # N, m_keep
)  # then the stream; sort_slots_rows takes the tile, scratch and chunk rows before it


def _slot_order(live, s, t, d):
    """Permutation sorting each row best-first by (live desc, score desc,
    ts desc, dc asc), compared directly: two stable sorts of exactly
    packed int64 key pairs, the minor pair first (``~x`` is -1 - x, so
    ascending ``~x`` is descending x with no overflow)."""
    low = (~t).to(torch.int64) * 2**32 + (d.to(torch.int64) + 2**31)
    high = (-live).to(torch.int64) * 2**32 + ((~s).to(torch.int64) + 2**31)
    p1 = torch.sort(low, dim=-1, stable=True).indices
    p2 = torch.sort(torch.gather(high, -1, p1), dim=-1, stable=True).indices
    return torch.gather(p1, -1, p2)


def sort_slots_plain(
    sides: Sequence[Triple],
    m_keep: int,
    rmv_vc: Optional[torch.Tensor] = None,
):
    """Plain version of K3, for any W: filter, sort, blank the duplicates,
    sort again, with torch sorts over each row's W candidates.

    The order is (live desc, score desc, ts desc, dc asc); without a
    filter every candidate is live, so it is the TPU kernel's direct
    (score, ts, dc) compare (``_cmpx_desc``). Equal candidates are equal
    in all four keys, so any correct sort gives the kernel's rows."""
    s = torch.cat([side[0] for side in sides], -1)
    d = torch.cat([side[1] for side in sides], -1)
    t = torch.cat([side[2] for side in sides], -1)
    fused = rmv_vc is not None
    live = torch.ones_like(s)
    if fused:
        ok = t > dom_lookup(d, rmv_vc)
        s = torch.where(ok, s, NEG_INF)
        d = torch.where(ok, d, 0)
        t = torch.where(ok, t, 0)
        live = ok.to(I32)

    def ordered(cols):
        perm = _slot_order(*cols)
        return [torch.gather(c, -1, perm) for c in cols]

    live, s, t, d = ordered((live, s, t, d))
    prev_same = (s[..., 1:] == s[..., :-1]) & (t[..., 1:] == t[..., :-1]) & (d[..., 1:] == d[..., :-1])
    dup = torch.cat([torch.zeros_like(t[..., :1], dtype=torch.bool), prev_same], -1) & (t > 0)
    s = torch.where(dup, NEG_INF, s)
    d = torch.where(dup, 0, d)
    t = torch.where(dup, 0, t)
    if fused:
        live = torch.where(dup, 0, live)
    live, s, t, d = ordered((live, s, t, d))
    n_live = (t > 0).sum(-1, dtype=I32)
    return s[..., :m_keep].contiguous(), d[..., :m_keep].contiguous(), t[..., :m_keep].contiguous(), n_live
