"""Time K3 (``ops.kernels.sort_slots``) on a CUDA card at the calls
chip_smoke.py makes, for one checkout.

    python antidote_ccrdt_tpu_torch/utils/time_k3.py [--root CHECKOUT] [--reps N]
        [--calls north,wide] [--tiles 0,1024,4096]

``north``: the calls of the north-star ``batch_merge("topk_rmv", 32
states)`` (chip_smoke.py phase 7: 32 states, one DC each, 8 192 adds and
512 removals over 100 000 ids, seed 13): the converter's call on the raw
host-order tables (W = M, unfused), each fold level's join (W = 2M, fused,
both sides canonical), and K3 at W = 8 fused on chip_smoke.py phase 3's rows
(32 x 100 000 rows of two canonical 4-slot sides, D = 32).

``wide``: phase 8's four calls, the converter's (unfused, raw) and the
first fold level's (fused, two canonical sides) at capacities M = 8 400
(W = 8 400 and 16 800: the global path) and M = 2 000 (W = 2 000 and
4 000: the block path), and the many-row call: 65 536 rows of two
canonical 256-slot sides (W = 512) against D = 32 tombstones, fused.

Each time is the mean of `--reps` calls by CUDA events after three warm-up
calls (Python's garbage collector held off, as ``utils.benchtime`` does),
the device time of every K3 kernel a call launches under torch.profiler,
and the host time to issue a call. The timing is this script's own
whatever the checkout: ``--root`` names the checkout whose package is
timed, so that two versions can be timed in turns on one card. ``--tiles``
times the row paths' calls (W > 256) once per tile, where the package
picks its tile with ``kernels.row_tile`` (0: the package's own choice).
Prints the card's nvidia-smi name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import re
import subprocess
import sys
import time

# The many-row call: rows, slots a side, tombstone width.
MANY_ROWS, MANY_M, MANY_D = 65_536, 256, 32


def device_ms(torch, fn, reps: int, kernel: str = r"sort_slots\w*") -> float:
    """Mean device time per call of `fn` of the CUDA kernels whose names
    match `kernel` (a regular expression), from torch.profiler (launch and
    host time excluded): each kernel's mean time per recorded launch times
    its launches per call, summed over the kernels. torch.profiler drops
    kernel records now and then, at times all of a session's: a session
    that recorded none is run again, up to three times, and a kernel's
    launches per call are its recorded launches over the calls, rounded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and re.search(rf"\b{kernel}\b", e.key)]
        if sum(e.self_device_time_total for e in hits) > 0:
            break
    else:
        raise AssertionError(f"the profiler saw no device time of {kernel} in three sessions")
    if any(e.count % reps for e in hits):
        print(f"[device times] note: the profiler recorded {[e.count for e in hits]} launches of {kernel} "
              f"in {reps} calls", flush=True)
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / reps)) for e in hits) / 1e3


def canonical_sides(torch, kernels, g, lead, m, D):
    """Two sides of `m` slots that keep the slot invariant (K3's own
    output on seeded draws, a quarter of the slots empty), and a
    tombstone table of width D."""
    from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF

    dev = torch.device("cuda")

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def side():
        ts = torch.where(ri(0, 4, lead + (m,)) == 0, 0, ri(1, 1 << 20, lead + (m,)))
        sc = torch.where(ts > 0, ri(1, 100_000, lead + (m,)), NEG_INF).to(torch.int32)
        dc = torch.where(ts > 0, ri(0, D, lead + (m,)), 0).to(torch.int32)
        return kernels.sort_slots_plain([(sc, dc, ts.to(torch.int32))], m)[:3]

    return [side(), side()], ri(0, 1 << 20, lead + (D,))


def north_calls(torch, kernels, timed, dev):
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss

    effects = ss.topk_rmv_effects(32, 100_000, 8_192, 512, seed=13)
    states = [ss.topk_rmv_direct(e, 100) for e in effects]
    del effects
    raw = bm.topk_rmv_tables(states, dev)[0]
    dense, batch, ids, _ = bm.topk_rmv_to_dense(states, dev)
    M = dense.M
    side = [(raw.slot_score, raw.slot_dc, raw.slot_ts)]
    out = dict(M=M, ids=len(ids),
               convert=dict(W=M, rows=raw.slot_ts.numel() // M, **timed(lambda: kernels.sort_slots(side, M))))
    del raw, side
    levels, n = [], batch.slot_ts.shape[0]
    while n > 1:
        half = n // 2
        lhs = bm._tree_map(lambda x: x[:half], batch)
        rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
        rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
        sides = [(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)]
        levels.append(dict(n=n, W=2 * M, rows=rmv.numel() // rmv.shape[-1],
                           **timed(lambda: kernels.sort_slots(sides, M, rmv_vc=rmv))))
        batch = dense.merge(lhs, rhs)
        n = half
    out["levels"] = levels
    del batch, lhs, rhs, rmv, sides, dense, states
    g = torch.Generator(device=dev).manual_seed(1)
    sides8, rmv8 = canonical_sides(torch, kernels, g, (32, 1, 100_000), 4, 32)
    out["replay_w8_fused"] = timed(lambda: kernels.sort_slots(sides8, 4, rmv_vc=rmv8))
    return out


def wide_calls(torch, kernels, timed, dev):
    """Phase 8's calls and the many-row call: {label: (call, W, rows)}."""
    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss

    calls = {}
    for m, path in ((8_400, "global"), (2_000, "block")):
        states = ss.topk_rmv_capacity_states(m)
        raw = bm.topk_rmv_tables(states, dev)[0]
        _, batch, _, _ = bm.topk_rmv_to_dense(states, dev)
        half = batch.slot_ts.shape[0] // 2
        lhs = bm._tree_map(lambda x: x[:half], batch)
        rhs = bm._tree_map(lambda x: x[half:2 * half], batch)
        rmv = torch.maximum(lhs.rmv_vc, rhs.rmv_vc)
        side = [(raw.slot_score, raw.slot_dc, raw.slot_ts)]
        sides = [(lhs.slot_score, lhs.slot_dc, lhs.slot_ts), (rhs.slot_score, rhs.slot_dc, rhs.slot_ts)]
        calls[f"{path}_convert"] = (lambda s=side, m=m: kernels.sort_slots(s, m), m, raw.slot_ts.numel() // m)
        calls[f"{path}_fold"] = (lambda s=sides, m=m, v=rmv: kernels.sort_slots(s, m, rmv_vc=v), 2 * m,
                                 rmv.numel() // rmv.shape[-1])
    g = torch.Generator(device=dev).manual_seed(2)
    many, rmv_many = canonical_sides(torch, kernels, g, (MANY_ROWS,), MANY_M, MANY_D)
    calls["many_rows_fold"] = (lambda: kernels.sort_slots(many, MANY_M, rmv_vc=rmv_many), 2 * MANY_M, MANY_ROWS)
    return calls


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--calls", default="north,wide")
    ap.add_argument("--tiles", default="0")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from antidote_ccrdt_tpu_torch.ops import _build, kernels

    if not torch.cuda.is_available():
        raise SystemExit("time_k3: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    def events_ms(fn):
        for _ in range(3):
            fn()
        gc.collect()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        gc.disable()
        try:
            start.record()
            for _ in range(args.reps):
                fn()
            end.record()
            end.synchronize()
        finally:
            gc.enable()
        return start.elapsed_time(end) / args.reps

    def issue_ms(fn):
        """Host time per call to issue `fn` (its checks, allocations and
        launches), the card not waited for inside the region."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / args.reps

    def timed(fn):
        return dict(ms=events_ms(fn), device_ms=device_ms(torch, fn, args.reps),
                    issue_ms=issue_ms(fn))

    out = dict(root=os.path.basename(os.path.abspath(args.root)), card=smi)
    groups = args.calls.split(",")
    if "north" in groups:
        out.update(north_calls(torch, kernels, timed, dev))
    if "wide" in groups:
        own_tile = getattr(kernels, "row_tile", None)
        tiles = [int(x) for x in args.tiles.split(",")] if own_tile else [0]
        for label, (call, W, rows) in wide_calls(torch, kernels, timed, dev).items():
            by_tile = {}
            for tile in tiles:
                if tile:
                    kernels.row_tile = lambda w, tile=tile: tile
                by_tile[str(tile or "own")] = timed(call)
                if own_tile:
                    kernels.row_tile = own_tile
            out[label] = dict(W=W, rows=rows, **(by_tile["own"] if list(by_tile) == ["own"] else by_tile))
    log = _build.BUILD_LOG.get("sort_slots", "")  # filled when this process built the library
    out["ptxas"] = {
        re.search(r"'(\w+)'", part).group(1): " ".join(re.findall(r"Used \d+ registers|\d+ bytes spill \w+", part))
        for part in log.split("Compiling entry function")[1:]
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
