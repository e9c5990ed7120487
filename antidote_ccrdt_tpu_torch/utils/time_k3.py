"""Time K3 (``ops.kernels.sort_slots``) on a CUDA card at the calls the
north-star ``batch_merge("topk_rmv", 32 states)`` makes, and at the
replay's W = 8, for one checkout.

    python antidote_ccrdt_tpu_torch/utils/time_k3.py [--root CHECKOUT] [--reps N]

The states are chip_smoke.py phase 7's (32 states, one DC each, 8 192
adds and 512 removals over 100 000 ids, seed 13). Timed: the converter's
call on the raw host-order tables (W = M, unfused), each fold level's join
(W = 2M, fused, both sides canonical), and K3 at W = 8 fused on chip_smoke.py
phase 3's rows (32 x 100 000 rows of two canonical 4-slot sides, D = 32).
Each time is the mean of `--reps` launches by CUDA events after three
warm-up calls, and the device time of the K3 kernels per call under
torch.profiler. ``--root`` names the checkout whose package is timed, so
that two versions can be timed in turns on one card. Prints the card's
nvidia-smi name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def device_ms(torch, fn, reps: int) -> float:
    """Device time per call of the K3 kernels that `fn` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and "sort_slots" in e.key)
    return us / 1e3 / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from antidote_ccrdt_tpu_torch.core import batch_merge as bm
    from antidote_ccrdt_tpu_torch.harness import scalar_states as ss
    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF
    from antidote_ccrdt_tpu_torch.utils.benchtime import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("time_k3: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")

    def timed(fn):
        return dict(ms=cuda_time_ms(fn, reps=args.reps), device_ms=device_ms(torch, fn, args.reps))

    effects = ss.topk_rmv_effects(32, 100_000, 8_192, 512, seed=13)
    states = [ss.topk_rmv_direct(e, 100) for e in effects]
    del effects
    raw = bm.topk_rmv_tables(states, dev)[0]
    dense, batch, ids, _ = bm.topk_rmv_to_dense(states, dev)
    M = dense.M
    side = [(raw.slot_score, raw.slot_dc, raw.slot_ts)]
    out = dict(root=os.path.basename(os.path.abspath(args.root)), card=smi, M=M, ids=len(ids),
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
    lead, m, D = (32, 1, 100_000), 4, 32

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev, dtype=torch.int32)

    def canonical():
        ts = torch.where(ri(0, 4, lead + (m,)) == 0, 0, ri(1, 1 << 20, lead + (m,)))
        sc = torch.where(ts > 0, ri(1, 100_000, lead + (m,)), NEG_INF).to(torch.int32)
        dc = torch.where(ts > 0, ri(0, D, lead + (m,)), 0).to(torch.int32)
        return kernels.sort_slots_plain([(sc, dc, ts.to(torch.int32))], m)[:3]

    sides8 = [canonical(), canonical()]
    rmv8 = ri(0, 1 << 20, lead + (D,))
    out["replay_w8_fused"] = timed(lambda: kernels.sort_slots(sides8, m, rmv_vc=rmv8))
    from antidote_ccrdt_tpu_torch.ops import _build

    log = _build.BUILD_LOG.get("sort_slots", "")  # filled when this process built the library
    out["ptxas"] = {
        re.search(r"'(\w+)'", part).group(1): " ".join(re.findall(r"Used \d+ registers|\d+ bytes spill \w+", part))
        for part in log.split("Compiling entry function")[1:]
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
