"""CPU time of the plain K3 (``ops.kernels.sort_slots_plain``) at the
replay's row width W = 8: two canonical sides of M = 4 slots with the
add-wins filter fused, as the dense engine's merge calls it. This is the
path the port's ``device="cpu"`` entry points run.

    python antidote_ccrdt_tpu_torch/utils/cpu_time_plain_k3.py [--root CHECKOUT] [--rows N] [--threads T]

``--root`` names the checkout whose package is timed (default: the one
holding this file), so two versions of the plain K3 can be timed on one
machine. Prints one JSON line: the median and minimum seconds of
``--reps`` calls after one untimed call.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from antidote_ccrdt_tpu_torch.ops import kernels
    from antidote_ccrdt_tpu_torch.ops.dense_table import NEG_INF

    torch.set_num_threads(args.threads)
    g = torch.Generator().manual_seed(1)
    M, D, shape = 4, 32, (args.rows, 4)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int32)

    def side():
        ts = torch.where(ri(0, 4, shape) == 0, 0, ri(1, 1 << 20, shape))
        sc = torch.where(ts > 0, ri(1, 100_000, shape), NEG_INF).to(torch.int32)
        dc = torch.where(ts > 0, ri(0, D, shape), 0).to(torch.int32)
        return kernels.sort_slots_plain([(sc, dc, ts.to(torch.int32))], M)[:3]

    sides = [side(), side()]
    rmv_vc = ri(0, 1 << 20, (args.rows, D))
    kernels.sort_slots_plain(sides, M, rmv_vc)
    secs = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        kernels.sort_slots_plain(sides, M, rmv_vc)
        secs.append(time.perf_counter() - t0)
    print(json.dumps(dict(
        root=os.path.basename(os.path.abspath(args.root)), rows=args.rows, W=2 * M, D=D,
        threads=torch.get_num_threads(), machine=platform.machine(), torch=torch.__version__,
        median_s=statistics.median(secs), min_s=min(secs),
    )))


if __name__ == "__main__":
    main()
