"""chip_smoke.py's replay main path (phase 4) on a CUDA card, for one
checkout, so that two versions of the package can be run in turns under
the same driver code.

    python antidote_ccrdt_tpu_torch/utils/time_main_path.py [--root CHECKOUT]

Runs phases 1-5 of the chip_smoke.py that sits at the root of the tree
holding this file (device, build, kernels, main path, profile) on the
package of ``--root`` (default: that same tree). Phase 3's inputs stay
allocated through phases 4 and 5, and phase 4 collects garbage just
before its rounds, as in a whole chip_smoke.py run. Prints the phases'
lines (phase 4's: every round's ms, p50, sync ms, merges/s; phase 5's:
device busy ms and idle share), then one JSON line naming the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_main_path: no CUDA device")
    card = smoke.phase_device(torch)
    smoke.phase_build()
    _rows, device_jobs = smoke.phase_kernels(torch)
    _launches, rp, gen = smoke.phase_main_path(torch, card)
    smoke.phase_profile(torch, rp, gen.next_batch(smoke.B, smoke.BR))
    del device_jobs
    import antidote_ccrdt_tpu_torch

    print(json.dumps({"root": root, "package": os.path.dirname(antidote_ccrdt_tpu_torch.__file__), "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
