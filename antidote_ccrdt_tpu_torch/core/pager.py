"""The pager's spill-file names (from ``antidote_ccrdt_tpu/core/pager.py``).

Only what WAL recovery needs: ``ElasticWal.recover`` deletes every pager
spill file under its directory before it rebuilds the state, whether or
not a pager ran. The pager itself (a CUDA-memory budget over partitions,
the cold tier in pinned host tensors) is ROADMAP A11.
"""

from __future__ import annotations

import os
from typing import Optional

SPILL_PREFIX = "pagercold-"


def discard_spill(spill_dir: Optional[str]) -> int:
    """Delete every pager spill file under `spill_dir`. Called on pager
    construction AND from WAL recovery: spill blobs are a cache of
    state that is durable elsewhere, and a file left by a SIGKILLed
    predecessor may be torn mid-write — recovery must rebuild
    all-resident from WAL/checkpoint, never resurrect a spill blob."""
    if not spill_dir or not os.path.isdir(spill_dir):
        return 0
    n = 0
    for fn in os.listdir(spill_dir):
        if fn.startswith(SPILL_PREFIX):
            try:
                os.unlink(os.path.join(spill_dir, fn))
                n += 1
            except OSError:
                pass
    return n
