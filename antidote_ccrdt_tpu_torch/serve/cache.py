"""Hot-key answer cache: computed answers survive snapshot swaps.

The cheap tier of the serving plane. A computed answer is immutable for
the snapshot it was computed at, so it stays servable AFTER the replica
swaps forward — at a staleness cost that grows with age. Each entry is
``(value, as_of_seq)``; the plane recomputes the entry's staleness
bound from its snapshot's swap pedigree at every serve, and the
`max_staleness` query knob decides whether the aged entry still
qualifies or the query falls through to the fresh replica (re-filling
the entry at the new seq).

Bounded two ways: LRU capacity (`serve.cache_evictions`), and a seq
horizon — the plane retains swap pedigree for only the last few seqs,
and `purge_below` drops entries whose pedigree is gone (an answer whose
staleness can no longer be bounded must not be served).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Tuple


class HotKeyCache:
    """LRU of canonical query answers tagged with their snapshot seq.

    Keys are `kernels.query_key` tuples; values are (answer, as_of_seq).
    Thread-safety is provided by the plane's batcher (single drainer at
    a time), so no lock here.
    """

    def __init__(self, cap: int = 1024, metrics: Any = None):
        self.cap = max(1, int(cap))
        self.metrics = metrics
        self._entries: "OrderedDict[Tuple, Tuple[Any, int]]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Tuple) -> Optional[Tuple[Any, int]]:
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
        return hit

    def put(self, key: Tuple, value: Any, seq: int) -> None:
        self._entries[key] = (value, int(seq))
        self._entries.move_to_end(key)
        while len(self._entries) > self.cap:
            self._entries.popitem(last=False)
            if self.metrics is not None:
                self.metrics.count("serve.cache_evictions")

    def purge_below(self, min_seq: int) -> int:
        """Drop entries older than the plane's pedigree horizon; returns
        how many were dropped."""
        stale = [k for k, (_, s) in self._entries.items() if s < min_seq]
        for k in stale:
            del self._entries[k]
        return len(stale)
