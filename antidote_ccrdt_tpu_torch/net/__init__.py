"""net/: pluggable gossip anti-entropy transports.

The failure-tolerant tier (`parallel.elastic`) exchanges lattice states
and join-decomposed deltas between members. A shared filesystem
directory (`GossipStore`) is fine for single-host drills and a
non-starter for multi-DC traffic, so this package makes the medium
pluggable behind a small blob-plane `Transport`
protocol:

* `net.transport`  — the `Transport` protocol, the filesystem
  implementation (`FsTransport`), and `GossipNode`, the state-plane
  facade every `parallel.elastic` entry point speaks.
* `net.tcp`        — a real TCP peer: `{packet,4}` ETF frames (the
  bridge's framing), per-peer connection cache with exponential backoff
  + jitter, bounded send queues with a drop-oldest-delta-keep-anchor
  policy.
* `net.membership` — SWIM-style liveness: heartbeats piggybacked on
  every frame, suspect -> confirm-dead timeouts, alive set feeding the
  deterministic `parallel.elastic.owners` assignment.
* `net.sim`        — a deterministic in-process simulator (seeded RNG,
  virtual clock; latency / loss / duplication / partitions / crashes)
  for replay-exact chaos tests.

Both peer transports (`TcpTransport`, `SimTransport`) can trade the
default full mesh for the DCN-aware zone topology in `topo/` via
`install_router()` — leaves gossip intra-zone, per-zone rendezvous
anchors relay across zones, frames compress per-link (see `topo/`).

This is the port of the JAX package's ``net/``: the same module names,
public names, wire bytes, counters and seeded draws, so a mixed fleet of
both packages gossips to one digest. Blobs stay bytes on the transports'
threads; `GossipNode` decodes them on the caller's thread, onto the
device of the state it is given.
"""

from .membership import Membership
from .sim import SimNet, SimTransport
from .tcp import TcpTransport
from .transport import FsTransport, GossipNode, Transport

__all__ = [
    "Transport",
    "FsTransport",
    "GossipNode",
    "Membership",
    "TcpTransport",
    "SimNet",
    "SimTransport",
]
