"""topo/: DCN-aware hierarchical gossip topology.

The `net/` tier gossips full-mesh: every delta crosses the (expensive,
high-latency) data-center network once per remote peer, so cross-DCN
traffic grows O(peers) — the scaling wall the ROADMAP names first. This
package layers a zone-aware topology UNDER the transports:

* `topo.zones`  — zone labels (`dc0`, `dc0/slice1`, ... from env or
  config) and the `ZoneMap` every node keeps of who lives where,
  learned from config, hello frames, and relay path stamps.
* `topo.anchor` — deterministic rendezvous-hash anchor election: one
  member per zone carries that zone's cross-DCN traffic. Stable under
  churn (removing a non-anchor never moves the anchor) and coordination-
  free (every member computes it locally from its own alive view).
* `topo.router` — the routing policy transports consult instead of the
  flat peer list: leaves gossip only intra-zone; anchors additionally
  relay to remote-zone anchors; relayed frames carry a (member, zone)
  hop stamp so no zone is ever entered twice (loop-free) and the flight
  log can reconstruct `leaf -> anchor -> anchor -> leaf` paths.
* `topo.codec`  — per-link delta-frame compression: a codec byte ahead
  of the ETF payload (0 = raw, 1 = zlib), negotiated per-link at hello
  so mixed fleets interop; default policy compresses cross-zone links
  only (intra-zone links are cheap, the DCN is not).

Correctness never depends on the topology: blobs land in the same
transport caches, anti-entropy stays join-based above, and a member with
an unknown zone simply degrades to full-mesh treatment. The topology
only changes WHERE frames travel — convergence is still pinned to the
full-mesh baseline digest by tests/test_topo_chaos.py and
`make topo-demo`.

This package must not import from `net/` (the transports import us).
"""

from .anchor import anchor_rank, rendezvous_anchor, rendezvous_order
from .codec import (
    CODEC_RAW,
    CODEC_ZLIB,
    decode_body,
    encode_frame,
    unpack_coded_frames,
)
from .router import ZoneRouter
from .zones import ENV_ZONE, UNKNOWN_ZONE, ZoneMap, zone_from_env

__all__ = [
    "ENV_ZONE",
    "UNKNOWN_ZONE",
    "ZoneMap",
    "zone_from_env",
    "anchor_rank",
    "rendezvous_anchor",
    "rendezvous_order",
    "ZoneRouter",
    "CODEC_RAW",
    "CODEC_ZLIB",
    "encode_frame",
    "decode_body",
    "unpack_coded_frames",
]
