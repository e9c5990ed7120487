"""Real-socket gossip drill worker: the elastic drill over TCP.

    python -m antidote_ccrdt_tpu_torch.scripts.net_gossip_demo --root DIR --member w0 --n-members 3
        [--die-at N] [--delta] [--device cpu|cuda] [--report FILE] [--hold]

Port of ``scripts/net_gossip_demo.py``: the drill of ``elastic_demo.py``
(deterministic op streams, ownership-grows adoption, convergence to the
sequential reference) over ``net.tcp.TcpTransport`` — real localhost
sockets, SWIM membership from piggybacked ages, bounded send queues with
backoff — instead of a shared directory. The shared directory is still
used for two non-gossip jobs only: address rendezvous (each worker binds
port 0 and publishes `addr-<member>`; a poller thread adds peers as their
files appear, so late joiners are discovered too) and the
`final-<member>.json` result drop the supervising test reads.

The port's own options (``--device``, ``--shape``, ``--report``,
``--hold``, ``--settle-s``, ``--local``) are elastic_demo.py's. A north-star anchor
(563 MB) is past ``MAX_FRAME``: over TCP the drill runs at the demo's
width or a narrower ``--shape``.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.scripts.elastic_demo import (  # noqa: E402
    DRILLS,
    Report,
    add_port_args,
    drills,
    on_device,
    run_worker,
    worker_setup,
)


def _write_addr(root: str, member: str, addr, zone: str = "") -> None:
    path = os.path.join(root, f"addr-{member}")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        # "host:port" or "host:port zone" — the optional zone token rides
        # the rendezvous file so peers learn topology before first contact
        # (the hello exchange re-teaches it). Readers that split on ":"
        # never see the zone.
        f.write(f"{addr[0]}:{addr[1]} {zone}".rstrip())
    os.replace(tmp, path)


def _read_addrs(root: str) -> dict:
    out = {}
    for fn in os.listdir(root):
        if not fn.startswith("addr-") or ".tmp" in fn:
            continue
        try:
            with open(os.path.join(root, fn)) as f:
                text = f.read().strip()
            hostport, _, zone = text.partition(" ")
            host, port = hostport.rsplit(":", 1)
            out[fn[len("addr-"):]] = (host, int(port), zone.strip())
        except (OSError, ValueError):
            continue  # torn write: next poll sees it whole
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="rendezvous + results directory (NOT the gossip medium — that is TCP)")
    ap.add_argument("--member", required=True)
    ap.add_argument("--n-members", type=int, required=True)
    ap.add_argument("--type", default="topk_rmv", choices=sorted(DRILLS))
    ap.add_argument("--die-at", type=int, default=-1)
    ap.add_argument("--join-late", type=float, default=0.0)
    ap.add_argument("--hb-interval", type=float, default=0.05)
    ap.add_argument("--timeout", type=float, default=0.4)
    ap.add_argument("--step-sleep", type=float, default=0.15)
    ap.add_argument("--publish-every", type=int, default=2)
    ap.add_argument("--delta", action="store_true")
    ap.add_argument("--partitions", type=int, default=0,
                    help="arm the partition plane + divergence watchdog (see elastic_demo.py --partitions); "
                    "0 disables")
    ap.add_argument("--overlap", dest="overlap", action="store_true", default=None,
                    help="overlapped round pipeline (parallel/overlap.py); default on unless CCRDT_OVERLAP=0 — "
                    "see elastic_demo.py")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false", help="force the serial round loop")
    ap.add_argument("--queue-max", type=int, default=64)
    ap.add_argument("--zone", default="", help="DCN zone label for topo/ routing (default: flat single-zone fleet)")
    ap.add_argument("--topo", action="store_true",
                    help="install the zone router: gossip intra-zone only, the per-zone rendezvous anchor relays "
                    "across zones")
    ap.add_argument("--lag-anchor-ops", type=float, default=0.0,
                    help="lag-driven backpressure threshold in ops (needs --delta); 0 disables — see "
                    "elastic_demo.py")
    ap.add_argument("--wal-dir", default="",
                    help="arm the per-worker crash WAL (harness/wal.py) under this directory — see elastic_demo.py")
    ap.add_argument("--wal-segment-bytes", type=int, default=256 << 10)
    ap.add_argument("--steps", type=int, default=0,
                    help="per-worker step count override (0 = the 10-step default; every member must agree)")
    add_port_args(ap)
    args = ap.parse_args(argv)
    dev, geo = worker_setup(args)  # faults too: the same plans drive tcp.send and bridge.read here

    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport
    from antidote_ccrdt_tpu_torch.net.transport import GossipNode
    from antidote_ccrdt_tpu_torch.obs import spans as obs_spans

    # Arm the span plane BEFORE the transport exists: the hello exchange on
    # each fresh peer socket carries the NTP-style clock echo, and those
    # first offsets align this worker's timeline in the merged trace.
    obs_spans.install_from_env(args.member)

    with on_device(dev, args.local):
        report = Report(args, dev)
        drill = drills(dev, geo)[args.type]
        dense = drill.make_engine()
        state = drill.init(dense)

        os.makedirs(args.root, exist_ok=True)
        transport = TcpTransport(args.member, queue_max=args.queue_max, zone=args.zone or None)
        if args.topo:
            transport.install_router(args.timeout)

        if args.join_late > 0:
            # Warm up first, register (addr file + first pings) after the
            # delay — the same late-join discipline as the fs drill.
            state = drill.apply(dense, state, 0, [])
            time.sleep(args.join_late)
        _write_addr(args.root, args.member, transport.address, args.zone)

        def discover():
            while True:
                for name, (host, port, zone) in _read_addrs(args.root).items():
                    if zone:
                        transport.learn_zone(name, zone)
                    transport.add_peer(name, (host, port))  # no-op for self/known
                time.sleep(0.05)

        threading.Thread(target=discover, daemon=True).start()

        store = GossipNode(transport)
        run_worker(store, drill, dense, state, args, result_dir=args.root, report=report)


if __name__ == "__main__":
    main()
