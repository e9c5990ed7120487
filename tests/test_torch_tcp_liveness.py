"""The port's `TcpTransport` against JAX's on relayed liveness.

Every frame carries its sender's last-heard ages, taken when the frame is
encoded. A large frame lands seconds later, and a ping read behind one
waits as long, so the ages make the members they name that much fresher;
passed from peer to peer they keep a dead member alive while large frames
flow. JAX's transport takes them as they stand. The port takes relayed
ages from pings only, each aged by how long it waited in the receiver
(``_read_conn``'s ``waited_s``): a member that stops is confirmed dead on
time while the others keep gossiping large frames.
"""

import importlib
import os
import struct
import threading
import time

import pytest

FRAME_MB, PUBLISH_S, BEAT_S, TIMEOUT_S = 16, 0.1, 0.05, 0.5


def _silent(t, member: str, seconds: float) -> None:
    t.membership.last_heard[member] = t.membership.now() - seconds


@pytest.mark.parametrize("package", ["antidote_ccrdt_tpu", "antidote_ccrdt_tpu_torch"])
def test_a_snapshot_frames_ages_refresh_a_silent_member_only_in_jax(package):
    """A member silent for 10 s, then a snapshot frame from b that says b
    heard it 0.1 s ago: JAX's transport takes it as 0.1 s old; the port's
    keeps the member 10 s silent, and takes the same age from a ping as
    0.1 s plus the ping's wait."""
    tcp = importlib.import_module(f"{package}.net.tcp")
    t = tcp.TcpTransport("a")
    try:
        _silent(t, "v", 10.0)
        heard = {b"b": 0.0, b"v": 0.1}
        t._handle((tcp.A_SNAP, b"b", struct.pack("<Q", 1) + b"state", heard))
        age = t.membership.now() - t.membership.last_heard["v"]
        if package == "antidote_ccrdt_tpu":
            assert age < 1.0
        else:
            assert age > 9.9
            t._handle((tcp.A_PING, b"b", heard), waited_s=3.0)
            assert 3.0 < t.membership.now() - t.membership.last_heard["v"] < 4.0
        assert t.membership.now() - t.membership.last_heard["b"] < 1.0  # the sender itself, heard directly
    finally:
        t.close()


def test_a_stopped_member_is_confirmed_dead_on_time_while_large_frames_flow():
    """Four port transports, all linked; v stops, and a, b and c go on
    publishing 16 MB snapshots to each other every 0.1 s with pings every
    0.05 s. Each of them confirms v dead (past 2 x the 0.5 s timeout)
    within 2.5 s of its stop."""
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport

    names = ["a", "b", "c", "v"]
    ts = {n: TcpTransport(n) for n in names}
    stop, v_stop = threading.Event(), threading.Event()
    blob = struct.pack("<Q", 1) + os.urandom(FRAME_MB << 20)

    def beat(t):
        while not (stop.is_set() or (t is ts["v"] and v_stop.is_set())):
            t.heartbeat()
            time.sleep(BEAT_S)

    def publish(t):
        while not stop.is_set():
            t.publish(blob)
            time.sleep(PUBLISH_S)

    threads = []
    try:
        for n, t in ts.items():
            for m, u in ts.items():
                if m != n:
                    t.add_peer(m, u.address)
        beats = {n: threading.Thread(target=beat, args=(t,), daemon=True) for n, t in ts.items()}
        for th in beats.values():
            th.start()
        deadline = time.monotonic() + 10.0
        while not all(set(ts[n].alive_members(TIMEOUT_S)) == set(names) for n in names):
            assert time.monotonic() < deadline, "the fleet never assembled"
            time.sleep(0.05)
        v_stop.set()
        beats["v"].join(5.0)
        ts["v"].close()
        t_stop = time.monotonic()
        threads = [threading.Thread(target=publish, args=(ts[n],), daemon=True) for n in "abc"]
        for th in threads:
            th.start()
        while any("v" in ts[n].alive_members(TIMEOUT_S) for n in "abc"):
            assert time.monotonic() - t_stop < 2.5, {
                n: round(ts[n].membership.now() - ts[n].membership.last_heard["v"], 2) for n in "abc"}
            time.sleep(0.02)
    finally:
        stop.set()
        for th in threads:
            th.join(5.0)
        for t in ts.values():
            t.close()
