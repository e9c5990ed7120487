"""The port's partition drill (``antidote_ccrdt_tpu_torch/scripts/
partition_demo.py``) against the JAX package's ``scripts/partition_demo.py``.

* At the JAX drill's own geometry, for 8 and for 4 partitions, JAX's drill
  runs as it ships: nothing of it is replaced. Its psnap publishes are
  recorded on their way to the transport (``JAX_DRILL``), which changes
  nothing it does. The two reports are equal in geometry, p*, the outage,
  the divergent partitions, the whole repair's bytes, the digests' bytes,
  the seven checks and the verdict, and in every entry of ``counters_w2``
  but those of ``partition_demo.TIMING_COUNTERS`` (``net.dig_fetches``,
  ``net.psnap_bytes``, ``net.psnap_fetches``, ``net.psnap_reqs_recv``,
  ``net.psnap_reqs_sent``, ``net.psnap_serves``): a sweep of the tail that
  runs before a peer's reply has landed asks and is served once more, so
  two runs of JAX's own drill differ in these. JAX's drill, whose
  ``fetch_psnap`` does not wait for a reply, also differs in
  ``JAX_RACE_COUNTERS`` (``net.partition_agree_advances``,
  ``net.partition_resyncs``): a tail resync that read a stale psnap takes
  one more try, and a sweep may then find the peer's digests agreeing
  (seen in runs of JAX's drill beside busy drills). The port's own runs
  agree in these.
* The resync's psnap bytes hang on thread timing in JAX's drill: a resync
  that reads its cache before the reply to its request lands bills an
  older psnap and asks again. So the port's psnap bytes are held to JAX's
  publishers instead: each divergent partition's psnap, as each peer last
  published it before the resync, moved once. JAX's own count is at least
  that. The ratio and the PASS line follow from these bytes.
* Away from that geometry (R = 6) every replica has an owner and all
  seven checks hold, the sequential reference included; at R = 4 the
  ownership map is JAX's.

Each drill runs as a subprocess, killed after DRILL_TIMEOUT_S.

The port's transport departs from JAX's ``net/tcp.py`` in three pinned
ways:

* a psnap asked for is waited for: ``fetch_psnap`` right after
  ``request_psnaps`` returns the peer's current psnap, a newer one after a
  second request, and after ``PSNAP_WAIT_S`` None for a part the peer
  never stored, or the older cached psnap of a peer that died before it
  answered;
* a frame with a binary of at least ``etf.CHUNK_MIN`` bytes goes out in
  parts and is read into one buffer: ``etf.encode_chunks`` joins to
  JAX's ``etf.encode``, and 3 MB anchors, deltas and psnaps cross
  between JAX's and the port's transports, either way, byte for byte
  (raw links and zlib cross-zone links);
* such a frame's send is bounded as a whole by the socket's timeout, as
  ``sendall`` is: a receiver that drains slowly fails it within about
  that timeout.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from antidote_ccrdt_tpu_torch.scripts import partition_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
DRILL_TIMEOUT_S = 180
JAX_RACE_COUNTERS = ("net.partition_agree_advances", "net.partition_resyncs")
EQUAL_FIELDS = ("geometry", "partitions", "p_star", "p_star_ids", "outage_steps", "divergent_parts",
                "whole_resync_bytes", "checks", "pass")
# JAX's drill as it ships, its psnap publishes appended to PSNAP_LOG as
# [member, seq, part, bytes] on their way to the transport.
JAX_DRILL = (
    "import json, os, runpy, sys\n"
    "sys.path.insert(0, {repo!r})\n"
    "from antidote_ccrdt_tpu.core import partition\n"
    "from antidote_ccrdt_tpu.net import tcp\n"
    "emitted, publish_psnap = [], tcp.TcpTransport.publish_psnap\n"
    "def record(self, part, blob):\n"
    "    emitted.append([self.member, partition.decode_psnap_blob(blob)[0], int(part), len(blob)])\n"
    "    return publish_psnap(self, part, blob)\n"
    "tcp.TcpTransport.publish_psnap = record\n"
    "sys.argv = [{script!r}] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_path({script!r}, run_name='__main__')\n"
    "finally:\n"
    "    with open(os.environ['PSNAP_LOG'], 'w') as f:\n"
    "        json.dump(emitted, f)\n"
).format(repo=REPO, script=os.path.join(REPO, "scripts", "partition_demo.py"))


def _env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])), **extra)


def _start(argv, cwd, **env):
    return subprocess.Popen([sys.executable, *argv], cwd=cwd, env=_env(**env), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(p, what):
    try:
        out, _ = p.communicate(timeout=DRILL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        p.kill()
        out, _ = p.communicate()
        raise AssertionError(f"{what} outlived {DRILL_TIMEOUT_S} s:\n{out[-4000:]}")
    assert p.returncode == 0, f"{what} exited {p.returncode}:\n{out[-4000:]}"
    return out


@pytest.mark.parametrize("partitions", [8, 4])
def test_port_drill_reports_what_jax_reports(partitions, tmp_path):
    jax_out, port_out, log = tmp_path / "jax.json", tmp_path / "port.json", tmp_path / "psnaps.json"
    procs = {
        "jax": _start(["-c", JAX_DRILL, "--partitions", str(partitions), "--out", str(jax_out)], REPO,
                      PSNAP_LOG=str(log)),
        "port": _start(["-m", "antidote_ccrdt_tpu_torch.scripts.partition_demo", "--device", "cpu",
                        "--shape", "demo", "--partitions", str(partitions), "--out", str(port_out)], REPO),
    }
    outs = {side: _finish(p, f"the {side} drill") for side, p in procs.items()}
    jax, port = json.loads(jax_out.read_text()), json.loads(port_out.read_text())
    assert set(port) == set(jax)
    for field in EQUAL_FIELDS:
        assert port[field] == jax[field], field
    assert port["pass"] and all(port["checks"].values())

    # Each divergent partition's psnap as each peer last published it
    # before the resync (a peer publishes once a step), moved once.
    emitted = json.loads(log.read_text())

    def published(member, part):
        return [n for m, seq, p, n in emitted if m == member and p == part and seq < partition_demo.OUTAGE_HI][-1]

    psnaps = sum(published(m, p) for m in ("w0", "w1") for p in jax["divergent_parts"])
    digests = jax["partial_resync_bytes"]["digests"]
    assert port["partial_resync_bytes"] == {"psnaps": psnaps, "digests": digests, "total": psnaps + digests}
    assert jax["partial_resync_bytes"]["psnaps"] >= psnaps
    ratio = jax["whole_resync_bytes"] / (psnaps + digests)
    assert port["bytes_ratio"] == round(ratio, 3)

    def steady(counters):
        return {k: v for k, v in counters.items()
                if k not in partition_demo.TIMING_COUNTERS + JAX_RACE_COUNTERS}

    assert steady(port["counters_w2"]) == steady(jax["counters_w2"])
    assert set(port["counters_w2"]) >= set(partition_demo.TIMING_COUNTERS) | {"net.partition_resyncs"}
    assert outs["port"].splitlines()[-1] == (
        f"PASS: partial anti-entropy moved {psnaps + digests} bytes vs {jax['whole_resync_bytes']} "
        f"whole-instance ({ratio:.1f}x reduction), digests bit-identical")
    assert outs["jax"].splitlines()[-1].startswith("PASS: partial anti-entropy moved ")


def test_every_replica_has_an_owner_away_from_jax_geometry(tmp_path):
    """R = 6 (JAX's map owns replicas 0-3 only): all seven checks hold, and
    the report goes to PART_torch_r01.json in the current directory."""
    owned = partition_demo.owned_replicas(6)
    assert sorted(r for rs in owned.values() for r in rs) == list(range(6))
    p = _start(["-m", "antidote_ccrdt_tpu_torch.scripts.partition_demo", "--device", "cpu",
                "--shape", "6,512,64,16,2,8"], str(tmp_path))
    _finish(p, "the R = 6 drill")
    assert os.listdir(tmp_path) == ["PART_torch_r01.json"]
    report = json.loads((tmp_path / "PART_torch_r01.json").read_text())
    assert report["geometry"] == {"R": 6, "NK": 1, "I": 512, "DCS": 6, "K": 8, "M": 2, "B": 64, "Br": 16,
                                  "steps": partition_demo.STEPS}
    assert report["checks"] == {k: True for k in report["checks"]} and len(report["checks"]) == 7
    assert report["pass"]


def test_ownership_at_four_replicas_is_jax_map():
    assert partition_demo.owned_replicas(4) == {"w0": [0, 3], "w1": [1], "w2": [2]}
    assert partition_demo.parse_shape("demo") == partition_demo.DEMO
    g = partition_demo.parse_shape("32,40000,32768,2048,4,100")
    assert (g.R, g.NK, g.I, g.DCS, g.K, g.M, g.B, g.Br, g.zipf) == (32, 1, 40_000, 32, 100, 4, 32_768, 2_048, False)


def _until(cond, what, timeout=30.0, beat=()):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        for t in beat:
            t.heartbeat()
        time.sleep(0.002)


def test_fetch_psnap_waits_for_the_reply_to_its_request():
    from antidote_ccrdt_tpu_torch.net.tcp import PSNAP_WAIT_S, TcpTransport

    a, b = TcpTransport("a"), TcpTransport("b")
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        _until(lambda: "a" in b.members() and "b" in a.members(), "the hellos", beat=(a, b))
        a.publish_psnap(3, b"first psnap")
        b.request_psnaps("a", [3])
        assert b.fetch_psnap("a", 3) == b"first psnap"  # no sleep: the fetch waits for the reply
        a.publish_psnap(3, b"second psnap")
        b.request_psnaps("a", [3])
        assert b.fetch_psnap("a", 3) == b"second psnap"
        assert b.fetch_psnap("a", 3) == b"second psnap"  # answered: a plain cache read
        t0 = time.monotonic()
        b.request_psnaps("a", [5])  # a stores no psnap of part 5: no reply comes
        assert b.fetch_psnap("a", 5) is None
        assert PSNAP_WAIT_S - 0.05 < time.monotonic() - t0 < PSNAP_WAIT_S + 4.0
    finally:
        a.close()
        b.close()


def test_fetch_psnap_of_a_peer_dead_before_its_reply_stalls_psnap_wait_s():
    """The price of the wait (ROADMAP §C, deliberate): a peer that dies
    between the request and its reply holds the fetch PSNAP_WAIT_S, after
    which it reads the cache as JAX's transport does at once."""
    from antidote_ccrdt_tpu_torch.net.tcp import PSNAP_WAIT_S, TcpTransport

    a, b = TcpTransport("a"), TcpTransport("b")
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        _until(lambda: "a" in b.members() and "b" in a.members(), "the hellos", beat=(a, b))
        a.publish_psnap(3, b"older psnap")
        b.request_psnaps("a", [3])
        assert b.fetch_psnap("a", 3) == b"older psnap"
        a.close()  # dies with its newer psnap unpublished
        t0 = time.monotonic()
        b.request_psnaps("a", [3])
        assert b.fetch_psnap("a", 3) == b"older psnap"
        assert PSNAP_WAIT_S - 0.05 < time.monotonic() - t0 < PSNAP_WAIT_S + 4.0
        t0 = time.monotonic()
        assert b.fetch_psnap("a", 3) == b"older psnap"  # the request is spent: no second stall
        assert time.monotonic() - t0 < 0.5
    finally:
        a.close()
        b.close()


def test_a_chunked_frame_to_a_slow_reader_fails_within_the_send_timeout():
    """`sendall` bounds a whole send by the socket's timeout; a frame sent
    in parts is bounded the same way, however steadily the peer drains."""
    import socket
    import threading

    from antidote_ccrdt_tpu_torch.core import etf
    from antidote_ccrdt_tpu_torch.net import tcp

    timeout = 1.0
    srv = socket.create_server(("127.0.0.1", 0))
    stop = threading.Event()

    def drain_slowly():
        conn, _ = srv.accept()
        with conn:
            while not stop.is_set() and conn.recv(1 << 16):
                time.sleep(0.02)  # about 3 MB/s: the frame needs about 20 s

    reader = threading.Thread(target=drain_slowly, daemon=True)
    reader.start()
    sock = socket.create_connection(srv.getsockname(), timeout=timeout)
    try:
        big = bytes(64 << 20)
        frame = tcp._Chunks(etf.encode_chunks((etf.Atom("delta"), b"a", 1, 2, big, {})))
        t0 = time.monotonic()
        with pytest.raises(socket.timeout):
            tcp._send_frame(sock, frame)
        assert timeout - 0.05 < time.monotonic() - t0 < timeout + 2.0
        assert sock.gettimeout() == timeout
    finally:
        stop.set()
        sock.close()
        srv.close()
        reader.join(10)


class _Recorder:
    """A transport that keeps what a `GossipNode` publishes, in order."""

    def __init__(self, member):
        self.member, self.sent = member, []

    def publish_psnap(self, part, blob):
        self.sent.append(("psnap", part, blob))

    def publish_digest(self, blob):
        self.sent.append(("digest", blob))


@pytest.mark.parametrize("threads", [1, 4])
def test_anchor_psnaps_are_jax_blobs_in_jax_order(threads, monkeypatch):
    """`publish_partitioned` deflates PSNAP_THREADS psnaps at a time: at 1
    and at 4 threads (9 partitions: groups of 4, 4 and 1) its blobs and
    their order are JAX's, for the first anchor and for a later one that
    republishes only the changed partitions."""
    import importlib.util

    from antidote_ccrdt_tpu.net.transport import GossipNode as JaxNode
    from antidote_ccrdt_tpu_torch.models.topk_rmv_dense import make_dense
    from antidote_ccrdt_tpu_torch.net import transport

    monkeypatch.setattr(transport, "PSNAP_THREADS", threads)
    spec = importlib.util.spec_from_file_location("jax_partition_demo", os.path.join(REPO, "scripts", "partition_demo.py"))
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    g = partition_demo.DEMO
    owned = range(g.R)
    ids_p = np.arange(g.I, dtype=np.int32)[:8]
    jdense = jdemo._build()
    pdense = make_dense(n_ids=g.I, n_dcs=g.DCS, size=g.K, slots_per_id=g.M, device="cpu")
    jstate, pstate = jdense.init(g.R, g.NK), pdense.init(g.R, g.NK)
    jnode, pnode = JaxNode(_Recorder("w0")), transport.GossipNode(_Recorder("w0"))
    for seq, step in enumerate((0, partition_demo.OUTAGE_LO)):  # all ids, then ids 0-7 only
        jstate = jdemo.apply_step(jdense, jstate, step, owned, ids_p)
        pstate = partition_demo.apply_step(pdense, g, pstate, step, owned, ids_p, "cpu")
        jnode.publish_partitioned("topk_rmv", jstate, seq, jdense, 8)
        pnode.publish_partitioned("topk_rmv", pstate, seq, pdense, 8)
    assert pnode.transport.sent == jnode.transport.sent
    assert [x[1] for x in pnode.transport.sent[:9]] == list(range(9))
    assert 2 < len(pnode.transport.sent) - 10 < 11  # the second anchor: changed partitions only


def test_encode_chunks_joins_to_jax_encoding():
    from antidote_ccrdt_tpu.core import etf as jetf
    from antidote_ccrdt_tpu_torch.core import etf

    big = np.random.default_rng(5).integers(0, 256, etf.CHUNK_MIN + 17, dtype=np.uint8).tobytes()
    def term(atom):
        return (atom("delta"), b"w0", 7, 2, big, {b"w1": 0.25, b"w2": 1.5}, [big, b"small"])

    chunks = etf.encode_chunks(term(etf.Atom))
    assert b"".join(chunks) == jetf.encode(term(jetf.Atom)) == etf.encode(term(etf.Atom))
    assert sum(c is big for c in chunks) == 2  # the large binary is not copied
    assert etf.encode_chunks((etf.Atom("ping"), b"w0", {})) == [jetf.encode((jetf.Atom("ping"), b"w0", {}))]


@pytest.mark.parametrize("zones", [("z", "z"), ("za", "zb")], ids=["raw", "zlib_cross_zone"])
@pytest.mark.parametrize("sender,receiver", [("port", "jax"), ("jax", "port"), ("port", "port")])
def test_big_frames_cross_between_jax_and_port_transports(sender, receiver, zones):
    from antidote_ccrdt_tpu.net.tcp import TcpTransport as JaxTcp
    from antidote_ccrdt_tpu_torch.net.tcp import TcpTransport as PortTcp

    cls = {"jax": JaxTcp, "port": PortTcp}
    rng = np.random.default_rng(11)
    snap, delta, psnap = (rng.integers(0, 256, (3 << 20) + k, dtype=np.uint8).tobytes() for k in (1, 2, 3))
    a, b = cls[sender]("a", zone=zones[0]), cls[receiver]("b", zone=zones[1])
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        _until(lambda: "a" in b.members() and "b" in a.members(), "the hellos", beat=(a, b))
        a.publish(snap)
        a.publish_delta(4, delta, keep=2)
        a.publish_psnap(2, psnap)
        _until(lambda: b.fetch("a") is not None and 4 in b.delta_seqs("a"), "the anchor and the delta")
        assert b.fetch("a") == snap and b.fetch_delta("a", 4) == delta
        b.request_psnaps("a", [2])
        _until(lambda: b.fetch_psnap("a", 2) is not None, "the psnap")
        assert b.fetch_psnap("a", 2) == psnap
    finally:
        a.close()
        b.close()
