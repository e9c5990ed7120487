"""The port's gossip media and topology (``topo/``, ``bridge/protocol.py``,
``net/{membership,transport,sim,tcp}.py``) against the JAX package's.

* Every case of ``tests/test_topo.py``, ``tests/test_net_membership.py``,
  ``tests/test_net_transport.py`` and ``tests/test_net_tcp.py`` runs again
  through the port (`torch_twins.port_copy`; the engines run on the CPU
  inside ``host_device``). ``test_net_tcp.py``'s real-process drill
  (marked slow) starts the port's ``scripts/net_gossip_demo.py`` workers
  (``--device cpu``); its reference stays JAX's ``reference_digest``.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copy

_JNP = ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp")
_DEMO = ("from elastic_demo import DRILLS", "from torch_twins import DEMO_DRILLS as DRILLS")

globals().update(port_copy("test_topo.py", replace=[_DEMO]))
globals().update(port_copy("test_net_membership.py"))
globals().update(port_copy("test_net_transport.py", replace=[_JNP]))
globals().update(port_copy("test_net_tcp.py", replace=[
    ('DEMO = os.path.join(REPO, "scripts", "net_gossip_demo.py")',
     'DEMO = os.path.join(REPO, "antidote_ccrdt_tpu_torch", "scripts", "net_gossip_demo.py")'),
    ('"--n-members", "3", "--type", "topk_rmv", *extra]',
     '"--n-members", "3", "--type", "topk_rmv", "--device", "cpu", *extra]'),
]))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages side by side -------------------------------------------

import struct  # noqa: E402
import time  # noqa: E402


from antidote_ccrdt_tpu.bridge import protocol as jproto  # noqa: E402
from antidote_ccrdt_tpu.core import etf as jetf  # noqa: E402
from antidote_ccrdt_tpu.core.etf import Atom as JaxAtom  # noqa: E402
from antidote_ccrdt_tpu.net import sim as jsim  # noqa: E402
from antidote_ccrdt_tpu.net import tcp as jtcp  # noqa: E402
from antidote_ccrdt_tpu.net.transport import GossipNode as JaxNode  # noqa: E402
from antidote_ccrdt_tpu.parallel import elastic as jel  # noqa: E402
from antidote_ccrdt_tpu.topo import codec as jcodec  # noqa: E402
from antidote_ccrdt_tpu_torch.bridge import protocol as pproto  # noqa: E402
from antidote_ccrdt_tpu_torch.core import etf as petf  # noqa: E402
from antidote_ccrdt_tpu_torch.core.etf import Atom  # noqa: E402
from antidote_ccrdt_tpu_torch.net import sim as psim  # noqa: E402
from antidote_ccrdt_tpu_torch.net import tcp as ptcp  # noqa: E402
from antidote_ccrdt_tpu_torch.net.transport import GossipNode  # noqa: E402
from antidote_ccrdt_tpu_torch.parallel import elastic as pel  # noqa: E402
from antidote_ccrdt_tpu_torch.topo import codec as pcodec  # noqa: E402
from torch_twins import demo_drills, leaf_bytes  # noqa: E402


def _wait_for(pred, timeout=8.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# (north-star state: three [32, 1, 100 000, 4] slot planes and
# rmv_vc [32, 1, 100 000, 32], int32)
NORTH_STAR_LEAF_BYTES = 3 * 32 * 100_000 * 4 * 4 + 32 * 100_000 * 32 * 4


@pytest.mark.parametrize("unpack", [pproto.unpack_frames, jproto.unpack_frames,
                                    pcodec.unpack_coded_frames, jcodec.unpack_coded_frames])
def test_a_frame_past_max_frame_is_rejected_by_both_packages(unpack):
    """`unpack_frames` (the bridge's reader) and `unpack_coded_frames`
    (TcpTransport's) raise on a header claiming more than MAX_FRAME
    (256 MiB) before reading the payload, in both packages alike: an
    anchor of the north-star state (≈ 563 MB of leaves) cannot cross a
    TcpTransport link; a frame at the limit is waited for, not refused."""
    limit = pproto.MAX_FRAME
    assert limit == jproto.MAX_FRAME == 256 * 1024 * 1024
    assert NORTH_STAR_LEAF_BYTES > limit
    buf = bytearray(struct.pack(">I", limit + 1) + b"\x83")
    with pytest.raises(ValueError, match=f"^frame of {limit + 1} bytes exceeds limit$"):
        list(unpack(buf))
    at_limit = bytearray(struct.pack(">I", limit) + b"\x83")
    assert list(unpack(at_limit)) == [] and len(at_limit) == 5


def test_frames_and_codecs_are_byte_equal_to_jax():
    """The ETF frames and per-link coded frames both packages put on a
    socket for the same terms."""
    def terms(atom):
        return [
            (atom("snap"), b"m0", struct.pack("<Q", 3) + bytes(range(200)), {}),
            (atom("delta"), b"m1", 7, b"\x00" * 999, {b"lo": 5}),
            (atom("ping"), b"m2", [(b"m0", 0.25), (b"m3", 1.5)]),
        ]

    for pt, jt in zip(terms(Atom), terms(JaxAtom)):
        got, want = pproto.pack_frame(pt), jproto.pack_frame(jt)
        assert got == want
        assert list(pproto.unpack_frames(bytearray(want))) == [pt]
        for codec in (pcodec.CODEC_RAW, pcodec.CODEC_ZLIB):
            coded = pcodec.encode_frame(petf.encode(pt), codec)
            assert coded == jcodec.encode_frame(jetf.encode(jt), codec)
            assert list(pcodec.unpack_coded_frames(bytearray(coded))) == [pt]


def test_simulator_draws_like_jax():
    """Two SimNets of one seed deliver the same blobs at the same virtual
    times and count the same losses and duplicates."""
    def drive(sim_mod):
        net = sim_mod.SimNet(seed=5, latency=(0.001, 0.05), loss=0.2, dup=0.2)
        ts = {m: net.join(m) for m in ("a", "b", "c")}
        seen = []
        for i in range(40):
            m = "abc"[i % 3]
            ts[m].heartbeat()
            ts[m].publish(struct.pack("<Q", i) + bytes([i]))
            ts[m].publish_delta(i, bytes([i, i]), keep=8)
            if i == 20:
                net.partition({"a"}, {"b", "c"})
            if i == 30:
                net.heal()
            net.advance(0.01 * (i % 4))
            seen.append([(x, y, ts[x].fetch(y), ts[x].delta_seqs(y)) for x in ts for y in ts if x != y])
        return seen, dict(net.metrics.counters)

    got, want = drive(psim), drive(jsim)
    assert got == want
    assert got[1]["net.sim_lost"] > 0 and got[1]["net.sim_duplicated"] > 0


@pytest.mark.parametrize("sender_pkg", ["jax", "torch"])
def test_tcp_anchor_and_delta_cross_between_the_packages(sender_pkg):
    """A JAX TcpTransport and a port TcpTransport on localhost: the
    sender's anchor and three chained deltas arrive, and the receiver's
    sweep ends in the sender's state, leaf for leaf."""
    receiver_pkg = "torch" if sender_pkg == "jax" else "jax"
    mods = {"jax": (jtcp, JaxNode, jel), "torch": (ptcp, GossipNode, pel)}
    s_tcp, s_node, s_el = mods[sender_pkg]
    r_tcp, r_node, r_el = mods[receiver_pkg]
    a, b = s_tcp.TcpTransport("a"), r_tcp.TcpTransport("b")
    try:
        a.add_peer("b", b.address)
        b.add_peer("a", a.address)
        s_drill, r_drill = demo_drills(sender_pkg)["topk_rmv"], demo_drills(receiver_pkg)["topk_rmv"]
        s_dense, r_dense = s_drill.make_engine(), r_drill.make_engine()
        sender, receiver = s_node(a), r_node(b)
        pub = s_el.DeltaPublisher(sender, s_dense, name="topk_rmv", full_every=8)
        state = s_drill.init(s_dense)
        kinds = []
        for step in range(4):
            state = s_drill.apply(s_dense, state, step, range(4))
            kinds.append(pub.publish(state)["kind"])
        assert kinds == ["full", "delta", "delta", "delta"]
        assert _wait_for(lambda: b.delta_seqs("a") == [1, 2, 3] and b.snapshot_members() == ["a"])
        got, stats = r_el.sweep_deltas(receiver, r_dense, r_drill.init(r_dense), {})
        assert stats == {"deltas": 3, "fulls": 1, "skipped": 0}
        assert leaf_bytes(got) == leaf_bytes(state)
    finally:
        a.close()
        b.close()


def test_tcp_query_without_a_handler_answers_jax_no_plane_documents():
    """A query or a write that no handler serves gets the serve plane's
    error document ("no serve plane", "no ingest plane"), byte-equal to
    the JAX package's reply, each package querying its own transport and
    the other's. An installed handler answers as in JAX."""
    pt, jt = ptcp.TcpTransport("s"), jtcp.TcpTransport("s")
    try:
        for query in (ptcp.query_peer, jtcp.query_peer):
            got = [query(t.address, b'{"q":1}', timeout=2.0) for t in (pt, jt)]
            assert got[0] == got[1] == ("s", b'{"error":"no serve plane","member":"s"}\n')
        for write in (ptcp.write_peer, jtcp.write_peer):
            got = [write(t.address, b'{"w":1}', timeout=2.0) for t in (pt, jt)]
            assert got[0] == got[1] == ("s", b'{"error":"no ingest plane","member":"s"}\n')
        for t in (pt, jt):
            t.install_serve(lambda payload: payload[::-1])
            t.install_ingest(lambda payload: payload.upper())
        for query, write in ((ptcp.query_peer, ptcp.write_peer), (jtcp.query_peer, jtcp.write_peer)):
            for t in (pt, jt):
                assert query(t.address, b"abc", timeout=2.0) == ("s", b"cba")
                assert write(t.address, b"abc", timeout=2.0) == ("s", b"ABC")
        for t in (pt, jt):
            assert (t.metrics.counters["net.queries"], t.metrics.counters["net.writes"]) == (4, 4)
    finally:
        pt.close()
        jt.close()
