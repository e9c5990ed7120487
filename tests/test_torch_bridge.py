"""The port's bridge server and client (``bridge/{server,client}.py``)
through the JAX package's own tests, and against the JAX package's bridge
byte for byte.

* Every case of ``tests/test_bridge.py``, ``tests/test_bridge_packed.py``,
  ``tests/test_bridge_erl.py`` (its golden bytes and the raw-socket
  session; the live escript case keeps its own ``escript`` gate),
  ``tests/test_serve_parity.py``, ``tests/test_scrape_faults.py``,
  ``tests/test_fault_matrix.py`` and ``tests/test_rtrace.py`` runs again
  through the port (`torch_twins.port_copies`): servers are
  ``BridgeServer(device="cpu")``, ``jax.numpy`` op constructors become
  `torch_twins.torch_jnp`, ``tests/test_serve.py``'s engine and applies
  and ``scripts/elastic_demo.py``'s drills their `torch_twins` twins, and
  an autouse ``host_device()`` region puts every other engine on the CPU.
  Nothing is left out.
* The same request frames, sent to a JAX and a port server, get
  byte-equal reply frames (extras and error frames included) and
  byte-equal ``grid_to_binary`` snapshots for all six grid types, across
  the tuple, packed, packed-multi, extras, ``merge_all``, ``observe``,
  ``batch_merge``, ``grid_compact``, ``metrics``, ``query`` and ``write``
  ops; each package's client drives the other's server; each package's
  grid snapshots load into the other's server.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

_CPU = ("BridgeServer()", 'BridgeServer(device="cpu")')
_CPU_PORT0 = ("BridgeServer(port=0)", 'BridgeServer(port=0, device="cpu")')
_JNP = ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp")
_SERVE = ("from antidote_ccrdt_tpu import serve", "from antidote_ccrdt_tpu_torch import serve")
_SERVE_HELPERS = ("from tests.test_serve import R, _apply, _engine",
                  "from torch_twins import SERVE_R as R, serve_apply as _apply, serve_engine as _engine")

globals().update(port_copies(
    ("test_bridge.py", dict(replace=[
        _CPU, _JNP, ("BridgeServer(read_deadline=0.3)", 'BridgeServer(read_deadline=0.3, device="cpu")')])),
    # test_bridge.py's module server and client fixtures serve this file
    # too: its own are the same two fixtures.
    ("test_bridge_packed.py", dict(replace=[_CPU], skip=["server", "client"])),
    # Its per-test server is `erl_server` here; the Erlang client it reads
    # stays the JAX package's file.
    ("test_bridge_erl.py", dict(replace=[
        ('"antidote_ccrdt_tpu_torch.erl"', '"antidote_ccrdt_tpu.erl"'),
        ('def server():\n    srv = BridgeServer(host="127.0.0.1", port=0)',
         'def erl_server():\n    srv = BridgeServer(host="127.0.0.1", port=0, device="cpu")'),
        ("def test_raw_socket_session_like_an_erlang_client(server, legacy):\n"
         "    with socket.create_connection(server.address",
         "def test_raw_socket_session_like_an_erlang_client(erl_server, legacy):\n"
         "    with socket.create_connection(erl_server.address"),
        ("def test_escript_smoke_against_live_server(server):\n    host, port = server.address",
         "def test_escript_smoke_against_live_server(erl_server):\n    host, port = erl_server.address"),
    ])),
    ("test_serve_parity.py", dict(replace=[_SERVE, _SERVE_HELPERS, _CPU_PORT0])),
    # Its autouse fault reset is test_serve_parity.py's, which runs here.
    ("test_scrape_faults.py", dict(replace=[_CPU], skip=["_no_fault_leak"])),
    ("test_fault_matrix.py", dict(replace=[
        _CPU, ("from scripts.elastic_demo import DRILLS", "from torch_twins import DEMO_DRILLS as DRILLS"),
        ("from tests.test_serve_parity import _frozen_plane",
         "from torch_twins import serve_frozen_plane as _frozen_plane")])),
    ("test_rtrace.py", dict(replace=[
        ('jnp = pytest.importorskip("jax.numpy")', "from torch_twins import torch_jnp as jnp"),
        _SERVE, _SERVE_HELPERS, _CPU_PORT0])),
))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


# --- the two packages' bridges side by side ----------------------------------

import time  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from antidote_ccrdt_tpu import serve as jserve  # noqa: E402
from antidote_ccrdt_tpu.bridge import BridgeClient as JaxClient, BridgeServer as JaxServer  # noqa: E402
from antidote_ccrdt_tpu.bridge import protocol as jproto  # noqa: E402
from antidote_ccrdt_tpu.bridge import server as jserver_mod  # noqa: E402
from antidote_ccrdt_tpu.obs import events as jevents  # noqa: E402
from antidote_ccrdt_tpu.serve.ingest import IngestPlane as JaxIngest  # noqa: E402
from antidote_ccrdt_tpu_torch import serve as pserve  # noqa: E402
from antidote_ccrdt_tpu_torch.bridge import BridgeClient as PortClient, BridgeServer as PortServer  # noqa: E402
from antidote_ccrdt_tpu_torch.bridge import server as pserver_mod  # noqa: E402
from antidote_ccrdt_tpu_torch.bridge import protocol as pproto  # noqa: E402
from antidote_ccrdt_tpu_torch.obs import events as pevents  # noqa: E402
from antidote_ccrdt_tpu_torch.serve.ingest import IngestPlane as PortIngest  # noqa: E402
from bridge_ops import A, GEOMETRY, NK, R, TYPES, Raw, grid_script, packed, tuple_ops  # noqa: E402


@pytest.fixture()
def servers():
    """A JAX and a port server, each with a raw connection."""
    jsrv, psrv = JaxServer().start(), PortServer(device="cpu").start()
    conns = {"jax": Raw(jsrv.address), "torch": Raw(psrv.address)}
    yield {"jax": jsrv, "torch": psrv}, conns
    for c in conns.values():
        c.close()
    jsrv.close()
    psrv.close()


def _both(conns, ops):
    """Each op to both servers in turn: the reply frames, equal byte for
    byte (a failure names the op)."""
    replies = []
    for i, op in enumerate(ops):
        want, got = conns["jax"].ask(op, i), conns["torch"].ask(op, i)
        assert got == want, (i, op if len(repr(op)) < 400 else repr(op)[:400], got[:300], want[:300])
        replies.append(got)
    return replies


@pytest.mark.parametrize("name", TYPES)
def test_reply_frames_and_snapshots_equal_jax(servers, name):
    """One seeded script of grid ops sent to a JAX and a port server:
    every reply frame, extras, observes, errors and every `grid_to_binary`
    included, is byte-equal."""
    _, conns = servers
    replies = _both(conns, grid_script(name, np.random.default_rng(TYPES.index(name))))
    assert sum(b"reply" in r and b"error" in r for r in replies) >= 7  # the error frames came back as errors


def test_packed_ids_fallback_equal_jax(servers, monkeypatch):
    """The topk_rmv multi path with the packed-ids upload forced off in
    both packages (every batch's eight planes stacked as they are)."""
    monkeypatch.setattr(jserver_mod, "_PACKED_IDS_LIMIT", 0)
    monkeypatch.setattr(pserver_mod, "_PACKED_IDS_LIMIT", 0)
    _, conns = servers
    _both(conns, grid_script("topk_rmv", np.random.default_rng(11)))


def _effects(rng, n=80):
    frontier, out = {}, []
    for _ in range(n):
        d, i = int(rng.integers(0, 3)), int(rng.integers(0, 24))
        if rng.random() < 0.3:
            out.append((A("rmv"), (i, {dd: t for dd, t in frontier.items() if t > 1})))
        else:
            frontier[d] = frontier.get(d, 0) + 1
            out.append((A("add"), (i, int(rng.integers(1, 999)), (d, frontier[d]))))
    return out


def _scalar_script(rng):
    """The scalar surface, batch_merge, grid_compact and the registry
    predicates, with their error frames."""
    from antidote_ccrdt_tpu.core import wire
    from antidote_ccrdt_tpu.models.topk_rmv import TopkRmvScalar

    eng = TopkRmvScalar()
    blobs = []
    for s in range(4):
        st = eng.new(5)
        for op in _effects(np.random.default_rng(100 + s), 30):
            st, _ = eng.update((str(op[0]), op[1]), st)
        blobs.append(wire.to_reference_binary("topk_rmv", st))
    ops = [(A("new"), A("topk_rmv"), [5]), (A("new"), A("average"), []),
           (A("downstream"), 1, (A("add"), (3, 40)), 1, 7), (A("downstream"), 2, (A("add"), 9), A("dc1"), 3),
           (A("update"), 1, (A("add"), (3, 40, (1, 7)))),
           (A("update"), 2, (A("add"), (10, 2))), (A("value"), 1), (A("value"), 2),
           (A("to_binary"), 1), (A("equal"), 1, 1), (A("compact"), 2, [(A("add"), (1, 1)), (A("add"), (2, 1))]),
           (A("batch_merge"), A("topk_rmv"), blobs + [1]), (A("value"), 3), (A("to_binary"), 3),
           (A("batch_merge"), A("average"), [2, 2]), (A("value"), 4),
           (A("batch_merge"), A("topk"), [1]), (A("free"), 4), (A("free"), 4), (A("value"), 4),
           (A("is_type"), A("wordcount")), (A("is_type"), A("nope")),
           (A("generates_extra_operations"), A("topk_rmv")),
           (A("is_operation"), A("topk_rmv"), (A("add"), (1, 2))),
           (A("require_state_downstream"), A("topk_rmv"), (A("rmv"), 1)),
           (A("is_replicate_tagged"), A("leaderboard"), (A("add_r"), (1, 2))),
           (A("nope"),), (A("query"), b"{}"), (A("write"), b"{}")]
    effects = _effects(rng)
    ops += [(A("grid_compact"), A("topk_rmv"), [], effects),
            (A("grid_compact"), A("topk_rmv"), [(A("m_keep"), 2)], effects),
            (A("grid_compact"), A("average"), [], [(A("add"), (v, 1)) for v in range(5)]),
            (A("grid_compact"), A("topk"), [], [(A("add"), (i % 4, 10 * i)) for i in range(9)]),
            (A("grid_compact"), A("wordcount"), [], [(A("add"), b"a b a")])]
    return ops


def test_scalar_ops_batch_merge_and_compaction_equal_jax(servers):
    _, conns = servers
    _both(conns, _scalar_script(np.random.default_rng(3)))
    # A request that is not a call, and then the metrics the two servers
    # counted for everything above.
    for c in conns.values():
        c.sock.sendall(pproto.pack_frame((A("hello"),)))
    assert conns["torch"].reply() == conns["jax"].reply()
    _both(conns, [(A("metrics"),)])


def _frozen_wall(monkeypatch):
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    fake.time = lambda: 1_700_000_000.0
    for mod in (jevents, pevents):
        monkeypatch.setattr(mod, "time", fake)


def test_query_and_write_ops_equal_jax(servers, monkeypatch):
    """{query} and {write} through either server into its own package's
    serve and ingest planes (frozen clocks): the same reply frames."""
    from antidote_ccrdt_tpu.models.topk_rmv_dense import make_dense as jmake
    from tests.test_serve import _apply as japply
    from torch_twins import serve_apply, serve_engine

    _frozen_wall(monkeypatch)
    srvs, conns = servers
    planes = {}
    for pkg, serve, dense, apply, ingest in (
            ("jax", jserve, jmake(n_ids=8, n_dcs=2, size=10, slots_per_id=2), japply, JaxIngest),
            ("torch", pserve, serve_engine(), serve_apply, PortIngest)):
        plane = serve.ServePlane(dense, member="w0", mono=lambda: 50.0)
        plane.swap(apply(dense, dense.init(2, 1), [1, 2, 3], [50, 40, 30]), 4)
        srvs[pkg].install_serve(plane)
        planes[pkg] = ingest("w0", durable_fn=lambda: 10, ack_timeout_s=2.0, poll_s=0.001)
        srvs[pkg].install_ingest(planes[pkg])
    queries = [jserve.request_bytes([{"op": "value", "key": 0}, {"op": "topk", "key": 0, "k": 2}]),
               jserve.request_bytes([{"op": "range", "key": 0, "lo": 35, "hi": 60}], max_staleness_s=1.0),
               b"not json"]
    _both(conns, [(A("query"), q) for q in queries])
    write = jserve.encode({"write_id": "c:0", "ops": [["add", [3, 70, [0, 1_000_001]]]], "ack": "applied"})
    folded = {}
    for pkg in ("jax", "torch"):
        conns[pkg].send((A("write"), write), 9)
        deadline = time.monotonic() + 10.0
        while planes[pkg].depth() < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        folded[pkg] = []
        assert planes[pkg].drain(5, folded[pkg].extend) == 1
    got, want = conns["torch"].reply(), conns["jax"].reply()
    assert got == want and b"write_ack" in got
    assert folded["torch"] == folded["jax"]
    _both(conns, [(A("write"), write), (A("write"), b'{"write_id": "bad"}'),
                  (A("write"), jserve.encode({"probe": {"w0": 3}}))])
    pevents.reset("?")
    jevents.reset("?")


def _client_session(client, atom):
    """One session of the client surface; the results as plain values
    (atoms as strings, packed columns as lists)."""
    def plain(x):
        if isinstance(x, (list, tuple)):
            return type(x)(plain(e) for e in x)
        if isinstance(x, np.ndarray):
            return x.tolist()
        if type(x).__name__ == "Atom":
            return ("atom", str(x))
        return x

    rng = np.random.default_rng(9)
    out = []
    client.grid_new("s", "topk_rmv", n_replicas=R, n_keys=NK, **GEOMETRY["topk_rmv"])
    b = [tuple_ops("topk_rmv", rng, 6) for _ in range(4)]

    def groups(per_replica):
        return [(str(tag), np.frombuffer(c, "<i4"), [np.frombuffer(x, "<i4") for x in cols])
                for tag, c, cols in packed("topk_rmv", per_replica)]

    def relabel(per_replica):  # the client's own Atom class
        return [[(atom(str(op[0])),) + tuple(op[1:]) for op in ops] for ops in per_replica]

    out.append(client.grid_apply("s", relabel(b[0])))
    out.append(client.grid_apply_extras("s", relabel(b[1])))
    out.append(client.grid_apply_packed("s", groups(b[2])))
    out.append(client.grid_apply_packed_multi("s", [groups(b[3]), groups(b[2])]))
    out.append(client.grid_apply_extras_packed("s", groups(b[1])))
    client.grid_merge_all("s")
    out.append(client.grid_observe("s", 1, 1))
    blob = client.grid_to_binary("s")
    client.grid_from_binary("s2", blob)
    out += [blob, client.grid_to_binary("s2") == blob]
    h = client.new("average")
    client.update(h, (atom("add"), (10, 2)))
    out.append(client.value(h))
    out.append(client.batch_merge("average", [h, client.to_binary(h)]))
    out.append(client.grid_compact("average", [(atom("add"), (v, 1)) for v in range(4)]))
    try:
        client.grid_observe("s", R, 0)
    except Exception as e:  # noqa: BLE001 - the server's error, raised by the client
        out.append((type(e).__name__, str(e)))
    out.append(client.grid_observe("s", 0, 0))
    out.append(client.metrics_text())
    return plain(out)


def test_clients_interoperate_with_either_server():
    """A JAX client driving the port's server, a port client driving
    JAX's, and a port client driving the port's server get the same
    results (the two clients are the same host code)."""
    from antidote_ccrdt_tpu.core.etf import Atom as jatom
    from antidote_ccrdt_tpu_torch.core.etf import Atom as patom

    results = {}
    for (srv_cls, kw), (cl_cls, atom) in (
            ((JaxServer, {}), (PortClient, patom)), ((PortServer, {"device": "cpu"}), (JaxClient, jatom)),
            ((PortServer, {"device": "cpu"}), (PortClient, patom))):
        with srv_cls(**kw) as srv, cl_cls(*srv.address) as cl:
            results[(srv_cls.__module__, cl_cls.__module__)] = _client_session(cl, atom)
    first = results[(JaxServer.__module__, PortClient.__module__)]
    assert first[-3][0] == "BridgeError"
    for key, got in results.items():
        assert got == first, key


@pytest.mark.parametrize("name", TYPES)
def test_grid_snapshots_load_across_packages(name):
    """A JAX grid's snapshot loads into the port's server and the port's
    into JAX's: the same snapshot back, the same observables, and the
    restored grid applies on."""
    from antidote_ccrdt_tpu.core.etf import Atom as jatom
    from antidote_ccrdt_tpu_torch.core.etf import Atom as patom

    rng = np.random.default_rng(20 + TYPES.index(name))
    b0, b1 = tuple_ops(name, rng, 8), tuple_ops(name, rng, 8)
    with JaxServer() as js, PortServer(device="cpu") as ps, JaxClient(*js.address) as jc, \
            PortClient(*ps.address) as pc:
        for cl, atom in ((jc, jatom), (pc, patom)):
            cl.grid_new("a", name, n_replicas=R, n_keys=NK, **GEOMETRY[name])
            cl.grid_apply("a", [[(atom(str(op[0])),) + op[1:] for op in ops] for ops in b0])
        blobs = {"jax": jc.grid_to_binary("a"), "torch": pc.grid_to_binary("a")}
        assert blobs["jax"] == blobs["torch"]
        pc.grid_from_binary("from_jax", blobs["jax"])
        jc.grid_from_binary("from_port", blobs["torch"])
        assert pc.grid_to_binary("from_jax") == blobs["jax"]
        assert jc.grid_to_binary("from_port") == blobs["torch"]
        cells = [(r, k) for r in range(R) for k in range(NK)]
        assert [pc.grid_observe("from_jax", r, k) for r, k in cells] == \
            [jc.grid_observe("from_port", r, k) for r, k in cells]
        for cl, atom, g in ((jc, jatom, "from_port"), (pc, patom, "from_jax")):
            cl.grid_apply(g, [[(atom(str(op[0])),) + op[1:] for op in ops] for ops in b1])
            cl.grid_merge_all(g)
        assert pc.grid_to_binary("from_jax") == jc.grid_to_binary("from_port")


def test_snapshot_past_the_frame_limit_poisons_either_client(monkeypatch):
    """A grid whose snapshot is larger than the frame limit: either
    server sends the frame, and either client rejects it as a transport
    failure and is closed for good (a north-star topk_rmv grid, 563 MB,
    is past the 256 MiB limit, so its snapshot cannot cross the wire)."""
    from antidote_ccrdt_tpu_torch.bridge import protocol as pproto

    for proto in (jproto, pproto):
        monkeypatch.setattr(proto, "MAX_FRAME", 4096)
    for srv_cls, kw in ((JaxServer, {}), (PortServer, {"device": "cpu"})):
        for cl_cls in (JaxClient, PortClient):
            with srv_cls(**kw) as srv, cl_cls(*srv.address) as cl:
                cl.grid_new("big", "topk", n_replicas=2, n_keys=1, n_ids=4096, size=4)
                with pytest.raises(ValueError, match="exceeds limit"):
                    cl.grid_to_binary("big")
                with pytest.raises(Exception, match="closed"):
                    cl.grid_observe("big", 0, 0)


# --- chip_smoke.py phase 15 on the CPU ------------------------------------------


def test_wire_mix_holds_and_repeats_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 15b's bench_grid_wire mix at a reduced width on
    the CPU, twice: its batch_merge op equals the direct batch_merge,
    every grid's snapshot survives its round trip over the wire (both
    checked inside), and the two runs give equal replies, snapshots and
    batch_merge states, which is what the card run is held to."""
    import torch

    import chip_smoke

    for name, value in dict(WIRE_CALLS=2, WIRE_MB=2, WIRE_BM_STATES=4, WIRE_BM_ADDS=20).items():
        monkeypatch.setattr(chip_smoke, name, value)
    runs = [chip_smoke.run_wire(torch, "cpu", (2, 256, 32), snapshots=True) for _ in range(2)]
    for key in ("replies", "snapshots", "batch_merge_blob", "grid_observe"):
        assert runs[0][key] == runs[1][key], key
    assert len(runs[0]["snapshots"]) == 6 and sum(runs[0]["replies"][:3]) > 0  # dominated adds were counted
    assert set(runs[0]["rates"]) >= {"topk_rmv packed multi x2", "worddocumentcount tuple", "leaderboard packed"}


def test_bridge_phase_gates_hold_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 15 at small shapes on the CPU: the wire-driven
    grid equals the engine driven directly (snapshot bytes, replies), the
    snapshot round trip holds, the held run ends in the same state with
    every call equal to its plain version, the contention ratio holds,
    and 15b's CPU runs agree."""
    import torch

    import chip_smoke

    for name, value in dict(R=4, I=256, B=64, BR=8, M=4, K=8, WIRE_R=2, WIRE_B=32, WIRE_SMALL=(2, 256, 16),
                            WIRE_CALLS=1, WIRE_MB=2, WIRE_BM_STATES=4, WIRE_BM_ADDS=20, CONTENTION_S=0.2).items():
        monkeypatch.setattr(chip_smoke, name, value)
    launches = chip_smoke.phase_bridge(torch, "cpu", dev="cpu")
    assert set(launches) == {"scatter_max_rows", "scatter_max_rows_copy", "delta_place", "sort_slots",
                             "sort_slots_9_16", "sort_slots_wide", "sort_slots_block", "sort_slots_global"}
