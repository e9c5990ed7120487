"""The port's durability plane (``harness/wal.py``, ``harness/checkpoint.py``)
against the JAX package's.

* Every case of ``tests/test_wal.py`` runs again through the port, with
  the drills of ``torch_twins`` in place of ``scripts/elastic_demo.py``'s
  (the same op streams, built for either package).
* The files themselves: segment files, WAL directories and checkpoint
  files the two packages write for the same appends and steps are equal
  byte for byte, and each package recovers a directory the other wrote
  to the state the writer had.
* ``checkpoint.py``: the scalar cases of ``tests/test_checkpoint.py``
  through the port, dense and partitioned checkpoints loaded across the
  packages, and ``RejoinStreamer`` against a store that serves psnaps.
"""

import os
import struct

import numpy as np
import pytest

from antidote_ccrdt_tpu.core import partition as jpt
from antidote_ccrdt_tpu.core import serial as jserial
from antidote_ccrdt_tpu.harness import checkpoint as jck
from antidote_ccrdt_tpu.harness import wal as jwal
from antidote_ccrdt_tpu.utils import faults as jfaults
from antidote_ccrdt_tpu_torch.core import partition as ppt
from antidote_ccrdt_tpu_torch.core import serial as pserial
from antidote_ccrdt_tpu_torch.harness import checkpoint as pck
from antidote_ccrdt_tpu_torch.harness import wal as pwal
from antidote_ccrdt_tpu_torch.utils import faults as pfaults
from antidote_ccrdt_tpu_torch.utils.metrics import Metrics
from torch_twins import AverageDrill, TopkRmvDrill, assert_tree, leaf_bytes, port_copy

globals().update(port_copy("test_wal.py", replace=[("from scripts.elastic_demo import DRILLS",
                                                     "from torch_twins import DRILLS")]))
# test_dense_checkpoint_roundtrip builds a JAX engine with no device:
# test_dense_checkpoints_cross_load_both_ways below covers it.
globals().update(port_copy("test_checkpoint.py", skip=["test_dense_checkpoint_roundtrip"]))


@pytest.fixture(autouse=True)
def _no_faults_in_either_package():
    pfaults.uninstall()
    jfaults.uninstall()
    yield
    pfaults.uninstall()
    jfaults.uninstall()


def files_under(root):
    """{relative path: bytes} of every file below `root`."""
    out = {}
    for d, _dirs, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_segment_files_are_byte_equal_to_jax(tmp_path):
    appends = [(i, bytes([i % 251]) * (3 * i + 1)) for i in range(40)]
    for name, mod in (("port", pwal), ("jax", jwal)):
        w = mod.WriteAheadLog(str(tmp_path / name), segment_bytes=256)
        for seq, payload in appends:
            w.append(seq, payload, sync=seq % 3 == 0)
        w.compact(9)
        w.close()
    port, jax_ = files_under(tmp_path / "port"), files_under(tmp_path / "jax")
    assert len(port) > 3 and port == jax_
    read_by_jax = list(jwal.WriteAheadLog(str(tmp_path / "port")).records())
    assert read_by_jax == list(pwal.WriteAheadLog(str(tmp_path / "jax")).records())
    assert read_by_jax[-31:] == appends[9:] and len(read_by_jax) < len(appends)


def run_drill(mod, drill, root, steps, *, partitions=None, durability="group", checkpoint_at=None, crash=False):
    """Log `steps` steps of `drill` through `mod.ElasticWal` under
    `root`; returns the final published view."""
    dense = drill.make_engine()
    state = drill.init(dense)
    wal = mod.ElasticWal(str(root), "w0", dense, drill.publish_name,
                         partitions=partitions, durability=durability)
    for step in range(steps):
        pre = drill.pub_state(dense, state)
        state = drill.apply(dense, state, step, [0, 2])
        wal.log_step(step, [0, 2], pre, drill.pub_state(dense, state))
        wal.flush()
        if step == checkpoint_at:
            wal.checkpoint(drill.pub_state(dense, state), step)
    if not crash:
        wal.close()
    return dense, drill.pub_state(dense, state)


def recover(mod, drill, root, partitions=None):
    dense = drill.make_engine()
    m = Metrics() if mod is pwal else None
    wal = mod.ElasticWal(str(root), "w0", dense, drill.publish_name, partitions=partitions, metrics=m)
    rec, last_step, owned = wal.recover(drill.pub_state(dense, drill.init(dense)))
    wal.close()
    return rec, last_step, owned


DRILL_KINDS = [(TopkRmvDrill, 4), (TopkRmvDrill, None), (AverageDrill, None)]


@pytest.mark.parametrize("drill_cls,partitions", DRILL_KINDS)
def test_wal_directories_are_byte_equal_to_jax(tmp_path, monkeypatch, drill_cls, partitions):
    monkeypatch.setenv("CCRDT_WAL_GROUP_MS", "1000000")
    for name, mod, pkg in (("port", pwal, "torch"), ("jax", jwal, "jax")):
        run_drill(mod, drill_cls(pkg), tmp_path / name, 6, partitions=partitions, checkpoint_at=2)
    port, jax_ = files_under(tmp_path / "port"), files_under(tmp_path / "jax")
    assert any(k.endswith(".wal") for k in port) and any(k.endswith("snap.ckpt") for k in port)
    if partitions:
        assert any(k.startswith(os.path.join("wal-w0", "stream-")) for k in port)
    assert port == jax_


@pytest.mark.parametrize("drill_cls,partitions", DRILL_KINDS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_recovers_the_others_wal(tmp_path, monkeypatch, drill_cls, partitions, writer):
    """A log written (and crashed, without close) by one package recovers
    under the other to the writer's live state."""
    monkeypatch.setenv("CCRDT_WAL_GROUP_MS", "1000000")
    wmod, rmod = (pwal, jwal) if writer == "port" else (jwal, pwal)
    wpkg, rpkg = ("torch", "jax") if writer == "port" else ("jax", "torch")
    _dense, live = run_drill(wmod, drill_cls(wpkg), tmp_path, 5, partitions=partitions, checkpoint_at=1, crash=True)
    rec, last_step, owned = recover(rmod, drill_cls(rpkg), tmp_path, partitions)
    assert last_step == 4 and owned == {0, 2}
    assert leaf_bytes(rec) == leaf_bytes(live)


def test_wal_env_knobs_read_like_jax(tmp_path, monkeypatch):
    drill = TopkRmvDrill()
    monkeypatch.setenv("CCRDT_WAL_DURABILITY", "ASYNC")
    monkeypatch.setenv("CCRDT_WAL_STREAMS", "3")
    monkeypatch.setenv("CCRDT_WAL_GROUP_BYTES", "12345")
    monkeypatch.setenv("CCRDT_WAL_GROUP_MS", "7.5")
    got = pwal.ElasticWal(str(tmp_path / "p"), "w0", drill.make_engine(), "topk_rmv")
    want = jwal.ElasticWal(str(tmp_path / "j"), "w0", TopkRmvDrill("jax").make_engine(), "topk_rmv")
    assert (got.durability, got.nstreams, got.group_bytes, got.group_ms) == (
        want.durability, want.nstreams, want.group_bytes, want.group_ms) == ("async", 3, 12345, 7.5)
    got.close()
    want.close()
    assert pwal.durability_mode("bogus") == jwal.durability_mode("bogus") == "group"


def test_group_byte_bound_force_flushes_like_jax(tmp_path, monkeypatch):
    """A record past CCRDT_WAL_GROUP_BYTES flushes at once: the staged
    window never holds it."""
    monkeypatch.setenv("CCRDT_WAL_GROUP_BYTES", "1")
    monkeypatch.setenv("CCRDT_WAL_GROUP_MS", "1000000")
    for mod, pkg in ((pwal, "torch"), (jwal, "jax")):
        drill = TopkRmvDrill(pkg)
        dense = drill.make_engine()
        state = drill.init(dense)
        wal = mod.ElasticWal(str(tmp_path / pkg), "w0", dense, "topk_rmv", durability="group")
        nxt = drill.apply(dense, state, 0, [1])
        wal.log_step(0, [1], state, nxt)
        assert wal.durable_seq == 0 and not wal._pending
        wal.close()


# --- checkpoint.py across the packages ---------------------------------------------


def test_dense_checkpoints_cross_load_both_ways(tmp_path):
    from torch_twins import topk_rmv_pair

    (jd, js), (pd, ps) = topk_rmv_pair(3)
    pck.save_dense_checkpoint(str(tmp_path / "p.ckpt"), "topk_rmv", ps[-1], step=17)
    jck.save_dense_checkpoint(str(tmp_path / "j.ckpt"), "topk_rmv", js[-1], step=17)
    assert (tmp_path / "p.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    step, name, back = jck.load_dense_checkpoint(str(tmp_path / "p.ckpt"), js[0], dense=jd)
    assert (step, name) == (17, "topk_rmv")
    assert_tree(ps[-1], back)
    step, name, back = pck.load_dense_checkpoint(str(tmp_path / "j.ckpt"), ps[0], dense=pd)
    assert (step, name) == (17, "topk_rmv")
    assert_tree(back, js[-1])
    with pytest.raises(ValueError):
        other = TopkRmvDrill().make_engine()  # another I/M/D: refused by check_state
        pck.load_dense_checkpoint(str(tmp_path / "j.ckpt"), ps[0], dense=other)


@pytest.mark.parametrize("kind", ["topk_rmv", "leaderboard"])
def test_partitioned_checkpoints_are_byte_equal_and_cross_load(tmp_path, kind):
    from torch_twins import leaderboard_pair, topk_rmv_pair

    if kind == "topk_rmv":
        (jd, js), (pd, ps) = topk_rmv_pair(5)
        jstate, pstate, jbase, pbase = js[-1], ps[-1], jd.init(3, 1), pd.init(3, 1)
    else:
        (jd, jstate), (pd, pstate) = leaderboard_pair(6)
        jbase, pbase = jd.init(2, 2), pd.init(2, 2)
    P = 4
    n = pck.save_partitioned_checkpoint(str(tmp_path / "p"), kind, pstate, pd, 9, partitions=P)
    assert n == jck.save_partitioned_checkpoint(str(tmp_path / "j"), kind, jstate, jd, 9, partitions=P)
    assert files_under(tmp_path / "p") == files_under(tmp_path / "j")
    step, name, back, durable = jck.load_partitioned_checkpoint(str(tmp_path / "p"), jbase, jd)
    assert (step, name, sorted(durable)) == (9, kind, list(range(P + 1)))
    assert_tree(pstate, back)
    step, name, back, durable = pck.load_partitioned_checkpoint(str(tmp_path / "j"), pbase, pd)
    assert (step, name, sorted(durable)) == (9, kind, list(range(P + 1)))
    assert_tree(back, jstate)
    # A subset save writes no manifest; a torn shard is skipped, not fatal.
    pck.save_partitioned_checkpoint(str(tmp_path / "s"), kind, pstate, pd, 3, partitions=P, parts=[1, 2])
    assert sorted(os.listdir(tmp_path / "s")) == ["shard-0001.ckpt", "shard-0002.ckpt"]
    shard = tmp_path / "s" / "shard-0002.ckpt"
    shard.write_bytes(shard.read_bytes()[:10])
    assert pck.load_partitioned_checkpoint(str(tmp_path / "s"), pbase, pd)[3] == [1]


class PsnapStore:
    """A peer that serves its digest vector and psnaps of one live state
    (the three calls `RejoinStreamer` makes of a transport), through the
    CCPT and dense-blob encodings a wire would carry."""

    def __init__(self, pt, serial, dense, live, P, metrics):
        self.pt, self.serial, self.dense, self.live, self.P = pt, serial, dense, live, P
        self.metrics = metrics
        self.fetches = 0

    def fetch_digests(self, peer):
        return self.pt.decode_digest_blob(self.pt.encode_digest_blob(5, self.pt.state_digests(self.live, self.P)))

    def request_psnaps(self, peer, parts):
        pass

    def fetch_psnap(self, peer, part, like, validate=None):
        self.fetches += 1
        payload = self.serial.dumps_dense("topk_rmv_psnap", self.pt.restrict_psnap(self.dense, self.live, part, self.P))
        seq, _part, payload = self.pt.decode_psnap_blob(self.pt.encode_psnap_blob(5, part, payload))
        _name, delta = self.serial.loads_dense(payload, like)
        assert validate is None or validate(delta)
        return seq, delta


def test_rejoin_streamer_resumes_like_jax(tmp_path):
    """Kill the streamer after two shards: the next incarnation plans only
    what never became durable, ends at the peer's digests, and every shard
    file equals the one JAX's streamer writes."""
    from antidote_ccrdt_tpu.utils.metrics import Metrics as JaxMetrics
    from torch_twins import topk_rmv_pair

    (jd, js), (pd, ps) = topk_rmv_pair(8)
    P = 4
    roots = {}
    for name, ck, pt, serial, dense, live, base, metrics in (
        ("port", pck, ppt, pserial, pd, ps[-1], pd.init(3, 1), Metrics()),
        ("jax", jck, jpt, jserial, jd, js[-1], jd.init(3, 1), JaxMetrics()),
    ):
        store = PsnapStore(pt, serial, dense, live, P, metrics)
        root = str(tmp_path / name)
        s1 = ck.RejoinStreamer(root, "topk_rmv", dense, store, "a", partitions=P)
        st = s1.start(base)
        plan = list(s1.plan)
        assert len(plan) >= 3
        for _ in range(2):
            st, part, _done = s1.step(st)
            assert part is not None
        s2 = ck.RejoinStreamer(root, "topk_rmv", dense, store, "a", partitions=P)
        st2 = s2.start(base)
        assert s2.plan == plan[2:]
        st2 = s2.run(st2)
        assert not s2.plan and store.fetches == len(plan)
        assert np.array_equal(pt.state_digests(st2, P), pt.state_digests(live, P))
        assert metrics.counters["rejoin.parts_streamed"] == len(plan)
        roots[name] = root
    assert files_under(roots["port"]) == files_under(roots["jax"])


def test_legacy_single_file_checkpoint_loads(tmp_path):
    from torch_twins import topk_rmv_pair

    (jd, js), (pd, ps) = topk_rmv_pair(9)
    jck.save_dense_checkpoint(str(tmp_path / "snap.ckpt"), "topk_rmv", js[-1], step=4)
    step, name, back, durable = pck.load_partitioned_checkpoint(str(tmp_path), pd.init(3, 1), pd)
    assert (step, name, durable) == (4, "topk_rmv", [])
    assert_tree(back, js[-1])
    (tmp_path / "snap.ckpt").write_bytes(struct.pack("<Q", 1) + b"torn")
    assert pck.load_partitioned_checkpoint(str(tmp_path), ps[0], pd)[0] == -1
