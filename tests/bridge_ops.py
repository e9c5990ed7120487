"""Seeded bridge requests for the differential bridge tests (no jax here:
``tests/test_torch_cuda.py`` uses them on the card machine): grid ops of
the six types in their tuple and packed wire shapes, whole scripts of a
grid's surface with its error frames, and a raw {packet, 4} connection
that returns reply frames as the bytes the server wrote."""

import socket
import struct

import numpy as np

from antidote_ccrdt_tpu_torch.bridge import protocol as P
from antidote_ccrdt_tpu_torch.bridge.server import _PACKED_COLUMNS
from antidote_ccrdt_tpu_torch.core.etf import Atom

A = Atom
TYPES = ["topk_rmv", "topk", "leaderboard", "average", "wordcount", "worddocumentcount"]
R, NK, I, D, K, M, V = 3, 2, 64, 3, 5, 2, 32
GEOMETRY = {
    "topk_rmv": dict(n_ids=I, n_dcs=D, size=K, slots_per_id=M),
    "topk": dict(n_ids=I, size=K),
    "leaderboard": dict(n_players=I, size=K),
    "average": {},
    "wordcount": dict(n_buckets=V),
    "worddocumentcount": dict(n_buckets=V),
}
COLUMNS = _PACKED_COLUMNS


class Raw:
    """A plain {packet, 4} socket: request frames out, reply frames back
    as the bytes the server wrote."""

    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=60)

    def send(self, op, req_id):
        self.sock.sendall(P.pack_frame(P.call(req_id, op)))

    def reply(self) -> bytes:
        head = self._read(4)
        return head + self._read(struct.unpack(">I", head)[0])

    def ask(self, op, req_id) -> bytes:
        self.send(op, req_id)
        return self.reply()

    def _read(self, n):
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            assert chunk, "server closed the connection"
            out += chunk
        return out

    def close(self):
        self.sock.close()


def tuple_ops(name, rng, n):
    """`n - r` seeded ops on replica r in `name`'s grid op shape (ts >= 1
    and in range, so that the JAX and port engines see the same valid
    batch). Every 4th topk_rmv op is a removal and every 5th leaderboard op
    a ban, so that a batch's padded widths stay put (fewer JAX compiles)."""
    out = []
    for r in range(R):
        ops = []
        for j in range(n - r):
            k, i = int(rng.integers(0, NK)), int(rng.integers(0, 6 if name == "topk_rmv" else 12))
            if name == "topk_rmv":
                if j % 4 == 3:
                    vc = sorted({int(d): int(rng.integers(1, 6)) for d in rng.integers(0, D, 2)}.items())
                    ops.append((A("rmv"), k, i, vc))
                else:
                    ops.append((A("add"), k, i, int(rng.integers(-50, 500)), int(rng.integers(0, D)),
                                int(rng.integers(1, 8))))
            elif name in ("topk",):
                ops.append((A("add"), k, i, int(rng.integers(-50, 500))))
            elif name == "leaderboard":
                ops.append((A("ban"), k, i) if j % 5 == 4 else (A("add"), k, i, int(rng.integers(0, 500))))
            elif name == "average":
                ops.append((A("add"), k, int(rng.integers(-100, 100)), int(rng.integers(0, 3))))
            elif name == "wordcount":
                ops.append((A("add"), k, int(rng.integers(0, V))))
            else:
                ops.append((A("doc_add"), k, int(rng.integers(0, 4)), int(rng.integers(0, 9)),
                            int(rng.integers(0, V))))
        out.append(ops)
    return out


def packed(name, per_replica):
    """The same ops as packed-columns groups (the Erlang client's
    pack_groups): one group a tag, columns concatenated in replica
    order."""
    groups = []
    for (type_name, tag), cols in COLUMNS.items():
        if type_name != name:
            continue
        counts = [sum(1 for op in ops if str(op[0]) == tag) for ops in per_replica]
        vals = {c: [] for c in cols}
        for ops in per_replica:
            for op in ops:
                if str(op[0]) != tag:
                    continue
                if tag == "rmv":
                    vals["key"].append(op[1])
                    vals["id"].append(op[2])
                    vals["vc_len"].append(len(op[3]))
                    vals["vc_dc"] += [d for d, _ in op[3]]
                    vals["vc_ts"] += [t for _, t in op[3]]
                else:
                    for c, v in zip(cols, op[1:]):
                        vals[c].append(v)
        if sum(counts):
            groups.append((A(tag), np.asarray(counts, "<i4").tobytes(),
                           [np.asarray(vals[c], "<i4").tobytes() for c in cols]))
    return groups


def grid_script(name, rng, g=b"g"):
    """Every grid op of `name`'s surface on one grid, with its error
    frames: new, tuple and packed applies with and without extras, a
    packed multi of 3 batches, observes of every cell, merge_all,
    applies on the merged (broadcast) state, and snapshots in between."""
    geo = {A(k): v for k, v in dict(n_replicas=R, n_keys=NK, **GEOMETRY[name]).items()}
    ops = [(A("grid_new"), g, A(name), geo)]
    batches = [tuple_ops(name, rng, 10) for _ in range(8)]
    ops += [(A("grid_apply"), g, batches[0]), (A("grid_apply_extras"), g, batches[1]),
            (A("grid_apply_packed"), g, packed(name, batches[2])),
            (A("grid_apply_extras_packed"), g, packed(name, batches[3])),
            (A("grid_apply_packed_multi"), g, [packed(name, b) for b in batches[4:7]]),
            (A("grid_to_binary"), g)]
    ops += [(A("grid_observe"), g, r, k) for r in range(R) for k in range(NK)]
    ops += [(A("grid_merge_all"), g), (A("grid_to_binary"), g), (A("grid_observe"), g, 1, 1),
            (A("grid_apply_extras"), g, batches[7]), (A("grid_to_binary"), g),
            (A("grid_apply_packed_multi"), g, [packed(name, b) for b in batches[4:6]]),
            (A("grid_merge_all"), g), (A("grid_merge_all"), g), (A("grid_to_binary"), g)]
    ops += [(A("grid_observe"), g, r, k) for r in range(R) for k in range(NK)]
    # Error frames: out-of-range cells and ops, unknown tags, a short
    # replica list, a batch that fails validation inside a multi, a
    # missing grid.
    bad_op = {"topk_rmv": (A("add"), 0, I, 1, 0, 1), "topk": (A("add"), NK, 0, 1),
              "leaderboard": (A("ban"), 0, I), "average": (A("add"), 0, 1, -1),
              "wordcount": (A("add"), 0, V), "worddocumentcount": (A("doc_add"), 0, -1, 0, 0)}[name]
    ops += [(A("grid_observe"), g, R, 0), (A("grid_apply"), g, [[bad_op]] + [[]] * (R - 1)),
            (A("grid_apply"), g, [[(A("nope"), 0)]] + [[]] * (R - 1)), (A("grid_apply"), g, [[]]),
            (A("grid_apply_packed_multi"), g, [packed(name, batches[0]),
                                               [(A("add"), b"\x01\x00\x00", [])]]),
            (A("grid_apply_packed"), g, [(A("nope"), b"", [])]),
            (A("grid_to_binary"), b"missing"), (A("grid_to_binary"), g)]
    return ops
