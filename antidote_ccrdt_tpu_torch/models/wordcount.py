"""wordcount / worddocumentcount: grow-only word -> count maps.

Reference: ``src/antidote_ccrdt_wordcount.erl`` and
``src/antidote_ccrdt_worddocumentcount.erl``. An ``add`` carries a document
(a string); the update splits it on ``"\\n"`` / ``" "`` and folds counts
(``wordcount.erl:76-85``). ``worddocumentcount`` dedupes words within the
document first (through a gb_set, ``worddocumentcount.erl:76-86``) so each
document contributes at most 1 per word. Downstream is stateless
(``wordcount.erl:50-51``).

Tokenization parity note: Erlang's ``binary:split(_, _, [global])`` keeps
empty segments, so consecutive separators yield empty-string "words" that
the reference counts. We reproduce that exactly (``re.split``).

Deliberate fix (SURVEY.md §2 quirk #3): the reference's ``compact_ops``
returns ``{noop, noop}`` — *discarding both ops* and silently losing data if
the host compacts (``wordcount.erl:70-72``). Word counts form a trivial
commutative monoid, so here compaction fuses the two ops into one
``add_counts`` op carrying the combined counts.

A port of ``antidote_ccrdt_tpu/models/wordcount.py``: the scalar half and
the host vocabularies are the same code (bit for bit in ``to_binary``);
the dense half is a hashed-vocabulary count table ``i32[R, NK, V]`` whose
op batch is one scatter-add and whose cross-replica merge is ``+``
(MONOID).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

from ..core import serial
from ..core.behaviour import EffectOp, PrepareOp, registry
from ..core.clock import ClockContext

_SPLIT = re.compile(r"[\n ]")


def tokenize(doc: str) -> list:
    """Erlang binary:split on "\\n" and " " with [global]: keeps empties."""
    return _SPLIT.split(doc)


class _WordcountBase:
    #: dedupe tokens per document before counting (worddocumentcount)
    per_document: bool = False

    def new(self) -> Dict[str, int]:
        return {}

    def value(self, state: Dict[str, int]) -> Dict[str, int]:
        return dict(state)

    def downstream(
        self, op: PrepareOp, state: Any, ctx: ClockContext
    ) -> Optional[EffectOp]:
        kind, payload = op
        assert kind == "add"
        return ("add", payload)

    def update(self, effect: EffectOp, state: Dict[str, int]) -> Tuple[Any, list]:
        kind, payload = effect
        out = dict(state)
        if kind == "add":
            tokens = tokenize(payload)
            if self.per_document:
                tokens = set(tokens)
            for w in tokens:
                out[w] = out.get(w, 0) + 1
            return out, []
        if kind == "add_counts":
            for w, c in payload.items():
                out[w] = out.get(w, 0) + c
            return out, []
        raise ValueError(f"unsupported effect {effect!r}")

    def require_state_downstream(self, op: PrepareOp) -> bool:
        return False

    def is_operation(self, op: Any) -> bool:
        return (
            isinstance(op, tuple)
            and len(op) == 2
            and op[0] == "add"
            and isinstance(op[1], str)
        )

    def is_replicate_tagged(self, effect: EffectOp) -> bool:
        return False

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        return e1[0] in ("add", "add_counts") and e2[0] in ("add", "add_counts")

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        """Fuse both ops' counts (quirk #3 fix — never drop data)."""
        merged: Dict[str, int] = {}
        for e in (e1, e2):
            merged, _ = self.update(e, merged)
        return None, ("add_counts", merged)

    def equal(self, a: Any, b: Any) -> bool:
        return a == b

    def to_binary(self, state: Any) -> bytes:
        return serial.dumps_scalar(self.type_name, state)

    def from_binary(self, data: bytes) -> Any:
        name, state = serial.loads_scalar(data)
        assert name == self.type_name
        return state


class WordcountScalar(_WordcountBase):
    type_name = "wordcount"
    per_document = False


class WordDocumentCountScalar(_WordcountBase):
    type_name = "worddocumentcount"
    per_document = True


registry.register("wordcount", scalar=WordcountScalar())
registry.register("worddocumentcount", scalar=WordDocumentCountScalar())


# --- host vocabularies -----------------------------------------------------


class VocabEncoder:
    """Exact token -> dense id mapping (host-side), grown on demand.

    Tokenization happens on the host (the reference also does the split in
    the update itself, wordcount.erl:76-85); the device only ever sees
    integer token ids. For an unbounded vocabulary use `hash_token`
    instead — collisions then conflate words, the standard
    hashed-vocabulary trade."""

    def __init__(self):
        self.vocab: Dict[str, int] = {}

    def encode(self, doc: str, per_document: bool = False) -> list:
        tokens = tokenize(doc)
        if per_document:
            # worddocumentcount: <=1 contribution per word per document
            # (worddocumentcount.erl:76-86).
            tokens = sorted(set(tokens))
        out = []
        for t in tokens:
            if t not in self.vocab:
                self.vocab[t] = len(self.vocab)
            out.append(self.vocab[t])
        return out

    def decode_counts(self, counts) -> Dict[str, int]:
        inv = {i: t for t, i in self.vocab.items()}
        return {
            inv[i]: int(c) for i, c in enumerate(counts) if int(c) != 0 and i in inv
        }


def hash_token(token: str, n_buckets: int) -> int:
    """FNV-1a 32-bit, stable across runs/processes (unlike Python's hash)."""
    h = 2166136261
    for b in token.encode("utf-8"):
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h % n_buckets


class HashedVocab:
    """Hashed-vocabulary encoder WITH collision accounting.

    Mechanism: first-seen token per bucket; a different token hashing to
    an owned bucket flags the bucket collided, and every op landing on a
    flagged bucket (the owner's included) counts as conflated —
    `lost`-style observability (cf. WordcountDenseState.lost) for the
    exactness loss the hashed table otherwise hides. Ops the owner issued
    BEFORE the bucket was flagged are not retroactively counted
    (streaming accounting); the per-bucket decoded count is the true
    conflated mass once flagged. Host-side by design: the encoder is the
    only place exact string identity exists (the device sees integer
    buckets; reference semantics are exact counts, wordcount.erl:76-85).

    SCOPE: accounting is per encoder. A cross-replica collision (replica 1
    feeds word A, replica 2 feeds word B, same bucket) is invisible to
    either side alone — `merge` the encoders (alongside the count-state
    merge) before trusting `report`/`decode_counts`; `decode_counts`
    reports counts in buckets this encoder never saw under an explicit
    `<unattributed ...>` key rather than dropping or misattributing them.

    Counts in collided buckets are sums over the listed words — still
    deterministic and convergent, just coarser than the reference; every
    other bucket is exact.
    """

    def __init__(self, n_buckets: int):
        self.V = n_buckets
        self._owner: Dict[int, str] = {}
        self.collided: Dict[int, list] = {}  # bucket -> [owner, others...]
        self.conflated_ops = 0  # ops landing on a bucket after it was flagged

    def encode_token(self, token: str) -> int:
        b = hash_token(token, self.V)
        own = self._owner.get(b)
        if own is None:
            self._owner[b] = token
        elif own != token:
            members = self.collided.setdefault(b, [own])
            if token not in members:
                members.append(token)
        if b in self.collided:
            self.conflated_ops += 1
        return b

    def encode(self, doc: str, per_document: bool = False) -> list:
        tokens = tokenize(doc)
        if per_document:
            tokens = sorted(set(tokens))
        return [self.encode_token(t) for t in tokens]

    def merge(self, other: "HashedVocab") -> None:
        """Union another encoder's ownership/collision knowledge into this
        one — the encoder-side counterpart of the count-state merge. A
        bucket owned by different words on the two sides becomes collided
        here (the cross-replica collision neither side could see)."""
        if other.V != self.V:
            raise ValueError(f"bucket-count mismatch: {self.V} vs {other.V}")
        for b, tok in other._owner.items():
            own = self._owner.get(b)
            if own is None:
                self._owner[b] = tok
            elif own != tok:
                members = self.collided.setdefault(b, [own])
                if tok not in members:
                    members.append(tok)
        for b, ws in other.collided.items():
            members = self.collided.setdefault(b, [self._owner[b]])
            for w in ws:
                if w not in members:
                    members.append(w)
        self.conflated_ops += other.conflated_ops

    def report(self) -> Dict[str, Any]:
        return {
            "n_buckets": self.V,
            "buckets_owned": len(self._owner),
            "buckets_collided": len(self.collided),
            "conflated_ops": self.conflated_ops,
            "collided_words": {b: list(ws) for b, ws in self.collided.items()},
        }

    def decode_counts(self, counts) -> Dict[Any, int]:
        """bucket counts -> {word: count}. A collided bucket's count is
        reported under a tuple of ALL its words (explicitly conflated, no
        silent winner); a nonzero bucket this encoder never fed is
        reported under an explicit unattributed key (it came from another
        pipeline — merge the encoders for attribution)."""
        out: Dict[Any, int] = {}
        for b, c in enumerate(counts):
            c = int(c)
            if c == 0:
                continue
            if b in self.collided:
                out[tuple(self.collided[b])] = c
            elif b in self._owner:
                out[self._owner[b]] = c
            else:
                out[f"<unattributed bucket {b}>"] = c
        return out


def fnv1a_buckets(words, n_buckets: int):
    """Vectorized FNV-1a % n_buckets over a word list, equal to
    `hash_token` word by word: one numpy pass per byte position over the
    vocabulary."""
    import numpy as np

    if not words:
        return np.zeros(0, np.int32)
    blobs = [w.encode("utf-8") for w in words]
    L = max(len(b) for b in blobs)
    mat = np.zeros((len(blobs), L), np.uint32)
    lens = np.asarray([len(b) for b in blobs])
    for i, b in enumerate(blobs):
        mat[i, : len(b)] = np.frombuffer(b, np.uint8)
    h = np.full(len(blobs), 2166136261, np.uint32)
    for j in range(L):
        h = np.where(j < lens, (h ^ mat[:, j]) * np.uint32(16777619), h)
    return (h % np.uint32(n_buckets)).astype(np.int32)


def vocab_collision_audit(words, n_buckets: int) -> Dict[str, Any]:
    """Exact collision census of a vocabulary under FNV-1a % n_buckets:
    the measured collision-rate artifact for a deployment's (vocab, V)
    choice."""
    import numpy as np

    words = list(dict.fromkeys(words))
    buckets = fnv1a_buckets(words, n_buckets)
    _, counts = np.unique(buckets, return_counts=True)
    n_collided_buckets = int((counts > 1).sum())
    words_in_collided = int(counts[counts > 1].sum())
    return {
        "n_words": len(words),
        "n_buckets": n_buckets,
        "buckets_collided": n_collided_buckets,
        "words_in_collided_buckets": words_in_collided,
        "word_collision_rate": words_in_collided / max(1, len(words)),
    }


# --- dense level -----------------------------------------------------------

import dataclasses  # noqa: E402

import torch  # noqa: E402

from ..core.behaviour import MergeKind  # noqa: E402
from ..device import DeviceLike, resolve_device  # noqa: E402
from ..ops.dense_table import table_addresses, wrapping_add  # noqa: E402

I32 = torch.int32


@dataclasses.dataclass
class WordcountDenseState:
    counts: torch.Tensor  # i32[R, NK, V]
    lost: torch.Tensor  # i32[R, NK] — tokens dropped because id >= V


@dataclasses.dataclass
class WordcountOps:
    """Token-id batch per replica; token < 0 marks padding."""

    key: torch.Tensor  # i32[R, B]
    token: torch.Tensor  # i32[R, B]


@dataclasses.dataclass
class WordDocOps:
    """Raw per-token records for device-side per-document dedup
    (`apply_doc_ops`); token < 0 marks padding. A document's records must
    not split across batches (dedup is per batch).

    `uniq` is the dedup identity and `token` the count target. They
    differ in hashed-vocabulary mode: dedup must be on *string* identity
    (worddocumentcount.erl:76-86 — two distinct words that hash-collide
    still contribute 2 to the shared bucket), so `uniq` carries the
    exact-vocabulary id and `token` the hashed bucket. In exact mode they
    are the same array."""

    key: torch.Tensor  # i32[R, B]
    doc: torch.Tensor  # i32[R, B]
    uniq: torch.Tensor  # i32[R, B]  dedup identity (exact-vocab id)
    token: torch.Tensor  # i32[R, B]  count target (bucket or exact id)


class WordcountDense:
    """Both wordcount variants share this engine (port of the JAX
    ``WordcountDense``): the per-document dedup of worddocumentcount is an
    encode-time concern (VocabEncoder per_document) or `apply_doc_ops`.
    Counts form a commutative monoid, so per-replica states are deltas and
    merge is + (MONOID). ``device``: where `init` puts states (default:
    the CUDA card; raises without one)."""

    type_name = "wordcount"
    merge_kind = MergeKind.MONOID

    def __init__(self, n_buckets: int, device: DeviceLike = None):
        self.V = n_buckets
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int = 1) -> WordcountDenseState:
        return WordcountDenseState(
            counts=torch.zeros((n_replicas, n_keys, self.V), dtype=I32, device=self.device),
            lost=torch.zeros((n_replicas, n_keys), dtype=I32, device=self.device),
        )

    def _count(self, state: WordcountDenseState, k: torch.Tensor, token: torch.Tensor):
        """Add 1 at (k, token) per op, as JAX's ``counts.at[k, token].add(1,
        mode="drop")``: an index in [-n, 0) wraps to index + n, one outside
        [-n, n) drops the op. Tokens >= V count in `lost` at their key,
        which wraps the same way."""
        R, NK, V = state.counts.shape
        every = torch.ones_like(k, dtype=torch.bool)
        flat, _ = table_addresses((R, NK, V), k, token, every)
        counts = wrapping_add(state.counts, flat, torch.ones_like(flat, dtype=I32))
        over = torch.where(token >= V, k, NK)
        flat, _ = table_addresses((R, 1, NK), torch.zeros_like(over), over, every)
        lost = wrapping_add(state.lost, flat, torch.ones_like(flat, dtype=I32))
        return WordcountDenseState(counts, lost)

    def apply_ops(self, state: WordcountDenseState, ops: WordcountOps):
        NK = state.counts.shape[1]
        k = torch.where(ops.token >= 0, ops.key, NK)  # padding -> dropped
        return self._count(state, k, ops.token), None

    def apply_doc_ops(self, state: WordcountDenseState, ops: WordDocOps):
        """worddocumentcount ingest with the per-document dedup on the
        device (worddocumentcount.erl:76-86 semantics): raw per-token
        records stream in un-deduped; a stable sort by (key, doc, uniq)
        makes duplicates adjacent, only run heads count, and the head's
        `token` (the hashed bucket in hashed-vocab mode) receives the
        count. Dedup on `uniq` — string identity — keeps hash-collision
        semantics equal to the scalar/host paths."""
        NK = state.counts.shape[1]
        k = torch.where(ops.token >= 0, ops.key, NK).to(I32)
        # (k, doc) packed exactly into one int64 word, then uniq: two
        # stable sorts, the minor key first.
        p1 = torch.sort(ops.uniq, dim=-1, stable=True).indices
        major = k.to(torch.int64) * 2**32 + (ops.doc.to(torch.int64) + 2**31)
        p2 = torch.sort(torch.gather(major, -1, p1), dim=-1, stable=True).indices
        perm = torch.gather(p1, -1, p2)
        ks, ds, us, ts = (torch.gather(x.to(I32), -1, perm) for x in (k, ops.doc, ops.uniq, ops.token))

        def same(x):
            return x == torch.roll(x, 1, dims=-1)

        dup = same(ks) & same(ds) & same(us)
        dup[..., 0] = False
        ks = ks.masked_fill(dup, NK)  # only run heads count
        return self._count(state, ks, ts), None

    def apply_doc_ops_compact(
        self,
        state: WordcountDenseState,
        uniq: torch.Tensor,
        doc_lens: torch.Tensor,
        counts: torch.Tensor,
        bucket_table: Optional[torch.Tensor] = None,
        key=0,
    ):
        """`apply_doc_ops` fed by the compact ingest wire: the wire ships
        only `uniq` [R, B] + `doc_lens` [R, DOCS] + per-replica live
        `counts` [R], and the two other planes are rebuilt here:

        * doc — positions are document-major, so doc[p] is a searchsorted
          (right side) of p against the cumulative lengths (empty
          documents own no positions);
        * token — one gather from the resident `bucket_table`; `None` =
          exact mode (token == uniq). A live uniq id outside the table has
          no bucket and becomes token V, which lands in `lost`.

        Padding beyond counts[r] is remapped to token=-1 exactly like the
        raw wire's sentinel. `key` (scalar) targets one NK row; batches
        spanning keys use the raw WordDocOps wire."""
        B = uniq.shape[1]
        dev = uniq.device
        pos = torch.arange(B, dtype=I32, device=dev)
        live = pos[None, :] < counts[:, None]
        uniq32 = torch.where(live, uniq.to(I32), -1)
        cum = torch.cumsum(doc_lens.to(I32), dim=-1, dtype=I32)
        doc = torch.searchsorted(cum, pos.expand(uniq.shape[0], B).contiguous(), right=True).to(I32)
        if bucket_table is None:
            token = uniq32
        else:
            tbl = bucket_table.to(I32)
            n = tbl.shape[0]
            token = tbl[uniq32.clamp(0, n - 1).to(torch.int64)]
            token = torch.where((uniq32 >= n) | (uniq32 < 0), self.V, token)
            token = torch.where(live, token, -1).to(I32)
        ops = WordDocOps(
            key=torch.as_tensor(key, dtype=I32, device=dev).expand_as(uniq32),
            doc=doc, uniq=uniq32, token=token,
        )
        return self.apply_doc_ops(state, ops)

    def merge(self, a: WordcountDenseState, b: WordcountDenseState) -> WordcountDenseState:
        return WordcountDenseState(a.counts + b.counts, a.lost + b.lost)

    def observe(self, state: WordcountDenseState):
        return state.counts

    def equal(self, a: WordcountDenseState, b: WordcountDenseState) -> bool:
        return bool((a.counts == b.counts).all())


def make_dense(n_buckets: int, device: DeviceLike = None) -> WordcountDense:
    return WordcountDense(n_buckets=n_buckets, device=device)


# Both wordcount variants share the dense engine; the per-document dedup of
# worddocumentcount happens at encode time or in `apply_doc_ops`.
registry.register("wordcount", dense_factory=make_dense)
registry.register("worddocumentcount", dense_factory=make_dense)
