"""Python binding for the native (C++) corpus tokenizer / data-loader
(port of ``antidote_ccrdt_tpu/harness/native_tokenizer.py``).

``native/ccrdt_tokenizer.cpp`` implements the wordcount ingest hot loop —
tokenize on '\\n'/' ' keeping empties (wordcount.erl:76-85 parity),
per-document dedup (worddocumentcount.erl:76-86), FNV-1a hashed or exact
grow-on-demand vocabulary encoding — over whole corpus chunks in one C
call. Same build-on-demand + ctypes pattern as `native_host` (g++ into
the package's ``build/``); falls back cleanly when the toolchain is
unavailable (`available()` is False and the pure-Python `VocabEncoder` /
`hash_token` path in models/wordcount.py remains the ingest). The op
builders put their tensors on the device the caller names (the card by
default).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.wordcount import fnv1a_buckets  # noqa: F401  (one FNV-1a in the package)

_lib = None
_build_error: Optional[str] = None


def _ensure_lib():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    from ..ops import _build

    try:
        lib = _build.load_host_library("ccrdt_tokenizer", ["-pthread"])
    except (RuntimeError, OSError) as e:
        _build_error = str(e)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ccrdt_tok_new.restype = ctypes.c_void_p
    lib.ccrdt_tok_new.argtypes = [ctypes.c_int32]
    lib.ccrdt_tok_free.argtypes = [ctypes.c_void_p]
    lib.ccrdt_tok_encode.restype = ctypes.c_int64
    lib.ccrdt_tok_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, i32p, ctypes.c_int64,
    ]
    lib.ccrdt_tok_encode_batch.restype = ctypes.c_int64
    lib.ccrdt_tok_encode_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int,
        ctypes.c_int, i32p, ctypes.c_int64, i64p,
    ]
    lib.ccrdt_tok_encode_batch_mt.restype = ctypes.c_int64
    lib.ccrdt_tok_encode_batch_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, i64p, ctypes.c_int,
        ctypes.c_int, i32p, ctypes.c_int64, i64p, ctypes.c_int,
    ]
    lib.ccrdt_tok_vocab_size.restype = ctypes.c_int64
    lib.ccrdt_tok_vocab_size.argtypes = [ctypes.c_void_p]
    lib.ccrdt_tok_vocab_dump.restype = ctypes.c_int64
    lib.ccrdt_tok_vocab_dump.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _ensure_lib() is not None


def build_error() -> Optional[str]:
    _ensure_lib()
    return _build_error


class NativeTokenizer:
    """Corpus tokenizer over the C++ library.

    n_buckets > 0: hashed vocabulary (FNV-1a % n_buckets, byte-identical to
    models/wordcount.py:hash_token). n_buckets == 0: exact vocabulary grown
    on demand, ids dense in first-appearance order (VocabEncoder parity up
    to per-document ordering: the native encoder emits deduped tokens in
    first-appearance rather than sorted order — counts are unaffected).
    """

    def __init__(self, n_buckets: int = 0):
        lib = _ensure_lib()
        if lib is None:
            raise RuntimeError(f"native tokenizer unavailable: {_build_error}")
        self._lib = lib
        self._h = lib.ccrdt_tok_new(n_buckets)
        self.n_buckets = n_buckets

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ccrdt_tok_free(h)
            self._h = None

    def encode_batch(
        self,
        docs: Sequence[str],
        per_document: bool = False,
        threads: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tokenize+encode a document batch in one C call.

        `threads`: 0 = hardware thread count, 1 = serial, N = pool of N.
        Documents are independent, so the pool splits the batch by byte
        ranges; exact-mode vocabulary ids stay bit-identical to the serial
        encode (thread-local vocabs folded in document order — see the
        .cpp header). The C call releases the GIL either way.

        Returns (token_ids i32[N], doc_end i64[n_docs]) where document i's
        tokens span token_ids[doc_end[i-1]:doc_end[i]].
        """
        if not docs:
            return np.zeros(0, np.int32), np.zeros(0, np.int64)
        blobs = [d.encode("utf-8") for d in docs]
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        buf = b"".join(blobs)
        # Worst case one token per byte plus one trailing empty per doc.
        cap = len(buf) + len(blobs)
        out = np.empty(cap, np.int32)
        doc_end = np.empty(len(blobs), np.int64)
        n = self._lib.ccrdt_tok_encode_batch_mt(
            self._h,
            buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(blobs),
            1 if per_document else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap,
            doc_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            threads,
        )
        assert n <= cap, (n, cap)  # cap is a proven upper bound
        return out[:n].copy(), doc_end

    def vocab_size(self) -> int:
        return int(self._lib.ccrdt_tok_vocab_size(self._h))

    def vocab(self) -> List[str]:
        """Exact-mode id-ordered token list (hashed mode has no vocab)."""
        if self.n_buckets > 0:
            raise ValueError("hashed tokenizer has no materialized vocab")
        if self.vocab_size() == 0:
            return []
        need = self._lib.ccrdt_tok_vocab_dump(self._h, None, 0)
        buf = ctypes.create_string_buffer(int(need))
        self._lib.ccrdt_tok_vocab_dump(self._h, buf, need)
        return buf.raw[:need].decode("utf-8").split("\n")


def wordcount_ops_from_docs(
    docs_per_replica: Sequence[Sequence[str]],
    n_buckets: int,
    per_document: bool = False,
    key: int = 0,
    device: DeviceLike = None,
):
    """Data-loader: corpus -> dense `WordcountOps` (one padded token batch
    per replica, on `device`) through the native tokenizer. The standing
    replacement for per-document Python encoding on the streaming-corpus
    benchmark config (BASELINE.md: wordcount, 64 replicas, ragged vocab)."""
    from ..models.wordcount import WordcountOps

    dev = resolve_device(device)

    tok = NativeTokenizer(n_buckets)
    encoded = [
        tok.encode_batch(docs, per_document=per_document, threads=0)[0]
        for docs in docs_per_replica
    ]
    B = max((len(e) for e in encoded), default=0)
    R = len(encoded)
    tokens = np.full((R, B), -1, np.int32)  # -1 = padding
    for r, e in enumerate(encoded):
        tokens[r, : len(e)] = e
    return WordcountOps(
        key=torch.full((R, B), key, dtype=torch.int32, device=dev),
        token=torch.from_numpy(tokens).to(dev),
    )


def _worddoc_encode(docs_per_replica, n_buckets):
    """Shared encode core of the raw and compact worddoc array builders:
    EXACT-mode tokenize (no host dedup — the tokenizer only splits and
    ids, cheap on this 1-CPU host) + one vectorized FNV pass over the
    vocabulary. Returns ([(token_ids, per_doc_lengths)] per replica,
    bucket_of)."""
    tok = NativeTokenizer(0)  # exact mode
    encoded = []
    for docs in docs_per_replica:
        toks, doc_end = tok.encode_batch(docs, per_document=False, threads=0)
        lengths = np.diff(np.concatenate([[0], doc_end]))
        encoded.append((toks, lengths))
    return encoded, fnv1a_buckets(tok.vocab(), n_buckets)


def worddoc_arrays_from_docs(
    docs_per_replica: Sequence[Sequence[str]],
    n_buckets: int,
    key: int = 0,
):
    """Numpy core of `worddoc_ops_from_docs` (the benchmark times the host
    phase separately, so it needs the arrays before any device upload).

    Encodes in EXACT mode (see `_worddoc_encode`): the exact id is the
    dedup identity `uniq`, so the device dedup is string-level exactly
    like the scalar reference (two distinct words that hash-collide still
    count twice in their shared bucket). Returns dict of [R, B] i32
    arrays (key/doc/uniq/token); token -1 marks padding."""
    enc, bucket_of = _worddoc_encode(docs_per_replica, n_buckets)
    encoded = [
        (toks, np.repeat(np.arange(len(lens)), lens)) for toks, lens in enc
    ]
    B = max((len(t) for t, _ in encoded), default=0)
    R = len(encoded)
    uniq = np.full((R, B), -1, np.int32)
    tokens = np.full((R, B), -1, np.int32)  # -1 = padding
    doc_ids = np.zeros((R, B), np.int32)
    for r, (t, d) in enumerate(encoded):
        uniq[r, : len(t)] = t
        tokens[r, : len(t)] = bucket_of[t]
        doc_ids[r, : len(d)] = d
    return {
        "key": np.full((R, B), key, np.int32),
        "doc": doc_ids,
        "uniq": uniq,
        "token": tokens,
    }


def worddoc_compact_arrays_from_docs(
    docs_per_replica: Sequence[Sequence[str]],
    n_buckets: int,
    key: int = 0,
):
    """COMPACT ingest wire for `WordcountDense.apply_doc_ops_compact`
    of `worddoc_arrays_from_docs`'s three [R, B]
    planes, `doc` is the run-length expansion of per-document lengths and
    `token` is bucket_of[uniq] — both recomputable device-side. Ships
    only what carries information:

    * uniq      [R, B]    exact-vocab id stream (0-padded; live via counts)
    * doc_lens  [R, DOCS] tokens per document (0-padded)
    * counts    [R]       live tokens per replica
    * bucket_table [Vexact] exact id -> hashed bucket (resident upload,
      once per corpus — ~2 bytes per vocabulary WORD, not per token)

    All values fit u16 whenever the raw wire's `fits` check passes plus
    doc lengths < 65536 (the caller packs; this returns i32)."""
    encoded, bucket_of = _worddoc_encode(docs_per_replica, n_buckets)
    R = len(encoded)
    B = max((len(t) for t, _ in encoded), default=0)
    DOCS = max((len(ln) for _, ln in encoded), default=0)
    uniq = np.zeros((R, B), np.int32)
    doc_lens = np.zeros((R, DOCS), np.int32)
    counts = np.zeros((R,), np.int32)
    for r, (t, ln) in enumerate(encoded):
        uniq[r, : len(t)] = t
        doc_lens[r, : len(ln)] = ln
        counts[r] = len(t)
    return {
        "uniq": uniq,
        "doc_lens": doc_lens,
        "counts": counts,
        "bucket_table": bucket_of.astype(np.int32),
        "key": np.int32(key),  # scalar NK row, like the raw key plane
    }


def worddoc_ops_from_docs(
    docs_per_replica: Sequence[Sequence[str]],
    n_buckets: int,
    key: int = 0,
    device: DeviceLike = None,
):
    """Data-loader for `WordcountDense.apply_doc_ops`: raw per-token
    records with NO host-side dedup; the per-document dedup of
    worddocumentcount (worddocumentcount.erl:76-86) happens on device as
    one sort over the batch, on string identity (see
    `worddoc_arrays_from_docs`)."""
    from ..models.wordcount import WordDocOps

    dev = resolve_device(device)
    arrs = worddoc_arrays_from_docs(docs_per_replica, n_buckets, key=key)
    return WordDocOps(**{k: torch.from_numpy(v).to(dev) for k, v in arrs.items()})
