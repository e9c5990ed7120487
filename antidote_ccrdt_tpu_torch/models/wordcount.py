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

The scalar half of ``antidote_ccrdt_tpu/models/wordcount.py`` (the same
code, bit for bit in ``to_binary``); the vocabulary and the dense engine
are not ported yet.
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
