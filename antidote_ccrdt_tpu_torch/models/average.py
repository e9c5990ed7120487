"""average: aggregated mean as a (sum, count) pair.

Reference: ``src/antidote_ccrdt_average.erl``. State is ``{Sum, N}``
(``:57-58``); adds carry either a bare value or a partial ``{Sum, N}``
(``:78-81``); downstream is stateless (``:132``); two adds compact into one
(``:127``). One deliberate fix (SURVEY.md §2 quirk #2): ``value/1`` on a
fresh state divides by zero in the reference (``average.erl:69-70``) — here
it returns 0.0.

The scalar half of ``antidote_ccrdt_tpu/models/average.py`` (the same
code, bit for bit in ``to_binary``); the dense engine is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from ..core import serial
from ..core.behaviour import EffectOp, PrepareOp, registry
from ..core.clock import ClockContext


class AverageScalar:
    type_name = "average"

    def new(self, sum_: int = 0, num: int = 0) -> Tuple[int, int]:
        return (int(sum_), int(num))

    def value(self, state: Tuple[int, int]) -> float:
        s, n = state
        if n == 0:
            return 0.0
        return s / n

    def downstream(
        self, op: PrepareOp, state: Any, ctx: ClockContext
    ) -> Optional[EffectOp]:
        kind, payload = op
        assert kind == "add"
        if isinstance(payload, tuple):
            v, n = payload
            return ("add", (int(v), int(n)))
        return ("add", (int(payload), 1))

    def update(self, effect: EffectOp, state: Tuple[int, int]) -> Tuple[Any, list]:
        kind, payload = effect
        assert kind == "add"
        if isinstance(payload, tuple):
            v, n = payload
        else:
            v, n = int(payload), 1
        if n == 0:  # reference no-op guard, average.erl:89
            return state, []
        s, cn = state
        return (s + v, cn + n), []

    def require_state_downstream(self, op: PrepareOp) -> bool:
        return False

    def is_operation(self, op: Any) -> bool:
        if not (isinstance(op, tuple) and len(op) == 2 and op[0] == "add"):
            return False
        p = op[1]
        if isinstance(p, tuple):
            return len(p) == 2 and all(isinstance(x, int) for x in p)
        return isinstance(p, int)

    @staticmethod
    def _fuse(e1: EffectOp, e2: EffectOp):
        # An n=0 op is a no-op in update (the `average.erl:89` guard), so it
        # must contribute nothing when fused either — the reference fuses
        # blindly (`average.erl:127`), silently resurrecting the dead op's
        # sum; deliberate fix, caught by test_compaction_preserves_state_average.
        (v1, n1), (v2, n2) = e1[1], e2[1]
        if n1 == 0:
            v1 = 0
        if n2 == 0:
            v2 = 0
        return v1 + v2, n1 + n2

    def can_compact(self, e1: EffectOp, e2: EffectOp) -> bool:
        if e1[0] != "add" or e2[0] != "add":
            return False
        # Refuse fusions whose combined n is 0 while the combined sum is
        # not: the fused op would hit the n=0 update guard and drop the
        # sum that sequential application keeps (possible because
        # is_operation admits negative n).
        v, n = self._fuse(e1, e2)
        return n != 0 or v == 0

    def compact_ops(self, e1: EffectOp, e2: EffectOp):
        v, n = self._fuse(e1, e2)
        return None, ("add", (v, n))

    def is_replicate_tagged(self, effect: EffectOp) -> bool:
        return False

    def equal(self, a: Any, b: Any) -> bool:
        return a == b

    def to_binary(self, state: Any) -> bytes:
        return serial.dumps_scalar(self.type_name, state)

    def from_binary(self, data: bytes) -> Any:
        name, state = serial.loads_scalar(data)
        assert name == self.type_name
        return state


registry.register("average", scalar=AverageScalar())
