"""average: aggregated mean as a (sum, count) pair.

Reference: ``src/antidote_ccrdt_average.erl``. State is ``{Sum, N}``
(``:57-58``); adds carry either a bare value or a partial ``{Sum, N}``
(``:78-81``); downstream is stateless (``:132``); two adds compact into one
(``:127``). One deliberate fix (SURVEY.md §2 quirk #2): ``value/1`` on a
fresh state divides by zero in the reference (``average.erl:69-70``) — here
it returns 0.0.

A port of ``antidote_ccrdt_tpu/models/average.py``: the scalar half is the
same code (bit for bit in ``to_binary``); the dense half keeps (sum, n)
accumulators ``[n_replicas, n_keys]``, applies an op batch as one
scatter-add per leaf, and merges replicas with ``+`` (MONOID algebra:
per-replica states are deltas — see `MergeKind`).
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


# --- dense level -----------------------------------------------------------

import dataclasses  # noqa: E402

import torch  # noqa: E402

from ..core.behaviour import MergeKind  # noqa: E402
from ..device import DeviceLike, resolve_device  # noqa: E402
from ..ops.dense_table import table_addresses, wrapping_add  # noqa: E402


@dataclasses.dataclass
class AverageState:
    """sum/n accumulators, shape [n_replicas, n_keys]."""

    sum: torch.Tensor
    num: torch.Tensor


@dataclasses.dataclass
class AverageOps:
    """A batch of add ops per replica: op b on replica r targets key[r, b]
    adding (value[r, b], count[r, b]). count==0 marks padding (the
    reference's own no-op guard makes 0 the natural null)."""

    key: torch.Tensor  # int32[R, B]
    value: torch.Tensor  # [R, B], state dtype
    count: torch.Tensor  # [R, B], state dtype


class AverageDense:
    """Batched average over [n_replicas, n_keys] (port of the JAX
    ``AverageDense``). `dtype` defaults to int32, as in JAX; integer sums
    wrap in it. ``device``: where `init` puts states (default: the CUDA
    card; raises without one)."""

    type_name = "average"
    merge_kind = MergeKind.MONOID

    def __init__(self, dtype: torch.dtype = torch.int32, device: DeviceLike = None):
        self.dtype = dtype
        self.device = resolve_device(device)

    def init(self, n_replicas: int, n_keys: int) -> AverageState:
        def z():
            return torch.zeros((n_replicas, n_keys), dtype=self.dtype, device=self.device)

        return AverageState(sum=z(), num=z())

    def apply_ops(self, state: AverageState, ops: AverageOps):
        """Scatter-add each op's (value, count) into its key, per replica;
        a key in [-NK, 0) lands on key + NK and one outside [-NK, NK) is
        dropped (JAX's ``.at[key].add(mode="drop")``). count==0 ops are
        no-ops end to end (average.erl:89): their value must not leak into
        the sum either."""
        R, NK = state.sum.shape
        value = ops.value.masked_fill(ops.count == 0, 0)
        flat, keep = table_addresses(
            (R, 1, NK), torch.zeros_like(ops.key), ops.key, torch.ones_like(ops.key, dtype=torch.bool)
        )
        new_sum = wrapping_add(state.sum, flat, value[keep])
        new_num = wrapping_add(state.num, flat, ops.count[keep])
        return AverageState(sum=new_sum, num=new_num), None

    def merge(self, a: AverageState, b: AverageState) -> AverageState:
        return AverageState(sum=a.sum + b.sum, num=a.num + b.num)

    def observe(self, state: AverageState) -> torch.Tensor:
        """float32 ``sum / max(num, 1)``, and 0.0 where num == 0: both
        operands rounded to float32 first, as JAX's true division of int32
        arrays does."""
        q = state.sum.to(torch.float32) / state.num.clamp_min(1).to(torch.float32)
        return q.masked_fill(state.num == 0, 0.0)


registry.register("average", dense_factory=AverageDense)
