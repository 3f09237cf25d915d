"""Per-device cost of one traced step: FLOPs, bytes, collective bytes and
peak live memory, counted op by op on each rank's local shards.

The port's counterpart of what ``launch/hlo_cost.py`` reads from the
reference's partitioned HLO. The step runs once, eagerly, on ``meta``
tensors under DTensor over a placeholder process group
(``launch/mesh.py``); :class:`CostMode` is a ``TorchDispatchMode`` that sees
every aten call. It defers DTensor-level calls (DTensor then runs the op on
its local shards, and those calls are counted) and skips DTensor's sharding
propagation, which runs the op on global-shape fake tensors, and host
tensors (a mesh works out its coordinates with them). So the counts are
per device:

* FLOPs: products by ``torch.utils.flop_counter.flop_registry`` (2 per
  multiply-add), plus one per output element of the arithmetic ops
  ``hlo_cost`` counts so (:data:`ARITH_OPS`);
* bytes: the inputs and outputs of every op that is not a view, a factory
  of uninitialised memory or a collective. This is what an eager step
  moves, unfused: XLA fuses elementwise chains and moves less, so the
  memory term is an upper bound on a fused program's traffic;
* collective payload bytes by kind: each collective's output bytes, an
  all-reduce twice (ring reduce-scatter plus all-gather), as
  ``analysis.collective_bytes`` counts the reference's HLO;
* peak live bytes: the most storage held at once by tensors that the step
  made or was given (:meth:`CostMode.track`), each storage counted once
  while any tensor on it lives (autograd's saved tensors included).

**Layer extrapolation.** A step's cost is linear in its depth: every layer
of a stack runs the same ops on the same shapes. :func:`extrapolate`
extends traces at 1 and 2 layers (Whisper: encoder and decoder each) to
the published depth, as ``hlo_cost`` multiplies a scan body by its trip
count.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field, fields
from typing import Dict, Mapping, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d functional collectives -> hlo_cost's kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}
# c10d bookkeeping that moves nothing
_C10D_NOOPS = ("wait_tensor", "_wrap_tensor_autograd", "broadcast")

# aten ops counted at one FLOP per output element: the counterparts of
# hlo_cost.ARITH_OPS (add subtract multiply divide maximum minimum
# exponential tanh rsqrt sqrt log power negate compare select and or convert
# cosine sine)
ARITH_OPS = frozenset(getattr(aten, name) for name in (
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "maximum", "minimum", "clamp", "clamp_", "clamp_min", "clamp_max",
    "exp", "exp_", "tanh", "rsqrt", "sqrt", "log", "pow", "neg",
    "eq", "ne", "lt", "le", "gt", "ge", "where", "logical_and",
    "logical_or", "bitwise_and", "bitwise_or", "_to_copy", "cos", "sin"))

# factories whose output is uninitialised: nothing is written
_NO_WRITE = frozenset({aten.empty, aten.empty_like, aten.empty_strided,
                       aten.new_empty, aten.new_empty_strided})


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class StepCost:
    """One traced step's per-device counts."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    peak_bytes: float = 0.0

    @property
    def collective_bytes(self) -> float:
        return float(sum(self.collectives.values()))

    def combine(self, *terms: Tuple["StepCost", float]) -> "StepCost":
        """``self + sum(weight * cost)`` over ``(cost, weight)`` terms, field
        by field."""
        out = StepCost(self.flops, self.bytes, dict(self.collectives),
                       self.peak_bytes)
        for cost, w in terms:
            out.flops += w * cost.flops
            out.bytes += w * cost.bytes
            out.peak_bytes += w * cost.peak_bytes
            for k, v in cost.collectives.items():
                out.collectives[k] = out.collectives.get(k, 0.0) + w * v
        return out

    def asdict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class CostMode(TorchDispatchMode):
    """Counts per-device work of the ops run inside it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = StepCost()
        self._live: Dict[int, list] = {}
        self._current = 0

    # -- live memory -------------------------------------------------------
    def track(self, tree) -> None:
        """Count the tensors of ``tree`` (DTensors by their local shards) as
        live from now until they die."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def _hold(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [storage.nbytes(), 0]
            self._current += entry[0]
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._current)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._current -= entry[0]
            del self._live[key]

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it on local shards
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(_is_fake(t) for t in ins + outs):
            return out                   # DTensor's sharding propagation
        if not any(t.device.type == "meta" for t in ins + outs):
            return out                   # host bookkeeping (mesh coordinates)
        packet = func.overloadpacket
        namespace = func.namespace
        if namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                b = sum(_nbytes(t) for t in outs)
                self.cost.collectives[kind] += 2 * b if kind == "all-reduce" \
                    else b
            elif packet.__name__ not in _C10D_NOOPS:
                raise NotImplementedError(f"collective {func} is not counted")
        else:
            if packet in flop_registry:
                self.cost.flops += flop_registry[packet](*args, **kwargs,
                                                         out_val=out)
            elif packet in ARITH_OPS:
                self.cost.flops += sum(t.numel() for t in outs)
            if not func.is_view and packet not in _NO_WRITE:
                self.cost.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out


def extrapolate(costs: Mapping[tuple, StepCost], depth: tuple) -> StepCost:
    """Cost at ``depth`` (one count per layer stack) from traces at depth
    ``(1, ..., 1)`` and at 2 in each stack with the others at 1:
    ``c(1..1) + sum_i (depth_i - 1) * (c(.., 2_i, ..) - c(1..1))``."""
    ones = (1,) * len(depth)
    base = costs[ones]
    terms = []
    for i, n in enumerate(depth):
        if n != 1:
            layer = costs[ones[:i] + (2,) + ones[i + 1:]].combine((base, -1.0))
            terms.append((layer, float(n - 1)))
    return base.combine(*terms)
