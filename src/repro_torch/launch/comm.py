"""Collective bytes and FLOPs of eager PyTorch code, the port's analogue of
``repro.launch.hlo_analysis``.

JAX's dry run parses the compiled HLO text, which PyTorch does not
produce.  The port records what its code runs instead: ``CommCounter`` is
a ``TorchDispatchMode`` that lets DTensor lower each op to local ops and
collectives first (it declines DTensor-level ops, as PyTorch's
``CommDebugMode`` does) and then records

* every c10d collective, functional (``_c10d_functional.*``, what DTensor's
  redistributions call) or in place (``c10d.*``), by kind: all-gather,
  all-reduce, reduce-scatter, all-to-all and collective-permute, with
  ``hlo_analysis``'s convention: the OUTPUT payload on this device, in
  bytes (broadcasts, scatters, gathers, reduces and point-to-point sends
  go under ``other``);
* the FLOPs of the local ops, by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry: matmuls, convolutions, attention), so
  per device as JAX's ``hlo_flops_per_device``.  An eager trace runs every
  layer of a loop, so there is no while-loop trip count to correct.

HBM traffic has no eager analogue (nothing says which intermediates a
fused kernel keeps on chip), so ``hbm_bytes`` is ``"unavailable: <reason>"``,
as JAX's ``analyze`` records a figure its backend cannot give.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
HBM_UNAVAILABLE = ("unavailable: an eager trace has no compiled program, "
                   "so no fusion decides which intermediates reach HBM")


def _kinds() -> dict:
    """op overload packet → (kind, whether the payload is the op's output
    (functional) or its first argument (in-place c10d))."""
    out: dict = {}
    fc = getattr(torch.ops, "_c10d_functional", None)
    c10d = getattr(torch.ops, "c10d", None)
    functional = {
        "all_gather_into_tensor": "all-gather",
        "all_gather_into_tensor_coalesced": "all-gather",
        "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
        "reduce_scatter_tensor": "reduce-scatter",
        "reduce_scatter_tensor_coalesced": "reduce-scatter",
        "all_to_all_single": "all-to-all", "broadcast": "other",
    }
    in_place = {
        "_allgather_base_": "all-gather", "allgather_": "all-gather",
        "allgather_coalesced_": "all-gather",
        "allgather_into_tensor_coalesced_": "all-gather",
        "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
        "_reduce_scatter_base_": "reduce-scatter",
        "reduce_scatter_": "reduce-scatter",
        "reduce_scatter_tensor_coalesced_": "reduce-scatter",
        "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
        "send": "collective-permute", "recv_": "collective-permute",
        "broadcast_": "other", "scatter_": "other", "gather_": "other",
        "reduce_": "other",
    }
    for ns, table, is_out in ((fc, functional, True), (c10d, in_place, False)):
        for name, kind in table.items():
            op = getattr(ns, name, None) if ns is not None else None
            if op is not None:
                out[op] = (kind, is_out)
    dt = getattr(torch.ops, "_dtensor", None)
    op = getattr(dt, "shard_dim_alltoall", None) if dt is not None else None
    if op is not None:
        out[op] = ("all-to-all", True)
    return out


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


@dataclasses.dataclass
class CommCosts:
    flops: float                      # per-device FLOPs of the local ops
    collective_bytes: dict[str, float]
    collective_total: float
    collective_count: int
    hbm_bytes: str = HBM_UNAVAILABLE

    def record(self) -> dict:
        """The dry run's ``collectives`` entry, ``hlo_analysis``'s keys."""
        return {**{k: int(v) for k, v in self.collective_bytes.items()},
                "total": int(self.collective_total),
                "count": self.collective_count}


class CommCounter(TorchDispatchMode):
    """Counts collectives and FLOPs of the ops run inside it (see the
    module's docstring); ``costs()`` reads them."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_rules = dict(FlopCounterMode().flop_registry)
        self._kinds = _kinds()
        self.bytes = {k: 0.0 for k in (*COLLECTIVE_KINDS, "other")}
        self.count = 0
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor lowers it; we see the rest
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._kinds:
            kind, is_out = self._kinds[packet]
            self.bytes[kind] += _nbytes(out if is_out else args[0])
            self.count += 1
        elif packet in self._flop_rules:
            self.flops += self._flop_rules[packet](*args, **kwargs,
                                                   out_val=out)
        return out

    def costs(self) -> CommCosts:
        coll = {k: self.bytes[k] for k in COLLECTIVE_KINDS}
        coll["other"] = self.bytes["other"]
        return CommCosts(flops=self.flops, collective_bytes=coll,
                         collective_total=sum(coll.values()),
                         collective_count=self.count)
