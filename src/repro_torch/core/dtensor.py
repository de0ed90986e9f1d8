"""Small DTensor helpers for the sharded path: each is the identity, or the
plain call, on a plain tensor, so the unsharded numerics do not move.

* ``settle(x)`` reduces a DTensor's pending partial sums (``Partial`` →
  ``Replicate``).
* ``whole(x)`` gathers a DTensor onto every rank (``Replicate`` on every
  mesh dim).  The decoders look tokens up in a whole embedding table: a
  lookup in a vocab-sharded one is a masked partial sum (``_MaskPartial``)
  that DTensor reduces only once, and the residual stream reads it twice
  (the norm's variance and its scale); nor does its gradient go back
  from a plain partial sum to the masked one.  The gather's backward is a
  reduce-scatter of the table's gradient onto its shards.
* ``split_last(x, n, d)`` and ``merge_last(x)`` reshape the last dim into
  (n, d) heads and back.  DTensor cannot unflatten or flatten a dim whose
  shard splits a head (minicpm's 36 heads of 64 column-sharded 16 ways),
  so such a DTensor is first replicated on the mesh dims that shard it.
* ``replicated_call(fn, *args)`` runs ``fn`` on the whole values of its
  arguments' DTensor leaves, every rank the same work, and returns
  replicated DTensors: exact for any function, at the price of gathering
  its inputs.  The MoE FFN takes it: its dispatch scatters tokens to the
  slots the routing picks, which no sharding rule of DTensor describes (a
  scatter by local indices into a replicated buffer would leave every
  rank a different buffer).
* ``local_pointwise(fn, x)`` runs an elementwise ``fn`` on each local
  shard (``local_map``), for ops to which DTensor gives no sharding rule
  in some PyTorch version (``log_sigmoid_backward``): an elementwise op is
  exact on any placement but a partial sum, which is settled first.

``whole`` and ``replicated_call`` discard the policies' sharding of what
they gather: within ``recording_gathers()`` each names what it gathered
from a mesh dim larger than 1 (the dry run reports these as computed
replicated).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator

import torch

_GATHERED: contextvars.ContextVar[set | None] = contextvars.ContextVar(
    "gathered", default=None)


@contextlib.contextmanager
def recording_gathers() -> Iterator[set]:
    """Yields the set of names that ``whole`` and ``replicated_call`` add
    to when they gather a DTensor sharded on a mesh dim larger than 1."""
    seen: set = set()
    token = _GATHERED.set(seen)
    try:
        yield seen
    finally:
        _GATHERED.reset(token)


def _note_gather(what: str, x) -> None:
    seen = _GATHERED.get()
    if seen is None or not is_dtensor(x):
        return
    if any(not p.is_replicate() and x.device_mesh.size(i) > 1
           for i, p in enumerate(x.placements)):
        seen.add(what)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every ``Partial`` placement reduced to ``Replicate``."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in x.placements])


def whole(x: torch.Tensor, what: str = "tensor") -> torch.Tensor:
    """``x`` replicated on every mesh dim (a plain tensor as it is);
    ``what`` names it for ``recording_gathers``."""
    if not is_dtensor(x) or all(p.is_replicate() for p in x.placements):
        return x
    _note_gather(what, x)
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[Replicate()] * x.device_mesh.ndim)


def _whole_heads(x: torch.Tensor, dim: int, heads: int) -> torch.Tensor:
    """``x`` replicated on the mesh dims that shard ``dim`` when their
    sizes' product does not divide ``heads``."""
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim == dim]
    n = 1
    for i in on:
        n *= x.device_mesh.size(i)
    if heads % n == 0:
        return x
    return x.redistribute(placements=[
        Replicate() if i in on else p for i, p in enumerate(x.placements)])


class _HeadReshape(torch.autograd.Function):
    """A DTensor reshape between (..., n·d) and (..., n, d) whose input,
    and in the backward whose gradient, is first replicated where its
    shard would split a head."""

    @staticmethod
    def forward(ctx, x, shape, heads, dim_in, dim_out):
        ctx.x_shape, ctx.heads, ctx.dim_out = x.shape, heads, dim_out
        return _whole_heads(x, dim_in, heads).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        g = _whole_heads(g, ctx.dim_out, ctx.heads)
        return g.reshape(ctx.x_shape), None, None, None, None


def split_last(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """``x.reshape(..., n, d)`` of its last dim."""
    shape = (*x.shape[:-1], n, d)
    if is_dtensor(x):
        return _HeadReshape.apply(x, shape, n, -1, -2)
    return x.reshape(shape)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x.reshape(..., n * d)`` of its last two dims (n, d)."""
    shape = (*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if is_dtensor(x):
        return _HeadReshape.apply(x, shape, x.shape[-2], -2, -1)
    return x.reshape(shape)


def replicated_call(fn: Callable, *args, what: str = "call"):
    """``fn(*args)`` on whole, plain tensors; each tensor of its output a
    DTensor replicated on the mesh of the arguments' DTensors.  ``what``
    names the call for ``recording_gathers``."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import tree
    mesh = next(x.device_mesh for a in args for x in tree.leaves(a)
                if is_dtensor(x))
    rep = [Replicate()] * mesh.ndim
    out = fn(*[tree.map(lambda x: whole(settle(x), what).to_local()
                        if is_dtensor(x) else x, a) for a in args])
    return tree.map(lambda t: DTensor.from_local(t, mesh, rep,
                                                 run_check=False)
                    if isinstance(t, torch.Tensor) else t, out)


def local_pointwise(fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` of each
    local shard, differentiated locally too."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor.experimental import local_map
    x = settle(x)
    # a list, not a tuple: local_map reads a tuple as one placement list
    # per output
    return local_map(fn, out_placements=list(x.placements),
                     in_placements=(x.placements,))(x)
