"""Small DTensor helpers for the sharded path: each is the identity, or the
plain call, on a plain tensor, so the unsharded numerics do not move.

* ``settle(x)`` reduces a DTensor's pending partial sums (``Partial`` →
  ``Replicate``); ``redistributed(x, placements)`` moves a DTensor to
  ``placements`` unless it is there already.
* ``embedding(ids, table)`` is ``F.embedding``.  On a table sharded by
  vocab (``Shard(0)``) over mesh dims where the ids are replicated, each
  rank looks up the ids of its own rows, puts zeros elsewhere, and the
  result is reduced once over those dims: exact, since every sum is one
  value and zeros.  It is settled at once, so the residual stream's two
  readers (the norm's variance and its scale) see a plain ``Replicate``
  placement; DTensor's own lookup leaves a masked partial sum
  (``_MaskPartial``) that it reduces only once and whose gradient does not
  go back from a plain partial sum.  The backward is the local
  ``F.embedding`` backward of the local ids, with no communication: the
  table's gradient is ``Partial`` over the mesh dims that shard the ids.
  A vocab shard on a mesh dim that also shards the ids (ZeRO-3's
  data-sharded table) is gathered there first, as that policy gathers
  every weight at use.
* ``shard_index(mesh, placements, dim)`` is this rank's index among the
  shards of tensor dim ``dim`` and their count.
* ``split_last(x, n, d)`` and ``merge_last(x)`` reshape the last dim into
  (n, d) heads and back.  DTensor cannot unflatten or flatten a dim whose
  shard splits a head (minicpm's 36 heads of 64 column-sharded 16 ways),
  so such a DTensor is first replicated on the mesh dims that shard it.
* ``contiguous_grad(x)`` is ``x`` whose gradient is made contiguous.  A
  local computation's gradient that leaves through ``to_local`` becomes a
  DTensor whose global strides DTensor infers from the local layout; from
  a transposed local gradient (the attention backward's dk of one head a
  shard, deepseek-moe-16b's 16 heads 16 ways) it infers strides under
  which a later ``reshape`` takes a view that the local tensor cannot.
* ``local_pointwise(fn, x)`` runs an elementwise ``fn`` on each local
  shard (``local_map``), for ops to which DTensor gives no sharding rule
  in some PyTorch version (``log_sigmoid_backward``): an elementwise op is
  exact on any placement but a partial sum, which is settled first.

``route_counts`` counts the sharded routes taken (``note_route``): ``embed``
for each masked vocab-sharded lookup, ``moe_ffn`` for each expert-parallel
MoE FFN (``models/moe.py``).  Within ``recording_gathers()``,
``note_computed_replicated`` names an op whose inputs a route replicated
on a mesh dim larger than 1 that some input was sharded on, so that every
rank of that dim repeats its work (the dry run reports these as computed
replicated).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Sequence

import torch
import torch.nn.functional as F

_GATHERED: contextvars.ContextVar[set | None] = contextvars.ContextVar(
    "gathered", default=None)

route_counts: dict[str, int] = {"embed": 0, "moe_ffn": 0}


def note_route(name: str) -> None:
    route_counts[name] += 1


@contextlib.contextmanager
def recording_gathers() -> Iterator[set]:
    """Yields the set of names that ``note_computed_replicated`` adds to."""
    seen: set = set()
    token = _GATHERED.set(seen)
    try:
        yield seen
    finally:
        _GATHERED.reset(token)


def note_computed_replicated(what: str, mesh, before: Sequence,
                             after: Sequence) -> None:
    """Adds ``what`` to ``recording_gathers``' set if on a mesh dim larger
    than 1 some input was sharded (``before``: each input's placements)
    and every input is replicated after the route's redistributions
    (``after``)."""
    seen = _GATHERED.get()
    if seen is None:
        return
    for i in range(mesh.ndim):
        if mesh.size(i) > 1 and any(
                not pl[i].is_replicate() for pl in before) and all(
                pl[i].is_replicate() for pl in after):
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


def redistributed(x: torch.Tensor, placements: Sequence) -> torch.Tensor:
    """The DTensor ``x`` on ``placements``."""
    if list(x.placements) == list(placements):
        return x
    return x.redistribute(placements=list(placements))


def shard_index(mesh, placements: Sequence, dim: int) -> tuple[int, int]:
    """(index, count) of this rank's shard of tensor dim ``dim`` under
    ``placements``: the mesh dims that shard it split it in mesh-dim
    order, the first one outermost, as DTensor applies them."""
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            index = index * mesh.size(i) + coord[i]
            count *= mesh.size(i)
    return index, count


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is made contiguous in the backward."""
    return _ContiguousGrad.apply(x) if x.requires_grad else x


def embedding(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``; a vocab-sharded DTensor table takes the
    masked lookup (see the module's docstring)."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    on_ids = [not p.is_replicate() for p in ids.placements]
    table = redistributed(table, [
        Replicate() if on_ids[i] and p.is_shard() else p
        for i, p in enumerate(table.placements)])
    vocab = [p.is_shard(0) for p in table.placements]
    if not any(vocab):
        return F.embedding(ids, table)
    table = redistributed(table, [p if p.is_shard(0) else Replicate()
                                  for p in table.placements])
    note_route("embed")
    index, count = shard_index(mesh, table.placements, 0)
    V = table.shape[0]
    if V % count:
        raise ValueError(f"embedding: {V} rows do not split into {count} "
                         f"equal vocab shards")
    rows = V // count
    local = contiguous_grad(table.to_local(grad_placements=[
        Partial() if on_ids[i] else p
        for i, p in enumerate(table.placements)]))
    j = ids.to_local() - index * rows
    inside = (j >= 0) & (j < rows)
    e = F.embedding(j.clamp(0, rows - 1), local)
    e = torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype,
                                                      device=e.device))
    out = DTensor.from_local(e, mesh, [
        Partial() if vocab[i] else p for i, p in enumerate(ids.placements)],
        run_check=False)
    return settle(out)


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
