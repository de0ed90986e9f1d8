"""Row-sharded execution of a fused CNN group with one halo exchange: the
port of ``repro.core.halo``, the paper's fused-layer dataflow on shards.

Feature maps (NHWC) are split along H into ``n_shards`` equal shards.  A
fused group needs, per shard, only its neighbours' receptive-field halo
rows, exchanged once before the group runs (the paper's one-time
cross-bank halo transfer, Fig. 1b); every layer of the group then runs on
its shard alone, recomputing the edge rows (the paper's redundant-compute
trade), where a layer-by-layer mapping would re-gather the full map
between layers.

Where JAX's ``shard_map`` body calls ``ppermute``, the port shifts a
tensor to the next or previous shard through one of two forms, which run
the same per-shard bodies:

* ``LocalShards(n)`` — all ``n`` shards in one process, as a list (shard
  ``i`` at index ``i``): the form that runs on one card;
* ``RankShards(group)`` — this rank's shard of a ``torch.distributed``
  process group, neighbours reached by ``batch_isend_irecv``.

The entry points take ``n_shards`` and run the one-process form, or, given
a ``group`` of ``n_shards`` ranks, the process-group form.  Both keep JAX's
contract: the full ``x`` goes in and the full result comes out (on every
rank, in the process-group form).  The process-group form has run on CPU
gloo ranks only, held bit-equal to the one-process form; it has not yet
run on GPUs over NCCL (ROADMAP.md, recommended order, item 5).

GLOBAL-BOUNDARY SEMANTICS (as in JAX): ``run_fused_group`` (one opaque
group function) is exact on every interior shard; the first and last
shards deviate within the group's receptive field, because out-of-image
halo rows are zero rows that pick up BN shifts and reach the next layers
instead of staying equal to conv padding.  ``run_fused_group_exact`` takes
the group as per-layer functions and re-zeroes out-of-image rows after
every layer: exact everywhere for stride-1 same-padded layers.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.tiling import Layer, input_rows


class LocalShards:
    """``n`` shards in one process: a sharded value is a list of ``n``
    tensors."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"n_shards must be at least 1, got {n}")
        self.n = n

    def split(self, x: torch.Tensor, dim: int = 1) -> list[torch.Tensor]:
        return list(x.chunk(self.n, dim))

    def join(self, ys: list[torch.Tensor], dim: int = 1) -> torch.Tensor:
        return torch.cat(ys, dim)

    def map(self, fn: Callable, *vals: list) -> list:
        """``fn(i, *shard_i_values)`` for every shard ``i``."""
        return [fn(i, *v) for i, v in enumerate(zip(*vals))]

    def shift(self, xs: list[torch.Tensor], step: int) -> list[torch.Tensor]:
        """Shard ``i`` receives shard ``i − step``'s tensor (cyclically):
        ``ppermute`` with the pairs ``(i, i + step)``."""
        return [xs[(i - step) % self.n] for i in range(self.n)]


class RankShards:
    """This rank's shard of ``group`` (``dist.group.WORLD`` for all
    ranks); the group's ranks are the shard indices."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def split(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return x.chunk(self.n, dim)[self.rank].contiguous()

    def join(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        ys = [torch.empty_like(y) for _ in range(self.n)]
        dist.all_gather(ys, y.contiguous(), group=self.group)
        return torch.cat(ys, dim)

    def map(self, fn: Callable, *vals):
        return fn(self.rank, *vals)

    def shift(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """Receives the tensor of rank ``rank − step`` and sends ``x`` to
        rank ``rank + step`` (cyclically), all ranks at once."""
        if self.n == 1:
            return x.clone()
        x = x.contiguous()
        out = torch.empty_like(x)

        def peer(r: int) -> int:
            return dist.get_global_rank(self.group, r % self.n)
        ops = [dist.P2POp(dist.isend, x, peer(self.rank + step), self.group),
               dist.P2POp(dist.irecv, out, peer(self.rank - step),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


Shards = LocalShards | RankShards


def shards_for(n_shards: int, group: dist.ProcessGroup | None) -> Shards:
    """The one-process form, or with ``group`` the process-group form (run
    on CPU gloo ranks only, not yet on GPUs: ROADMAP.md, recommended order,
    item 5)."""
    if group is None:
        return LocalShards(n_shards)
    shards = RankShards(group)
    if shards.n != n_shards:
        raise ValueError(f"n_shards={n_shards}, but the process group has "
                         f"{shards.n} ranks")
    return shards


def shard_rows(rows: int, n_shards: int, what: str) -> int:
    """The rows of one of ``n_shards`` equal shards of ``rows``."""
    if n_shards < 1 or rows % n_shards:
        raise ValueError(f"{what}: {rows} rows do not split into {n_shards} "
                         f"equal shards")
    return rows // n_shards


def group_halo_rows(group: list[Layer], tiles: int) -> int:
    """Halo rows a fused group needs: the most, over a ``tiles``-row grid,
    of the extra input rows a tile needs beyond its own share (for an
    interior tile the sum of both sides, as in JAX; ``run_fused_group``
    takes it as the rows per side)."""
    own = group[0].iy // tiles
    return max(0, *(hi - lo - own for lo, hi in input_rows(group, tiles)))


def exchange_halo(x, halo_up: int, halo_down: int, shards: Shards):
    """x: a sharded ``(B, H_shard, W, C)`` value of ``shards``.  Returns it
    extended with ``halo_up`` rows from the previous shard and
    ``halo_down`` rows from the next (zero rows at the first and last
    shards: conv-padding semantics), contiguous."""
    n = shards.n

    def check(i: int, s: torch.Tensor) -> None:
        # JAX would silently take fewer rows from x[:, -halo:]
        if (min(halo_up, halo_down) < 0
                or max(halo_up, halo_down) > s.shape[1]):
            raise ValueError(f"exchange_halo: halo of {halo_up}/{halo_down} "
                             f"rows, shard {i} has {s.shape[1]}")
    shards.map(check, x)
    parts = []
    if halo_up:
        # rows flowing down: shard i sends its last rows to i + 1
        top = shards.shift(shards.map(lambda i, s: s[:, -halo_up:], x), 1)
        parts.append(shards.map(
            lambda i, t: torch.zeros_like(t) if i == 0 else t, top))
    parts.append(x)
    if halo_down:
        bot = shards.shift(shards.map(lambda i, s: s[:, :halo_down], x), -1)
        parts.append(shards.map(
            lambda i, b: torch.zeros_like(b) if i == n - 1 else b, bot))
    return shards.map(lambda i, *p: torch.cat(p, dim=1), *parts)


def _crop_valid(y: torch.Tensor, crop_up: int, crop_down: int) -> torch.Tensor:
    if crop_down:
        return y[:, crop_up:-crop_down]
    return y[:, crop_up:]


def run_fused_group(group_fn: Callable[[torch.Tensor], torch.Tensor],
                    x: torch.Tensor, n_shards: int, *, halo: int,
                    shrink: int,
                    group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """Runs ``group_fn`` on ``n_shards`` row shards of ``x`` after a single
    up-front halo exchange, and returns the shards' outputs joined.

    ``halo``   — input rows taken from each neighbour (receptive field);
    ``shrink`` — output rows the halo produced that belong to a
                 neighbour, cropped after the group runs (the redundant
                 edge compute).  For a stride-s group, shrink = halo // s,
                 aligned only when s divides halo.

    With ``group`` (of ``n_shards`` ranks) this rank runs its own shard
    (run on CPU gloo ranks only, not yet on GPUs); without, all shards run
    here in turn."""
    shard_rows(x.shape[1], n_shards, "run_fused_group")
    shards = shards_for(n_shards, group)

    def local(i: int, ext: torch.Tensor) -> torch.Tensor:
        return _crop_valid(group_fn(ext), shrink, shrink)

    ext = exchange_halo(shards.split(x), halo, halo, shards)
    return shards.join(shards.map(local, ext))


def run_fused_group_exact(layer_fns: Sequence[Callable[[torch.Tensor],
                                                       torch.Tensor]],
                          x: torch.Tensor, n_shards: int, *, halo: int,
                          group: dist.ProcessGroup | None = None
                          ) -> torch.Tensor:
    """Exact everywhere: one halo exchange for the whole fused group, then
    after every layer the out-of-image rows are multiplied by zero, so
    they equal conv padding at every layer (stride-1 same-padded groups):
    the paper's fused dataflow with boundary-tile clipping.  ``group`` as in
    ``run_fused_group`` (run on CPU gloo ranks only, not yet on GPUs)."""
    H = x.shape[1]
    shard = shard_rows(H, n_shards, "run_fused_group_exact")
    shards = shards_for(n_shards, group)

    def local(i: int, ext: torch.Tensor) -> torch.Tensor:
        # global positions of the extended rows
        pos = torch.arange(ext.shape[1], device=ext.device) + i * shard - halo
        valid = ((pos >= 0) & (pos < H))[None, :, None, None].to(ext.dtype)
        y = ext
        for fn in layer_fns:
            y = fn(y) * valid
        return y[:, halo:-halo] if halo else y

    ext = exchange_halo(shards.split(x), halo, halo, shards)
    return shards.join(shards.map(local, ext))
