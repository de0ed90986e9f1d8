"""Windowed-halo attention: the paper's conv halo carried over to
sliding-window attention (gemma2's local layers) under sequence sharding;
the port of ``repro.core.seq_halo``.

A local-attention layer with window W needs, per sequence shard of length
S_shard, only the last W−1 positions of the preceding shards: a 1-D halo.
Instead of gathering all of K/V, each shard pulls ``h = ⌈(W−1)/S_shard⌉``
predecessor shards of K/V in ``h`` ring shifts (``halo.LocalShards`` or
``halo.RankShards``, as in ``core.halo``) and computes masked attention
locally, the causal and window mask taken against global positions:

    K/V bytes moved per shard:  gather = (n−1)/n · |KV|,  halo = h/n · |KV|

The attention is ``models.layers.attention_scores`` in plain PyTorch, as
JAX computes it in einsums outside any Pallas kernel; the flash kernel's
mask has no query offset.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.halo import Shards, shard_rows, shards_for
from repro_torch.models.layers import attention_scores


def _halo_steps(S: int, window: int, n_shards: int) -> int:
    """Ring steps that bring a shard the last ``window − 1`` positions:
    ``⌈(W−1)/S_shard⌉`` predecessor shards, at most ``n_shards − 1``."""
    return min(n_shards - 1,
               math.ceil(max(window - 1, 0) / (S // n_shards)))


def _ring_halo(x, steps: int, shards: Shards):
    """Collects ``steps`` predecessor shards of a sharded ``(B, S_shard,
    KV, hd)`` value by ring shifts; returns ``(B, (steps+1)·S_shard, KV,
    hd)`` per shard, oldest first and the local shard last, with zeros
    before the start of the sequence."""
    parts = [x]
    cur = x
    for s in range(1, steps + 1):
        # one shift a step: shard i receives from i − 1; shard s − 1 wraps
        cur = shards.shift(cur, 1)
        cur = shards.map(
            lambda i, c: c if i >= s else torch.zeros_like(c), cur)
        parts.append(cur)
    # parts[k] holds the shard from k shards back; order them in time
    return shards.map(lambda i, *p: torch.cat(p[::-1], dim=1), *parts)


def windowed_attention_halo(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int, n_shards: int,
                            softcap: float = 0.0,
                            group: dist.ProcessGroup | None = None
                            ) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, S, KV, hd), split along S into
    ``n_shards`` shards.  Causal sliding-window attention with a halo K/V
    exchange instead of a gather.  With ``group`` (of ``n_shards`` ranks)
    this rank runs its own shard (run on CPU gloo ranks only, not yet on
    GPUs: ROADMAP.md, recommended order, item 5); without, all shards run
    here in turn."""
    S = q.shape[1]
    s_shard = shard_rows(S, n_shards, "windowed_attention_halo")
    shards = shards_for(n_shards, group)
    halo_steps = _halo_steps(S, window, n_shards)

    def local(i: int, qs: torch.Tensor, k_ext: torch.Tensor,
              v_ext: torch.Tensor) -> torch.Tensor:
        T = k_ext.shape[1]
        # global positions
        q_pos = i * s_shard + torch.arange(s_shard, device=qs.device)
        k_pos = (i - halo_steps) * s_shard + torch.arange(T, device=qs.device)
        m = (k_pos[None, :] <= q_pos[:, None]) \
            & (k_pos[None, :] > q_pos[:, None] - window) \
            & (k_pos[None, :] >= 0)
        return attention_scores(qs, k_ext, v_ext, m[None], softcap)

    k_ext = _ring_halo(shards.split(k), halo_steps, shards)
    v_ext = _ring_halo(shards.split(v), halo_steps, shards)
    return shards.join(shards.map(local, shards.split(q), k_ext, v_ext))


def halo_vs_gather_bytes(S: int, kv_heads: int, head_dim: int, *,
                         window: int, n_shards: int,
                         dtype_bytes: int = 2) -> dict:
    """Per-shard K/V bytes moved by a gather and by the windowed halo."""
    kv_bytes = 2 * S * kv_heads * head_dim * dtype_bytes   # K and V
    halo_steps = _halo_steps(S, window, n_shards)
    return {
        "all_gather": kv_bytes * (n_shards - 1) / n_shards,
        "halo": kv_bytes * halo_steps / n_shards,
        "ratio": (n_shards - 1) / max(halo_steps, 1),
    }
