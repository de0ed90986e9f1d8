"""AdamW with decoupled weight decay and global-norm clipping, the port of
``repro.optim.adamw``.

Optimizer state mirrors the parameter tree: ``m`` and ``v`` in float32
whatever the parameter dtype, the new parameter computed in float32 and
cast back, in JAX's arithmetic order.  Unlike the JAX function, the update
works in place, one leaf at a time, under ``torch.no_grad()``: the
parameters and moments are overwritten (the parameters stay the very
tensors a model reads, so autograd keeps reaching them), the clip scale is
applied to each gradient leaf as it is used, and only that leaf's float32
temporaries are alive at once.  At minicpm-2b's stacked (40, 2304, 5760)
MLP leaves a whole clipped float32 copy of the gradients would add 10.9 GB
and each temporary of the largest leaf 2.1 GB.  ``step`` is an int32 0-d
tensor that lives on the host.

Sharded leaves (DTensors, ``repro_torch.core.policies``): the global norm
sums each leaf's GLOBAL sum of squares (``full_tensor`` of the local
sums), and each gradient leaf is first redistributed to its moments'
placements (ZeRO-1: the data-parallel partial sum reduce-scattered onto
the moments' shards), the parameter read there too; the update runs on
those local shards in the same arithmetic, and the new parameter goes
back to the parameter's placements (cast first, so the gather moves its
own dtype).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core.dtensor import is_dtensor

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0


def adamw_init(params: Params) -> dict[str, Any]:
    def zeros(p: Params) -> Params:
        return tree.map(lambda x: torch.zeros_like(
            x, dtype=torch.float32, requires_grad=False), p)

    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum, in leaf order, of each leaf's float32 sum of
    squares."""
    def sum_sq(x: torch.Tensor) -> torch.Tensor:
        s = torch.sum(torch.square(x.to(torch.float32)))
        return s.full_tensor() if is_dtensor(s) else s
    sums = [sum_sq(x) for x in tree.leaves(grads)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float):
    """(the gradients in float32 times min(1, max_norm / (norm + 1e-9)),
    norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree.map(lambda g: g.to(torch.float32) * scale, grads), norm


def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: dict[str, Any], lr_scale: torch.Tensor | float = 1.0):
    """One AdamW step, in place.  Returns (params, new_state, metrics):
    the same parameter tree, updated; ``{"m", "v"}`` the same moment trees,
    updated, and ``step`` advanced by one; ``grad_norm`` (before clipping)
    and ``lr``."""
    with torch.no_grad():
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip_norm)
        step = state["step"] + 1
        b1t = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
        b2t = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))
        lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32)
        for p, g, m, v in zip(tree.leaves(params), tree.leaves(grads),
                              tree.leaves(state["m"]),
                              tree.leaves(state["v"])):
            pm = p
            if is_dtensor(m):
                g = g.redistribute(m.device_mesh, m.placements)
                if p.placements != m.placements:
                    pm = p.redistribute(m.device_mesh, m.placements)
            g32 = g.to(torch.float32) * scale
            v.mul_(cfg.b2).add_(g32.square().mul_(1 - cfg.b2))
            m.mul_(cfg.b1).add_(g32.mul_(1 - cfg.b1))
            del g32
            denom = (v / b2t).sqrt_().add_(cfg.eps)
            delta = (m / b1t).div_(denom)
            del denom
            delta.add_(pm, alpha=cfg.weight_decay)  # + wd * p in float32
            if pm is p:
                p.copy_(p.to(torch.float32) - delta.mul_(lr))
            else:
                new = (pm.to(torch.float32) - delta.mul_(lr)).to(p.dtype)
                p.copy_(new.redistribute(p.device_mesh, p.placements))
            del delta, pm
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
