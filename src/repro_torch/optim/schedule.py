"""LR schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM
arXiv:2404.06395), the port of ``repro.optim.schedule``.

Each returns a multiplicative factor on the base LR as a 0-d float32
tensor, computed in float32 in JAX's order, from an integer step (a Python
int or an integer tensor, on whatever device it lies).
"""

from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, *, warmup: int, total: int,
                    min_ratio: float = 0.1) -> torch.Tensor:
    s = _step_f32(step)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def wsd_schedule(step, *, warmup: int, total: int, decay_frac: float = 0.1,
                 min_ratio: float = 0.1) -> torch.Tensor:
    """Warmup → Stable (flat) → Decay (last ``decay_frac`` of training).
    MiniCPM's schedule: the stable phase runs at full LR; decay is a fast
    linear tail."""
    s = _step_f32(step)
    # JAX: jnp.maximum(total * decay_frac, 1), a float32 value
    decay_steps = torch.tensor(max(total * decay_frac, 1), dtype=torch.float32)
    decay_start = total - decay_steps
    warm = s / max(warmup, 1)
    tail = torch.clamp((s - decay_start) / decay_steps, 0.0, 1.0)
    decay = 1.0 - (1.0 - min_ratio) * tail
    return torch.where(s < warmup, warm,
                       torch.where(s < decay_start, 1.0, decay))


def make_schedule(kind: str, *, warmup: int = 100, total: int = 10000):
    if kind == "wsd":
        return lambda step: wsd_schedule(step, warmup=warmup, total=total)
    return lambda step: cosine_schedule(step, warmup=warmup, total=total)
