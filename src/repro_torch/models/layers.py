"""The conv/bn/pool layers of ResNet in PyTorch, with the JAX package's
layouts: NHWC activations, HWIO conv weights, parameters as plain dicts.

Every ``init_*`` draws from an explicit ``torch.Generator`` on the CPU and
then moves to ``device`` (``None`` is PyTorch's default device), so the same
seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = dict[str, Any]


def _randn(gen: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, dtype=torch.float32)
            * scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return _randn(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                  device)


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return _randn(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)),
                  dtype, device)


def conv2d(w: torch.Tensor, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x: NHWC, w: HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def init_bn(cout: int, dtype: torch.dtype = torch.float32,
            device=None) -> Params:
    return {"scale": torch.ones(cout, dtype=dtype, device=device),
            "bias": torch.zeros(cout, dtype=dtype, device=device),
            "mean": torch.zeros(cout, dtype=torch.float32, device=device),
            "var": torch.ones(cout, dtype=torch.float32, device=device)}


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN: normalise in f32 with the running stats, cast back,
    then apply scale and bias."""
    inv = torch.rsqrt(p["var"] + eps)
    return ((x.float() - p["mean"]) * inv).to(x.dtype) * p["scale"] \
        + p["bias"]


def maxpool2d(x: torch.Tensor, k: int, stride: int,
              padding: int) -> torch.Tensor:
    """Max over k×k windows of the input padded with −inf; NHWC in and out."""
    xp = F.pad(x, (0, 0, padding, padding, padding, padding),
               value=-math.inf)
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))
