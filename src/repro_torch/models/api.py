"""Model assembly: config → (init, forward, init_cache, decode_step), as in
the JAX package.  This port serves the CNN family; the other families come
with later slices of the port."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``device`` defaults to ``cuda`` and raises if no card is present;
    ``device="cpu"`` runs the plain PyTorch path."""
    if cfg.family == "cnn":
        from repro_torch.models.resnet import build_resnet_model
        return build_resnet_model(cfg, device)
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet: the decoder-only, MoE and "
        "encoder-decoder builders are ROADMAP queue 1 item 9, the hybrid "
        "item 10, xLSTM item 11")
