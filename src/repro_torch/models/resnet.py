"""ResNet18 in PyTorch (NHWC) — the paper's benchmark CNN (§V), with every
conv and its BN, and where present the residual add and ReLU, run as one
``ops.fused_conv`` call: the fused CONV_BN / CONV_BN_RELU / ADD_RELU op of
the paper's Table I.  A forward makes 20 such calls: the stem, 16 block
convs and 3 downsamples.  Max pool, global average pool and the linear head
stay plain PyTorch.

The forwards take the tree from ``fold_bn``: the JAX package's parameter
layout with each BN folded into the fused conv's scale and shift.
``ResNet18`` folds once, when it is built.

Two execution paths, as in the JAX package:
* ``forward`` — monolithic;
* ``forward_fused_groups`` — the paper's fused-layer grouping (stem+stage1 /
  stage2 / stage3 fused; stage4 + head layer-by-layer).
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = dict[str, Any]

STAGE_CHANNELS = (64, 128, 256, 512)
BN_EPS = 1e-5


def init_basic_block(gen: torch.Generator, cin: int, cout: int, stride: int,
                     dtype: torch.dtype = torch.float32, device=None) -> Params:
    p: Params = {
        "conv1": L.init_conv(gen, 3, 3, cin, cout, dtype, device),
        "bn1": L.init_bn(cout, dtype, device),
        "conv2": L.init_conv(gen, 3, 3, cout, cout, dtype, device),
        "bn2": L.init_bn(cout, dtype, device),
    }
    if stride != 1 or cin != cout:
        p["down"] = L.init_conv(gen, 1, 1, cin, cout, dtype, device)
        p["down_bn"] = L.init_bn(cout, dtype, device)
    return p


def fold_bn(p: Params) -> Params:
    """The tree the forwards run on: ``p`` in the JAX package's layout with
    each BN dict folded to the fused conv's ``{"scale": γ·rsqrt(var+eps),
    "shift": β − mean·scale}``, both f32 for a tree of any dtype: the fused
    conv reads them as f32, and rounding them to a bf16 tree's dtype would
    add an error that JAX's BN does not make.  The conv and head weights are
    the same tensors, not copies."""
    out: Params = {}
    for k, v in p.items():
        if isinstance(v, dict) and "var" in v:
            scale = v["scale"].float() * torch.rsqrt(v["var"].float() + BN_EPS)
            shift = v["bias"].float() - v["mean"].float() * scale
            out[k] = {"scale": scale, "shift": shift}
        else:
            out[k] = fold_bn(v) if isinstance(v, dict) else v
    return out


def conv_bn(w: torch.Tensor, bn: Params, x: torch.Tensor, stride: int,
            padding: int, relu: bool,
            residual: torch.Tensor | None = None) -> torch.Tensor:
    """One fused-conv call; ``bn`` is a BN folded by ``fold_bn``."""
    return ops.fused_conv(x, w, bn["scale"], bn["shift"], stride=stride,
                          padding=padding, relu=relu, residual=residual)


def basic_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    h = conv_bn(p["conv1"], p["bn1"], x, stride, 1, relu=True)
    shortcut = x
    if "down" in p:
        shortcut = conv_bn(p["down"], p["down_bn"], x, stride, 0, relu=False)
    return conv_bn(p["conv2"], p["bn2"], h, 1, 1, relu=True,
                   residual=shortcut)   # the ADD_RELU epilogue


def init_resnet18(gen: torch.Generator, num_classes: int = 1000,
                  dtype: torch.dtype = torch.float32, device=None) -> Params:
    p: Params = {
        "conv1": L.init_conv(gen, 7, 7, 3, 64, dtype, device),
        "bn1": L.init_bn(64, dtype, device),
        "fc_w": L.dense_init(gen, 512, num_classes, dtype, device),
        "fc_b": torch.zeros(num_classes, dtype=dtype, device=device),
    }
    cin = 64
    for si, cout in enumerate(STAGE_CHANNELS):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            p[f"s{si + 1}b{bi + 1}"] = init_basic_block(gen, cin, cout, stride,
                                                        dtype, device)
            cin = cout
    return p


def stem(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = conv_bn(p["conv1"], p["bn1"], x, 2, 3, relu=True)
    return L.maxpool2d(h, 3, 2, 1)


def stage(p: Params, x: torch.Tensor, si: int) -> torch.Tensor:
    for bi in range(2):
        stride = 2 if (si > 0 and bi == 0) else 1
        x = basic_block(p[f"s{si + 1}b{bi + 1}"], x, stride)
    return x


def head(p: Params, x: torch.Tensor) -> torch.Tensor:
    return L.avgpool_global(x) @ p["fc_w"] + p["fc_b"]


def forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    """p: a tree from ``fold_bn``; x: (B, H, W, 3) → logits (B, classes)."""
    h = stem(p, x)
    for si in range(4):
        h = stage(p, h, si)
    return head(p, h)


# --- fused-group structure (paper's Fused4 grouping) ---

def fused_group_fns(p: Params):
    """The three fused groups + the layer-by-layer tail, as callables.
    Group boundaries follow plan_fused(graph, 2, 2): [stem+stage1, stage2,
    stage3], tail = stage4 + head."""
    return [
        lambda x: stage(p, stem(p, x), 0),
        lambda x: stage(p, x, 1),
        lambda x: stage(p, x, 2),
    ], lambda x: head(p, stage(p, x, 3))


def forward_fused_groups(p: Params, x: torch.Tensor) -> torch.Tensor:
    groups, tail = fused_group_fns(p)
    for g in groups:
        x = g(x)
    return tail(x)


# --- the module that holds the parameters ---

class ResNet18(nn.Module):
    """Holds ResNet18's parameters (as buffers: this is an inference model)
    and runs ``forward`` / ``forward_fused_groups`` on them.

    ``params`` is a nested dict with the JAX package's keys and layouts, e.g.
    from ``repro_torch.weights.params_from_jax``; without it the weights are
    drawn from ``seed``.  ``device`` defaults to ``cuda`` and raises if no
    card is present; pass ``device="cpu"`` for the plain CPU path.  The
    device is fixed here: BN is folded once, for that device.
    """

    def __init__(self, num_classes: int = 1000, *, params: Params | None = None,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        if params is None:
            params = init_resnet18(torch.Generator().manual_seed(seed),
                                   num_classes, dtype, device)
        self.params = L.tree_to(params, device)   # the JAX layout
        for name, t in L.flatten_tree(self.params).items():
            self.register_buffer(name, t)
        self.folded = fold_bn(self.params)       # what the forwards run on

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.folded, images)

    def forward_fused_groups(self, images: torch.Tensor) -> torch.Tensor:
        return forward_fused_groups(self.folded, images)


def build_resnet_model(cfg: ModelConfig, device=None):
    from repro_torch.models.api import Model
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)

    def init(seed: int = 0) -> ResNet18:
        return ResNet18(cfg.vocab_size, seed=seed, dtype=dtype, device=device)

    def fwd(model: ResNet18, batch: dict[str, torch.Tensor]):
        return model(batch["images"]), torch.zeros((), device=device)

    def no_cache(*a, **k):
        raise NotImplementedError("CNN classifier has no decode path")

    return Model(cfg, device, init, fwd, no_cache, no_cache)
