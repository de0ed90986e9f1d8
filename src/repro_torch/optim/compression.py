"""Gradient compression for the data-parallel all-reduce, the port of
``repro.optim.compression``.

int8 block quantization with ERROR FEEDBACK: each leaf is quantized per
block of 256 values against the block's absmax / 127, and the
quantization residual is carried into the next step so that the
compression is unbiased over time.  ``torch.round`` rounds half to even as
``jnp.round`` does, and the division is IEEE float32 on both sides, so the
codes are JAX's exactly.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.core.dtensor import is_dtensor

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """→ (int8 codes (blocks, 256), float32 per-block scales (blocks, 1),
    pad)."""
    flat, pad = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return codes, scale, pad


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor, pad: int,
                    shape) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one gradient leaf.
    Returns (g_compressed, new_err) with g_compressed ≈ g + err.  A
    sharded leaf (a DTensor) is compressed as the global tensor it holds,
    every rank computing the same blocks, and both results take ``err``'s
    placements."""
    if is_dtensor(err):
        from torch.distributed.tensor import distribute_tensor
        g_hat, new_err = compress_leaf(g.full_tensor(), err.full_tensor())
        return tuple(distribute_tensor(t, err.device_mesh, err.placements)
                     for t in (g_hat, new_err))
    target = g.to(torch.float32) + err
    codes, scale, pad = quantize_int8(target)
    g_hat = dequantize_int8(codes, scale, pad, g.shape)
    return g_hat, target - g_hat


def init_error_feedback(params: Any) -> Any:
    return tree.map(lambda x: torch.zeros_like(
        x, dtype=torch.float32, requires_grad=False), params)


def compress_grads(grads: Any, err_state: Any):
    outs = [compress_leaf(g, e) for g, e in zip(tree.leaves(grads),
                                                tree.leaves(err_state))]
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))
