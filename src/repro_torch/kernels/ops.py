"""Public kernel entry points, mirroring ``repro.kernels.ops``.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  The TPU
tiling knobs of the JAX wrapper (``tile_h``, ``tile_w``, ``cout_block``)
have no counterpart: the CUDA kernel fixes its own tile and masks ragged
edges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.fused_conv import fused_conv_kernel
from repro_torch.kernels.ref import fused_conv_ref


def fused_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, *, stride: int = 1, padding: int = 1,
               relu: bool = True,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """[relu](conv(x, w, stride, padding)·scale + shift [+ residual]),
    NHWC/HWIO, accumulated in f32."""
    fn = fused_conv_ref if x.device.type == "cpu" else fused_conv_kernel
    return fn(x, w, scale, shift, stride=stride, padding=padding, relu=relu,
              residual=residual)
