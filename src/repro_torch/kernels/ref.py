"""Plain PyTorch versions of the port's kernels: the CPU path and the
reference each kernel is held against on the card."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fused_conv_ref(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, stride: int = 1, padding: int = 1,
                   relu: bool = True,
                   residual: torch.Tensor | None = None) -> torch.Tensor:
    """CONV + BN(folded scale/shift) [+ADD] [+RELU] — the paper's fused
    PIMcore op.  x: (B, H, W, Cin), w: (kh, kw, Cin, Cout); f32 inside,
    returned in ``x.dtype``."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1),
                 stride=stride, padding=padding).permute(0, 2, 3, 1)
    y = y * scale.float() + shift.float()
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).contiguous()
