"""Wrapper of the hand-written Hopper fused CONV + BN + [ADD] + [RELU]
kernel (``csrc/fused_conv.cu``), the port of the Pallas
``repro.kernels.fused_conv.fused_conv_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.fused_conv`` sends CPU tensors to the plain version.
``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

_INDEX_LIMIT = 2**31   # the kernel indexes with 32-bit ints


def out_hw(h: int, w: int, kh: int, kw: int, stride: int,
           padding: int) -> tuple[int, int]:
    return (h + 2 * padding - kh) // stride + 1, \
        (w + 2 * padding - kw) // stride + 1


def _check(name: str, t: torch.Tensor, device: torch.device,
           shape: tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"fused_conv: {name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_conv: the kernel takes float32 only, {name} "
                        f"is {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_conv: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_conv: {name} must be contiguous")
    if t.numel() >= _INDEX_LIMIT:
        raise ValueError(f"fused_conv: {name} has {t.numel()} elements, the "
                         f"kernel indexes below {_INDEX_LIMIT}")


def fused_conv_kernel(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, *, stride: int = 1,
                      padding: int = 1, relu: bool = True,
                      residual: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, H, W, Cin) NHWC; w: (kh, kw, Cin, Cout) HWIO; scale, shift:
    (Cout,); residual: (B, OH, OW, Cout).  Returns (B, OH, OW, Cout) with
    OH = (H + 2p - kh)//s + 1, all float32 on one CUDA device."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_kernel runs on CUDA tensors, x is on "
                         f"{x.device}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"fused_conv: x and w must be 4-d, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if stride < 1 or padding < 0:
        raise ValueError(f"fused_conv: stride {stride}, padding {padding}")
    B, H, W, Cin = x.shape
    kh, kw, _, Cout = w.shape
    OH, OW = out_hw(H, W, kh, kw, stride, padding)
    if OH < 1 or OW < 1:
        raise ValueError(f"fused_conv: a {kh}x{kw} window does not fit "
                         f"{H}x{W} with padding {padding}")
    _check("x", x, x.device, (B, H, W, Cin))
    _check("w", w, x.device, (kh, kw, Cin, Cout))
    _check("scale", scale, x.device, (Cout,))
    _check("shift", shift, x.device, (Cout,))
    if residual is not None:
        _check("residual", residual, x.device, (B, OH, OW, Cout))
    if B * OH * OW * Cout >= _INDEX_LIMIT:
        raise ValueError(f"fused_conv: the output has {B * OH * OW * Cout} "
                         f"elements, the kernel indexes below {_INDEX_LIMIT}")
    y = torch.empty((B, OH, OW, Cout), device=x.device, dtype=x.dtype)

    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.fused_conv_f32(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            None if residual is None else residual.data_ptr(), y.data_ptr(),
            B, H, W, Cin, kh, kw, Cout, OH, OW, stride, padding, int(relu),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed: "
                           f"{lib.fused_conv_error_string(err).decode()}")
    launches += 1
    return y
