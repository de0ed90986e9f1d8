"""Public kernel entry points, mirroring ``repro.kernels.ops``.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; a CUDA
tensor goes to the hand-written kernel, which launches or raises.  The one
way to run the plain version on a CUDA tensor is the explicit ``plain()``
context, which exists to hold a whole model against its plain self on the
card; the model path never enters it.  The TPU tiling knobs of the JAX
wrappers (``tile_h``, ``tile_w``, ``cout_block``, ``block_q``, ``block_k``,
``chunk``) have no counterpart: the CUDA kernels fix their own tiles and
mask ragged edges.  The scans' ``chunk`` in particular only tiled the
sequence for the TPU's sequential grid; their results do not depend on it
(the JAX tests' chunk-invariance cases), so ``mamba_scan`` and
``mlstm_scan`` take none.

Training: on a CUDA tensor that needs a gradient (grad mode on, an input
requiring grad, outside ``plain()``), each op with a backward launches its
kernel through its autograd function: ``flash_attention`` through
``FlashAttention``, whose backward is the gradient of the plain
arithmetic; ``mamba_scan`` and ``mlstm_scan`` through ``MambaScan`` and
``MLSTMScan``, whose backwards are hand-written kernels of their own.
``fused_conv`` has no backward yet and raises, rather than return an
output whose gradient silently stops.  A CPU tensor, or any tensor inside
``plain()``, takes the plain version, which autograd differentiates.
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

from repro_torch.kernels.flash_attention import (
    FlashAttention, check_every_row_sees_a_key, flash_attention_kernel)
from repro_torch.kernels.fused_conv import fused_conv_kernel
from repro_torch.kernels.mamba_scan import MambaScan, mamba_scan_kernel
from repro_torch.kernels.mlstm_scan import MLSTMScan, mlstm_scan_kernel
from repro_torch.kernels.ref import (attention_ref, fused_conv_ref,
                                     mamba_scan_ref, mlstm_ref)

_plain = False


@contextlib.contextmanager
def plain() -> Iterator[None]:
    """Inside this context every op runs its plain PyTorch version, also on
    CUDA tensors, and no kernel launches."""
    global _plain
    before, _plain = _plain, True
    try:
        yield
    finally:
        _plain = before


def _use_plain(x: torch.Tensor) -> bool:
    return _plain or x.device.type == "cpu"


def _needs_grad(*ts: torch.Tensor | None) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_backward(name: str, item: str, *ts: torch.Tensor | None) -> None:
    """Refuse to launch a kernel that has no backward where a gradient is
    wanted; ``item`` names the ROADMAP item that adds one."""
    if _needs_grad(*ts):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, so its output would "
            f"carry no gradient; training through it waits for ROADMAP "
            f"queue 1's {item!r} (run under torch.no_grad(), or inside "
            f"ops.plain() for the plain version)")


def fused_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, *, stride: int = 1, padding: int = 1,
               relu: bool = True,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """[relu](conv(x, w, stride, padding)·scale + shift [+ residual]),
    NHWC/HWIO, accumulated in f32."""
    if _use_plain(x):
        fn = fused_conv_ref
    else:
        _no_backward("fused_conv", "a fused_conv backward", x, w, scale,
                     shift, residual)
        fn = fused_conv_kernel
    return fn(x, w, scale, shift, stride=stride, padding=padding, relu=relu,
              residual=residual)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """(B, S, H, hd) × (B, T, KV, hd)² → (B, S, H, hd): GQA attention with
    f32 softmax, causal (top-left), ``window`` (0 = none) and ``softcap``
    (0 = none), through the kernel's (B·H, S, hd) layout.  A window that
    leaves a query row with no visible key (S >= T + window) raises, on
    every device."""
    Bt, S, H, D = q.shape
    _, T, KV, _ = k.shape
    check_every_row_sees_a_key(S, T, window)
    q3 = q.transpose(1, 2).reshape(Bt * H, S, D).contiguous()
    k3 = k.transpose(1, 2).reshape(Bt * KV, T, D).contiguous()
    v3 = v.transpose(1, 2).reshape(Bt * KV, T, D).contiguous()
    if _use_plain(q):
        out = attention_ref(q3, k3, v3, causal=causal, window=window,
                            softcap=softcap)
    elif _needs_grad(q, k, v):
        out = FlashAttention.apply(q3, k3, v3, causal, window, softcap,
                                   flash_attention_kernel)
    else:
        out = flash_attention_kernel(q3, k3, v3, causal=causal,
                                     window=window, softcap=softcap)
    return out.reshape(Bt, H, S, D).transpose(1, 2)


def mamba_scan(dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence ``S_t = e^{a_t}·S_{t-1} + dtx_t ⊗ B_t``,
    ``y_t = S_t·C_t``: dtx (b, S, H, P), a_log (b, S, H), B/C (b, S, N)
    shared by all heads, all f32 → y (b, S, H, P) in f32."""
    args = (dtx.contiguous(), a_log.contiguous(), B.contiguous(),
            C.contiguous())
    if _use_plain(dtx):
        return mamba_scan_ref(*args)
    if _needs_grad(*args):
        return MambaScan.apply(*args)
    return mamba_scan_kernel(*args)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """The stabilised mLSTM recurrence: q, k, v (b, S, H, P), i_pre and
    f_pre (b, S, H), all f32 → h (b, S, H, P) in f32 (``ref.mlstm_ref``
    gives the formulas)."""
    args = (q.contiguous(), k.contiguous(), v.contiguous(),
            i_pre.contiguous(), f_pre.contiguous())
    if _use_plain(q):
        return mlstm_ref(*args)
    if _needs_grad(*args):
        return MLSTMScan.apply(*args)
    return mlstm_scan_kernel(*args)
