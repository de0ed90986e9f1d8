"""Wrapper of the hand-written Hopper flash-attention kernels, the port of
the Pallas ``repro.kernels.flash_attention.flash_attention_kernel``
(``src/repro/kernels/flash_attention.py:84``).

The wrapper routes by dtype; neither route falls back on the other:

* bf16 → ``csrc/flash_attention_sm90.cu``: both products on the tensor
  cores (``wgmma``), K/V tiles through a TMA-fed ring of mbarrier-guarded
  stages, one producer and two consumer warpgroups.  Its bound on an H100
  is the 4·D operations per visible (query, key) pair at 989 TFLOP/s; P
  goes into the second product as hi + lo bf16, so that the output stays
  within half a bf16 ulp of the f32 function (see the source's header).
* f32 → ``csrc/flash_attention.cu``: the CUDA-core kernel, exact to
  reordered f32 sums, which the tensor cores cannot give; bound at
  67 TFLOP/s.

It takes CUDA tensors only and raises on anything the kernels do not take;
``kernels.ops.flash_attention`` sends CPU tensors to the plain version.
``launches`` counts the launches of both, ``launches_by_kernel`` each
route's, so a run can show that its path went through the kernel it
expects.  The Pallas ``block_q``/``block_k`` knobs have no counterpart: the
kernels fix their own tiles and mask ragged S and T.

``FlashAttention`` gives the kernel's output a gradient.  The JAX package
trains through the einsum ``attention_scores`` and never through its
Pallas kernel, which has no backward; so the backward here is the gradient
of that arithmetic (``ref.attention_ref_grad``), recomputed in f32 from
the saved q, k and v.  A hand-written backward kernel is a later step.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

launches = 0
launches_by_kernel = {"wgmma_bf16": 0, "simt_f32": 0}

# the head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_INDEX_LIMIT = 2**31                 # the kernel indexes with 32-bit ints
_GRID_Y_LIMIT = 65535                # grid rows: f32 one per query head,
_BF16_Q_TILE = 128                   # bf16 one per 128-query tile
_TMA_ALIGN = 16                      # bytes, TMA's base-address alignment


def check_every_row_sees_a_key(S: int, T: int, window: int) -> None:
    """Refuse a window that leaves a query row with no visible key.

    Row i sees the keys j < T with j > i - window (and j <= i when causal),
    so with a window some row sees none exactly when S >= T + window.  The
    JAX reference gives such a row the mean of v over all T keys (every
    logit is -1e30); the kernel skips all of its key tiles and would give
    0.  No path of the port makes such a row (its prefill has S = T), so
    the op refuses them on every device rather than compute two functions.
    """
    if window > 0 and S >= T + window:
        raise ValueError(f"flash_attention: window {window} with S {S} >= "
                         f"T {T} + window leaves query rows with no visible "
                         f"key")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q: (BH, S, D); k/v: (BKV, T, D) with BH = BKV·group, all float32 or
    all bfloat16, contiguous, on one CUDA device.  Returns (BH, S, D) in
    the input dtype."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_kernel runs on CUDA tensors, q is "
                         f"on {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q, k and v must be 3-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if tuple(v.shape) != (BKV, T, D) or k.shape[2] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must both be (BKV, T, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D}, the kernel is "
                         f"built for {HEAD_DIMS}")
    if S < 1 or T < 1 or BKV < 1 or BH % BKV:
        raise ValueError(f"flash_attention: BH {BH}, BKV {BKV}, S {S}, T {T}:"
                         " needs S, T >= 1 and BH a multiple of BKV")
    if BH > _GRID_Y_LIMIT or -(-S // _BF16_Q_TILE) > _GRID_Y_LIMIT:
        raise ValueError(f"flash_attention: BH {BH} or S {S} too large for "
                         f"the grid")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")
    check_every_row_sees_a_key(S, T, window)
    bf16 = q.dtype == torch.bfloat16
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.numel() >= _INDEX_LIMIT:
            raise ValueError(f"flash_attention: {name} has {t.numel()} "
                             f"elements, the kernel indexes below "
                             f"{_INDEX_LIMIT}")
        if bf16 and t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"flash_attention: {name} must be "
                             f"{_TMA_ALIGN}-byte aligned for TMA")
    out = torch.empty_like(q)

    lib = _build.library()
    route = "wgmma_bf16" if bf16 else "simt_f32"
    fn, error_string = ((lib.flash_attention_sm90_bf16,
                         lib.flash_attention_sm90_error_string) if bf16 else
                        (lib.flash_attention_f32,
                         lib.flash_attention_error_string))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, BKV, S, T, D, int(causal), int(window), float(softcap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()}")
    launches += 1
    launches_by_kernel[route] += 1
    return out


class FlashAttention(torch.autograd.Function):
    """``forward`` runs ``forward_fn`` (the kernel on the model path; the
    tests inject the plain version) on q (BH, S, D) and k, v (BKV, T, D)
    and saves the inputs; ``backward`` returns ``ref.attention_ref_grad``
    of them: dq, dk and dv in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float,
                forward_fn: Callable[..., torch.Tensor]) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        return forward_fn(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = ref.attention_ref_grad(q, k, v, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None
