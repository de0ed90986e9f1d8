"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas
``repro.kernels.flash_attention.flash_attention_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.flash_attention`` sends CPU tensors to the plain version.
``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel.  The Pallas ``block_q``/``block_k`` knobs have no
counterpart: the kernel fixes its own tiles and masks ragged S and T.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0

# the head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_INDEX_LIMIT = 2**31                 # the kernel indexes with 32-bit ints
_GRID_Y_LIMIT = 65535                # one grid row per query head


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
    if BH > _GRID_Y_LIMIT:
        raise ValueError(f"flash_attention: BH {BH} > {_GRID_Y_LIMIT}")
    if window < 0 or softcap < 0:
        raise ValueError(f"flash_attention: window {window} and softcap "
                         f"{softcap} must be >= 0")
    check_every_row_sees_a_key(S, T, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.numel() >= _INDEX_LIMIT:
            raise ValueError(f"flash_attention: {name} has {t.numel()} "
                             f"elements, the kernel indexes below "
                             f"{_INDEX_LIMIT}")
    out = torch.empty_like(q)

    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, BKV, S, T, D, int(causal), int(window), float(softcap),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    launches += 1
    return out
