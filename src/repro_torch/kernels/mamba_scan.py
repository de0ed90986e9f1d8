"""Wrapper of the hand-written Hopper SSD-scan kernel
(``csrc/mamba_scan.cu``), the port of the Pallas
``repro.kernels.mamba_scan.mamba_scan_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.mamba_scan`` sends CPU tensors to the plain version.
``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel.  The Pallas ``chunk`` knob has no counterpart: the
kernel fixes its own chunk of 64 steps and masks a ragged last one, so it
takes any S.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import check_f32_operands

launches = 0

MAX_STATE = 64            # P and N the kernel holds, each at most this


def mamba_scan_kernel(dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor) -> torch.Tensor:
    """dtx: (b, S, H, P); a_log: (b, S, H); B/C: (b, S, N); all float32,
    contiguous, on one CUDA device, with P and N at most 64.  Returns y:
    (b, S, H, P) float32, the SSD recurrence's output."""
    global launches
    if dtx.dim() != 4 or a_log.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"mamba_scan: dtx must be 4-d and a_log, B, C 3-d, "
                         f"got {tuple(dtx.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, S, H, P = dtx.shape
    N = B.shape[2]
    check_f32_operands("mamba_scan", {"dtx": dtx, "a_log": a_log, "B": B,
                                      "C": C},
                       {"a_log": (b, S, H), "B": (b, S, N), "C": (b, S, N)})
    if min(b, S, H, P, N) < 1 or P > MAX_STATE or N > MAX_STATE:
        raise ValueError(f"mamba_scan: b {b}, S {S}, H {H}, P {P}, N {N}: "
                         f"needs each >= 1 and P, N <= {MAX_STATE}")
    y = torch.empty_like(dtx)

    lib = _build.library()
    with torch.cuda.device(dtx.device):
        err = lib.mamba_scan_f32(
            dtx.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), b, S, H, P, N,
            torch.cuda.current_stream(dtx.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: "
                           f"{lib.mamba_scan_error_string(err).decode()}")
    launches += 1
    return y
