"""Wrapper of the hand-written Hopper mLSTM-scan kernel
(``csrc/mlstm_scan_sm90.cu``: chunkwise in four launches, the large
products on the tensor cores as three TF32 products each, the scores in
f64), the port of the Pallas ``repro.kernels.mlstm_scan.mlstm_scan_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.mlstm_scan`` sends CPU tensors to the plain version.
``launches`` counts calls of the op (each call makes the kernel's four
launches), so a run can show that its path went through the kernel.  The
Pallas ``chunk`` knob has no counterpart: the kernel is built for chunks of
CHUNK steps and masks a ragged last chunk, so it takes any S.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import INDEX_LIMIT, check_f32_operands

launches = 0

MAX_HEAD_DIM = 512   # P the kernel holds
CHUNK = 128          # time steps per chunk, as the kernel is built


def state_floats(P: int) -> int:
    """Floats of one (batch, chunk, head) state in the scratch: C and n at
    P rounded up to 64."""
    pt = -(-P // 64) * 64
    return pt * pt + pt


def state_pass_fits(b: int, H: int, P: int) -> bool:
    """Whether the state pass, a thread per float4 of each (batch, head)'s
    state, counts them below 2**31."""
    return b * H * state_floats(P) < INDEX_LIMIT


def mlstm_scan_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_pre: torch.Tensor, f_pre: torch.Tensor
                      ) -> torch.Tensor:
    """q, k, v: (b, S, H, P); i_pre, f_pre: (b, S, H); all float32,
    contiguous, on one CUDA device, with P at most 512.  Returns h:
    (b, S, H, P) float32, the stabilised mLSTM recurrence's output."""
    global launches
    if q.dim() != 4 or i_pre.dim() != 3:
        raise ValueError(f"mlstm_scan: q must be 4-d and i_pre 3-d, got "
                         f"{tuple(q.shape)}, {tuple(i_pre.shape)}")
    b, S, H, P = q.shape
    check_f32_operands("mlstm_scan", {"q": q, "k": k, "v": v, "i_pre": i_pre,
                                      "f_pre": f_pre},
                       {"k": (b, S, H, P), "v": (b, S, H, P),
                        "i_pre": (b, S, H), "f_pre": (b, S, H)})
    if min(b, S, H, P) < 1 or P > MAX_HEAD_DIM:
        raise ValueError(f"mlstm_scan: b {b}, S {S}, H {H}, P {P}: needs "
                         f"each >= 1 and P <= {MAX_HEAD_DIM}")
    if not state_pass_fits(b, H, P):
        raise ValueError(f"mlstm_scan: b·H = {b * H} states of "
                         f"{state_floats(P)} floats; the state pass indexes "
                         f"them below {INDEX_LIMIT}")
    h = torch.empty_like(q)

    lib = _build.library()
    scratch = torch.empty(
        lib.mlstm_scan_sm90_scratch_bytes(b, S, H, P, CHUNK),
        dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mlstm_scan_sm90_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
            f_pre.data_ptr(), h.data_ptr(), scratch.data_ptr(), b, S, H, P,
            CHUNK, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan kernel launch failed: "
                           f"{lib.mlstm_scan_sm90_error_string(err).decode()}")
    launches += 1
    return h
