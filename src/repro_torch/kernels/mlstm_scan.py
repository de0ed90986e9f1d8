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

The backward is a kernel of its own (``csrc/mlstm_scan_bwd_sm90.cu``, six
launches, each pair (t, s) of the quadratic form taken once: the scores in
f64 on the FP64 tensor cores, the products as three TF32 products on the
tensor cores), ``mlstm_scan_bwd_kernel``, counted by ``backward_launches``
(once a call); ``MLSTMScan`` is the autograd function that runs the two.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import INDEX_LIMIT, check_f32_operands

launches = 0
backward_launches = 0

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


def _check_operands(op: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, i_pre: torch.Tensor, f_pre: torch.Tensor,
                    **more: torch.Tensor) -> tuple[int, int, int, int]:
    """Raises on operands the kernels do not take (``more``: further (b, S,
    H, P) operands); returns b, S, H, P."""
    if q.dim() != 4 or i_pre.dim() != 3:
        raise ValueError(f"{op}: q must be 4-d and i_pre 3-d, got "
                         f"{tuple(q.shape)}, {tuple(i_pre.shape)}")
    b, S, H, P = q.shape
    check_f32_operands(op, {"q": q, "k": k, "v": v, "i_pre": i_pre,
                            "f_pre": f_pre, **more},
                       {"k": (b, S, H, P), "v": (b, S, H, P),
                        "i_pre": (b, S, H), "f_pre": (b, S, H),
                        **{name: (b, S, H, P) for name in more}})
    if min(b, S, H, P) < 1 or P > MAX_HEAD_DIM:
        raise ValueError(f"{op}: b {b}, S {S}, H {H}, P {P}: needs "
                         f"each >= 1 and P <= {MAX_HEAD_DIM}")
    return b, S, H, P


def mlstm_scan_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      i_pre: torch.Tensor, f_pre: torch.Tensor
                      ) -> torch.Tensor:
    """q, k, v: (b, S, H, P); i_pre, f_pre: (b, S, H); all float32,
    contiguous, on one CUDA device, with P at most 512.  Returns h:
    (b, S, H, P) float32, the stabilised mLSTM recurrence's output."""
    global launches
    b, S, H, P = _check_operands("mlstm_scan", q, k, v, i_pre, f_pre)
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


def mlstm_scan_bwd_kernel(dh: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, i_pre: torch.Tensor,
                          f_pre: torch.Tensor, h: torch.Tensor
                          ) -> tuple[torch.Tensor, ...]:
    """The gradient of the mLSTM scan for the output gradient dh (b, S, H,
    P), from the forward's inputs and its output h: (dq, dk, dv, d i_pre,
    d f_pre) in float32."""
    global backward_launches
    b, S, H, P = _check_operands("mlstm_scan_bwd", q, k, v, i_pre, f_pre,
                                 dh=dh, h=h)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i_pre), torch.empty_like(f_pre)
    lib = _build.library()
    scratch = torch.empty(lib.mlstm_scan_bwd_sm90_scratch_bytes(b, S, H),
                          dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.mlstm_scan_bwd_sm90_f32(
            dh.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            i_pre.data_ptr(), f_pre.data_ptr(), h.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), di.data_ptr(), df.data_ptr(),
            scratch.data_ptr(), b, S, H, P,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mlstm_scan backward kernel launch failed: "
                           f"{lib.mlstm_scan_sm90_error_string(err).decode()}")
    backward_launches += 1
    return dq, dk, dv, di, df


class MLSTMScan(torch.autograd.Function):
    """``forward`` launches the mLSTM-scan kernel on q, k, v, i_pre and
    f_pre and saves them with its output; ``backward`` launches the
    backward kernel on them."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
        h = mlstm_scan_kernel(q, k, v, i_pre, f_pre)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, h)
        return h

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        q, k, v, i_pre, f_pre, h = ctx.saved_tensors
        return mlstm_scan_bwd_kernel(dh.contiguous(), q, k, v, i_pre, f_pre,
                                     h)
