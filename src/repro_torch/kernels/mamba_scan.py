"""Wrapper of the hand-written Hopper SSD-scan kernel
(``csrc/mamba_scan_sm90.cu``: chunk-parallel in three launches, the
products on the tensor cores as three bf16 products each), the port of the
Pallas ``repro.kernels.mamba_scan.mamba_scan_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.mamba_scan`` sends CPU tensors to the plain version.
``launches`` counts calls of the op (each call makes the kernel's three
launches), so a run can show that its path went through the kernel.  The
Pallas ``chunk`` knob has no counterpart: the kernel is built for chunks of
64 and 128 steps, ``chunk_for`` picks one by S, and a ragged last chunk is
masked, so it takes any S.  ``plan`` picks how many heads a block of the
first and the last launch takes.

The backward is a kernel of its own (``csrc/mamba_scan_bwd_sm90.cu``, four
launches: chunk sums, state passes, chunk gradients, group sums; chunk 64,
the products on the tensor cores as three bf16 products each),
``mamba_scan_bwd_kernel``, counted by ``backward_launches`` once a call;
``plan_bwd`` picks the heads a block of its chunk-sums and chunk-gradients
launches takes.  ``MambaScan`` is the autograd function that runs the two.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._operands import INDEX_LIMIT, check_f32_operands

launches = 0
backward_launches = 0

MAX_STATE = 64            # P and N the kernel holds, each at most this
BUILT_CHUNKS = (64, 128)  # the chunks (time steps) the kernel is built for
SHORT_S = 256             # S up to which the shorter chunk is the faster
STATE_FLOATS = 64 * 64    # one head's state in the scratch, padded
MAX_GROUP = 32            # heads a block of phase 1 or 3 takes
SMS = 132                 # streaming multiprocessors of an H100 SXM
# A block's set-up in units of one head's work: phase 1 splits B and scans
# the decays, phase 3 also stages C and forms C.B^T, as much as a head; the
# backward's chunk sums and chunk gradients likewise.
_SETUP_COST = {1: 0.5, 3: 1.0}
BWD_CHUNK = 64            # the backward kernel's chunk (time steps)
# Heads a block of the backward's chunk sums takes at most: at zamba2's
# 4x1024 blocks of 5 heads in several waves ran faster on an H100 than one
# wave of blocks of 20, each block's first loads then overlapping other
# blocks' work (PERF.md).
BWD_SUMS_GROUP = 5


def chunk_for(S: int) -> int:
    """The kernel's chunk for a sequence of S steps.  128 halves the state
    traffic of 64 and is the faster at S 1000 and 4096 on an H100; up to S
    256 the shorter chunk gives more blocks and less causal padding, and
    is the faster (PERF.md)."""
    return BUILT_CHUNKS[0] if S <= SHORT_S else BUILT_CHUNKS[1]


def heads_per_block(blocks_per_head: int, H: int, resident: int,
                    setup: float, most: int = MAX_GROUP) -> int:
    """The heads G (at most ``most``) a block takes, when each of
    ``blocks_per_head`` (batch x chunk) cells needs ceil(H / G) blocks and
    the card holds ``resident`` at once: the G whose waves of blocks take
    the least modelled time, a block costing ``setup`` plus G heads; ties
    go to the smaller G."""
    best = None
    for g in range(1, min(H, most) + 1):
        waves = math.ceil(blocks_per_head * math.ceil(H / g) / resident)
        cost = waves * (setup + g)
        if best is None or cost < best[0]:
            best = (cost, g)
    return best[1]


@functools.cache
def plan(b: int, S: int, H: int, chunk: int,
         resident: tuple[int, int] = (2 * SMS, SMS)) -> tuple[int, int]:
    """The heads per block of phase 1 (chunk states) and phase 3 (chunk
    outputs) at ``chunk``, where the card holds ``resident`` blocks of each
    at once."""
    cells = b * math.ceil(S / chunk)
    return tuple(heads_per_block(cells, H, r, _SETUP_COST[phase])
                 for r, phase in zip(resident, (1, 3)))


@functools.cache
def plan_bwd(b: int, S: int, H: int,
             resident: tuple[int, int] = (2 * SMS, SMS)) -> tuple[int, int]:
    """The heads per block of the backward's chunk sums and chunk gradients,
    where the card holds ``resident`` blocks of each at once."""
    cells = b * math.ceil(S / BWD_CHUNK)
    return (heads_per_block(cells, H, resident[0], _SETUP_COST[1],
                            BWD_SUMS_GROUP),
            heads_per_block(cells, H, resident[1], _SETUP_COST[3]))


@functools.cache
def bwd_resident_blocks(device: int) -> tuple[int, int]:
    """How many blocks of the backward's chunk sums and of its chunk
    gradients CUDA device ``device`` holds at once."""
    lib = _build.library()
    with torch.cuda.device(device):
        blocks = tuple(lib.mamba_scan_bwd_sm90_resident_blocks(phase)
                       for phase in (1, 3))
    if min(blocks) < 1:
        raise RuntimeError(f"mamba_scan_bwd: the card holds no block of the "
                           f"kernel: {blocks}")
    return blocks


@functools.cache
def resident_blocks(device: int, chunk: int) -> tuple[int, int]:
    """How many blocks of phase 1 and of phase 3 at ``chunk`` CUDA device
    ``device`` holds at once."""
    lib = _build.library()
    with torch.cuda.device(device):
        blocks = tuple(lib.mamba_scan_sm90_resident_blocks(phase, chunk)
                       for phase in (1, 3))
    if min(blocks) < 1:
        raise RuntimeError(f"mamba_scan: the card holds no block of the "
                           f"kernel: {blocks}")
    return blocks


def _check_operands(op: str, dtx: torch.Tensor, a_log: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    dy: torch.Tensor | None = None
                    ) -> tuple[int, int, int, int, int]:
    """Raises on operands the kernels do not take; returns b, S, H, P, N."""
    if dtx.dim() != 4 or a_log.dim() != 3 or B.dim() != 3 or C.dim() != 3:
        raise ValueError(f"{op}: dtx must be 4-d and a_log, B, C 3-d, "
                         f"got {tuple(dtx.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, S, H, P = dtx.shape
    N = B.shape[2]
    operands = {"dtx": dtx, "a_log": a_log, "B": B, "C": C}
    if dy is not None:
        operands = {"dy": dy, **operands}
    check_f32_operands(op, operands,
                       {"dy": (b, S, H, P), "dtx": (b, S, H, P),
                        "a_log": (b, S, H), "B": (b, S, N), "C": (b, S, N)})
    if min(b, S, H, P, N) < 1 or P > MAX_STATE or N > MAX_STATE:
        raise ValueError(f"{op}: b {b}, S {S}, H {H}, P {P}, N {N}: "
                         f"needs each >= 1 and P, N <= {MAX_STATE}")
    if b * H * STATE_FLOATS >= INDEX_LIMIT:
        raise ValueError(f"{op}: b·H = {b * H} states of "
                         f"{STATE_FLOATS} floats; the state pass indexes "
                         f"them below {INDEX_LIMIT}")
    return b, S, H, P, N


def mamba_scan_kernel(dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, *,
                      chunk: int | None = None) -> torch.Tensor:
    """dtx: (b, S, H, P); a_log: (b, S, H); B/C: (b, S, N); all float32,
    contiguous, on one CUDA device, with P and N at most 64.  Returns y:
    (b, S, H, P) float32, the SSD recurrence's output.  ``chunk`` (one of
    BUILT_CHUNKS; ``chunk_for(S)`` if None) is there to time each build."""
    global launches
    if chunk is not None and chunk not in BUILT_CHUNKS:
        raise ValueError(f"mamba_scan: chunk {chunk} is not one of the "
                         f"kernel's builds {BUILT_CHUNKS}")
    b, S, H, P, N = _check_operands("mamba_scan", dtx, a_log, B, C)
    chunk = chunk or chunk_for(S)
    y = torch.empty_like(dtx)
    # Per (batch, chunk, head) the chunk's state, then the state entering
    # it, and the chunk's decay e^{A_c}.
    cells = b * math.ceil(S / chunk) * H
    scratch = torch.empty(cells * (STATE_FLOATS + 1), dtype=torch.float32,
                          device=dtx.device)
    device = dtx.device.index
    group1, group3 = plan(b, S, H, chunk, resident_blocks(device, chunk))

    lib = _build.library()
    err = lib.mamba_scan_sm90_f32(
        dtx.data_ptr(), a_log.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), b, S, H, P, N, chunk, group1,
        group3, device, torch.cuda.current_stream(dtx.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan kernel launch failed: "
                           f"{lib.mamba_scan_sm90_error_string(err).decode()}")
    launches += 1
    return y


def mamba_scan_bwd_kernel(dy: torch.Tensor, dtx: torch.Tensor,
                          a_log: torch.Tensor, B: torch.Tensor,
                          C: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The gradient of the SSD scan for the output gradient dy (b, S, H,
    P), from the forward's inputs as ``mamba_scan_kernel`` takes them:
    (d dtx, d a_log, dB, dC) in float32, dB and dC summed over the heads."""
    global backward_launches
    b, S, H, P, N = _check_operands("mamba_scan_bwd", dtx, a_log, B, C, dy)
    ddtx, da = torch.empty_like(dtx), torch.empty_like(a_log)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    lib = _build.library()
    group1, group3 = plan_bwd(b, S, H, bwd_resident_blocks(dtx.device.index))
    # The chunks' own states and adjoints, then in place the states
    # entering and the adjoints leaving them; the decays; each group's part
    # of dB and dC.
    scratch = torch.empty(
        lib.mamba_scan_bwd_sm90_scratch_bytes(b, S, H, group3),
        dtype=torch.uint8, device=dtx.device)
    with torch.cuda.device(dtx.device):
        err = lib.mamba_scan_bwd_sm90_f32(
            dy.data_ptr(), dtx.data_ptr(), a_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), ddtx.data_ptr(), da.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), scratch.data_ptr(), b, S, H, P, N, group1, group3,
            torch.cuda.current_stream(dtx.device).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan backward kernel launch failed: "
                           f"{lib.mamba_scan_sm90_error_string(err).decode()}")
    backward_launches += 1
    return ddtx, da, dB, dC


class MambaScan(torch.autograd.Function):
    """``forward`` launches the scan kernel on dtx, a_log, B and C and saves
    them; ``backward`` launches the backward kernel on them."""

    @staticmethod
    def forward(ctx, dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(dtx, a_log, B, C)
        return mamba_scan_kernel(dtx, a_log, B, C)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return mamba_scan_bwd_kernel(dy.contiguous(), *ctx.saved_tensors)
