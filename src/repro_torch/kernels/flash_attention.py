"""Wrapper of the hand-written Hopper flash-attention kernels, the port of
the Pallas ``repro.kernels.flash_attention.flash_attention_kernel``
(``src/repro/kernels/flash_attention.py:84``), and of their backward.

The wrapper routes by dtype; neither route falls back on the other:

* bf16 → ``csrc/flash_attention_sm90.cu``: both products on the tensor
  cores (``wgmma``), K/V tiles through a TMA-fed ring of mbarrier-guarded
  stages, one producer and two consumer warpgroups.  Its bound on an H100
  is the 4·D operations per visible (query, key) pair at 989 TFLOP/s; P
  goes into the second product as hi + lo bf16, so that the output stays
  within half a bf16 ulp of the f32 function (see the source's header).
* f32 → ``csrc/flash_attention.cu``: the CUDA-core kernel, exact to
  reordered f32 sums, which the tensor cores cannot give; bound at
  67 TFLOP/s.  A persistent grid, one CTA an SM, deals out items of 128
  query rows of a head (64 at D = 256), longest first; two consumer groups
  take half of an item's rows each, while a producer warpgroup copies Q
  and the K and V rows (128 keys a tile up to D = 64, 64 up to D = 128, 32
  at D = 256) 16 bytes a thread into a ring of mbarrier-guarded buffers.
  S in register patches of 8 x 8 (8 x 4 at D = 80 to 128), a branch-free
  softmax in base 2 whose row statistics stay in registers, P through
  shared memory, O += P.V in 8-row patches over parts of the keys added in
  a fixed order.  Its bases must be 16-byte aligned.  Timed against SDPA's
  f32 forward by ``python3 chip_smoke.py --flash-bwd-times``; its
  arithmetic emulated on the CPU by ``tests/test_torch_flash_fwd_f32.py``.

It takes CUDA tensors only and raises on anything the kernels do not take;
``kernels.ops.flash_attention`` sends CPU tensors to the plain version.
``launches`` counts the forward's launches, ``backward_launches`` the
backward's, ``launches_by_kernel`` each route's, so a run can show that
its path went through the kernels it expects.  The Pallas
``block_q``/``block_k`` knobs have no counterpart: the kernels fix their
own tiles and mask ragged S and T.

``FlashAttention`` gives the kernel's output a gradient.  The JAX package
trains through the einsum ``attention_scores`` and never through its
Pallas kernel, which has no backward; the backward here is the gradient of
that arithmetic, computed by hand-written kernels from the forward's saved
q, k, v, O and per-row log-sum-exp, chosen by dtype:

* bf16 → ``csrc/flash_attention_bwd_sm90.cu`` (``bwd_tc_bf16``) at every
  head dim: ``wgmma`` with TMA-fed tiles, S and dP once per visible pair
  (twice at D = 128 and 256, whose two consumers split D; at D = 256 one
  stage of Q and dO and one dQ buffer), P and dS as hi + lo bf16; three
  launches: D_i and the padded statistics; dK and dV per key tile, whose
  dQ parts are added into an f32 accumulator in a fixed order per query
  tile, so two calls give the same bits; dq rounded from it.  Scratch from
  ``torch.empty``: the padded statistics, the accumulator and the order's
  counters, and at D = 256 the f32 sums into which each CTA flushes its dK
  and dV registers every 32 steps;
* f32 → ``csrc/flash_attention_bwd.cu`` (``bwd_simt_f32``): the CUDA cores,
  exact to reordered f32 sums, bound at 10·D operations a visible pair at
  67 TFLOP/s; two launches: D_i and the padded statistics; dK and dV per
  key tile (128 keys up to D = 64, 64 at D = 80 and 96, 32 above), S and
  dP once a pair in register-blocked patches of 8 x 8 fed from shared
  memory, rows bulk-copied into a two-stage ring, the dQ parts added into
  dq by bulk reductions in a fixed order, the lowest key tile first, so
  two calls give the same bits.  Scratch from ``torch.empty``: the padded
  statistics and the order's counters.  Timed on the card by ``python3
  chip_smoke.py --flash-bwd-times``; its arithmetic emulated on the CPU by
  ``tests/test_torch_flash_bwd.py``.

The dtype chooses before any launch; no route falls back on another.
``ref.attention_ref_grad`` stays the plain version: the CPU's, and the
yardstick the card is held to.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

launches = 0
backward_launches = 0
launches_by_kernel = {"wgmma_bf16": 0, "simt_f32": 0, "bwd_tc_bf16": 0,
                      "bwd_simt_f32": 0}
# the backward's route beside each forward route
BACKWARD_ROUTE = {"wgmma_bf16": "bwd_tc_bf16", "simt_f32": "bwd_simt_f32"}

# the head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
_INDEX_LIMIT = 2**31                 # the kernel indexes with 32-bit ints
_GRID_Y_LIMIT = 65535                # grid rows: the bf16 backward's one
                                     # per KV head (BKV <= BH), the bf16
_BF16_Q_TILE = 128                   # forward's one per 128-query tile
_BWD_ROWS = 64                       # backward: wgmma 64-row dQ tiles;
                                     # wgmma and f32 statistics padded to
                                     # 64 rows
_KV_ACC_FLOATS = 2 * 64 * 256        # D = 256: a 64-key CTA's dK and dV
_TMA_ALIGN = 16                      # bytes, TMA's and cp.async's alignment
_F32_TILE = 32                       # f32 backward: its least key and
                                     # query tile, the rows a dQ counter
                                     # slot stands for


def backward_route(dtype: torch.dtype, head_dim: int) -> str:
    """The ``launches_by_kernel`` key of the backward kernel that takes
    gradients of ``dtype`` at ``head_dim``: one route a dtype, at every
    head dim of HEAD_DIMS."""
    return BACKWARD_ROUTE["wgmma_bf16" if dtype == torch.bfloat16
                          else "simt_f32"]


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


def _check(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int, softcap: float,
           more: dict[str, torch.Tensor] | None = None,
           aligned: bool = False) -> tuple[int, int, int, int, int]:
    """Raises on operands the kernels do not take: q (BH, S, D), k and v
    (BKV, T, D), and ``more`` of q's dtype and shape, all 16-byte aligned
    in bf16 (TMA, cp.async) or where ``aligned`` (the f32 kernels' bulk
    copies and float4 loads); returns BH, BKV, S, T, D."""
    if q.device.type != "cuda":
        raise ValueError(f"{op} runs on CUDA tensors, q is on {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"flash_attention: q, k and v must be 3-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    operands = {"q": q, "k": k, "v": v, **(more or {})}
    for name, t in operands.items():
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
    for name, t in (more or {}).items():
        if t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {tuple(t.shape)} must "
                             f"be q's {tuple(q.shape)}")
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
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.numel() >= _INDEX_LIMIT:
            raise ValueError(f"flash_attention: {name} has {t.numel()} "
                             f"elements, the kernel indexes below "
                             f"{_INDEX_LIMIT}")
        if (bf16 or aligned) and t.data_ptr() % _TMA_ALIGN:
            raise ValueError(f"flash_attention: {name} must be "
                             f"{_TMA_ALIGN}-byte aligned for TMA and 16-byte "
                             f"loads")
    return BH, BKV, S, T, D


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True, window: int = 0,
                           softcap: float = 0.0, stats: bool = False):
    """q: (BH, S, D); k/v: (BKV, T, D) with BH = BKV·group, all float32 or
    all bfloat16, contiguous, on one CUDA device.  Returns (BH, S, D) in
    the input dtype; with ``stats``, (out, lse, out_lo) for the backward:
    each row's log-sum-exp of its logits, f32 (BH, S), and, in bf16, O's lo
    part bf16(o - bf16(o)) (None in f32).  ``out`` has the same bits
    either way."""
    global launches
    BH, BKV, S, T, D = _check("flash_attention_kernel", q, k, v, window,
                              softcap, aligned=True)
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32,
                      device=q.device) if stats else None
    out_lo = torch.empty_like(q) if stats and bf16 else None

    def ptr(t: torch.Tensor | None):
        return None if t is None else t.data_ptr()
    lib = _build.library()
    route = "wgmma_bf16" if bf16 else "simt_f32"
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if bf16:
            err = lib.flash_attention_sm90_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ptr(out_lo), ptr(lse), BH, BKV, S, T, D, int(causal),
                int(window), float(softcap), stream)
        else:
            err = lib.flash_attention_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ptr(lse), BH, BKV, S, T, D, int(causal), int(window),
                float(softcap), stream)
    if err:
        error_string = (lib.flash_attention_sm90_error_string if bf16 else
                        lib.flash_attention_error_string)
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()}")
    launches += 1
    launches_by_kernel[route] += 1
    return (out, lse, out_lo) if stats else out


def flash_attention_backward_kernel(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, *,
        out_lo: torch.Tensor | None = None, causal: bool = True,
        window: int = 0, softcap: float = 0.0
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_kernel`` for the output gradient
    ``dout``, from its inputs, its output and the ``lse`` (and, in bf16,
    ``out_lo``) it returned with ``stats``: contiguous dq (BH, S, D) and
    dk, dv (BKV, T, D) in the inputs' dtype, dk and dv summed over each KV
    head's query group.  The launches of the backward kernel of
    ``backward_route(dtype, D)``, counted once; scratch from
    ``torch.empty``."""
    global backward_launches
    bf16 = q.dtype == torch.bfloat16
    more = {"out": out, "dout": dout}
    if bf16:
        if out_lo is None:
            raise ValueError("flash_attention backward: bf16 needs out_lo, "
                             "O's lo part from the forward's stats")
        more["out_lo"] = out_lo
    BH, BKV, S, T, D = _check("flash_attention_backward_kernel", q, k, v,
                              window, softcap, more, aligned=True)
    if -(-max(S, T) // _BWD_ROWS) > _GRID_Y_LIMIT or (
            q.dtype == torch.float32
            and -(-T // _F32_TILE) > _GRID_Y_LIMIT):
        raise ValueError(f"flash_attention backward: S {S} or T {T} too "
                         f"large for the grid")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (BH, S) or not lse.is_contiguous()):
        raise ValueError(f"flash_attention backward: lse must be contiguous "
                         f"float32 ({BH}, {S}) on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    route = backward_route(q.dtype, D)
    s_pad = -(-S // _BWD_ROWS) * _BWD_ROWS
    if route == "bwd_tc_bf16" and BH * s_pad * D >= _INDEX_LIMIT:
        raise ValueError(f"flash_attention backward: the dQ accumulator "
                         f"({BH}, {s_pad}, {D}) has {_INDEX_LIMIT} or more "
                         f"elements")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    f32 = dict(dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        if route == "bwd_tc_bf16":
            di, lse2 = (torch.empty((BH, s_pad), **f32) for _ in range(2))
            dq_acc = torch.empty((BH, s_pad, D), **f32)
            counters = torch.empty((BH, s_pad // _BWD_ROWS),
                                   dtype=torch.int32, device=q.device)
            # D = 256: each CTA's dK and dV sums, flushed from registers
            kv_acc = (torch.empty(BKV * -(-T // _BWD_ROWS) * _KV_ACC_FLOATS,
                                  **f32) if D == 256 else None)
            err = lib.flash_attention_bwd_sm90_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                out_lo.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), di.data_ptr(),
                lse2.data_ptr(), dq_acc.data_ptr(), counters.data_ptr(),
                None if kv_acc is None else kv_acc.data_ptr(), BH, BKV, S, T,
                D, int(causal), int(window), float(softcap), stream)
            error_string = lib.flash_attention_sm90_error_string
        else:
            di, lse_pad = (torch.empty((BH, s_pad), **f32) for _ in range(2))
            counters = torch.empty((BH, s_pad // _F32_TILE),
                                   dtype=torch.int32, device=q.device)
            err = lib.flash_attention_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), di.data_ptr(), lse_pad.data_ptr(),
                counters.data_ptr(), BH, BKV, S, T, D, int(causal),
                int(window), float(softcap), stream)
            error_string = lib.flash_attention_error_string
    if err:
        raise RuntimeError(f"flash_attention {route} kernel launch failed: "
                           f"{error_string(err).decode()}")
    backward_launches += 1
    launches_by_kernel[route] += 1
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor | None, dout: torch.Tensor, *,
                             out_lo: torch.Tensor | None = None,
                             causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """``FlashAttention``'s default backward: the kernels for CUDA tensors,
    the plain ``ref.attention_ref_grad`` (recomputed from q, k and v) for
    CPU tensors, where no kernel runs."""
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "cpu":
        return ref.attention_ref_grad(q, k, v, dout, **kw)
    return flash_attention_backward_kernel(q, k, v, out, lse, dout,
                                           out_lo=out_lo, **kw)


class FlashAttention(torch.autograd.Function):
    """``forward`` runs ``forward_fn`` (the kernel on the model path; the
    tests inject the plain version) with ``stats=True`` on q (BH, S, D) and
    k, v (BKV, T, D), and saves q, k, v, the output and its statistics;
    ``backward`` runs ``backward_fn`` (``flash_attention_backward`` if not
    given; the tests inject emulations) on them: dq, dk and dv in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, softcap: float,
                forward_fn: Callable[..., tuple],
                backward_fn: Callable[..., tuple] | None = None
                ) -> torch.Tensor:
        ctx.kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse, out_lo = forward_fn(q, k, v, **ctx.kw, stats=True)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.backward_fn = backward_fn or flash_attention_backward
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = ctx.backward_fn(q, k, v, out, lse, dout.contiguous(),
                                     out_lo=out_lo, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
