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

Dtypes, as in JAX's ops: ``fused_conv`` takes any mix of f32, bf16 and
f16 operands, computes in f32 and returns ``x.dtype``; on the card x, w
and the residual all in bf16 take the kernel's bf16 route (one bf16
product per k-step), any other mix its f32 route on f32 copies.  The scans
take bf16 (or f16) operands too, compute in f32 (their kernels, and the
plain versions, on f32 copies) and return the first operand's dtype, also
under autograd.

Training: on a CUDA tensor that needs a gradient (grad mode on, an input
requiring grad, outside ``plain()``), each op with a backward launches its
kernel through its autograd function, whose backward is a hand-written
kernel of its own: ``flash_attention`` through ``FlashAttention`` (the
forward saves each row's log-sum-exp for the backward kernels of its
dtype's route), ``mamba_scan`` and ``mlstm_scan`` through ``MambaScan``
and ``MLSTMScan``.
``fused_conv`` has no backward yet and raises, rather than return an
output whose gradient silently stops.  A CPU tensor, or any tensor inside
``plain()``, takes the plain version, which autograd differentiates.

DTensors (the sharded launch path): a kernel reads ``data_ptr()``, which a
DTensor does not give, so ``flash_attention``, ``mamba_scan`` and
``mlstm_scan`` take a DTensor through ``local_map``: the op runs on each
rank's local shards, through the kernel on the card (and its autograd
function) and the plain version on the CPU, exactly as on a plain tensor
of that device.  That is exact only where the shards are independent
problems: batch-sharded inputs, head-sharded ones (attention with whole
GQA groups per shard, the SSD scan with B and C whole, the mLSTM), and any
placement on a mesh dim of size 1.  On any other mesh dim (a sequence
shard, whose causal mask and recurrence would start at the wrong
position; a head-dim shard; a partial sum) the inputs are first
redistributed to ``Replicate`` there, and the output goes back to the
placements of the first input afterwards: the collectives GSPMD would
insert around the Pallas call.  ``exact_placements`` makes that choice.
Meta shards (the dry run's: shapes, no data) take the plain version,
which gives the output's shape; the scans' plain versions loop over time,
so on meta shards an elementwise stand-in of the output's shape, which
reads every input, takes their place (the dry run counts no FLOPs of a
scan, as JAX's HLO count skips a Pallas call).
"""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch

from repro_torch.core.dtensor import contiguous_grad, is_dtensor
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


def exact_placements(mesh, args: list[torch.Tensor],
                     modes: dict[int, tuple[int | None, ...]],
                     divisors: dict[int, tuple[int, ...]]) -> list[list]:
    """Per input, the placements under which the op's local computation is
    exact.  ``modes`` maps a tensor dim ``d`` of the first input to the
    placement each input must have when the first input is ``Shard(d)``
    (``None``: replicated); ``divisors[d]`` are sizes the product of the
    mesh dims sharding ``d`` must divide (whole GQA groups).  A mesh dim
    of size 1 keeps every input's placement but a partial sum's; any
    other mesh dim keeps the first input's ``Shard(d)`` for ``d`` in
    ``modes``, and is ``Replicate`` for all inputs otherwise."""
    from torch.distributed.tensor import Replicate, Shard
    lead = args[0].placements
    out = [[Replicate()] * mesh.ndim for _ in args]
    by_dim: dict[int, int] = {}
    for i, p in enumerate(lead):
        if mesh.size(i) == 1:
            for a, x in enumerate(args):
                q = x.placements[i]
                out[a][i] = Replicate() if q.is_partial() else q
        elif type(p) is Shard and p.dim in modes:
            by_dim[p.dim] = by_dim.get(p.dim, 1) * mesh.size(i)
            for a, d in enumerate(modes[p.dim]):
                out[a][i] = Replicate() if d is None else Shard(d)
    for d, n in by_dim.items():
        if any(k % n for k in divisors.get(d, ())):
            for i, p in enumerate(lead):
                if mesh.size(i) > 1 and p == Shard(d):
                    for a in range(len(args)):
                        out[a][i] = Replicate()
    return out


def _local_route(fn, args: tuple, modes, divisors=None,
                 meta_fn=None) -> torch.Tensor:
    """``fn`` (the op on plain tensors) on the local shards of ``args``,
    redistributed to ``exact_placements``; the output DTensor goes back to
    the first input's placements (a partial sum's settled).  The local
    gradients leave contiguous (``core.dtensor.contiguous_grad``).  On meta
    shards ``meta_fn`` stands in, if given, else ``fn``'s plain version."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = tuple(a if is_dtensor(a) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args)
    lead = args[0].placements
    want = exact_placements(mesh, list(args), modes, divisors or {})
    args = tuple(a if list(a.placements) == w else a.redistribute(
        placements=w) for a, w in zip(args, want))

    def local(*xs):
        xs = tuple(contiguous_grad(x) for x in xs)
        if xs[0].device.type == "meta":    # the dry run's shards: shapes
            if meta_fn is not None:
                return meta_fn(*xs)
            with plain():
                return fn(*xs)
        return fn(*xs)
    out = local_map(local, out_placements=want[0],
                    in_placements=tuple(want))(*args)
    back = [Replicate() if p.is_partial() else p for p in lead]
    return out if list(out.placements) == back else \
        out.redistribute(placements=back)


def fused_conv(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               shift: torch.Tensor, *, stride: int = 1, padding: int = 1,
               relu: bool = True,
               residual: torch.Tensor | None = None) -> torch.Tensor:
    """[relu](conv(x, w, stride, padding)·scale + shift [+ residual]),
    NHWC/HWIO, accumulated in f32 and returned in ``x.dtype``, for any mix
    of f32, bf16 and f16 operands (``fused_conv.route`` picks the kernel's
    route on the card)."""
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
    if is_dtensor(q) or is_dtensor(k) or is_dtensor(v):
        return _local_route(
            lambda q_, k_, v_: flash_attention(
                q_, k_, v_, causal=causal, window=window, softcap=softcap),
            (q, k, v), {0: (0, 0, 0), 2: (2, 2, 2)}, {2: (H, KV)})
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


def _f32(t: torch.Tensor) -> torch.Tensor:
    """bf16 and f16 as an f32 copy (exact), any other tensor as it is."""
    return t.float() if t.dtype in (torch.bfloat16, torch.float16) else t


def mamba_scan(dtx: torch.Tensor, a_log: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence ``S_t = e^{a_t}·S_{t-1} + dtx_t ⊗ B_t``,
    ``y_t = S_t·C_t``: dtx (b, S, H, P), a_log (b, S, H), B/C (b, S, N)
    shared by all heads → y (b, S, H, P) in ``dtx.dtype``, computed in f32
    (bf16 and f16 operands as f32 copies)."""
    if any(is_dtensor(t) for t in (dtx, a_log, B, C)):
        return _local_route(
            mamba_scan, (dtx, a_log, B, C),
            {0: (0, 0, 0, 0), 2: (2, 2, None, None)},
            meta_fn=lambda x, a, b, c: x * a[..., None]
            * (b * c).sum(-1)[..., None, None])
    args = tuple(_f32(t).contiguous() for t in (dtx, a_log, B, C))
    if _use_plain(dtx):
        y = mamba_scan_ref(*args)
    elif _needs_grad(*args):
        y = MambaScan.apply(*args)
    else:
        y = mamba_scan_kernel(*args)
    return y.to(dtx.dtype)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """The stabilised mLSTM recurrence: q, k, v (b, S, H, P), i_pre and
    f_pre (b, S, H) → h (b, S, H, P) in ``q.dtype``, computed in f32 (bf16
    and f16 operands as f32 copies; ``ref.mlstm_ref`` gives the
    formulas)."""
    if any(is_dtensor(t) for t in (q, k, v, i_pre, f_pre)):
        return _local_route(
            mlstm_scan, (q, k, v, i_pre, f_pre), {0: (0,) * 5, 2: (2,) * 5},
            meta_fn=lambda q_, k_, v_, i, f: q_ * k_ * v_
            * (i * f)[..., None])
    args = tuple(_f32(t).contiguous() for t in (q, k, v, i_pre, f_pre))
    if _use_plain(q):
        h = mlstm_ref(*args)
    elif _needs_grad(*args):
        h = MLSTMScan.apply(*args)
    else:
        h = mlstm_scan_kernel(*args)
    return h.to(q.dtype)
