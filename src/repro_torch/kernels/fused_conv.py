"""Wrapper of the hand-written Hopper fused CONV + BN + [ADD] + [RELU]
kernel (``csrc/fused_conv_sm90.cu``), the port of the Pallas
``repro.kernels.fused_conv.fused_conv_kernel``, in two routes:

* ``bf16``: x, w and any residual in bf16, one bf16 product per k-step on
  the tensor cores through wgmma, bf16 out;
* ``f32``: any other mix of float dtypes, on exact f32 copies of the
  operands that are not f32 (as the Pallas kernel reads every operand as
  f32), three bf16 products per f32 product, f32 out.

Both read scale and shift as f32, split K over a thread block cluster and
return ``x.dtype`` (the f32 route's result rounded once where x is not
f32), as the Pallas kernel does.  The bf16 route copies 8 channels of a
patch row at a time: a call whose Cin is not a multiple of 8 (the stem's
3) goes in with x and w padded with zero channels (``padded_cin``), a copy
of x.

It takes CUDA tensors only and raises on anything the kernels do not take;
``kernels.ops.fused_conv`` sends CPU tensors to the plain version.
``launches`` counts the kernels' launches and ``launches_by_route`` each
route's, so a run can show that its path went through the kernel it
expects.  ``plan`` picks the tile width and the split of K per shape and
route.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

launches = 0
launches_by_route = {"f32": 0, "bf16": 0}

_INDEX_LIMIT = 2**31   # the kernel indexes with 32-bit ints
# the float dtypes of the Pallas kernel's callers (JAX without x64)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

SMS = 132              # streaming multiprocessors of an H100 SXM
TILE_M = 128           # output pixels per block
# reduction depth each route stages at a time: a 128-byte bf16 row
K_BLOCKS = {"f32": 32, "bf16": 64}
K_BLOCK = K_BLOCKS["f32"]
MAX_SPLITS = 8         # the portable thread block cluster
TILE_N = (64, 128)     # the tile widths the kernel is built for
# A model of a block's time in k-blocks of the 128-wide tile: a 64-wide
# k-block does half the products on the same patches; every block pays for
# its set-up, the pipeline's fill and the epilogue, and a split block for
# the cluster's sum of the partial tiles.
_KBLOCK_COST = {64: 0.6, 128: 1.0}
_BLOCK_COST = 2.0
_SPLIT_COST = 1.0
# The kernel holds one block per SM; a card whose SMs take any cluster.
ALL_SMS = (SMS,) * MAX_SPLITS


@functools.cache
def plan(m: int, n: int, k: int, resident: tuple[int, ...] = ALL_SMS,
         k_block: int = K_BLOCK) -> tuple[int, int]:
    """(tile width, split of K) for an (m x k)·(k x n) implicit GEMM staged
    in k-blocks of ``k_block`` (the route's, ``K_BLOCKS``): the pair whose
    waves of blocks take the least modelled time, where ``resident[s -
    1]`` blocks in clusters of s fit on the card at once; ties go to the
    narrower tile and the smaller split.  Stages 3 and 4 of ResNet18 at
    batch 8 give 16-26 tiles, which a split of K spreads over the card.  A
    k-block costs the same on both routes: the bf16 one stages as many
    bytes (twice the depth at half the width) for two thirds of the f32
    route's products."""
    nk = math.ceil(k / k_block)
    best = None
    for bn in TILE_N:
        if bn > TILE_N[0] and n <= TILE_N[0]:
            continue
        tiles = math.ceil(m / TILE_M) * math.ceil(n / bn)
        for splits in range(1, min(MAX_SPLITS, nk) + 1):
            waves = math.ceil(tiles * splits / resident[splits - 1])
            cost = waves * (math.ceil(nk / splits) * _KBLOCK_COST[bn]
                            + _BLOCK_COST + _SPLIT_COST * (splits > 1))
            if best is None or cost < best[0]:
                best = (cost, bn, splits)
    return best[1], best[2]


def _current_stream(device: int) -> int:
    """The raw handle of PyTorch's current stream on ``device``: the same
    stream as ``torch.cuda.current_stream(device).cuda_stream``, without
    building a Stream object on every launch (host time that the small
    late-stage convs, a few microseconds on the card, cannot hide)."""
    return torch._C._cuda_getCurrentRawStream(device)


@functools.cache
def resident_blocks(device: int, kind: str = "f32") -> tuple[int, ...]:
    """Per split s = 1..MAX_SPLITS, how many of the ``kind`` route's
    blocks in clusters of s CUDA device ``device`` holds at once: a cluster
    must fit within one group of SMs, so an H100 holds fewer than one per
    SM."""
    lib = _build.library()
    with torch.cuda.device(device):
        blocks = tuple(lib.fused_conv_sm90_resident_blocks(
            s, int(kind == "bf16")) for s in range(1, MAX_SPLITS + 1))
    if min(blocks) < 1:
        raise RuntimeError(f"fused_conv: the card holds no cluster of the "
                           f"kernel's blocks: {blocks}")
    return blocks


def out_hw(h: int, w: int, kh: int, kw: int, stride: int,
           padding: int) -> tuple[int, int]:
    return (h + 2 * padding - kh) // stride + 1, \
        (w + 2 * padding - kw) // stride + 1


def padded_cin(cin: int) -> int:
    """The input channels the bf16 route's kernel runs a call with: Cin
    padded with zeros to a multiple of 8, a 16-byte copy of a patch row.
    Exact, and for the stem (Cin = 3) 1.5x faster on an H100 than
    gathering its 6-byte pixels element by element, copy included."""
    return cin + -cin % 8


def route(x: torch.Tensor, w: torch.Tensor,
          residual: torch.Tensor | None = None) -> str:
    """The kernel route of a call: ``bf16`` when x, w and the residual are
    all bf16, else ``f32``."""
    ts = (x, w) if residual is None else (x, w, residual)
    return "bf16" if all(t.dtype == torch.bfloat16 for t in ts) else "f32"


def _check(name: str, t: torch.Tensor, device: torch.device,
           shape: tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"fused_conv: {name} is on {t.device}, x on {device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"fused_conv: the kernels take float32, bfloat16 and "
                        f"float16 (as f32 copies), {name} is {t.dtype}")
    if t.shape != shape:
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
    (Cout,); residual: (B, OH, OW, Cout), each f32, bf16 or f16, all on
    one CUDA device.  Returns (B, OH, OW, Cout) in ``x.dtype`` with OH =
    (H + 2p - kh)//s + 1, through the bf16 route when x, w and the
    residual are bf16 (Cin padded to ``padded_cin``), else the f32 route
    (``route``).  A failed launch raises; no call falls back to the other
    route or to the plain version."""
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
    kind = route(x, w, residual)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    # the operands the route reads, copied only where the dtype differs (a
    # dtype check costs less host time than a no-op .to())
    xk, wk, rk, scale, shift = (
        t if t is None or t.dtype == want else t.to(want)
        for t, want in ((x, dtype), (w, dtype), (residual, dtype),
                        (scale, torch.float32), (shift, torch.float32)))
    if kind == "bf16" and (Cin % 8 or xk.data_ptr() % 16):
        pad = padded_cin(Cin) - Cin
        xk = F.pad(xk, (0, pad)) if pad else xk.clone()   # aligned
        wk = F.pad(wk, (0, 0, 0, pad)) if pad else wk
        Cin += pad
    y = torch.empty((B, OH, OW, Cout), device=x.device, dtype=dtype)

    device = x.device.index
    bn, splits = plan(B * OH * OW, Cout, kh * kw * Cin,
                      resident_blocks(device, kind), K_BLOCKS[kind])

    lib = _build.library()
    err = getattr(lib, f"fused_conv_sm90_{kind}")(
        xk.data_ptr(), wk.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        None if rk is None else rk.data_ptr(), y.data_ptr(),
        B, H, W, Cin, kh, kw, Cout, OH, OW, stride, padding, int(relu), bn,
        splits, device, _current_stream(device))
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed ({kind} route): "
                           f"{lib.fused_conv_sm90_error_string(err).decode()}")
    launches += 1
    launches_by_route[kind] += 1
    return y if y.dtype == x.dtype else y.to(x.dtype)
