"""Wrapper of the hand-written Hopper fused CONV + BN + [ADD] + [RELU]
kernel (``csrc/fused_conv_sm90.cu``: three bf16 products per f32 product on
the tensor cores through wgmma, split K over a thread block cluster), the
port of the Pallas ``repro.kernels.fused_conv.fused_conv_kernel``.

It takes CUDA tensors only and raises on anything the kernel does not take;
``kernels.ops.fused_conv`` sends CPU tensors to the plain version.
``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel.  ``plan`` picks the tile width and the split of K
per shape.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _build

launches = 0

_INDEX_LIMIT = 2**31   # the kernel indexes with 32-bit ints

SMS = 132              # streaming multiprocessors of an H100 SXM
TILE_M = 128           # output pixels per block
K_BLOCK = 32           # reduction depth the kernel stages at a time
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
def plan(m: int, n: int, k: int,
         resident: tuple[int, ...] = ALL_SMS) -> tuple[int, int]:
    """(tile width, split of K) for an (m x k)·(k x n) implicit GEMM: the
    pair whose waves of blocks take the least modelled time, where
    ``resident[s - 1]`` blocks in clusters of s fit on the card at once;
    ties go to the narrower tile and the smaller split.  Stages 3 and 4 of
    ResNet18 at batch 8 give 16-26 tiles, which a split of K spreads over
    the card."""
    nk = math.ceil(k / K_BLOCK)
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
def resident_blocks(device: int) -> tuple[int, ...]:
    """Per split s = 1..MAX_SPLITS, how many of the kernel's blocks in
    clusters of s CUDA device ``device`` holds at once: a cluster must fit
    within one group of SMs, so an H100 holds fewer than one per SM."""
    lib = _build.library()
    with torch.cuda.device(device):
        blocks = tuple(lib.fused_conv_sm90_resident_blocks(s)
                       for s in range(1, MAX_SPLITS + 1))
    if min(blocks) < 1:
        raise RuntimeError(f"fused_conv: the card holds no cluster of the "
                           f"kernel's blocks: {blocks}")
    return blocks


def out_hw(h: int, w: int, kh: int, kw: int, stride: int,
           padding: int) -> tuple[int, int]:
    return (h + 2 * padding - kh) // stride + 1, \
        (w + 2 * padding - kw) // stride + 1


def _check(name: str, t: torch.Tensor, device: torch.device,
           shape: tuple[int, ...]) -> None:
    if t.device != device:
        raise ValueError(f"fused_conv: {name} is on {t.device}, x on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"fused_conv: the kernel takes float32 only, {name} "
                        f"is {t.dtype}")
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
    (Cout,); residual: (B, OH, OW, Cout).  Returns (B, OH, OW, Cout) with
    OH = (H + 2p - kh)//s + 1, all float32 on one CUDA device."""
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
    y = torch.empty((B, OH, OW, Cout), device=x.device, dtype=x.dtype)

    device = x.device.index
    bn, splits = plan(B * OH * OW, Cout, kh * kw * Cin,
                      resident_blocks(device))

    lib = _build.library()
    err = lib.fused_conv_sm90_f32(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
        None if residual is None else residual.data_ptr(), y.data_ptr(),
        B, H, W, Cin, kh, kw, Cout, OH, OW, stride, padding, int(relu), bn,
        splits, device, _current_stream(device))
    if err:
        raise RuntimeError(f"fused_conv kernel launch failed: "
                           f"{lib.fused_conv_sm90_error_string(err).decode()}")
    launches += 1
    return y
