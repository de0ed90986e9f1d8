"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test asks its fixture whether a card is present and
skips if not, so every process collects the same tests.  On a machine with
an NVIDIA H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import fused_conv as fc
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import mlstm_scan as ML
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import (attention_ref, attention_ref_grad,
                                     fused_conv_ref, mamba_scan_ref,
                                     mlstm_ref)
from repro_torch.models import build_model

pytestmark = pytest.mark.cuda

RTOL = 1e-4   # max|kernel − plain| ≤ RTOL · max|plain|: f32 sums reordered


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, hw, cin, cout, k, s, p, residual):
    g = torch.Generator(device=dev).manual_seed(hw * 1000 + cin + k)
    x = torch.randn(B, hw, hw, cin, generator=g, device=dev)
    w = torch.randn(k, k, cin, cout, generator=g, device=dev) * 0.2
    scale = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
    shift = 0.1 * torch.randn(cout, generator=g, device=dev)
    oh = fc.out_hw(hw, hw, k, k, s, p)[0]
    res = (torch.randn(B, oh, oh, cout, generator=g, device=dev)
           if residual else None)
    return x, w, scale, shift, res


@pytest.mark.parametrize("B,hw,cin,cout,k,s,p,relu,residual", [
    (2, 32, 3, 64, 7, 2, 3, True, False),       # stem: Cin=3, K=147
    (2, 14, 64, 64, 3, 1, 1, True, True),       # ADD_RELU epilogue
    (2, 14, 64, 128, 3, 2, 1, True, False),     # 3x3/s2
    (2, 14, 64, 128, 1, 2, 0, False, False),    # 1x1/s2 downsample
    (1, 7, 96, 40, 3, 1, 1, True, True),        # 7x7 map, ragged Cout
    (3, 9, 5, 70, 3, 2, 1, False, True),        # ragged everything
    (8, 7, 512, 512, 3, 1, 1, True, True),      # stage 4, K split over 8
    (8, 14, 256, 512, 3, 2, 1, True, False),    # stage 4's 3x3/s2, split 8
    (8, 14, 256, 256, 3, 1, 1, True, True),     # stage 3, split over 5
    (2, 14, 256, 40, 3, 1, 1, True, False),     # Cout 40, split K
    (2, 15, 64, 64, 3, 1, 1, False, True),      # M = 450, no whole tile
    (1, 56, 64, 64, 3, 1, 1, True, False),      # batch 1
    (1, 224, 3, 64, 7, 2, 3, True, False),      # the stem at full size
    (1, 224, 3, 64, 7, 2, 3, False, True),      # the stem with a residual
])
def test_kernel_matches_plain(cuda, B, hw, cin, cout, k, s, p, relu,
                              residual):
    x, w, scale, shift, res = _inputs(cuda, B, hw, cin, cout, k, s, p,
                                      residual)
    kw = dict(stride=s, padding=p, relu=relu, residual=res)
    before = fc.launches
    out = ops.fused_conv(x, w, scale, shift, **kw)
    torch.cuda.synchronize()
    assert fc.launches == before + 1
    ref = fused_conv_ref(x, w, scale, shift, **kw)
    assert out.shape == ref.shape and out.is_cuda
    err = (out - ref).abs().max().item()
    assert err <= RTOL * ref.abs().max().item(), err


@pytest.mark.parametrize("B,hw,cin,cout,k,s,p", [
    (8, 7, 512, 512, 3, 1, 1),      # split K: the cluster's sum
    (2, 14, 64, 64, 3, 1, 1),       # one block per tile
])
def test_kernel_is_deterministic(cuda, B, hw, cin, cout, k, s, p):
    """Two launches on the same inputs give the same bits: the split of K
    is summed in a fixed order, with no atomics."""
    x, w, scale, shift, res = _inputs(cuda, B, hw, cin, cout, k, s, p, True)
    kw = dict(stride=s, padding=p, residual=res)
    one = fc.fused_conv_kernel(x, w, scale, shift, **kw)
    two = fc.fused_conv_kernel(x, w, scale, shift, **kw)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


def test_kernel_refuses_what_it_cannot_take(cuda):
    x, w, scale, shift, _ = _inputs(cuda, 1, 8, 4, 8, 3, 1, 1, False)
    with pytest.raises(TypeError, match="float32"):
        ops.fused_conv(x.double(), w.double(), scale.double(), shift.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_conv(x.transpose(1, 2), w, scale, shift)
    with pytest.raises(ValueError, match="shape"):
        ops.fused_conv(x, w, scale[:4], shift)
    with pytest.raises(ValueError, match="on cpu"):
        ops.fused_conv(x, w.cpu(), scale, shift)


# The bf16 route (x, w and the residual bf16) against the plain version on
# the same operands, per element: one bf16 ulp, where the two f32 sums
# round on the two sides of a tie, plus RTOL of the conv's size.
BF16_ULP = 2.0**-7

CONV_SHAPES = [
    (2, 32, 3, 64, 7, 2, 3, True, False),       # stem: Cin=3, K=147
    (2, 14, 64, 64, 3, 1, 1, True, True),       # ADD_RELU epilogue
    (2, 14, 64, 128, 3, 2, 1, True, False),     # 3x3/s2
    (2, 14, 64, 128, 1, 2, 0, False, False),    # 1x1/s2 downsample
    (1, 7, 96, 40, 3, 1, 1, True, True),        # 7x7 map, ragged Cout
    (3, 9, 5, 70, 3, 2, 1, False, True),        # ragged everything
    (8, 7, 512, 512, 3, 1, 1, True, True),      # stage 4, K split
    (8, 14, 256, 512, 3, 2, 1, True, False),    # stage 4's 3x3/s2, split
    (8, 14, 256, 256, 3, 1, 1, True, True),     # stage 3, split
    (2, 14, 256, 40, 3, 1, 1, True, False),     # Cout 40, split K
    (2, 15, 64, 64, 3, 1, 1, False, True),      # M = 450, no whole tile
    (1, 224, 3, 64, 7, 2, 3, False, True),      # the stem with a residual
]


def _bf16(t):
    return None if t is None else t.bfloat16()


def _within_bf16(out, ref):
    err = (out.float() - ref.float()).abs()
    limit = BF16_ULP * ref.float().abs() + RTOL * ref.float().abs().max()
    return bool((err <= limit).all()), err.max().item()


@pytest.mark.parametrize("B,hw,cin,cout,k,s,p,relu,residual", CONV_SHAPES)
def test_bf16_kernel_matches_plain(cuda, B, hw, cin, cout, k, s, p, relu,
                                   residual):
    x, w, scale, shift, res = _inputs(cuda, B, hw, cin, cout, k, s, p,
                                      residual)
    x, w, res = _bf16(x), _bf16(w), _bf16(res)
    kw = dict(stride=s, padding=p, relu=relu, residual=res)
    before = dict(fc.launches_by_route)
    out = ops.fused_conv(x, w, scale, shift, **kw)
    again = ops.fused_conv(x, w, scale, shift, **kw)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fc.launches_by_route.items()} == \
        {"f32": 0, "bf16": 2}
    ref = fused_conv_ref(x, w, scale, shift, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    ok, err = _within_bf16(out, ref)
    assert ok, err
    assert torch.equal(out, again)


def test_bf16_kernel_takes_an_unaligned_x(cuda):
    """The bf16 route copies 16 bytes of a patch row at a time: an x whose
    base is not 16-byte aligned (a contiguous view into a larger buffer)
    goes in as an aligned copy, with the same result."""
    x, w, scale, shift, _ = _inputs(cuda, 2, 14, 64, 64, 3, 1, 1, False)
    x, w = x.bfloat16(), w.bfloat16()
    buf = torch.empty(x.numel() + 1, device=cuda, dtype=torch.bfloat16)
    shifted = buf[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    out = ops.fused_conv(shifted, w, scale, shift)
    torch.cuda.synchronize()
    assert torch.equal(out, ops.fused_conv(x, w, scale, shift))


@pytest.mark.parametrize("xd,wd,rd", [
    (torch.bfloat16, torch.float32, None),
    (torch.float32, torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16, torch.float32),
    (torch.float16, torch.float16, torch.float16),
])
def test_mixed_dtypes_take_the_f32_route(cuda, xd, wd, rd):
    """Any operand not bf16 sends the call to the f32 route, on f32 copies,
    as the Pallas kernel reads every operand as f32; the output is
    x.dtype, the f32 result rounded once."""
    x, w, scale, shift, res = _inputs(cuda, 2, 14, 64, 64, 3, 1, 1, True)
    x, w = x.to(xd), w.to(wd)
    res = res.to(rd) if rd is not None else None
    before = dict(fc.launches_by_route)
    out = ops.fused_conv(x, w, scale.to(xd), shift.to(xd), residual=res)
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fc.launches_by_route.items()} == \
        {"f32": 1, "bf16": 0}
    ref = fused_conv_ref(x, w, scale.to(xd), shift.to(xd), residual=res)
    assert out.dtype == xd == ref.dtype
    ok, err = _within_bf16(out, ref)
    assert ok, err


def test_bf16_resnet18_runs_on_the_bf16_route(cuda):
    """A bf16 ResNet18 (the config with both dtypes bf16, as in JAX) at
    small size: 20 launches a forward, all on the bf16 route, bf16 logits
    close to the same forward under ops.plain()."""
    import dataclasses as dc
    cfg = dc.replace(get_config("resnet18"), dtype="bfloat16",
                     param_dtype="bfloat16")
    model = build_model(cfg, device=cuda)
    net = model.init(0)
    x = torch.randn(2, 64, 64, 3, device=cuda).bfloat16()
    before = dict(fc.launches_by_route)
    out, _ = model.forward(net, {"images": x})
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in fc.launches_by_route.items()} == \
        {"f32": 0, "bf16": 20}
    with ops.plain():
        ref, _ = model.forward(net, {"images": x})
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    rel = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert rel <= 0.02, rel.item()


@pytest.mark.parametrize("op", ["mamba_scan", "mlstm_scan"])
def test_scans_take_bf16_and_return_it(cuda, op):
    """JAX's ops take bf16 and return the first operand's dtype, computed
    in f32; so do the port's, through the f32 kernels, under autograd
    too."""
    g = torch.Generator(device=cuda).manual_seed(11)

    def randn(*size, scale=1.0, shift=0.0):
        return torch.randn(size, generator=g, device=cuda) * scale + shift
    if op == "mamba_scan":
        args = [randn(2, 64, 4, 16, scale=0.3).bfloat16(),
                -torch.nn.functional.softplus(randn(2, 64, 4)),
                randn(2, 64, 8, scale=0.3).bfloat16(),
                randn(2, 64, 8, scale=0.3).bfloat16()]
        mod, plain = MS, mamba_scan_ref
    else:
        args = [*(randn(2, 64, 2, 32, scale=0.4).bfloat16()
                  for _ in range(3)), randn(2, 64, 2), randn(2, 64, 2,
                                                             shift=2.0)]
        mod, plain = ML, mlstm_ref
    before = mod.launches
    out = getattr(ops, op)(*args)
    torch.cuda.synchronize()
    assert mod.launches == before + 1 and out.dtype == torch.bfloat16
    ref = plain(*(a.float() for a in args))
    err = (out.float() - ref).abs()
    assert (err <= BF16_ULP * ref.abs() + 1e-4).all(), err.max().item()
    xs = [a.detach().requires_grad_(True) for a in args]
    y = getattr(ops, op)(*xs)
    assert y.dtype == torch.bfloat16
    grads = torch.autograd.grad(y, xs, torch.ones_like(y))
    assert all(gr.dtype == a.dtype for gr, a in zip(grads, xs))
    assert all(torch.isfinite(gr.float()).all() for gr in grads)


# --- flash attention -------------------------------------------------------------

# Per element against the plain version in f32, as chip_smoke.py holds the
# kernel: reordered f32 sums (the f32 limit of test_kernels.py) and, for
# bf16, half an ulp of the output's one rounding.
FLASH_RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0**-8}
FLASH_ATOL = 2e-5


def _qkv(dev, BH, BKV, S, T, D, dtype):
    g = torch.Generator(device=dev).manual_seed(S * 7 + T + D)
    return tuple(torch.randn(n, L, D, generator=g, device=dev).to(dtype)
                 for n, L in ((BH, S), (BKV, T), (BKV, T)))


def _route(dtype) -> str:
    """The kernel that serves a dtype: tensor cores for bf16, CUDA cores
    for f32."""
    return "wgmma_bf16" if dtype == torch.bfloat16 else "simt_f32"


def _held_against_plain(q, k, v, **kw):
    """One kernel launch, on the route of q's dtype and no other, held
    against the plain version in f32."""
    before, by_route = FA.launches, dict(FA.launches_by_kernel)
    out = FA.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert {r: n - by_route[r] for r, n in FA.launches_by_kernel.items()} == \
        {r: int(r == _route(q.dtype)) for r in by_route}
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert out.dtype == q.dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref, atol=FLASH_ATOL,
                               rtol=FLASH_RTOL[q.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,BKV,S,T,D,causal,window,softcap", [
    (8, 4, 200, 200, 256, True, 0, 50.0),     # gemma2 heads, ragged S
    (8, 4, 333, 333, 256, True, 100, 50.0),   # ragged, windowed
    (4, 1, 64, 150, 64, True, 0, 0.0),        # GQA 4:1, S != T, top-left
    (6, 3, 100, 77, 32, False, 0, 30.0),      # non-causal, ragged T
    (4, 2, 96, 96, 16, True, 8, 50.0),        # smoke head dim and window
    (4, 2, 52, 37, 16, True, 16, 50.0),       # last row sees one key
    (4, 2, 52, 37, 16, False, 16, 0.0),       # the same, non-causal
    (8, 8, 200, 200, 80, True, 0, 0.0),       # zamba2 heads, ragged S
    (6, 3, 100, 77, 80, False, 0, 30.0),      # D = 80, GQA, ragged T
    (8, 8, 200, 200, 96, True, 0, 0.0),       # phi3 heads, ragged S
    (6, 3, 100, 77, 96, False, 0, 30.0),      # D = 96, GQA, ragged T
    (8, 1, 130, 130, 128, True, 0, 0.0),      # qwen3's GQA 8:1 at D = 128
])
def test_flash_kernel_matches_plain(cuda, dtype, BH, BKV, S, T, D, causal,
                                    window, softcap):
    _held_against_plain(*_qkv(cuda, BH, BKV, S, T, D, dtype), causal=causal,
                        window=window, softcap=softcap)


# The tensor-core kernel's edges: its query tile is 128 rows, its key tile
# 64 keys at D = 128 and 256 and 128 keys at the other head dims.
@pytest.mark.parametrize("BH,BKV,S,T,D,causal,window,softcap", [
    (4, 2, 129, 191, 16, True, 0, 50.0),      # S, T multiples of no tile
    (4, 2, 129, 191, 32, False, 0, 0.0),
    (4, 2, 191, 129, 64, True, 0, 30.0),
    (4, 2, 129, 191, 80, True, 0, 0.0),
    (4, 2, 191, 129, 96, True, 0, 0.0),
    (4, 2, 129, 191, 96, False, 0, 50.0),
    (4, 2, 191, 129, 128, False, 0, 50.0),
    (4, 2, 129, 191, 256, True, 0, 50.0),
    (8, 8, 1, 1, 80, True, 0, 0.0),           # S = T = 1
    (8, 1, 1, 300, 256, False, 0, 50.0),      # one query, group 8
    (8, 1, 300, 300, 64, True, 0, 0.0),       # group 8
    (16, 2, 300, 300, 256, True, 0, 50.0),    # group 8 at gemma2's D
    (8, 4, 512, 512, 256, True, 128, 50.0),   # window ends on a key tile
    (8, 4, 512, 512, 80, True, 256, 0.0),     # the same at 128-key tiles
    (8, 4, 512, 512, 96, True, 256, 0.0),     # and at D = 96's
    (8, 4, 640, 640, 128, True, 192, 0.0),    # and on a query tile
    (4, 4, 300, 300, 80, True, 400, 0.0),     # window >= T
    (4, 2, 300, 300, 256, False, 512, 50.0),  # window >= T, non-causal
])
def test_flash_bf16_kernel_edges_match_plain(cuda, BH, BKV, S, T, D, causal,
                                             window, softcap):
    _held_against_plain(*_qkv(cuda, BH, BKV, S, T, D, torch.bfloat16),
                        causal=causal, window=window, softcap=softcap)


# whisper-large-v3's heads (20 of 64, 4 clips): the encoder's
# bidirectional attention over 1500 frames (11 key tiles and a ragged 92),
# the decoder's cross-attention of 448 tokens to them, and its causal
# self-attention over 448.
@pytest.mark.parametrize("S,T,causal,dtype", [
    (1500, 1500, False, torch.bfloat16),
    (448, 1500, False, torch.bfloat16),
    (448, 448, True, torch.bfloat16),
    (1500, 1500, False, torch.float32),
    (448, 1500, False, torch.float32),
])
def test_flash_whisper_shapes_match_plain(cuda, S, T, causal, dtype):
    _held_against_plain(*_qkv(cuda, 80, 80, S, T, 64, dtype), causal=causal,
                        window=0, softcap=0.0)


# The CUDA-core kernel at every head dim it is built for, with its
# statistics, as chip_smoke.py's phase 7 holds it: a ragged causal GQA
# shape past two query tiles, a windowed softcapped one, and a non-causal
# cross one.
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
@pytest.mark.parametrize("BH,BKV,S,T,causal,window,softcap", [
    (6, 2, 300, 257, True, 0, 0.0),
    (4, 2, 333, 333, True, 100, 50.0),
    (6, 3, 130, 300, False, 0, 30.0),
])
def test_flash_f32_kernel_with_statistics_matches_plain(
        cuda, D, BH, BKV, S, T, causal, window, softcap):
    """Per element against the plain version; two launches with statistics
    give the same output and log-sum-exp bits, the output the same bits as
    a launch without; the log-sum-exp within FLASH_ATOL of the plain
    version's."""
    q, k, v = _qkv(cuda, BH, BKV, S, T, D, torch.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _held_against_plain(q, k, v, **kw)
    (out, lse, lo), (out2, lse2, _) = (
        FA.flash_attention_kernel(q, k, v, **kw, stats=True)
        for _ in range(2))
    torch.cuda.synchronize()
    assert lo is None
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(out, FA.flash_attention_kernel(q, k, v, **kw))
    _, ref_lse, _ = attention_ref(q, k, v, **kw, stats=True)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=FLASH_ATOL)


def test_flash_f32_refuses_an_unaligned_base(cuda):
    """The f32 kernel copies rows 16 bytes at a time; the wrapper raises
    rather than launch on a base those copies cannot take."""
    q, k, v = _qkv(cuda, 4, 2, 8, 8, 32, torch.float32)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    shifted = shifted.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_kernel(shifted, k, v)


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(cuda, 4, 2, 8, 8, 32, torch.float32)
    with pytest.raises(TypeError):
        FA.flash_attention_kernel(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        FA.flash_attention_kernel(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_kernel(q.transpose(0, 1), k, v)
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention_kernel(q[:3].contiguous(), k, v)
    with pytest.raises(ValueError, match="no visible key"):
        FA.flash_attention_kernel(*_qkv(cuda, 4, 2, 53, 37, 32,
                                        torch.float32), window=16)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_kernel(q[..., :24].contiguous(),
                                  k[..., :24].contiguous(),
                                  v[..., :24].contiguous())


def test_flash_bf16_refuses_a_base_tma_cannot_take(cuda):
    """TMA reads from 16-byte aligned bases only; the wrapper raises rather
    than launch on another."""
    q, k, v = _qkv(cuda, 4, 2, 8, 8, 32, torch.bfloat16)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    shifted = shifted.view(q.shape).copy_(q)
    with pytest.raises(ValueError, match="aligned"):
        FA.flash_attention_kernel(shifted, k, v)


@pytest.mark.parametrize("name", ["gemma2-2b-smoke", "gemma2-2b",
                                  "deepseek-moe-16b-smoke", "phi3-mini-3.8b"])
def test_forward_launches_once_per_layer_and_plain_none(cuda, name):
    """One flash launch per layer (deepseek's dense first layer included)
    in each forward; none under ``ops.plain()``, whose logits agree with
    the kernel path's."""
    cfg = get_config(name)
    if not name.endswith("-smoke"):   # full width, cut to 2 layers
        cfg = dataclasses.replace(cfg, num_layers=2)
    model = build_model(cfg)
    net = model.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                                     device=cuda)}
    route = _route(getattr(torch, cfg.dtype))   # bf16 at full width
    for _ in range(2):
        before, on_route = FA.launches, FA.launches_by_kernel[route]
        logits, _ = model.forward(net, batch)
        torch.cuda.synchronize()
        assert FA.launches == before + cfg.num_layers
        assert FA.launches_by_kernel[route] == on_route + cfg.num_layers
    before = FA.launches
    with ops.plain():
        plain, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    assert FA.launches == before
    atol = 1e-4 if cfg.dtype == "float32" else 0.25
    assert (logits - plain).abs().max().item() <= atol


def test_whisper_smoke_forward_matches_cpu_plain(cuda):
    """whisper-large-v3-smoke on the card, with the same weights as on the
    CPU (drawn from one seed): one flash launch per encoder layer and two
    per decoder layer (self and cross) in the forward, one per encoder
    layer in ``fill_cross_cache``, none in a decode step; the forward's
    logits and the decode step's against the CPU's plain path."""
    cfg = get_config("whisper-large-v3-smoke")
    model, cpu = build_model(cfg), build_model(cfg, device="cpu")
    net, cpu_net = model.init(seed=0), cpu.init(seed=0)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model, generator=g)
    batch = {"tokens": toks.to(cuda), "enc_frames": frames.to(cuda)}
    before = (FA.launches, FA.launches_by_kernel["simt_f32"])
    logits, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    per_forward = cfg.encoder_layers + 2 * cfg.num_layers
    assert (FA.launches - before[0], FA.launches_by_kernel["simt_f32"]
            - before[1]) == (per_forward, per_forward)
    ref, _ = cpu.forward(cpu_net, {"tokens": toks, "enc_frames": frames})
    assert (logits.cpu() - ref).abs().max().item() <= 1e-4
    before = FA.launches
    cache = model.fill_cross_cache(net, model.init_cache(2, 24), frames)
    assert FA.launches - before == cfg.encoder_layers
    before = FA.launches
    step, _ = model.decode_step(net, cache, toks[:, :1], 0)
    torch.cuda.synchronize()
    assert FA.launches == before
    cpu_cache = cpu.fill_cross_cache(cpu_net, cpu.init_cache(2, 24), frames)
    ref_step, _ = cpu.decode_step(cpu_net, cpu_cache, toks[:, :1], 0)
    assert (step.cpu() - ref_step).abs().max().item() <= 1e-4


# --- mamba scan ------------------------------------------------------------------

# Per element against the plain version, both in f32 on the card: the JAX
# test's 1e-4.  The chunked kernel sums in another order than the
# step-by-step plain version and takes each product as three bf16 products,
# within a few 2^-16 of each (5e-5 of y at zamba2's heads in the CPU
# emulation of tests/test_torch_mamba_scan.py); the state forgets, so the
# error does not grow with S.
SCAN_ATOL = 1e-4


def _scan_inputs(dev, b, S, H, P, N, a_log=None):
    """dtx·0.3, B and C ·0.3 and a_log = −softplus(N(0, 1)); or a_log the
    constant ``a_log``; or, for ``a_log="long"``, long-memory decays −Δ·A
    (Δ log-uniform in [1e-3, 0.1] per step and head, A = linspace(1, 16)
    over the heads) that carry the state across every chunk."""
    g = torch.Generator(device=dev).manual_seed(b * 1000 + S + H + P + N)

    def randn(*size):
        return torch.randn(size, generator=g, device=dev)
    if a_log is None:
        a = -torch.nn.functional.softplus(randn(b, S, H))
    elif a_log == "long":
        dt = 1e-3 * 100.0 ** torch.rand((b, S, H), generator=g, device=dev)
        a = -dt * torch.linspace(1.0, 16.0, H, device=dev)
    else:
        a = torch.full((b, S, H), a_log, device=dev)
    return randn(b, S, H, P) * 0.3, a, randn(b, S, N) * 0.3, \
        randn(b, S, N) * 0.3


@pytest.mark.parametrize("b,S,H,P,N", [
    (2, 64, 3, 16, 8),        # the grid of tests/test_kernels.py
    (1, 128, 2, 8, 4),
    (4, 64, 80, 64, 64),      # zamba2's heads at the serving prompt
    (1, 1000, 4, 64, 64),     # ragged last chunk
    (2, 37, 5, 33, 17),       # ragged everything
    (1, 1, 1, 1, 1),
    (1, 4096, 80, 64, 64),    # zamba2's prefill
])
@pytest.mark.parametrize("decays", [None, "long"], ids=["fast", "long"])
def test_scan_kernel_matches_plain(cuda, b, S, H, P, N, decays):
    """At fast decays and at long-memory ones, slow enough that the state
    crosses every chunk, so that a state pass that drops or misroutes the
    carried state cannot pass; the shapes take both of the kernel's chunk
    lengths (64 up to S = 256, else 128).  Two launches give the same
    bits."""
    dtx, a_log, Bm, Cm = _scan_inputs(cuda, b, S, H, P, N, a_log=decays)
    before = MS.launches
    out = ops.mamba_scan(dtx, a_log, Bm, Cm)
    again = ops.mamba_scan(dtx, a_log, Bm, Cm)
    torch.cuda.synchronize()
    assert MS.launches == before + 2
    assert torch.equal(out, again)   # no atomics: the same bits
    ref = mamba_scan_ref(dtx, a_log, Bm, Cm)
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=SCAN_ATOL, rtol=0)


def test_scan_kernel_full_reset(cuda):
    """a_log = -30: y_t = (C_t·B_t)·dtx_t, e^{cum} underflowing to 0."""
    dtx, a_log, Bm, Cm = _scan_inputs(cuda, 1, 200, 3, 64, 64, a_log=-30.0)
    out = MS.mamba_scan_kernel(dtx, a_log, Bm, Cm)
    expect = (Cm * Bm).sum(-1)[..., None, None] * dtx
    torch.testing.assert_close(out, expect, atol=SCAN_ATOL, rtol=0)


def test_scan_kernel_refuses_what_it_cannot_take(cuda):
    dtx, a_log, Bm, Cm = _scan_inputs(cuda, 1, 16, 2, 8, 4)
    with pytest.raises(TypeError, match="float32"):
        MS.mamba_scan_kernel(dtx.double(), a_log, Bm, Cm)
    with pytest.raises(ValueError, match="on cpu"):
        MS.mamba_scan_kernel(dtx, a_log, Bm.cpu(), Cm)
    with pytest.raises(ValueError, match="4-d"):
        MS.mamba_scan_kernel(dtx[0], a_log, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        MS.mamba_scan_kernel(dtx, a_log, Bm.transpose(1, 2).contiguous()
                             .transpose(1, 2), Cm)
    with pytest.raises(ValueError, match="shape"):
        MS.mamba_scan_kernel(dtx, a_log[:, :8], Bm, Cm)
    big = _scan_inputs(cuda, 1, 4, 1, 65, 4)
    with pytest.raises(ValueError, match="P, N <= 64"):
        MS.mamba_scan_kernel(*big)
    with pytest.raises(ValueError, match="chunk"):
        MS.mamba_scan_kernel(dtx, a_log, Bm, Cm, chunk=96)
    many = _scan_inputs(cuda, 1, 1, 2**19, 1, 1)   # 2**31 state floats
    with pytest.raises(ValueError, match="state pass"):
        MS.mamba_scan_kernel(*many)


@pytest.mark.parametrize("name,layers", [("zamba2-2.7b-smoke", 4),
                                         ("zamba2-2.7b", 6)])
def test_hybrid_forward_launches_per_layer_and_plain_none(cuda, name,
                                                          layers):
    """One mamba_scan launch per Mamba2 layer and one flash launch per
    attention block in each forward; none under ``ops.plain()``, whose
    logits agree with the kernel path's.  zamba2 at full width is cut to
    one unit (5 Mamba2 layers and one attention block) to save time."""
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    units = layers // cfg.hybrid_attn_every
    model = build_model(cfg)
    net = model.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                                     device=cuda)}
    route = _route(getattr(torch, cfg.dtype))   # bf16 at full width
    for _ in range(2):
        before = (MS.launches, FA.launches, FA.launches_by_kernel[route])
        logits, _ = model.forward(net, batch)
        torch.cuda.synchronize()
        assert (MS.launches - before[0], FA.launches - before[1],
                FA.launches_by_kernel[route] - before[2]) == \
            (layers - units, units, units)
    before = (MS.launches, FA.launches)
    with ops.plain():
        plain, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    assert (MS.launches, FA.launches) == before
    atol = 1e-4 if cfg.dtype == "float32" else 0.25
    assert (logits - plain).abs().max().item() <= atol


# --- mlstm_scan ---------------------------------------------------------------

MLSTM_ATOL = 1e-4   # as tests/test_kernels.py holds the Pallas mLSTM scan


def _mlstm_inputs(dev, b, S, H, P, f_pre=None, i_scale=1.0):
    """Drawn as tests/test_kernels.py draws them: q, k, v ·0.4, i_pre
    N(0, 1) (times ``i_scale``), f_pre N(0, 1) + 2 unless given: a
    constant, or "long" for N(0, 1) + 4 (forget gates near 0.98, so the
    state crosses every chunk)."""
    g = torch.Generator(device=dev).manual_seed(b * 1000 + S + H + P)

    def randn(*size):
        return torch.randn(size, generator=g, device=dev)
    q, k, v = (randn(b, S, H, P) * 0.4 for _ in range(3))
    i_pre = randn(b, S, H) * i_scale
    if f_pre is None or f_pre == "long":
        f = randn(b, S, H) + (4 if f_pre else 2)
    else:
        f = torch.full((b, S, H), f_pre, device=dev)
    return q, k, v, i_pre, f


@pytest.mark.parametrize("b,S,H,P", [
    (2, 32, 2, 16),           # the grid of tests/test_kernels.py
    (1, 32, 1, 8),            # its chunk-invariance case
    (4, 64, 4, 512),          # xlstm-1.3b's heads at the serving prompt
    (1, 300, 4, 512),         # ragged last chunk
    (2, 37, 3, 33),           # ragged everything (4-byte copies)
    (1, 1, 1, 1),
    (1, 2048, 4, 512),        # xlstm-1.3b's prefill
])
@pytest.mark.parametrize("gates", [None, "long"], ids=["usual", "long"])
def test_mlstm_kernel_matches_plain(cuda, b, S, H, P, gates):
    """At the usual forget gates and at long-memory ones, slow enough that
    the state crosses every chunk, so that a state pass that drops or
    misroutes the carried state cannot pass.  Two launches give the same
    bits."""
    args = _mlstm_inputs(cuda, b, S, H, P, f_pre=gates)
    before = ML.launches
    out = ops.mlstm_scan(*args)
    again = ops.mlstm_scan(*args)
    torch.cuda.synchronize()
    assert ML.launches == before + 2
    assert torch.equal(out, again)   # no atomics: the same bits
    ref = mlstm_ref(*args)
    assert out.shape == ref.shape and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, atol=MLSTM_ATOL, rtol=0)


def test_mlstm_kernel_forget_all(cuda):
    """f_pre = -30: f_s = 0, so h_t = v_t (k_t·q_t) / max(|k_t·q_t|, 1)."""
    q, k, v, i_pre, f_pre = _mlstm_inputs(cuda, 1, 100, 4, 512, f_pre=-30.0)
    out = ML.mlstm_scan_kernel(q, k, v, i_pre, f_pre)
    kq = (k * q).sum(-1, keepdim=True)
    expect = v * kq / kq.abs().clamp_min(1.0)
    torch.testing.assert_close(out, expect, atol=MLSTM_ATOL, rtol=0)


def test_mlstm_kernel_stabiliser(cuda):
    """i_pre ·10: the stabiliser m_t follows i_t."""
    args = _mlstm_inputs(cuda, 2, 200, 2, 512, i_scale=10.0)
    torch.testing.assert_close(ML.mlstm_scan_kernel(*args), mlstm_ref(*args),
                               atol=MLSTM_ATOL, rtol=0)


def test_mlstm_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v, i_pre, f_pre = _mlstm_inputs(cuda, 1, 16, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        ML.mlstm_scan_kernel(q.double(), k, v, i_pre, f_pre)
    with pytest.raises(ValueError, match="on cpu"):
        ML.mlstm_scan_kernel(q, k.cpu(), v, i_pre, f_pre)
    with pytest.raises(ValueError, match="4-d"):
        ML.mlstm_scan_kernel(q[0], k, v, i_pre, f_pre)
    with pytest.raises(ValueError, match="contiguous"):
        ML.mlstm_scan_kernel(q, k, v.transpose(1, 2).contiguous()
                             .transpose(1, 2), i_pre, f_pre)
    with pytest.raises(ValueError, match="shape"):
        ML.mlstm_scan_kernel(q, k, v, i_pre[:, :8], f_pre)
    big = _mlstm_inputs(cuda, 1, 4, 1, 513)
    with pytest.raises(ValueError, match="P <= 512"):
        ML.mlstm_scan_kernel(*big)
    many = _mlstm_inputs(cuda, 1, 1, 2**13, 512)   # 2**31 state floats
    with pytest.raises(ValueError, match="state pass"):
        ML.mlstm_scan_kernel(*many)


@pytest.mark.parametrize("name,layers", [("xlstm-1.3b-smoke", 4),
                                         ("xlstm-1.3b", 4)])
def test_xlstm_forward_launches_per_mlstm_layer_and_plain_none(cuda, name,
                                                               layers):
    """One mlstm_scan launch per mLSTM layer and no other kernel in each
    forward; none under ``ops.plain()``, whose logits agree with the kernel
    path's.  xlstm-1.3b at full width is cut to one unit (3 mLSTM layers and
    one sLSTM layer) to save time."""
    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    units = layers // cfg.xlstm_slstm_every
    model = build_model(cfg)
    net = model.init(seed=0)
    g = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                                     device=cuda)}
    others = (MS.launches, FA.launches, fc.launches)
    for _ in range(2):
        before = ML.launches
        logits, _ = model.forward(net, batch)
        torch.cuda.synchronize()
        assert ML.launches - before == layers - units
    assert (MS.launches, FA.launches, fc.launches) == others
    before = ML.launches
    with ops.plain():
        plain, _ = model.forward(net, batch)
    torch.cuda.synchronize()
    assert ML.launches == before
    atol = 1e-4 if cfg.dtype == "float32" else 0.25
    assert (logits - plain).abs().max().item() <= atol


# --- the halo dataflow (core/halo.py, core/seq_halo.py) on the card ---------

def test_halo_group_through_kernel_matches_whole(cuda):
    """ResNet18's stage-2 group in 4 row shards, one halo exchange, every
    conv through the kernel, 5 launches per shard: every row within RTOL
    of the same sharded call under ``ops.plain()``, and rows outside the
    first and last shard within RTOL of the group run whole."""
    from repro_torch.core import halo as H
    from repro_torch.models import layers as L
    from repro_torch.models import resnet as R
    g = torch.Generator().manual_seed(0)
    params = R.init_resnet18(g, 10)
    for blk in ("s2b1", "s2b2"):
        for name, bn in params[blk].items():
            if "bn" in name:
                bn["mean"].normal_(0, 0.1, generator=g)
                bn["bias"].normal_(0, 0.1, generator=g)
    fn = R.fused_group_fns(R.fold_bn(L.tree_to(params, cuda)))[0][1]
    x = torch.randn(2, 56, 56, 64, generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    whole = fn(x)
    before = fc.launches
    out = H.run_fused_group(fn, x, 4, halo=14, shrink=7)
    torch.cuda.synchronize()
    assert fc.launches - before == 20
    with ops.plain():
        ref = H.run_fused_group(fn, x, 4, halo=14, shrink=7)
    assert fc.launches - before == 20
    assert (out - ref).abs().max().item() <= RTOL * ref.abs().max().item()
    dev = (out - whole).abs().amax(dim=(0, 2, 3))
    assert dev[7:-7].max().item() <= RTOL * whole.abs().max().item()
    assert dev[:7].max().item() > 0.1 and dev[-7:].max().item() > 0.1


def test_windowed_halo_matches_whole_attention(cuda):
    """Eight sequence shards with a three-step K/V ring, f32, against
    attention over the whole sequence with the same causal window mask,
    per element within 2e-5; no kernel launches."""
    from repro_torch.core.seq_halo import windowed_attention_halo
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 512, h, 64, generator=g, device=cuda)
               for h in (8, 4, 4))
    before = FA.launches
    out = windowed_attention_halo(q, k, v, window=150, n_shards=8,
                                  softcap=50.0)
    ref = L.attention_scores(q, k, v, L.causal_mask(512, 512, window=150)
                             .to(cuda), 50.0)
    torch.cuda.synchronize()
    assert FA.launches == before
    assert (out - ref).abs().max().item() <= 2e-5


# --- training: the flash gradient, the kernels without one, a train step ----

def _grad_check(dev, dtype, B, H, KV, S, T, D, causal, window, softcap):
    """dq, dk, dv through ``ops.flash_attention`` (the kernel inside the
    autograd function, whose backward launches the backward kernel)
    against autograd of the plain attention in f32 on the same values:
    within 1e-5·max|ref| in f32, half a bf16 ulp of |ref| plus 2e-5 in
    bf16.  Twice: the two gradients bit-equal, two forward and two
    backward launches, each on its dtype's (and head dim's) route, and no
    call of the plain gradient."""
    g = torch.Generator(device=dev).manual_seed(S * 31 + D)
    q, k, v = (torch.randn(B, n, H_, D, generator=g, device=dev).to(dtype)
               for n, H_ in ((S, H), (T, KV), (T, KV)))
    do = torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    routes = (_route(dtype), FA.backward_route(dtype, D))
    before = dict(FA.launches_by_kernel)
    bwd_before = FA.backward_launches
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ops.flash_attention(*leaves, **kw).backward(do)
        runs.append(leaves)
    torch.cuda.synchronize()
    moved = {r: n - before[r] for r, n in FA.launches_by_kernel.items()}
    assert moved == {r: 2 * int(r in routes) for r in moved}
    assert FA.backward_launches == bwd_before + 2
    assert all(torch.equal(a.grad, b.grad) for a, b in zip(*runs))
    refs = [t.float().clone().requires_grad_() for t in (q, k, v)]
    with ops.plain():
        ref_out = ops.flash_attention(*refs, **kw)
    ref_out.backward(do.float())
    for t, r in zip(runs[0], refs):
        assert t.grad.dtype == dtype
        err = (t.grad.float() - r.grad).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * r.grad.abs().max().item()
        else:
            assert bool((err <= 2.0 ** -8 * r.grad.abs() + 2e-5).all()), \
                err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window,softcap", [
    (4, 36, 36, 1024, 1024, 64, True, 0, 0.0),   # minicpm-2b's train shape
    (1, 64, 8, 512, 512, 128, True, 0, 0.0),     # qwen3's GQA 64/8
    (1, 8, 4, 512, 512, 256, True, 128, 50.0),   # gemma2's D, window, cap
    (2, 4, 4, 100, 300, 64, False, 0, 0.0),      # cross, ragged tiles
    (2, 32, 32, 1024, 1024, 80, True, 0, 0.0),   # zamba2's D
    (1, 20, 20, 448, 1500, 64, False, 0, 0.0),   # whisper's cross shape
    (1, 8, 4, 8192, 8192, 256, True, 0, 50.0),   # gemma2's global layer
    (1, 8, 4, 8192, 8192, 256, True, 4096, 50.0),  # and its local layer
    (4, 8, 1, 1024, 1024, 256, True, 0, 0.0),    # paligemma-3b's heads
])
def test_flash_gradient_matches_plain(cuda, dtype, B, H, KV, S, T, D, causal,
                                      window, softcap):
    _grad_check(cuda, dtype, B, H, KV, S, T, D, causal, window, softcap)


# The backward kernels alone, at every head dim: the wgmma kernel walks
# 128-key tiles (64 at D = 128 and 256) and 64-query tiles, the f32 kernel
# 128-key tiles up to D = 64 (64 at D = 80 and 96, 32 above) and 64-query
# tiles (32 at D = 256), so 150, 77 and 700 are multiples of none; 700
# with a window of 200 has six key tiles or more, each query tile's dQ
# summed over up to three or more in order, and the non-causal 200 by 600
# five or more, every one adding to every query tile, as in the ragged GQA
# 77 by 200.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", FA.HEAD_DIMS)
@pytest.mark.parametrize("BH,BKV,S,T,causal,window,softcap", [
    (4, 2, 150, 150, True, 0, 0.0),      # causal, GQA 2:1, ragged
    (4, 1, 150, 150, True, 37, 30.0),    # window and softcap, GQA 4:1
    (2, 2, 77, 150, False, 0, 0.0),      # cross, S < T, ragged
    (2, 2, 150, 77, True, 0, 0.0),       # causal, S > T: keys past S seen
    (2, 1, 700, 700, True, 200, 0.0),    # window across key tiles, GQA 2:1
    (2, 2, 200, 600, False, 0, 0.0),     # non-causal, five key tiles each
    (6, 2, 77, 200, False, 0, 0.0),      # non-causal, GQA 3:1, ragged
])
def test_flash_backward_kernel_matches_plain(cuda, dtype, D, BH, BKV, S, T,
                                             causal, window, softcap):
    """dq, dk, dv from the forward's saved statistics against
    ``attention_ref_grad`` in f32 on the same values (the limits of
    ``_grad_check``); two launches give the same bits; one backward launch
    each on the backward route of the dtype and head dim."""
    q, k, v = _qkv(cuda, BH, BKV, S, T, D, dtype)
    do = torch.randn(q.shape, generator=torch.Generator(
        device=cuda).manual_seed(D), device=cuda).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse, lo = FA.flash_attention_kernel(q, k, v, **kw, stats=True)
    assert torch.equal(out, FA.flash_attention_kernel(q, k, v, **kw))
    route = FA.backward_route(dtype, D)
    before = dict(FA.launches_by_kernel)
    runs = [FA.flash_attention_backward_kernel(q, k, v, out, lse, do,
                                               out_lo=lo, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert {r: n - before[r] for r, n in FA.launches_by_kernel.items()} == \
        {r: 2 * int(r == route) for r in before}
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    refs = attention_ref_grad(q.float(), k.float(), v.float(), do.float(),
                              **kw)
    for got, want in zip(runs[0], refs):
        assert got.dtype == dtype and got.is_contiguous()
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5 * want.abs().max().item()
        else:
            assert bool((err <= 2.0 ** -8 * want.abs() + 2e-5).all()), \
                err.max().item()


def test_flash_backward_kernel_refuses_what_it_cannot_take(cuda):
    q, k, v = _qkv(cuda, 4, 2, 40, 40, 32, torch.bfloat16)
    out, lse, lo = FA.flash_attention_kernel(q, k, v, stats=True)
    bwd = FA.flash_attention_backward_kernel
    with pytest.raises(ValueError, match="out_lo"):
        bwd(q, k, v, out, lse, out)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, out, lse[:, :8].contiguous(), out, out_lo=lo)
    with pytest.raises(ValueError, match="lse"):
        bwd(q, k, v, out, lse.double(), out, out_lo=lo)
    with pytest.raises(TypeError):
        bwd(q, k, v, out, lse, out.float(), out_lo=lo)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, out, lse, out.transpose(0, 1).contiguous()
            .transpose(0, 1), out_lo=lo)
    with pytest.raises(ValueError, match="CUDA"):
        bwd(q.cpu(), k, v, out, lse, out, out_lo=lo)
    with pytest.raises(ValueError, match="must be q's"):
        bwd(q, k, v, out[:, :8].contiguous(), lse, out, out_lo=lo)
    # the f32 backward reads 16 bytes at a time: its bases too are aligned
    qf, kf, vf = _qkv(cuda, 4, 2, 40, 40, 32, torch.float32)
    outf, lsef, _ = FA.flash_attention_kernel(qf, kf, vf, stats=True)
    shifted = torch.empty(qf.numel() + 1, device=cuda)[1:]
    shifted = shifted.view(qf.shape).copy_(qf)
    with pytest.raises(ValueError, match="aligned"):
        bwd(shifted, kf, vf, outf, lsef, outf)


def test_train_step_reaches_no_plain_flash_gradient(cuda, monkeypatch):
    """A train step of minicpm-2b-smoke in bf16 on the card: one flash
    backward launch a layer on the tensor-core route, and no call of the
    plain gradient ``ref.attention_ref_grad``."""
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (TrainStepConfig, init_train_state,
                                           make_train_step)
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return attention_ref_grad(*args, **kw)
    monkeypatch.setattr(ref, "attention_ref_grad", counted)
    cfg = dataclasses.replace(get_config("minicpm-2b-smoke"),
                              dtype="bfloat16", param_dtype="bfloat16")
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3), schedule_warmup=1)
    model = build_model(cfg, device=cuda)
    state = init_train_state(model, model.init(0), ts)
    before = (FA.backward_launches, FA.launches_by_kernel["bwd_tc_bf16"])
    _, metrics = make_train_step(model, ts)(state, batch_for_step(
        cfg, 0, 2, 64, device=cuda))
    torch.cuda.synchronize()
    assert calls == []
    assert (FA.backward_launches, FA.launches_by_kernel["bwd_tc_bf16"]) == \
        (before[0] + cfg.num_layers, before[1] + cfg.num_layers)
    assert torch.isfinite(torch.as_tensor(metrics["loss"])).all()


def test_kernels_without_a_backward_refuse_a_gradient(cuda):
    """Under autograd the fused conv, which has no backward, raises rather
    than return an output whose gradient silently stops; without a
    gradient (no_grad, or inputs that need none) it launches as before.
    The two scans give gradients through their backward kernels: a forward
    and a backward launch each, and only the forward without a gradient."""
    x = torch.randn(1, 8, 8, 16, device=cuda, requires_grad=True)
    w = torch.randn(3, 3, 16, 16, device=cuda)
    scale, shift = torch.ones(16, device=cuda), torch.zeros(16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.fused_conv(x, w, scale, shift)
    with torch.no_grad():
        assert ops.fused_conv(x, w, scale, shift).shape == (1, 8, 8, 16)
    dtx = torch.randn(1, 64, 2, 16, device=cuda, requires_grad=True)
    a = -torch.rand(1, 64, 2, device=cuda)
    Bm, Cm = (torch.randn(1, 64, 16, device=cuda) for _ in range(2))
    q = torch.randn(1, 64, 2, 16, device=cuda, requires_grad=True)
    gates = [torch.randn(1, 64, 2, device=cuda) for _ in range(2)]
    for mod, run, leaf in ((MS, lambda: ops.mamba_scan(dtx, a, Bm, Cm), dtx),
                           (ML, lambda: ops.mlstm_scan(q, q.detach(),
                                                       q.detach(), *gates),
                            q)):
        before = (mod.launches, mod.backward_launches)
        run().sum().backward()
        torch.cuda.synchronize()
        assert (mod.launches, mod.backward_launches) == (before[0] + 1,
                                                         before[1] + 1)
        assert torch.isfinite(leaf.grad).all() and leaf.grad.abs().max() > 0
        with torch.no_grad():
            run()
        assert (mod.launches, mod.backward_launches) == (before[0] + 2,
                                                         before[1] + 1)


# --- the scans' backward kernels ---------------------------------------------------

BWD_RTOL = 1e-4   # per gradient tensor, of max|g_plain|
BWD_ZERO = 1e-6   # max|g_plain| taken as at least this of the call's largest


def _bwd_check(op, plain, mod, args):
    """The gradient through ``op`` (the kernel under its autograd function,
    whose backward is the backward kernel) against autograd of ``plain`` in
    f32 on the same values, each tensor within BWD_RTOL·max|g_plain|; two
    backward launches give the same bits; each counter moves by two."""
    g = torch.Generator(device=args[0].device).manual_seed(99)
    dout = torch.randn(args[0].shape, generator=g, device=args[0].device)
    before = (mod.launches, mod.backward_launches)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in args]
        op(*leaves).backward(dout)
        runs.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert (mod.launches, mod.backward_launches) == (before[0] + 2,
                                                     before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    leaves = [t.clone().requires_grad_() for t in args]
    plain(*leaves).backward(dout)
    refs = [t.grad for t in leaves]
    top = max(r.abs().max().item() for r in refs)
    for got, ref in zip(runs[0], refs):
        assert got.shape == ref.shape and got.dtype == torch.float32
        limit = BWD_RTOL * max(ref.abs().max().item(), BWD_ZERO * top)
        assert (got - ref).abs().max().item() <= limit


@pytest.mark.parametrize("b,S,H,P,N,decays", [
    (2, 64, 3, 16, 8, None),
    (1, 1024, 8, 64, 64, None),      # zamba2's train S, P and N
    (1, 1024, 8, 64, 64, "long"),    # the adjoint crosses every chunk
    (1, 200, 3, 64, 64, -30.0),      # full reset
    (2, 37, 5, 33, 17, "long"),      # ragged everything
    (1, 1, 1, 1, 1, None),
    (1, 256, 80, 64, 64, None),      # zamba2's 80 heads, a ragged last group
    (1, 1000, 8, 64, 64, None),      # a ragged S at full P and N
    (1, 512, 7, 64, 64, "long"),     # a prime number of heads
])
def test_scan_backward_matches_plain(cuda, b, S, H, P, N, decays):
    _bwd_check(ops.mamba_scan, mamba_scan_ref, MS,
               _scan_inputs(cuda, b, S, H, P, N, a_log=decays))


@pytest.mark.parametrize("b,S,H,P,gates,i_scale,qk", [
    (2, 32, 2, 16, None, 1.0, 1.0),
    (2, 256, 2, 512, None, 1.0, 1.0),     # xlstm-1.3b's P
    (2, 256, 2, 512, "long", 1.0, 1.0),   # long memory
    (2, 200, 2, 512, None, 10.0, 1.0),    # the stabiliser follows i_t
    (1, 100, 4, 512, -30.0, 1.0, 1.0),    # forget-all
    (2, 256, 2, 512, None, 1.0, 0.1),     # |n.q| < 1 at most steps
    (2, 37, 3, 33, None, 1.0, 1.0),       # ragged everything
    (1, 1, 1, 1, None, 1.0, 1.0),
    (1, 1000, 2, 512, None, 1.0, 1.0),    # a ragged S at full P
    (1, 1024, 1, 512, None, 1.0, 1.0),    # S = 2P
])
def test_mlstm_backward_matches_plain(cuda, b, S, H, P, gates, i_scale, qk):
    q, k, v, i_pre, f_pre = _mlstm_inputs(cuda, b, S, H, P, f_pre=gates,
                                          i_scale=i_scale)
    _bwd_check(ops.mlstm_scan, mlstm_ref, ML,
               (q * qk, k * qk, v, i_pre, f_pre))


def test_backward_kernels_refuse_what_they_cannot_take(cuda):
    dtx, a_log, Bm, Cm = _scan_inputs(cuda, 1, 16, 2, 8, 4)
    with pytest.raises(ValueError, match="mamba_scan_bwd_kernel runs on"):
        MS.mamba_scan_bwd_kernel(dtx.cpu(), dtx, a_log, Bm, Cm)
    with pytest.raises(ValueError, match="shape"):
        MS.mamba_scan_bwd_kernel(dtx[:, :8].contiguous(), dtx, a_log, Bm, Cm)
    q, k, v, i_pre, f_pre = _mlstm_inputs(cuda, 1, 16, 2, 8)
    with pytest.raises(TypeError, match="float32"):
        ML.mlstm_scan_bwd_kernel(q.double(), q, k, v, i_pre, f_pre, q)
    with pytest.raises(ValueError, match="shape"):
        ML.mlstm_scan_bwd_kernel(q, q, k, v, i_pre, f_pre, q[:, :8])
    big = _mlstm_inputs(cuda, 1, 4, 1, 513)
    with pytest.raises(ValueError, match="P <= 512"):
        ML.mlstm_scan_bwd_kernel(big[0], *big, big[0])


def _train_launches(cfg) -> dict[str, int]:
    """Each kernel's launches in one gradient of ``cfg``: flash once per
    attention block; each scan once per layer forward and once backward."""
    from repro_torch.models.api import hybrid_units, xlstm_units
    if cfg.family == "hybrid":
        units, k = hybrid_units(cfg)
        return {"flash": units, "mamba": units * k, "mlstm": 0}
    if cfg.family == "ssm":
        units, k = xlstm_units(cfg)
        return {"flash": 0, "mamba": 0, "mlstm": units * k}
    return {"flash": cfg.num_layers, "mamba": 0, "mlstm": 0}


def _launch_counts() -> dict[str, int]:
    return {"flash": FA.launches, "flash_bwd": FA.backward_launches,
            "mamba": MS.launches, "mamba_bwd": MS.backward_launches,
            "mlstm": ML.launches, "mlstm_bwd": ML.backward_launches}


@pytest.mark.parametrize("name", ["minicpm-2b-smoke", "gemma2-2b-smoke",
                                  "zamba2-2.7b-smoke", "xlstm-1.3b-smoke"])
def test_train_step_on_the_card_matches_the_cpu(cuda, name):
    """One train step of a smoke config on the card (flash through its
    autograd function and each scan through its own, one forward and one
    backward launch an attention block or scan layer) and on the CPU from
    the same state: loss within 1e-5 relative, gradients within 1e-4·max
    per leaf, parameters within 2·lr + 1e-6."""
    from repro_torch import tree
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (TrainStepConfig, init_train_state,
                                           make_grad_fn, make_train_step)
    cfg = get_config(name)
    ts = TrainStepConfig(opt=AdamWConfig(lr=1e-3), schedule_warmup=1)
    cpu_model = build_model(cfg, device="cpu")
    gpu_model = build_model(cfg, device=cuda)
    cpu_state = init_train_state(cpu_model, cpu_model.init(0), ts)
    gpu_state = init_train_state(gpu_model, gpu_model.init(0), ts)
    batch = batch_for_step(cfg, 0, 2, 32, device="cpu")
    _, _, g_cpu = make_grad_fn(cpu_model, ts)(cpu_state["params"], batch)
    before = _launch_counts()
    _, _, g_gpu = make_grad_fn(gpu_model, ts)(gpu_state["params"], batch)
    torch.cuda.synchronize()
    want = _train_launches(cfg)
    want.update(flash_bwd=want["flash"], mamba_bwd=want["mamba"],
                mlstm_bwd=want["mlstm"])
    assert {k: n - before[k] for k, n in _launch_counts().items()} == want
    for a, b in zip(tree.leaves(g_cpu), tree.leaves(g_gpu)):
        assert b.norm().item() > 0
        assert (a - b.cpu()).abs().max().item() <= \
            1e-4 * a.abs().max().item()
    s_cpu, m_cpu = make_train_step(cpu_model, ts)(cpu_state, batch)
    s_gpu, m_gpu = make_train_step(gpu_model, ts)(gpu_state, batch)
    assert m_gpu["loss"].item() == pytest.approx(m_cpu["loss"].item(),
                                                 rel=1e-5)
    for a, b in zip(tree.leaves(s_cpu["params"]),
                    tree.leaves(s_gpu["params"])):
        assert (a.detach() - b.detach().cpu()).abs().max().item() \
            <= 2e-3 + 1e-6


# The DTensor route (``ops._local_route``) needs a process group, which a
# pytest process must not hold: each case runs in a process of its own, on
# a one-rank NCCL group over an in-memory store and a 1×1 mesh.
DTENSOR_ROUTE = """
import json, sys
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.kernels import flash_attention as FA, mamba_scan as MS
from repro_torch.kernels import mlstm_scan as ML, ops
from repro_torch.launch.mesh import make_mesh
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
mesh = make_mesh((1, 1), ("data", "model"))
g = torch.Generator(device="cuda").manual_seed(0)
def rand(*shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)
# the placements of fused_seq's sequence-sharded q and of a head shard
PLACE = {"seq": [Shard(0), Shard(1)], "heads": [Replicate(), Shard(2)]}
out = {}
for op, mod, args in [
        ("flash", FA, [rand(2, 256, 8, 64, dtype=torch.bfloat16),
                       rand(2, 256, 4, 64, dtype=torch.bfloat16),
                       rand(2, 256, 4, 64, dtype=torch.bfloat16)]),
        ("mamba", MS, [rand(2, 128, 4, 64) * 0.1, -rand(2, 128, 4).abs(),
                       rand(2, 128, 64) * 0.1, rand(2, 128, 64) * 0.1]),
        ("mlstm", ML, [rand(2, 128, 4, 64) * 0.1, rand(2, 128, 4, 64) * 0.1,
                       rand(2, 128, 4, 64), rand(2, 128, 4), rand(2, 128, 4)])]:
    fn = {"flash": ops.flash_attention, "mamba": ops.mamba_scan,
          "mlstm": ops.mlstm_scan}[op]
    want = fn(*args)
    for place in PLACE:
        for grad in (False, True):
            xs = [distribute_tensor(a, mesh, PLACE[place] if a.dim() > 3
                  or op != "mamba" else [Replicate(), Replicate()])
                  .requires_grad_(grad) for a in args]
            mod.launches = 0
            got = fn(*xs)
            torch.cuda.synchronize()
            launched = mod.launches
            if grad:
                got.float().sum().backward()
            mod.launches = 0
            with ops.plain():
                fn(*[x.detach() for x in xs])
            out[f"{op}/{place}/{grad}"] = {
                "launches": launched, "plain_launches": mod.launches,
                "placements": str(got.placements),
                "equal": bool(torch.equal(got.to_local(), want)),
                "grads": all(x.grad is not None for x in xs) if grad else True}
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_dtensor_route_launches_the_kernels_on_a_1x1_mesh(cuda):
    """On a 1×1 mesh a DTensor reaches each kernel through ``local_map``:
    one launch a call (the autograd function's too, with a gradient), none
    under ``ops.plain()``, the output in the first input's placements and
    bit-equal to the same kernel's call on the plain tensors."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", DTENSOR_ROUTE], env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(out) == 12
    for case, rec in out.items():
        assert rec["launches"] == 1 and rec["plain_launches"] == 0, case
        assert rec["equal"] and rec["grads"], case
        want = "(Shard(dim=0), Shard(dim=1))" if "/seq/" in case \
            else "(Replicate(), Shard(dim=2))"
        assert rec["placements"] == want, case
