"""The port's fused CONV + BN + [ADD] + [RELU] on the CPU, held against the
JAX oracle ``repro.kernels.ref.fused_conv_ref`` on the geometry grid of
``tests/test_kernels.py``, at its tolerance (atol 1e-4).  The Pallas kernel
itself does not trace on this jax, so the JAX side is its plain oracle.
The CUDA kernel is held against the same plain version on the card, in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import fused_conv_ref as jax_fused_conv_ref
from repro_torch.kernels import fused_conv as fc
from repro_torch.kernels import ops
from repro_torch.kernels.ref import fused_conv_ref as fc_ref

ATOL = 1e-4


def _inputs(seed, B, H, W, cin, k, cout, residual_hw=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = None
    if residual_hw is not None:
        res = rng.standard_normal((B, *residual_hw, cout)).astype(np.float32)
    return x, w, scale, shift, res


def _both(x, w, scale, shift, res=None, **kw):
    ref = jax_fused_conv_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
        residual=None if res is None else jnp.asarray(res), **kw)
    out = ops.fused_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(shift),
        residual=None if res is None else torch.from_numpy(res), **kw)
    return out, np.asarray(ref)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                   (1, 2, 0), (7, 2, 3)])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_conv_geometry(k, s, p, relu):
    x, w, scale, shift, _ = _inputs(7, 2, 16, 16, 8, k, 16)
    out, ref = _both(x, w, scale, shift, stride=s, padding=p, relu=relu)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_fused_conv_residual_add_relu():
    """The paper's full fused epilogue: CONV_BN + ADD + RELU in one op."""
    x, w, scale, shift, res = _inputs(8, 1, 8, 8, 8, 3, 8, residual_hw=(8, 8))
    out, ref = _both(x, w, scale, shift, res)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert (out.numpy() >= 0).all()  # relu applied after add


@pytest.mark.parametrize("hw,cout", [(7, 8), (7, 12), (5, 3)])
def test_fused_conv_nondivisible_spatial(hw, cout):
    """Odd extents and channel counts (ResNet 7x7 stage-4 maps) that the
    Pallas version pads to whole tiles and crops."""
    x, w, scale, shift, _ = _inputs(9, 1, hw, hw, 8, 3, cout)
    out, ref = _both(x, w, scale, shift)
    assert out.shape == ref.shape == (1, hw, hw, cout)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("hw", [4, 9, 12])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_fused_conv_sweep(hw, stride, k):
    """The fixed-grid counterpart of test_kernels' hypothesis property."""
    x, w, _, _, _ = _inputs(hw * 10 + stride, 1, hw, hw, 4, k, 8)
    w *= 1.5
    one, zero = np.ones(8, np.float32), np.zeros(8, np.float32)
    out, ref = _both(x, w, one, zero, stride=stride, padding=k // 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_stem_cin3_residual_without_relu():
    """Cin=3 (the stem's K=147) with a residual and no ReLU."""
    x, w, scale, shift, res = _inputs(10, 2, 20, 20, 3, 7, 16,
                                      residual_hw=(10, 10))
    out, ref = _both(x, w, scale, shift, res, stride=2, padding=3,
                     relu=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_cpu_goes_to_plain_version_not_the_kernel():
    x, w, scale, shift, _ = _inputs(11, 1, 6, 6, 4, 3, 4)
    before = fc.launches
    ops.fused_conv(*map(torch.from_numpy, (x, w, scale, shift)))
    assert fc.launches == before


def test_non_cpu_tensor_goes_to_kernel_which_raises():
    """No fallback: a tensor that is not on the CPU reaches the kernel's
    wrapper, which refuses what it cannot launch on."""
    x = torch.empty((1, 6, 6, 4), device="meta")
    w = torch.empty((3, 3, 4, 4), device="meta")
    s = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_conv(x, w, s, s)


# ResNet18's convs at batch 8 as implicit GEMMs: (M, Cout, K).
RESNET18_GEMMS = [(100352, 64, 147), (25088, 64, 576), (6272, 128, 576),
                  (6272, 128, 64), (6272, 128, 1152), (1568, 256, 1152),
                  (1568, 256, 128), (1568, 256, 2304), (392, 512, 2304),
                  (392, 512, 256), (392, 512, 4608)]


@pytest.mark.parametrize("m,n,k", RESNET18_GEMMS + [(75, 70, 45),
                                                    (1, 1, 1), (450, 40, 576)])
def test_plan_is_one_the_kernel_takes(m, n, k):
    bn, splits = fc.plan(m, n, k)
    assert bn in fc.TILE_N
    assert 1 <= splits <= min(fc.MAX_SPLITS, -(-k // fc.K_BLOCK))
    if n <= fc.TILE_N[0]:
        assert bn == fc.TILE_N[0]


@pytest.mark.parametrize("m,n,k", RESNET18_GEMMS[5:])
def test_plan_fills_the_card_at_stages_3_and_4(m, n, k):
    """Stages 3 and 4 have 16-26 output tiles for 132 SMs; the split of K
    brings them within one wave of a full card."""
    bn, splits = fc.plan(m, n, k)
    blocks = -(-m // fc.TILE_M) * -(-n // bn) * splits
    assert splits > 1 and fc.SMS * 3 // 4 <= blocks <= fc.SMS


@pytest.mark.parametrize("h,k,s,p,want", [(224, 7, 2, 3, 112),
                                          (56, 1, 2, 0, 28), (7, 3, 1, 1, 7),
                                          (14, 3, 2, 1, 7)])
def test_out_hw(h, k, s, p, want):
    assert fc.out_hw(h, h, k, k, s, p) == (want, want)


# --- the kernel's arithmetic, emulated on the CPU ---------------------------
#
# The CUDA kernel takes each f32 product as three bf16 products on the
# tensor cores, a_hi·b_hi + a_hi·b_lo + a_lo·b_hi with hi = bf16(v) and
# lo = bf16(v − hi), summed in f32.  Emulated here at ResNet18's shapes with
# chip_smoke.py's inputs (x ~ N(0, 1), He-scaled weights), it must hold the
# card's per-conv limit, max|out − conv| ≤ 1e-4·max|conv| against the conv
# in f64; a single bf16 pass or a single TF32 pass must not, which is why
# the kernel carries the split.

KERNEL_RTOL = 1e-4   # chip_smoke.py's limit per conv

# (name, batch, input hw, Cin, Cout, k, stride, padding)
RESNET18_SHAPES = [
    ("stem_7x7s2", 1, 224, 3, 64, 7, 2, 3),       # K = 147
    ("s1_3x3", 2, 56, 64, 64, 3, 1, 1),
    ("s4_3x3s2", 2, 14, 256, 512, 3, 2, 1),
    ("s4_3x3", 2, 7, 512, 512, 3, 1, 1),          # K = 4608
]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Rounds f32 to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _conv(x: torch.Tensor, w: torch.Tensor, s: int, p: int) -> torch.Tensor:
    return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2),
                                      w.permute(3, 2, 0, 1), stride=s,
                                      padding=p)


def _split_bf16x3(x, w, s, p):
    xh, wh = _bf16(x), _bf16(w)
    xl, wl = _bf16(x - xh), _bf16(w - wh)
    return _conv(xh, wh, s, p) + _conv(xh, wl, s, p) + _conv(xl, wh, s, p)


SCHEMES = {
    "bf16x3": _split_bf16x3,
    "bf16x1": lambda x, w, s, p: _conv(_bf16(x), _bf16(w), s, p),
    "tf32x1": lambda x, w, s, p: _conv(_tf32(x), _tf32(w), s, p),
}


def _scheme_rel_err(scheme: str, shape) -> float:
    _, b, hw, cin, cout, k, s, p = shape
    rng = np.random.default_rng(hw * 100 + cin)
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, cin))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout))
                          * (2.0 / (k * k * cin)) ** 0.5).astype(np.float32))
    exact = _conv(x.double(), w.double(), s, p)
    out = SCHEMES[scheme](x, w, s, p)
    assert out.dtype == torch.float32
    return ((out.double() - exact).abs().max() / exact.abs().max()).item()


def test_split_rounds_as_the_kernel_does():
    """hi carries bf16's 8 bits, lo the next 8: hi + lo is within 2^-16 of
    v, and exactly v where v needs no more than 16 bits."""
    v = torch.tensor([1.0, 1 + 2**-7, 1 + 2**-9 + 2**-15, 3.14159265,
                      -2.5e-3, 7e4])
    hi = _bf16(v)
    lo = _bf16(v - hi)
    assert ((hi + lo - v).abs() <= v.abs() * 2.0**-16).all()
    assert (hi + lo)[:3].tolist() == v[:3].tolist()
    assert _tf32(torch.tensor([1 + 2**-11]))[0].item() == 1 + 2**-10


@pytest.mark.parametrize("shape", RESNET18_SHAPES, ids=lambda s: s[0])
def test_bf16x3_split_holds_the_kernel_limit(shape):
    assert _scheme_rel_err("bf16x3", shape) <= KERNEL_RTOL / 10


@pytest.mark.parametrize("scheme", ["bf16x1", "tf32x1"])
@pytest.mark.parametrize("shape", RESNET18_SHAPES, ids=lambda s: s[0])
def test_one_pass_misses_the_kernel_limit(scheme, shape):
    assert _scheme_rel_err(scheme, shape) > KERNEL_RTOL


# --- the bf16 route ------------------------------------------------------------
#
# JAX's fused conv reads every operand as f32, adds in f32 and writes
# x.dtype (src/repro/kernels/fused_conv.py:55 and :130, and its oracle
# ref.fused_conv_ref).  The port's plain version does the same, and on the
# card x, w and a residual all in bf16 take the kernel's bf16 route, which
# rounds the same f32 sums once.  f32 sums taken in another order can land
# on the other side of a rounding tie: one ulp of the output's dtype
# (2^-7·|ref| for bf16 at most), plus the f32 limit of the tests above
# relative to the conv's size.

ULP = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10,
       torch.float32: 2.0**-23}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}


def _within_one_ulp(out: torch.Tensor, ref: np.ndarray) -> None:
    ref = np.asarray(ref, np.float32)
    got = out.float().numpy()
    limit = ULP[out.dtype] * np.abs(ref) + 1e-4 * np.abs(ref).max()
    bad = np.abs(got - ref) > limit
    assert not bad.any(), (np.abs(got - ref)[bad].max(), bad.sum())


def _pair(a: np.ndarray | None, dtype: torch.dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    if a is None:
        return None, None
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(t.float().numpy()).astype(JNP[dtype])


def _mixed(dtypes, x, w, scale, shift, res=None, **kw):
    """ops.fused_conv and JAX's oracle on x, w, scale, shift and res in
    ``dtypes`` (five dtypes, the last ignored without a residual)."""
    (xt, xj), (wt, wj), (st, sj), (ht, hj), (rt, rj) = (
        _pair(a, d) for a, d in zip((x, w, scale, shift, res), dtypes))
    out = ops.fused_conv(xt, wt, st, ht, residual=rt, **kw)
    ref = jax_fused_conv_ref(xj, wj, sj, hj, residual=rj, **kw)
    return out, ref


BF16 = (torch.bfloat16,) * 5


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                   (1, 2, 0), (7, 2, 3)])
@pytest.mark.parametrize("relu", [True, False])
def test_bf16_operands_match_jax(k, s, p, relu):
    x, w, scale, shift, _ = _inputs(7, 2, 16, 16, 8, k, 16)
    out, ref = _mixed(BF16, x, w, scale, shift, stride=s, padding=p,
                      relu=relu)
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert tuple(out.shape) == ref.shape
    _within_one_ulp(out, ref)


@pytest.mark.parametrize("relu", [True, False])
def test_bf16_residual_and_the_stem(relu):
    """The ADD_RELU epilogue in bf16, and the 7x7/s2 stem with Cin = 3 and a
    residual: a 6-byte pixel, which the bf16 route on the card takes padded
    to 8 channels."""
    x, w, scale, shift, res = _inputs(8, 1, 8, 8, 8, 3, 8, residual_hw=(8, 8))
    out, ref = _mixed(BF16, x, w, scale, shift, res, relu=relu)
    _within_one_ulp(out, ref)
    x, w, scale, shift, res = _inputs(10, 2, 20, 20, 3, 7, 16,
                                      residual_hw=(10, 10))
    out, ref = _mixed(BF16, x, w, scale, shift, res, stride=2, padding=3,
                      relu=relu)
    assert out.dtype == torch.bfloat16
    _within_one_ulp(out, ref)


MIX = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("rd", MIX + [None])
@pytest.mark.parametrize("sd", MIX)
@pytest.mark.parametrize("wd", MIX)
@pytest.mark.parametrize("xd", MIX + [torch.float16])
def test_every_dtype_mix_gives_jax_dtype_and_value(xd, wd, sd, rd):
    """x, w, scale and shift (together), and the residual in each dtype
    JAX's kernel takes: the output is x.dtype, with JAX's value."""
    x, w, scale, shift, res = _inputs(12, 1, 9, 9, 8, 3, 16,
                                      residual_hw=(9, 9))
    dtypes = (xd, wd, sd, sd, rd or torch.float32)
    out, ref = _mixed(dtypes, x, w, scale, shift,
                      None if rd is None else res)
    assert out.dtype == xd and ref.dtype == JNP[xd]
    _within_one_ulp(out, ref)


@pytest.mark.parametrize("dtypes,want", [
    ((torch.bfloat16,) * 3, "bf16"),
    ((torch.bfloat16, torch.bfloat16, None), "bf16"),
    ((torch.bfloat16, torch.float32, None), "f32"),
    ((torch.float32, torch.bfloat16, None), "f32"),
    ((torch.bfloat16, torch.bfloat16, torch.float32), "f32"),
    ((torch.float16, torch.float16, None), "f32"),
])
def test_route_is_bf16_only_when_x_w_and_residual_are(dtypes, want):
    x, w, r = (None if d is None else torch.zeros(1, dtype=d) for d in dtypes)
    assert fc.route(x, w, r) == want


@pytest.mark.parametrize("m,n,k", RESNET18_GEMMS + [(75, 70, 45),
                                                    (1, 1, 1), (450, 40, 576)])
def test_bf16_plan_is_one_the_kernel_takes(m, n, k):
    bn, splits = fc.plan(m, n, k, k_block=fc.K_BLOCKS["bf16"])
    assert bn in fc.TILE_N
    assert 1 <= splits <= min(fc.MAX_SPLITS, -(-k // fc.K_BLOCKS["bf16"]))
    if n <= fc.TILE_N[0]:
        assert bn == fc.TILE_N[0]


@pytest.mark.parametrize("cin,want", [(3, 8), (5, 8), (8, 8), (12, 16),
                                      (64, 64), (96, 96)])
def test_bf16_route_pads_cin_to_a_multiple_of_8(cin, want):
    assert fc.padded_cin(cin) == want


def _bf16_blocks(m, n, k):
    bn, splits = fc.plan(m, n, k, k_block=fc.K_BLOCKS["bf16"])
    return -(-m // fc.TILE_M) * -(-n // bn) * splits, splits


@pytest.mark.parametrize("m,n,k", [g for g in RESNET18_GEMMS[5:]
                                   if g[2] >= 1152])
def test_bf16_plan_fills_the_card_at_stages_3_and_4(m, n, k):
    """The 3x3 convs of stages 3 and 4, 18 to 72 bf16 k-blocks deep, split
    K to within one wave of a full card."""
    blocks, splits = _bf16_blocks(m, n, k)
    assert splits > 1 and fc.SMS * 3 // 4 <= blocks <= fc.SMS


def test_bf16_plan_of_the_stage_3_and_4_downsamples():
    """The 1x1 downsamples are 2 and 4 bf16 k-blocks deep.  Stage 4's
    splits its 4 to fill the card; stage 3's keeps its 2 in 52 blocks, one
    wave, since the model prices a split of 2 k-blocks (one each, plus the
    cluster's sum) above the second k-block it saves."""
    assert _bf16_blocks(392, 512, 256) == (128, 4)
    assert _bf16_blocks(1568, 256, 128) == (52, 1)
    assert fc.plan(1568, 256, 128, k_block=fc.K_BLOCKS["bf16"]) == (64, 1)


# The bf16 route's arithmetic, emulated: bf16 operands (Cin padded with
# zeros to ``padded_cin``), each k-block's 64 products summed in f32 into
# the f32 accumulator in k order, the split's partial tiles summed in rank
# order, the epilogue in f32, one rounding.
# At ResNet18's shapes (the plan's split for batch 8) it must hold the
# limit above against the plain version; a route that kept its sums in
# bf16 between k-blocks must not.

def _patches(x: torch.Tensor, k: int, s: int, p: int) -> torch.Tensor:
    """(B·OH·OW, k·k·Cin) patch rows, k ordered (r, c, ci) as the kernel
    stages them."""
    B, H, W, C = x.shape
    oh = (H + 2 * p - k) // s + 1
    xp = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
    taps = [xp[:, r:r + s * (oh - 1) + 1:s, c:c + s * (oh - 1) + 1:s]
            for r in range(k) for c in range(k)]
    return torch.stack(taps, dim=3).reshape(B * oh * oh, k * k * C)


def _route_bf16(x, w, scale, shift, res, k, s, p, relu, splits,
                round_partials=False):
    kb = fc.K_BLOCKS["bf16"]
    pad = fc.padded_cin(x.shape[-1]) - x.shape[-1]
    x = torch.nn.functional.pad(x.float(), (0, pad))
    w = torch.nn.functional.pad(w.float(), (0, 0, 0, pad))
    P = _patches(x, k, s, p)
    Wm = w.reshape(-1, w.shape[-1])
    nk = -(-P.shape[1] // kb)
    total = None
    for part in range(splits):
        acc = torch.zeros(P.shape[0], Wm.shape[1])
        for b in range(part * nk // splits, (part + 1) * nk // splits):
            acc = acc + P[:, b * kb:(b + 1) * kb] @ Wm[b * kb:(b + 1) * kb]
            if round_partials:
                acc = acc.to(torch.bfloat16).float()
        total = acc if total is None else total + acc
    y = total * scale + shift
    if res is not None:
        y = y + res.float().reshape(y.shape)
    if relu:
        y = torch.relu(y)
    oh = (x.shape[1] + 2 * p - k) // s + 1
    return y.to(torch.bfloat16).reshape(x.shape[0], oh, oh, -1)


def _route_case(shape, round_partials=False):
    _, b, hw, cin, cout, k, s, p = shape
    rng = np.random.default_rng(hw * 100 + cin + 1)
    x = torch.from_numpy(rng.standard_normal((b, hw, hw, cin)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, k, cin, cout))
                          * (2.0 / (k * k * cin)) ** 0.5).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(cout).astype(
        np.float32))
    shift = torch.from_numpy(0.1 * rng.standard_normal(cout).astype(
        np.float32))
    oh = (hw + 2 * p - k) // s + 1
    res = torch.from_numpy(rng.standard_normal((b, oh, oh, cout)).astype(
        np.float32)).to(torch.bfloat16)
    _, splits = fc.plan(8 * oh * oh, cout, k * k * fc.padded_cin(cin),
                        k_block=fc.K_BLOCKS["bf16"])
    plain = fc_ref(x, w, scale, shift, stride=s, padding=p, residual=res)
    out = _route_bf16(x, w, scale, shift, res, k, s, p, True, splits,
                      round_partials)
    return out, plain.float().numpy()


@pytest.mark.parametrize("shape", RESNET18_SHAPES, ids=lambda s: s[0])
def test_bf16_route_arithmetic_holds_the_limit(shape):
    out, plain = _route_case(shape)
    assert out.shape == plain.shape
    _within_one_ulp(out, plain)


@pytest.mark.parametrize("shape", RESNET18_SHAPES[1:], ids=lambda s: s[0])
def test_bf16_sums_between_k_blocks_would_miss_it(shape):
    out, plain = _route_case(shape, round_partials=True)
    with pytest.raises(AssertionError):
        _within_one_ulp(out, plain)
