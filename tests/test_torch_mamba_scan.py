"""The arithmetic of the Hopper SSD-scan kernel (``csrc/mamba_scan_sm90.cu``)
emulated on the CPU, held against the JAX oracle
``repro.kernels.ref.mamba_scan_ref`` at the limit the card check holds the
kernel to (1e-4 per element against the plain recurrence).

The emulation keeps the kernel's chunk, its three phases (chunk states,
state passing, chunk outputs) and its product split: each f32 operand as
hi = bf16(v) and lo = bf16(v - hi), each product as hi·hi + hi·lo + lo·hi
summed in f32.  It shows that the split holds the limit where one bf16 or
one TF32 pass misses it, and that the long-memory draw catches a state pass
that drops the carried state, which the fast draws cannot.  The CUDA kernel
itself is held against the plain version on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The wrapper's plan of
heads per block is checked here too."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro_torch.kernels import mamba_scan as MS

ATOL = 1e-4            # chip_smoke.SCAN_ATOL: per element, against plain
B, S, H, P, N = 1, 4096, 2, 64, 64   # zamba2's P and N and its prefill S
LONG_DT = (1e-3, 0.1)  # the Mamba2 paper's range for the step Δ
LONG_A = (1.0, 16.0)   # the model's A = linspace(1, 16) over the heads


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Rounds f32 to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return ah @ bh + ah @ bl + al @ bh


PRODUCTS = {
    "bf16x3": _split_mm,
    "bf16x1": lambda a, b: _bf16(a) @ _bf16(b),
    "tf32x1": lambda a, b: _tf32(a) @ _tf32(b),
    "exact": lambda a, b: a @ b,
}


def emulate(dtx, a_log, Bm, Cm, *, chunk=None, product="bf16x3",
            carry=True, factored=False):
    """y of the SSD recurrence computed as the kernel computes it: chunks
    of ``chunk`` steps (the wrapper's ``chunk_for(S)`` if None;
    zero-padded), then
      1. dS_c = (w ∘ X)ᵀ·B with w_s = e^{cum_last − cum_s}, and e^{A_c};
      2. S_c = e^{A_{c−1}}·S_{c−1} + dS_{c−1} (``carry=False`` drops the
         first term: S_c = dS_{c−1});
      3. y = (e^{cum_t}·C)·S_cᵀ + (C·Bᵀ ∘ e^{cum_t − cum_s}, s ≤ t)·X, the
         exp masked before it is taken (``factored`` takes e^{cum_t}·
         e^{−cum_s} instead, which the kernel must not);
    every product by ``PRODUCTS[product]``, every other operation in the
    inputs' dtype."""
    mm = PRODUCTS[product]
    b, s, h, p = dtx.shape
    chunk = chunk or MS.chunk_for(s)
    nc = math.ceil(s / chunk)
    pad = nc * chunk - s

    def chunks(t):   # (b, s, ...) -> (b, nc, chunk, ...)
        t = torch.nn.functional.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
        return t.reshape(b, nc, chunk, *t.shape[2:])
    X = chunks(dtx).permute(0, 1, 3, 2, 4)              # b nc h Q p
    cum = torch.cumsum(chunks(a_log).permute(0, 1, 3, 2), -1)   # b nc h Q
    Bc, Cc = chunks(Bm)[:, :, None], chunks(Cm)[:, :, None]    # b nc 1 Q n
    last = cum[..., -1:]

    d_state = mm((torch.exp(last - cum)[..., None] * X).transpose(-1, -2),
                 Bc)                                    # b nc h p n
    decay = torch.exp(last)[..., None]                  # b nc h 1 1
    state = torch.zeros_like(d_state[:, 0])
    entering = []
    for c in range(nc):
        entering.append(state)
        state = (decay[:, c] * state if carry else 0) + d_state[:, c]
    entering = torch.stack(entering, 1)

    tri = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    if factored:
        gate = torch.exp(cum)[..., :, None] * torch.exp(-cum)[..., None, :]
        gate = torch.where(tri, gate, 0.0)
    else:
        gate = torch.exp(torch.where(tri, diff, -torch.inf))
    scores = mm(Cc, Bc.transpose(-1, -2)) * gate        # b nc h Q Q
    y = mm(torch.exp(cum)[..., None] * Cc, entering.transpose(-1, -2)) \
        + mm(scores, X)
    return y.permute(0, 1, 3, 2, 4).reshape(b, nc * chunk, h, p)[:, :s]


def draw(seed: int, b: int, s: int, h: int, p: int, n: int,
         long_memory: bool) -> tuple[np.ndarray, ...]:
    """As tests/test_kernels.py draws them (dtx·0.3, a_log = −softplus(N(0,
    1)), B and C ·0.3), or with long-memory decays: a_log = −Δ·A, Δ
    log-uniform in LONG_DT per step and head, A = linspace(LONG_A) over the
    heads."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    dtx = normal((b, s, h, p), 0.3)
    if long_memory:
        dt = np.exp(rng.uniform(*np.log(LONG_DT), (b, s, h)))
        a_log = (-dt * np.linspace(*LONG_A, h)).astype(np.float32)
    else:
        a_log = -np.logaddexp(0.0, normal((b, s, h), 1.0)).astype(np.float32)
    return dtx, a_log, normal((b, s, n), 0.3), normal((b, s, n), 0.3)


@functools.cache
def _case(long_memory: bool):
    """The inputs at zamba2's P, N and prefill S, and the JAX oracle's y."""
    arrays = draw(17, B, S, H, P, N, long_memory)
    ref = np.asarray(jax_mamba_scan_ref(*map(jnp.asarray, arrays)))
    return tuple(map(torch.from_numpy, arrays)), ref


def _err(long_memory: bool, **kw) -> float:
    inputs, ref = _case(long_memory)
    return float(np.abs(emulate(*inputs, **kw).numpy() - ref).max())


DRAWS = pytest.mark.parametrize("long_memory", [False, True],
                                ids=["fast", "long_memory"])


@DRAWS
@pytest.mark.parametrize("chunk", MS.BUILT_CHUNKS)
def test_split_products_hold_the_limit(long_memory, chunk):
    assert _err(long_memory, chunk=chunk) <= ATOL


@DRAWS
@pytest.mark.parametrize("product", ["bf16x1", "tf32x1"])
def test_one_pass_misses_the_limit(long_memory, product):
    assert _err(long_memory, product=product) > ATOL


@DRAWS
def test_exact_products_match_the_oracle(long_memory):
    """The phases themselves, with f32 products: only reordered sums and
    e^{Σa} for a product of e^{a} over up to a chunk (1e-5 at the fast
    draws), well inside the limit."""
    assert _err(long_memory, product="exact") <= ATOL / 4


def test_dropped_carry_passes_fast_decays_but_not_long_memory():
    """A state pass with S_c = dS_{c−1}: at a ≈ −0.8 a step a chunk of 128
    decays the carried state by e^{-100}, so the fast draws cannot see it;
    the long-memory draw misses the limit by orders of magnitude."""
    assert _err(False, carry=False) <= ATOL
    assert _err(True, carry=False) > 100 * ATOL


def test_factored_decay_overflows():
    """e^{cum_t}·e^{−cum_s} in place of e^{cum_t − cum_s}: cum reaches −100
    in a chunk of 128 at the fast draws and e^{100} overflows f32."""
    inputs, _ = _case(False)
    assert not torch.isfinite(emulate(*inputs, factored=True)).all()
    assert torch.isfinite(emulate(*inputs)).all()


def test_full_reset_underflows_to_the_closed_form():
    """a_log = −30: e^{cum} underflows to 0 and y_t = (C_t·B_t)·dtx_t."""
    dtx, _, Bm, Cm = map(torch.from_numpy, draw(3, 1, 300, 3, 16, 8, False))
    a_log = torch.full((1, 300, 3), -30.0)
    expect = (Cm * Bm).sum(-1)[..., None, None] * dtx
    torch.testing.assert_close(emulate(dtx, a_log, Bm, Cm), expect,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("s,p,n", [(1000, 64, 64), (37, 33, 17), (1, 1, 1)])
def test_ragged_shapes_match_the_oracle(s, p, n):
    """A ragged last chunk and P, N below the tile: zero padding adds
    nothing."""
    arrays = draw(s + p, 2, s, 3, p, n, True)
    ref = np.asarray(jax_mamba_scan_ref(*map(jnp.asarray, arrays)))
    out = emulate(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# --- the wrapper's plan ----------------------------------------------------------

def test_plan_fills_the_card_at_the_prefill():
    """zamba2's prefill (b 1, S 4096, H 80) on an H100 that holds two
    blocks of phase 1 and one of phase 3 per SM: phase 1 takes 10 heads a
    block (256 blocks, one wave of 264), phase 3 20 (128 blocks for 132
    SMs), so C·Bᵀ is formed once for 20 heads."""
    assert MS.chunk_for(4096) == 128
    assert MS.plan(1, 4096, 80, 128, (264, 132)) == (10, 20)


@pytest.mark.parametrize("b,s,h,resident", [
    (1, 4096, 80, (264, 132)), (4, 64, 80, (264, 132)),
    (1, 1000, 80, (396, 396)), (2, 37, 5, (264, 132)), (1, 1, 1, (1, 1)),
    (1, 65536, 80, (264, 132)),
])
def test_plan_stays_in_bounds(b, s, h, resident):
    chunk = MS.chunk_for(s)
    assert chunk in MS.BUILT_CHUNKS
    for phase, g in zip((1, 3), MS.plan(b, s, h, chunk, resident)):
        assert 1 <= g <= min(h, MS.MAX_GROUP)
        waves = math.ceil(b * math.ceil(s / chunk) * math.ceil(h / g)
                          / resident[phase // 2])
        assert waves >= 1


def test_more_resident_blocks_never_mean_more_heads_per_block():
    groups = [MS.heads_per_block(32, 80, r, 1.0) for r in (66, 132, 264, 528)]
    assert groups == sorted(groups, reverse=True)
