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
heads per block is checked here too.

The backward kernel (``csrc/mamba_scan_bwd_sm90.cu``) is emulated the same
way: its chunk of 64, its four launches (chunk sums, the passes of the
entering states and the leaving adjoints, the chunk gradients with d a_log
as the quadrant sums of (1) in its header, the sums of dB and dC over each
group of heads and then over the groups), its ten matrix products split as
the forward's, held against autograd of the plain recurrence in f32 and
against the gradient of the recurrence in f64, each gradient tensor within
ATOL·max|g|; one bf16 or one TF32 pass misses that limit."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ref import mamba_scan_ref as jax_mamba_scan_ref
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels.ref import mamba_scan_ref

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


@pytest.mark.parametrize("b,s,h,resident,want", [
    (4, 1024, 80, (264, 132), (5, 20)),    # zamba2's train shape: 1,024
                                           # and 256 blocks
    (1, 1024, 80, (264, 132), (5, 10)),    # 16 cells: 256 and 128 blocks
    (1, 1, 1, (1, 1), (1, 1)),
])
def test_backward_plan_fills_the_card(b, s, h, resident, want):
    """The backward's heads per block at chunk 64: the chunk sums at most
    BWD_SUMS_GROUP, the chunk gradients in whole waves of blocks, C·Bᵀ
    formed once for that many heads."""
    assert MS.plan_bwd(b, s, h, resident) == want


def test_more_resident_blocks_never_mean_more_heads_per_block():
    groups = [MS.heads_per_block(32, 80, r, 1.0) for r in (66, 132, 264, 528)]
    assert groups == sorted(groups, reverse=True)


# --- the backward kernel -----------------------------------------------------------

BWD_CHUNK = 64          # the backward kernel's chunk
BWD_SHAPE = (1, 512, 3, 64, 64)   # zamba2's P and N, 8 chunks
ZERO = 1e-6             # of the largest gradient: below it, rounding


def emulate_bwd(dy, dtx, a_log, Bm, Cm, *, product="bf16x3", group=None,
                quadrant=True, carry=True):
    """The SSD scan's gradient (d dtx, d a_log, dB, dC) computed as the
    backward kernel computes it: chunks of BWD_CHUNK steps (padded steps
    with a_log = 0 and zero inputs), cum summed in order, gl = e^{cum},
    gr = e^{cum_L - cum}, then
      1. per chunk dS = (gr∘X)ᵀB and L = (gl∘dY)ᵀC;
      2. the state S0 entering each chunk, forwards, and the adjoint Gh
         leaving it, backwards (``carry=False``: Gh = 0, dropping what the
         later chunks give back);
      3. E1 = D∘(C Bᵀ), E2 = D∘(dY Xᵀ) with D = [r >= k] e^{cum_r - cum_k}
         masked before the exp; dx = gr∘(B Ghᵀ) + E1ᵀ dY, each head's dB =
         gr∘(X Gh) + E2ᵀ C and dC = gl∘(dY S0) + E2 B; d a_log as the sums
         of (1) in the kernel's header, the pair terms W = [r > k]
         E1∘(dY Xᵀ) as quadrant sums (``quadrant=False``: as the reverse
         cumulative sum of the adjoint of cum instead, the usual form);
      4. dB and dC summed over the heads of each group of ``group`` (the
         wrapper's ``plan_bwd`` at an H100's resident blocks if None) in
         head order, then over the groups in group order;
    each of the ten matrix products by ``PRODUCTS[product]`` (the kernel's:
    bf16x3), every other operation in f32.  The kernel reads x_t and C_t
    for the row dots of (1) back from their split tiles, hi + lo, within
    2^-17 of each value: not emulated."""
    mm = PRODUCTS[product]
    b, s, h, p = dtx.shape
    L = BWD_CHUNK
    nc = math.ceil(s / L)
    pad = nc * L - s
    group = group or MS.plan_bwd(b, s, h)[1]

    def heads(t):       # (b, s, h, x) -> (b, nc, h, L, x)
        t = F.pad(t, [0, 0, 0, 0, 0, pad])
        return t.reshape(b, nc, L, h, -1).permute(0, 1, 3, 2, 4)

    def shared(t):      # (b, s, n) -> (b, nc, 1, L, n)
        return F.pad(t, [0, 0, 0, pad]).reshape(b, nc, 1, L, -1)

    def back(t):        # (b, nc, h, L, x) -> (b, s, h, x)
        return t.permute(0, 1, 3, 2, 4).reshape(b, nc * L, h, -1)[:, :s]
    X, dY, Bc, Cc = heads(dtx), heads(dy), shared(Bm), shared(Cm)
    a = heads(a_log[..., None])[..., 0]
    cum, run = torch.empty_like(a), torch.zeros_like(a[..., 0])
    for i in range(L):
        run = run + a[..., i]
        cum[..., i] = run
    gl, gr = torch.exp(cum), torch.exp(cum[..., -1:] - cum)
    dS = mm((gr[..., None] * X).transpose(-1, -2), Bc)
    own = mm((gl[..., None] * dY).transpose(-1, -2), Cc)
    decay = gl[..., -1, None, None]
    S0, Gh = torch.empty_like(dS), torch.zeros_like(own)
    run = torch.zeros_like(dS[:, 0])
    for c in range(nc):
        S0[:, c] = run
        run = decay[:, c] * run + dS[:, c]
    run = torch.zeros_like(own[:, 0])
    for c in reversed(range(nc)):
        if carry:
            Gh[:, c] = run
        run = decay[:, c] * run + own[:, c]
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    D = torch.exp(torch.where(tri, cum[..., :, None] - cum[..., None, :],
                              -torch.inf))
    YX = mm(dY, X.transpose(-1, -2))
    E1, E2 = D * mm(Cc, Bc.transpose(-1, -2)), D * YX
    cx, cc = mm(Bc, Gh.transpose(-1, -2)), mm(dY, S0)
    dX = gr[..., None] * cx + mm(E1.transpose(-1, -2), dY)
    dBh = gr[..., None] * mm(X, Gh) + mm(E2.transpose(-1, -2), Cc)
    dCh = gl[..., None] * cc + mm(E2, Bc)
    f = gr * (X * cx).sum(-1)                 # e^{cum_L - cum_s} x_s.(Gh B_s)
    e = gl * (Cc * cc).sum(-1)                # e^{cum_t} dy_t.(S0 C_t)
    gs = gl[..., -1:] * (Gh * S0).sum((-1, -2))[..., None]
    if quadrant:
        W = torch.where(tri & ~torch.eye(L, dtype=torch.bool), E1 * YX, 0.0)
        quad = ((torch.cumsum(W, -1) - W) * tri).sum(-2)
        e_after = torch.flip(torch.cumsum(torch.flip(e, [-1]), -1), [-1])
        da = (e_after + gs) + ((torch.cumsum(f, -1) - f) + quad)
    else:
        pairs = E1 * YX * tri
        dcum = pairs.sum(-1) - pairs.sum(-2) + e - f
        dcum[..., -1] += gs[..., 0] + f.sum(-1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])

    def head_sum(t):    # (b, s, h, n): in head order within each group,
        parts = []      # then over the groups in group order
        for g0 in range(0, h, group):
            part = t[:, :, g0]
            for j in range(g0 + 1, min(g0 + group, h)):
                part = part + t[:, :, j]
            parts.append(part)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total
    return (back(dX), back(da[..., None])[..., 0], head_sum(back(dBh)),
            head_sum(back(dCh)))


def scan_grads(args, dy, fn, dtype):
    leaves = [a.to(dtype).detach().clone().requires_grad_() for a in args]
    fn(*leaves).backward(dy.to(dtype))
    return [t.grad for t in leaves]


def grad_errors(got, want) -> list[float]:
    """Each tensor's largest error in units of its limit ATOL·max|want|,
    max|want| taken as at least ZERO of the largest of ``want``."""
    top = max(w.abs().max().item() for w in want)
    return [((g.double() - w.double()).abs().max()
             / (ATOL * max(w.abs().max().item(), ZERO * top))).item()
            for g, w in zip(got, want)]


@functools.cache
def _bwd_case(kind: str):
    """The inputs at BWD_SHAPE (zamba2's P and N, 3 heads), an output
    gradient, and the plain gradient in f32 and in f64."""
    b, s, h, p, n = BWD_SHAPE
    dtx, a_log, Bm, Cm = map(torch.from_numpy,
                             draw(23, b, s, h, p, n, kind == "long_memory"))
    if kind == "reset":
        a_log = torch.full_like(a_log, -30.0)
    args = (dtx, a_log, Bm, Cm)
    dy = torch.from_numpy(np.random.default_rng(24).standard_normal(
        dtx.shape).astype(np.float32))
    return args, dy, scan_grads(args, dy, mamba_scan_ref, torch.float32), \
        scan_grads(args, dy, mamba_scan_ref, torch.float64)


BWD_DRAWS = pytest.mark.parametrize("kind", ["fast", "long_memory", "reset"])


@pytest.fixture
def one_thread():
    """The plain recurrences' autograd is thousands of small ops, which
    gain nothing from intra-op threads and, beside other test processes,
    lose much to them: run the test on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@BWD_DRAWS
def test_backward_arithmetic_holds_the_limit(kind, one_thread):
    """Each of d dtx, d a_log, dB and dC within ATOL·max|g| of autograd of
    the plain recurrence in f32 and of the gradient in f64."""
    args, dy, g32, g64 = _bwd_case(kind)
    got = emulate_bwd(dy, *args)
    assert max(grad_errors(got, g32)) <= 1.0
    assert max(grad_errors(got, g64)) <= 1.0


@BWD_DRAWS
@pytest.mark.parametrize("product", ["bf16x1", "tf32x1"])
def test_backward_one_pass_misses_the_limit(kind, product, one_thread):
    """One bf16 or one TF32 pass in place of the split: some gradient misses
    ATOL·max|g| at least threefold on every draw (bf16 30–45-fold, TF32
    3.8–6.1-fold), where the split holds it about tenfold."""
    args, dy, g32, _ = _bwd_case(kind)
    assert max(grad_errors(emulate_bwd(dy, *args, product=product),
                           g32)) >= 3.0


def test_backward_group_sums_hold_the_limit_at_80_heads(one_thread):
    """zamba2's 80 heads at S 256: dB and dC summed over groups of the
    plan's size (3 heads, the last group of 2), in head order and then in
    group order, within the limit as every other gradient."""
    b, s, h, p, n = 1, 256, 80, 64, 64
    group = MS.plan_bwd(b, s, h)[1]
    assert 1 < group < h and h % group
    args = tuple(map(torch.from_numpy, draw(80, b, s, h, p, n, False)))
    dy = torch.from_numpy(np.random.default_rng(81).standard_normal(
        args[0].shape).astype(np.float32))
    g32 = scan_grads(args, dy, mamba_scan_ref, torch.float32)
    assert max(grad_errors(emulate_bwd(dy, *args, group=group), g32)) <= 1.0


@pytest.mark.parametrize("kind", ["fast", "long_memory"])
def test_quadrant_and_usual_forms_of_d_a_log_agree(kind, one_thread):
    """d a_log as quadrant sums (the kernel's) and as the reverse cumulative
    sum of cum's adjoint (the usual form), the products exact so that only
    the forms differ: both within 0.02 of the limit of the f64 gradient
    where d a_log is of the order of the others."""
    args, dy, _, g64 = _bwd_case(kind)
    for quadrant in (True, False):
        da = emulate_bwd(dy, *args, product="exact", quadrant=quadrant)[1]
        assert grad_errors([da], [g64[1]])[0] <= 0.02


def test_quadrant_sums_keep_a_vanishing_d_a_log(one_thread):
    """At the full reset d a_log is ~1e-12: with the products exact, the
    quadrant sums hold it within 1e-6 of itself, while the usual form's
    differences of the larger pair terms lose all of it.  (The kernel's
    split products hold it within ~1e-5 of itself, their own rounding.)"""
    args, dy, g32, g64 = _bwd_case("reset")

    def rel(quadrant, product="exact"):
        da = emulate_bwd(dy, *args, product=product, quadrant=quadrant)[1]
        return ((da.double() - g64[1]).abs().max()
                / g64[1].abs().max()).item()
    assert rel(True) <= 1e-6 and rel(False) > 0.5
    assert rel(True, "bf16x3") <= 1e-5


def test_dropped_adjoint_misses_long_memory(one_thread):
    """With Gh = 0 (nothing from the later chunks) the long-memory draw
    misses the limit by orders of magnitude: its state gradient crosses
    every chunk."""
    args, dy, g32, _ = _bwd_case("long_memory")
    assert max(grad_errors(emulate_bwd(dy, *args, carry=False), g32)) > 100


def test_backward_full_reset_is_finite_and_local(one_thread):
    """a_log = -30: every exp of a masked entry underflows to 0 and none
    overflows, so d dtx_t = (C_t.B_t) dy_t, dB_t = sum_h (dy_t.dtx_t) C_t
    and dC_t = sum_h (dy_t.dtx_t) B_t, and d a_log is below 1e-9."""
    args, dy, _, _ = _bwd_case("reset")
    dtx, _, Bm, Cm = args
    ddtx, da, dB, dC = emulate_bwd(dy, *args)
    assert all(torch.isfinite(t).all() for t in (ddtx, da, dB, dC))
    yx = (dy * dtx).sum(-1).sum(-1)[..., None]
    for got, want in ((ddtx, (Cm * Bm).sum(-1)[..., None, None] * dy),
                      (dB, yx * Cm), (dC, yx * Bm)):
        torch.testing.assert_close(got, want, atol=ATOL * want.abs().max(),
                                   rtol=0)
    assert da.abs().max() < 1e-9


@pytest.mark.parametrize("s,p,n", [(200, 33, 17), (65, 64, 64), (1, 1, 1)])
def test_backward_ragged_shapes_hold_the_limit(s, p, n, one_thread):
    """A ragged last chunk and P, N below the tile."""
    arrays = draw(s + n, 2, s, 3, p, n, True)
    args = tuple(map(torch.from_numpy, arrays))
    dy = torch.from_numpy(np.random.default_rng(s).standard_normal(
        args[0].shape).astype(np.float32))
    g32 = scan_grads(args, dy, mamba_scan_ref, torch.float32)
    assert max(grad_errors(emulate_bwd(dy, *args), g32)) <= 1.0
