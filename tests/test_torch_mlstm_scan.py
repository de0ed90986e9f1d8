"""The arithmetic of the Hopper mLSTM-scan kernel (``csrc/mlstm_scan_sm90.cu``)
emulated on the CPU, held against the JAX oracle
``repro.kernels.ref.mlstm_ref`` at the limit the card check holds the kernel
to (1e-4 per element against the plain recurrence in f32).

The emulation keeps the kernel's chunk, its four phases (the m chain and
the f64 scores, the chunk carry, state passing, chunk outputs), its
exponents (the plain recurrence's per-step exponents lf' = (log f_t +
m_{t-1}) - m_t and i' = i_t - m_t, summed over segments) and its product
split: each f32 operand of the large products as hi = tf32(v) and lo =
tf32(v - hi), each product as hi·hi + hi·lo + lo·hi summed in f32; the
scores q_t·k_s in f64, their row sums and n·q in f64.  It holds the limit on
the usual, stabiliser (i_pre·10) and long-memory (f_pre N(0, 1) + 4) draws
at xlstm-1.3b's P = 512 and prefill S = 2048, where bf16×3 products,
exponents from exact sums of log f, or a dropped carry miss it; f32 or
TF32×3 scores leave the denominator 4-7 times further from exact.  The
CUDA kernel itself is held against the plain version on the card, in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  The wrapper's
scratch sizes and refusals are checked here too.

The backward kernel (``csrc/mlstm_scan_bwd_sm90.cu``) is emulated the same
way: the plain version's exponents with f64 prefix sums; the scores q·k in
f64 and D in f64, d_t in f64 from the score tiles' row sums; the scores
and D rounded to f32; dnum·vᵀ and the products dq, dk and dv as three TF32
products; dl = M·S in f64 with its row and column sums over the very same
terms, each over the pair blocks lowest first; the m chain run backwards.
It is held against autograd of the plain recurrence in f32 and against the
gradient of the recurrence in f64 on the usual, stabiliser and long-memory
draws, forget-all and a draw where the clamp max(|n·q|, 1) holds at most
steps, each gradient tensor within ATOL·max|g|.  Treating the stabiliser
as gradient-free misses the limit there."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ref import mlstm_ref as jax_mlstm_ref
from repro_torch.kernels import mlstm_scan as ML
from repro_torch.kernels.ref import mlstm_ref as ML_REF

ATOL = 1e-4            # chip_smoke.MLSTM_ATOL: per element, against plain
B, S, H, P = 1, 2048, 2, 512   # xlstm-1.3b's P and its prefill S
SEED = 0
M0 = -1e30             # the stabiliser before the first step
DRAWS = ("usual", "stabiliser", "long_memory")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Rounds f32 to TF32's 10 mantissa bits (to nearest, ties away), as
    cvt.rna.tf32.f32."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(rnd):
    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ah, bh = rnd(a), rnd(b)
        al, bl = rnd(a - ah), rnd(b - bh)
        return ah @ bh + ah @ bl + al @ bh
    return mm


PRODUCTS = {"tf32x3": _split_mm(_tf32), "bf16x3": _split_mm(_bf16),
            "exact": lambda a, b: a @ b}


def plain_chain(i_pre, f_pre):
    """The m chain in the plain recurrence's order: m_t and its per-step
    exponents lf' and i', each (b, H, S)."""
    lf = F.logsigmoid(f_pre.float()).permute(0, 2, 1)
    ii = i_pre.float().permute(0, 2, 1)
    m = torch.full(lf.shape[:-1], M0)
    ms, lfs, iota = (torch.empty_like(lf) for _ in range(3))
    for t in range(lf.shape[-1]):
        e = lf[..., t] + m
        m = torch.maximum(e, ii[..., t])
        ms[..., t], lfs[..., t], iota[..., t] = m, e - m, ii[..., t] - m
    return ms, lfs, iota, lf, ii


def _segment_sums(step: torch.Tensor):
    """Lam[..., t, s] = sum_{s<u<=t} step_u (summed upward, one segment at
    a time, never as a difference of prefix sums) and G[..., t] =
    sum_{u<=t} step_u."""
    L = step.shape[-1]
    lam = torch.zeros(*step.shape, L)
    run, G, g = torch.zeros_like(step), torch.zeros_like(step), 0.0
    col = torch.arange(L)
    for t in range(L):
        g = g + step[..., t]
        G[..., t] = g
        run = torch.where(col < t, run + step[..., t, None], run)
        lam[..., t, :] = run
    return lam, G


def emulate(q, k, v, i_pre, f_pre, *, chunk=None, product="tf32x3",
            scores="f64", carry=True, exponents="plain", parts=False):
    """h of the mLSTM recurrence computed as the kernel computes it: chunks
    of ``chunk`` steps (the kernel's CHUNK if None; padded steps with lf'
    = 0 and i' = -1e30), then
      A. the plain version's m chain; the scores q_t·k_s in f64
         (``scores``: "f32" or "tf32x3" for one f32 or TF32×3 product);
      B. D_ts = e^{i'_s + Lam(s, t]} masked (s <= t) before the exp, D·S
         rounded to f32 for the numerator and summed in f64 for the
         denominator, g_t = e^{G_t}, the carry (w∘V)ᵀ·K with w_s =
         e^{i'_s + Lam(s, end]} and w·K;
      C. C_c = e^{G_end} C_{c-1} + carry_{c-1} (``carry=False`` drops the
         first term);
      D. acc = g_t (Q·C_cᵀ) + (D·S)·V, den = max(|rowsum + g_t n_c·q_t|, 1)
         in f64, h = acc / den;
    the large products by ``PRODUCTS[product]``.  ``exponents="log_f"``
    takes D_ts = e^{F(s, t] + i_s - m_t} (F the exact segment sums of log
    f, m the plain chain's) and the like for g, w and e^{G_end}, as a
    kernel that sums log f instead of the plain version's exponents would.
    ``parts`` returns (acc, den) instead of h."""
    mm = PRODUCTS[product]
    b, s, h, p = q.shape
    L = chunk or ML.CHUNK
    nc = math.ceil(s / L)
    pad = nc * L - s
    m, lfs, iota, lf, ii = plain_chain(i_pre, f_pre)

    def chunks(t, value=0.0):   # (b, s, ...) -> (b, nc, h, L, ...)
        t = F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad], value=value)
        t = t.reshape(b, nc, L, *t.shape[2:])
        return t.permute(0, 1, 3, 2, *range(4, t.dim()))

    def seq(t, value=0.0):      # (b, H, s) -> (b, nc, h, L)
        return chunks(t.permute(0, 2, 1), value)
    Q, K, V = (chunks(x.float()) for x in (q, k, v))
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    if exponents == "plain":
        lam, G = _segment_sums(seq(lfs))
        io = seq(iota, M0)
        expo, wexp = io[..., None, :] + lam, io + lam[..., -1, :]
        gexp, dexp = G, G[..., -1]
    else:
        lam, G = _segment_sums(seq(lf))
        ic, mc = seq(ii, M0), seq(m)
        m_in = torch.cat([torch.full_like(mc[:, :1, :, -1], M0),
                          mc[:, :-1, :, -1]], 1)[..., None]
        expo = lam + ic[..., None, :] - mc[..., :, None]
        wexp = lam[..., -1, :] + ic - mc[..., -1:]
        gexp, dexp = G + m_in - mc, G[..., -1] + m_in[..., 0] - mc[..., -1]
    f64 = torch.float64
    if scores == "f64":
        S64 = Q.to(f64) @ K.to(f64).transpose(-1, -2)
    elif scores == "tf32x3":
        S64 = PRODUCTS["tf32x3"](Q, K.transpose(-1, -2)).to(f64)
    else:
        S64 = (Q @ K.transpose(-1, -2)).to(f64)
    DS = torch.exp(torch.where(tri, expo, -torch.inf)).to(f64) * S64
    sc, rowsum = DS.float(), DS.sum(-1)
    w, decay = torch.exp(wexp), torch.exp(dexp)
    d_C = mm((w[..., None] * V).transpose(-1, -2), K)     # [p][j]
    d_n = (w[..., None] * K).sum(-2)
    C, n, C_in, n_in = torch.zeros(b, h, p, p), torch.zeros(b, h, p), [], []
    for c in range(nc):
        C_in.append(C)
        n_in.append(n)
        keep = decay[:, c] if carry else torch.zeros_like(decay[:, c])
        C = keep[..., None, None] * C + d_C[:, c]
        n = keep[..., None] * n + d_n[:, c]
    C_in, n_in = torch.stack(C_in, 1), torch.stack(n_in, 1)
    g = torch.exp(gexp)
    acc = mm(Q, C_in.transpose(-1, -2)) * g[..., None] + mm(sc, V)
    nq = (Q.to(f64) * n_in.to(f64)[..., None, :]).sum(-1)
    den = (rowsum + g.to(f64) * nq).abs().clamp_min(1.0).float()

    def unchunk(t):
        t = t.permute(0, 1, 3, 2, *range(4, t.dim()))
        return t.reshape(b, nc * L, h, *t.shape[4:])[:, :s]
    if parts:
        return unchunk(acc), unchunk(den)
    return unchunk(acc / den[..., None])


def draw(seed: int, b: int, s: int, h: int, p: int,
         kind: str) -> tuple[np.ndarray, ...]:
    """As tests/test_kernels.py draws them (q, k, v ·0.4, i_pre N(0, 1),
    f_pre N(0, 1) + 2); "stabiliser" scales i_pre by 10, "long_memory"
    shifts f_pre by 4 instead of 2 (forget gates near 0.98, so the state
    carries across every chunk)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    q, k, v = (normal((b, s, h, p), 0.4) for _ in range(3))
    i_pre = normal((b, s, h), 10.0 if kind == "stabiliser" else 1.0)
    f_pre = normal((b, s, h), 1.0, 4.0 if kind == "long_memory" else 2.0)
    return q, k, v, i_pre, f_pre


@functools.cache
def _case(kind: str):
    """The inputs at xlstm-1.3b's P and prefill S, and the JAX oracle's h."""
    arrays = draw(SEED, B, S, H, P, kind)
    ref = np.asarray(jax_mlstm_ref(*map(jnp.asarray, arrays)))
    return tuple(map(torch.from_numpy, arrays)), ref


def _err(kind: str, **kw) -> float:
    inputs, ref = _case(kind)
    return float(np.abs(emulate(*inputs, **kw).numpy() - ref).max())


@functools.cache
def _exact_den(kind: str) -> torch.Tensor:
    """max(|n_t·q_t|, 1) in f64, with the plain version's f32 exponents:
    the denominator the kernel's should equal but for its sums."""
    (q, k, _, i_pre, f_pre), _ = _case(kind)
    _, lfs, iota, _, _ = plain_chain(i_pre, f_pre)
    f_s, i_s = torch.exp(lfs).double(), torch.exp(iota).double()
    q, k = q.double(), k.double()
    n = torch.zeros(B, H, P, dtype=torch.float64)
    den = torch.empty(B, S, H, dtype=torch.float64)
    for t in range(S):
        n = f_s[..., t, None] * n + i_s[..., t, None] * k[:, t]
        den[:, t] = (n * q[:, t]).sum(-1).abs().clamp_min(1.0)
    return den


def _den_err(kind: str, **kw) -> float:
    """The largest relative error of the emulated denominator."""
    inputs, _ = _case(kind)
    _, den = emulate(*inputs, parts=True, **kw)
    exact = _exact_den(kind)
    return float(((den.double() - exact).abs() / exact).max())


@pytest.mark.parametrize("kind", DRAWS)
@pytest.mark.parametrize("chunk", [64, ML.CHUNK, 256])
def test_kernel_arithmetic_holds_the_limit(kind, chunk):
    """At the kernel's chunk and at the two it was timed against: the
    chunk was chosen for speed, and the limit holds at each."""
    assert _err(kind, chunk=chunk) <= ATOL


@pytest.mark.parametrize("kind", DRAWS)
def test_exact_products_hold_the_limit(kind):
    """The phases themselves, with f32 products: only reordered sums."""
    assert _err(kind, product="exact") <= ATOL


@pytest.mark.parametrize("kind", DRAWS)
def test_bf16x3_misses_the_limit(kind):
    """bf16×3 carries each operand to 2^-16: at |h| ~ 10-20 and 512
    columns that is too coarse (the split fused_conv and mamba_scan use)."""
    assert _err(kind, product="bf16x3") > ATOL


def test_exponents_of_summed_log_f_miss_the_stabiliser_draw():
    """Exact segment sums of log f with the plain chain's m: where the
    plain version's rounding of m drifts (i_pre·10 makes m large), its h
    drifts with it, and only its own per-step exponents follow."""
    assert _err("stabiliser", exponents="log_f") > ATOL
    assert _err("stabiliser") <= ATOL / 2


def test_dropped_carry_passes_fast_draws_but_not_long_memory():
    """A state pass with C_c = carry_{c-1}: at f_pre N(0, 1) + 2 a chunk of
    128 forgets the carried state, so the usual draw cannot see it; the
    long-memory draw misses the limit by orders of magnitude."""
    assert _err("usual", carry=False) <= ATOL
    assert _err("long_memory", carry=False) > 100 * ATOL


@pytest.mark.parametrize("kind", ["usual", "long_memory"])
@pytest.mark.parametrize("scores", ["f32", "tf32x3"])
def test_f64_scores_keep_the_denominator_exact(kind, scores):
    """n·q cancels, so the denominator carries the scores' rounding into h
    at full size (|h| ~ 20 at P = 512): f64 scores keep it within 2e-6 of
    exact (the rest is e^{sum} against a product of e's), where f32 or
    TF32×3 scores put it 4-7 times further off.  On the committed draws
    those take 60-80 % of the limit against the plain version, and on
    other seeds they miss it."""
    best = _den_err(kind)
    assert best <= 2e-6
    assert _den_err(kind, scores=scores) > 3 * best


def test_forget_all_matches_the_closed_form():
    """f_pre = -30: every step forgets, h_t = v_t (k_t·q_t) / max(|k_t·q_t|,
    1), also across chunk boundaries."""
    q, k, v, i_pre, _ = map(torch.from_numpy, draw(3, 1, 300, 2, 64, "usual"))
    f_pre = torch.full((1, 300, 2), -30.0)
    kq = (k * q).sum(-1, keepdim=True)
    expect = v * kq / kq.abs().clamp_min(1.0)
    torch.testing.assert_close(emulate(q, k, v, i_pre, f_pre), expect,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("b,s,h,p", [(2, 1000, 2, 64), (2, 37, 3, 33),
                                     (1, 1, 1, 1), (1, 300, 2, 200)])
def test_ragged_shapes_match_the_oracle(b, s, h, p):
    """A ragged last chunk and P below the tiles: zero padding and the
    padded steps' i' = -1e30 add nothing."""
    arrays = draw(s + p, b, s, h, p, "usual")
    ref = np.asarray(jax_mlstm_ref(*map(jnp.asarray, arrays)))
    out = emulate(*map(torch.from_numpy, arrays)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


# --- the wrapper's scratch --------------------------------------------------------

def test_state_floats_pad_p_to_64():
    assert ML.state_floats(512) == 512 * 512 + 512
    assert ML.state_floats(33) == 64 * 64 + 64
    assert ML.state_floats(1) == 64 * 64 + 64


@pytest.mark.parametrize("b,h,p,fits", [(1, 4, 512, True), (4, 4, 512, True),
                                        (1, 2**13, 512, False),
                                        (2**14, 2**13, 1, False)])
def test_state_pass_refuses_counts_past_32_bits(b, h, p, fits):
    """xlstm-1.3b at batch 1 and 4 fits; 2**13 heads of 512 or 2**27
    states of 64 x 64 do not."""
    assert ML.state_pass_fits(b, h, p) is fits


# --- the backward kernel -----------------------------------------------------------

BWD_SHAPE = (1, 160, 1, 512)   # xlstm-1.3b's P; S cut for the plain autograd
BWD_DRAWS = ("usual", "stabiliser", "long_memory", "forget_all", "clamp")
ZERO = 1e-6    # of the largest gradient: below it, rounding (forget-all's
               # d i_pre: i_t sets m_t and cancels)


@pytest.fixture
def one_thread():
    """The plain recurrences' autograd is thousands of small ops, which
    gain nothing from intra-op threads and, beside other test processes,
    lose much to them: run the test on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


BLK, ST = 128, 64   # the backward kernel's pair block and score tile


def _in_order(parts: torch.Tensor) -> torch.Tensor:
    """The partial sums along the last dimension added lowest first, as
    the kernel adds its tiles' and blocks' sums."""
    out = torch.zeros_like(parts[..., 0])
    for j in range(parts.shape[-1]):
        out = out + parts[..., j]
    return out


def emulate_bwd(dh, q, k, v, i_pre, f_pre, h, *, stabiliser=True,
                sums=False):
    """The mLSTM scan's gradient (dq, dk, dv, d i_pre, d f_pre) computed as
    the backward kernel computes it, from the output h, the steps padded to
    SP, a multiple of BLK:
      1. the plain version's m chain, lf' and i', the max's share w, and G
         the prefix sums of lf'_u for u >= 1 in f64; dh_t·h_t in f64;
      2. per pair the scores q_t·k_s in f64 (exact products, f64 sums) and
         D_ts = e^{i'_s + G_t - G_s} in f64 (masked, s <= t < S); the row
         sums of D (q·k) per score tile of ST columns;
      3. d_t the tiles' sums, lowest first; den_t, dd_t = -(dh_t·h_t)/den_t
         sign(d_t) where |d_t| >= 1, dnum = dh/den;
      4. S and D rounded to f32; X = dnum·Vᵀ as three TF32 products, M =
         (X + dd_t) D, W∘S = D S, dl = M S in f64, its row and column sums
         per block of BLK pairs, the blocks' sums lowest first;
      5. dq = M·K, dk = Mᵀ·Q and dv = (W∘S)ᵀ·dnum as three TF32 products;
      6. backwards over t in f64: G^m_t = w_{t+1} G^m_{t+1} - rowsum_t,
         d lf'_t = sum_{u>=t} (rowsum_u - colsum_u), d log f_t = d lf'_t +
         w_t G^m_t, d i_t = colsum_t + (1 - w_t) G^m_t, d f_pre = d log f
         σ(-f_pre).
    ``stabiliser=False`` drops the m chain's adjoint (G^m = 0); ``sums``
    returns (rowsum, colsum, dl) instead of the gradient."""
    f64, mm = torch.float64, PRODUCTS["tf32x3"]
    s = q.shape[1]
    sp = -(-s // BLK) * BLK
    m, lfs, iota, lf, ii = plain_chain(i_pre, f_pre)      # (b, H, s)
    above = lf + torch.cat([torch.full_like(m[..., :1], M0), m[..., :-1]], -1)
    w = torch.where(above > ii, 1.0, torch.where(above == ii, 0.5, 0.0))
    G = lfs.to(f64)
    G[..., 0] = 0.0
    G = F.pad(G.cumsum(-1), [0, sp - s])
    io = F.pad(iota.to(f64), [0, sp - s], value=M0)
    step = torch.arange(sp)
    vis = (step[None, :] <= step[:, None]) & (step[:, None] < s)
    D = torch.exp(torch.where(vis, io[..., None, :]
                              + (G[..., :, None] - G[..., None, :]),
                              -torch.inf))
    Q, K, V, dH, Hh = (F.pad(t.permute(0, 2, 1, 3), [0, 0, 0, sp - s])
                       for t in (q, k, v, dh, h))
    S64 = Q.to(f64) @ K.to(f64).transpose(-1, -2)
    d = _in_order((D * S64).unflatten(-1, (sp // ST, ST)).sum(-1))[..., :s]
    clamp = d.abs() < 1.0
    den = torch.where(clamp, 1.0, d.abs()).float()
    hd = (dH.to(f64) * Hh.to(f64)).sum(-1)[..., :s]
    dd = torch.where(clamp, 0.0, -(hd / den) * torch.sign(d)).float()
    dnum = dH / F.pad(den, [0, sp - s], value=1.0)[..., None]
    S32, Df = S64.float(), D.float()
    M = (mm(dnum, V.transpose(-1, -2))
         + F.pad(dd, [0, sp - s])[..., None]) * Df
    dl = M.to(f64) * S32.to(f64)
    rowsum = _in_order(dl.unflatten(-1, (sp // BLK, BLK)).sum(-1))[..., :s]
    colsum = _in_order(dl.unflatten(-2, (sp // BLK, BLK)).sum(-2)
                       .transpose(-1, -2))[..., :s]
    if sums:
        return rowsum, colsum, dl
    dq, dk = mm(M, K), mm(M.transpose(-1, -2), Q)
    dv = mm((Df * S32).transpose(-1, -2), dnum)
    dlf, di = torch.empty_like(rowsum), torch.empty_like(rowsum)
    carry, quad = torch.zeros_like(rowsum[..., 0]), torch.zeros_like(d[..., 0])
    wd = w.to(f64) if stabiliser else torch.zeros_like(rowsum)
    for t in reversed(range(s)):
        gm = carry - rowsum[..., t] if stabiliser else torch.zeros_like(carry)
        quad = quad + (rowsum[..., t] - colsum[..., t])
        dlf[..., t] = quad + wd[..., t] * gm
        di[..., t] = colsum[..., t] + (1 - wd[..., t]) * gm
        carry = wd[..., t] * gm
    df = dlf.float() * torch.sigmoid(-f_pre.float().permute(0, 2, 1))

    def back(t):
        return t[:, :, :s].permute(0, 2, 1, *range(3, t.dim()))
    return back(dq), back(dk), back(dv), back(di.float()), back(df)


def grad_errors(got, want) -> list[float]:
    """Each tensor's largest error in units of its limit ATOL·max|want|,
    max|want| taken as at least ZERO of the largest of ``want``."""
    top = max(w.abs().max().item() for w in want)
    return [((g.double() - w.double()).abs().max()
             / (ATOL * max(w.abs().max().item(), ZERO * top))).item()
            for g, w in zip(got, want)]


@functools.cache
def _bwd_case(kind: str):
    """The inputs at BWD_SHAPE, dh, h and the plain gradient in f32 and
    f64.  ``forget_all`` sets f_pre = -30; ``clamp`` scales q and k by 0.1,
    so |n·q| < 1 at most steps."""
    b, s, h, p = BWD_SHAPE
    q, k, v, i_pre, f_pre = map(torch.from_numpy, draw(
        SEED + 1, b, s, h, p, kind if kind in DRAWS else "usual"))
    if kind == "forget_all":
        f_pre = torch.full_like(f_pre, -30.0)
    if kind == "clamp":
        q, k = q * 0.1, k * 0.1
    args = (q, k, v, i_pre, f_pre)
    dh = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(
        q.shape).astype(np.float32))

    def grads(fn, dtype):
        leaves = [a.to(dtype).clone().requires_grad_() for a in args]
        out = fn(*leaves)
        out.backward(dh.to(dtype))
        return [t.grad for t in leaves], out.detach()
    g32, out = grads(ML_REF, torch.float32)
    return args, dh, out, g32, grads(ML_REF, torch.float64)[0]


@pytest.mark.parametrize("kind", BWD_DRAWS)
def test_backward_arithmetic_holds_the_limit(kind, one_thread):
    """Each of dq, dk, dv, d i_pre and d f_pre within ATOL·max|g| of
    autograd of the plain recurrence in f32 and of the gradient in f64."""
    args, dh, h, g32, g64 = _bwd_case(kind)
    got = emulate_bwd(dh, *args, h)
    assert max(grad_errors(got, g32)) <= 1.0
    assert max(grad_errors(got, g64)) <= 1.0


def test_clamp_draw_clamps_at_most_steps_the_usual_at_some(one_thread):
    """The clamp draw has |n·q| < 1 at most steps; the usual draw at some
    (14%), so its gates' gradients go through the m chain too."""
    def share(kind):
        args, *_ = _bwd_case(kind)
        q, k, _, i_pre, f_pre = args
        _, den = emulate(q, k, q, i_pre, f_pre, parts=True)
        return (den == 1.0).float().mean().item()
    assert share("clamp") > 0.5 > share("usual") > 0.05


@pytest.mark.parametrize("kind", ["usual", "clamp"])
def test_gradient_free_stabiliser_misses_the_limit(kind, one_thread):
    """Dropping the m chain's adjoint: the gates' gradients miss the limit
    wherever the clamp holds at some step."""
    args, dh, h, g32, _ = _bwd_case(kind)
    got = emulate_bwd(dh, *args, h, stabiliser=False)
    assert max(grad_errors(got, g32)[3:]) > 10


def test_row_and_column_sums_add_the_same_terms(one_thread):
    """d lf' is the difference of dl's row and column sums summed over t:
    taken over the same f64 terms, their totals agree to f64 rounding;
    over the terms rounded to f32 (as column sums of recomputed f32
    products would take them) they are 10^3 times further apart."""
    args, dh, h, *_ = _bwd_case("usual")
    rowsum, colsum, dl = emulate_bwd(dh, *args, h, sums=True)
    scale = dl.abs().sum().item()
    gap = abs(rowsum.sum().item() - colsum.sum().item())
    assert gap <= 1e-13 * scale
    f32_gap = abs(rowsum.sum().item() - dl.float().double().sum().item())
    assert f32_gap > 1e3 * max(gap, 1e-13 * scale)


@pytest.mark.parametrize("b,s,h,p", [(2, 40, 3, 48), (1, 1, 1, 1)])
def test_backward_ragged_shapes_hold_the_limit(b, s, h, p, one_thread):
    q, k, v, i_pre, f_pre = map(torch.from_numpy,
                                draw(SEED + s, b, s, h, p, "usual"))
    dh = torch.from_numpy(np.random.default_rng(s).standard_normal(
        q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i_pre, f_pre)]
    out = ML_REF(*leaves)
    out.backward(dh)
    got = emulate_bwd(dh, q, k, v, i_pre, f_pre, out.detach())
    assert max(grad_errors(got, [t.grad for t in leaves])) <= 1.0
