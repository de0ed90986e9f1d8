"""The flash-attention backward kernels' arithmetic on the CPU.

``csrc/flash_attention_bwd_sm90.cu`` (bf16 at every head dim, ``wgmma``)
and ``csrc/flash_attention_bwd.cu`` (f32, CUDA cores) run only on the
card; this file emulates them in torch, step by step as they walk their
tiles: the forward kernel's online softmax over its key tiles, which saves
each row's log-sum-exp (and, in bf16, O's lo part); D_i = rowsum(dO∘O)
from the f32-accurate O.  Both kernels walk in one pass: per key tile of a
KV head (``backward_tiles``: ``wgmma`` 128 keys, 64 at D = 128 and 256;
f32 128 up to D = 64, 64 at D = 80 and 96, 32 above), the group's query
heads and their visible query tiles (64 queries; f32 32 at D = 256;
``tc_query_tiles``); per step S^T and dP^T once, dV and dK accumulated,
and the dQ parts (``wgmma`` one per 64 keys, f32 one per half of the tile)
added into the query tile's f32 sum in the fixed order of the key tiles
(``tc_key_tiles``, ``dq_order``; ``wgmma`` highest first, at D = 256 and in
f32 lowest first), each tile's parts in turn; at D = 256 dK and dV leave
their accumulators for an f32 sum every 32 steps.  In bf16 P and dS split
into hi + lo bf16, each product summed in f32 sixteen rows at a time, hi
then lo, as the tensor cores take them.  The emulation is held against
``jax.grad`` of the JAX package's ``attention_scores`` (the arithmetic JAX
trains through) at causal, windowed, softcapped, GQA, non-causal cross and
ragged shapes and at every head dim:

* f32: each element within 1e-5·max|ref|;
* bf16: bf16 gradients, each within half a bf16 ulp (2^-8 relative) plus
  2e-5 of the gradient in f32 of the same bf16 values.

The one-pass kernels' tile walk is held against the visible pairs at each
of their tiles, and their dQ orders against their launch orders (no wait
on a CTA launched later).  The
emulated log-sum-exp is held against ``torch.logsumexp`` of the masked,
softcapped logits, and ``FlashAttention`` runs with the emulation injected
as its ``backward_fn``.  Inputs come from a numpy seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import (NEG_INF, _visible, attention_ref,
                                     attention_ref_grad)

F32_RTOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0**-8, 2e-5
LOG2E = 1.4426950408889634
TC_BQ = 64         # the wgmma kernel: queries a step
TC_FLUSH = 32      # the wgmma kernel at D = 256: steps a dK, dV run takes


def forward_key_tile(D: int, dtype: torch.dtype) -> int:
    """Keys a step of the forward kernel's online softmax at head dim D
    (``Tiles<D>::BK`` of ``csrc/flash_attention_sm90.cu`` in bf16 and of
    ``csrc/flash_attention.cu`` in f32: 128 up to D = 64, 64 up to D = 128,
    32 at D = 256)."""
    if dtype == torch.bfloat16:
        return 64 if D in (128, 256) else 128
    return 128 if D <= 64 else 64 if D <= 128 else 32


def backward_tiles(D: int, dtype: torch.dtype) -> tuple[int, int]:
    """(BK, BQ) of the one-pass backward kernels at head dim D: the keys a
    CTA owns and the queries a step.  ``wgmma`` (bf16): ``tc_key_tile(D)``
    keys, 64 queries; f32 (``csrc/flash_attention_bwd.cu``'s
    ``Tiles<D>``): 128 x 64 up to D = 64, 64 x 64 at D = 80 and 96, 32 x
    64 at D = 128, 32 x 32 at D = 256."""
    if dtype == torch.bfloat16:
        return tc_key_tile(D), TC_BQ
    bk = 128 if D <= 64 else 64 if D <= 96 else 32
    return bk, 32 if D == 256 else 64


def tc_key_tile(D: int) -> int:
    """Keys a CTA of the ``wgmma`` kernel owns at head dim D (``Tiles<D>::
    BK``): 128, 64 a consumer; at D = 128 and 256, 64, the consumers
    splitting D."""
    return 64 if D >= 128 else 128


def tc_query_tiles(kt: int, S: int, T: int, causal: bool, window: int,
                   bk: int, bq: int = TC_BQ) -> range:
    """The ``bq``-query tiles that ``bk``-key tile ``kt`` walks (the one-pass
    kernels' ``q_lo``, ``q_hi``)."""
    k0, n_q = kt * bk, -(-S // bq)
    lo, hi = 0, n_q
    if causal:
        lo = k0 // bq if k0 <= S - 1 else n_q
    if window:
        k_max = min(k0 + bk - 1, T - 1)
        hi = min(hi, (k_max + window - 1) // bq + 1)
    return range(lo, max(lo, hi))


def tc_key_tiles(i: int, S: int, T: int, causal: bool, window: int,
                 bk: int, bq: int = TC_BQ) -> range:
    """The ``bk``-key tiles that add to ``bq``-query tile ``i``'s dQ (the
    one-pass kernels' ``kt_lo``, ``kt_hi``); they add from the last to the
    first."""
    q0, n_kt = i * bq, -(-T // bk)
    q_max = min(q0 + bq - 1, S - 1)
    hi = min(n_kt, q_max // bk + 1) if causal else n_kt
    lo = max(0, q0 - window + 1) // bk if window else 0
    return range(lo, hi)


def dq_order(D: int, dtype: torch.dtype) -> str:
    """The one-pass kernels' dQ order at head dim D: ``high`` (``wgmma``
    below D = 256: the highest key tile launched and adding first, query
    tiles walked upward, the group's heads outer), ``low_inner``
    (``wgmma`` at D = 256: the lowest first, query tiles walked downward,
    the heads inner on each) or ``low`` (f32: the lowest first, walked
    downward, the heads outer)."""
    if dtype == torch.bfloat16:
        return "low_inner" if D == 256 else "high"
    return "low"


def walk_steps(order: str, kt: int, group: int, S: int, T: int,
               causal: bool, window: int, bk: int, bq: int
               ) -> list[tuple[int, int]]:
    """Key tile ``kt``'s steps, (query head of the group, query tile), in
    the walk of ``order`` (``dq_order``)."""
    tiles = list(tc_query_tiles(kt, S, T, causal, window, bk, bq))
    if order == "low_inner":
        return [(g, i) for i in tiles[::-1] for g in range(group)]
    return [(g, i) for g in range(group)
            for i in (tiles[::-1] if order == "low" else tiles)]


# name, B, H, KV, S, T, D, causal, window, softcap: the shapes of
# tests/test_torch_flash_grad.py, then ragged S and T (not multiples of any
# tile), a cross shape past one key block, and one case a head dim.
SHAPES = [
    ("causal", 2, 4, 4, 24, 24, 16, True, 0, 0.0),
    ("window", 1, 4, 4, 40, 40, 16, True, 8, 0.0),
    ("softcap", 2, 2, 2, 17, 17, 32, True, 0, 50.0),
    ("window_softcap", 1, 4, 2, 33, 33, 16, True, 6, 30.0),
    ("gqa_4to1", 2, 8, 2, 20, 20, 16, True, 0, 0.0),
    ("cross_noncausal", 2, 4, 4, 9, 30, 16, False, 0, 0.0),
    ("ragged_causal", 1, 2, 2, 77, 77, 32, True, 0, 0.0),
    ("ragged_window_gqa", 1, 4, 2, 150, 150, 16, True, 37, 0.0),
    ("cross_ragged_long", 1, 2, 2, 70, 150, 16, False, 0, 0.0),
    ("causal_cross_s_lt_t", 1, 2, 1, 70, 150, 32, True, 0, 0.0),
    ("noncausal_s_gt_t", 1, 2, 2, 90, 33, 16, False, 0, 0.0),
    # gemma2-2b's heads (8 query and 4 KV heads of 256, softcap 50), its
    # local layers' window biting at this length: four 64-key tiles
    ("gemma2_heads_window", 1, 8, 4, 200, 200, 256, True, 70, 50.0),
    # paligemma-3b's heads (8 query heads on one KV head of 256): key tile
    # 0 walks 40 steps, so at D = 256 its dK and dV flush once
    ("paligemma_heads", 1, 8, 1, 300, 300, 256, True, 0, 0.0),
] + [(f"d{d}", 1, 2, 1, 40, 40, d, True, 0, 0.0)
     for d in FA.HEAD_DIMS]


def _inputs(shape, seed):
    _, B, H, KV, S, T, D, *_ = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _flat(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """(B, S, H, D) → the kernel's (B·H, S, D)."""
    B, S, H, D = x.shape
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D) \
        .contiguous().to(dtype)


def _unflat(x: torch.Tensor, B: int) -> np.ndarray:
    BH, S, D = x.shape
    return x.reshape(B, BH // B, S, D).permute(0, 2, 1, 3).float().numpy()


def _jax_grads(shape, q, k, v, do):
    _, B, H, KV, S, T, D, causal, window, softcap = shape
    mask = _visible(S, T, causal, window, "cpu").numpy()

    def f(q_, k_, v_):
        o = JL.attention_scores(q_, k_, v_, jnp.asarray(mask[None]), softcap)
        return jnp.sum(o * do)
    return [np.asarray(g) for g in
            jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))]


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """hi = bf16(x), lo = bf16(x - hi), both back in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _rows(x: torch.Tensor, r0: int, n: int) -> torch.Tensor:
    """Rows [r0, r0 + n) of x (rows, D) as f32, rows past the end zeros."""
    out = torch.zeros(n, x.shape[1])
    got = x[r0:r0 + n].float()
    out[:got.shape[0]] = got
    return out


def _product(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor,
             split: bool) -> torch.Tensor:
    """acc + a @ b as the kernels sum it: in bf16 a (f32) as hi + lo, over
    the contraction sixteen at a time, hi then lo; in f32 at once."""
    if not split:
        return acc + a @ b
    hi, lo = _split(a)
    for c in range(0, a.shape[1], 16):
        acc = acc + hi[:, c:c + 16] @ b[c:c + 16]
        acc = acc + lo[:, c:c + 16] @ b[c:c + 16]
    return acc


def _logits(s: torch.Tensor, scale: float, softcap: float):
    """The logit x of raw scores s and dx/ds, through softcap and scale."""
    if softcap:
        t = torch.tanh(s * (scale / softcap))
        return softcap * t, (1 - t * t) * scale
    return s * scale, torch.full_like(s, scale)


def emulate_forward(q, k, v, *, causal, window, softcap):
    """The forward kernel's online softmax over its key tiles, per query
    head: returns O in f32, its lse (BH, S) and, in bf16, O as the kernel
    rounds it (hi) and its lo part."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    bf16 = q.dtype == torch.bfloat16
    BK = forward_key_tile(D, q.dtype)
    scale = 1 / math.sqrt(D)
    mask = _visible(S, T, causal, window, "cpu")
    o = torch.zeros(BH, S, D)
    lse = torch.zeros(BH, S)
    for bh in range(BH):
        qf, kf, vf = q[bh].float(), k[bh // G].float(), v[bh // G].float()
        m = torch.full((S,), NEG_INF)
        l, acc = torch.zeros(S), torch.zeros(S, D)
        for kb in range(0, T, BK):
            s = qf @ kf[kb:kb + BK].T
            x, _ = _logits(s, scale, softcap)
            x = torch.where(mask[:, kb:kb + BK], x, NEG_INF)
            mx = torch.maximum(m, x.max(dim=1).values)
            p = torch.exp(x - mx[:, None])
            alpha = torch.exp(m - mx)
            l = l * alpha + p.sum(dim=1)
            acc = _product(p, vf[kb:kb + BK], acc * alpha[:, None], bf16)
            m = mx
        o[bh] = acc / l[:, None]
        lse[bh] = m + torch.log(l)
    if bf16:
        hi, lo = o.bfloat16(), (o - o.bfloat16().float()).bfloat16()
        return o, lse, hi, lo
    return o, lse, o, None


def emulate_backward(q, k, v, out, lse, dout, *, out_lo=None, causal=True,
                     window=0, softcap=0.0, rounded=True):
    """dq, dk, dv as the backward kernels compute them, from the forward's
    out (in bf16 with out_lo) and lse: D_i, then the kernels' walk
    (``emulate_walk``).  In the inputs' dtype, or the f32 accumulators
    where not ``rounded``."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    bf16 = q.dtype == torch.bfloat16
    scale = 1 / math.sqrt(D)
    o = out.float() + (out_lo.float() if bf16 else 0)
    di = (dout.float() * o).sum(dim=-1)                       # (a)
    mask = _visible(S, T, causal, window, "cpu")

    def grad_tile(s, dp, keys, queries, lse_t, di_t):
        """P^T and dS^T of a tile of raw scores S^T (keys by queries),
        masked where not visible; lse and D_i index the columns."""
        x, dx = _logits(s, scale, softcap)
        p = torch.exp2(x * LOG2E - lse_t[None, :] * LOG2E)
        vis = torch.zeros(s.shape, dtype=torch.bool)
        q_ok, k_ok = queries[queries < S], keys[keys < T]
        vis[:len(k_ok), :len(q_ok)] = mask[q_ok[:, None], k_ok[None, :]].T
        p = torch.where(vis, p, 0.0)
        return p, p * (dp - di_t[None, :]) * dx

    dt = q.dtype if rounded else torch.float32
    bk, bq = backward_tiles(D, q.dtype)
    grads = emulate_walk(q, k, v, dout, lse, di, grad_tile, causal=causal,
                         window=window, bk=bk, bq=bq,
                         part=64 if bf16 else bk // 2, split=bf16,
                         order=dq_order(D, q.dtype),
                         flush=TC_FLUSH if bf16 and D == 256 else 0)
    return tuple(g.to(dt) for g in grads)


def emulate_walk(q, k, v, dout, lse, di, grad_tile, *, causal, window, bk,
                 bq, part, split, order, flush=0):
    """The one-pass kernels' walk, in f32: per (``bk``-key tile, KV head),
    the group's query heads and their ``bq``-query tiles in the walk of
    ``order`` (``walk_steps``); per step and ``part`` keys of the tile
    (``wgmma``: a consumer warpgroup's 64, and at D = 128 the consumers share
    them and split the columns, which sums the same terms in the same order;
    f32: a consumer group's half of the dQ product) S^T, dP^T, P^T and dS^T, dV
    += P^T.dO and dK += dS^T.Q, and the dQ part dS.K (with ``split``, hi + lo,
    16 keys a product); then per query tile the key tiles' parts added in the
    kernel's order (``high`` the highest key tile first, else the lowest), each
    tile's parts in turn, the first stored.  With ``flush`` (``wgmma`` at D =
    256), dK and dV leave their accumulators for a sum every ``flush`` steps
    but the last, and the last run is added to that sum."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    chunks = bk // part
    dk, dv = torch.zeros(BKV, T, D), torch.zeros(BKV, T, D)
    parts: dict[tuple[int, int], list[tuple[int, torch.Tensor]]] = {}
    for kvh in range(BKV):
        for kt in range(-(-T // bk)):
            acc_k = [torch.zeros(part, D) for _ in range(chunks)]
            acc_v = [torch.zeros(part, D) for _ in range(chunks)]
            walk = walk_steps(order, kt, G, S, T, causal, window, bk, bq)
            sum_k = sum_v = None
            for n, (g, i) in enumerate(walk):
                bh = kvh * G + g
                q0 = i * bq
                qt, ot = _rows(q[bh], q0, bq), _rows(dout[bh], q0, bq)
                lse_t = _rows(lse[bh][:, None], q0, bq)[:, 0]
                di_t = _rows(di[bh][:, None], q0, bq)[:, 0]
                got = []
                for c in range(chunks):
                    kc0 = kt * bk + part * c
                    kc, vc = (_rows(x[kvh], kc0, part) for x in (k, v))
                    p, ds = grad_tile(kc @ qt.T, vc @ ot.T,
                                      torch.arange(kc0, kc0 + part),
                                      torch.arange(q0, q0 + bq),
                                      lse_t, di_t)
                    acc_v[c] = _product(p, ot, acc_v[c], split)
                    acc_k[c] = _product(ds, qt, acc_k[c], split)
                    got.append(_product(ds.T, kc, torch.zeros(bq, D),
                                        split))
                parts.setdefault((bh, i), []).append((kt, got))
                if flush and n % flush == flush - 1 and n != len(walk) - 1:
                    sum_k = acc_k if sum_k is None else [
                        a + b for a, b in zip(sum_k, acc_k)]
                    sum_v = acc_v if sum_v is None else [
                        a + b for a, b in zip(sum_v, acc_v)]
                    acc_k = [torch.zeros(part, D) for _ in range(chunks)]
                    acc_v = [torch.zeros(part, D) for _ in range(chunks)]
            if sum_k is not None:
                acc_k = [a + b for a, b in zip(sum_k, acc_k)]
                acc_v = [a + b for a, b in zip(sum_v, acc_v)]
            for c in range(chunks):
                kc0 = kt * bk + part * c
                n = max(0, min(part, T - kc0))
                dk[kvh, kc0:kc0 + n] = acc_k[c][:n]
                dv[kvh, kc0:kc0 + n] = acc_v[c][:n]
    dq = torch.zeros(BH, S, D)
    highest_first = order == "high"
    for (bh, i), got in parts.items():
        added = sorted(got, key=lambda tile: -tile[0] if highest_first
                       else tile[0])
        tiles = list(tc_key_tiles(i, S, T, causal, window, bk, bq))
        assert [kt for kt, _ in added] == \
            (tiles[::-1] if highest_first else tiles)
        in_order = [h for _, tile in added for h in tile]
        acc = in_order[0]
        for h in in_order[1:]:
            acc = acc + h
        n = min(bq, S - i * bq)
        dq[bh, i * bq:i * bq + n] = acc[:n]
    return dq, dk, dv


def _case(shape, dtype, seed):
    """Inputs in ``dtype`` (the kernel's layout), the emulated forward and
    backward, and the numpy inputs rounded to ``dtype`` for JAX."""
    q, k, v, do = (_flat(a).to(dtype) for a in _inputs(shape, seed))
    _, B, *_, causal, window, softcap = shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    o32, lse, out, out_lo = emulate_forward(q, k, v, **kw)
    grads = emulate_backward(q, k, v, out, lse, do, out_lo=out_lo, **kw)
    as_np = [_unflat(t, B) for t in (q, k, v, do)]
    return (q, k, v, do), (o32, lse, out, out_lo), grads, as_np, kw


@pytest.fixture
def one_thread():
    """The emulation walks hundreds of small tiles, which gain nothing from
    intra-op threads and, beside other test processes, lose much to them:
    run the test on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _held(got: torch.Tensor, ref: np.ndarray, B: int, dtype,
          what: str) -> None:
    g = _unflat(got, B)
    if dtype == torch.float32:
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=F32_RTOL * np.abs(ref).max(),
                                   err_msg=what)
    else:
        assert got.dtype == torch.bfloat16
        err = np.abs(g - ref)
        worst = (err / (BF16_RTOL * np.abs(ref) + BF16_ATOL)).max()
        assert worst <= 1.0, f"{what}: {worst:.3f} of the limit"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_emulated_backward_matches_jax_grad(shape, dtype, one_thread):
    """The backward kernels' arithmetic against ``jax.grad`` of
    ``attention_scores`` on the same (in bf16: the same rounded) values."""
    B = shape[1]
    _, _, grads, (q, k, v, do), _ = _case(shape, dtype, seed=11)
    for name, got, want in zip("qkv", grads, _jax_grads(shape, q, k, v, do)):
        assert got.dtype == dtype
        _held(got, want, B, dtype, f"d{name}")


# (S, T, causal, window) of the tile-walk tests: SHAPES' and the card's
# training shapes (minicpm 1024, whisper's cross 448 by 1500, gemma2's
# window 128 at 512 and its train step's local layers, window 4096 at
# 8192), ragged and windowed ones.
WALK_CASES = sorted({sh[4:6] + sh[7:9] for sh in SHAPES} | {
    (1024, 1024, True, 0), (448, 1500, False, 0), (512, 512, True, 128),
    (8192, 8192, True, 4096), (77, 150, True, 0), (150, 77, True, 0),
    (300, 300, True, 37), (1000, 1000, True, 4096), (130, 300, False, 0)})


# (BK, BQ) of the one-pass kernels: wgmma 128 x 64 and 64 x 64 (D = 128),
# f32 128 x 64 (D <= 64), 64 x 64 (D = 80, 96), 32 x 64 (D = 128) and
# 32 x 32 (D = 256).
WALK_TILES = [(128, 64), (64, 64), (32, 64), (32, 32)]
WALK_TILE_IDS = ["128", "64", "32x64", "32x32"]


@pytest.mark.parametrize("bk,bq", WALK_TILES, ids=WALK_TILE_IDS)
@pytest.mark.parametrize("S,T,causal,window", WALK_CASES)
def test_tc_tile_walk_matches_visible_pairs(S, T, causal, window, bk, bq):
    """The one-pass kernels' walk at each of their tiles: key tile kt takes
    query tile i exactly when some pair of the two tiles is visible, seen
    from either side, and every query tile has a key tile (its dQ is
    written)."""
    mask = _visible(S, T, causal, window, "cpu")
    n_q, n_kt = -(-S // bq), -(-T // bk)
    for i in range(n_q):
        for kt in range(n_kt):
            seen = bool(mask[i * bq:(i + 1) * bq,
                             kt * bk:(kt + 1) * bk].any())
            assert (i in tc_query_tiles(kt, S, T, causal, window, bk,
                                        bq)) == seen
            assert (kt in tc_key_tiles(i, S, T, causal, window, bk,
                                       bq)) == seen
        assert len(tc_key_tiles(i, S, T, causal, window, bk, bq)) > 0


def _dq_order_ticks(S, T, causal, window, group, slots, bk, bq, order,
                    reverse=False):
    """Runs the one-pass kernels' CTAs of one KV head as a schedule: CTAs
    start in launch order on ``slots`` SMs; each takes one step a tick and,
    before its step's dQ add, waits until the query tile's counter reads
    its rank (CTAs go in launch order within a tick).  ``order``
    (``dq_order``): ``high`` launches the highest key tile first and it
    adds first, the others the lowest; each CTA walks as ``walk_steps``
    says; ``reverse`` launches the other way round.  Returns the ticks to
    the end, or None if no CTA can move."""
    n_kt = -(-T // bk)
    low = order != "high"
    launch = list(range(n_kt))[::1 if low != reverse else -1]
    walk = {kt: walk_steps(order, kt, group, S, T, causal, window, bk, bq)
            for kt in launch}
    counter: dict[tuple[int, int], int] = {}
    waiting, running, done, ticks = list(launch), [], set(), 0
    while len(done) < n_kt:
        while waiting and len(running) < slots:
            running.append([waiting.pop(0), 0])
        moved = False
        for cta in running:
            kt, n = cta
            if n == len(walk[kt]):
                continue
            g, i = walk[kt][n]
            tiles = tc_key_tiles(i, S, T, causal, window, bk, bq)
            rank = kt - tiles.start if low else tiles.stop - 1 - kt
            if counter.get((g, i), 0) == rank:
                counter[(g, i)] = counter.get((g, i), 0) + 1
                cta[1] += 1
                moved = True
        for cta in list(running):
            if cta[1] == len(walk[cta[0]]):
                running.remove(cta)
                done.add(cta[0])
                moved = True
        if not moved:
            return None
        ticks += 1
    assert all(counter[(g, i)] ==
               len(tc_key_tiles(i, S, T, causal, window, bk, bq))
               for g, i in counter)
    return ticks


# The dQ order of each one-pass kernel at its tiles: (order, BK, BQ):
# ``wgmma`` at 128 x 64, at 64 x 64 (D = 128) and at D = 256's 64 x 64,
# and f32 at each of its tiles.
ORDER_CASES = [("high", 128, 64), ("high", 64, 64), ("low_inner", 64, 64)] \
    + [("low", bk, bq) for bk, bq in WALK_TILES]
ORDER_IDS = ["128", "64", "d256"] + [f"f32-{i}" for i in WALK_TILE_IDS]


@pytest.mark.parametrize("slots", [1, 3, 64])
@pytest.mark.parametrize("S,T,causal,window", WALK_CASES)
@pytest.mark.parametrize("order,bk,bq", ORDER_CASES, ids=ORDER_IDS)
def test_tc_dq_order_waits_only_on_earlier_ctas(S, T, causal, window, slots,
                                                 order, bk, bq):
    """The dQ order of the ``wgmma`` kernel (below D = 256 the highest key
    tile launched and adding first, at D = 256 the lowest) and of the f32
    kernel (the lowest first): the schedule runs
    to its end however few SMs there are (a CTA waits only on CTAs launched
    before it), every query tile's counter ends at its number of key
    tiles, and on causal self-attention with every CTA resident no wait
    lengthens the longest CTA's walk.  Launched the other way round, one SM
    deadlocks wherever a query tile has two key tiles."""
    group = 2
    ticks = _dq_order_ticks(S, T, causal, window, group, slots, bk, bq,
                            order)
    assert ticks is not None
    longest = max(group * len(tc_query_tiles(kt, S, T, causal, window, bk,
                                             bq))
                  for kt in range(-(-T // bk)))
    if causal and S == T and slots >= -(-T // bk):
        assert ticks == longest
    shared = any(len(tc_key_tiles(i, S, T, causal, window, bk, bq)) > 1
                 for i in range(-(-S // bq)))
    if slots == 1 and shared:
        assert _dq_order_ticks(S, T, causal, window, group, 1, bk, bq,
                               order, reverse=True) is None


@pytest.mark.parametrize("shape", SHAPES[:6] + SHAPES[7:9],
                         ids=[s[0] for s in SHAPES[:6] + SHAPES[7:9]])
def test_emulated_lse_matches_logsumexp(shape, one_thread):
    """The forward's saved log-sum-exp, from its online softmax over key
    tiles, against ``torch.logsumexp`` of the masked, softcapped logits;
    its O against the plain forward."""
    (q, k, v, _), (o32, lse, _, _), _, _, kw = _case(shape, torch.float32, 5)
    D = q.shape[-1]
    G = q.shape[0] // k.shape[0]
    s = torch.einsum("hsd,htd->hst", q, k.repeat_interleave(G, 0))
    x, _ = _logits(s, 1 / math.sqrt(D), kw["softcap"])
    mask = _visible(q.shape[1], k.shape[1], kw["causal"], kw["window"],
                    "cpu")
    want = torch.logsumexp(torch.where(mask, x, NEG_INF), dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=4e-6)
    ref_out, ref_lse, _ = attention_ref(q, k, v, **kw, stats=True)
    torch.testing.assert_close(ref_lse, want, rtol=0, atol=4e-6)
    torch.testing.assert_close(o32, ref_out, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[7]],
                         ids=[SHAPES[2][0], SHAPES[7][0]])
def test_bf16_d_i_needs_the_lo_part(shape, one_thread):
    """D_i from O's hi + lo: dq's f32 accumulator lies within 1e-5 of
    max|dq| of the f32 gradient.  From the bf16 O alone the same arithmetic
    moves dS by up to 2^-9 of Σ|dO||O|, and the accumulator lies many
    times farther (before the one rounding to bf16 that both share)."""
    (q, k, v, do), (_, lse, out, out_lo), _, _, kw = _case(
        shape, torch.bfloat16, 3)
    ref = attention_ref_grad(*(t.float() for t in (q, k, v, do)), **kw)
    with_lo, no_lo = (emulate_backward(q, k, v, out, lse, do, out_lo=lo,
                                       rounded=False, **kw)[0]
                      for lo in (out_lo, torch.zeros_like(out_lo)))
    d_with = (with_lo - ref[0]).abs().max().item()
    d_without = (no_lo - ref[0]).abs().max().item()
    assert d_with <= F32_RTOL * ref[0].abs().max().item()
    assert d_without >= 20 * d_with


def test_function_runs_the_injected_backward(one_thread):
    """``FlashAttention`` saves the forward's output and statistics and
    hands them to the injected ``backward_fn``: with the forward's
    emulation and the backward's, its gradients are the emulation's, in
    the inputs' dtype; without one, on the CPU, the plain gradient."""
    shape = SHAPES[3]
    q, k, v, do = (_flat(a).bfloat16() for a in _inputs(shape, 7))
    _, B, *_, causal, window, softcap = shape
    kw = dict(causal=causal, window=window, softcap=softcap)
    seen = []

    def forward_fn(q_, k_, v_, *, stats, **kw_):
        assert stats
        _, lse, out, out_lo = emulate_forward(q_, k_, v_, **kw_)
        return out, lse, out_lo

    def backward_fn(*args, **kw_):
        seen.append(kw_)
        return emulate_backward(*args, **kw_)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.FlashAttention.apply(*leaves, causal, window, softcap,
                                  forward_fn, backward_fn)
    out.backward(do)
    assert len(seen) == 1 and seen[0]["out_lo"] is not None
    _, lse, ref_out, out_lo = emulate_forward(q, k, v, **kw)
    want = emulate_backward(q, k, v, ref_out, lse, do, out_lo=out_lo, **kw)
    assert torch.equal(out.detach(), ref_out)
    for t, w in zip(leaves, want):
        assert t.grad.dtype == torch.bfloat16 and torch.equal(t.grad, w)
    plain = [t.float().clone().requires_grad_() for t in (q, k, v)]
    FA.FlashAttention.apply(*plain, causal, window, softcap,
                            attention_ref).backward(do.float())
    want = attention_ref_grad(*(t.float() for t in (q, k, v, do)), **kw)
    for t, w in zip(plain, want):
        assert torch.equal(t.grad, w)


def test_backward_kernel_refuses_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only; the CPU has the plain
    version through ``flash_attention_backward``."""
    q = torch.zeros(2, 8, 16)
    lse = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_backward_kernel(q, q, q, q, lse, q)
    got = FA.flash_attention_backward(q, q, q, q, lse, q)
    assert all(g.shape == q.shape for g in got)


@pytest.mark.parametrize("D", FA.HEAD_DIMS)
def test_backward_route_is_one_per_dtype(D):
    """Every head dim's bf16 gradient goes to the ``wgmma`` kernel
    (``bwd_tc_bf16``, ``csrc/flash_attention_bwd_sm90.cu``), D = 256
    (gemma2-2b's, paligemma-3b's) among them, and every f32 one to the
    CUDA-core kernel: one backward route a dtype, each counted in
    ``launches_by_kernel`` beside the forward routes and no other."""
    assert FA.backward_route(torch.bfloat16, D) == "bwd_tc_bf16"
    assert FA.backward_route(torch.float32, D) == "bwd_simt_f32"
    assert set(FA.launches_by_kernel) == set(FA.BACKWARD_ROUTE) | set(
        FA.BACKWARD_ROUTE.values())
