"""The f32 flash-attention forward kernel's arithmetic on the CPU.

``csrc/flash_attention.cu`` (route ``simt_f32``) runs only on the card;
this file emulates it in torch, step by step as it walks its tiles.  Its
unit of work, an item, is ``2 * BQG`` query rows of one head, two consumer
groups of ``BQG`` rows each; a persistent grid of one CTA an SM deals the
items out in rounds (``cta_items``).  An item walks the keys from the
first any of its rows sees, ``BK`` at a time (128 up to D = 64, 64 up to
D = 128, 32 at D = 256), and per step and group takes base-2 logits x =
(q * log2(e) / sqrt(D)).K^T (with a softcap, x = cap * log2(e) *
tanh((q / sqrt(D)).K^T / cap)), the mask only on tiles that hide some pair
of the group's rows (branch-free: masked logits -1e30, keys past T -inf),
the online softmax (m, alpha = 2^(m_old - m), P = 2^(x - m), l), and O +=
P.V summed in ``KS`` parts over the tile's keys, the parts added in order
at the end; O = acc / max(l, 1e-30) and the log-sum-exp m * ln 2 + ln
max(l, 1e-30), in natural-log units as the backward reads it.

The emulation is held against the JAX package's ``attention_scores`` (the
arithmetic of the Pallas kernel's plain reference) on the CPU at causal,
windowed, softcapped, GQA, non-causal cross (S != T) and ragged shapes and
at every head dim: O within 2e-5 per element, the log-sum-exp within 4e-6
of JAX's over the same masked, softcapped logits.  The kernel's tile walk
(which key tiles each query tile visits, where it masks, and the order in
which the CTAs take the items) is held against the visible pairs.  Inputs come
from a numpy seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import NEG_INF, _visible, attention_ref

O_ATOL = 2e-5      # per element, as chip_smoke.py holds the kernel
LSE_ATOL = 4e-6
GROUP = 128        # threads of a consumer group
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453


def f32_tiles(D: int) -> tuple[int, int, int]:
    """(BQG, BK, KS) of the kernel's ``Tiles<D>``: query rows a consumer
    group (a CTA owns two groups' rows), keys a step, and the parts of a
    step's keys over which O is summed separately."""
    bqg = 32 if D == 256 else 64
    bk = 128 if D <= 64 else 64 if D <= 128 else 32
    ow = 2 if D == 80 else 4
    oc = {16: 1, 80: 5, 96: 3}.get(D, 2)
    nm, nn = bqg // 8, D // (ow * oc)
    return bqg, bk, GROUP // (nm * nn)


def cta_keys(q0: int, bq: int, S: int, T: int, causal: bool,
             window: int) -> tuple[int, int]:
    """The keys [k_begin, k_end) that the CTA of query rows [q0, q0 + bq)
    walks: none past its last row below S when causal, none at or before
    q0 - window when windowed."""
    k_begin = max(0, q0 - window + 1) if window > 0 else 0
    k_end = min(T, min(S, q0 + bq)) if causal else T
    return k_begin, k_end


def steps_of(q0: int, bq: int, bk: int, S: int, T: int, causal: bool,
             window: int) -> int:
    k_begin, k_end = cta_keys(q0, bq, S, T, causal, window)
    return -(-(k_end - k_begin) // bk) if k_end > k_begin else 0


def item_of(idx: int, BH: int, S: int, bq: int) -> tuple[int, int]:
    """(query tile, head) of item ``idx``: every head's last query tile
    first, then the one before."""
    n_qt = -(-S // bq)
    return n_qt - 1 - idx // BH, idx % BH


def cta_items(c: int, grid: int, n_items: int) -> list[int]:
    """The items CTA ``c`` of a grid of ``grid`` takes, in order: rounds of
    ``grid`` items, dealt forward in even rounds and backward in odd
    ones."""
    out, k = [], 0
    while (idx := k * grid + (grid - 1 - c if k % 2 else c)) < n_items:
        out.append(idx)
        k += 1
    return out


def is_edge(kb: int, bk: int, qrow0: int, bqg: int, S: int, T: int,
            causal: bool, window: int) -> bool:
    """Whether the kernel masks the step at keys [kb, kb + bk) for the
    group of rows from qrow0: some key past T, or some pair of the group's
    rows (below S) and the tile's keys hidden."""
    q_last = min(qrow0 + bqg, S) - 1
    return (kb + bk > T or (causal and kb + bk - 1 > qrow0)
            or (window > 0 and kb <= q_last - window))


def emulate_f32_forward(q, k, v, *, causal, window, softcap):
    """O (BH, S, D) and the log-sum-exp (BH, S) as the kernel computes
    them, all heads of a query tile at once."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    G = BH // BKV
    bqg, bk, ks = f32_tiles(D)
    bq, part = 2 * bqg, bk // ks
    scale = 1.0 / torch.sqrt(torch.tensor(float(D)))
    q_scale = scale if softcap else scale * torch.tensor(LOG2E)
    inv_cap = 1.0 / torch.tensor(softcap) if softcap else None
    cap_log2e = torch.tensor(softcap) * torch.tensor(LOG2E)
    kf, vf = k.repeat_interleave(G, 0), v.repeat_interleave(G, 0)
    o = torch.zeros(BH, S, D)
    lse = torch.zeros(BH, S)
    for qt in range(-(-S // bq)):
        q0 = qt * bq
        k_begin, _ = cta_keys(q0, bq, S, T, causal, window)
        steps = steps_of(q0, bq, bk, S, T, causal, window)
        for group in range(2):
            qrow0 = q0 + group * bqg
            rows = torch.arange(qrow0, qrow0 + bqg)
            n = max(0, min(S - qrow0, bqg))
            qs = q[:, rows.clamp(max=S - 1)] * q_scale   # rows past S: S - 1
            m = torch.full((BH, bqg), NEG_INF)
            l = torch.zeros(BH, bqg)
            acc = torch.zeros(ks, BH, bqg, D)
            for step in range(steps):
                kb = k_begin + step * bk
                keys = torch.arange(kb, kb + bk)
                rows_kv = keys.clamp(max=T - 1)   # rows past T repeat T - 1
                kt, vt = kf[:, rows_kv], vf[:, rows_kv]
                x = qs @ kt.transpose(1, 2)
                if softcap:
                    x = cap_log2e * torch.tanh(x * inv_cap)
                if is_edge(kb, bk, qrow0, bqg, S, T, causal, window):
                    vis = torch.ones(bqg, bk, dtype=torch.bool)
                    if causal:
                        vis &= keys[None, :] <= rows[:, None]
                    if window:
                        vis &= keys[None, :] > rows[:, None] - window
                    x = torch.where(vis, x, NEG_INF)
                    x = torch.where(keys < T, x, -math.inf)
                mx = torch.maximum(m, x.max(dim=2).values)
                alpha = torch.exp2(m - mx)
                p = torch.exp2(x - mx[..., None])
                l = l * alpha + p.sum(dim=2)
                for s in range(ks):
                    cut = slice(s * part, (s + 1) * part)
                    acc[s] = acc[s] * alpha[..., None] + p[..., cut] @ vt[:,
                                                                          cut]
                m = mx
            total = acc[0]
            for s in range(1, ks):
                total = total + acc[s]
            denom = torch.clamp(l, min=1e-30)
            o[:, qrow0:qrow0 + n] = (total / denom[..., None])[:, :n]
            lse[:, qrow0:qrow0 + n] = (m * torch.tensor(LN2)
                                       + torch.log(denom))[:, :n]
    return o, lse


# name, B, H, KV, S, T, D, causal, window, softcap: every mask kind, GQA,
# cross and ragged shapes past one query tile (128 rows) and several key
# tiles, then one case a head dim past its tiles.
SHAPES = [
    ("causal", 2, 4, 4, 150, 150, 16, True, 0, 0.0),
    ("window", 1, 4, 4, 300, 300, 16, True, 37, 0.0),
    ("softcap", 2, 2, 2, 140, 140, 32, True, 0, 50.0),
    ("window_softcap", 1, 4, 2, 260, 260, 16, True, 70, 30.0),
    ("gqa_4to1", 1, 8, 2, 200, 200, 16, True, 0, 0.0),
    ("cross_noncausal", 2, 4, 4, 90, 300, 16, False, 0, 0.0),
    ("ragged_causal", 1, 2, 2, 277, 277, 32, True, 0, 0.0),
    ("causal_cross_s_lt_t", 1, 2, 1, 70, 150, 32, True, 0, 0.0),
    ("causal_s_gt_t", 1, 2, 2, 300, 77, 16, True, 0, 0.0),
    ("noncausal_s_gt_t", 1, 2, 2, 290, 33, 16, False, 0, 0.0),
    ("window_ge_t", 1, 2, 2, 200, 200, 16, True, 300, 0.0),
    ("window_noncausal", 1, 2, 1, 180, 200, 16, False, 50, 20.0),
] + [(f"d{d}", 1, 2, 1, 270, 270, d, True, 0, 0.0) for d in FA.HEAD_DIMS] \
  + [(f"d{d}_cross_softcap", 1, 2, 2, 100, 150, d, False, 0, 50.0)
     for d in FA.HEAD_DIMS]


def _inputs(shape, seed):
    _, B, H, KV, S, T, D, *_ = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32),
            rng.normal(size=(B, T, KV, D)).astype(np.float32))


def _flat(x: np.ndarray) -> torch.Tensor:
    """(B, S, H, D) → the kernel's (B·H, S, D)."""
    B, S, H, D = x.shape
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D) \
        .contiguous()


def _jax_reference(shape, q, k, v):
    """O from ``attention_scores`` and each row's log-sum-exp of the same
    masked, softcapped logits, both in JAX on the CPU, in the kernel's
    (B·H, S, ...) layout."""
    _, B, H, KV, S, T, D, causal, window, softcap = shape
    mask = jnp.asarray(_visible(S, T, causal, window, "cpu").numpy())
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out = JL.attention_scores(jq, jk, jv, mask[None], softcap)
    qg = jq.reshape(B, S, KV, H // KV, D)
    logits = jnp.einsum("bskgh,btkh->bkgst", qg, jk) / math.sqrt(D)
    logits = jnp.where(mask, JL._softcap(logits, softcap), NEG_INF)
    lse = jax.nn.logsumexp(logits, axis=-1).reshape(B * H, S)
    out = np.asarray(out).transpose(0, 2, 1, 3).reshape(B * H, S, D)
    return out, np.asarray(lse)


@pytest.fixture
def one_thread():
    """The emulation walks many small tiles, which gain nothing from
    intra-op threads and, beside other test processes, lose much to them:
    run the test on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_emulated_forward_matches_jax(shape, one_thread):
    """The kernel's arithmetic against JAX's ``attention_scores`` and the
    log-sum-exp of its logits, per element."""
    *_, causal, window, softcap = shape
    q, k, v = _inputs(shape, seed=7)
    o, lse = emulate_f32_forward(*map(_flat, (q, k, v)), causal=causal,
                                 window=window, softcap=softcap)
    want_o, want_lse = _jax_reference(shape, q, k, v)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=0, atol=O_ATOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[9:10],
                         ids=[s[0] for s in SHAPES[:3] + SHAPES[9:10]])
def test_emulated_forward_matches_plain(shape, one_thread):
    """The same against the port's plain version, which the card holds the
    kernel to, with its statistics."""
    *_, causal, window, softcap = shape
    q, k, v = map(_flat, _inputs(shape, seed=8))
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = emulate_f32_forward(q, k, v, **kw)
    ref, ref_lse, _ = attention_ref(q, k, v, **kw, stats=True)
    torch.testing.assert_close(o, ref, rtol=0, atol=O_ATOL)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=LSE_ATOL)


def test_garbage_of_wholly_masked_tiles_is_wiped(one_thread):
    """A window that starts each CTA's walk before its first rows' keys: a
    row's first tiles are wholly masked (exp(0) garbage), which the first
    visible key's alpha = 0 wipes; the result is the plain one, and no row
    takes a key past T."""
    shape = ("garbage", 1, 2, 2, 400, 400, 16, True, 20, 0.0)
    q, k, v = map(_flat, _inputs(shape, seed=9))
    o, _ = emulate_f32_forward(q, k, v, causal=True, window=20, softcap=0.0)
    torch.testing.assert_close(o, attention_ref(q, k, v, window=20),
                               rtol=0, atol=O_ATOL)


# (S, T, causal, window) of the walk tests: SHAPES' and the card's shapes
# (minicpm 1024, whisper's clips 1500 and 448 by 1500, gemma2's window),
# ragged and windowed ones.
WALK_CASES = sorted({sh[4:6] + sh[7:9] for sh in SHAPES} | {
    (1024, 1024, True, 0), (1500, 1500, False, 0), (448, 1500, False, 0),
    (1000, 1000, True, 300), (8192, 8192, True, 4096), (512, 512, True, 128),
    (1, 1, True, 0), (129, 191, True, 0), (191, 129, False, 0),
    (640, 640, True, 192), (700, 700, True, 200), (52, 37, True, 16)})
WALK_DIMS = [16, 80, 256]   # the three (BQG, BK) tilings


@pytest.mark.parametrize("D", WALK_DIMS)
@pytest.mark.parametrize("S,T,causal,window", WALK_CASES)
def test_tile_walk_matches_visible_pairs(S, T, causal, window, D):
    """Each CTA visits exactly the key tiles that hold a visible pair of
    its rows, in order and each once; a step it does not mask for a group
    has every pair of the group's rows (below S) visible and every key
    below T."""
    if window and S >= T + window:
        pytest.skip("refused by the wrapper: a row sees no key")
    bqg, bk, _ = f32_tiles(D)
    bq = 2 * bqg
    vis = _visible(S, T, causal, window, "cpu")
    for qt in range(-(-S // bq)):
        q0 = qt * bq
        k_begin, k_end = cta_keys(q0, bq, S, T, causal, window)
        steps = steps_of(q0, bq, bk, S, T, causal, window)
        seen = vis[q0:q0 + bq]
        cols = seen.any(dim=0).nonzero().flatten()
        assert int(cols.min()) >= k_begin and int(cols.max()) < k_end
        for n in range(steps):
            kb = k_begin + n * bk
            assert bool(seen[:, kb:kb + bk].any()), (qt, n)
            for group in range(2):
                qrow0 = q0 + group * bqg
                rows = vis[qrow0:min(qrow0 + bqg, S), kb:kb + bk]
                if rows.numel() and not is_edge(kb, bk, qrow0, bqg, S, T,
                                                causal, window):
                    assert kb + bk <= T and bool(rows.all()), (qt, n, group)
        assert steps == 0 or k_begin + (steps - 1) * bk < k_end


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("BH", [1, 3, 36])
@pytest.mark.parametrize("S,T,causal,window", WALK_CASES)
def test_items_are_dealt_once_and_evenly(S, T, causal, window, BH, grid):
    """The persistent grid (``min(items, SMs)`` CTAs) takes every (query
    tile, head) once; on causal shapes without a window the items run
    longest first, each CTA's items shorten, and no CTA's total exceeds
    the largest of a deal forward in every round."""
    if window and S >= T + window:
        pytest.skip("refused by the wrapper: a row sees no key")
    for D in WALK_DIMS:
        bqg, bk, _ = f32_tiles(D)
        bq = 2 * bqg
        n_items = -(-S // bq) * BH
        g = min(n_items, grid)
        taken = [cta_items(c, g, n_items) for c in range(g)]
        assert sorted(i for items in taken for i in items) == list(
            range(n_items))
        assert sorted({item_of(i, BH, S, bq) for i in range(n_items)}) == [
            (qt, h) for qt in range(-(-S // bq)) for h in range(BH)]

        def steps(i):
            qt, _ = item_of(i, BH, S, bq)
            return steps_of(qt * bq, bq, bk, S, T, causal, window)
        if causal and not window:
            lengths = [steps(i) for i in range(n_items)]
            assert lengths == sorted(lengths, reverse=True)
            totals = [sum(map(steps, items)) for items in taken]
            for items in taken:
                assert [steps(i) for i in items] == sorted(
                    (steps(i) for i in items), reverse=True)
            forward = [sum(map(steps, range(c, n_items, g)))
                       for c in range(g)]
            assert max(totals) <= max(forward)


def test_deal_evens_out_the_twin_layer():
    """At the minicpm-2b f32 twin's layer (4x1024, 36 heads, causal) on an
    H100's 132 SMs, the longest CTA walks at most one step more than the
    mean; dealt forward in every round it would walk 44 against 39.3."""
    bqg, bk, _ = f32_tiles(64)
    bq, BH, S, grid = 2 * bqg, 4 * 36, 1024, 132
    n_items = -(-S // bq) * BH

    def steps(i):
        qt, _ = item_of(i, BH, S, bq)
        return steps_of(qt * bq, bq, bk, S, S, True, 0)
    totals = [sum(map(steps, cta_items(c, grid, n_items)))
              for c in range(grid)]
    mean = sum(map(steps, range(n_items))) / grid
    assert max(totals) <= math.ceil(mean) + 1
