"""Parity of the port's LM layers (``repro_torch.models.layers``) and of the
flash-attention op's plain version (``repro_torch.kernels``) with the JAX
package's: the same numpy inputs, made from a seed, go through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels.flash_attention import flash_attention_kernel as pallas_flash
from repro.models import api as JAPI
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import api as API
from repro_torch.models import layers as L

ATOL = 2e-5        # f32, as tests/test_kernels.py holds the flash kernel
BF16_ATOL = 3e-2   # bf16 outputs, as tests/test_kernels.py


def _np(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(out, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol,
                               rtol=rtol)


# --- layers -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    x, w = _np(0, (2, 5, 64), 3.0), 1 + _np(1, (64,), 0.1)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w))
    out = L.rmsnorm(tw, tx, 1e-6)
    assert out.dtype == tx.dtype
    _close(out, JL.rmsnorm(jw, jx, 1e-6),
           atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("theta", [10000.0, 500.0, 0.0])
def test_apply_rope_matches_jax(theta):
    x = _np(2, (2, 7, 4, 16))
    pos = np.tile(np.arange(7), (2, 1)) + np.array([[0], [5]])
    out = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(out, JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-5)
    if theta == 0.0:
        np.testing.assert_array_equal(out.numpy(), x)


@pytest.mark.parametrize("S,T,offset,window", [(6, 6, 0, 0), (6, 9, 3, 0),
                                               (8, 8, 0, 3), (5, 12, 7, 4)])
def test_causal_mask_matches_jax(S, T, offset, window):
    np.testing.assert_array_equal(
        L.causal_mask(S, T, offset, window).numpy(),
        np.asarray(JL.causal_mask(S, T, offset, window)))


@pytest.mark.parametrize("window", [0, 3, 100])
def test_win_mask_matches_jax(window):
    np.testing.assert_array_equal(API._win_mask(9, window).numpy(),
                                  np.asarray(JAPI._win_mask(9, window)))


@pytest.mark.parametrize("H,KV,softcap,window", [(4, 4, 0.0, 0),
                                                 (8, 2, 0.0, 0),
                                                 (8, 2, 50.0, 0),
                                                 (6, 3, 30.0, 5)])
def test_attention_scores_matches_jax(H, KV, softcap, window):
    B, S, hd = 2, 11, 16
    q, k, v = (_np(3, (B, S, H, hd)), _np(4, (B, S, KV, hd)),
               _np(5, (B, S, KV, hd)))
    mask = JL.causal_mask(S, S, 0, window)
    ref = JL.attention_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask, softcap)
    out = L.attention_scores(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.from_numpy(np.asarray(mask)), softcap)
    _close(out, ref, atol=1e-5)


def test_attention_scores_decode_mask_matches_jax():
    """The (1, 1, T) key mask of the decode step, with a window."""
    B, T, H, KV, hd, index, window = 2, 10, 4, 2, 16, 6, 3
    q, k, v = _np(6, (B, 1, H, hd)), _np(7, (B, T, KV, hd)), \
        _np(8, (B, T, KV, hd))
    m = (np.arange(T) <= index) & (np.arange(T) > index - window)
    ref = JL.attention_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(m)[None, None, :], 50.0)
    out = L.attention_scores(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.from_numpy(m)[None, None, :], 50.0)
    _close(out, ref, atol=1e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_mlp_matches_jax(activation):
    tree = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(0), 32,
                                                64, jnp.float32))
    x = _np(9, (3, 5, 32))
    ref = JL.mlp(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), activation)
    out = L.mlp({k: torch.from_numpy(v) for k, v in tree.items()},
                torch.from_numpy(x), activation)
    _close(out, ref, atol=1e-5)


@pytest.mark.parametrize("window", [0, 8, 3])
def test_attention_window_equals_jax_mask(window):
    """The port's ``attention(window=w)`` is JAX's ``attention(mask=
    causal_mask(S, S) & _win_mask(S, w))``, as its decoder builds it."""
    cfg = get_config("gemma2-2b-smoke")
    jcfg = jax_get_config("gemma2-2b-smoke")
    tree = jax.tree.map(np.asarray, JL.init_attention(
        jax.random.PRNGKey(1), jcfg, jnp.float32))
    B, S = 2, 12
    x = _np(10, (B, S, cfg.d_model))
    pos = np.tile(np.arange(S), (B, 1))
    mask = JL.causal_mask(S, S) & JAPI._win_mask(S, window)
    ref = JL.attention(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                       positions=jnp.asarray(pos), mask=mask)
    out = L.attention({k: torch.from_numpy(v) for k, v in tree.items()},
                      torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                      window=window)
    _close(out, ref, atol=1e-5)


@pytest.mark.parametrize("name", ["gemma2-2b-smoke", "qwen3-32b-smoke"])
def test_attention_cross_equals_jax(name):
    """``attention(kv_override=src, causal=False)`` is JAX's cross-attention
    (``kv_override=src`` with an all-ones mask) over T != S source rows: k
    and v from the source, qk-norm where the config has it (qwen3), no
    rope, the softcap where it has one (gemma2)."""
    cfg, jcfg = get_config(name), jax_get_config(name)
    tree = jax.tree.map(np.asarray, JL.init_attention(
        jax.random.PRNGKey(2), jcfg, jnp.float32))
    B, S, T = 2, 12, 7
    x = _np(11, (B, S, cfg.d_model))
    src = _np(12, (B, T, cfg.d_model))
    pos = np.tile(np.arange(S), (B, 1))
    ref = JL.attention(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                       positions=jnp.asarray(pos),
                       mask=jnp.ones((1, S, T), bool),
                       kv_override=jnp.asarray(src))
    out = L.attention({k: torch.from_numpy(v) for k, v in tree.items()},
                      torch.from_numpy(x), cfg, positions=torch.from_numpy(pos),
                      window=0, causal=False,
                      kv_override=torch.from_numpy(src))
    _close(out, ref, atol=1e-5)


# --- the flash kernel's plain version ------------------------------------------

def _qkv(BH, BKV, S, T, D, seed=0):
    return (_np(seed, (BH, S, D)), _np(seed + 1, (BKV, T, D)),
            _np(seed + 2, (BKV, T, D)))


def _both(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = JREF.attention_ref(*(jnp.asarray(a, jdt) for a in (q, k, v)), **kw)
    return attention_ref(*t, **kw), ref


# the grid of tests/test_kernels.py::test_flash_attention_shapes
@pytest.mark.parametrize("BH,BKV,S,T,D", [(4, 2, 128, 128, 64),
                                          (2, 1, 64, 128, 32),
                                          (8, 8, 128, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_jax(BH, BKV, S, T, D, causal):
    out, ref = _both(*_qkv(BH, BKV, S, T, D), causal=causal)
    _close(out, ref)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (64, 0.0), (0, 30.0),
                                            (32, 50.0)])
def test_attention_ref_window_softcap_matches_jax(window, softcap):
    out, ref = _both(*_qkv(2, 2, 128, 128, 32, seed=3), causal=True,
                     window=window, softcap=softcap)
    _close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_head_dim_80_matches_jax(dtype, causal):
    """zamba2's heads: D = 80, as many KV heads as query heads, no
    softcap."""
    out, ref = _both(*_qkv(4, 4, 96, 96, 80, seed=11), dtype=dtype,
                     causal=causal)
    _close(out, ref, atol=ATOL if dtype == torch.float32 else BF16_ATOL)


def test_attention_ref_bf16_matches_jax():
    out, ref = _both(*_qkv(2, 2, 128, 128, 64, seed=6), dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out, ref, atol=BF16_ATOL)


@pytest.mark.parametrize("S,T,window", [(64, 128, 0), (100, 37, 16)])
def test_attention_ref_top_left_causal(S, T, window):
    """Query i sees keys <= i also when S != T (not bottom-right)."""
    out, ref = _both(*_qkv(4, 2, S, T, 16, seed=9), causal=True,
                     window=window, softcap=50.0)
    _close(out, ref)


def test_ops_flash_attention_gqa_matches_jax():
    B, S, H, KV, D = 2, 128, 8, 2, 32
    q, k, v = _np(11, (B, S, H, D)), _np(12, (B, S, KV, D)), \
        _np(13, (B, S, KV, D))
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=0, softcap=0.0)
    ref = JOPS.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=64, block_k=64)
    assert out.shape == (B, S, H, D)
    _close(out, ref)


@pytest.mark.parametrize("BH,BKV,D,seed", [(2, 1, 16, 0), (3, 3, 24, 1),
                                           (8, 2, 32, 2)])
def test_attention_ref_rowsum(BH, BKV, D, seed):
    """Attention over constant values returns that constant."""
    q, k, _ = _qkv(BH, BKV, 64, 64, D, seed)
    out = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                        torch.ones(BKV, 64, D), causal=True)
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


# a few cases against the Pallas kernel itself, in interpret mode (slow)
@pytest.mark.parametrize("BH,BKV,S,T,D,causal,window,softcap", [
    (4, 2, 128, 128, 32, True, 0, 0.0),
    (2, 1, 64, 128, 32, True, 0, 50.0),
    (4, 2, 128, 128, 16, True, 48, 50.0),
    (2, 2, 128, 128, 80, True, 0, 0.0),      # zamba2's head dim
])
def test_plain_version_matches_pallas_kernel(BH, BKV, S, T, D, causal, window,
                                             softcap):
    q, k, v = _qkv(BH, BKV, S, T, D, seed=20)
    ref = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=causal, window=window, softcap=softcap,
                       block_q=64, block_k=64, interpret=True)
    out = attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal, window=window, softcap=softcap)
    _close(out, ref)


# --- the bf16 tensor-core kernel's arithmetic, emulated ------------------------

# The card's per-element limit for bf16 (tests/test_torch_cuda.py,
# chip_smoke.py): half an ulp of the output's one rounding plus 2e-5.
CARD_RTOL, CARD_ATOL = 2.0**-8, 2e-5


def _sm90_emulation(q, k, v, *, causal, window, softcap, block_k, split=True,
                    round_out=True):
    """The arithmetic of ``csrc/flash_attention_sm90.cu`` in plain torch:
    bf16 q and k, scores in f32 with 1/sqrt(D) applied after the product,
    key tiles of ``block_k`` with online rescaling in base 2, P as hi + lo
    bf16 (one bf16 when not ``split``), f32 accumulation, the output
    rounded once to bf16 (kept in f32 when not ``round_out``)."""
    BH, S, D = q.shape
    BKV, T, _ = k.shape
    group = BH // BKV
    kf = k.repeat_interleave(group, 0).float()
    vf = v.repeat_interleave(group, 0).float()
    scale = 1.0 / np.sqrt(D)
    sl2 = (1.0 if softcap else scale) * np.log2(np.e)
    rows = torch.arange(S)[:, None]
    m = torch.full((BH, S, 1), -1e30)
    lsum = torch.zeros(BH, S, 1)
    acc = torch.zeros(BH, S, D)
    for kb in range(0, T, block_k):
        s = q.float() @ kf[:, kb:kb + block_k].transpose(1, 2)
        if softcap:
            s = softcap * torch.tanh(s * (scale / softcap))
        keys = torch.arange(kb, min(kb + block_k, T))[None, :]
        visible = torch.ones(S, keys.shape[1], dtype=torch.bool)
        if causal:
            visible &= keys <= rows
        if window:
            visible &= keys > rows - window
        s = torch.where(visible, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * sl2)
        p = torch.exp2((s - m_new) * sl2)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if split else torch.zeros_like(p)
        acc = acc * alpha + hi @ vf[:, kb:kb + block_k] \
            + lo @ vf[:, kb:kb + block_k]
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        m = m_new
    out = acc / lsum.clamp_min(1e-30)
    return out.bfloat16() if round_out else out


_SM90_CASES = {   # the two head dims the LM paths run, S about 2048
    "d256_gemma2_group2_softcap_window": dict(
        BH=2, BKV=1, S=2048, D=256, causal=True, window=700, softcap=50.0,
        block_k=64),
    "d80_zamba2_causal": dict(BH=2, BKV=2, S=2048, D=80, causal=True,
                              window=0, softcap=0.0, block_k=128),
}


def _sm90_inputs(case, seed):
    c = _SM90_CASES[case]
    q, k, v = _qkv(c["BH"], c["BKV"], c["S"], c["S"], c["D"], seed=seed)
    kw = {n: c[n] for n in ("causal", "window", "softcap")}
    return [torch.from_numpy(a).bfloat16() for a in (q, k, v)], kw, \
        c["block_k"]


@pytest.mark.parametrize("case", sorted(_SM90_CASES))
def test_sm90_arithmetic_holds_the_card_limit(case):
    """hi + lo P, f32 sums and one output rounding stay within half an ulp
    plus 2e-5 of the f32 function, element by element."""
    (q, k, v), kw, block_k = _sm90_inputs(case, seed=30)
    out = _sm90_emulation(q, k, v, block_k=block_k, **kw)
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    assert out.dtype == torch.bfloat16
    used = ((out.float() - ref).abs()
            / (CARD_RTOL * ref.abs() + CARD_ATOL)).max().item()
    assert used <= 1.0, used


@pytest.mark.parametrize("case", sorted(_SM90_CASES))
def test_sm90_single_bf16_p_is_16x_worse(case):
    """Why P is split: carried as one bf16, its 2^-9 relative error per
    weight gives at least 16x the error of the split, before the output's
    rounding."""
    (q, k, v), kw, block_k = _sm90_inputs(case, seed=31)
    ref = attention_ref(q.float(), k.float(), v.float(), **kw)
    errs = [(_sm90_emulation(q, k, v, block_k=block_k, split=split,
                             round_out=False, **kw) - ref).abs().max().item()
            for split in (True, False)]
    assert errs[1] >= 16 * errs[0], errs


# --- dispatch -------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 16, 16, 16))
    before = FA.launches
    out = ops.flash_attention(q.view(1, 4, 16, 16).transpose(1, 2),
                              k.view(1, 2, 16, 16).transpose(1, 2),
                              v.view(1, 2, 16, 16).transpose(1, 2))
    ref = attention_ref(q, k, v).view(1, 4, 16, 16).transpose(1, 2)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert FA.launches == before


def test_plain_context_nests_and_restores():
    assert not ops._plain
    with ops.plain():
        assert ops._use_plain(torch.zeros(1))
        with ops.plain():
            pass
        assert ops._plain
    assert not ops._plain
    with pytest.raises(RuntimeError), ops.plain():
        raise RuntimeError
    assert not ops._plain


@pytest.mark.parametrize("S,T,window", [(100, 37, 16), (53, 37, 16),
                                        (9, 1, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_rows_without_a_visible_key_are_refused(S, T, window, causal):
    """S >= T + window leaves the last rows no key: refused on the CPU and
    under ``plain()`` as on the card, where the kernel would give 0 and
    the reference the mean of v."""
    q, k, v = (torch.from_numpy(a).view(1, n, L, 16).transpose(1, 2)
               for a, n, L in zip(_qkv(4, 2, S, T, 16), (4, 2, 2),
                                  (S, T, T)))
    with pytest.raises(ValueError, match="no visible key"):
        ops.flash_attention(q, k, v, causal=causal, window=window)
    with pytest.raises(ValueError, match="no visible key"), ops.plain():
        ops.flash_attention(q, k, v, causal=causal, window=window)


@pytest.mark.parametrize("causal", [True, False])
def test_last_row_with_one_visible_key_is_taken(causal):
    """At S = T + window - 1 the last row sees one key, and the op computes
    the reference's function."""
    S, T, window = 52, 37, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, S, T, 16, seed=4))
    kw = dict(causal=causal, window=window, softcap=50.0)
    out = ops.flash_attention(q.view(1, 4, S, 16).transpose(1, 2),
                              k.view(1, 2, T, 16).transpose(1, 2),
                              v.view(1, 2, T, 16).transpose(1, 2), **kw)
    ref = attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.transpose(1, 2).reshape(4, S, 16), ref,
                               atol=0, rtol=0)
    torch.testing.assert_close(ref[:, -1], v.repeat_interleave(2, 0)[:, -1],
                               atol=0, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_kernel(q, q, q)


@pytest.mark.parametrize("name", ["gemma2-2b", "gemma2-2b-smoke"])
def test_gemma2_head_dim_is_built(name):
    assert get_config(name).resolved_head_dim in FA.HEAD_DIMS
