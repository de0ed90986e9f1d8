"""The port's encoder-decoder (whisper-large-v3) against the JAX package's:
the smoke config in f32 with JAX-made parameters carried across by
``params_from_jax``; ``encode``, ``forward``, ``fill_cross_cache`` and the
decode steps after it, the non-causal encoder block and the cross
``attention``, the sinusoid, the serving engine, the config, the
full-width tree, and the entry points."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import api as JAPI
from repro.models import blocks as JB
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import api as API
from repro_torch.models import blocks as B
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.api import EncDecLM, init_encdec_params, param_count
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_jax

NAME = "whisper-large-v3"
ARCH = NAME + "-smoke"
BATCH, S = 2, 10      # 10 target tokens against the smoke config's 16 frames
LOGITS_ATOL = 1e-4    # f32, summed in another order than XLA's
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-3   # as test_arch_smoke.py
# Full-width parameter count, from ``jax.eval_shape`` of the JAX init: 32
# encoder and 32 decoder layers of d 1280 with JAX's gated MLP (three
# 1280x5120 matrices), cross-attention in every decoder layer, and the
# tied 51866-word embedding.
FULL_PARAMS = 1_954_032_640


@functools.cache
def _jax():
    model = jax_build_model(jax_get_config(ARCH))
    return model, model.init(jax.random.PRNGKey(0))


@functools.cache
def _tree():
    return jax.tree.map(np.asarray, _jax()[1])


def _port():
    cfg = get_config(ARCH)
    return build_model(cfg, device="cpu"), EncDecLM(
        cfg, params=params_from_jax(_tree(), "cpu", cfg), device="cpu")


@functools.cache
def _inputs():
    cfg = get_config(ARCH)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    frames = rng.standard_normal(
        (BATCH, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return toks, frames


@functools.cache
def _jax_case():
    """JAX's encoder output, forward logits, filled cross cache and the
    decode logits of every position after it."""
    jm, jp = _jax()
    toks, frames = _inputs()
    enc = jm.encode(jp, jnp.asarray(frames))
    logits, _ = jm.forward(jp, {"tokens": jnp.asarray(toks),
                                "enc_frames": jnp.asarray(frames)})
    cache = jm.fill_cross_cache(jp, jm.init_cache(BATCH, S),
                                jnp.asarray(frames))
    filled = jax.tree.map(np.asarray, cache)
    decode, steps = jax.jit(jm.decode_step), []
    for t in range(S):
        lg, cache = decode(jp, cache, jnp.asarray(toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    return (np.asarray(enc), np.asarray(logits), filled,
            np.concatenate(steps, 1))


@pytest.fixture(scope="module")
def port():
    return _port()


def _decode_all(model, net, cache, toks):
    out = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(net, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        out.append(lg)
    return torch.cat(out, 1)


def test_encode_matches_jax(port):
    model, net = port
    _, frames = _inputs()
    before = FA.launches
    out = model.encode(net, torch.from_numpy(frames))
    assert FA.launches == before          # the CPU path launches nothing
    assert out.shape == frames.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_case()[0], atol=LOGITS_ATOL)


def test_forward_matches_jax(port):
    model, net = port
    toks, frames = _inputs()
    logits, aux = model.forward(net, {"tokens": torch.from_numpy(toks),
                                      "enc_frames": torch.from_numpy(frames)})
    assert logits.dtype == torch.float32 and aux.item() == 0.0
    assert logits.shape == (BATCH, S, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), _jax_case()[1],
                               atol=LOGITS_ATOL)
    torch.testing.assert_close(net(torch.from_numpy(toks),
                                   torch.from_numpy(frames)), logits,
                               atol=0, rtol=0)


def test_fill_cross_cache_matches_jax(port):
    model, net = port
    _, frames = _inputs()
    cfg = model.cfg
    cache = model.init_cache(BATCH, S)
    want = (cfg.num_layers, BATCH, cfg.encoder_seq_len, cfg.num_kv_heads,
            cfg.resolved_head_dim)
    assert tuple(cache["dec"]["xk"].shape) == want
    assert not cache["dec"]["xk"].any()
    filled = model.fill_cross_cache(net, cache, torch.from_numpy(frames))
    assert filled is cache
    ref = _jax_case()[2]["dec"]
    assert sorted(filled["dec"]) == sorted(ref) == ["k", "v", "xk", "xv"]
    for name in ("xk", "xv"):
        assert tuple(filled["dec"][name].shape) == want
        np.testing.assert_allclose(filled["dec"][name].numpy(), ref[name],
                                   atol=LOGITS_ATOL)
    for name in ("k", "v"):               # the self-attention cache: zeros
        assert not filled["dec"][name].any() and not ref[name].any()


def test_decode_steps_after_fill_match_jax(port):
    model, net = port
    toks, frames = _inputs()
    cache = model.fill_cross_cache(net, model.init_cache(BATCH, S),
                                   torch.from_numpy(frames))
    before = FA.launches
    steps = _decode_all(model, net, cache, toks)
    assert FA.launches == before
    np.testing.assert_allclose(steps.numpy(), _jax_case()[3],
                               atol=LOGITS_ATOL)


def test_teacher_forced_decode_matches_own_forward(port):
    model, net = port
    toks, frames = _inputs()
    full, _ = model.forward(net, {"tokens": torch.from_numpy(toks),
                                  "enc_frames": torch.from_numpy(frames)})
    cache = model.fill_cross_cache(net, model.init_cache(BATCH, S),
                                   torch.from_numpy(frames))
    np.testing.assert_allclose(_decode_all(model, net, cache, toks).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


@pytest.mark.parametrize("t_len", [16, 7], ids=["frames", "ragged"])
def test_cross_attention_matches_jax(t_len):
    """``L.attention(kv_override=)`` over T encoder rows (T != S), against
    JAX's with its all-ones mask."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    lp = API._layer(_tree()["dec"], 0)["xattn"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, S, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((BATCH, t_len, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (BATCH, S))
    ref = JL.attention(lp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                       mask=jnp.ones((1, S, t_len), bool),
                       kv_override=jnp.asarray(src))
    out = L.attention({k: torch.tensor(v) for k, v in lp.items()},
                      torch.from_numpy(x), cfg,
                      positions=torch.from_numpy(pos.copy()), window=0,
                      causal=False, kv_override=torch.from_numpy(src))
    assert out.shape == (BATCH, S, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stack", ["enc", "dec"])
def test_blocks_match_jax(stack):
    """The encoder block, non-causal, and the decoder block with
    cross-attention to an encoder output, against JAX's ``attn_block``
    with all-ones (encoder, cross) and causal (self) masks."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    lp = API._layer(_tree()[stack], 1)
    rng = np.random.default_rng(2)
    F = cfg.encoder_seq_len
    n = F if stack == "enc" else S
    x = rng.standard_normal((BATCH, n, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((BATCH, F, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(n), (BATCH, n))
    if stack == "enc":
        kw = dict(mask=jnp.ones((1, n, n), bool))
        tkw = dict(causal=False)
    else:
        kw = dict(mask=JL.causal_mask(n, n), enc_out=jnp.asarray(enc),
                  enc_mask=jnp.ones((1, n, F), bool))
        tkw = dict(enc_out=torch.from_numpy(enc))
    ref, _ = JB.attn_block(lp, jnp.asarray(x), jcfg,
                           positions=jnp.asarray(pos), **kw)
    tp = jax.tree.map(torch.tensor, lp)
    out, aux = B.attn_block(tp, torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos.copy()), window=0,
                            **tkw)
    assert aux.item() == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


# Both sides compute exp(arange(0, d, 2) * (-log(10000) / d)) in f32, but
# their exp is not correctly rounded in the same places (XLA's CPU exp
# misses the nearest f32 at 70 of whisper's 640 frequencies, PyTorch's at
# 11), so ``div`` may differ by an ulp (2**-24 below 1).  At position p
# that moves pos * div by up to p * 2**-24 before rounding, and each side
# then rounds the product to f32, whose ulp is 2**-13 for products in
# [1024, 2048): measured, the two tables differ by exactly 2**-13 at
# some entries.  sin and cos add their own half ulps.
SIN_ATOL = 1500 * 2**-24 + 2**-13 + 2**-23


def test_sinusoid_matches_jax():
    out = API._sinusoid(1500, 1280, torch.float32)
    ref = np.asarray(JAPI._sinusoid(1500, 1280, jnp.float32))
    assert out.shape == (1500, 1280) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=SIN_ATOL)
    # the first rows, where the products are small, agree far closer
    np.testing.assert_allclose(out[:8].numpy(), ref[:8], atol=1e-6)
    assert API._sinusoid(4, 8, torch.bfloat16).dtype == torch.bfloat16
    div = math.exp(-math.log(10000.0) * 2 / 8)
    np.testing.assert_allclose(API._sinusoid(4, 8, torch.float32)[3, 2:4],
                               [math.sin(3 * div), math.cos(3 * div)],
                               atol=1e-6)


def test_engine_lockstep_matches_jax_engine(port):
    """Neither engine fills the cross cache: both decode against its
    zeros, so the cross-attention adds nothing and the tokens agree."""
    model, net = port
    jm, jp = _jax()
    toks, _ = _inputs()
    plen, new = 6, 4
    prompts = [list(map(int, p)) for p in toks[:, :plen]]
    ref = JaxServeEngine(jm, jp, batch_slots=BATCH,
                         max_len=plen + new).run_lockstep(prompts, new)
    outs = ServeEngine(model, net, batch_slots=BATCH,
                       max_len=plen + new).run_lockstep(prompts, new)
    assert outs == ref
    assert all(len(o) == new for o in outs)


# --- build_model, the config and the full-width tree -----------------------------

def test_model_carries_encode_and_fill_cross_cache():
    model = build_model(get_config(ARCH), device="cpu")
    assert model.encode is API.encdec_encode
    assert model.fill_cross_cache is API.encdec_fill_cross_cache
    assert isinstance(model.init(seed=0), EncDecLM)
    other = build_model(get_config("gemma2-2b-smoke"), device="cpu")
    assert other.encode is None and other.fill_cross_cache is None


@pytest.mark.parametrize("name", [NAME, ARCH])
def test_config_matches_jax(name):
    cfg, ref = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert cfg.resolved_head_dim == ref.resolved_head_dim == (
        64 if name == NAME else 16)


def test_full_width_tree_matches_jax_layout():
    """Every key, shape and dtype of whisper-large-v3's tree, at full width
    and depth, from the port's init on the meta device and JAX's
    ``eval_shape``."""
    cfg = get_config(NAME)
    jm = jax_build_model(jax_get_config(NAME))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = init_encdec_params(torch.Generator(), cfg, device="meta")
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert flat.keys() == flat_ref.keys()
    for k, v in flat.items():
        assert tuple(v.shape) == flat_ref[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(flat_ref[k].dtype)
    assert param_count(tree) == sum(v.size for v in flat_ref.values()) \
        == FULL_PARAMS
    assert tree["dec"]["xattn"]["wk"].shape == (32, 1280, 1280)
    assert tree["enc"]["mlp"]["w_up"].shape == (32, 1280, 5120)
    assert "xattn" not in tree["enc"]


def test_wrong_tree_raises():
    cfg = get_config(ARCH)
    tree = _tree()
    bad = dict(tree, dec={k: v for k, v in tree["dec"].items()
                          if k != "xattn"})
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(bad, "cpu", cfg)
    bad = {k: v for k, v in tree.items() if k != "enc_norm"}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(bad, "cpu", cfg)


# --- entry points ----------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda dev: build_model(get_config(ARCH), device=dev),
    lambda dev: EncDecLM(get_config(ARCH), device=dev),
    lambda dev: params_from_jax(_tree(), dev, get_config(ARCH)),
])
def test_entry_points_need_a_card_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(dev)
    entry("cpu")
