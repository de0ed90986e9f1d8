"""The port's decoder-only LM (gemma2-2b) and its serving engine against the
JAX package's, with JAX-made parameters carried across by
``params_from_jax``; configs, weights and entry points of the slice."""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import build_model
from repro_torch.models.api import DecoderLM, init_decoder_params, param_count
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
ARCH = "gemma2-2b-smoke"
B, S = 2, 12          # S > the smoke window of 8, so local layers mask
LOGITS_ATOL = 1e-4    # f32, summed in another order than XLA's
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-3   # as test_arch_smoke.py


@functools.cache
def _jax_model(dtype="float32"):
    cfg = dataclasses.replace(jax_get_config(ARCH), dtype=dtype,
                              param_dtype=dtype)
    model = jax_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port(dtype="float32"):
    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype,
                              param_dtype=dtype)
    tree = jax.tree.map(np.asarray, _jax_model(dtype)[1])
    return build_model(cfg, device="cpu"), DecoderLM(
        cfg, params=params_from_jax(tree, "cpu", cfg), device="cpu")


@pytest.fixture(scope="module")
def case():
    jm, jp = _jax_model()
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    logits, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    decode = jax.jit(jm.decode_step)
    cache, steps = jm.init_cache(B, S), []
    for t in range(S):
        lg, cache = decode(jp, cache, jnp.asarray(toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    model, net = _port()
    return toks, np.asarray(logits), np.concatenate(steps, 1), model, net


def _decode_all(model, net, toks):
    cache = model.init_cache(toks.shape[0], toks.shape[1])
    out = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(net, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        out.append(lg)
    return torch.cat(out, 1)


def test_forward_matches_jax(case):
    toks, ref, _, model, net = case
    before = FA.launches
    logits, aux = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert FA.launches == before          # the CPU path launches nothing
    assert logits.dtype == torch.float32 and aux.item() == 0.0
    assert logits.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGITS_ATOL)


def test_decode_matches_jax_decode(case):
    toks, _, ref, model, net = case
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(), ref,
                               atol=LOGITS_ATOL)


def test_decode_matches_own_forward(case):
    toks, _, _, model, net = case
    full, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_engine_lockstep_equals_manual_stepping(case):
    toks, _, _, model, net = case
    plen, new = 6, 5
    prompts = [list(map(int, p)) for p in toks[:, :plen]]
    outs = ServeEngine(model, net, batch_slots=3,
                       max_len=plen + new).run_lockstep(prompts, new)
    cache = model.init_cache(3, plen + new)
    cur = np.zeros((3, 1), np.int64)
    expect = [[] for _ in prompts]
    for t in range(plen + new - 1):
        if t < plen:
            cur[:B, 0] = toks[:, t]
        lg, cache = model.decode_step(net, cache, torch.from_numpy(cur), t)
        nxt = lg[:, -1].argmax(-1).numpy()
        if t >= plen - 1:
            for b in range(B):
                expect[b].append(int(nxt[b]))
            cur[:, 0] = nxt
    assert outs == expect
    assert all(len(o) == new for o in outs)


def test_engine_first_token_is_forward_argmax(case):
    """The ``examples/serve_lm.py`` cross-check, against JAX's logits."""
    toks, ref, _, model, net = case
    outs = ServeEngine(model, net, batch_slots=B,
                       max_len=S + 2).run_lockstep(
        [list(map(int, p)) for p in toks], 1)
    top2 = np.sort(ref[:, -1], axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 10 * LOGITS_ATOL
    got = np.array([o[0] for o in outs])
    np.testing.assert_array_equal(got[sure], ref[:, -1].argmax(-1)[sure])


def test_engine_refuses_what_lockstep_cannot_take(case):
    _, _, _, model, net = case
    eng = ServeEngine(model, net, batch_slots=2, max_len=4)
    with pytest.raises(ValueError, match="slots"):
        eng.run_lockstep([[1], [2], [3]], 1)
    with pytest.raises(ValueError, match="equal length"):
        eng.run_lockstep([[1, 2], [3]], 1)
    with pytest.raises(ValueError, match="max_len"):
        eng.run_lockstep([[1, 2, 3]], 2)


# --- configs and the full-width tree -------------------------------------------

@pytest.mark.parametrize("name", ["gemma2-2b", "gemma2-2b-smoke",
                                  "zamba2-2.7b", "zamba2-2.7b-smoke"])
def test_config_matches_jax(name):
    cfg, ref = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert [cfg.window_for_layer(i) for i in range(cfg.num_layers)] == \
        [ref.window_for_layer(i) for i in range(ref.num_layers)]


def test_full_width_tree_matches_jax_layout():
    """Every key, shape and dtype of gemma2-2b's tree, at full width, from
    the port's init on the meta device and JAX's ``eval_shape``."""
    cfg = get_config("gemma2-2b")
    jm = jax_build_model(jax_get_config("gemma2-2b"))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = init_decoder_params(torch.Generator(), cfg, device="meta")
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda t: t, tree))[0]}
    assert flat.keys() == flat_ref.keys()
    for k, v in flat.items():
        assert tuple(v.shape) == flat_ref[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == str(flat_ref[k].dtype)
    assert param_count(tree) == sum(v.size for v in flat_ref.values())
    assert 2.61e9 < param_count(tree) < 2.62e9
    assert tree["layers"]["attn"]["wq"].shape == (26, 2304, 2048)


def test_init_shapes_dtypes_and_scale():
    cfg = get_config(ARCH)
    p = init_decoder_params(torch.Generator().manual_seed(0), cfg, "cpu")
    again = init_decoder_params(torch.Generator().manual_seed(0), cfg, "cpu")
    torch.testing.assert_close(p["embed"], again["embed"], atol=0, rtol=0)
    assert p["embed"].std().item() == pytest.approx(0.02, rel=0.1)
    wq = p["layers"]["attn"]["wq"]
    assert wq.shape == (4, 64, 64) and wq.dtype == torch.float32
    assert wq.std().item() == pytest.approx(64 ** -0.5, rel=0.1)
    assert not torch.equal(wq[0], wq[1])      # each layer drawn anew
    assert torch.equal(p["layers"]["ln1_post"], torch.ones(4, 64))


# --- weights ----------------------------------------------------------------------

def test_bf16_tree_round_trips_bit_for_bit():
    tree = jax.tree.map(np.asarray, _jax_model("bfloat16")[1])
    cfg = dataclasses.replace(get_config(ARCH), dtype="bfloat16",
                              param_dtype="bfloat16")
    out = params_from_jax(tree, "cpu", cfg)
    ref_leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    assert len(got) == len(ref_leaves)
    for path, arr in ref_leaves:
        t = got[path]
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      arr.view(np.int16))


def test_bf16_forward_matches_jax():
    """The bf16 path end to end on the CPU: the packages round bf16 at other
    places, so the bound is four bf16 ulps (2**-7 each) of logits of size
    about 1."""
    jm, jp = _jax_model("bfloat16")
    model, net = _port("bfloat16")
    toks = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=4 * 2**-7)


def test_wrong_key_or_shape_raises():
    cfg = get_config(ARCH)
    tree = jax.tree.map(np.asarray, _jax_model()[1])
    bad = dict(tree, layers=dict(tree["layers"], extra=tree["final_norm"]))
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, "cpu", cfg)
    bad = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError, match="missing"):
        params_from_jax(bad, "cpu", cfg)
    bad = dict(tree, embed=tree["embed"][:, :32])
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, "cpu", cfg)
    bad = dict(tree, embed=tree["embed"].astype(np.int32))
    with pytest.raises(TypeError, match="floating"):
        params_from_jax(bad, "cpu", cfg)


# --- entry points ----------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda dev: build_model(get_config(ARCH), device=dev),
    lambda dev: DecoderLM(get_config(ARCH), device=dev),
    lambda dev: params_from_jax(jax.tree.map(np.asarray, _jax_model()[1]),
                                dev, get_config(ARCH)),
])
def test_lm_entry_points_need_a_card_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(dev)
    entry("cpu")


@pytest.mark.parametrize("family", ["audio", "ssm"])
def test_other_families_build_as_decoder_only(family):
    """JAX's ``build_model`` builds any family that no earlier branch takes
    (``audio`` without ``is_encoder_decoder``, ``ssm`` without
    ``xlstm_slstm_every``) as a decoder-only LM; so does the port, and its
    forward agrees with JAX's on the same parameters."""
    jcfg = dataclasses.replace(jax_get_config(ARCH), family=family)
    cfg = dataclasses.replace(get_config(ARCH), family=family)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    net = model.init(seed=0)
    assert type(net) is DecoderLM
    net = DecoderLM(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu", cfg), device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGITS_ATOL)


@pytest.mark.parametrize("family,experts", [("moe", 4), ("dense", 4),
                                            ("moe", 0)])
def test_decoder_families_build_and_run(family, experts):
    """The decoder-only builder takes dense, moe and vlm with or without
    experts, as JAX's ``build_model`` does: with experts every layer's FFN
    is the MoE, without them a gated MLP."""
    cfg = dataclasses.replace(get_config(ARCH), family=family,
                              moe_num_experts=experts, moe_top_k=2,
                              moe_d_ff=32)
    model = build_model(cfg, device="cpu")
    net = model.init(seed=0)
    assert ("moe" in net.params["layers"]) == bool(experts)
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(0))
    logits, aux = model.forward(net, {"tokens": toks})
    assert logits.shape == (2, 10, cfg.vocab_size)
    assert torch.isfinite(logits).all() and (aux.item() > 0) == bool(experts)
    step, _ = model.decode_step(net, model.init_cache(2, 10), toks[:, :1], 0)
    torch.testing.assert_close(step[:, 0], logits[:, 0], atol=2e-3,
                               rtol=1e-3)


def test_model_init_draws_from_seed():
    model = build_model(get_config(ARCH), device="cpu")
    a, b = model.init(seed=3), model.init(seed=3)
    torch.testing.assert_close(a.params["embed"], b.params["embed"], atol=0,
                               rtol=0)
    assert dict(a.named_buffers())["layers__attn__wq"] is \
        a.params["layers"]["attn"]["wq"]


def test_serve_imports_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.models.api; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env)


# --- examples/serve_lm_torch.py ------------------------------------------------

def test_serve_example_runs_on_cpu():
    """The port's ``examples/serve_lm.py``: the engine's first tokens equal
    the forward's argmax (the script raises otherwise)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_lm_torch.py"),
         "--device", "cpu"], check=True, env=env, capture_output=True,
        text=True, timeout=300).stdout
    assert "engine output matches forward argmax ✓" in out
    assert "tok/s on the CPU" in out and out.count("req") == 4
