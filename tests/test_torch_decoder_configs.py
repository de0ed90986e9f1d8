"""The port's decoder-only builder at the six configs it gained with the MoE
FFN, the dense first layer and the VLM prefix: deepseek-moe-16b,
granite-moe-1b-a400m, phi3-mini-3.8b, qwen3-32b, minicpm-2b and
paligemma-3b.  Each smoke config's forward and decode against the JAX
package's, with JAX-made parameters carried across by ``params_from_jax``;
each config, smoke and full, field by field; each full-width tree against
``jax.eval_shape``; and ``_stack_init``'s draws."""

import dataclasses
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import api as API
from repro_torch.models import build_model
from repro_torch.models.api import DecoderLM, init_decoder_params, param_count
from repro_torch.weights import params_from_jax

NAMES = ["deepseek-moe-16b", "granite-moe-1b-a400m", "phi3-mini-3.8b",
         "qwen3-32b", "minicpm-2b", "paligemma-3b"]
MOE_NAMES = NAMES[:2]
B, S = 2, 12
LOGITS_ATOL = 1e-4    # f32, summed in another order than XLA's
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-3   # as test_arch_smoke.py
# Full-width parameter counts, from ``jax.eval_shape`` of the JAX init.
FULL_PARAMS = {"deepseek-moe-16b": 16_375_728_128}


@functools.cache
def _jax(name, dtype="float32", **changes):
    cfg = dataclasses.replace(jax_get_config(name + "-smoke"), dtype=dtype,
                              param_dtype=dtype, **changes)
    model = jax_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port(name, dtype="float32", **changes):
    cfg = dataclasses.replace(get_config(name + "-smoke"), dtype=dtype,
                              param_dtype=dtype, **changes)
    tree = jax.tree.map(np.asarray, _jax(name, dtype, **changes)[1])
    return build_model(cfg, device="cpu"), DecoderLM(
        cfg, params=params_from_jax(tree, "cpu", cfg), device="cpu")


def _decode_all(model, net, toks):
    cache = model.init_cache(toks.shape[0], toks.shape[1])
    out = []
    for t in range(toks.shape[1]):
        lg, cache = model.decode_step(net, cache,
                                      torch.from_numpy(toks[:, t:t + 1]), t)
        out.append(lg)
    return torch.cat(out, 1)


@functools.cache
def _case(name):
    """Tokens, JAX's forward logits and aux, JAX's decode logits."""
    jm, jp = _jax(name)
    toks = np.random.default_rng(0).integers(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    logits, aux = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    decode = jax.jit(jm.decode_step)
    cache, steps = jm.init_cache(B, S), []
    for t in range(S):
        lg, cache = decode(jp, cache, jnp.asarray(toks[:, t:t + 1]), t)
        steps.append(np.asarray(lg))
    return toks, np.asarray(logits), float(aux), np.concatenate(steps, 1)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    toks, ref, ref_aux, _ = _case(name)
    model, net = _port(name)
    before = FA.launches
    logits, aux = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert FA.launches == before          # the CPU path launches nothing
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGITS_ATOL)
    assert aux.item() == pytest.approx(ref_aux, abs=1e-6)
    assert (aux.item() > 0) == (name in MOE_NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_jax_decode(name):
    toks, _, _, ref = _case(name)
    model, net = _port(name)
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(), ref,
                               atol=LOGITS_ATOL)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_decode_matches_own_forward_without_drops(name):
    """At ``moe_capacity_factor = E/K`` the capacity is every token, so the
    forward drops nothing and routes as the decode steps do."""
    cfg = get_config(name + "-smoke")
    no_drop = cfg.moe_num_experts / cfg.moe_top_k
    model, net = _port(name, moe_capacity_factor=no_drop)
    toks = _case(name)[0]
    full, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_paligemma_prefix_forward_matches_jax():
    """256 patch embeddings in front (4 at smoke size): positions over the
    whole length, the tokens see the prefix, the prefix rows cut off."""
    jm, jp = _jax("paligemma-3b")
    model, net = _port("paligemma-3b")
    toks = _case("paligemma-3b")[0]
    prefix = np.random.default_rng(1).standard_normal(
        (B, model.cfg.num_prefix_tokens, model.cfg.d_model)).astype(
            np.float32)
    ref, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks),
                                      "prefix_embed": jnp.asarray(prefix)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks),
                                 "prefix_embed": torch.from_numpy(prefix)})
    assert out.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGITS_ATOL)
    plain, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert (out - plain).abs().max().item() > 1e-3   # the prefix is seen
    cache = model.init_cache(B, S)
    assert cache["layers"]["k"].shape[2] == S + model.cfg.num_prefix_tokens


def _same_experts(tree):
    """The tree with every routed expert set to expert 0."""
    moe = {k: (np.broadcast_to(v[:, :1], v.shape).copy()
               if k in ("w_gate", "w_up", "w_down") else v)
           for k, v in tree["layers"]["moe"].items()}
    return dict(tree, layers=dict(tree["layers"], moe=moe))


def test_deepseek_bf16_forward_matches_jax():
    """The bf16 MoE path end to end on the CPU (dense0, the f32 router, the
    dispatch, the bf16 expert products, the gates, the shared expert).  The
    packages round bf16 at other places, so the bound is four bf16 ulps
    (2**-7 each) of the largest logit: about 4 here (an untied head), where
    the logits leave their bf16 product with ulps of 2**-5.

    With random experts a one-ulp difference of the residual stream flips
    top-k choices at this router's smallest gaps (1.7e-4 between the 2nd and
    3rd probability, measured) and moves logits by up to 0.83 (measured),
    by the JAX semantics themselves.  So every routed expert here is expert
    0 and the capacity is every token (``moe_capacity_factor = E/K``): the
    output no longer depends on which experts the top-k picks, and still on
    each token's dispatch, gather and gates.  The f32 tests hold the routing
    itself; ``test_torch_moe.py`` holds the bf16 FFN with random experts."""
    cfg = get_config("deepseek-moe-16b-smoke")
    changes = dict(dtype="bfloat16", param_dtype="bfloat16",
                   moe_capacity_factor=cfg.moe_num_experts / cfg.moe_top_k)
    cfg = dataclasses.replace(cfg, **changes)
    jm = jax_build_model(dataclasses.replace(
        jax_get_config("deepseek-moe-16b-smoke"), **changes))
    tree = _same_experts(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    model = build_model(cfg, device="cpu")
    net = DecoderLM(cfg, params=params_from_jax(tree, "cpu", cfg),
                    device="cpu")
    assert net.params["layers"]["moe"]["router"].dtype == torch.float32
    assert net.params["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    toks = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)
    ref, _ = jm.forward(jax.tree.map(jnp.asarray, tree),
                        {"tokens": jnp.asarray(toks)})
    ref = np.asarray(ref)
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=4 * 2**-7 * np.abs(ref).max())


# --- configs and the full-width trees -------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_jax(name, smoke):
    cfg, ref = get_config(name, smoke), jax_get_config(name, smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert cfg.resolved_head_dim == ref.resolved_head_dim
    assert [cfg.window_for_layer(i) for i in range(cfg.num_layers)] == \
        [ref.window_for_layer(i) for i in range(ref.num_layers)]


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("name", NAMES)
def test_full_width_tree_matches_jax_layout(name):
    """Every key, shape and dtype of the tree at full width, from the
    port's init on the meta device and JAX's ``eval_shape``."""
    cfg = get_config(name)
    jm = jax_build_model(jax_get_config(name))
    flat_ref = _flat(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    tree = init_decoder_params(torch.Generator(), cfg, device="meta")
    flat = _flat(jax.tree.map(lambda t: t, tree))
    assert flat.keys() == flat_ref.keys()
    for k, v in flat.items():
        assert tuple(v.shape) == flat_ref[k].shape, k
        assert str(v.dtype).removeprefix("torch.") == \
            str(flat_ref[k].dtype), k
    n = sum(v.size for v in flat_ref.values())
    assert param_count(tree) == n
    assert n == FULL_PARAMS.get(name, n)
    if cfg.moe_num_experts:
        assert tree["layers"]["moe"]["router"].dtype == torch.float32
        n_dense = API.dense_layers(cfg)
        assert ("dense0" in tree) == (n_dense > 0)
        assert tree["layers"]["moe"]["w_gate"].shape == (
            cfg.num_layers - n_dense, cfg.moe_num_experts, cfg.d_model,
            cfg.moe_d_ff)


def test_deepseek_tree_round_trips_with_f32_router():
    """A bf16 MoE tree from JAX: every leaf carried bit for bit, the
    router in f32, the rest in bf16."""
    tree = jax.tree.map(np.asarray, _jax("deepseek-moe-16b", "bfloat16")[1])
    cfg = dataclasses.replace(get_config("deepseek-moe-16b-smoke"),
                              dtype="bfloat16", param_dtype="bfloat16")
    out = _flat(params_from_jax(tree, "cpu", cfg))
    ref = _flat(tree)
    assert out.keys() == ref.keys() and "['dense0']['mlp']['w_up']" in out
    for k, arr in ref.items():
        t = out[k]
        if k.endswith("['router']"):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), arr)
        else:
            assert t.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          arr.view(np.int16))


# --- _stack_init -----------------------------------------------------------------

def _list_then_stack(init_fn, n):
    """What ``_stack_init`` did before it drew into a preallocated stack."""
    trees = [init_fn() for _ in range(n)]

    def stack(ts):
        return {k: stack([t[k] for t in ts]) if isinstance(v, dict)
                else torch.stack([t[k] for t in ts])
                for k, v in ts[0].items()}
    return stack(trees)


@pytest.mark.parametrize("name", ["deepseek-moe-16b-smoke", "gemma2-2b-smoke",
                                  "zamba2-2.7b-smoke"])
def test_stack_init_draws_as_list_then_stack(name):
    """The same draws in the same order, bit for bit, with nested stacks
    (the hybrid's (U, K) units) too."""
    cfg = get_config(name)
    init = (API.init_hybrid_params if cfg.family == "hybrid"
            else API.init_decoder_params)
    got = _flat(init(torch.Generator().manual_seed(5), cfg, "cpu"))
    orig = API._stack_init
    try:
        API._stack_init = _list_then_stack
        want = _flat(init(torch.Generator().manual_seed(5), cfg, "cpu"))
    finally:
        API._stack_init = orig
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_stack_init_holds_one_tree_beside_the_stack():
    """Each tree is copied into the stack as soon as it is drawn."""
    alive = []

    def draw():
        alive.append(sum(1 for t in made if t() is not None))
        t = torch.zeros(3)
        made.append(weakref.ref(t))
        return {"w": t}
    made: list = []
    out = API._stack_init(draw, 4)
    assert out["w"].shape == (4, 3)
    assert max(alive) <= 1
