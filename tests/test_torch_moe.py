"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, with JAX-made parameters carried across, and the
routing properties of ``tests/test_moe.py`` on the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as JMOE
from repro_torch.configs import get_config
from repro_torch.models import moe as MOE

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

ATOL = 1e-5          # f32, products summed in another order than XLA's
GRANITE = "granite-moe-1b-a400m-smoke"
DEEPSEEK = "deepseek-moe-16b-smoke"


def _cfgs(name, **changes):
    return (dataclasses.replace(get_config(name), **changes),
            dataclasses.replace(jax_get_config(name), **changes))


def _params(jcfg, seed=3):
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, _tensors(jax.tree.map(np.asarray, jp))


def _tensors(tree):
    """JAX's arrays as tensors of the same dtype (bf16 through its 16-bit
    pattern)."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _jax_keep(jp, x, jcfg):
    """The JAX function's kept assignments, by the lines of its dispatch:
    the (T·K,) mask in token-major, descending-gate order."""
    E, K = jcfg.moe_num_experts, jcfg.moe_top_k
    xt = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, sel = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(sel.reshape(-1), E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1)
    return np.asarray(pos <= JMOE.capacity_for(xt.shape[0], jcfg))


def _both(name, x, **changes):
    cfg, jcfg = _cfgs(name, **changes)
    jp, p = _params(jcfg)
    ref, ref_aux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
    out, aux = MOE.moe_ffn(p, torch.from_numpy(x), cfg)
    return (out, aux), (np.asarray(ref), float(ref_aux)), (p, jp, cfg, jcfg)


@pytest.mark.parametrize("name,B,S", [(GRANITE, 2, 12), (GRANITE, 4, 64),
                                      (DEEPSEEK, 2, 12), (DEEPSEEK, 1, 33)])
def test_moe_ffn_matches_jax(name, B, S):
    """Output and aux; deepseek's smoke keeps one shared expert."""
    (out, aux), (ref, ref_aux), (p, _, cfg, _) = _both(name, _x(
        get_config(name), B, S))
    assert ("shared" in p) == (name == DEEPSEEK)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert aux.item() == pytest.approx(ref_aux, abs=ATOL)


@pytest.mark.parametrize("case", ["identical_tokens", "capacity_0.5"])
@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_moe_ffn_drops_what_jax_drops(name, case):
    """A drop case made on purpose: identical tokens all route alike, or
    the capacity is halved; the port keeps exactly JAX's assignments."""
    cfg = get_config(name)
    if case == "identical_tokens":
        x = np.tile(_x(cfg, 1, 1), (2, 9, 1))
        changes = {}
    else:
        x = _x(cfg, 2, 12)
        changes = {"moe_capacity_factor": 0.5}
    (out, aux), (ref, ref_aux), (p, jp, cfg, jcfg) = _both(name, x,
                                                          **changes)
    keep = _jax_keep(jp, x, jcfg)
    r = MOE.route(p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg)
    assert (~keep).sum() > 0
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert aux.item() == pytest.approx(ref_aux, abs=ATOL)


def test_route_slots_are_positions_within_experts():
    """Each kept (expert, slot) pair is taken once, the slots of an expert
    count up from 0 in assignment order, and dropped ones point at C."""
    cfg = dataclasses.replace(get_config(GRANITE), moe_capacity_factor=0.5)
    _, p = _params(_cfgs(GRANITE)[1])
    r = MOE.route(p, torch.from_numpy(_x(cfg, 2, 12)[0]), cfg)
    flat_e = r.sel.reshape(-1)
    for e in range(cfg.moe_num_experts):
        mine = flat_e == e
        n = int(mine.sum())
        want = torch.arange(n)
        want[want >= r.C] = r.C
        assert torch.equal(r.slot[mine], want)
        assert int(r.keep[mine].sum()) == min(n, r.C)
    assert torch.allclose(r.gate_w.sum(-1), torch.ones(12))
    assert (r.gate_w[:, :-1] >= r.gate_w[:, 1:]).all()


def test_router_is_f32_in_a_bf16_tree():
    cfg = get_config("deepseek-moe-16b")
    p = MOE.init_moe(torch.Generator(), cfg, torch.bfloat16, device="meta")
    assert p["router"].dtype == torch.float32
    assert {t.dtype for k, t in p.items() if k != "router"
            and not isinstance(t, dict)} == {torch.bfloat16}
    assert p["w_gate"].shape == (64, 2048, 1408)
    assert p["shared"]["w_down"].shape == (2 * 1408, 2048)


def test_bf16_moe_ffn_matches_jax():
    """bf16 experts and activations with the f32 router, on the same
    inputs: the routing is the same (both route the same bf16 values in
    f32), and the packages round bf16 at other places, so the bound is four
    bf16 ulps (2**-7 each) of the largest output."""
    cfg, jcfg = _cfgs(DEEPSEEK)
    jp = JMOE.init_moe(jax.random.PRNGKey(3), jcfg, jnp.bfloat16)
    p = _tensors(jax.tree.map(np.asarray, jp))
    assert p["router"].dtype == torch.float32
    assert p["w_up"].dtype == torch.bfloat16
    x = torch.from_numpy(_x(cfg, 2, 12)).bfloat16()
    y, aux = MOE.moe_ffn(p, x, cfg)
    ref, ref_aux = JMOE.moe_ffn(jp, jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), jcfg)
    ref = np.asarray(ref.astype(jnp.float32))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), ref,
                               atol=4 * 2**-7 * np.abs(ref).max())
    assert aux.item() == pytest.approx(float(ref_aux), abs=ATOL)


def test_two_runs_give_the_same_bits():
    """Each kept (expert, slot) is written once and no sum is atomic."""
    cfg = dataclasses.replace(get_config(DEEPSEEK), moe_capacity_factor=0.5)
    p = MOE.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    x = torch.from_numpy(_x(cfg, 2, 12)).bfloat16()
    one, _ = MOE.moe_ffn(p, x, cfg)
    two, _ = MOE.moe_ffn(p, x, cfg)
    assert torch.equal(one, two)


# --- the routing properties of tests/test_moe.py, on the port -------------------

CFG = get_config(GRANITE)


def _port_params(cfg, seed=3):
    return MOE.init_moe(torch.Generator().manual_seed(seed), cfg,
                        torch.float32)


def test_output_shape_and_finite():
    y, aux = MOE.moe_ffn(_port_params(CFG), torch.from_numpy(
        _x(CFG, 2, 16)), CFG)
    assert y.shape == (2, 16, CFG.d_model)
    assert torch.isfinite(y).all()
    assert aux.item() > 0


def test_aux_loss_balanced_lower_bound():
    """Perfectly uniform routing gives aux = coef; random tokens come near
    it."""
    _, aux = MOE.moe_ffn(_port_params(CFG), torch.from_numpy(
        _x(CFG, 4, 64)), CFG)
    assert aux.item() >= CFG.moe_aux_loss_coef * 0.99
    assert aux.item() < CFG.moe_aux_loss_coef * 3


@pytest.mark.parametrize("tokens", [1, 24, 64, 256, 4096])
def test_capacity_formula(tokens):
    assert MOE.capacity_for(tokens, CFG) == JMOE.capacity_for(tokens, CFG)
    assert MOE.capacity_for(tokens, CFG) == max(CFG.moe_top_k, int(np.ceil(
        tokens * CFG.moe_top_k / CFG.moe_num_experts
        * CFG.moe_capacity_factor)))
    ds = get_config("deepseek-moe-16b")
    assert MOE.capacity_for(tokens, ds) == JMOE.capacity_for(
        tokens, jax_get_config("deepseek-moe-16b"))


def test_deepseek_shared_experts_add():
    cfg = get_config(DEEPSEEK)
    p = _port_params(cfg)
    x = torch.from_numpy(_x(cfg, 2, 8))
    y_with, _ = MOE.moe_ffn(p, x, cfg)
    y_without, _ = MOE.moe_ffn({k: v for k, v in p.items()
                                if k != "shared"}, x, cfg)
    assert not torch.allclose(y_with, y_without)


def test_identical_tokens_identical_outputs():
    """Routing is per token: identical tokens map identically (no drops at
    two tokens)."""
    x = torch.from_numpy(np.tile(_x(CFG, 1, 1), (1, 2, 1)))
    y, _ = MOE.moe_ffn(_port_params(CFG), x, CFG)
    torch.testing.assert_close(y[0, 0], y[0, 1], atol=1e-5, rtol=0)


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 100))
def test_moe_linear_in_gate_weights(seed):
    """The output stays finite for any draw (gates sum to 1)."""
    p = _port_params(CFG, seed)
    y, _ = MOE.moe_ffn(p, torch.from_numpy(_x(CFG, 1, 8, seed + 1)), CFG)
    assert torch.isfinite(y).all()
