"""The port's SSD scan (plain version), Mamba2 cell and zamba2 hybrid LM
against the JAX package's, with the same numpy inputs and JAX-made
parameters carried across by ``params_from_jax``; the hybrid's config,
full-width tree, serving engine and entry points."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as JREF
from repro.kernels.mamba_scan import mamba_scan_kernel as pallas_scan
from repro.models import build_model as jax_build_model
from repro.models import ssm as JSSM
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba_scan as MS
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import build_model
from repro_torch.models import ssm as SSM
from repro_torch.models.api import HybridLM, init_hybrid_params, param_count
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_jax

ARCH = "zamba2-2.7b-smoke"   # 4 layers: U = 2 units of K = 1 mamba + 1 attn
B, S = 2, 32                 # two chunks of the smoke config's 16
SCAN_ATOL = 1e-4             # as tests/test_kernels.py holds the Pallas scan
LOGITS_ATOL = 1e-4           # f32, summed in another order than XLA's
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-3   # as test_arch_smoke.py


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _scan_inputs(seed, b, S, H, P, N, a_log=None):
    """Drawn as tests/test_kernels.py draws them: dtx·0.3,
    a_log = -softplus(N(0, 1)), B and C ·0.3."""
    rng = np.random.default_rng(seed)
    dtx = _np(rng, (b, S, H, P), 0.3)
    if a_log is None:
        a_log = -np.logaddexp(0.0, _np(rng, (b, S, H))).astype(np.float32)
    else:
        a_log = np.full((b, S, H), a_log, np.float32)
    return dtx, a_log, _np(rng, (b, S, N), 0.3), _np(rng, (b, S, N), 0.3)


def _port_scan(*arrays):
    return mamba_scan_ref(*(torch.from_numpy(a) for a in arrays)).numpy()


# --- the SSD scan's plain version ------------------------------------------------

# the grid of tests/test_kernels.py::test_mamba_scan
@pytest.mark.parametrize("S,chunk", [(64, 16), (64, 64), (128, 32)])
def test_scan_ref_matches_jax_ref_and_pallas(S, chunk):
    arrays = _scan_inputs(S + chunk, 2, S, 3, 16, 8)
    out = _port_scan(*arrays)
    assert out.shape == (2, S, 3, 16) and out.dtype == np.float32
    jarrays = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(JREF.mamba_scan_ref(*jarrays)),
                               atol=SCAN_ATOL)
    np.testing.assert_allclose(
        out, np.asarray(pallas_scan(*jarrays, chunk=chunk, interpret=True)),
        atol=SCAN_ATOL)


def test_scan_ref_matches_pallas_at_every_chunk():
    """The chunk-invariance case of tests/test_kernels.py: the port has no
    chunk, so one plain result must match the Pallas kernel at both."""
    arrays = _scan_inputs(7, 1, 64, 2, 8, 4)
    out = _port_scan(*arrays)
    for chunk in (16, 64):
        ref = pallas_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                          interpret=True)
        np.testing.assert_allclose(out, np.asarray(ref), atol=SCAN_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_ref_full_reset(seed):
    """a_log = -30 resets the state every step: y_t = (C_t·B_t)·dtx_t, as
    the reset property of tests/test_kernels.py; the Pallas kernel agrees."""
    dtx, a_log, Bm, Cm = _scan_inputs(seed, 1, 32, 2, 8, 4, a_log=-30.0)
    out = _port_scan(dtx, a_log, Bm, Cm)
    expect = np.einsum("bsn,bsn->bs", Cm, Bm)[..., None, None] * dtx
    np.testing.assert_allclose(out, expect, atol=SCAN_ATOL)
    ref = pallas_scan(*(jnp.asarray(a) for a in (dtx, a_log, Bm, Cm)),
                      chunk=16, interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), atol=SCAN_ATOL)


@pytest.mark.parametrize("S", [1, 50])
def test_scan_ref_ragged_length_matches_jax_ref(S):
    """Any S, as the kernel takes any S (the JAX sequential oracle does
    too; the Pallas kernel needs S to divide into chunks)."""
    arrays = _scan_inputs(S, 2, S, 3, 16, 8)
    ref = JREF.mamba_scan_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_port_scan(*arrays), np.asarray(ref),
                               atol=SCAN_ATOL)


def test_cpu_tensors_take_the_plain_scan():
    arrays = [torch.from_numpy(a) for a in _scan_inputs(3, 1, 20, 2, 8, 4)]
    before = MS.launches
    strided_B = arrays[2].transpose(0, 2).contiguous().transpose(0, 2)
    out = ops.mamba_scan(arrays[0], arrays[1], strided_B, arrays[3])
    assert MS.launches == before
    torch.testing.assert_close(out, mamba_scan_ref(*arrays), atol=0, rtol=0)


def test_scan_kernel_wrapper_refuses_cpu_tensors():
    dtx, a_log, Bm, Cm = (torch.from_numpy(a)
                          for a in _scan_inputs(4, 1, 8, 2, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        MS.mamba_scan_kernel(dtx, a_log, Bm, Cm)


# --- the Mamba2 cell ---------------------------------------------------------------

@functools.cache
def _jax_cell():
    cfg = jax_get_config(ARCH)
    return cfg, JSSM.init_mamba2(jax.random.PRNGKey(3), cfg, jnp.float32)


def _port_cell():
    _, tree = _jax_cell()
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def test_mamba2_forward_matches_jax():
    jcfg, jp = _jax_cell()
    x = _np(np.random.default_rng(5), (B, S, jcfg.d_model))
    ref = JSSM.mamba2_forward(jp, jnp.asarray(x), jcfg)
    before = MS.launches
    out = SSM.mamba2_forward(_port_cell(), torch.from_numpy(x),
                             get_config(ARCH))
    assert MS.launches == before            # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_mamba2_decode_matches_jax_and_own_forward():
    jcfg, jp = _jax_cell()
    cfg, p = get_config(ARCH), _port_cell()
    x = _np(np.random.default_rng(6), (B, 12, jcfg.d_model))
    jcache = JSSM.mamba2_init_cache(jcfg, B, jnp.float32)
    cache = SSM.mamba2_init_cache(cfg, B, torch.float32)
    for t in range(12):
        ref, jcache = JSSM.mamba2_decode_step(jp, jcache,
                                              jnp.asarray(x[:, t:t + 1]), jcfg)
        out, cache = SSM.mamba2_decode_step(p, cache,
                                            torch.from_numpy(x[:, t:t + 1]),
                                            cfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   atol=1e-5)
    full = SSM.mamba2_forward(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(SSM.mamba2_ref_scan(p, torch.from_numpy(x),
                                                   cfg).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


@pytest.mark.parametrize("seq", [24, 40])
def test_mamba2_forward_refuses_a_ragged_chunk(seq):
    """S = 24 and 40 do not divide into the smoke chunk of 16: refused as
    JAX refuses them (the kernel itself would take them)."""
    x = torch.zeros(1, seq, get_config(ARCH).d_model)
    with pytest.raises(ValueError, match="not divisible by ssm chunk"):
        SSM.mamba2_forward(_port_cell(), x, get_config(ARCH))


# --- the hybrid LM -----------------------------------------------------------------

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
    return build_model(cfg, device="cpu"), HybridLM(
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


def test_hybrid_forward_matches_jax(case):
    toks, ref, _, model, net = case
    before = (FA.launches, MS.launches)
    logits, aux = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert (FA.launches, MS.launches) == before   # the CPU path launches none
    assert logits.dtype == torch.float32 and aux.item() == 0.0
    assert logits.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGITS_ATOL)
    torch.testing.assert_close(net(torch.from_numpy(toks)), logits, atol=0,
                               rtol=0)


def test_hybrid_decode_matches_jax_decode(case):
    toks, _, ref, model, net = case
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(), ref,
                               atol=DECODE_ATOL, rtol=DECODE_RTOL)


def test_hybrid_decode_matches_own_forward(case):
    toks, _, _, model, net = case
    full, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_hybrid_cache_layout(case):
    _, _, _, model, _ = case
    cache = model.init_cache(3, 10)
    cfg = model.cfg
    assert cache["mamba"]["ssm"].shape == (2, 1, 3, 8, 16, 16)
    assert cache["mamba"]["ssm"].dtype == torch.float32
    assert cache["mamba"]["conv"].shape == (2, 1, 3, cfg.ssm_conv_width - 1,
                                            2 * cfg.d_model + 2 * 16)
    assert cache["attn"]["k"].shape == (2, 3, 10, cfg.num_kv_heads,
                                        cfg.resolved_head_dim)


def test_hybrid_bf16_forward_matches_jax():
    """The bf16 path end to end on the CPU: the packages round bf16 at other
    places, so the bound is four bf16 ulps (2**-7 each) of logits of size
    about 1, as for gemma2."""
    jm, jp = _jax_model("bfloat16")
    model, net = _port("bfloat16")
    toks = np.random.default_rng(1).integers(0, 512, (B, S)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=4 * 2**-7)


def test_engine_first_token_is_forward_argmax(case):
    """The ``examples/serve_lm.py`` cross-check on the hybrid, against
    JAX's logits."""
    toks, ref, _, model, net = case
    outs = ServeEngine(model, net, batch_slots=B,
                       max_len=S + 2).run_lockstep(
        [list(map(int, p)) for p in toks], 2)
    assert all(len(o) == 2 for o in outs)
    top2 = np.sort(ref[:, -1], axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 10 * LOGITS_ATOL
    got = np.array([o[0] for o in outs])
    np.testing.assert_array_equal(got[sure], ref[:, -1].argmax(-1)[sure])


def test_hybrid_forward_refuses_a_ragged_chunk(case):
    _, _, _, model, net = case
    with pytest.raises(ValueError, match="not divisible by ssm chunk"):
        model.forward(net, {"tokens": torch.zeros(1, 24, dtype=torch.long)})


# --- config, full-width tree and weights ---------------------------------------------

def test_full_width_tree_matches_jax_layout():
    """Every key, shape and dtype of zamba2-2.7b's tree, at full width, from
    the port's init on the meta device and JAX's ``eval_shape``."""
    cfg = get_config("zamba2-2.7b")
    jm = jax_build_model(jax_get_config("zamba2-2.7b"))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = init_hybrid_params(torch.Generator(), cfg, device="meta")
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
    assert 2.82e9 < param_count(tree) < 2.83e9
    assert tree["mamba"]["cell"]["in_proj"].shape == (9, 5, 2560, 10448)
    assert tree["attn"]["attn"]["wq"].shape == (9, 2560, 2560)
    assert cfg.resolved_head_dim in FA.HEAD_DIMS
    assert cfg.ssm_head_dim <= MS.MAX_STATE >= cfg.ssm_state_dim


def test_init_draws_from_seed_with_jax_constants():
    cfg = get_config(ARCH)
    p = init_hybrid_params(torch.Generator().manual_seed(0), cfg, "cpu")
    again = init_hybrid_params(torch.Generator().manual_seed(0), cfg, "cpu")
    torch.testing.assert_close(p["embed"], again["embed"], atol=0, rtol=0)
    cell = p["mamba"]["cell"]
    jcell = jax.tree.map(np.asarray, _jax_cell()[1])
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm_w"):
        assert cell[k].dtype == torch.float32
        np.testing.assert_allclose(cell[k][1, 0].numpy(), jcell[k],
                                   atol=1e-6)
    assert cell["conv_w"].std().item() == pytest.approx(0.1, rel=0.1)
    assert not torch.equal(cell["in_proj"][0, 0], cell["in_proj"][1, 0])
    bf = init_hybrid_params(torch.Generator(), dataclasses.replace(
        cfg, param_dtype="bfloat16"), "meta")
    assert bf["mamba"]["cell"]["A_log"].dtype == torch.float32
    assert bf["mamba"]["cell"]["in_proj"].dtype == torch.bfloat16


def test_wrong_hybrid_tree_raises():
    cfg = get_config(ARCH)
    tree = jax.tree.map(np.asarray, _jax_model()[1])
    bad = dict(tree, mamba=dict(tree["mamba"], extra=tree["final_norm"]))
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, "cpu", cfg)
    cell = dict(tree["mamba"]["cell"], A_log=tree["mamba"]["cell"]["A_log"]
                [..., :4])
    bad = dict(tree, mamba=dict(tree["mamba"], cell=cell))
    with pytest.raises(ValueError, match="A_log"):
        params_from_jax(bad, "cpu", cfg)


def test_hybrid_needs_layers_that_tile_into_units():
    cfg = dataclasses.replace(get_config(ARCH), num_layers=5)
    with pytest.raises(ValueError, match="tile into units"):
        build_model(cfg, device="cpu")


# --- entry points --------------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda dev: build_model(get_config(ARCH), device=dev),
    lambda dev: HybridLM(get_config(ARCH), device=dev),
    lambda dev: params_from_jax(jax.tree.map(np.asarray, _jax_model()[1]),
                                dev, get_config(ARCH)),
])
def test_hybrid_entry_points_need_a_card_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(dev)
    entry("cpu")


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build_model(get_config("zamba2-2.7b")).device.type == "cuda"
