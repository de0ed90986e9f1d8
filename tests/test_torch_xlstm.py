"""The port's mLSTM scan (plain version), mLSTM and sLSTM cells and xLSTM
LM against the JAX package's, with the same numpy inputs and JAX-made
parameters carried across by ``params_from_jax``; the xLSTM config,
full-width tree, cache, serving engine and entry points."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as JREF
from repro.kernels.mlstm_scan import mlstm_scan_kernel as pallas_mlstm
from repro.models import build_model as jax_build_model
from repro.models import xlstm as JXL
from repro_torch.configs import get_config
from repro_torch.kernels import mlstm_scan as ML
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mlstm_ref
from repro_torch.models import build_model
from repro_torch.models import xlstm as XL
from repro_torch.models.api import (XLSTMLM, DecoderLM, init_xlstm_params,
                                    param_count)
from repro_torch.serve import ServeEngine
from repro_torch.weights import params_from_jax

ARCH = "xlstm-1.3b-smoke"    # 4 layers: U = 2 units of K = 1 mLSTM + 1 sLSTM
B, S = 2, 16
SCAN_ATOL = 1e-4             # as tests/test_kernels.py holds the Pallas scan
CELL_ATOL = 1e-5             # f32 cells, summed in another order than XLA's
LOGITS_ATOL = 1e-4           # f32, over 4 layers
DECODE_ATOL, DECODE_RTOL = 2e-3, 1e-3   # as test_arch_smoke.py


def _np(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _mlstm_inputs(seed, b, S, H, P, f_pre=None, i_scale=1.0):
    """Drawn as tests/test_kernels.py draws them: q, k, v ·0.4, i_pre
    N(0, 1) (times ``i_scale``), f_pre N(0, 1) + 2 unless a constant is
    given."""
    rng = np.random.default_rng(seed)
    q, k, v = (_np(rng, (b, S, H, P), 0.4) for _ in range(3))
    i_pre = _np(rng, (b, S, H), i_scale)
    f = (_np(rng, (b, S, H), 1.0, 2.0) if f_pre is None
         else np.full((b, S, H), f_pre, np.float32))
    return q, k, v, i_pre, f


def _port_scan(*arrays):
    return mlstm_ref(*(torch.from_numpy(a) for a in arrays)).numpy()


# --- the mLSTM scan's plain version ------------------------------------------------

# the grid of tests/test_kernels.py::test_mlstm_scan
@pytest.mark.parametrize("S,chunk", [(32, 8), (64, 64)])
def test_scan_ref_matches_jax_ref_and_pallas(S, chunk):
    arrays = _mlstm_inputs(S + chunk, 2, S, 2, 16)
    out = _port_scan(*arrays)
    assert out.shape == (2, S, 2, 16) and out.dtype == np.float32
    jarrays = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(out, np.asarray(JREF.mlstm_ref(*jarrays)),
                               atol=SCAN_ATOL)
    np.testing.assert_allclose(
        out, np.asarray(pallas_mlstm(*jarrays, chunk=chunk, interpret=True)),
        atol=SCAN_ATOL)


def test_scan_ref_matches_pallas_at_every_chunk():
    """The chunk-invariance case of tests/test_kernels.py (P = 8): the port
    has no chunk, so one plain result must match the Pallas kernel at
    both."""
    arrays = _mlstm_inputs(7, 1, 32, 1, 8)
    out = _port_scan(*arrays)
    for chunk in (8, 32):
        ref = pallas_mlstm(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                           interpret=True)
        np.testing.assert_allclose(out, np.asarray(ref), atol=SCAN_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_ref_forget_all(seed):
    """f_pre = -30 makes f_s = 0 (up to e^-30): every step starts from
    C = v kᵀ, n = k, so h_t = v_t (k_t·q_t) / max(|k_t·q_t|, 1)."""
    q, k, v, i_pre, f_pre = _mlstm_inputs(seed, 1, 24, 2, 16, f_pre=-30.0)
    out = _port_scan(q, k, v, i_pre, f_pre)
    kq = np.einsum("bshp,bshp->bsh", k, q)
    expect = v * (kq / np.maximum(np.abs(kq), 1.0))[..., None]
    np.testing.assert_allclose(out, expect, atol=SCAN_ATOL)


def test_scan_ref_stabiliser_matches_jax_ref():
    """i_pre ·10: m_t follows i_t and the gates span e^±30; the ragged
    S = 37 and P = 33 as the kernel takes them."""
    arrays = _mlstm_inputs(11, 2, 37, 3, 33, i_scale=10.0)
    ref = JREF.mlstm_ref(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(_port_scan(*arrays), np.asarray(ref),
                               atol=SCAN_ATOL)


def test_cpu_tensors_take_the_plain_scan():
    arrays = [torch.from_numpy(a) for a in _mlstm_inputs(3, 1, 20, 2, 8)]
    before = ML.launches
    strided_k = arrays[1].transpose(0, 2).contiguous().transpose(0, 2)
    out = ops.mlstm_scan(arrays[0], strided_k, *arrays[2:])
    assert ML.launches == before
    torch.testing.assert_close(out, mlstm_ref(*arrays), atol=0, rtol=0)


def test_scan_kernel_wrapper_refuses_cpu_tensors():
    arrays = [torch.from_numpy(a) for a in _mlstm_inputs(4, 1, 8, 2, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        ML.mlstm_scan_kernel(*arrays)


# --- the cells -------------------------------------------------------------------

@functools.cache
def _jax_cells():
    cfg = jax_get_config(ARCH)
    return cfg, JXL.init_mlstm(jax.random.PRNGKey(3), cfg, jnp.float32), \
        JXL.init_slstm(jax.random.PRNGKey(4), cfg, jnp.float32)


def _port_cell(kind):
    _, mp, sp = _jax_cells()
    tree = mp if kind == "mlstm" else sp
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_forward_matches_jax(kind):
    jcfg, mp, sp = _jax_cells()
    x = _np(np.random.default_rng(5), (B, S, jcfg.d_model))
    ref = getattr(JXL, f"{kind}_forward")(mp if kind == "mlstm" else sp,
                                          jnp.asarray(x), jcfg)
    before = ML.launches
    out = getattr(XL, f"{kind}_forward")(_port_cell(kind),
                                         torch.from_numpy(x),
                                         get_config(ARCH))
    assert ML.launches == before            # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=CELL_ATOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_cell_decode_matches_jax_and_own_forward(kind):
    """Each step against JAX's, the cache against JAX's after 12 steps, and
    the steps together against the port's own forward."""
    jcfg, mp, sp = _jax_cells()
    jp = mp if kind == "mlstm" else sp
    cfg, p = get_config(ARCH), _port_cell(kind)
    x = _np(np.random.default_rng(6), (B, 12, jcfg.d_model))
    jcache = getattr(JXL, f"{kind}_init_cache")(jcfg, B)
    cache = getattr(XL, f"{kind}_init_cache")(cfg, B)
    outs = []
    for t in range(12):
        ref, jcache = getattr(JXL, f"{kind}_decode_step")(
            jp, jcache, jnp.asarray(x[:, t:t + 1]), jcfg)
        out, same = getattr(XL, f"{kind}_decode_step")(
            p, cache, torch.from_numpy(x[:, t:t + 1]), cfg)
        assert same is cache
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=CELL_ATOL)
        outs.append(out)
    for k, v in cache.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jcache[k]),
                                   atol=CELL_ATOL, err_msg=k)
    full = getattr(XL, f"{kind}_forward")(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=DECODE_ATOL, rtol=DECODE_RTOL)


def test_mlstm_forward_makes_one_scan_call(monkeypatch):
    """The recurrence goes through ``ops.mlstm_scan`` once, with f32
    inputs, q scaled by 1/√P."""
    calls = []

    def spy(*args):
        calls.append(args)
        return mlstm_ref(*args)
    monkeypatch.setattr(ops, "mlstm_scan", spy)
    cfg = get_config(ARCH)
    x = torch.from_numpy(_np(np.random.default_rng(7), (B, S, cfg.d_model)))
    XL.mlstm_forward(_port_cell("mlstm"), x, cfg)
    assert len(calls) == 1
    q, k, v, i_pre, f_pre = calls[0]
    P = cfg.d_model // cfg.num_heads
    assert q.shape == (B, S, cfg.num_heads, P) and q.dtype == torch.float32
    assert i_pre.shape == f_pre.shape == (B, S, cfg.num_heads)
    p = _port_cell("mlstm")
    expect = (x @ p["wq"]).reshape(B, S, cfg.num_heads, P) / P ** 0.5
    torch.testing.assert_close(q, expect)


# --- the xLSTM LM ------------------------------------------------------------------

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
    return build_model(cfg, device="cpu"), XLSTMLM(
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


def test_xlstm_forward_matches_jax(case):
    toks, ref, _, model, net = case
    before = ML.launches
    logits, aux = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert ML.launches == before                  # the CPU path launches none
    assert logits.dtype == torch.float32 and aux.item() == 0.0
    assert logits.shape == (B, S, model.cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), ref, atol=LOGITS_ATOL)
    torch.testing.assert_close(net(torch.from_numpy(toks)), logits, atol=0,
                               rtol=0)


def test_xlstm_decode_matches_jax_decode(case):
    toks, _, ref, model, net = case
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(), ref,
                               atol=LOGITS_ATOL)


def test_xlstm_decode_matches_own_forward(case):
    toks, _, _, model, net = case
    full, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_decode_all(model, net, toks).numpy(),
                               full.numpy(), atol=DECODE_ATOL,
                               rtol=DECODE_RTOL)


def test_xlstm_cache_layout_and_in_place_update(case):
    """The stacked (U, K, ...) / (U, ...) layout, the -1e30 stabiliser, and
    a decode step that writes every state into the cache it was given
    (the engine discards the returned one)."""
    toks, _, _, model, net = case
    cache = model.init_cache(3, 10)
    cfg = model.cfg
    d, H = cfg.d_model, cfg.num_heads
    P = d // H
    mc, sc = cache["mlstm"], cache["slstm"]
    assert mc["C"].shape == (2, 1, 3, H, P, P)
    assert mc["n"].shape == (2, 1, 3, H, P)
    assert mc["m"].shape == (2, 1, 3, H)
    for k in ("c", "n", "m", "h"):
        assert sc[k].shape == (2, 3, d)
    assert all(t.dtype == torch.float32 for t in (*mc.values(),
                                                  *sc.values()))
    assert (mc["m"] == -1e30).all() and (sc["m"] == -1e30).all()
    cache = model.init_cache(B, S)
    before = {f"{g}/{k}": v.clone() for g in cache for k, v in
              cache[g].items()}
    _, out = model.decode_step(net, cache, torch.from_numpy(toks[:, :1]), 0)
    assert out is cache
    for g in cache:
        for k, v in cache[g].items():
            assert not torch.equal(v, before[f"{g}/{k}"]), f"{g}/{k}"


def test_xlstm_bf16_forward_matches_jax():
    """The bf16 path end to end on the CPU: the packages round bf16 at other
    places, so the bound is four bf16 ulps (2**-7 each) of logits of size
    about 1, as for gemma2 and zamba2."""
    jm, jp = _jax_model("bfloat16")
    model, net = _port("bfloat16")
    toks = np.random.default_rng(1).integers(0, 512, (B, 32)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               atol=4 * 2**-7)


def test_engine_first_token_is_forward_argmax(case):
    """The ``examples/serve_lm.py`` cross-check on xLSTM, against JAX's
    logits."""
    toks, ref, _, model, net = case
    outs = ServeEngine(model, net, batch_slots=B,
                       max_len=S + 2).run_lockstep(
        [list(map(int, p)) for p in toks], 2)
    assert all(len(o) == 2 for o in outs)
    top2 = np.sort(ref[:, -1], axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > 10 * LOGITS_ATOL
    got = np.array([o[0] for o in outs])
    np.testing.assert_array_equal(got[sure], ref[:, -1].argmax(-1)[sure])


# --- config, full-width tree and weights ---------------------------------------------

@pytest.mark.parametrize("name", ["xlstm-1.3b", "xlstm-1.3b-smoke"])
def test_config_matches_jax(name):
    cfg, ref = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert cfg.resolved_head_dim == ref.resolved_head_dim


def test_full_config_dimensions():
    """The assignment table's row of tests/test_arch_smoke.py."""
    cfg = get_config("xlstm-1.3b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (48, 2048, 4, 4, 0, 50304)
    assert cfg.xlstm_slstm_every == 4 and cfg.family == "ssm"
    assert get_config(ARCH).xlstm_slstm_every == 2


def test_full_width_tree_matches_jax_layout():
    """Every key, shape and dtype of xlstm-1.3b's tree, at full width, from
    the port's init on the meta device and JAX's ``eval_shape``."""
    cfg = get_config("xlstm-1.3b")
    jm = jax_build_model(jax_get_config("xlstm-1.3b"))
    ref = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = init_xlstm_params(torch.Generator(), cfg, device="meta")
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
    assert param_count(tree) == 1_123_026_944
    assert tree["mlstm"]["cell"]["wq"].shape == (12, 3, 2048, 2048)
    assert tree["mlstm"]["cell"]["w_i"].shape == (12, 3, 2048, 4)
    assert tree["slstm"]["cell"]["r_z"].shape == (12, 4, 512, 512)
    assert cfg.d_model // cfg.num_heads <= ML.MAX_HEAD_DIM


def test_init_draws_from_seed_with_jax_dtypes():
    cfg = get_config(ARCH)
    p = init_xlstm_params(torch.Generator().manual_seed(0), cfg, "cpu")
    again = init_xlstm_params(torch.Generator().manual_seed(0), cfg, "cpu")
    torch.testing.assert_close(p["embed"], again["embed"], atol=0, rtol=0)
    P = cfg.d_model // cfg.num_heads
    r_z = p["slstm"]["cell"]["r_z"]
    assert r_z.std().item() == pytest.approx(P ** -0.5, rel=0.1)
    assert not torch.equal(p["mlstm"]["cell"]["wq"][0, 0],
                           p["mlstm"]["cell"]["wq"][1, 0])
    bf = init_xlstm_params(torch.Generator(), dataclasses.replace(
        cfg, param_dtype="bfloat16"), "meta")
    for kind, keys in (("mlstm", ("w_i", "w_f")),
                       ("slstm", ("w_i", "w_f", "r_z"))):
        for k in keys:
            assert bf[kind]["cell"][k].dtype == torch.float32, (kind, k)
        assert bf[kind]["cell"]["out_proj"].dtype == torch.bfloat16


def test_wrong_xlstm_tree_raises():
    cfg = get_config(ARCH)
    tree = jax.tree.map(np.asarray, _jax_model()[1])
    bad = dict(tree, slstm=dict(tree["slstm"], extra=tree["final_norm"]))
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(bad, "cpu", cfg)
    cell = dict(tree["mlstm"]["cell"], w_f=tree["mlstm"]["cell"]["w_f"]
                [..., :2])
    bad = dict(tree, mlstm=dict(tree["mlstm"], cell=cell))
    with pytest.raises(ValueError, match="w_f"):
        params_from_jax(bad, "cpu", cfg)


def test_xlstm_needs_layers_that_tile_into_units():
    cfg = dataclasses.replace(get_config(ARCH), num_layers=5)
    with pytest.raises(ValueError, match="tile into units"):
        build_model(cfg, device="cpu")


def test_ssm_without_slstm_blocks_builds_decoder_only():
    """Without ``xlstm_slstm_every`` the ssm family is built, as JAX builds
    it, as a decoder-only LM, and ``params_from_jax`` takes JAX's tree of
    it; the forwards agree."""
    cfg = dataclasses.replace(get_config(ARCH), xlstm_slstm_every=0)
    jcfg = dataclasses.replace(jax_get_config(ARCH), xlstm_slstm_every=0)
    jm = jax_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    assert "layers" in jp and "mlstm" not in jp
    model = build_model(cfg, device="cpu")
    net = DecoderLM(cfg, params=params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu", cfg), device="cpu")
    assert type(model.init(seed=0)) is DecoderLM
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    out, _ = model.forward(net, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


# --- entry points --------------------------------------------------------------------

@pytest.mark.parametrize("entry", [
    lambda dev: build_model(get_config(ARCH), device=dev),
    lambda dev: XLSTMLM(get_config(ARCH), device=dev),
    lambda dev: params_from_jax(jax.tree.map(np.asarray, _jax_model()[1]),
                                dev, get_config(ARCH)),
])
def test_xlstm_entry_points_need_a_card_unless_cpu(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(dev)
    entry("cpu")


def test_build_model_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert build_model(get_config("xlstm-1.3b")).device.type == "cuda"
