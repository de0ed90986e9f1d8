"""The port's trainer (``repro_torch.train.trainer``): the invariants of
``tests/test_trainer.py`` (microbatching, the chunked loss, perfect
cross-entropy, the MoE aux loss, the greedy serve step), then one train
step from a JAX-made state (``weights.state_from_jax``) on the same batch,
held against JAX's ``make_train_step`` for every smoke config the port trains,
and for gemma2-2b's head layout at smoke width elsewhere: the loss and
grad_norm within 1e-5 relative, lr exactly, each gradient leaf within
1e-4·max|g_jax| of that leaf, the moments within 2e-4·max of theirs, the step,
and the new parameters within 2·lr + 1e-6 (JAX's own bound for an AdamW step
whose near-zero gradient flips sign, ``tests/test_trainer.py``).  Every
floating leaf gets a gradient of nonzero norm.  The remat and chunked-loss
forms give the plain step's gradients; gemma2's final softcap runs out of place
under autograd and in place without it.  The hybrid (zamba2) and xLSTM families
train through the plain recurrences here, which write nothing in place."""

import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import batch_for_step as jax_batch_for_step
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.train import trainer as JT
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data.pipeline import batch_for_step
from repro_torch.models import api as API
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import (TrainStepConfig, cross_entropy,
                                       init_train_state, make_grad_fn,
                                       make_loss_fn, make_serve_step,
                                       make_train_step)
from repro_torch.weights import state_from_jax

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("qwen3-32b", smoke=True)
TRAINABLE = ["minicpm-2b", "gemma2-2b", "phi3-mini-3.8b", "qwen3-32b",
             "granite-moe-1b-a400m", "deepseek-moe-16b", "paligemma-3b",
             "whisper-large-v3", "zamba2-2.7b", "xlstm-1.3b"]
LR = 1e-3
GRAD_RTOL = 1e-4       # per leaf, of max|g|: f32 sums in another order
LOSS_RTOL = 1e-5
# gemma2-2b's heads (8 query and 4 KV heads of 256; its softcaps 50 and 30
# and the smoke's window of 8, which bites the 16-token batch), narrow
# elsewhere: 2 layers, one local and one global, the smoke's d_model, d_ff
# and vocab.  The case the card trains at full width (chip_smoke phase 53).
GEMMA2_HEADS = "gemma2-2b@heads"
HEAD_LAYOUTS = {GEMMA2_HEADS: ("gemma2-2b", dict(
    num_layers=2, num_heads=8, num_kv_heads=4, head_dim=256))}


def _smoke(name, get):
    """``name``'s smoke config from ``get`` (JAX's or the port's
    ``get_config``), with a HEAD_LAYOUTS case's heads."""
    arch, heads = HEAD_LAYOUTS.get(name, (name, {}))
    return dataclasses.replace(get(arch, smoke=True), **heads)


def _setup(ts, cfg=CFG):
    model = build_model(cfg, device="cpu")
    return model, init_train_state(model, model.init(0), ts)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# tests/test_trainer.py's invariants
# ---------------------------------------------------------------------------

def test_microbatch_equals_full_batch_loss():
    """Gradient accumulation changes neither the loss nor the step, up to
    the AdamW bound of JAX's test (2·lr for a sign flip of a near-zero
    accumulated gradient)."""
    batch = batch_for_step(CFG, 0, 8, 16, device="cpu")
    ts_full = TrainStepConfig(opt=AdamWConfig(lr=LR), schedule_warmup=1)
    ts_micro = TrainStepConfig(opt=AdamWConfig(lr=LR), schedule_warmup=1,
                               microbatch=2)
    model, state_f = _setup(ts_full)
    _, state_m = _setup(ts_micro)
    sf, mf = make_train_step(model, ts_full)(state_f, batch)
    sm, mm = make_train_step(model, ts_micro)(state_m, batch)
    assert float(mf["loss"]) == pytest.approx(float(mm["loss"]), rel=1e-4)
    for a, b in zip(tree.leaves(sf["params"]), tree.leaves(sm["params"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=2 * LR + 1e-4)


def test_chunked_ce_equals_full_ce():
    batch = batch_for_step(CFG, 0, 4, 16, device="cpu")
    ts_full = TrainStepConfig(schedule_warmup=1)
    ts_chunk = TrainStepConfig(schedule_warmup=1, loss_chunk=4)
    model, state = _setup(ts_full)
    l_full, _, g_full = make_grad_fn(model, ts_full)(state["params"], batch)
    l_chunk, _, g_chunk = make_grad_fn(model, ts_chunk)(state["params"],
                                                         batch)
    assert float(l_full) == pytest.approx(float(l_chunk), rel=1e-5)
    for a, b in zip(tree.leaves(g_full), tree.leaves(g_chunk)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=GRAD_RTOL * np.abs(_np(a)).max())
    _, m_chunk = make_train_step(model, ts_chunk)(state, batch)
    assert float(m_chunk["loss"]) == pytest.approx(float(l_full), rel=1e-5)


def test_remat_gives_the_same_gradients():
    batch = batch_for_step(CFG, 1, 2, 16, device="cpu")
    ts = TrainStepConfig(schedule_warmup=1)
    model, state = _setup(ts)
    l0, _, g0 = make_grad_fn(model, ts)(state["params"], batch)
    l1, _, g1 = make_grad_fn(model, dataclasses.replace(ts, remat=True))(
        state["params"], batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)


def test_cross_entropy_perfect_prediction():
    logits = torch.full((1, 4, 8), -30.0)
    labels = torch.tensor([[1, 2, 3, 0]])
    logits[0, torch.arange(4), labels[0]] = 30.0
    assert float(cross_entropy(logits, labels)) < 1e-3


def test_loss_fn_includes_moe_aux():
    cfg = get_config("granite-moe-1b-a400m", smoke=True)
    model = build_model(cfg, device="cpu")
    lm = model.init(0)
    loss, aux = make_loss_fn(model)(lm.params,
                                    batch_for_step(cfg, 0, 2, 16,
                                                   device="cpu"))
    assert float(aux) > 0
    assert float(loss) > float(aux)


def test_serve_step_greedy_token():
    model = build_model(CFG, device="cpu")
    lm = model.init(0)
    serve = make_serve_step(model, sample=True)
    cache = model.init_cache(2, 8)
    out, _ = serve(lm, cache, torch.zeros((2, 1), dtype=torch.int32), 0)
    assert out.shape == (2, 1) and out.dtype == torch.int32


def test_train_state_is_the_models_own_tensors():
    """``init_train_state`` trains the module ``model.init`` returned, and
    ``Model.bind`` holds the state's tensors without copying them."""
    ts = TrainStepConfig(schedule_warmup=1)
    model = build_model(CFG, device="cpu")
    lm = model.init(0)
    before = lm.params["embed"].detach().clone()
    state = init_train_state(model, lm, ts)
    bound = model.bind(state["params"])
    assert all(a is b for a, b in zip(tree.leaves(bound.params),
                                      tree.leaves(state["params"])))
    make_train_step(model, ts)(state, batch_for_step(CFG, 0, 2, 8,
                                                     device="cpu"))
    assert state["params"]["embed"] is lm.params["embed"]
    assert not torch.equal(lm.params["embed"].detach(), before)


# ---------------------------------------------------------------------------
# one train step against JAX
# ---------------------------------------------------------------------------

@functools.cache
def _jax_step(name):
    """JAX's state, batch, gradients, new state and metrics for one step of
    ``name``-smoke (``_smoke``) at lr 1e-3, as numpy."""
    cfg = _smoke(name, jax_get_config)
    model = jax_build_model(cfg)
    ts = JT.TrainStepConfig(opt=JaxAdamWConfig(lr=LR), schedule_warmup=1)
    state = JT.init_train_state(model, model.init(jax.random.PRNGKey(0)), ts)
    batch = jax_batch_for_step(cfg, 0, 2, 16)
    grad = jax.grad(lambda p, b: JT.make_loss_fn(model)(p, b)[0])
    step = JT.make_train_step(model, ts)

    @jax.jit
    def run(state, batch):
        return grad(state["params"], batch), *step(state, batch)
    grads, new, metrics = run(state, batch)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return to_np(state), to_np(batch), to_np(grads), to_np(new), \
        to_np(metrics)


@pytest.mark.parametrize("name", TRAINABLE + [GEMMA2_HEADS])
def test_train_step_matches_jax(name):
    jstate, jbatch, jgrads, jnew, jm = _jax_step(name)
    cfg = _smoke(name, get_config)
    model = build_model(cfg, device="cpu")
    ts = TrainStepConfig(opt=AdamWConfig(lr=LR), schedule_warmup=1)
    state = state_from_jax(jstate, cfg, device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}

    loss, _, grads = make_grad_fn(model, ts)(state["params"], batch)
    for g, want in zip(tree.leaves(grads), jax.tree.leaves(jgrads)):
        assert g.shape == want.shape and g.dtype == torch.float32
        assert float(g.norm()) > 0, "a leaf got no gradient"
        np.testing.assert_allclose(_np(g), want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())

    new, m = make_train_step(model, ts)(state, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                             rel=LOSS_RTOL)
    assert float(m["loss"]) == float(loss)
    assert float(m["aux_loss"]) == pytest.approx(float(jm["aux_loss"]),
                                                 rel=LOSS_RTOL, abs=1e-7)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=LOSS_RTOL)
    assert float(m["lr"]) == float(jm["lr"])
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    for a, want in zip(tree.leaves(new["params"]),
                       jax.tree.leaves(jnew["params"])):
        np.testing.assert_allclose(_np(a), want, rtol=0, atol=2 * LR + 1e-6)
    for key in ("m", "v"):
        for a, want in zip(tree.leaves(new["opt"][key]),
                           jax.tree.leaves(jnew["opt"][key])):
            np.testing.assert_allclose(_np(a), want, rtol=0,
                                       atol=2 * GRAD_RTOL * np.abs(want).max())


def test_state_from_jax_carries_the_state():
    jstate = _jax_step("minicpm-2b")[0]
    cfg = get_config("minicpm-2b", smoke=True)
    state = state_from_jax(jstate, cfg, device="cpu")
    assert state["opt"]["step"].dtype == torch.int32
    for a, want in zip(tree.leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(_np(a), want)
    assert all(p.requires_grad for p in tree.leaves(state["params"]))
    with pytest.raises(KeyError):
        state_from_jax({"params": jstate["params"]}, cfg, device="cpu")


def test_state_from_jax_bf16_bit_for_bit():
    cfg = dataclasses.replace(jax_get_config("minicpm-2b", smoke=True),
                              dtype="bfloat16", param_dtype="bfloat16")
    model = jax_build_model(cfg)
    jstate = jax.tree.map(np.asarray, JT.init_train_state(
        model, model.init(jax.random.PRNGKey(1)),
        JT.TrainStepConfig(compress_grads=True)))
    pcfg = dataclasses.replace(get_config("minicpm-2b", smoke=True),
                               dtype="bfloat16", param_dtype="bfloat16")
    state = state_from_jax(jstate, pcfg, device="cpu")
    assert set(state) == {"params", "opt", "ef"}
    for a, want in zip(tree.leaves(state["params"]),
                       jax.tree.leaves(jstate["params"])):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            a.detach().view(torch.int16).numpy(), want.view(np.int16))
    assert all(a.dtype == torch.float32
               for a in tree.leaves(state["opt"]["m"]))


# ---------------------------------------------------------------------------
# autograd through the model code
# ---------------------------------------------------------------------------

def test_head_softcap_in_place_only_without_autograd():
    """gemma2-smoke's final softcap: out of place under autograd (a
    backward through the forward works), in place otherwise, with the same
    values."""
    cfg = get_config("gemma2-2b", smoke=True)
    model = build_model(cfg, device="cpu")
    lm = model.init(0)
    batch = batch_for_step(cfg, 0, 2, 12, device="cpu")
    with torch.no_grad():
        plain, _ = model.forward(lm, batch)
    ts = TrainStepConfig(schedule_warmup=1)
    state = init_train_state(model, lm, ts)
    logits, _ = model.forward(model.bind(state["params"]), batch)
    assert torch.equal(logits.detach(), plain)
    assert float(logits.detach().abs().max()) <= cfg.final_softcap
    logits.sum().backward()
    assert all(p.grad is not None for p in tree.leaves(state["params"]))


@pytest.mark.parametrize("family", ["decoder", "encdec"])
def test_return_hidden_feeds_the_head(family):
    name = "minicpm-2b" if family == "decoder" else "whisper-large-v3"
    cfg = get_config(name, smoke=True)
    model = build_model(cfg, device="cpu")
    lm = model.init(0)
    batch = batch_for_step(cfg, 0, 2, 8, device="cpu")
    with torch.no_grad():
        logits, _ = model.forward(lm, batch)
        hidden, _ = model.forward(lm, batch, return_hidden=True)
        assert torch.equal(API._head(lm.params, cfg, hidden), logits)


# ---------------------------------------------------------------------------
# examples/train_lm_torch.py
# ---------------------------------------------------------------------------

def test_train_example_runs_on_cpu(tmp_path):
    """The port's ``examples/train_lm.py``: 30 steps of lm-10m through
    ``run_restartable``, and the loss falls (the script raises
    otherwise)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--ckpt-dir", str(tmp_path / "ckpt")],
        check=True, env=env, capture_output=True, text=True,
        timeout=300).stdout
    assert "model lm-10m" in out and "schedule=wsd" in out
    assert "done: 30 steps, 0 restarts" in out
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "LATEST", "step_00000010", "step_00000020", "step_00000029"]


def test_train_example_needs_a_card_unless_cpu(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--ckpt-dir", str(tmp_path)])
