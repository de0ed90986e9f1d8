"""The port's optimizer, schedules, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.data``): the cases of
``tests/test_optim_data.py`` on the port, then parity with the JAX package
on the same numpy inputs: ``adamw_update`` within 1e-6 relative (float32
sums in another order), the schedules at every step 0…total within 1e-6
(XLA's and torch's float32 ``cos`` differ in the last bit), the int8 codes
of ``quantize_int8`` equal, ``compress_grads`` within float32 rounding,
and ``batch_for_step``'s tokens equal token for token; its normal draws
within 1e-6 absolute at the 0.02 scale (``torch.erfinv`` and XLA's
differ in the last float32 bits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import batch_for_step as jax_batch_for_step
from repro.optim import adamw as JA
from repro.optim import compression as JC
from repro.optim import schedule as JS
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import pipeline as P
from repro_torch.data.pipeline import batch_for_step, synthetic_batches
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.compression import (compress_grads, dequantize_int8,
                                           init_error_feedback, quantize_int8)
from repro_torch.optim.schedule import (cosine_schedule, make_schedule,
                                        wsd_schedule)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

RTOL = 1e-6


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if jnp.asarray(x).dtype == jnp.bfloat16 else x)


# ---------------------------------------------------------------------------
# AdamW (tests/test_optim_data.py's cases)
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"x": torch.tensor(5.0)}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"x": 2 * params["x"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert abs(float(params["x"])) < 1e-2


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-4)


def test_weight_decay_decoupled():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    params = {"x": torch.tensor(2.0)}
    state = adamw_init(params)
    p2, _, _ = adamw_update(cfg, params, {"x": torch.tensor(0.0)}, state)
    assert float(p2["x"]) < 2.0


def test_adamw_updates_in_place_and_keeps_the_tensors():
    """The state's parameters stay the tensors a model reads, and a leaf
    that requires a gradient is updated without autograd seeing it."""
    w = torch.ones(4, requires_grad=True)
    params = {"w": w}
    state = adamw_init(params)
    out, new, _ = adamw_update(AdamWConfig(lr=0.1), params,
                               {"w": torch.ones(4)}, state)
    assert out["w"] is w and new["m"] is state["m"] and w.grad_fn is None
    assert float(w[0].detach()) < 1.0 and int(new["step"]) == 1
    assert new["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# AdamW against JAX
# ---------------------------------------------------------------------------

def _tree_np(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(33, 7)).astype(dtype),
            "layers": {"b": rng.normal(size=(5,)).astype(dtype),
                       "a": (rng.normal(size=(3, 4, 6)) * 1e-3).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(dtype, clip):
    """Three steps from the same params, grads and moments: params, m, v
    within 1e-6 of each leaf's largest magnitude (a moment that cancels
    keeps the sums' absolute, not relative, error), grad_norm and lr within
    1e-6 relative (bf16 params: within one bf16 rounding of the float32
    result, which is JAX's cast)."""
    cfg = dict(lr=3e-3, grad_clip_norm=clip)
    jdt = jnp.dtype(dtype)
    p_np = _tree_np(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), p_np)
    tp = tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                  p_np)
    js, ts = JA.adamw_init(jp), adamw_init(tp)
    for step in range(3):
        g_np = _tree_np(10 + step)
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt), g_np)
        tg = tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                      g_np)
        scale = 0.5 + step * 0.25
        jp, js, jm = JA.adamw_update(JA.AdamWConfig(**cfg), jp, jg, js, scale)
        tp, ts, tm = adamw_update(AdamWConfig(**cfg), tp, tg, ts, scale)
        for a, b in zip(jax.tree.leaves(jp), tree.leaves(tp)):
            rtol = RTOL if dtype == "float32" else 2.0 ** -8
            np.testing.assert_allclose(_np(b), _np(a), rtol=rtol,
                                       atol=RTOL * np.abs(_np(a)).max())
        for key in ("m", "v"):
            for a, b in zip(jax.tree.leaves(js[key]), tree.leaves(ts[key])):
                np.testing.assert_allclose(
                    _np(b), _np(a), rtol=0,
                    atol=RTOL * np.abs(_np(a)).max())
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)


def test_clip_by_global_norm_matches_jax():
    g_np = _tree_np(3)
    jc, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 2.0)
    tc, tn = clip_by_global_norm(tree.map(torch.from_numpy, g_np), 2.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=RTOL, atol=1e-9)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def test_cosine_schedule_shape():
    s = [float(cosine_schedule(t, warmup=10, total=100))
         for t in (0, 5, 10, 50, 100)]
    assert s[0] == 0.0 and s[1] == pytest.approx(0.5)
    assert s[2] == pytest.approx(1.0)
    assert s[3] < s[2] and s[4] == pytest.approx(0.1, abs=1e-6)


def test_wsd_schedule_shape():
    vals = [float(wsd_schedule(torch.tensor(t, dtype=torch.int32),
                               warmup=10, total=100))
            for t in (0, 10, 50, 89, 95, 100)]
    assert vals[0] == 0.0
    assert vals[1] == pytest.approx(1.0)
    assert vals[2] == pytest.approx(1.0)
    assert vals[3] == pytest.approx(1.0)
    assert vals[4] < 1.0
    assert vals[5] == pytest.approx(0.1, abs=1e-6)


def test_make_schedule_dispatch():
    assert float(make_schedule("wsd", warmup=1, total=100)(50)) \
        == pytest.approx(1.0)


@pytest.mark.parametrize("kind,warmup,total", [
    ("wsd", 10, 100), ("cosine", 10, 100), ("wsd", 3, 30),
    ("cosine", 0, 17), ("wsd", 100, 10000)])
def test_schedules_match_jax_at_every_step(kind, warmup, total):
    j = JS.make_schedule(kind, warmup=warmup, total=total)
    t = make_schedule(kind, warmup=warmup, total=total)
    steps = np.arange(total + 2, dtype=np.int32)
    got = np.array([float(t(torch.tensor(s))) for s in steps], np.float32)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

@settings(max_examples=10, deadline=None)
@given(st.integers(0, 10000))
def test_int8_quant_bounded_error(seed):
    x = torch.randn(300, generator=torch.Generator().manual_seed(seed)) * 3.0
    codes, scale, pad = quantize_int8(x)
    x_hat = dequantize_int8(codes, scale, pad, x.shape)
    max_err = float((x - x_hat).abs().max())
    assert max_err <= float(scale.max()) * 0.5 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    g = {"w": torch.linspace(-1e-3, 1e-3, 64)}
    err = init_error_feedback(g)
    total = torch.zeros(64)
    n = 50
    for _ in range(n):
        g_hat, err = compress_grads(g, err)
        total = total + g_hat["w"]
    np.testing.assert_allclose((total / n).numpy(), g["w"].numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("n", [300, 256, 1, 1000])
def test_quantize_int8_codes_equal_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * rng.choice([1e-6, 1.0, 30.0], n)).astype(
        np.float32)
    x[::7] = np.round(x[::7] * 4) / 4        # values near .5 code points
    jcodes, jscale, jpad = JC.quantize_int8(jnp.asarray(x))
    codes, scale, pad = quantize_int8(torch.from_numpy(x))
    assert pad == jpad and codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        dequantize_int8(codes, scale, pad, (n,)).numpy(),
        np.asarray(JC.dequantize_int8(jcodes, jscale, jpad, (n,))))


def test_compress_grads_matches_jax():
    """Five steps of error feedback on the same gradients: the compressed
    gradients and the carried errors within float32 rounding."""
    g_np = _tree_np(7)
    jerr = JC.init_error_feedback(jax.tree.map(jnp.asarray, g_np))
    terr = init_error_feedback(tree.map(torch.from_numpy, g_np))
    for step in range(5):
        g_np = _tree_np(20 + step)
        jg, jerr = JC.compress_grads(jax.tree.map(jnp.asarray, g_np), jerr)
        tg, terr = compress_grads(tree.map(torch.from_numpy, g_np), terr)
        for a, b in zip(jax.tree.leaves((jg, jerr)), tree.leaves((tg, terr))):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# data pipeline (tests/test_optim_data.py's cases)
# ---------------------------------------------------------------------------

CFG = get_config("qwen3-32b", smoke=True)


def test_batch_determinism():
    a = batch_for_step(CFG, 5, 4, 16, device="cpu")
    b = batch_for_step(CFG, 5, 4, 16, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    c = batch_for_step(CFG, 6, 4, 16, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])


def test_labels_are_shifted_tokens():
    b = batch_for_step(CFG, 0, 2, 16, device="cpu")
    assert b["tokens"].shape == b["labels"].shape == (2, 16)
    assert b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_slice_matches_global():
    full = batch_for_step(CFG, 3, 8, 16, device="cpu")
    part = batch_for_step(CFG, 3, 8, 16, host_slice=slice(0, 8),
                          device="cpu")
    assert torch.equal(full["tokens"], part["tokens"])


def test_prefetch_iterator():
    it = synthetic_batches(CFG, 2, 8, start_step=4, device="cpu")
    step, batch = next(it)
    assert step == 4 and batch["tokens"].shape == (2, 8)
    step2, batch2 = next(it)
    assert step2 == 5
    assert torch.equal(batch2["tokens"],
                       batch_for_step(CFG, 5, 2, 8, device="cpu")["tokens"])
    it.close()


def test_batch_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_for_step(CFG, 0, 2, 8)


# ---------------------------------------------------------------------------
# data pipeline against JAX
# ---------------------------------------------------------------------------

def test_threefry_primitives_match_jax():
    key = jax.random.PRNGKey(20260714)
    assert P.prng_key(20260714) == tuple(int(k) for k in np.asarray(key))
    for d in (0, 1, 5, 2**31 + 7):
        got = P.fold_in(P.prng_key(20260714), d)
        want = np.asarray(jax.random.fold_in(key, d))
        assert got == tuple(int(k) for k in want)
    k = jax.random.fold_in(key, 9)
    ours = P.fold_in(P.prng_key(20260714), 9)
    want = np.asarray(jax.random.split(k))
    assert P.split(ours) == [tuple(int(x) for x in w) for w in want]
    np.testing.assert_array_equal(
        P.random_bits(ours, (3, 5)),
        np.asarray(jax.random.bits(k, (3, 5), jnp.uint32)))


@pytest.mark.parametrize("vocab", [2, 8192, 122753])
@pytest.mark.parametrize("host_slice", [None, slice(2, 5)],
                         ids=["whole", "slice2-5"])
def test_batch_for_step_tokens_equal_jax(vocab, host_slice):
    """Steps 0–3, token for token: the draws restart replay and a resume
    across the packages rest on."""
    import dataclasses
    jcfg = dataclasses.replace(jax_get_config("minicpm-2b", smoke=True),
                               vocab_size=vocab)
    cfg = dataclasses.replace(get_config("minicpm-2b", smoke=True),
                              vocab_size=vocab)
    for step in range(4):
        want = jax_batch_for_step(jcfg, step, 6, 33, host_slice=host_slice)
        got = batch_for_step(cfg, step, 6, 33, host_slice=host_slice,
                             device="cpu")
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("name,key", [("paligemma-3b", "prefix_embed"),
                                      ("whisper-large-v3", "enc_frames")])
def test_batch_for_step_normals_match_jax(name, key):
    jcfg = jax_get_config(name, smoke=True)
    cfg = get_config(name, smoke=True)
    for step in (0, 3):
        want = np.asarray(jax_batch_for_step(jcfg, step, 3, 8)[key])
        got = batch_for_step(cfg, step, 3, 8, device="cpu")[key]
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        assert 0.01 < float(got.std()) < 0.03


def test_batch_for_step_bf16_normals_match_jax():
    """At the full configs' bfloat16 the uniform draws 8 bits, as JAX's."""
    import dataclasses
    jcfg = dataclasses.replace(jax_get_config("paligemma-3b"),
                               num_prefix_tokens=16)
    cfg = dataclasses.replace(get_config("paligemma-3b"),
                              num_prefix_tokens=16)
    want = jax_batch_for_step(jcfg, 1, 2, 4)["prefix_embed"]
    got = batch_for_step(cfg, 1, 2, 4, device="cpu")["prefix_embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), rtol=0,
                               atol=1e-6)
