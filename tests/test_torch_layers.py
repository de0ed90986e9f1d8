"""Parity of the port's conv/bn/pool layers (``repro_torch.models.layers``)
with the JAX package's (``repro.models.layers``): the same numpy inputs,
made from a seed, go through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

RNG = np.random.default_rng(11)


def _np(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


# --- mirrors of tests/test_layers.py (conv/pool section) -------------------

def test_conv2d_identity_kernel():
    x = torch.from_numpy(_np((1, 5, 5, 3)))
    w = torch.zeros((1, 1, 3, 3))
    w[0, 0] = torch.eye(3)
    torch.testing.assert_close(L.conv2d(w, x), x, atol=1e-6, rtol=0)


def test_maxpool_basic():
    x = torch.arange(16.0).reshape(1, 4, 4, 1)
    y = L.maxpool2d(x, 2, 2, 0)
    np.testing.assert_array_equal(y[0, :, :, 0].numpy(), [[5, 7], [13, 15]])


def test_batchnorm_folds_stats():
    p = L.init_bn(4)
    p["mean"] = torch.full((4,), 2.0)
    p["var"] = torch.full((4,), 4.0)
    x = torch.full((1, 2, 2, 4), 6.0)
    # (6-2)/2 = 2
    np.testing.assert_allclose(L.batchnorm(p, x).numpy(), 2.0, atol=1e-3)


# --- parity with the JAX layers --------------------------------------------

@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 2, 0),
                                   (7, 2, 3)])
def test_conv2d_matches_jax(k, s, p):
    x, w = _np((2, 11, 11, 3)), _np((k, k, 3, 5), 0.3)
    ref = np.asarray(JL.conv2d(jnp.asarray(w), jnp.asarray(x), s, p))
    out = L.conv2d(torch.from_numpy(w), torch.from_numpy(x), s, p)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_batchnorm_matches_jax():
    x = _np((2, 4, 4, 6))
    p = {"scale": 1 + _np((6,), 0.1), "bias": _np((6,), 0.1),
         "mean": _np((6,), 0.5),
         "var": RNG.uniform(0.5, 2.0, 6).astype(np.float32)}
    ref = np.asarray(JL.batchnorm({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x)))
    out = L.batchnorm({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("k,s,p", [(3, 2, 1), (2, 2, 0), (3, 1, 2)])
def test_maxpool_matches_jax(k, s, p):
    # all-negative input: a zero pad instead of −inf would show at the edges
    x = -np.abs(_np((2, 9, 9, 4))) - 1.0
    ref = np.asarray(JL.maxpool2d(jnp.asarray(x), k, s, p))
    out = L.maxpool2d(torch.from_numpy(x), k, s, p)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy(), ref)


def test_avgpool_global_matches_jax():
    x = _np((3, 5, 7, 4))
    np.testing.assert_allclose(
        L.avgpool_global(torch.from_numpy(x)).numpy(),
        np.asarray(JL.avgpool_global(jnp.asarray(x))), atol=1e-6)


def test_init_bn_matches_jax():
    ref = JL.init_bn(7, jnp.float32)
    out = L.init_bn(7)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        assert out[k].dtype == torch.float32


@pytest.mark.parametrize("init,shape,std", [
    (lambda g: L.init_conv(g, 3, 3, 64, 32), (3, 3, 64, 32),
     np.sqrt(2.0 / 576)),
    (lambda g: L.dense_init(g, 512, 100), (512, 100), 1 / np.sqrt(512)),
])
def test_init_shape_dtype_scale(init, shape, std):
    """Torch cannot reproduce JAX's PRNG: the port's initializers are held
    to the JAX ones' shape, dtype and scale, and to their seed."""
    w = init(torch.Generator().manual_seed(0))
    assert tuple(w.shape) == shape and w.dtype == torch.float32
    assert abs(w.std().item() / std - 1) < 0.05
    assert abs(w.mean().item()) < 0.1 * std
    torch.testing.assert_close(init(torch.Generator().manual_seed(0)), w,
                               atol=0, rtol=0)


# --- layernorm ---------------------------------------------------------------

def test_layernorm_zero_mean_unit_var():
    """As tests/test_layers.py::test_layernorm_zero_mean_unit_var."""
    p = L.init_layernorm(32)
    y = L.layernorm(p, torch.from_numpy(_np((4, 32)) * 3 + 2)).numpy()
    np.testing.assert_allclose(y.mean(-1), 0.0, atol=1e-4)
    np.testing.assert_allclose(y.std(-1), 1.0, atol=1e-2)


def test_init_layernorm_matches_jax():
    ref = JL.init_layernorm(24, jnp.bfloat16)
    out = L.init_layernorm(24, torch.bfloat16)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(out[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dtype):
    """Normalised in f32 and cast back before scale and bias on both
    sides; bf16 within one bf16 ulp of the output (2^-7 relative)."""
    x = _np((3, 5, 48), 2.0) + 1.5
    p = {"scale": 1 + _np((48,), 0.2), "bias": _np((48,), 0.2)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = JL.layernorm({k: jnp.asarray(v, jdt) for k, v in p.items()},
                       jnp.asarray(x, jdt))
    out = L.layernorm({k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
                      torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref, rtol=2**-7,
                                   atol=2**-7)
