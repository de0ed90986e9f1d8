"""The port's fused CONV + BN + [ADD] + [RELU] on the CPU, held against the
JAX oracle ``repro.kernels.ref.fused_conv_ref`` on the geometry grid of
``tests/test_kernels.py``, at its tolerance (atol 1e-4).  The Pallas kernel
itself does not trace on this jax, so the JAX side is its plain oracle.
The CUDA kernel is held against the same plain version on the card, in
``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import fused_conv_ref as jax_fused_conv_ref
from repro_torch.kernels import fused_conv as fc
from repro_torch.kernels import ops

ATOL = 1e-4


def _inputs(seed, B, H, W, cin, k, cout, residual_hw=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) * 0.2).astype(np.float32)
    scale = (rng.standard_normal(cout) * 0.1 + 1.0).astype(np.float32)
    shift = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = None
    if residual_hw is not None:
        res = rng.standard_normal((B, *residual_hw, cout)).astype(np.float32)
    return x, w, scale, shift, res


def _both(x, w, scale, shift, res=None, **kw):
    ref = jax_fused_conv_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(shift),
        residual=None if res is None else jnp.asarray(res), **kw)
    out = ops.fused_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(shift),
        residual=None if res is None else torch.from_numpy(res), **kw)
    return out, np.asarray(ref)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                   (1, 2, 0), (7, 2, 3)])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_conv_geometry(k, s, p, relu):
    x, w, scale, shift, _ = _inputs(7, 2, 16, 16, 8, k, 16)
    out, ref = _both(x, w, scale, shift, stride=s, padding=p, relu=relu)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_fused_conv_residual_add_relu():
    """The paper's full fused epilogue: CONV_BN + ADD + RELU in one op."""
    x, w, scale, shift, res = _inputs(8, 1, 8, 8, 8, 3, 8, residual_hw=(8, 8))
    out, ref = _both(x, w, scale, shift, res)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert (out.numpy() >= 0).all()  # relu applied after add


@pytest.mark.parametrize("hw,cout", [(7, 8), (7, 12), (5, 3)])
def test_fused_conv_nondivisible_spatial(hw, cout):
    """Odd extents and channel counts (ResNet 7x7 stage-4 maps) that the
    Pallas version pads to whole tiles and crops."""
    x, w, scale, shift, _ = _inputs(9, 1, hw, hw, 8, 3, cout)
    out, ref = _both(x, w, scale, shift)
    assert out.shape == ref.shape == (1, hw, hw, cout)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("hw", [4, 9, 12])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_fused_conv_sweep(hw, stride, k):
    """The fixed-grid counterpart of test_kernels' hypothesis property."""
    x, w, _, _, _ = _inputs(hw * 10 + stride, 1, hw, hw, 4, k, 8)
    w *= 1.5
    one, zero = np.ones(8, np.float32), np.zeros(8, np.float32)
    out, ref = _both(x, w, one, zero, stride=stride, padding=k // 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_stem_cin3_residual_without_relu():
    """Cin=3 (the stem's K=147) with a residual and no ReLU."""
    x, w, scale, shift, res = _inputs(10, 2, 20, 20, 3, 7, 16,
                                      residual_hw=(10, 10))
    out, ref = _both(x, w, scale, shift, res, stride=2, padding=3,
                     relu=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_cpu_goes_to_plain_version_not_the_kernel():
    x, w, scale, shift, _ = _inputs(11, 1, 6, 6, 4, 3, 4)
    before = fc.launches
    ops.fused_conv(*map(torch.from_numpy, (x, w, scale, shift)))
    assert fc.launches == before


def test_non_cpu_tensor_goes_to_kernel_which_raises():
    """No fallback: a tensor that is not on the CPU reaches the kernel's
    wrapper, which refuses what it cannot launch on."""
    x = torch.empty((1, 6, 6, 4), device="meta")
    w = torch.empty((3, 3, 4, 4), device="meta")
    s = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_conv(x, w, s, s)


@pytest.mark.parametrize("h,k,s,p,want", [(224, 7, 2, 3, 112),
                                          (56, 1, 2, 0, 28), (7, 3, 1, 1, 7),
                                          (14, 3, 2, 1, 7)])
def test_out_hw(h, k, s, p, want):
    assert fc.out_hw(h, h, k, k, s, p) == (want, want)
