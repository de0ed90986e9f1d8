"""The gradient of the flash path (``FlashAttention``) on the CPU: the
autograd function built with the plain forward injected in place of the
kernel, its dq, dk and dv held against autograd of ``attention_ref`` and
against ``jax.grad`` of the JAX package's ``attention_scores`` (the
arithmetic JAX trains through), for causal, windowed, softcapped, GQA and
non-causal cross shapes.  Limit: 1e-5·max|reference| per element in f32
(the same f32 arithmetic summed in another order); in bf16 the inputs'
dtype comes back and each element lies within half a bf16 ulp of the f32
gradient plus 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.ref import attention_ref, attention_ref_grad

RTOL = 1e-5

# name, B, H, KV, S, T, D, causal, window, softcap
SHAPES = [
    ("causal", 2, 4, 4, 24, 24, 16, True, 0, 0.0),
    ("window", 1, 4, 4, 40, 40, 16, True, 8, 0.0),
    ("softcap", 2, 2, 2, 17, 17, 32, True, 0, 50.0),
    ("window_softcap", 1, 4, 2, 33, 33, 16, True, 6, 30.0),
    ("gqa_4to1", 2, 8, 2, 20, 20, 16, True, 0, 0.0),
    ("cross_noncausal", 2, 4, 4, 9, 30, 16, False, 0, 0.0),
]


def _inputs(shape, seed=0):
    _, B, H, KV, S, T, D, *_ = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, D)).astype(np.float32)
    do = rng.normal(size=(B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _flat(x: np.ndarray) -> torch.Tensor:
    """(B, S, H, D) → the kernel's (B·H, S, D)."""
    B, S, H, D = x.shape
    return torch.from_numpy(x).permute(0, 2, 1, 3).reshape(B * H, S, D) \
        .contiguous()


def _unflat(x: torch.Tensor, B: int) -> np.ndarray:
    BH, S, D = x.shape
    return x.reshape(B, BH // B, S, D).permute(0, 2, 1, 3).float().numpy()


def _function_grads(shape, q, k, v, do, dtype=torch.float32):
    _, B, *_, causal, window, softcap = shape
    leaves = [_flat(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = FlashAttention.apply(*leaves, causal, window, softcap,
                               attention_ref)
    out.backward(_flat(do).to(dtype))
    return out, [t.grad for t in leaves]


def _jax_grads(shape, q, k, v, do):
    _, B, H, KV, S, T, D, causal, window, softcap = shape
    qpos, kpos = np.arange(S)[:, None], np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window

    def f(q_, k_, v_):
        o = JL.attention_scores(q_, k_, v_, jnp.asarray(mask[None]), softcap)
        return jnp.sum(o * do)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _held(got: np.ndarray, ref: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=RTOL * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_function_backward_matches_autograd_of_plain(shape):
    q, k, v, do = _inputs(shape)
    _, B, *_, causal, window, softcap = shape
    out, grads = _function_grads(shape, q, k, v, do)
    leaves = [_flat(a).requires_grad_() for a in (q, k, v)]
    ref_out = attention_ref(*leaves, causal=causal, window=window,
                            softcap=softcap)
    ref_out.backward(_flat(do))
    assert torch.equal(out.detach(), ref_out.detach())
    for name, g, t in zip("qkv", grads, leaves):
        assert g.shape == t.shape and g.dtype == torch.float32
        _held(g.numpy(), t.grad.numpy(), f"d{name}")


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_function_backward_matches_jax_grad(shape):
    q, k, v, do = _inputs(shape, seed=1)
    B = shape[1]
    _, grads = _function_grads(shape, q, k, v, do)
    for name, g, want in zip("qkv", grads, _jax_grads(shape, q, k, v, do)):
        _held(_unflat(g, B), np.asarray(want), f"d{name}")


@pytest.mark.parametrize("shape", SHAPES[2:5], ids=[s[0] for s in SHAPES[2:5]])
def test_function_backward_bf16(shape):
    """bf16 inputs: bf16 gradients, each within half a bf16 ulp (2^-8
    relative) plus 2e-5 of the gradient of the same bf16 values in f32."""
    q, k, v, do = _inputs(shape, seed=2)
    _, grads = _function_grads(shape, q, k, v, do, torch.bfloat16)
    as_bf16 = [_flat(a).bfloat16().float() for a in (q, k, v, do)]
    _, B, *_, causal, window, softcap = shape
    ref = attention_ref_grad(*as_bf16, causal=causal, window=window,
                             softcap=softcap)
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        err = (g.float() - r).abs()
        assert bool((err <= 2.0 ** -8 * r.abs() + 2e-5).all())


def test_ops_flash_attention_differentiates_on_cpu():
    """On the CPU the op takes the plain version, which autograd
    differentiates; its gradients are the Function's."""
    shape = SHAPES[3]
    q, k, v, do = _inputs(shape, seed=3)
    _, B, *_, causal, window, softcap = shape
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window,
                              softcap=softcap)
    out.backward(torch.from_numpy(do))
    _, grads = _function_grads(shape, q, k, v, do)
    for t, g in zip(leaves, grads):
        _held(t.grad.numpy(), _unflat(g, B), "op vs Function")
