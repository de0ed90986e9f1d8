"""The scans' dtype contract at the ops level, against JAX's ops: bf16
operands are read as f32, the recurrence runs in f32 and the output has
the first operand's dtype (``repro.kernels.mamba_scan`` and
``mlstm_scan`` write ``dtx.dtype`` and ``q.dtype``), on the CPU here and
on the card (``tests/test_torch_cuda.py``), under autograd too.  JAX's ops
run their Pallas kernels in interpret mode on the CPU.  The two sides
round the same f32 recurrence once, from sums taken in other orders: one
bf16 ulp (2^-7·|ref|) plus the scans' f32 limit (1e-4, as
tests/test_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops

ATOL = 1e-4
BF16_ULP = 2.0**-7


def _np(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _scan_inputs(seed, b=2, S=64, H=3, P=16, N=8):
    """As tests/test_kernels.py draws them: dtx·0.3, a_log = −softplus(N(0,
    1)), B and C ·0.3."""
    rng = np.random.default_rng(seed)
    return (_np(rng, (b, S, H, P), 0.3),
            -np.logaddexp(0.0, _np(rng, (b, S, H))).astype(np.float32),
            _np(rng, (b, S, N), 0.3), _np(rng, (b, S, N), 0.3))


def _mlstm_inputs(seed, b=2, S=32, H=2, P=16):
    """q, k, v ·0.4, i_pre N(0, 1), f_pre N(0, 1) + 2."""
    rng = np.random.default_rng(seed)
    return (*(_np(rng, (b, S, H, P), 0.4) for _ in range(3)),
            _np(rng, (b, S, H)), _np(rng, (b, S, H), 1.0, 2.0))


CASES = {"mamba_scan": _scan_inputs, "mlstm_scan": _mlstm_inputs}
# per operand: bf16 (True) or f32; the first decides the output's dtype
MIXES = [(True,) * 5, (True, False, False, False, False),
         (False, True, True, True, True)]


def _operands(arrays, mix):
    """The same values as torch tensors and JAX arrays, bf16 where ``mix``
    says (rounded once, on the torch side)."""
    ts = [torch.from_numpy(a).to(torch.bfloat16 if b else torch.float32)
          for a, b in zip(arrays, mix)]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
        for t in ts]
    return ts, js


@pytest.mark.parametrize("mix", MIXES, ids=["all_bf16", "first_bf16",
                                            "first_f32"])
@pytest.mark.parametrize("op", CASES)
def test_scan_dtype_and_value_match_jax_ops(op, mix):
    arrays = CASES[op](3)
    ts, js = _operands(arrays, mix)
    out = getattr(ops, op)(*ts)
    ref = getattr(jax_ops, op)(*js)
    want = torch.bfloat16 if mix[0] else torch.float32
    assert out.dtype == want and ref.dtype == (
        jnp.bfloat16 if mix[0] else jnp.float32)
    ref = np.asarray(ref, np.float32)
    err = np.abs(out.float().numpy() - ref)
    assert (err <= BF16_ULP * np.abs(ref) + ATOL).all(), err.max()


@pytest.mark.parametrize("op", CASES)
def test_scan_bf16_gradient_is_the_f32_gradient_rounded(op):
    """Under autograd the bf16 op is the f32 op between two casts: its
    gradients are bf16, the f32 op's gradients (of f32 copies, for the
    output gradient read as f32) rounded once."""
    arrays = CASES[op](4)
    xs = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in arrays]
    out = getattr(ops, op)(*xs)
    assert out.dtype == torch.bfloat16
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out.shape).astype(np.float32)).to(torch.bfloat16)
    grads = torch.autograd.grad(out, xs, dout)
    fs = [x.detach().float().requires_grad_(True) for x in xs]
    ref = torch.autograd.grad(getattr(ops, op)(*fs), fs, dout.float())
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))
