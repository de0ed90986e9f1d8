"""Gradients of the port's hybrid and xLSTM recurrences against ``jax.grad``
of the JAX package's, on the CPU at small sizes: the plain SSD scan and
mLSTM recurrence (``kernels.ref``, which write nothing in place, so autograd
differentiates them) against the vector-Jacobian products of
``repro.kernels.ref``'s scans, and the Mamba2, mLSTM and sLSTM cells per
parameter (and per input) against the JAX cells.  The JAX mLSTM cell starts
its stabiliser at -inf where the port's scan starts it at -1e30; the
gradients agree there too.  Each gradient tensor is held within
GRAD_RTOL·max|g_jax| of JAX's (f32 sums in another order), with max|g_jax|
taken as at least ZERO of the call's largest gradient: in the forget-all
draw i_t sets m_t and cancels, and d i_pre is rounding (~1e-13) on both
sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ref as JREF
from repro.models import ssm as JSSM
from repro.models import xlstm as JXL
from repro_torch.configs import get_config
from repro_torch.kernels import ref as REF
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

GRAD_RTOL = 1e-4   # per tensor, of max|g_jax|
ZERO = 1e-6        # of the largest gradient: below it, rounding


@pytest.fixture
def one_thread():
    """The plain recurrences' autograd is thousands of small ops, which
    gain nothing from intra-op threads and, beside other test processes,
    lose much to them: run the test on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _normal(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _jax_vjp(fn, args, dout):
    _, pull = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g) for g in pull(jnp.asarray(dout))]


def _torch_vjp(fn, args, dout):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    fn(*leaves).backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in leaves]


def _hold(got, want, names):
    top = max(np.abs(w).max() for w in want)
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_RTOL * max(np.abs(w).max(), ZERO * top),
            err_msg=name)


# --- the plain scans ---------------------------------------------------------------

def _scan_args(kind, seed=0, b=2, s=48, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    dtx = _normal(rng, (b, s, h, p), 0.3)
    if kind == "reset":
        a_log = np.full((b, s, h), -30.0, np.float32)
    elif kind == "long_memory":
        a_log = -np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (b, s, h))
                        ).astype(np.float32)
    else:
        a_log = -np.logaddexp(0.0, _normal(rng, (b, s, h))).astype(np.float32)
    args = dtx, a_log, _normal(rng, (b, s, n), 0.3), _normal(rng, (b, s, n),
                                                            0.3)
    return args, _normal(rng, (b, s, h, p))


@pytest.mark.parametrize("kind", ["fast", "long_memory", "reset"])
def test_scan_ref_gradient_matches_jax(kind, one_thread):
    args, dy = _scan_args(kind)
    _hold(_torch_vjp(REF.mamba_scan_ref, args, dy),
          _jax_vjp(JREF.mamba_scan_ref, args, dy),
          ["dtx", "a_log", "B", "C"])


def _mlstm_args(kind, seed=1, b=2, s=40, h=2, p=16):
    rng = np.random.default_rng(seed)
    scale = 0.05 if kind == "clamp" else 0.4
    q, k, v = (_normal(rng, (b, s, h, p), scale) for _ in range(3))
    i_pre = _normal(rng, (b, s, h), 10.0 if kind == "stabiliser" else 1.0)
    if kind == "forget_all":
        f_pre = np.full((b, s, h), -30.0, np.float32)
    else:
        f_pre = _normal(rng, (b, s, h), 1.0,
                        4.0 if kind == "long_memory" else 2.0)
    return (q, k, v, i_pre, f_pre), _normal(rng, (b, s, h, p))


@pytest.mark.parametrize("kind", ["usual", "stabiliser", "long_memory",
                                  "forget_all", "clamp"])
def test_mlstm_ref_gradient_matches_jax(kind, one_thread):
    """``clamp`` draws q and k small, so |n·q| < 1 at most steps and the
    gradient flows through the stabiliser's chain."""
    args, dh = _mlstm_args(kind)
    _hold(_torch_vjp(REF.mlstm_ref, args, dh),
          _jax_vjp(JREF.mlstm_ref, args, dh),
          ["q", "k", "v", "i_pre", "f_pre"])


# --- the cells -------------------------------------------------------------------

B, S = 2, 16
HYBRID, XLSTM = "zamba2-2.7b-smoke", "xlstm-1.3b-smoke"


@functools.cache
def _jax_cell(kind):
    if kind == "mamba2":
        cfg = jax_get_config(HYBRID)
        return cfg, JSSM.init_mamba2(jax.random.PRNGKey(3), cfg, jnp.float32)
    cfg = jax_get_config(XLSTM)
    init = JXL.init_mlstm if kind == "mlstm" else JXL.init_slstm
    return cfg, init(jax.random.PRNGKey(4), cfg, jnp.float32)


CELLS = {"mamba2": (JSSM.mamba2_forward, SSM.mamba2_forward, HYBRID),
         "mlstm": (JXL.mlstm_forward, XL.mlstm_forward, XLSTM),
         "slstm": (JXL.slstm_forward, XL.slstm_forward, XLSTM)}


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_gradient_matches_jax(kind, one_thread):
    """d(sum(dout ∘ cell(p, x))) per parameter and for x, against
    ``jax.grad`` of the JAX cell."""
    jax_fwd, port_fwd, arch = CELLS[kind]
    jcfg, jp = _jax_cell(kind)
    cfg = get_config(arch)
    rng = np.random.default_rng(7)
    x = _normal(rng, (B, S, jcfg.d_model))
    dout = _normal(rng, (B, S, jcfg.d_model))
    names = sorted(jp)

    def loss(params, x):
        return jnp.sum(jax_fwd(params, x, jcfg) * dout)
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    params = {k: torch.tensor(np.asarray(jp[k])).requires_grad_()
              for k in names}
    xt = torch.from_numpy(x).requires_grad_()
    (port_fwd(params, xt, cfg) * torch.from_numpy(dout)).sum().backward()
    _hold([params[k].grad.numpy() for k in names] + [xt.grad.numpy()],
          [np.asarray(jgp[k]) for k in names] + [np.asarray(jgx)],
          names + ["x"])
