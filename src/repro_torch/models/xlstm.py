"""xLSTM cells (arXiv:2405.04517), as in the JAX package's
``repro.models.xlstm``: the mLSTM (matrix memory) and the sLSTM (scalar
memory with a block-diagonal recurrence), each with init, full-sequence
forward, cache and one-token decode.

mLSTM per head, with P = d_model // num_heads (not ``head_dim``):

    C_t = f_t · C_{t-1} + i_t · v_t k_tᵀ          (P × P matrix memory)
    n_t = f_t · n_{t-1} + i_t · k_t
    h_t = o_t ⊙ (C_t q_t) / max(|n_tᵀ q_t|, 1)

with log-space gate stabilisation (m_t, a running max).  The JAX forward
runs its own ``lax.scan`` of that step; the port hands the whole
recurrence to one ``ops.mlstm_scan`` call per layer, which on the card is
the hand-written mLSTM-scan kernel.  It computes the same steps in the
same order; the one textual difference is the stabiliser before the first
step, -1e30 in the kernel where the JAX forward has -inf, which changes
no output: C and n start at 0 and f_s = exp(-huge) = 0 either way.

The sLSTM is strictly recurrent (h_{t-1} feeds the next step through
``r_z``) and has no kernel in JAX either: it is a Python loop over time
with the input projections taken once outside it, as JAX's ``lax.scan``.
Each step makes new c, n, m and h, so autograd differentiates the loop.
Decode is plain PyTorch for both cells, as in JAX, and updates the cache
in place.  The bf16 casts sit where JAX has them.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.dtensor import local_pointwise, merge_last, split_last
from repro_torch.kernels import ops
from repro_torch.kernels.ref import MLSTM_M0
from repro_torch.models.layers import _randn, dense_init, rmsnorm

Params = dict[str, Any]


def _heads(cfg) -> tuple[int, int]:
    H = cfg.num_heads
    return H, cfg.d_model // H


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg, dtype: torch.dtype,
               device=None) -> Params:
    """The JAX tree: the gate weights ``w_i`` and ``w_f`` (d × H) are f32,
    the rest is in ``dtype``."""
    d = cfg.d_model
    H, _ = _heads(cfg)
    f32 = torch.float32
    return {
        "wq": dense_init(gen, d, d, dtype, device),
        "wk": dense_init(gen, d, d, dtype, device),
        "wv": dense_init(gen, d, d, dtype, device),
        "w_i": dense_init(gen, d, H, f32, device),     # input gate (pre-exp)
        "w_f": dense_init(gen, d, H, f32, device),     # forget gate
        "w_o": dense_init(gen, d, d, dtype, device),   # output gate
        "out_proj": dense_init(gen, d, d, dtype, device),
        "norm_w": torch.ones(d, dtype=dtype, device=device),
    }


def _mlstm_out(p: Params, h: torch.Tensor, o: torch.Tensor, cfg,
               dtype: torch.dtype) -> torch.Tensor:
    """h in f32 → ``dtype``, times the output gate, RMSNorm, out_proj."""
    h = h.to(dtype) * o
    h = merge_last(h)
    return rmsnorm(p["norm_w"], h, cfg.norm_eps) @ p["out_proj"]


def mlstm_forward(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The stabilised mLSTM over the sequence.  x: (B, S, d) → (B, S, d)."""
    H, P = _heads(cfg)
    q = split_last(x @ p["wq"], H, P).float() / math.sqrt(P)
    k = split_last(x @ p["wk"], H, P).float()
    v = split_last(x @ p["wv"], H, P).float()
    xf = x.float()
    i_pre = xf @ p["w_i"]                                   # (B, S, H)
    f_pre = xf @ p["w_f"]
    o = split_last(torch.sigmoid(x @ p["w_o"]), H, P)
    h = ops.mlstm_scan(q, k, v, i_pre, f_pre)
    return _mlstm_out(p, h, o, cfg, x.dtype)


def mlstm_init_cache(cfg, batch: int, device=None) -> Params:
    H, P = _heads(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, P, P), dtype=f32, device=device),
        "n": torch.zeros((batch, H, P), dtype=f32, device=device),
        "m": torch.full((batch, H), MLSTM_M0, dtype=f32, device=device),
    }


def mlstm_decode_step(p: Params, cache: Params, x: torch.Tensor, cfg
                      ) -> tuple[torch.Tensor, Params]:
    """x: (B, 1, d) → (y, cache).  Writes the new C, n and m into ``cache``
    in place (the JAX version returns an updated copy) and returns it."""
    Bt = x.shape[0]
    H, P = _heads(cfg)
    qt = split_last(x @ p["wq"], H, P).reshape(Bt, H, P).float() \
        / math.sqrt(P)
    kt = split_last(x @ p["wk"], H, P).reshape(Bt, H, P).float()
    vt = split_last(x @ p["wv"], H, P).reshape(Bt, H, P).float()
    xf = x[:, 0].float()
    it = xf @ p["w_i"]
    ft = xf @ p["w_f"]
    o = split_last(torch.sigmoid(x @ p["w_o"]), H, P)

    C, n, m = cache["C"], cache["n"], cache["m"]
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(log_f + m - m_new)
    C.mul_(f_s[..., None, None]).add_(
        i_s[..., None, None] * (vt[..., :, None] * kt[..., None, :]))
    n.mul_(f_s[..., None]).add_(i_s[..., None] * kt)
    m.copy_(m_new)
    num = (C @ qt[..., None])[..., 0]
    den = (n * qt).sum(-1).abs().clamp_min(1.0)
    h = (num / den[..., None]).reshape(Bt, 1, H, P)
    return _mlstm_out(p, h, o, cfg, x.dtype), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg, dtype: torch.dtype,
               device=None) -> Params:
    """The JAX tree: ``w_i``, ``w_f`` (d × d) and the per-head recurrent
    ``r_z`` (H, P, P), drawn N(0, 1/P), are f32; the rest is in
    ``dtype``."""
    d = cfg.d_model
    H, P = _heads(cfg)
    f32 = torch.float32
    return {
        "w_z": dense_init(gen, d, d, dtype, device),
        "w_i": dense_init(gen, d, d, f32, device),
        "w_f": dense_init(gen, d, d, f32, device),
        "w_o": dense_init(gen, d, d, dtype, device),
        "r_z": _randn(gen, (H, P, P), 1.0 / math.sqrt(P), f32, device),
        "out_proj": dense_init(gen, d, d, dtype, device),
        "norm_w": torch.ones(d, dtype=dtype, device=device),
    }


def _slstm_step(p: Params, state: Params, h_prev: torch.Tensor,
                zt: torch.Tensor, it: torch.Tensor, log_f: torch.Tensor,
                ot: torch.Tensor, cfg) -> tuple[Params, torch.Tensor]:
    """One sLSTM step on (B, d) f32 inputs: returns the new c, n and m and
    the new h, all new tensors."""
    H, P = _heads(cfg)
    c, n, m = state["c"], state["n"], state["m"]
    hr = merge_last(torch.bmm(split_last(h_prev, H, P).transpose(0, 1),
                              p["r_z"]).transpose(0, 1))
    z = torch.tanh(zt + hr)
    lf_m = log_f + m
    m_new = torch.maximum(lf_m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(lf_m - m_new)
    c = torch.addcmul(c * f_s, i_s, z)
    n = n * f_s + i_s
    h = ot * c / n.clamp_min(1.0)
    return {"c": c, "n": n, "m": m_new}, h


def slstm_forward(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The sLSTM over the sequence, step by step (about 17 small kernels a
    step).  x: (B, S, d) → (B, S, d)."""
    Bt, S, _ = x.shape
    xf = x.float()
    z_in = (x @ p["w_z"]).float()
    i_in = xf @ p["w_i"]
    log_f = local_pointwise(F.logsigmoid, xf @ p["w_f"])
    o_in = torch.sigmoid(x @ p["w_o"]).float()
    state = slstm_init_cache(cfg, Bt, x.device)
    h, hs = state.pop("h"), []
    for t in range(S):
        state, h = _slstm_step(p, state, h, z_in[:, t], i_in[:, t],
                               log_f[:, t], o_in[:, t], cfg)
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    return rmsnorm(p["norm_w"], hs.to(x.dtype), cfg.norm_eps) @ p["out_proj"]


def slstm_init_cache(cfg, batch: int, device=None) -> Params:
    d = cfg.d_model
    f32 = torch.float32
    return {
        "c": torch.zeros((batch, d), dtype=f32, device=device),
        "n": torch.zeros((batch, d), dtype=f32, device=device),
        "m": torch.full((batch, d), MLSTM_M0, dtype=f32, device=device),
        "h": torch.zeros((batch, d), dtype=f32, device=device),
    }


def slstm_decode_step(p: Params, cache: Params, x: torch.Tensor, cfg
                      ) -> tuple[torch.Tensor, Params]:
    """x: (B, 1, d) → (y (B, 1, d), cache).  Writes the new c, n, m and h
    into ``cache`` in place (the JAX version returns an updated copy) and
    returns it."""
    x0 = x[:, 0]
    xf = x0.float()
    state, h = _slstm_step(p, cache, cache["h"], (x0 @ p["w_z"]).float(),
                           xf @ p["w_i"], F.logsigmoid(xf @ p["w_f"]),
                           torch.sigmoid(x0 @ p["w_o"]).float(), cfg)
    for key, value in (*state.items(), ("h", h)):
        cache[key].copy_(value)
    y = rmsnorm(p["norm_w"], h.to(x.dtype), cfg.norm_eps) @ p["out_proj"]
    return y[:, None, :], cache
