"""Mamba2 (SSD) cells for the zamba2 hybrid, as in the JAX package's
``repro.models.ssm``.

The state-space duality form: per head h with head_dim P and state N,

    a_t = exp(-Δ_t · exp(A_log_h))                 (scalar decay)
    S_t = a_t · S_{t-1} + (Δ_t · x_t) ⊗ B_t        (P × N state)
    y_t = S_t · C_t + D_h · x_t

The JAX forward computes the scan chunk-parallel in ``jnp`` (an intra-chunk
attention-like term plus an inter-chunk state carry); the port hands the
whole scan to one ``ops.mamba_scan`` call, which on the card is the
hand-written SSD-scan kernel.  Everything around it (projections, the
causal conv, the ``D·x`` skip, the ``silu(z)`` gate and the gated RMSNorm)
is plain PyTorch with the bf16 casts at the same points as JAX.  Decode is
O(1), one state update per token, plain PyTorch as in JAX.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.dtensor import merge_last, split_last
from repro_torch.kernels import ops
from repro_torch.models.layers import _randn, dense_init

Params = dict[str, Any]


def ssm_dims(cfg) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state_dim
    return d_inner, H, P, N


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype,
                device=None) -> Params:
    """The JAX tree: ``A_log``, ``D`` and ``dt_bias`` stay f32, the rest
    is in ``dtype``."""
    d = cfg.d_model
    d_inner, H, P, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N              # x, B, C share the causal conv
    f32 = torch.float32
    return {
        # in_proj → [z (gate), x, B, C, dt]
        "in_proj": dense_init(gen, d, 2 * d_inner + 2 * N + H, dtype, device),
        "conv_w": _randn(gen, (cfg.ssm_conv_width, conv_ch), 0.1, dtype,
                         device),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.linspace(1.0, 16.0, H, dtype=f32,
                                device=device).log(),
        "D": torch.ones(H, dtype=f32, device=device),
        "dt_bias": torch.zeros(H, dtype=f32, device=device),
        "norm_w": torch.ones(d_inner, dtype=dtype, device=device),
        "out_proj": dense_init(gen, d_inner, d, dtype, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x: (B, S, C), w: (W, C); ``state``
    holds the W-1 inputs before x (zeros when None).  Summed in f32 and
    rounded once to ``x.dtype``.  Returns (y, new_state), the new state
    being the trailing W-1 inputs."""
    Wd, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], Wd - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                       # (B, S+W-1, C)
    wf = w.float()
    acc = xp[:, 0:S].float() * wf[0]
    for k in range(1, Wd):
        acc += xp[:, k:k + S].float() * wf[k]
    y = acc.to(x.dtype) + b
    return y, xp[:, xp.shape[1] - (Wd - 1):]


def _split_proj(proj: torch.Tensor, cfg):
    d_inner, H, P, N = ssm_dims(cfg)
    z, rest = proj[..., :d_inner], proj[..., d_inner:]
    xbc, dt = rest[..., : d_inner + 2 * N], rest[..., d_inner + 2 * N:]
    return z, xbc, dt


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, cfg,
                dtype: torch.dtype) -> torch.Tensor:
    """The mamba2 epilogue: y in f32 → ``dtype``, times silu(z), RMSNorm in
    f32, back to ``dtype``, times ``norm_w``, then ``out_proj``."""
    y = y.to(dtype) * F.silu(z)
    y32 = y.float()
    var = y32.square().mean(dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps)).to(dtype) * p["norm_w"]
    return y @ p["out_proj"]


def mamba2_forward(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence forward.  x: (B, S, d) → (B, S, d).  Refuses, as JAX
    does, an S that does not divide into ``ssm_chunk`` steps, though the
    kernel itself takes any S."""
    S = x.shape[1]
    d_inner, H, P, N = ssm_dims(cfg)
    Q = min(cfg.ssm_chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by ssm chunk {Q}")

    proj = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc)
    xh = split_last(xbc[..., :d_inner], H, P)
    Bm = xbc[..., d_inner:d_inner + N]                      # (B,S,N) 1 group
    Cm = xbc[..., d_inner + N:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])          # (B,S,H)
    a_log = -dt * p["A_log"].exp()                          # log decay
    dtx = xh.float() * dt[..., None]                        # (B,S,H,P)
    y = ops.mamba_scan(dtx, a_log, Bm.float(), Cm.float())
    y = y + xh.float() * p["D"][None, None, :, None]
    return _gated_norm(p, merge_last(y), z, cfg, x.dtype)


# ---------------------------------------------------------------------------
# decode (O(1) per token)
# ---------------------------------------------------------------------------

def mamba2_init_cache(cfg, batch: int, dtype: torch.dtype,
                      device=None) -> Params:
    d_inner, H, P, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
    }


def mamba2_decode_step(p: Params, cache: Params, x: torch.Tensor, cfg
                       ) -> tuple[torch.Tensor, Params]:
    """x: (B, 1, d) → (y, cache).  Writes the new SSM and conv states into
    ``cache`` in place (the JAX version returns an updated copy) and
    returns it."""
    Bt = x.shape[0]
    d_inner, H, P, N = ssm_dims(cfg)
    proj = x @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(proj, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    cache["conv"].copy_(conv_state)
    xbc = F.silu(xbc)
    xh = xbc[..., :d_inner].reshape(Bt, H, P)
    Bm = xbc[:, 0, d_inner:d_inner + N].float()
    Cm = xbc[:, 0, d_inner + N:].float()

    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])    # (B,H)
    a = torch.exp(-dt * p["A_log"].exp())
    dtx = xh.float() * dt[..., None]                        # (B,H,P)
    ssm = cache["ssm"]
    ssm.mul_(a[..., None, None]).addcmul_(dtx[..., None], Bm[:, None, None])
    y = (ssm @ Cm[:, None, :, None])[..., 0] \
        + xh.float() * p["D"][None, :, None]
    return _gated_norm(p, y.reshape(Bt, 1, d_inner), z, cfg, x.dtype), cache


def mamba2_ref_scan(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Naive per-token recurrence — oracle for the forward."""
    cache = mamba2_init_cache(cfg, x.shape[0], x.dtype, x.device)
    ys = [mamba2_decode_step(p, cache, x[:, t:t + 1], cfg)[0]
          for t in range(x.shape[1])]
    return torch.cat(ys, dim=1)

