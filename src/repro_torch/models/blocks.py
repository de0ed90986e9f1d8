"""The residual blocks of the LMs, as in the JAX package's
``repro.models.blocks``: the attention (+ gated MLP or MoE) block of the
decoder-only LM and of the hybrid, with per-layer init, full-sequence
forward and one-token decode against a KV cache (pre-norm residual, with
gemma2's post-norms ``ln1_post``, ``ln2_post`` when the config asks), the
encoder-decoder's bidirectional encoder block and its decoder block with
cross-attention (``cross=True``), and the pre-norm residuals around the
hybrid's Mamba2 cell and xLSTM's mLSTM and sLSTM cells.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.dtensor import merge_last, split_last
from repro_torch.core.hints import hint
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

Params = dict[str, Any]


def init_attn_block(gen: torch.Generator, cfg, dtype: torch.dtype, *,
                    use_moe: bool = False, cross: bool = False,
                    device=None) -> Params:
    """The FFN is the MoE with ``use_moe``, else a gated MLP; ``cross``
    adds the decoder's cross-attention (``xattn``) and its norm (``ln_x``)."""
    p: Params = {
        "ln1": L.init_rmsnorm(cfg.d_model, dtype, device),
        "attn": L.init_attention(gen, cfg, dtype, device),
        "ln2": L.init_rmsnorm(cfg.d_model, dtype, device),
    }
    if cross:
        p["ln_x"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["xattn"] = L.init_attention(gen, cfg, dtype, device)
    if use_moe:
        p["moe"] = MOE.init_moe(gen, cfg, dtype, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)
    if cfg.post_attn_norm:
        p["ln1_post"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    if cfg.post_mlp_norm:
        p["ln2_post"] = L.init_rmsnorm(cfg.d_model, dtype, device)
    return p


def _ffn(p: Params, x: torch.Tensor, cfg) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    if "moe" in p:
        return MOE.moe_ffn(p["moe"], x, cfg)
    return L.mlp(p["mlp"], x, cfg.mlp_activation), \
        torch.zeros((), dtype=torch.float32, device=x.device)


def attn_block(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               window: int, causal: bool = True,
               enc_out: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence attention block over (B, S, d) with the given sliding
    ``window`` (0 = global), causal unless ``causal=False`` (the encoder).
    With ``enc_out`` (B, T, d), cross-attention to it (non-causal, over all
    T) runs after self-attention and before the FFN, with no post-norm.
    The ``residual`` sharding hint sits on the block's input and on the
    attention's output, as in JAX.  Returns (x, aux_loss)."""
    x = hint("residual", x)
    h = L.attention(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                    positions=positions, window=window, causal=causal)
    if "ln1_post" in p:
        h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
    x = x + hint("residual", h)
    if enc_out is not None:
        x = x + L.attention(p["xattn"], L.rmsnorm(p["ln_x"], x, cfg.norm_eps),
                            cfg, positions=positions, window=0, causal=False,
                            kv_override=enc_out)
    h, aux = _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    if "ln2_post" in p:
        h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
    return x + h, aux


# ---- decode with KV cache ----

def init_attn_cache(cfg, batch: int, max_len: int, dtype: torch.dtype,
                    device=None, cross_len: int = 0) -> Params:
    """``k``, ``v``: (batch, max_len, KV, hd) zeros; with ``cross_len``
    also the cross-attention's ``xk``, ``xv``: (batch, cross_len, KV, hd)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def zeros(length: int) -> torch.Tensor:
        return torch.zeros((batch, length, kv, hd), dtype=dtype,
                           device=device)
    c = {"k": zeros(max_len), "v": zeros(max_len)}
    if cross_len:
        c["xk"], c["xv"] = zeros(cross_len), zeros(cross_len)
    return c


def attn_block_decode(p: Params, cache: Params, x: torch.Tensor, cfg, *,
                      index: int, window: int = 0):
    """One-token decode.  x: (B, 1, d); ``index`` is the position.  Writes
    this token's k and v into ``cache`` at ``index`` in place (the JAX
    version returns an updated copy) and attends, through the plain
    ``attention_scores``, to keys ``kpos <= index`` and, when
    ``window > 0``, ``kpos > index - window``.  With ``xk``/``xv`` in the
    cache, cross-attention to them follows, also through the plain
    ``attention_scores`` with an all-ones mask, as in JAX: a decode step
    launches no kernel.  Returns (x, cache, aux)."""
    B = x.shape[0]
    kv, hd, h_ = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_heads
    xin = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q = split_last(xin @ p["attn"]["wq"], h_, hd)
    k = split_last(xin @ p["attn"]["wk"], kv, hd)
    v = split_last(xin @ p["attn"]["wv"], kv, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["attn"]["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["attn"]["k_norm"], k, cfg.norm_eps)
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    ck[:, index] = k[:, 0].to(ck.dtype)
    cv[:, index] = v[:, 0].to(cv.dtype)
    kpos = torch.arange(ck.shape[1], device=x.device)
    m = kpos <= index
    if window > 0:
        m &= kpos > index - window
    attn_out = L.attention_scores(q, ck, cv, m[None, None, :],
                                  cfg.attn_softcap)
    h = merge_last(attn_out) @ p["attn"]["wo"]
    if "ln1_post" in p:
        h = L.rmsnorm(p["ln1_post"], h, cfg.norm_eps)
    x = x + h
    if "xk" in cache:
        xq = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
        qx = split_last(xq @ p["xattn"]["wq"], h_, hd)
        xm = torch.ones((1, 1, cache["xk"].shape[1]), dtype=torch.bool,
                        device=x.device)
        hx = L.attention_scores(qx, cache["xk"], cache["xv"], xm,
                                cfg.attn_softcap)
        x = x + merge_last(hx) @ p["xattn"]["wo"]
    h, aux = _ffn(p, L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    if "ln2_post" in p:
        h = L.rmsnorm(p["ln2_post"], h, cfg.norm_eps)
    return x + h, cache, aux


# ---- mamba block (pre-norm residual around the cell) ----

def init_mamba_block(gen: torch.Generator, cfg, dtype: torch.dtype,
                     device=None) -> Params:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, device),
            "cell": SSM.init_mamba2(gen, cfg, dtype, device)}


def mamba_block(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + SSM.mamba2_forward(p["cell"],
                                  L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)


def mamba_block_decode(p: Params, cache: Params, x: torch.Tensor, cfg
                       ) -> tuple[torch.Tensor, Params]:
    """One-token decode; updates ``cache`` in place and returns it."""
    y, c = SSM.mamba2_decode_step(p["cell"], cache,
                                  L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)
    return x + y, c


# ---- xLSTM blocks (pre-norm residual around each cell) ----

def init_mlstm_block(gen: torch.Generator, cfg, dtype: torch.dtype,
                     device=None) -> Params:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, device),
            "cell": XL.init_mlstm(gen, cfg, dtype, device)}


def mlstm_block(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + XL.mlstm_forward(p["cell"],
                                L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)


def mlstm_block_decode(p: Params, cache: Params, x: torch.Tensor, cfg
                       ) -> tuple[torch.Tensor, Params]:
    """One-token decode; updates ``cache`` in place and returns it."""
    y, c = XL.mlstm_decode_step(p["cell"], cache,
                                L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)
    return x + y, c


def init_slstm_block(gen: torch.Generator, cfg, dtype: torch.dtype,
                     device=None) -> Params:
    return {"ln": L.init_rmsnorm(cfg.d_model, dtype, device),
            "cell": XL.init_slstm(gen, cfg, dtype, device)}


def slstm_block(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    return x + XL.slstm_forward(p["cell"],
                                L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)


def slstm_block_decode(p: Params, cache: Params, x: torch.Tensor, cfg
                       ) -> tuple[torch.Tensor, Params]:
    """One-token decode; updates ``cache`` in place and returns it."""
    y, c = XL.slstm_decode_step(p["cell"], cache,
                                L.rmsnorm(p["ln"], x, cfg.norm_eps), cfg)
    return x + y, c
