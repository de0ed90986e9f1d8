"""Core NN layers in PyTorch, with the JAX package's layouts: norms, RoPE,
GQA attention and gated MLPs for the LM (``(B, S, H, hd)`` activations,
``(d_in, d_out)`` weights), and the conv/bn/pool set of ResNet (NHWC
activations, HWIO conv weights); parameters are plain dicts.

Every ``init_*`` draws from an explicit ``torch.Generator`` on the CPU, one
tensor at a time, and then moves it to ``device`` (``None`` is PyTorch's
default device), so the same seed gives the same weights on every device.
On the ``meta`` device nothing is drawn: only shapes and dtypes are made.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.dtensor import merge_last, split_last
from repro_torch.core.hints import hint
from repro_torch.kernels import ops

Params = dict[str, Any]


_SEP = "__"   # joins nested keys into buffer names; keys hold single "_" only


def flatten_tree(tree: Params, prefix: str = "") -> dict[str, torch.Tensor]:
    """A nested parameter dict as ``{"a__b__c": tensor}``, for registering
    its leaves as an ``nn.Module``'s buffers."""
    flat: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            flat.update(flatten_tree(v, name + _SEP))
        else:
            flat[name] = v
    return flat


def tree_to(tree: Params, device: torch.device) -> Params:
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _randn(gen: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    if torch.device(device or "cpu").type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32).mul_(
        scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return _randn(gen, (in_dim, out_dim), 1.0 / math.sqrt(in_dim), dtype,
                  device)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return _randn(gen, (vocab, dim), 0.02, dtype, device)


# --- norms -------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
    return torch.ones(dim, dtype=dtype, device=device)


def rmsnorm(w: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Normalises in f32 and casts back to ``x.dtype`` before the scale,
    as the JAX version does."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def init_layernorm(dim: int, dtype: torch.dtype = torch.float32,
                   device=None) -> Params:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalises over the last axis in f32 (the biased variance) and casts
    back to ``x.dtype`` before the scale and bias, as the JAX version does."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"] \
        + p["bias"]


# --- rotary position embeddings ----------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of head_dim (not interleaved pairs); the identity when
    ``theta <= 0``."""
    if theta <= 0:
        return x
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs      # (.., S, half)
    cos = torch.cos(angles)[..., :, None, :]              # (.., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --- attention (GQA, sliding window, softcap, qk-norm) -----------------------

def init_attention(gen: torch.Generator, cfg, dtype: torch.dtype = torch.float32,
                   device=None) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p: Params = {
        "wq": dense_init(gen, d, h * hd, dtype, device),
        "wk": dense_init(gen, d, kv * hd, dtype, device),
        "wv": dense_init(gen, d, kv * hd, dtype, device),
        "wo": dense_init(gen, h * hd, d, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor, softcap: float = 0.0) -> torch.Tensor:
    """q: (B,S,H,hd)  k/v: (B,T,KV,hd) with H = KV*G.  mask: broadcastable
    to (B,H,S,T), True = attend.  f32 inside; masked logits are -1e30."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg.float(),
                          k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    m = mask.reshape(B, KV, G, S, T) if mask.dim() == 4 and \
        mask.shape[1] == H else mask[:, None, None, :, :] \
        if mask.dim() == 3 else mask
    logits = torch.where(m, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def causal_mask(S: int, T: int, q_offset: int = 0,
                window: int = 0) -> torch.Tensor:
    """(1, S, T) boolean mask: query i (global pos q_offset+i) attends to
    keys ≤ its position, within ``window`` if nonzero."""
    qpos = torch.arange(S)[:, None] + q_offset
    kpos = torch.arange(T)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m[None]


def attention(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              window: int, causal: bool = True,
              kv_override: torch.Tensor | None = None) -> torch.Tensor:
    """Full attention block (projections + scores) over the whole
    sequence, through ``ops.flash_attention``.

    The JAX version takes a ``mask``; its decoder builds it as
    ``causal_mask(S, S) & _win_mask(S, window)``, which is exactly the
    kernel's ``k_pos <= q_pos`` and, when ``window > 0``,
    ``k_pos > q_pos - window``, and its encoder and cross-attention pass
    all-ones masks, which are ``causal=False`` with no window.  So the port
    passes ``window`` (0 = global) and ``causal`` instead of a mask.

    The sharding hints (``core.hints``) sit where JAX has them: ``qkv``
    on q (and on self-attention's k and v) after the head reshape and
    after the qk-norm, ``attn_out`` on the attention's output.

    ``kv_override`` (B, T, d) feeds cross-attention: keys and values come
    from it (``src @ wk``, ``src @ wv``, with its own length T), qk-norm
    applies as to self-attention, and rope is skipped, as in JAX."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    src = x if kv_override is None else kv_override
    q = hint("qkv", split_last(x @ p["wq"], h, hd))
    k = split_last(src @ p["wk"], kv, hd)
    v = split_last(src @ p["wv"], kv, hd)
    if kv_override is None:
        k, v = hint("qkv", k), hint("qkv", v)
    if cfg.qk_norm:
        q = hint("qkv", rmsnorm(p["q_norm"], q, cfg.norm_eps))
        k = hint("qkv", rmsnorm(p["k_norm"], k, cfg.norm_eps))
    if kv_override is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = hint("attn_out", ops.flash_attention(
        q, k, v, causal=causal, window=window, softcap=cfg.attn_softcap))
    return merge_last(out) @ p["wo"]


# --- gated MLP (SwiGLU / GeGLU) ----------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32, device=None) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def activate(g: torch.Tensor, activation: str) -> torch.Tensor:
    """The gate's activation: SiLU, or GELU.  ``jax.nn.gelu`` is the tanh
    approximation by default, so GeGLU here is ``F.gelu(approximate=
    "tanh")``, not torch's exact-erf default."""
    return F.silu(g) if activation == "silu" else F.gelu(g, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    return (activate(x @ p["w_gate"], activation) * (x @ p["w_up"])) \
        @ p["w_down"]


# --- conv/bn/pool for ResNet -------------------------------------------------

def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    return _randn(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)),
                  dtype, device)


def conv2d(w: torch.Tensor, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x: NHWC, w: HWIO."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def init_bn(cout: int, dtype: torch.dtype = torch.float32,
            device=None) -> Params:
    return {"scale": torch.ones(cout, dtype=dtype, device=device),
            "bias": torch.zeros(cout, dtype=dtype, device=device),
            "mean": torch.zeros(cout, dtype=torch.float32, device=device),
            "var": torch.ones(cout, dtype=torch.float32, device=device)}


def batchnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BN: normalise in f32 with the running stats, cast back,
    then apply scale and bias."""
    inv = torch.rsqrt(p["var"] + eps)
    return ((x.float() - p["mean"]) * inv).to(x.dtype) * p["scale"] \
        + p["bias"]


def maxpool2d(x: torch.Tensor, k: int, stride: int,
              padding: int) -> torch.Tensor:
    """Max over k×k windows of the input padded with −inf; NHWC in and out."""
    xp = F.pad(x, (0, 0, padding, padding, padding, padding),
               value=-math.inf)
    y = F.max_pool2d(xp.permute(0, 3, 1, 2), k, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def avgpool_global(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(1, 2))
