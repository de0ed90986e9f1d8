"""Model assembly: config → (init, forward, init_cache, decode_step), as in
the JAX package.  The port serves every family of the JAX registry: the CNN
(``models/resnet.py``), the decoder-only transformer (dense, MoE with an
optional dense first layer, and vlm with its stub prefix embeddings:
gemma2-2b, phi3-mini-3.8b, qwen3-32b, minicpm-2b, granite-moe-1b-a400m,
deepseek-moe-16b, paligemma-3b), the Mamba2 hybrid, zamba2, xLSTM (the
``ssm`` family with sLSTM blocks), xlstm-1.3b, and the encoder-decoder,
whisper-large-v3, whose ``Model`` also carries ``encode`` and
``fill_cross_cache``.  ``build_model`` dispatches as JAX's does: any
family that no earlier branch takes is built as a decoder-only LM.

Layer stacks are STACKED as in JAX: every leaf of the decoder's
``params["layers"]`` has a leading axis of ``num_layers`` less the dense
first layers (``params["dense0"]``, unstacked); the hybrid's
``params["mamba"]`` and xLSTM's ``params["mlstm"]`` leaves a leading
``(units, blocks per unit)`` pair of axes, and the hybrid's
``params["attn"]`` and xLSTM's ``params["slstm"]`` a leading ``units``
axis.  JAX scans over those axes; the port loops over them in Python,
handing each decoder layer its own sliding window
(``cfg.window_for_layer``).  ``forward`` is the prefill, whose every
self-attention runs through ``ops.flash_attention``, every Mamba2 scan
through ``ops.mamba_scan`` and every mLSTM recurrence through
``ops.mlstm_scan``, and the encoder-decoder's stacks (``params["enc"]``,
``params["dec"]``) run the encoder's and the cross-attention's
bidirectional attention through ``ops.flash_attention`` too;
``decode_step`` is the one-token serving path against a pre-allocated
KV/state cache, which it updates in place.

Every ``forward`` takes JAX's ``remat`` (each stacked layer, or each
hybrid or xLSTM unit, under ``torch.utils.checkpoint``, recomputed in the
backward) and ``return_hidden`` (the last hidden state instead of the
logits, for the trainer's chunked head and loss).  ``Model.bind(params)``
holds a parameter tree, such as a train state's, in the family's module
without copying it, so a forward reads exactly the tensors the optimizer
updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dtensor import embedding
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[..., Any]
    forward: Callable[..., tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Any]
    decode_step: Callable[..., Any]
    # the encoder-decoder's two extra entry points (None for other families)
    encode: Callable[..., torch.Tensor] | None = None
    fill_cross_cache: Callable[..., Any] | None = None
    # params tree → the family's module holding those very tensors (LMs)
    bind: Callable[[Params], nn.Module] | None = None


def _dt(cfg: ModelConfig) -> tuple[torch.dtype, torch.dtype]:
    return getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)


def _stack_init(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` trees from ``init_fn``, stacked leaf by leaf on a new axis 0.

    Each stacked leaf is allocated once, from the first tree's leaf, and
    every tree is copied into its slice as soon as it is drawn, so that at
    most one tree lives beside the stack (stacking a list of trees would
    hold all of them and the stack together)."""
    first = init_fn()

    def alloc(tree: Params) -> Params:
        return {k: alloc(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in tree.items()}

    def put(stack: Params, tree: Params, i: int) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                put(stack[k], v, i)
            else:
                stack[k][i].copy_(v)

    stack = alloc(first)
    put(stack, first, 0)
    del first
    for i in range(1, n):
        put(stack, init_fn(), i)
    return stack


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _layers(tree: Params, n: int) -> list[Params]:
    """The ``n`` layers of a stacked tree, as views from one ``unbind`` per
    leaf.  Under autograd each leaf's gradient is then one stack of the
    layers' gradients; indexing layer by layer would make every layer's
    gradient a zero-filled copy of the whole stacked leaf, summed n times
    (at minicpm-2b's 1 GB MLP leaves, most of a step)."""
    parts = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: part[i] for k, part in parts.items()} for i in range(n)]


def _sinusoid(seq: int, dim: int, dtype: torch.dtype,
              device=None) -> torch.Tensor:
    """(seq, dim) sinusoidal positions, sin in the even columns and cos in
    the odd ones, computed in f32 as JAX computes them (``div`` as
    ``exp(arange(0, dim, 2) * (-log(10000) / dim))``) and cast to
    ``dtype``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def param_count(params: Params) -> int:
    return sum(t.numel() for t in L.flatten_tree(params).values())


def _remat(remat: bool, fn: Callable, *args: Any) -> Any:
    """``fn(*args)``, under activation checkpointing when ``remat``: only
    the inputs are kept, and ``fn`` runs again in the backward (JAX's
    ``jax.checkpoint`` of a scan body).  The forwards draw no random
    numbers, so no RNG state is kept."""
    if not remat:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


# ---------------------------------------------------------------------------
# shared embed / head
# ---------------------------------------------------------------------------

def _init_embed(gen: torch.Generator, cfg: ModelConfig, pdt: torch.dtype,
                device=None) -> Params:
    p = {"embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, pdt,
                               device),
         "final_norm": L.init_rmsnorm(cfg.d_model, pdt, device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.vocab_size, pdt,
                                    device)
    return p


def _embed(params: Params, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its CUDA backward sums each row's
    # gradients in a fixed order (indexing's accumulates atomically), so a
    # replayed train step gives the same bits; a vocab-sharded DTensor
    # table takes the masked lookup (``core.dtensor.embedding``)
    x = embedding(tokens.long(), params["embed"])
    if cfg.scale_embed_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, tied (or separate) head, f32 logits, final softcap.  The
    softcap runs in place on the fresh logits when no gradient is wanted:
    at gemma2-2b's 256000-word vocabulary they are 1 GiB per thousand
    tokens.  Under autograd it runs out of place, as autograd needs."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        if torch.is_grad_enabled() and logits.requires_grad:
            logits = c * torch.tanh(logits / c)
        else:
            logits.div_(c).tanh_().mul_(c)
    return logits


# ---------------------------------------------------------------------------
# decoder-only transformer family (dense / moe / vlm)
# ---------------------------------------------------------------------------

def dense_layers(cfg: ModelConfig) -> int:
    """How many first layers are dense (``params["dense0"]``): JAX reads
    ``first_dense_layers`` only in a config with experts, and draws one
    ``dense0`` block for any nonzero count."""
    return cfg.first_dense_layers if cfg.moe_num_experts else 0


def init_decoder_params(gen: torch.Generator, cfg: ModelConfig,
                        device=None) -> Params:
    """The JAX package's decoder-only tree: ``embed``, ``final_norm``, the
    separate ``lm_head`` when untied, ``dense0`` (a gated-MLP block) when
    the config has dense first layers, and the stacked ``layers`` (MoE
    blocks when the config has experts).  Each tensor is drawn on the CPU
    and moved to ``device`` before the next is drawn; ``device="meta"``
    draws nothing."""
    _, pdt = _dt(cfg)
    n_dense = dense_layers(cfg)
    p = _init_embed(gen, cfg, pdt, device)
    if n_dense:
        p["dense0"] = B.init_attn_block(gen, cfg, pdt, device=device)
    p["layers"] = _stack_init(
        lambda: B.init_attn_block(gen, cfg, pdt,
                                  use_moe=cfg.moe_num_experts > 0,
                                  device=device),
        cfg.num_layers - n_dense)
    return p


class DecoderLM(nn.Module):
    """Holds a decoder-only LM's parameter tree (as buffers) with the JAX
    package's keys and stacked layout.

    ``params`` is such a tree, e.g. from ``repro_torch.weights.
    params_from_jax`` or a train state; its tensors are held as they are
    when they already lie on ``device``, so a trainer that sets
    ``requires_grad`` on them and updates them in place trains this
    module.  Without ``params`` the weights are drawn from ``seed``.
    ``device`` defaults to ``cuda`` and raises if no card is present; pass
    ``device="cpu"`` for the plain CPU path."""

    init_params = staticmethod(init_decoder_params)

    def __init__(self, cfg: ModelConfig, *, params: Params | None = None,
                 seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if params is None:
            params = self.init_params(torch.Generator().manual_seed(seed),
                                      cfg, device)
        self.params = L.tree_to(params, device)
        for name, t in L.flatten_tree(self.params).items():
            self.register_buffer(name, t)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) → f32 logits (B, S, vocab)."""
        return decoder_forward(self, {"tokens": tokens})[0]


def decoder_forward(model: DecoderLM, batch: dict[str, torch.Tensor], *,
                    remat: bool = False, return_hidden: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): ``batch["tokens"]`` (B, S) →
    (f32 logits (B, S, vocab), aux: the sum of the MoE layers' load-balance
    losses, 0 without experts).

    With ``cfg.num_prefix_tokens`` and ``batch["prefix_embed"]`` (B, P, d),
    the prefix goes in front of the token embeddings, positions run over
    all P + S, the causal mask lets the tokens see it, and its P rows are
    cut from the output.  ``dense0`` runs first, with no window; the
    stacked layers take the windows of layers ``n_dense`` on, each under
    ``remat`` as in JAX's scan (``dense0`` is not).  ``return_hidden``
    returns the last hidden state (B, S, d) in place of the logits."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    n_dense = dense_layers(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    n_prefix = 0
    if cfg.num_prefix_tokens and "prefix_embed" in batch:
        pfx = batch["prefix_embed"].to(device=x.device, dtype=dt)
        n_prefix = pfx.shape[1]
        x = torch.cat([pfx, x], dim=1)
    Btch, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(Btch, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if n_dense:
        x, a = B.attn_block(params["dense0"], x, cfg, positions=positions,
                            window=0)
        aux = aux + a
    stacked = _layers(params["layers"], cfg.num_layers - n_dense)
    for i, lp in enumerate(stacked):
        def layer(h, lp=lp, i=i):
            return B.attn_block(lp, h, cfg, positions=positions,
                                window=cfg.window_for_layer(n_dense + i))
        x, a = _remat(remat, layer, x)
        aux = aux + a
    if n_prefix:
        x = x[:, n_prefix:]
    if return_hidden:
        return x, aux
    return _head(params, cfg, x), aux


def decoder_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                       device) -> Params:
    """``layers``: the KV cache stacked over the stacked layers, and
    ``dense0``'s own; ``max_len + num_prefix_tokens`` rows each, as in
    JAX."""
    dt, _ = _dt(cfg)
    n_dense = dense_layers(cfg)
    total = max_len + cfg.num_prefix_tokens
    c = B.init_attn_cache(cfg, batch_size, total, dt, device)
    n = cfg.num_layers - n_dense
    cache = {"layers": {k: v[None].repeat(n, *[1] * v.dim())
                        for k, v in c.items()}}
    if n_dense:
        cache["dense0"] = B.init_attn_cache(cfg, batch_size, total, dt,
                                            device)
    return cache


def decoder_decode_step(model: DecoderLM, cache: Params,
                        tokens: torch.Tensor, index: int
                        ) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) at position ``index`` → (f32 logits (B, 1, vocab),
    cache).  The cache is updated in place and returned."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    n_dense = dense_layers(cfg)
    index = int(index)
    x = _embed(params, cfg, tokens.to(params["embed"].device)).to(dt)
    if n_dense:
        x, _, _ = B.attn_block_decode(params["dense0"], cache["dense0"], x,
                                      cfg, index=index)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers - n_dense):
        x, _, _ = B.attn_block_decode(
            _layer(params["layers"], i), {"k": ks[i], "v": vs[i]}, x, cfg,
            index=index, window=cfg.window_for_layer(n_dense + i))
    return _head(params, cfg, x), cache


def _win_mask(S: int, window: int) -> torch.Tensor:
    """(1, S, S): keys within ``window`` of each query (all when 0); the
    JAX decoder ANDs it with ``causal_mask``.  The port's forward passes the
    window to the kernel instead; the parity tests build the JAX mask."""
    qpos = torch.arange(S)[:, None]
    kpos = torch.arange(S)[None, :]
    if window > 0:
        return (kpos > qpos - window)[None]
    return torch.ones((1, S, S), dtype=torch.bool)


# ---------------------------------------------------------------------------
# hybrid (zamba2): units of (E-1) mamba + 1 attn
# ---------------------------------------------------------------------------

def hybrid_units(cfg: ModelConfig) -> tuple[int, int]:
    """(U, K): U units of K Mamba2 blocks and one attention block."""
    E = cfg.hybrid_attn_every
    if not E or cfg.num_layers % E:
        raise ValueError(f"hybrid layers must tile into units: "
                         f"{cfg.num_layers} layers, attention every {E}")
    return cfg.num_layers // E, E - 1


def init_hybrid_params(gen: torch.Generator, cfg: ModelConfig,
                       device=None) -> Params:
    """The JAX package's hybrid tree: ``embed``, ``final_norm``, ``mamba``
    with leaves stacked ``(U, K, ...)`` and ``attn`` stacked ``(U, ...)``.
    Each tensor is drawn on the CPU and moved to ``device`` before the next
    is drawn; ``device="meta"`` draws nothing."""
    _, pdt = _dt(cfg)
    U, K = hybrid_units(cfg)
    p = _init_embed(gen, cfg, pdt, device)
    p["mamba"] = _stack_init(lambda: _stack_init(
        lambda: B.init_mamba_block(gen, cfg, pdt, device=device), K), U)
    p["attn"] = _stack_init(
        lambda: B.init_attn_block(gen, cfg, pdt, device=device), U)
    return p


class HybridLM(DecoderLM):
    """Holds a Mamba2 hybrid's parameter tree (zamba2), as ``DecoderLM``
    holds a decoder's: buffers with the JAX package's keys and stacked
    layout, drawn from ``seed`` unless ``params`` is given."""

    init_params = staticmethod(init_hybrid_params)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) → f32 logits (B, S, vocab)."""
        return hybrid_forward(self, {"tokens": tokens})[0]


def hybrid_forward(model: HybridLM, batch: dict[str, torch.Tensor], *,
                   remat: bool = False, return_hidden: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): each unit's K Mamba2 blocks (one
    ``ops.mamba_scan`` each), then its causal global attention block (one
    ``ops.flash_attention``), each unit under ``remat``.
    ``batch["tokens"]`` (B, S) → (f32 logits (B, S, vocab), or the hidden
    state with ``return_hidden``; aux = 0).  Differentiable: on the card
    each scan's gradient is its backward kernel's."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = hybrid_units(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    Btch, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(Btch, S)
    for mp, ap in zip(_layers(params["mamba"], U), _layers(params["attn"], U)):
        def unit(h, mp=mp, ap=ap):
            for bp in _layers(mp, K):
                h = B.mamba_block(bp, h, cfg)
            return B.attn_block(ap, h, cfg, positions=positions, window=0)[0]
        x = _remat(remat, unit, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _head(params, cfg, x), aux


def hybrid_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                      device) -> Params:
    """``mamba``: the SSM and conv states stacked ``(U, K, ...)``;
    ``attn``: the KV cache stacked ``(U, ...)``."""
    dt, _ = _dt(cfg)
    U, K = hybrid_units(cfg)
    m = SSM.mamba2_init_cache(cfg, batch_size, dt, device)
    a = B.init_attn_cache(cfg, batch_size, max_len, dt, device)
    return {"mamba": {k: v[None, None].repeat(U, K, *[1] * v.dim())
                      for k, v in m.items()},
            "attn": {k: v[None].repeat(U, *[1] * v.dim())
                     for k, v in a.items()}}


def hybrid_decode_step(model: HybridLM, cache: Params, tokens: torch.Tensor,
                       index: int) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) at position ``index`` → (f32 logits (B, 1, vocab),
    cache).  The cache is updated in place and returned."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = hybrid_units(cfg)
    index = int(index)
    x = _embed(params, cfg, tokens.to(params["embed"].device)).to(dt)
    mc, ac = cache["mamba"], cache["attn"]
    for u in range(U):
        mp = _layer(params["mamba"], u)
        for k in range(K):
            x, _ = B.mamba_block_decode(
                _layer(mp, k), {"ssm": mc["ssm"][u, k],
                                "conv": mc["conv"][u, k]}, x, cfg)
        x, _, _ = B.attn_block_decode(
            _layer(params["attn"], u), {"k": ac["k"][u], "v": ac["v"][u]},
            x, cfg, index=index)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# xLSTM: units of (E-1) mLSTM + 1 sLSTM
# ---------------------------------------------------------------------------

def xlstm_units(cfg: ModelConfig) -> tuple[int, int]:
    """(U, K): U units of K mLSTM blocks and one sLSTM block."""
    E = cfg.xlstm_slstm_every
    if not E or cfg.num_layers % E:
        raise ValueError(f"xLSTM layers must tile into units: "
                         f"{cfg.num_layers} layers, sLSTM every {E}")
    return cfg.num_layers // E, E - 1


def init_xlstm_params(gen: torch.Generator, cfg: ModelConfig,
                      device=None) -> Params:
    """The JAX package's xLSTM tree: ``embed``, ``final_norm``, ``mlstm``
    with leaves stacked ``(U, K, ...)`` and ``slstm`` stacked ``(U, ...)``.
    Each tensor is drawn on the CPU and moved to ``device`` before the next
    is drawn; ``device="meta"`` draws nothing."""
    _, pdt = _dt(cfg)
    U, K = xlstm_units(cfg)
    p = _init_embed(gen, cfg, pdt, device)
    p["mlstm"] = _stack_init(lambda: _stack_init(
        lambda: B.init_mlstm_block(gen, cfg, pdt, device=device), K), U)
    p["slstm"] = _stack_init(
        lambda: B.init_slstm_block(gen, cfg, pdt, device=device), U)
    return p


class XLSTMLM(DecoderLM):
    """Holds an xLSTM LM's parameter tree (xlstm-1.3b), as ``DecoderLM``
    holds a decoder's: buffers with the JAX package's keys and stacked
    layout, drawn from ``seed`` unless ``params`` is given."""

    init_params = staticmethod(init_xlstm_params)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) → f32 logits (B, S, vocab)."""
        return xlstm_forward(self, {"tokens": tokens})[0]


def xlstm_forward(model: XLSTMLM, batch: dict[str, torch.Tensor], *,
                  remat: bool = False, return_hidden: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): each unit's K mLSTM blocks (one
    ``ops.mlstm_scan`` each), then its sLSTM block (a plain loop over
    time), each unit under ``remat``.  ``batch["tokens"]`` (B, S) → (f32
    logits (B, S, vocab), or the hidden state with ``return_hidden``;
    aux = 0).  Differentiable: on the card each mLSTM scan's gradient is
    its backward kernel's, the sLSTM loop's autograd's."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = xlstm_units(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    for mp, sp in zip(_layers(params["mlstm"], U),
                      _layers(params["slstm"], U)):
        def unit(h, mp=mp, sp=sp):
            for bp in _layers(mp, K):
                h = B.mlstm_block(bp, h, cfg)
            return B.slstm_block(sp, h, cfg)
        x = _remat(remat, unit, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _head(params, cfg, x), aux


def xlstm_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                     device) -> Params:
    """``mlstm``: C, n and m stacked ``(U, K, ...)``; ``slstm``: c, n, m
    and h stacked ``(U, ...)``.  The state has a fixed size: ``max_len`` is
    not read."""
    U, K = xlstm_units(cfg)
    m = XL.mlstm_init_cache(cfg, batch_size, device)
    s = XL.slstm_init_cache(cfg, batch_size, device)
    return {"mlstm": {k: v[None, None].repeat(U, K, *[1] * v.dim())
                      for k, v in m.items()},
            "slstm": {k: v[None].repeat(U, *[1] * v.dim())
                      for k, v in s.items()}}


def xlstm_decode_step(model: XLSTMLM, cache: Params, tokens: torch.Tensor,
                      index: int) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) → (f32 logits (B, 1, vocab), cache).  The cache is
    updated in place and returned; ``index`` is not read, since the state
    carries the position."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = xlstm_units(cfg)
    x = _embed(params, cfg, tokens.to(params["embed"].device)).to(dt)
    mc, sc = cache["mlstm"], cache["slstm"]
    for u in range(U):
        mp = _layer(params["mlstm"], u)
        for k in range(K):
            x, _ = B.mlstm_block_decode(
                _layer(mp, k), {n: mc[n][u, k] for n in ("C", "n", "m")},
                x, cfg)
        x, _ = B.slstm_block_decode(
            _layer(params["slstm"], u),
            {n: sc[n][u] for n in ("c", "n", "m", "h")}, x, cfg)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# encoder-decoder (whisper backbone; conv frontend stubbed)
# ---------------------------------------------------------------------------

def init_encdec_params(gen: torch.Generator, cfg: ModelConfig,
                       device=None) -> Params:
    """The JAX package's encoder-decoder tree: ``embed``, ``final_norm``,
    ``enc`` (attention blocks stacked over ``encoder_layers``),
    ``enc_norm`` and ``dec`` (blocks with cross-attention, stacked over
    ``num_layers``).  Each tensor is drawn on the CPU and moved to
    ``device`` before the next is drawn; ``device="meta"`` draws
    nothing."""
    _, pdt = _dt(cfg)
    p = _init_embed(gen, cfg, pdt, device)
    p["enc"] = _stack_init(
        lambda: B.init_attn_block(gen, cfg, pdt, device=device),
        cfg.encoder_layers)
    p["enc_norm"] = L.init_rmsnorm(cfg.d_model, pdt, device)
    p["dec"] = _stack_init(
        lambda: B.init_attn_block(gen, cfg, pdt, cross=True, device=device),
        cfg.num_layers)
    return p


class EncDecLM(DecoderLM):
    """Holds an encoder-decoder's parameter tree (whisper-large-v3), as
    ``DecoderLM`` holds a decoder's: buffers with the JAX package's keys
    and stacked layout, drawn from ``seed`` unless ``params`` is given."""

    init_params = staticmethod(init_encdec_params)

    def forward(self, tokens: torch.Tensor,
                frames: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S), frames: (B, F, d) → f32 logits (B, S, vocab)."""
        return encdec_forward(self, {"tokens": tokens,
                                     "enc_frames": frames})[0]


def encdec_encode(model: EncDecLM, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) precomputed frame embeddings (the conv frontend
    is a stub, as in JAX) → the encoder's output (B, F, d).  The frames are
    cast to the activation dtype and then added to the sinusoid in that
    dtype, in JAX's order; every encoder layer attends bidirectionally
    (one non-causal ``ops.flash_attention`` each), then ``enc_norm``."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    dev = params["embed"].device
    x = frames.to(device=dev, dtype=dt)
    Btch, F, _ = x.shape
    x = x + _sinusoid(F, cfg.d_model, dt, dev)[None]
    positions = torch.arange(F, device=dev).expand(Btch, F)
    for lp in _layers(params["enc"], cfg.encoder_layers):
        x, _ = B.attn_block(lp, x, cfg, positions=positions, window=0,
                            causal=False)
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def encdec_forward(model: EncDecLM, batch: dict[str, torch.Tensor], *,
                   remat: bool = False, return_hidden: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward: ``batch["enc_frames"]`` (B, F, d) through
    the encoder, then ``batch["tokens"]`` (B, S) with sinusoidal positions
    through the decoder, each layer's causal self-attention and its
    cross-attention to all F encoder rows one flash launch each →
    (f32 logits (B, S, vocab), or the decoder's hidden state with
    ``return_hidden``; aux = 0).  ``remat`` checkpoints each decoder layer,
    as JAX's does (not the encoder's)."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    enc_out = encdec_encode(model, batch["enc_frames"])
    tokens = batch["tokens"].to(params["embed"].device)
    Btch, S = tokens.shape
    x = _embed(params, cfg, tokens).to(dt)
    x = x + _sinusoid(S, cfg.d_model, dt, x.device)[None]
    positions = torch.arange(S, device=x.device).expand(Btch, S)
    for lp in _layers(params["dec"], cfg.num_layers):
        def layer(h, lp=lp):
            return B.attn_block(lp, h, cfg, positions=positions, window=0,
                                enc_out=enc_out)[0]
        x = _remat(remat, layer, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return _head(params, cfg, x), aux


def encdec_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                      device) -> Params:
    """``dec``: the self-attention's ``k``, ``v`` (``max_len`` rows) and the
    cross-attention's ``xk``, ``xv`` (``encoder_seq_len`` rows, zeros until
    ``fill_cross_cache``), stacked over the decoder layers."""
    dt, _ = _dt(cfg)
    c = B.init_attn_cache(cfg, batch_size, max_len, dt, device,
                          cross_len=cfg.encoder_seq_len)
    return {"dec": {k: v[None].repeat(cfg.num_layers, *[1] * v.dim())
                    for k, v in c.items()}}


def encdec_fill_cross_cache(model: EncDecLM, cache: Params,
                            frames: torch.Tensor) -> Params:
    """Encodes ``frames`` (B, F, d) and puts each decoder layer's cross
    keys and values (``enc_out @ wk``, ``enc_out @ wv``, no norm, as in
    JAX) in ``cache["dec"]["xk"]``, ``["xv"]``, replacing what was there,
    as JAX does: F need not be ``encoder_seq_len``.  Returns the cache."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    enc_out = encdec_encode(model, frames)
    Btch, F, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    xk = enc_out.new_empty((cfg.num_layers, Btch, F, kv, hd), dtype=dt)
    xv = torch.empty_like(xk)
    for i in range(cfg.num_layers):
        xa = _layer(params["dec"], i)["xattn"]
        xk[i] = (enc_out @ xa["wk"]).reshape(Btch, F, kv, hd)
        xv[i] = (enc_out @ xa["wv"]).reshape(Btch, F, kv, hd)
    cache["dec"]["xk"], cache["dec"]["xv"] = xk, xv
    return cache


def encdec_decode_step(model: EncDecLM, cache: Params, tokens: torch.Tensor,
                       index: int) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) at position ``index`` → (f32 logits (B, 1, vocab),
    cache).  The position embedding is row ``index`` of the sinusoid over
    the cache's length; each layer attends to its cached keys and to the
    cross cache, through the plain ``attention_scores`` (no kernel
    launches).  The cache is updated in place and returned."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    index = int(index)
    dec = cache["dec"]
    x = _embed(params, cfg, tokens.to(params["embed"].device)).to(dt)
    x = x + _sinusoid(dec["k"].shape[2], cfg.d_model, dt, x.device)[index]
    for i in range(cfg.num_layers):
        x, _, _ = B.attn_block_decode(
            _layer(params["dec"], i), {n: dec[n][i] for n in
                                       ("k", "v", "xk", "xv")},
            x, cfg, index=index)
    return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig, device, lm_cls: type[DecoderLM],
              forward: Callable, init_cache: Callable,
              decode_step: Callable, **extra: Callable) -> Model:
    """The ``Model`` of an LM family: ``init(seed)`` draws an ``lm_cls``,
    ``bind(params)`` holds a given tree in one, ``init_cache(batch_size,
    max_len)`` allocates on the model's device; ``extra`` sets the
    encoder-decoder's ``encode`` and ``fill_cross_cache``."""
    device = resolve_device(device)

    def init(seed: int = 0) -> DecoderLM:
        return lm_cls(cfg, seed=seed, device=device)

    def bind(params: Params) -> DecoderLM:
        return lm_cls(cfg, params=params, device=device)

    def cache(batch_size: int, max_len: int) -> Params:
        return init_cache(cfg, batch_size, max_len, device)

    return Model(cfg, device, init, forward, cache, decode_step, **extra,
                 bind=bind)


def lm_family(cfg: ModelConfig) -> tuple[type[DecoderLM], Callable,
                                         Callable, Callable,
                                         dict[str, Callable]]:
    """The LM family JAX's ``build_model`` picks for a non-CNN ``cfg``, in
    its order: the encoder-decoder, the hybrid, the ``ssm`` family with
    sLSTM blocks (xLSTM), and any other config as a decoder-only LM.
    Returns (module class, forward, init_cache, decode_step, the
    encoder-decoder's extra entry points)."""
    if cfg.is_encoder_decoder:
        return EncDecLM, encdec_forward, encdec_init_cache, \
            encdec_decode_step, {"encode": encdec_encode,
                                 "fill_cross_cache": encdec_fill_cross_cache}
    if cfg.family == "hybrid":
        hybrid_units(cfg)
        return HybridLM, hybrid_forward, hybrid_init_cache, \
            hybrid_decode_step, {}
    if cfg.family == "ssm" and cfg.xlstm_slstm_every:
        xlstm_units(cfg)
        return XLSTMLM, xlstm_forward, xlstm_init_cache, xlstm_decode_step, {}
    return DecoderLM, decoder_forward, decoder_init_cache, \
        decoder_decode_step, {}


def build_model(cfg: ModelConfig, device=None) -> Model:
    """Dispatches as JAX's ``build_model`` does: the CNN, else the LM of
    ``lm_family``.  ``device`` defaults to ``cuda`` and raises if no card
    is present; ``device="cpu"`` runs the plain PyTorch path."""
    if cfg.family == "cnn":
        from repro_torch.models.resnet import build_resnet_model
        return build_resnet_model(cfg, device)
    lm_cls, forward, init_cache, decode_step, extra = lm_family(cfg)
    return _build_lm(cfg, device, lm_cls, forward, init_cache, decode_step,
                     **extra)
