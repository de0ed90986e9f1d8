"""Model assembly: config → (init, forward, init_cache, decode_step), as in
the JAX package.  The port serves the CNN family (``models/resnet.py``),
the decoder-only transformer (dense, and vlm without prefix tokens), e.g.
gemma2-2b, the Mamba2 hybrid, zamba2, and xLSTM (the ``ssm`` family with
sLSTM blocks), xlstm-1.3b; the other families come with later slices of
the port.

Layer stacks are STACKED as in JAX: every leaf of the decoder's
``params["layers"]`` has a leading ``num_layers`` axis; the hybrid's
``params["mamba"]`` and xLSTM's ``params["mlstm"]`` leaves a leading
``(units, blocks per unit)`` pair of axes, and the hybrid's
``params["attn"]`` and xLSTM's ``params["slstm"]`` a leading ``units``
axis.  JAX scans over those axes; the port loops over them in Python,
handing each decoder layer its own sliding window
(``cfg.window_for_layer``).  ``forward`` is the prefill, whose every
self-attention runs through ``ops.flash_attention``, every Mamba2 scan
through ``ops.mamba_scan`` and every mLSTM recurrence through
``ops.mlstm_scan``; ``decode_step`` is the one-token serving path against
a pre-allocated KV/state cache, which it updates in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
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


def _dt(cfg: ModelConfig) -> tuple[torch.dtype, torch.dtype]:
    return getattr(torch, cfg.dtype), getattr(torch, cfg.param_dtype)


def _stack_init(init_fn: Callable[[], Params], n: int) -> Params:
    """``n`` trees from ``init_fn``, stacked leaf by leaf on a new axis 0."""
    layers = [init_fn() for _ in range(n)]

    def stack(trees: list[Params]) -> Params:
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees])
                for k, v in trees[0].items()}
    return stack(layers)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def param_count(params: Params) -> int:
    return sum(t.numel() for t in L.flatten_tree(params).values())


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
    x = params["embed"][tokens.long()]
    if cfg.scale_embed_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm, tied (or separate) head, f32 logits, final softcap.  The
    softcap runs in place on the fresh logits: at gemma2-2b's 256000-word
    vocabulary they are 1 GiB per thousand tokens."""
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["lm_head"]
    logits = logits.float()
    if cfg.final_softcap:
        c = cfg.final_softcap
        logits.div_(c).tanh_().mul_(c)
    return logits


# ---------------------------------------------------------------------------
# decoder-only transformer family (dense / vlm)
# ---------------------------------------------------------------------------

def init_decoder_params(gen: torch.Generator, cfg: ModelConfig,
                        device=None) -> Params:
    """The JAX package's decoder-only tree: ``embed``, ``final_norm`` and
    the stacked ``layers``.  Each tensor is drawn on the CPU and moved to
    ``device`` before the next is drawn; ``device="meta"`` draws nothing."""
    _, pdt = _dt(cfg)
    p = _init_embed(gen, cfg, pdt, device)
    p["layers"] = _stack_init(
        lambda: B.init_attn_block(gen, cfg, pdt, device=device),
        cfg.num_layers)
    return p


class DecoderLM(nn.Module):
    """Holds a decoder-only LM's parameter tree (as buffers: this is an
    inference model) with the JAX package's keys and stacked layout.

    ``params`` is such a tree, e.g. from ``repro_torch.weights.
    params_from_jax``; without it the weights are drawn from ``seed``.
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


def decoder_forward(model: DecoderLM, batch: dict[str, torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): ``batch["tokens"]`` (B, S) →
    (f32 logits (B, S, vocab), aux)."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    Btch, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(Btch, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, a = B.attn_block(_layer(params["layers"], i), x, cfg,
                            positions=positions,
                            window=cfg.window_for_layer(i))
        aux = aux + a
    return _head(params, cfg, x), aux


def decoder_init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
                       device) -> Params:
    dt, _ = _dt(cfg)
    c = B.init_attn_cache(cfg, batch_size, max_len, dt, device)
    n = cfg.num_layers
    return {"layers": {k: v[None].repeat(n, *[1] * v.dim())
                       for k, v in c.items()}}


def decoder_decode_step(model: DecoderLM, cache: Params,
                        tokens: torch.Tensor, index: int
                        ) -> tuple[torch.Tensor, Params]:
    """tokens: (B, 1) at position ``index`` → (f32 logits (B, 1, vocab),
    cache).  The cache is updated in place and returned."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    index = int(index)
    x = _embed(params, cfg, tokens.to(params["embed"].device)).to(dt)
    ks, vs = cache["layers"]["k"], cache["layers"]["v"]
    for i in range(cfg.num_layers):
        x, _, _ = B.attn_block_decode(
            _layer(params["layers"], i), {"k": ks[i], "v": vs[i]}, x, cfg,
            index=index, window=cfg.window_for_layer(i))
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


def hybrid_forward(model: HybridLM, batch: dict[str, torch.Tensor]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): each unit's K Mamba2 blocks (one
    ``ops.mamba_scan`` each), then its causal global attention block (one
    ``ops.flash_attention``).  ``batch["tokens"]`` (B, S) → (f32 logits
    (B, S, vocab), aux = 0)."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = hybrid_units(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    Btch, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(Btch, S)
    for u in range(U):
        mp = _layer(params["mamba"], u)
        for k in range(K):
            x = B.mamba_block(_layer(mp, k), x, cfg)
        x, _ = B.attn_block(_layer(params["attn"], u), x, cfg,
                            positions=positions, window=0)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def xlstm_forward(model: XLSTMLM, batch: dict[str, torch.Tensor]
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The full-sequence forward (prefill): each unit's K mLSTM blocks (one
    ``ops.mlstm_scan`` each), then its sLSTM block (a plain loop over
    time).  ``batch["tokens"]`` (B, S) → (f32 logits (B, S, vocab),
    aux = 0)."""
    cfg, params = model.cfg, model.params
    dt, _ = _dt(cfg)
    U, K = xlstm_units(cfg)
    tokens = batch["tokens"].to(params["embed"].device)
    x = _embed(params, cfg, tokens).to(dt)
    for u in range(U):
        mp = _layer(params["mlstm"], u)
        for k in range(K):
            x = B.mlstm_block(_layer(mp, k), x, cfg)
        x = B.slstm_block(_layer(params["slstm"], u), x, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
# entry point
# ---------------------------------------------------------------------------

def _build_lm(cfg: ModelConfig, device, lm_cls: type[DecoderLM],
              forward: Callable, init_cache: Callable,
              decode_step: Callable) -> Model:
    """The ``Model`` of an LM family: ``init(seed)`` draws an ``lm_cls``,
    ``init_cache(batch_size, max_len)`` allocates on the model's device."""
    device = resolve_device(device)

    def init(seed: int = 0) -> DecoderLM:
        return lm_cls(cfg, seed=seed, device=device)

    def cache(batch_size: int, max_len: int) -> Params:
        return init_cache(cfg, batch_size, max_len, device)

    return Model(cfg, device, init, forward, cache, decode_step)


def build_model(cfg: ModelConfig, device=None) -> Model:
    """``device`` defaults to ``cuda`` and raises if no card is present;
    ``device="cpu"`` runs the plain PyTorch path."""
    if cfg.family == "cnn":
        from repro_torch.models.resnet import build_resnet_model
        return build_resnet_model(cfg, device)
    if cfg.family in ("dense", "vlm") and not cfg.moe_num_experts:
        return _build_lm(cfg, device, DecoderLM, decoder_forward,
                         decoder_init_cache, decoder_decode_step)
    if cfg.family == "hybrid":
        hybrid_units(cfg)
        return _build_lm(cfg, device, HybridLM, hybrid_forward,
                         hybrid_init_cache, hybrid_decode_step)
    if cfg.family == "ssm" and cfg.xlstm_slstm_every:
        xlstm_units(cfg)
        return _build_lm(cfg, device, XLSTMLM, xlstm_forward,
                         xlstm_init_cache, xlstm_decode_step)
    if cfg.family == "ssm":
        raise NotImplementedError(
            "family 'ssm' without xlstm_slstm_every is not ported: the port "
            "builds the ssm family as xLSTM only (ROADMAP queue 1 item 11), "
            "which needs xlstm_slstm_every > 0 (an sLSTM block every that "
            "many layers)")
    item = {"moe": "item 9 (models/moe.py)",
            "dense": "item 9 (models/moe.py)",
            "audio": "item 9 (_build_encdec)"}
    raise NotImplementedError(
        f"family {cfg.family!r} with {cfg.moe_num_experts} experts is not "
        f"ported yet: ROADMAP queue 1 {item.get(cfg.family, 'item 9')}")
