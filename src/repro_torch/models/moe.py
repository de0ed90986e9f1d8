"""Mixture-of-Experts FFN, as the JAX package's ``repro.models.moe``: top-k
router, capacity-based dispatch, optional shared experts (DeepSeekMoE) and
the Switch load-balance aux loss.

Dispatch uses the scatter/cumsum formulation (no sort): the (token, k)
assignments, flattened token-major and, within a token, in descending gate
order, get a 1-based position within their expert from a cumulative
one-hot count; assignments past ``capacity_for(T)`` are dropped.  That
order decides which assignments overflow, so it is JAX's exactly
(``torch.topk`` returns the K largest in descending order, as
``jax.lax.top_k`` does).

``moe_ffn`` runs four steps, each a function of its own: ``route`` (the
router, top-k, aux loss and slots), ``dispatch`` (tokens into their
slots), ``experts`` (the gated MLPs) and ``combine`` (back from the slots,
weighted by the gates).

The JAX version adds each assignment into an ``(E, C + 1, d)`` buffer whose
slot C collects the dropped ones.  Here each assignment is written, not
added: every kept (expert, slot) pair is written by exactly one assignment,
so the buffer does not depend on the order of the writes, and the dropped
ones all land in slot C, which is cut off.  No atomics, so two runs give
the same bits.  The expert products are batched matrix products and the
scatter and gather plain indexing: JAX computes them as einsums and
``.at[].add`` outside any Pallas kernel, so there is no kernel to port.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.dtensor import is_dtensor, replicated_call, settle
from repro_torch.models import layers as L
from repro_torch.models.layers import _randn

Params = dict[str, Any]


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype,
             device=None) -> Params:
    """The router is f32 whatever ``dtype`` is, as in JAX."""
    d = cfg.d_model
    E, ff = cfg.moe_num_experts, cfg.moe_d_ff
    p: Params = {
        "router": L.dense_init(gen, d, E, torch.float32, device),
        "w_gate": _randn(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
        "w_up": _randn(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
        "w_down": _randn(gen, (E, ff, d), 1 / math.sqrt(ff), dtype, device),
    }
    if cfg.moe_num_shared_experts:
        p["shared"] = L.init_mlp(gen, d, ff * cfg.moe_num_shared_experts,
                                 dtype, device)
    return p


def capacity_for(tokens: int, cfg) -> int:
    cap = int(math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts
                        * cfg.moe_capacity_factor))
    return max(cap, cfg.moe_top_k)


class Route(NamedTuple):
    """The routing of T tokens: ``probs`` (T, E) f32, ``gate_w`` (T, K)
    renormalised over the K chosen, ``sel`` (T, K) the chosen experts in
    descending order, ``slot`` (T·K,) each assignment's 0-based slot
    within its expert (C where dropped), ``keep`` (T·K,), the capacity
    ``C`` and the f32 load-balance ``aux`` loss."""
    probs: torch.Tensor
    gate_w: torch.Tensor
    sel: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    C: int
    aux: torch.Tensor


def route(p: Params, xt: torch.Tensor, cfg) -> Route:
    """Routes ``xt`` (T, d): softmax and top-k in f32."""
    T = xt.shape[0]
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = capacity_for(T, cfg)
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    gate_w, sel = torch.topk(probs, K, dim=-1, sorted=True)      # (T, K)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e
    f_e = F.one_hot(sel, E).sum(dim=1).float().mean(dim=0)
    aux = E * (f_e * probs.mean(dim=0)).sum() * cfg.moe_aux_loss_coef

    # (E, TK): the count runs along the inner axis, where a scan is one
    # pass; along the outer axis of (TK, E) it took half a 1x4096
    # deepseek-moe-16b prefill on an H100
    onehot = F.one_hot(sel.reshape(T * K), E).t().contiguous()
    pos = (onehot.cumsum(dim=1) * onehot).sum(dim=0)             # 1-based
    keep = pos <= C
    slot = torch.where(keep, pos - 1, C)
    return Route(probs, gate_w, sel, slot, keep, C, aux)


def dispatch(xt: torch.Tensor, r: Route) -> torch.Tensor:
    """Each kept assignment's token into its (expert, slot): (E, C, d) in
    ``xt.dtype``, zero where a slot is free."""
    T, d = xt.shape
    E, K = r.probs.shape[1], r.sel.shape[1]
    token = torch.arange(T * K, device=xt.device) // K
    buf = xt.new_zeros((E, r.C + 1, d))
    buf[r.sel.reshape(T * K), r.slot] = xt[token]
    return buf[:, :r.C]


def experts(p: Params, buf: torch.Tensor, activation: str) -> torch.Tensor:
    """Every expert's gated MLP over its slots: (E, C, d) → (E, C, d)."""
    h = L.activate(torch.bmm(buf, p["w_gate"]), activation) \
        * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def combine(out_buf: torch.Tensor, r: Route) -> torch.Tensor:
    """Each token's kept assignments back from their slots, weighted by
    their gates and summed: (E, C, d) → (T, d)."""
    T, K = r.sel.shape
    gathered = out_buf[r.sel.reshape(T * K), r.slot.clamp(max=r.C - 1)]
    # JAX multiplies by keep, then by the gate cast to x.dtype: a dropped
    # assignment's gate is 0 here instead, which gives the same values
    gates = torch.where(r.keep.view(T, K), r.gate_w, 0.0).to(out_buf.dtype)
    return (gathered.view(T, K, -1) * gates[..., None]).sum(dim=1)


def moe_ffn(p: Params, x: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out in ``x.dtype``, f32 aux loss).  A DTensor runs
    whole on every rank (``core.dtensor.replicated_call``) and the output
    goes back to x's placements."""
    if is_dtensor(x):
        y, aux = replicated_call(lambda p_, x_: moe_ffn(p_, x_, cfg), p, x,
                                 what="moe_ffn")
        return y.redistribute(placements=settle(x).placements), aux
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, xt, cfg)
    y = combine(experts(p, dispatch(xt, r), cfg.mlp_activation), r)
    if "shared" in p:
        y = y + L.mlp(p["shared"], xt, cfg.mlp_activation)
    return y.reshape(B, S, d), r.aux
