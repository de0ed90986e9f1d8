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

A DTensor ``x`` takes the expert-parallel route, on local shards, with
JAX's global semantics (the capacity from the global token count, slots
in the global token order, the aux loss over all tokens), so it drops
exactly what one process drops:

* Placements.  The mesh dims that shard the experts (``Shard(0)`` of the
  expert weights; ``model`` in every policy) are the expert dims: there
  the tokens are gathered (``fused_seq``'s sequence shards; under
  ``layerwise_tp`` they are replicated already), and each rank computes
  only its experts, so the output is a partial sum that goes back to
  ``x``'s placements (an all-gather, then a reduce-scatter: at
  deepseek-moe-16b's 16×16 shapes this moves less than an all-to-all of
  the kept assignments in static buffers).  On the other mesh dims a
  batch or sequence shard of ``x`` stays, each rank routing its own
  tokens; the weights are gathered there (``fused_seq_zero3``'s data
  shards), and the router everywhere.
* Slots.  Each rank counts its assignments per (row, expert); the counts
  of every rank are gathered (a few KB), and an assignment's global
  position is the count of the rows, and of the sequence shards of its
  row, before its own, plus its position in its row.  Its slot in the
  rank's buffer is its position among the rank's assignments: those come
  in the global order, so it stays below ``min(C, tokens of the rank)``,
  a static bound (top-k picks distinct experts), and the dry run on meta
  shards counts the experts' FLOPs.
* The aux loss.  f_e and p̄_e are sums over all tokens, partial where
  the tokens are sharded, and on the expert dims each rank sums every
  n-th token, so that the sums are partial there too and the gradient
  reaches each token once; reduced once, then divided by the global
  token count.
* Gradients flow through the gathers and reductions by DTensor's rules;
  the local gradients of the tokens and the router are partial on the
  expert dims, those of the weights on the token dims.

On one rank (a 1×1 mesh) with C at most the token count, every buffer
has the plain path's shape and content.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.dtensor import (contiguous_grad, is_dtensor,
                                      note_computed_replicated, note_route,
                                      redistributed, settle, shard_index)
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


def _choose(p: Params, xt: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router's softmax in f32 and its top-k over ``xt`` (T, d):
    (probs (T, E), gate_w (T, K) renormalised, sel (T, K))."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)      # (T, E)
    gate_w, sel = torch.topk(probs, cfg.moe_top_k, dim=-1, sorted=True)
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), sel


def _aux(f_e: torch.Tensor, p_e: torch.Tensor, cfg) -> torch.Tensor:
    """The Switch load-balance loss E · Σ_e f_e · p̄_e, scaled."""
    E = cfg.moe_num_experts
    return E * (f_e * p_e).sum() * cfg.moe_aux_loss_coef


def route(p: Params, xt: torch.Tensor, cfg) -> Route:
    """Routes ``xt`` (T, d): softmax and top-k in f32."""
    T = xt.shape[0]
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    C = capacity_for(T, cfg)
    probs, gate_w, sel = _choose(p, xt, cfg)
    f_e = F.one_hot(sel, E).sum(dim=1).float().mean(dim=0)
    aux = _aux(f_e, probs.mean(dim=0), cfg)

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


def _expert_parallel(p: Params, x: torch.Tensor, cfg
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` of a DTensor ``x`` on local shards (see the module's
    docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    note_route("moe_ffn")
    x = settle(x)
    mesh = x.device_mesh
    B, S, d = x.shape
    E, K = cfg.moe_num_experts, cfg.moe_top_k
    rep, part = Replicate(), Partial()
    w_in = p["w_gate"].placements
    expert = [q.is_shard(0) for q in w_in]
    token = [not expert[i] and (q.is_shard(0) or q.is_shard(1))
             for i, q in enumerate(x.placements)]
    xg = redistributed(x, [q if token[i] else rep
                           for i, q in enumerate(x.placements)])
    w_pl = [Shard(0) if e else rep for e in expert]
    note_computed_replicated("moe_ffn", mesh, [x.placements, w_in],
                             [xg.placements, w_pl])

    def local(t, placements, grad):
        return contiguous_grad(redistributed(t, placements).to_local(
            grad_placements=grad))
    xl = local(xg, xg.placements, [q if token[i] else (
        part if expert[i] else rep) for i, q in enumerate(xg.placements)])
    ws = {k: local(p[k], w_pl, [part if token[i] else q
                                for i, q in enumerate(w_pl)])
          for k in ("w_gate", "w_up", "w_down")}
    sums = [part if token[i] or expert[i] else rep
            for i in range(mesh.ndim)]
    router = local(p["router"], [rep] * mesh.ndim, sums)

    b, s, _ = xl.shape
    T = b * s
    row, rows = shard_index(mesh, xg.placements, 0)
    seq, seqs = shard_index(mesh, xg.placements, 1)
    if B % rows or S % seqs:
        raise ValueError(f"moe_ffn: ({B}, {S}) tokens do not split evenly "
                         f"into {rows} x {seqs} shards")
    shard, shards = shard_index(mesh, w_pl, 0)
    El = ws["w_gate"].shape[0]
    e0 = shard * El
    C = capacity_for(B * S, cfg)
    Cl = min(C, T)
    xt = xl.reshape(T, d)
    probs, gate_w, sel = _choose({"router": router}, xt, cfg)

    # each assignment's 1-based position among its row's, in the order of
    # route(): sequence, then descending gate
    sk = sel.reshape(b, s * K)
    onehot = F.one_hot(sk, E).transpose(1, 2).contiguous()     # (b, E, sK)
    count = onehot.cumsum(dim=2)
    in_row = (count * onehot).sum(dim=1)                       # (b, sK)
    per_row = count[:, :, -1]                                   # (b, E)
    # every rank's per-row counts, in the global order (row, sequence
    # shard): the assignments before this block's rows, exclusive
    every = DTensor.from_local(per_row[:, None], mesh, xg.placements,
                               run_check=False).full_tensor()
    every = every.reshape(B * seqs, E)
    earlier = (every.cumsum(dim=0) - every).view(B, seqs, E)[
        row * b:(row + 1) * b, seq]                             # (b, E)
    keep = in_row + earlier.gather(1, sk) <= C
    # the slot: the position among this block's assignments, which come
    # in the global order, so it is below min(C, T)
    in_block = in_row + (per_row.cumsum(dim=0) - per_row).gather(1, sk)
    mine = (keep & (sk >= e0) & (sk < e0 + El)).reshape(T * K)
    e_idx = torch.where(mine, sk.reshape(T * K) - e0, 0)
    s_idx = torch.where(mine, in_block.reshape(T * K) - 1, Cl)

    token_of = torch.arange(T * K, device=xt.device) // K
    buf = xt.new_zeros((El, Cl + 1, d))
    buf[e_idx, s_idx] = xt[token_of]
    out = experts(ws, buf[:, :Cl], cfg.mlp_activation)
    gathered = out[e_idx, s_idx.clamp(max=Cl - 1)]
    gates = torch.where(mine.view(T, K), gate_w, 0.0).to(out.dtype)
    y = (gathered.view(T, K, d) * gates[..., None]).sum(dim=1)
    y = DTensor.from_local(y.view(b, s, d), mesh, [
        part if expert[i] else q for i, q in enumerate(xg.placements)],
        run_check=False)
    y = redistributed(y, x.placements)

    # the aux loss's sums over all tokens: each rank of the expert dims
    # takes every shards-th token of the block, so they are partial there
    share = slice(shard, None, shards)
    f_p = torch.stack((F.one_hot(sel[share], E).sum(dim=(0, 1)).float(),
                       probs[share].sum(dim=0)))
    f_p = settle(DTensor.from_local(f_p, mesh, sums, run_check=False)) \
        / (B * S)
    aux = _aux(f_p[0], f_p[1], cfg)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg.mlp_activation)
    return y, aux


def moe_ffn(p: Params, x: torch.Tensor, cfg
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out in ``x.dtype``, f32 aux loss).  A DTensor takes
    the expert-parallel route on its local shards."""
    if is_dtensor(x):
        return _expert_parallel(p, x, cfg)
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    r = route(p, xt, cfg)
    y = combine(experts(p, dispatch(xt, r), cfg.mlp_activation), r)
    if "shared" in p:
        y = y + L.mlp(p["shared"], xt, cfg.mlp_activation)
    return y.reshape(B, S, d), r.aux
