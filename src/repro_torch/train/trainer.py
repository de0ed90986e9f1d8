"""Train and serve steps, the port of ``repro.train.trainer``:
next-token cross-entropy plus the MoE aux loss, optional microbatching
(float32 gradient accumulation), optional remat, optional int8 gradient
compression with error feedback, and AdamW under the config's WSD or
cosine schedule.

PyTorch runs eagerly, so ``make_train_step`` returns a plain function
(JAX's is jitted).  The train state is ``{"params", "opt": {"m", "v",
"step"}}`` (and ``"ef"`` with compression), as in JAX; its parameters are
leaf tensors with ``requires_grad`` that the forward reads directly (through
``Model.bind``) and the optimizer updates in place, under
``torch.no_grad()``.  A step therefore overwrites the state it is given and
returns it: clone a state that must survive.

The same step trains a SHARDED state, whose leaves are DTensors placed by
a policy (``repro_torch.core.policies``): the loss and its gradient then
run under ``implicit_replication`` (plain tensors the model makes, such as
positions, count as replicated) and DTensor's sharding propagation inserts
the collectives, the counterpart of GSPMD under JAX's jit.  The sharding
helpers: ``opt_spec_from_param_spec`` (ZeRO-1 moments), ``state_spec``
(the whole state's specs) and ``named`` (specs → ``NamedSharding``s, a
mesh and its placements).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
import torch.utils.checkpoint

from repro_torch import tree
from repro_torch.core.dtensor import is_dtensor
from repro_torch.core.policies import P, NamedSharding, Policy, mesh_shape, \
    placements
from repro_torch.models.api import Model, _head
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.compression import compress_grads, init_error_feedback
from repro_torch.optim.schedule import make_schedule


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``, in
    float32."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(-1, labels.to(logits.device).long()[..., None])[..., 0]
    return -ll.mean()


def make_loss_fn(model: Model):
    """loss_fn(params, batch) → (cross-entropy + aux, aux)."""
    def loss_fn(params, batch):
        logits, aux = model.forward(model.bind(params), batch)
        return cross_entropy(logits, batch["labels"]) + aux, aux

    return loss_fn


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatch: int = 0          # 0 → no accumulation
    remat: bool = False
    compress_grads: bool = False
    schedule_total_steps: int = 10000
    schedule_warmup: int = 100
    # chunked head+CE over sequence slices: each slice's logits live only
    # inside its own checkpointed chunk, never the whole (B, S, vocab)
    loss_chunk: int = 0


def init_train_state(model: Model, params, ts_cfg: TrainStepConfig):
    """``params``: the tree, or the module ``model.init`` returns (its own
    tensors are then trained).  Marks every floating leaf as requiring a
    gradient, in place."""
    if isinstance(params, torch.nn.Module):
        params = params.params
    for p in tree.leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params)}
    if ts_cfg.compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


def _micro(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` along dim 0.  A DTensor splits shard by
    shard: the i-th slice of every rank's local rows, a slice of the batch
    in another grouping than the contiguous one, whose n equal parts
    average to the same loss and gradient; slicing the global dim would
    gather the batch onto every rank.  Every rank's rows must split into
    n equal parts: the microbatch must be a multiple of the data-parallel
    size."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        local = x.to_local()
        if local.shape[0] % n:
            raise ValueError(
                f"{local.shape[0]} local rows of a batch of {x.shape[0]} "
                f"do not split into {n} microbatches: the microbatch must "
                f"be a multiple of the data-parallel size")
        rows = local.shape[0] // n
        return DTensor.from_local(local[i * rows:(i + 1) * rows],
                                  x.device_mesh, x.placements,
                                  run_check=False)
    mb = x.shape[0] // n
    return x[i * mb:(i + 1) * mb]


def _metric(x: torch.Tensor) -> torch.Tensor:
    """A detached metric, as a plain tensor (a DTensor's global value)."""
    x = x.detach()
    return x.full_tensor() if is_dtensor(x) else x


def sharded(leaves: list) -> contextlib.AbstractContextManager:
    """``implicit_replication`` when a leaf is a DTensor, else nothing."""
    if not any(is_dtensor(x) for x in leaves):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_grad_fn(model: Model, ts_cfg: TrainStepConfig
                 ) -> Callable[[Any, Any], tuple[Any, Any, Any]]:
    """grad_fn(params, batch) → (loss, aux, grads): the loss of one
    batch (split into ``microbatch``-row slices whose float32 gradients
    are averaged) and its gradient tree, leaves in the parameters' dtypes
    without microbatching, float32 with it; a leaf the loss does not reach
    gets zeros, as ``jax.grad`` gives."""
    cfg = model.cfg

    def loss_fn(params, batch):
        lm = model.bind(params)
        if ts_cfg.loss_chunk:
            hidden, aux = model.forward(lm, batch, remat=ts_cfg.remat,
                                        return_hidden=True)
            S = hidden.shape[1]
            n = max(1, S // ts_cfg.loss_chunk)
            width = S // n
            labels = batch["labels"].to(hidden.device)

            def chunk_ce(hc, lc):
                return cross_entropy(_head(params, cfg, hc), lc)

            ce = torch.zeros((), dtype=torch.float32, device=hidden.device)
            for i in range(n):
                part = slice(i * width, (i + 1) * width)
                ce = ce + torch.utils.checkpoint.checkpoint(
                    chunk_ce, hidden[:, part], labels[:, part],
                    use_reentrant=False, preserve_rng_state=False) / n
            return ce + aux, aux
        logits, aux = model.forward(lm, batch, remat=ts_cfg.remat)
        return cross_entropy(logits, batch["labels"]) + aux, aux

    def value_and_grad(params, batch):
        leaves = tree.leaves(params)
        with sharded(leaves):
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return _metric(loss), _metric(aux), tree.unflatten(params, grads)

    def grad_fn(params, batch):
        if not ts_cfg.microbatch:
            return value_and_grad(params, batch)
        mb = ts_cfg.microbatch
        gb = batch["tokens"].shape[0]
        if gb % mb:
            # JAX's reshape to (gb // mb, mb) refuses it too
            raise ValueError(f"a batch of {gb} rows does not split into "
                             f"microbatches of {mb}")
        n = gb // mb
        acc = None
        losses, auxes = [], []
        for i in range(n):
            micro = {k: _micro(v, i, n) for k, v in batch.items()}
            l_i, a_i, g = value_and_grad(params, micro)
            # the first microbatch's gradients start the sums, in their own
            # placements: a DTensor's partial sum then stays partial until
            # the optimizer reduces it once
            parts = [b.to(torch.float32) / n for b in tree.leaves(g)]
            if acc is None:
                acc = parts
            else:
                for a, b in zip(acc, parts):
                    a.add_(b)
            losses.append(l_i / n)
            auxes.append(a_i / n)
        return sum(losses), sum(auxes), tree.unflatten(params, acc)

    return grad_fn


def make_train_step(model: Model, ts_cfg: TrainStepConfig
                    ) -> Callable[[Any, Any], tuple[Any, Any]]:
    """train_step(state, batch) → (state, metrics): the gradients of
    ``make_grad_fn``, compressed with error feedback if asked, then one
    AdamW update in place at the schedule's factor for the 1-based step it
    commits.  metrics: ``loss``, ``aux_loss``, ``grad_norm``, ``lr``."""
    cfg = model.cfg
    schedule = make_schedule(cfg.lr_schedule,
                             warmup=ts_cfg.schedule_warmup,
                             total=ts_cfg.schedule_total_steps)
    grad_fn = make_grad_fn(model, ts_cfg)

    def train_step(state, batch):
        params = state["params"]
        loss, aux, grads = grad_fn(params, batch)
        new_state = dict(state)
        if ts_cfg.compress_grads:
            grads, new_state["ef"] = compress_grads(grads, state["ef"])
        # schedule sees the 1-based step the update commits (step 0 of a
        # fresh run must already take a warmup-scaled, NONZERO step)
        lr_scale = schedule(state["opt"]["step"] + 1)
        new_params, new_opt, metrics = adamw_update(
            ts_cfg.opt, params, grads, state["opt"], lr_scale)
        new_state.update(params=new_params, opt=new_opt)
        metrics.update(loss=loss, aux_loss=aux)
        return new_state, metrics

    return train_step


def make_serve_step(model: Model, *, sample: bool = False):
    """One batched decode step: greedy int32 tokens (B, 1) (or the
    logits) and the cache, which ``decode_step`` updates in place.  ``lm``
    is the model's module (``model.init``'s, or ``model.bind`` of a
    trained tree)."""

    @torch.no_grad()
    def serve_step(lm, cache, tokens, index):
        logits, cache = model.decode_step(lm, cache, tokens, index)
        if sample:
            out = logits[:, -1].argmax(dim=-1).to(torch.int32)
            return out[:, None], cache
        return logits, cache

    return serve_step


# ---------------------------------------------------------------------------
# sharding helpers
# ---------------------------------------------------------------------------

def opt_spec_from_param_spec(policy: Policy, param_spec, params_shape):
    """ZeRO-1: moments = param sharding + every free mesh axis slotted into
    the first divisible unsharded dim."""
    sizes = mesh_shape(policy.mesh)

    def rule(spec: P, shp):
        used = {a for part in spec for a in
                ((part,) if isinstance(part, str) else (part or ()))}
        parts = list(spec) + [None] * (len(shp.shape) - len(spec))
        for ax, size in sizes.items():
            if ax in used:
                continue
            for d in range(len(parts)):
                dim_ok = parts[d] is None and shp.shape[d] % size == 0 \
                    and shp.shape[d] >= size
                if dim_ok:
                    parts[d] = ax
                    used.add(ax)
                    break
        return P(*parts)

    return tree.map(rule, param_spec, params_shape)


def state_spec(policy: Policy, params_shapes) -> dict:
    """Spec tree for the full train state given param SHAPES (meta-device
    tensors will do — no allocation)."""
    pspec = policy.param_spec(params_shapes)
    ospec = opt_spec_from_param_spec(policy, pspec, params_shapes)
    return {"params": pspec,
            "opt": {"m": ospec, "v": ospec, "step": P()}}


def named(mesh, spec_tree):
    """Each spec as a ``NamedSharding``: ``mesh`` and the spec's DTensor
    placements on it."""
    return tree.map(lambda s: NamedSharding(mesh, placements(s, mesh)),
                    spec_tree)
