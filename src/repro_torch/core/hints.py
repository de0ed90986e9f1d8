"""Sharding hints: the port of ``repro.core.hints``, where JAX injects
``with_sharding_constraint`` at chosen points.

Sharding propagation alone can mis-shard specific regions (the GQA head
reshape + qk-norm, the residual stream under sequence sharding).  Models
call ``hint(tag, x)`` at those points; by default it is the identity, and
a policy's perf mode installs a tag → spec table via
``sharding_hints(...)`` so the constraint lands without threading policy
objects through every layer.  In the port the constraint is a
``redistribute`` of a DTensor ``x`` onto its own mesh; a plain tensor
(every unsharded path) passes through untouched, so no numerics move.

Tags used by the model zoo:
    qkv        — (B, S, heads, head_dim) right after the head reshape
    attn_out   — (B, S, heads, head_dim) attention output pre-merge
    residual   — (B, S, d_model) the residual stream between blocks
"""

from __future__ import annotations

import contextlib
import contextvars

from repro_torch.core.dtensor import is_dtensor
from repro_torch.core.policies import P, placements, repair_spec

_HINTS: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "sharding_hints", default=None)


def _sharded_axes(spec) -> int:
    return sum(1 for p in spec if p is not None)


def choose(cand, shape: tuple[int, ...], mesh) -> P:
    """The cascade: candidates in preference order; the survivor that keeps
    the most sharded axes after divisibility repair (e.g. head-sharding
    falls back to head-DIM sharding when heads < mesh axis)."""
    specs = cand if isinstance(cand, (list, tuple)) else [cand]
    best = None
    for s in specs:
        r = repair_spec(s, shape, mesh)
        if best is None or _sharded_axes(r) > _sharded_axes(best):
            best = r
    return best


def hint(tag: str, x):
    table = _HINTS.get()
    if not table or not is_dtensor(x):
        return x
    cand = table.get(tag)
    if cand is None:
        return x
    want = placements(choose(cand, tuple(x.shape), x.device_mesh),
                      x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def sharding_hints(table: dict):
    tok = _HINTS.set(table)
    try:
        yield
    finally:
        _HINTS.reset(tok)


def tp_hints(dp) -> dict:
    """Perf hints for the layerwise_tp policy (head-sharded activations,
    falling back to head-DIM sharding for few-head archs)."""
    return {
        "qkv": [P(dp, None, "model", None), P(dp, None, None, "model")],
        "attn_out": [P(dp, None, "model", None),
                     P(dp, None, None, "model")],
        "residual": P(dp, None, None),
    }


def fused_seq_hints(dp) -> dict:
    """Perf hints for fused_seq (sequence-sharded residual stream)."""
    return {
        "qkv": P(dp, "model", None, None),
        "attn_out": P(dp, "model", None, None),
        "residual": P(dp, "model", None),
    }


def hints_for(policy) -> dict:
    """The table of ``policy``'s name: ``tp_hints`` for ``layerwise_tp``,
    ``fused_seq_hints`` otherwise (as the JAX dry run picks)."""
    dp = policy._dp()
    return tp_hints(dp) if policy.name == "layerwise_tp" \
        else fused_seq_hints(dp)
