"""The port's sharding policies (``repro_torch.core.policies``) against the
JAX package's, in one process and with no process group.

JAX's policies run on ``jax.sharding.AbstractMesh`` over
``jax.eval_shape`` of the model's init and cache; the port's run on its
shape-only ``ShapeMesh`` over meta-device parameters and caches.  For every
config of the registry, full size and smoke, under ``layerwise_tp``,
``fused_seq`` and ``fused_seq_zero3``, on the meshes (1,1), (2,4), (16,16)
and (2,16,16), the trees ``param_spec``, ``cache_spec``, ``batch_spec``,
``logits_spec`` and ``state_spec`` (the ZeRO-1 moments included) must be
equal leaf for leaf.  The full sizes on a 16-way model axis reach the KV
fallback branches (minicpm's 36 KV heads, whisper's 20).  Then
``repair_spec``'s cases of ``tests/test_policies_sharded.py``, the hints'
cascade against the same repair computed from JAX's ``repair_spec``, and
the placements of a spec, whose multi-axis part out of mesh order raises.
"""

import functools

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.core import hints as jax_hints
from repro.core.policies import get_policy as jax_get_policy
from repro.core.policies import repair_spec as jax_repair_spec
from repro.data.pipeline import make_batch_specs as jax_batch_specs
from repro.models import build_model as jax_build_model
from repro.train.trainer import state_spec as jax_state_spec
from repro_torch import tree
from repro_torch.configs import ARCH_REGISTRY, get_config
from repro_torch.core import hints as H
from repro_torch.core.policies import (P, ShapeMesh, get_policy, placements,
                                       repair_spec)
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import build_model
from repro_torch.train.trainer import state_spec

MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
POLICIES = ["layerwise_tp", "fused_seq", "fused_seq_zero3"]
BATCH, SEQ, CACHE_LEN = 32, 64, 64


def _norm(part):
    """A spec part as a tuple of axis names (None for none)."""
    if part is None:
        return None
    names = (part,) if isinstance(part, str) else tuple(part)
    return names or None


def _spec(s) -> tuple:
    return tuple(_norm(p) for p in s)


def _jax_flat(t) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(k.key) for k in path
                  if isinstance(k, jax.tree_util.DictKey)): _spec(s)
            for path, s in leaves}


def _port_flat(t) -> dict:
    out = {}
    tree.map_with_path(
        lambda path, s: out.__setitem__(
            tuple(k for k in path if isinstance(k, str)), _spec(s)), t)
    return out


@functools.cache
def _jax_shapes(arch: str, smoke: bool):
    cfg = jax_get_config(arch, smoke=smoke)
    m = jax_build_model(cfg)
    params = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    cache = jax.eval_shape(lambda: m.init_cache(BATCH, CACHE_LEN))
    return cfg, params, cache, jax_batch_specs(cfg, BATCH, SEQ)


@functools.cache
def _port_shapes(arch: str, smoke: bool):
    cfg = get_config(arch, smoke=smoke)
    m = build_model(cfg, device="meta")
    params = m.init(0).params
    cache = m.init_cache(BATCH, CACHE_LEN)
    return cfg, params, cache, make_batch_specs(cfg, BATCH, SEQ)


def test_registry_is_jax_registry():
    assert ARCH_REGISTRY == list(JAX_REGISTRY)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_REGISTRY)
def test_specs_equal_jax(arch, smoke, policy):
    jcfg, jparams, jcache, jbatch = _jax_shapes(arch, smoke)
    cfg, params, cache, batch = _port_shapes(arch, smoke)
    for shape, axes in MESHES:
        jpol = jax_get_policy(policy, AbstractMesh(shape, axes), jcfg)
        pol = get_policy(policy, ShapeMesh(shape, axes), cfg)
        where = f"{arch}{'-smoke' if smoke else ''} {policy} {shape}"
        for name, want, got in [
            ("param_spec", jpol.param_spec(jparams), pol.param_spec(params)),
            ("cache_spec", jpol.cache_spec(jcache), pol.cache_spec(cache)),
            ("batch_spec", jpol.batch_spec(jbatch), pol.batch_spec(batch)),
            ("state_spec", jax_state_spec(jpol, jparams),
             state_spec(pol, params)),
        ]:
            w, g = _jax_flat(want), _port_flat(got)
            assert g.keys() == w.keys(), f"{where} {name}: leaves differ"
            bad = {k: (g[k], w[k]) for k in w if g[k] != w[k]}
            assert not bad, f"{where} {name}: {bad}"
        assert _spec(pol.logits_spec()) == _spec(jpol.logits_spec()), where


REPAIR_CASES = [
    # spec parts, shape, mesh
    (("model", None), (7, 3), ((1,), ("model",))),
    (("data", "model"), (1, 122753), ((2, 4), ("data", "model"))),
    ((("data", "model"),), (2,), ((2, 4), ("data", "model"))),
    ((("data", "model"),), (16,), ((2, 4), ("data", "model"))),
    ((("pod", "data"), None, "model"), (4, 8, 36),
     ((2, 16, 16), ("pod", "data", "model"))),
    ((None, "model", None), (3, 16, 5), ((16, 16), ("data", "model"))),
]


@pytest.mark.parametrize("parts,shape,mesh", REPAIR_CASES)
def test_repair_spec_equals_jax(parts, shape, mesh):
    got = repair_spec(P(*parts), shape, ShapeMesh(*mesh))
    want = jax_repair_spec(JP(*parts), shape, AbstractMesh(*mesh))
    assert _spec(got) == _spec(want)


def test_repair_spec_drops_indivisible():
    mesh = ShapeMesh((2, 4), ("data", "model"))
    assert repair_spec(P("data", "model"), (1, 122753), mesh) == P(None, None)
    assert repair_spec(P(("data", "model")), (2,), mesh) == P("data")


def _jax_choice(cand, shape, mesh):
    """JAX's ``hint`` cascade, written out over its ``repair_spec``."""
    specs = cand if isinstance(cand, (list, tuple)) else [cand]
    best = None
    for s in specs:
        r = jax_repair_spec(s, shape, mesh)
        if best is None or sum(p is not None for p in r) > \
                sum(p is not None for p in best):
            best = r
    return best


@pytest.mark.parametrize("table", ["tp", "fused_seq"])
@pytest.mark.parametrize("shape", [(8, 64, 32, 64), (8, 64, 8, 64),
                                   (8, 64, 36, 64), (1, 63, 4, 16),
                                   (8, 64, 2048)])
def test_hint_cascade_equals_jax(table, shape):
    for sizes, axes in MESHES:
        mesh = ShapeMesh(sizes, axes)
        dp = tuple(a for a in axes if a != "model")
        dp = dp if len(dp) != 1 else dp[0]
        ours = (H.tp_hints if table == "tp" else H.fused_seq_hints)(dp)
        theirs = (jax_hints.tp_hints if table == "tp"
                  else jax_hints.fused_seq_hints)(dp)
        for tag in ("qkv", "attn_out", "residual"):
            if len(shape) != (3 if tag == "residual" else 4):
                continue
            got = H.choose(ours[tag], shape, mesh)
            want = _jax_choice(theirs[tag], shape, AbstractMesh(sizes, axes))
            assert _spec(got) == _spec(want), (tag, sizes, shape)


def test_hint_is_identity_on_plain_tensors():
    x = torch.randn(2, 4, 3)
    with H.sharding_hints(H.fused_seq_hints("data")):
        assert H.hint("residual", x) is x
    assert H.hint("residual", x) is x


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = ShapeMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == (Replicate(), Shard(1),
                                                 Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod"), None), mesh)
    with pytest.raises(ValueError, match="shards two dims"):
        placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not on the mesh"):
        placements(P("expert"), mesh)


def test_fused_seq_batch_spec_keeps_jax_instance_flag():
    """JAX's ``FusedSeq`` sets ``shard_sequence = True`` on the class, but
    the dataclass field's default (False) is set on every instance, so its
    batch spec shards only the batch; the port keeps that behaviour."""
    mesh = ShapeMesh((2, 4), ("data", "model"))
    pol = get_policy("fused_seq", mesh, get_config("qwen3-32b", smoke=True))
    jpol = jax_get_policy("fused_seq", AbstractMesh((2, 4), ("data", "model")),
                          jax_get_config("qwen3-32b", smoke=True))
    assert pol.shard_sequence is False and jpol.shard_sequence is False
    tokens = {"tokens": torch.empty(8, 32, dtype=torch.int32, device="meta")}
    jtokens = {"tokens": jax.ShapeDtypeStruct((8, 32), jnp.int32)}
    assert _port_flat(pol.batch_spec(tokens)) == \
        _jax_flat(jpol.batch_spec(jtokens))
