"""Sharding policies: the paper's dataflow dichotomy on a device mesh, the
port of ``repro.core.policies``.

Two first-class policies:

* ``layerwise_tp`` — the LAYER-BY-LAYER analogue: parameters are
  operand-partitioned over the ``model`` axis (attention heads / FFN
  columns ↔ the paper's cout partitioning).  Activations are replicated
  over ``model``, so every layer boundary re-gathers activations — the
  all-gather/reduce-scatter pairs DTensor's sharding propagation inserts
  are this policy's "cross-bank transfers".

* ``fused_seq`` — the FUSED-LAYER analogue: the residual stream stays
  SEQUENCE-sharded over ``model`` across consecutive layers (sequence ↔ the
  paper's (ox,oy) spatial tiling).  Weights are broadcast (replicated ↔ the
  GBUF weight broadcast); token-local ops (norms, MLPs, element-wise) run
  with zero collectives; only the mixing boundary op (attention K/V, MoE
  dispatch, the scans) communicates.

Specs are produced by NAME-BASED rules over the parameter tree; leading
layer-stack dimensions are inferred from rank (ndim − canonical rank), so
the same rules cover flat, L-stacked and (U, I)-unit-stacked parameters.

A spec is the port's own ``P``: one part per tensor dim, each ``None``, a
mesh axis name, or a tuple of names (one dim sharded over several mesh
axes, major first).  The rules read only a mesh's axis names and sizes
(``mesh_shape``), so they work on a ``DeviceMesh`` and on a ``ShapeMesh``,
a mesh of sizes and names without ranks, on which a 512-rank production
mesh is reasoned about with no process group.  ``placements`` turns a spec
into DTensor placements on a ``DeviceMesh``; ``Policy.shard`` places a
tree with them.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any

from repro_torch import tree

# canonical (unstacked) matmul leaves: (in, out)
_MAT2 = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_i", "w_f",
         "w_o", "w_z", "in_proj", "out_proj", "lm_head", "router", "fc_w"}
_TP_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_i", "w_f", "w_o", "w_z",
           "lm_head", "in_proj"}
_TP_ROW = {"wo", "w_down", "out_proj"}
_EXPERT3 = {"w_gate", "w_up", "w_down"}          # MoE: (E, d, f) canonical
_KV_LEAVES = {"k", "v", "xk", "xv"}


class P:
    """A partition spec: one part per leading tensor dim (missing trailing
    parts are ``None``).  Unlike JAX's ``PartitionSpec`` it is not a tuple,
    so that the port's tree functions take it as a leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts: Any):
        for p in parts:
            ok = p is None or isinstance(p, str) or (
                isinstance(p, tuple) and all(isinstance(n, str) for n in p))
            if not ok:
                raise TypeError(f"P: a part is None, an axis name or a tuple "
                                f"of names, got {p!r}")
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other: object) -> bool:
        if isinstance(other, P):
            return self.parts == other.parts
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self.parts))})"


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh of axis sizes and names with no ranks behind it (JAX's
    ``AbstractMesh``): what the policies read, without a process group."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"ShapeMesh: {self.axis_sizes} sizes for "
                             f"{self.axis_names} names")

    @property
    def shape(self) -> OrderedDict:
        return OrderedDict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.axis_sizes:
            n *= s
        return n


def mesh_shape(mesh) -> OrderedDict:
    """{axis name: size} in mesh-dim order, of a ``ShapeMesh`` or a
    ``DeviceMesh`` (whose dims must be named)."""
    if isinstance(mesh, ShapeMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the policies need a DeviceMesh with named dims")
    return OrderedDict(zip(names, mesh.shape))


def _names(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d``'s part names, ``Replicate()`` on the
    others.  A part naming several axes shards its dim over them in
    mesh-dim order, as DTensor applies shards; a tuple in another order
    than the mesh's raises (it would silently mean another layout), and so
    does an axis named twice or not on the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_shape(mesh))
    out: list = [Replicate() for _ in order]
    seen: set[str] = set()
    for d, part in enumerate(spec):
        names = _names(part)
        for n in names:
            if n not in order:
                raise ValueError(f"{spec}: axis {n!r} is not on the mesh "
                                 f"{tuple(order)}")
            if n in seen:
                raise ValueError(f"{spec}: axis {n!r} shards two dims")
            seen.add(n)
            out[order.index(n)] = Shard(d)
        idx = [order.index(n) for n in names]
        if idx != sorted(idx):
            raise ValueError(
                f"{spec}: dim {d}'s axes {names} are not in the mesh's order "
                f"{tuple(order)}; DTensor shards one dim over several mesh "
                f"dims in mesh order, so this spec has no placements")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and DTensor placements on it: where a leaf lives
    (JAX's ``NamedSharding``, with the spec already turned into
    placements)."""

    mesh: Any
    placements: tuple


def _path_names(path) -> list[str]:
    return [k for k in path if isinstance(k, str)]


def _lead(x, canonical: int) -> list[None]:
    return [None] * max(0, x.ndim - canonical)


def _pad(spec_parts: list, ndim: int) -> P:
    parts = spec_parts + [None] * (ndim - len(spec_parts))
    return P(*parts[:ndim])


def repair_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop (partially, if a tuple) any axis assignment whose mesh size does
    not divide the tensor dim — e.g. batch=1 cells can't take the data
    axes, odd vocabs can't take the model axis."""
    sizes = mesh_shape(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        if part is None:
            out.append(None)
            continue
        kept: list[str] = []
        size = 1
        for n in _names(part):
            if dim % (size * sizes[n]) == 0:
                kept.append(n)
                size *= sizes[n]
        out.append(tuple(kept) if len(kept) > 1 else
                   (kept[0] if kept else None))
    return P(*out)


def _is_expert_leaf(names: list[str]) -> bool:
    return "moe" in names and names[-1] in _EXPERT3 and "shared" not in names


@dataclasses.dataclass(frozen=True)
class Policy:
    """Produces specs for params / batch / cache / logits."""

    name: str
    mesh: Any
    cfg: Any

    def _dp(self):
        axes = tuple(a for a in mesh_shape(self.mesh) if a in ("pod", "data"))
        return axes if len(axes) != 1 else axes[0]

    def param_spec(self, params: Any) -> Any:
        raise NotImplementedError

    def batch_spec(self, batch: Any) -> Any:
        dp = self._dp()

        def rule(path, x):
            names = _path_names(path)
            if names and names[-1] in ("tokens", "labels") and x.ndim >= 2 \
                    and self.shard_sequence:
                return _pad([dp, "model"], x.ndim)
            return _pad([dp], x.ndim)

        return self._map_rules(rule, batch)

    def cache_spec(self, cache: Any) -> Any:
        raise NotImplementedError

    def logits_spec(self) -> P:
        raise NotImplementedError

    shard_sequence: bool = False

    def _map_rules(self, rule, params: Any) -> Any:
        """map a (path, leaf)->P rule with shape-divisibility repair."""
        return tree.map_with_path(
            lambda p, x: repair_spec(rule(p, x), tuple(x.shape), self.mesh),
            params)

    def shard(self, state: Any, spec_tree: Any) -> Any:
        """Each leaf as a DTensor on the policy's ``DeviceMesh`` with its
        spec's placements (``distribute_tensor``).  ``distribute_tensor``
        sends rank 0's copy (``src_data_rank=0``), so every rank must have
        made the same tree: the launcher draws the state on every rank from
        one seed.  A leaf that requires a gradient gives a DTensor leaf
        that does."""
        from torch.distributed.tensor import distribute_tensor

        def put(x, s):
            out = distribute_tensor(x.detach(), self.mesh,
                                    placements(s, self.mesh))
            return out.requires_grad_(x.requires_grad)
        return tree.map(put, state, spec_tree)


class LayerwiseTP(Policy):
    """Megatron-style tensor parallelism (layer-by-layer analogue)."""

    def __init__(self, mesh, cfg):
        super().__init__("layerwise_tp", mesh, cfg)

    def param_spec(self, params: Any) -> Any:
        def rule(path, x):
            names = _path_names(path)
            leaf = names[-1]
            if _is_expert_leaf(names):
                return _pad(_lead(x, 3) + ["model", None, None], x.ndim)
            if leaf in _MAT2 and leaf != "router":
                if leaf in _TP_COL:
                    return _pad(_lead(x, 2) + [None, "model"], x.ndim)
                if leaf in _TP_ROW:
                    return _pad(_lead(x, 2) + ["model", None], x.ndim)
            if leaf == "embed":
                return P("model", None)
            return _pad([], x.ndim)

        return self._map_rules(rule, params)

    def cache_spec(self, cache: Any) -> Any:
        dp = self._dp()
        msize = mesh_shape(self.mesh)["model"]

        def rule(path, x):
            names = _path_names(path)
            if names[-1] in _KV_LEAVES:
                # canonical (B, T, KV, hd): batch→data, kv heads→model;
                # FALL BACK to head-DIM sharding when kv % model ≠ 0
                # (minicpm kv=36, whisper kv=20 on a 16-way model axis)
                if x.shape[-2] % msize == 0:
                    return _pad(_lead(x, 4) + [dp, None, "model", None],
                                x.ndim)
                return _pad(_lead(x, 4) + [dp, None, None, "model"], x.ndim)
            canon, spec = _state_canon(names, dp, head_axis="model")
            return _pad(_lead(x, canon) + spec, x.ndim)

        return self._map_rules(rule, cache)

    def logits_spec(self) -> P:
        return P(self._dp(), None, "model")


class FusedSeq(Policy):
    """Sequence-sharded fused dataflow (the paper's technique analogue)."""

    shard_sequence = True

    def __init__(self, mesh, cfg):
        super().__init__("fused_seq", mesh, cfg)

    def param_spec(self, params: Any) -> Any:
        # weights broadcast (replicated over model) — the GBUF analogue;
        # MoE experts stay expert-sharded (dispatch is a boundary op).
        def rule(path, x):
            names = _path_names(path)
            if _is_expert_leaf(names):
                return _pad(_lead(x, 3) + ["model", None, None], x.ndim)
            return _pad([], x.ndim)

        return self._map_rules(rule, params)

    def cache_spec(self, cache: Any) -> Any:
        dp = self._dp()

        def rule(path, x):
            names = _path_names(path)
            if names[-1] in _KV_LEAVES:
                # KV cache SEQUENCE-sharded over model (ring-attention style)
                return _pad(_lead(x, 4) + [dp, "model", None, None], x.ndim)
            canon, spec = _state_canon(names, dp, head_axis="model")
            return _pad(_lead(x, canon) + spec, x.ndim)

        return self._map_rules(rule, cache)

    def logits_spec(self) -> P:
        return P(self._dp(), "model", None)


def _state_canon(names: list[str], dp, head_axis: str):
    """(canonical_rank, canonical_spec) for recurrent-state cache leaves.

    Disambiguates name collisions by subtree: mLSTM ``n`` is (B,H,P) while
    sLSTM ``n`` is (B,d).  Head/feature dims shard over ``model``; the batch
    dim shards over data axes."""
    leaf = names[-1]
    in_mlstm = "mlstm" in names
    in_slstm = "slstm" in names
    in_mamba = "mamba" in names
    if in_mamba and leaf == "ssm":           # (B, H, P, N)
        return 4, [dp, head_axis, None, None]
    if in_mamba and leaf == "conv":          # (B, W, C)
        return 3, [dp, None, None]
    if in_mlstm and leaf == "C":             # (B, H, P, P)
        return 4, [dp, head_axis, None, None]
    if in_mlstm and leaf == "n":             # (B, H, P)
        return 3, [dp, head_axis, None]
    if in_mlstm and leaf == "m":             # (B, H)
        return 2, [dp, head_axis]
    if in_slstm:                             # c/n/m/h: (B, d)
        return 2, [dp, head_axis]
    return 2, [dp]


class FusedSeqZero3(FusedSeq):
    """fused_seq + ZeRO-3-style weight sharding: parameters shard their
    first divisible non-stack dim over ``data`` and are re-gathered at use
    (DTensor's propagation inserts the all-gather where a layer reads
    them).  This is the paper's GBUF-capacity story at mesh scale: the
    fused dataflow broadcasts weights, and when they don't fit locally they
    stream in shards — trading collective bytes for the 1/N_data memory
    footprint that lets 32B-param models fit HBM under weight broadcast."""

    def __init__(self, mesh, cfg):
        Policy.__init__(self, "fused_seq_zero3", mesh, cfg)

    def param_spec(self, params: Any) -> Any:
        def rule(path, x):
            names = _path_names(path)
            if _is_expert_leaf(names):
                return _pad(_lead(x, 3) + ["model", "data", None], x.ndim)
            if names[-1] in _MAT2 or names[-1] in ("embed",):
                lead = _lead(x, 2)
                return _pad(lead + ["data", None], x.ndim)
            return _pad([], x.ndim)

        return self._map_rules(rule, params)


POLICIES = {
    "layerwise_tp": LayerwiseTP,
    "fused_seq": FusedSeq,
    "fused_seq_zero3": FusedSeqZero3,
}


def get_policy(name: str, mesh, cfg) -> Policy:
    return POLICIES[name](mesh, cfg)
