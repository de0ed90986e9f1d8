"""The row part of the JAX package's fused-layer tiling (``repro.core.
tiling``): how many input rows a tile of a fused group needs, propagated
back through every layer of the group, residual operands included.

Only what ``halo.group_halo_rows`` reads is kept: the layer records' row
geometry (name, kind, kernel, stride, padding, input and output rows and
the names of the tensors a layer reads), the y intervals of ``tile_group``
and ResNet18's chain with the fused-group bounds of the paper's Fused4
plan.  Columns, tile statistics and the PIM cost model are not here.
Intervals are half-open ``[lo, hi)`` and clipped to the feature map, so a
boundary tile loses the rows that fall on the padding.
"""

from __future__ import annotations

import dataclasses

Interval = tuple[int, int]   # half-open [lo, hi)

INPUT = "__input__"          # the group's input tensor, in ``_sources``


@dataclasses.dataclass(frozen=True)
class Layer:
    """One macro layer's row geometry: CONV_BN[_RELU], POOL_MAX or
    ADD_RELU (``kind``, the JAX ``OpKind``'s value)."""

    name: str
    kind: str
    iy: int
    oy: int
    k: int = 1
    stride: int = 1
    padding: int = 0
    # the layer whose output is the primary input; None = the previous one
    input_of: str | None = None
    # the layer whose output is the residual operand of an ADD_RELU
    residual_of: str | None = None


def _conv(name: str, iy: int, k: int, s: int, p: int, relu: bool = True,
          input_of: str | None = None) -> Layer:
    return Layer(name, "CONV_BN_RELU" if relu else "CONV_BN", iy,
                 (iy + 2 * p - k) // s + 1, k, s, p, input_of)


def build_resnet18(input_hw: int = 224) -> list[Layer]:
    """ResNet18's stem and four stages in the JAX ``build_resnet18``'s
    order (``repro.core.graph``), without the global pool and the head."""
    L = [_conv("conv1", input_hw, 7, 2, 3)]
    hw = L[-1].oy
    L.append(Layer("maxpool", "POOL_MAX", hw, (hw + 2 - 3) // 2 + 1, 3, 2, 1))
    hw = L[-1].oy
    cin = 64
    for si, cout in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            blk = f"s{si + 1}b{bi + 1}"
            in_name = L[-1].name
            L.append(_conv(f"{blk}_conv1", hw, 3, stride, 1))
            mid = L[-1].oy
            L.append(_conv(f"{blk}_conv2", mid, 3, 1, 1, relu=False))
            shortcut = in_name
            if stride != 1 or cin != cout:
                L.append(_conv(f"{blk}_down", hw, 1, stride, 0, relu=False,
                               input_of=in_name))
                shortcut = L[-1].name
            L.append(Layer(f"{blk}_add", "ADD_RELU", mid, mid,
                           input_of=f"{blk}_conv2", residual_of=shortcut))
            hw, cin = mid, cout
    return L


# The groups of ``repro.core.fusion.plan_fused(build_resnet18(), 2, 2)``:
# stem + stage 1, stage 2, stage 3; stage 4 and the head run layer by layer.
RESNET18_FUSED_GROUPS = ((0, 8), (8, 15), (15, 22))


def resnet18_fused_groups(input_hw: int = 224) -> list[list[Layer]]:
    chain = build_resnet18(input_hw)
    return [chain[a:b] for a, b in RESNET18_FUSED_GROUPS]


def _back_interval(out_iv: Interval, k: int, stride: int, padding: int,
                   in_extent: int) -> Interval:
    """Input rows needed for output rows ``out_iv``: ``[lo·s − p,
    (hi − 1)·s − p + k)``, clipped to ``[0, in_extent)``."""
    lo, hi = out_iv
    if hi <= lo:
        return (0, 0)
    return (max(0, lo * stride - padding),
            min(in_extent, (hi - 1) * stride - padding + k))


def _union(a: Interval, b: Interval) -> Interval:
    """The union of two intervals (they overlap or abut in a tiled group)."""
    if a[1] <= a[0]:
        return b
    if b[1] <= b[0]:
        return a
    return (min(a[0], b[0]), max(a[1], b[1]))


def _sources(group: list[Layer], i: int) -> list[str]:
    """Names of the tensors layer ``i`` reads (``INPUT`` = the group's
    input): its primary input, then any residual operand."""
    lyr = group[i]
    names = {x.name for x in group}
    primary = lyr.input_of
    if primary is None:
        primary = group[i - 1].name if i > 0 else INPUT
    out = [primary if primary in names else INPUT]
    if lyr.residual_of is not None:
        out.append(lyr.residual_of if lyr.residual_of in names else INPUT)
    return out


def input_rows(group: list[Layer], tiles: int) -> list[Interval]:
    """Per tile of a ``tiles``-row grid over the group's output, the group
    input rows it needs: the y intervals of the JAX ``tile_group(group,
    tiles, 1).input_req``.  Raises ``ValueError`` when the grid does not
    divide the output rows."""
    last = group[-1]
    if last.oy % tiles:
        raise ValueError(f"group output of {last.oy} rows not divisible by "
                         f"a {tiles}-row tile grid")
    ty = last.oy // tiles
    reqs = []
    for r in range(tiles):
        need = {last.name: (r * ty, (r + 1) * ty)}
        got: Interval = (0, 0)
        for i in range(len(group) - 1, -1, -1):
            lyr = group[i]
            out_iv = need.setdefault(lyr.name, (0, 0))
            in_iv = _back_interval(out_iv, lyr.k, lyr.stride, lyr.padding,
                                   lyr.iy)
            for j, src in enumerate(_sources(group, i)):
                # a residual operand is elementwise: the output's own rows
                iv = in_iv if j == 0 else out_iv
                if src == INPUT:
                    got = _union(got, iv)
                else:
                    need[src] = _union(need.get(src, (0, 0)), iv)
        reqs.append(got)
    return reqs
