"""Device meshes, the port of ``repro.launch.mesh``.

Defined as FUNCTIONS (never module-level constants), so importing this
module touches no process group: the launcher and the dry run initialise
one (NCCL on the card, gloo on the CPU, a fake group of 256 or 512 ranks
in the dry run) and then call these.

Mesh axes:
* ``data``  — batch (and, for decode cells, KV-batch) sharding
* ``model`` — tensor/sequence sharding, the axis the paper's dataflow
  choice plays out on (layer-by-layer ↔ TP gathers; fused ↔ sequence
  sharding with local halos)
* ``pod``   — the multi-pod outer data axis (2 pods × 256 chips)

The policies read only a mesh's names and sizes, so a
``core.policies.ShapeMesh`` of the same shape stands for one with no
ranks behind it.
"""

from __future__ import annotations

from repro_torch.core.policies import mesh_shape


def production_shape(*, multi_pod: bool = False
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(sizes, names) of the production mesh: 16×16 ``data``×``model``, or
    2×16×16 with ``pod`` outermost."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, whose world size must be the product of ``shape``; on
    ``cuda`` unless ``device_type`` asks for another (``"cpu"``)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or "cuda", tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    shape, axes = production_shape(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes a global batch is sharded over (pod folds into data)."""
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"
