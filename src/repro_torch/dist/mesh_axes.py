"""Axis-role discovery over any mesh-like object.

The port's copy of ``repro.dist.mesh_axes``. The policy never touches a
device or a process group: it reads only axis names and sizes from what it
is handed, a ``torch.distributed.device_mesh.DeviceMesh``
(``mesh_dim_names``, ``shape``), anything exposing the reference's
``axis_names`` / ``shape`` (a test fake, a jax-style mesh), or a
``MeshView``. ``MeshView`` snapshots the two so every downstream module
works against one small, explicit surface.

Roles are the floorplan regions of the paper's packing problem: an axis
carries either *tensor* parallelism (TP/EP, the 'model' axis), *batch*
parallelism (DP, 'pod' and 'data'), or *pipeline* stages ('stage').
``legalize.validate_spec`` enforces that a single spec dim entry never
combines axes of different roles, the analogue of "bins never mix
regions" (``core.packing.Packing.validate``).
"""

from __future__ import annotations

import dataclasses
import math

# axis name -> role. Unknown axis names default to "batch": an unnamed
# extra axis behaves like plain DP, which is always numerically safe.
TENSOR, BATCH, PIPELINE = "tensor", "batch", "pipeline"
ROLE_OF_AXIS = {
    "model": TENSOR,
    "expert": TENSOR,
    "data": BATCH,
    "pod": BATCH,
    "replica": BATCH,
    "stage": PIPELINE,
}


@dataclasses.dataclass(frozen=True)
class MeshView:
    """The two attributes the policy is allowed to read, snapshotted."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @classmethod
    def of(cls, mesh) -> "MeshView":
        if isinstance(mesh, MeshView):
            return mesh
        if hasattr(mesh, "mesh_dim_names"):  # a torch DeviceMesh
            if mesh.mesh_dim_names is None:
                raise ValueError("the sharding policy needs a DeviceMesh with mesh_dim_names")
            return cls(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape))
        names = tuple(mesh.axis_names)
        shape = dict(mesh.shape)
        return cls(names, tuple(int(shape[a]) for a in names))

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def product(self, axes: tuple[str, ...]) -> int:
        shape = self.shape
        return math.prod(shape[a] for a in axes) if axes else 1

    def role(self, axis: str) -> str:
        return ROLE_OF_AXIS.get(axis, BATCH)

    @property
    def tensor_axes(self) -> tuple[str, ...]:
        """TP/EP axes in mesh order (the compute 'region')."""
        return tuple(a for a in self.axis_names if self.role(a) == TENSOR)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        """DP axes in mesh order (the batch 'region')."""
        return tuple(a for a in self.axis_names if self.role(a) == BATCH)

    @property
    def tp_size(self) -> int:
        return self.product(self.tensor_axes)

    @property
    def dp_size(self) -> int:
        return self.product(self.batch_axes)
