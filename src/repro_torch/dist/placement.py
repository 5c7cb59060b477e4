"""Engine placement over the mesh axes (fleet scale-out): the port's copy
of ``repro.dist.placement``.

A fleet engine is a full model replica: it keeps the whole tensor-
parallel ('model') extent and owns a contiguous slice of a *batch* (DP)
axis; engines are the coarsest data-parallel unit, the way the paper's
floorplan regions own whole SLRs while bins stack inside them. The
placement therefore only ever splits axes whose role is ``BATCH``
(``mesh_axes.ROLE_OF_AXIS``): splitting a tensor axis would change the
collectives inside an engine, and splitting the pipeline axis would put
one engine's stages on two engines.

Device-free like the rest of ``repro_torch.dist``: the planner reads only
axis names and sizes through ``MeshView``, so the launch entry points print
production placements (16x16, 2x16x16) on any host.
"""

from __future__ import annotations

import dataclasses

from repro_torch.dist.mesh_axes import MeshView


@dataclasses.dataclass(frozen=True)
class EnginePlacement:
    """One engine's slice of the fleet mesh."""

    engine_id: int
    axis: str  # the batch axis the fleet divides
    lo: int  # [lo, hi) slice of that axis
    hi: int
    view: MeshView  # the engine's own sub-mesh view

    @property
    def devices(self) -> int:
        return self.view.product(self.view.axis_names)

    def describe(self) -> str:
        shape = "x".join(str(s) for s in self.view.sizes)
        return (
            f"engine {self.engine_id}: {self.axis}[{self.lo}:{self.hi}] "
            f"-> {shape} ({self.devices} devices)"
        )


def plan_engine_placement(mesh, n_engines: int) -> list[EnginePlacement]:
    """Slice a mesh into ``n_engines`` replica sub-meshes.

    Picks the largest batch-role axis that ``n_engines`` divides (the
    divisibility rule of ``dist.legalize`` at engine granularity) and gives
    each engine a contiguous slice of it; every other axis is kept whole.
    Raises ``ValueError`` when no batch axis divides: there is no
    replication fallback here, because half an engine is not a meaningful
    spill target.
    """
    view = MeshView.of(mesh)
    if n_engines < 1:
        raise ValueError("need >= 1 engine")
    candidates = sorted(
        (a for a in view.batch_axes if view.axis_size(a) % n_engines == 0),
        key=view.axis_size,
        reverse=True,
    )
    if not candidates:
        sizes = {a: view.axis_size(a) for a in view.batch_axes}
        raise ValueError(
            f"{n_engines} engines divide no batch axis of {sizes}; "
            "choose an engine count dividing a data-parallel axis"
        )
    axis = candidates[0]
    per = view.axis_size(axis) // n_engines
    sub_sizes = tuple(per if a == axis else s for a, s in zip(view.axis_names, view.sizes))
    sub = MeshView(view.axis_names, sub_sizes)
    return [EnginePlacement(i, axis, i * per, (i + 1) * per, sub) for i in range(n_engines)]
