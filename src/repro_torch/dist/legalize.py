"""Divisibility-constrained placement: the packing legality kernel.

The port's copy of ``repro.dist.legalize``, over the port's own
``PartitionSpec``. A candidate placement is ``(dim, axes)``: shard array
dim ``dim`` over the mesh axes ``axes``. It is *legal* when the dim size
divides the product of the axis sizes, the analogue of the paper's
bin-height constraint (FCMP never splits a word across blocks).
``first_legal`` walks an ordered candidate list and falls back to
replication when nothing divides: the paper's spill path.

``validate_spec`` enforces the two structural invariants on every spec the
policy emits:

* an axis is used at most once per spec (a physical block holds one bin),
* a single dim entry never mixes axes of different roles ("bins never mix
  regions", ``core.packing.Packing.validate``).
"""

from __future__ import annotations

from repro_torch.dist.mesh_axes import MeshView


class PartitionSpec(tuple):
    """One entry per array dim: ``None`` (replicated), an axis name, or a
    tuple of axis names (the dim split over their product), as in
    ``jax.sharding.PartitionSpec``; an immutable tuple, so specs compare
    as tuples."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _as_axes(entry) -> tuple[str, ...]:
    """A spec dim entry -> tuple of axis names (may be empty)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def divides(dim_size: int, mesh: MeshView, axes: tuple[str, ...]) -> bool:
    """Bin-height legality: the dim splits evenly over the axis product."""
    prod = mesh.product(axes)
    return prod > 0 and dim_size % prod == 0


def first_legal(
    shape: tuple[int, ...],
    candidates: list[tuple[int, tuple[str, ...]]],
    mesh: MeshView,
) -> tuple[int, tuple[str, ...]] | None:
    """First candidate placement that is legal, or None (replicate).

    Negative dims are resolved against ``len(shape)``; candidates naming a
    dim the array does not have, or axes the mesh does not have, are
    skipped rather than raised: the same rule table serves every family
    and every mesh shape.
    """
    n = len(shape)
    for dim, axes in candidates:
        if dim < 0:
            dim += n
        if not 0 <= dim < n:
            continue
        axes = tuple(a for a in axes if a in mesh.axis_names)
        if not axes:
            continue
        if divides(shape[dim], mesh, axes):
            return dim, axes
    return None


def spec_from_placements(
    shape: tuple[int, ...],
    placements: list[tuple[int, tuple[str, ...]]],
) -> PartitionSpec:
    """Full-rank spec from resolved (dim, axes) placements."""
    entries: list = [None] * len(shape)
    for dim, axes in placements:
        if axes:
            entries[dim] = axes[0] if len(axes) == 1 else tuple(axes)
    return PartitionSpec(*entries)


def largest_dividing_suffix(
    mesh: MeshView, axes: tuple[str, ...], size: int
) -> tuple[str, ...]:
    """Longest suffix of ``axes`` whose product divides ``size``.

    Used for batch placement: the DP axes come ordered innermost-last
    (``('pod', 'data')``), and dropping axes from the *front* keeps the
    fast intra-pod axis sharded while the slow cross-pod axis replicates:
    batch 16 on a 2x16x16 mesh shards over 'data' (16) and replicates
    over 'pod' (batch 32 divides the full ('pod', 'data') product and
    shards over both).
    """
    for start in range(len(axes)):
        cand = axes[start:]
        if cand and divides(size, mesh, cand):
            return cand
    return ()


def validate_spec(shape: tuple[int, ...], spec: PartitionSpec, mesh: MeshView) -> None:
    """Raise ValueError if ``spec`` breaks a packing invariant."""
    seen: set[str] = set()
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} longer than shape {shape}")
    for dim, entry in enumerate(spec):
        axes = _as_axes(entry)
        if not axes:
            continue
        roles = {mesh.role(a) for a in axes}
        if len(roles) > 1:
            raise ValueError(f"dim {dim} of spec {spec} mixes regions {sorted(roles)}")
        for a in axes:
            if a not in mesh.axis_names:
                raise ValueError(f"spec {spec} names unknown axis {a!r}")
            if a in seen:
                raise ValueError(f"spec {spec} reuses axis {a!r}")
            seen.add(a)
        if not divides(shape[dim], mesh, axes):
            raise ValueError(
                f"dim {dim} ({shape[dim]}) of shape {shape} does not divide "
                f"axes {axes} (= {mesh.product(axes)})"
            )
