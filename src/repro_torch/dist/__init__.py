"""``repro_torch.dist``: the mesh-sharding policy, the port's copy of
``repro.dist``.

The analogue of the paper's region-constrained memory packing (FCMP),
term by term:

===========================  ==============================================
paper (FPGA floorplan)       this package (device mesh)
===========================  ==============================================
logical parameter memory     a parameter / batch / cache leaf
physical RAM block           a slice of a mesh axis
floorplan region (SLR)       a mesh-axis *role* (tensor / batch / pipeline)
bin (stack of buffers)       one dim entry of a ``PartitionSpec``
"bins never mix regions"     a dim entry never combines axes of different
                             roles (``legalize.validate_spec``)
bin height divisibility      a sharded dim must divide the product of its
                             mesh-axis sizes (``legalize.divides``)
packing fallback             replication, when no divisible placement
                             exists (the paper's "spill to URAM/LUTRAM")
===========================  ==============================================

Layering:

* ``mesh_axes``: axis-role discovery over a ``DeviceMesh``, a test fake
  or a ``MeshView`` (no device or process group is ever touched);
* ``legalize``: the port's ``PartitionSpec``, the divisibility checker,
  the candidate-placement search and the never-mix-regions validator;
* ``rules``: per-family leaf rules (tensor-parallel, expert-parallel or
  table sharding);
* ``sharding``: the public policy, ``param_specs``, ``batch_specs``,
  ``cache_specs``, ``token_spec``, ``sharded_byte_fraction``;
* ``placement``: fleet scale-out, a mesh's batch axes sliced into
  per-engine replica sub-meshes (``plan_engine_placement``).
"""

from repro_torch.dist import sharding  # noqa: F401
from repro_torch.dist.placement import (  # noqa: F401
    EnginePlacement,
    plan_engine_placement,
)
