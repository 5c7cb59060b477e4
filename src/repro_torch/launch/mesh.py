"""Production mesh construction over a fake process group, and meshes
over a real one.

The port's counterpart of ``repro.launch.mesh``. The reference forces 512
placeholder host devices; here a ``DeviceMesh`` spans the ranks of a fake
process group (``torch.testing._internal.distributed.fake_pg``, backend
``"fake"``, rank 0): no device, no network, no data moves, so every
collective is a stand-in the op walk counts (``make_mesh``,
``make_production_mesh``: the dry run's). ``make_real_mesh`` lays a mesh
over the real group a launcher made (``gloo`` or ``nccl``; the train CLI's
``fit_mesh`` and ``--production-mesh``), and never makes or replaces a
group. These are FUNCTIONS, not module constants: importing this module
touches no process group.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _fake_group(size: int) -> None:
    """Make a fake process group of ``size`` ranks, rank 0, unless one of
    that size exists: a fake group of another size is replaced; a real
    backend's group is never touched (raises)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group exists: the dry-run mesh is built "
                "only over a fake group")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """An arbitrary mesh (tests use small shapes) over a fake group of
    exactly ``prod(shape)`` ranks."""
    _fake_group(math.prod(shape))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks).

    Axes: 'data' carries DP (and the batch of the long-context cells),
    'model' carries TP/EP, 'pod' is the outer DP axis."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_real_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A mesh over the real process group that exists, of exactly
    ``prod(shape)`` ranks: on CUDA over ``nccl``, on the CPU otherwise.
    Never makes or replaces a group (raises where there is no real group
    or its size differs)."""
    if not dist.is_initialized() or dist.get_backend() == "fake":
        raise RuntimeError("no real process group: launch the ranks under torchrun")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} ranks; the group "
                         f"has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
