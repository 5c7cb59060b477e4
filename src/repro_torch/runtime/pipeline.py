"""GPipe-style pipeline parallelism over a mesh axis's process group.

The port of ``repro.runtime.pipeline``: the layer stack is split into S
contiguous stages along the mesh axis ``axis`` (one rank a stage);
microbatches stream through with the standard (S + M - 1)-slot schedule.
Activations move stage to stage as point-to-point sends
(``batch_isend_irecv`` on the axis's group), where the reference runs
``jax.lax.ppermute``: the paper's producer/consumer stream decoupling one
level up the stack (GALS islands -> pipeline stages, async FIFOs -> send
buffers).

The skewed schedule is the reference's: at slot t, stage s computes
microbatch t - s. Every stage computes in all S + M - 1 slots, as the
reference's scan does: stage 0 past the last microbatch on the last one
again, a later stage before its first on what it received (zeros before
anything arrives); that is the pipeline bubble, the (S-1)/(M+S-1)
utilisation factor. The last stage's outputs reach every rank of the axis
by a masked all-reduce (the reference's masked ``psum``).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _stage_slice(leaf, stage: int):
    """This rank's stage of a leaf with a leading stage axis: the local
    shard of a ``Shard(0)`` ``DTensor`` (one stage long), or the plain
    leaf's slice at ``stage``."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[stage]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_forward(
    layer_stack_fn: Callable,
    stage_params,
    x_microbatches: torch.Tensor,
    *,
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run microbatches through pipeline stages; every rank of ``mesh``
    calls it.

    layer_stack_fn(stage_params_slice, x) -> x : one stage's compute.
    stage_params: a tree (dicts, tuples, lists) whose leaves have a leading
    axis of n_stages: ``Shard(0)`` ``DTensor``s over ``axis``, or whole
    tensors, of which each rank takes its stage's slice.
    x_microbatches: (M, mb, ...) microbatched input, the same on every rank.
    Returns (M, mb, ...) outputs of the last stage, on every rank.
    """
    dim = mesh.mesh_dim_names.index(axis)
    n_stages = mesh.shape[dim]
    stage = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    xs = x_microbatches.to_local() if isinstance(x_microbatches, DTensor) else x_microbatches
    m = xs.shape[0]
    params_local = _tree_map(lambda v: _stage_slice(v, stage), stage_params)
    # P2POp takes global ranks: the axis's neighbours by their global rank
    nxt = dist.get_global_rank(group, stage + 1) if stage < n_stages - 1 else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    buf = torch.zeros_like(xs[0])  # incoming activation register
    outs = torch.zeros_like(xs)
    for t in range(m + n_stages - 1):
        # stage 0 injects microbatch t; the others take what they received
        x_in = xs[min(max(t, 0), m - 1)] if stage == 0 else buf
        y = layer_stack_fn(params_local, x_in)
        # forward the result to the next stage; stage 0 receives nothing
        # (zeros, as a partial ppermute gives)
        buf = torch.zeros_like(y) if prv is None else torch.empty_like(y)
        p2p = ([dist.P2POp(dist.isend, y.contiguous(), nxt, group)] if nxt is not None else []) + \
              ([dist.P2POp(dist.irecv, buf, prv, group)] if prv is not None else [])
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
        # the last stage records its finished microbatch t - (S - 1)
        if t >= n_stages - 1 and stage == n_stages - 1:
            outs[min(t - (n_stages - 1), m - 1)] = y
    # every rank of the axis gets the last stage's outputs: a masked sum
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
    return outs
