"""``meta`` stand-ins and their placements for every dry-run cell.

The port's counterpart of ``repro.launch.specs``. The reference's
``jax.ShapeDtypeStruct`` stand-ins become tensors on the ``meta`` device
(shape and dtype, no storage); its ``NamedSharding``s become ``DTensor``
placements, one ``Shard`` / ``Replicate`` per mesh dim, made from the
policy's ``PartitionSpec``s (``dist.legalize.placements_of``, which
refuses a multi-axis entry out of the mesh's order). ``input_specs(cfg,
shape)`` gives every model input of the step kind the shape names (train
and prefill: the full-sequence batch; decode: the token and a cache of
``seq_len``); ``distribute_abstract`` lays stand-ins out on a mesh as
``meta`` ``DTensor``s, whose local shards have rank 0's shapes.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.dist import sharding as shd
from repro_torch.dist.legalize import PartitionSpec, placements_of
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, ShapeConfig, modality_batch_leaves, torch_dtype
from repro_torch.optim.adamw import AdamW, OptState


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """Train/prefill batch stand-ins: {tokens, labels[, modality stub]}."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32), "labels": _meta((b, s), torch.int32)}
    for name, rest in modality_batch_leaves(cfg).items():
        out[name] = _meta((b,) + rest, torch_dtype(cfg))
    return out


def abstract_params(cfg: ModelConfig) -> lm.LMParams:
    return lm.abstract_params(cfg)


def abstract_opt_state(cfg: ModelConfig, opt: AdamW | None = None) -> OptState:
    return (opt or AdamW()).init(abstract_params(cfg))


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """Decode-state stand-ins at the cell's (batch, seq_len), the enc-dec's
    cross-attention caches included."""
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    if cfg.family == "encdec":
        from repro_torch.models.encdec import with_cross_caches

        cache = with_cross_caches(cache, cfg, shape.global_batch)
    return cache


def abstract_token(cfg: ModelConfig, shape: ShapeConfig) -> torch.Tensor:
    return _meta((shape.global_batch, 1), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, Any]:
    """All stand-in inputs for the cell's step kind."""
    if shape.kind in ("train", "prefill"):
        return {"batch": abstract_batch(cfg, shape)}
    return {"token": abstract_token(cfg, shape), "cache": abstract_cache(cfg, shape)}


# --------------------------------------------------------------------------
# Shardings: placements per mesh dim, from the policy's specs
# --------------------------------------------------------------------------


def _placed(mesh, spec_tree):
    if isinstance(spec_tree, PartitionSpec):
        return placements_of(spec_tree, mesh)
    if isinstance(spec_tree, OptState):
        return OptState(*(_placed(mesh, s) for s in spec_tree))
    return {k: _placed(mesh, s) for k, s in spec_tree.items()}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    specs = shd.batch_specs(cfg, mesh, shape.global_batch)
    return _placed(mesh, {k: specs[k] for k in abstract_batch(cfg, shape)})


def param_shardings(cfg: ModelConfig, mesh):
    return _placed(mesh, shd.param_specs(cfg, mesh))


def opt_shardings(cfg: ModelConfig, mesh, opt: AdamW | None = None):
    pspec = shd.param_specs(cfg, mesh)
    return _placed(mesh, OptState(step=PartitionSpec(), mu=pspec, nu=pspec))


def mesh_shardings(mesh, placements):
    """``ckpt.restore_resharded``'s shardings from a ``*_shardings`` tree
    (nested dicts or an ``OptState`` of placements): each placements leaf
    as a ``(mesh, placements)`` pair."""
    if isinstance(placements, OptState):
        return OptState(*(mesh_shardings(mesh, p) for p in placements))
    if isinstance(placements, dict):
        return {k: mesh_shardings(mesh, p) for k, p in placements.items()}
    return mesh, placements


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    cache = abstract_cache(cfg, shape)
    specs = shd.cache_specs(cfg, mesh, shape.global_batch, shape.seq_len, cache=cache)
    return _placed(mesh, {k: specs[k] for k in cache})


def token_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh):
    return placements_of(shd.token_spec(cfg, mesh, shape.global_batch), mesh)


def distribute_abstract(tree, mesh, placements, *, trainable: bool = False):
    """``meta`` ``DTensor``s of the stand-ins in ``tree`` (nested dicts, an
    ``OptState`` or a tensor) laid out by ``placements`` (the same
    structure, from the ``*_shardings`` functions). Each local shard has
    rank 0's shape; no storage is allocated. With ``trainable`` the float
    leaves require gradients (the parameters a train step differentiates).
    A leaf of lower rank than its placements name (AdamW's scalar moment of
    a frozen packed carrier) is replicated."""
    if isinstance(tree, torch.Tensor):
        pl = [p if not p.is_shard() or p.dim < tree.dim() else Replicate() for p in placements]
        out = DTensor.from_local(
            torch.empty(_local_shape(tree.shape, pl, mesh), dtype=tree.dtype, device="meta"),
            mesh, pl, run_check=False, shape=tree.shape, stride=tree.stride())
        return out.requires_grad_() if trainable and out.is_floating_point() else out
    if isinstance(tree, OptState):
        return OptState(*(distribute_abstract(t, mesh, p) for t, p in zip(tree, placements)))
    return {k: distribute_abstract(t, mesh, placements[k], trainable=trainable)
            for k, t in tree.items()}


def _local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """Rank 0's shard of ``shape``: each sharded dim over the product of
    its mesh dims (the policy shards only dims that divide)."""
    out = list(shape)
    for p, n in zip(placements, mesh.shape):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)
