"""The sharding policy: legal partition specs for every parameter, batch
and cache leaf. The port's copy of ``repro.dist.sharding``.

Public API (all take any mesh-like ``mesh_axes.MeshView.of`` reads: a
``DeviceMesh``, a bare fake exposing ``axis_names`` / ``shape``; no device
or process group is touched, so production meshes plan on a laptop):

* ``param_specs(cfg, mesh)``                 specs mirroring
  ``lm.abstract_params(cfg).tree()`` leaf for leaf (packed carriers
  included);
* ``batch_specs(cfg, mesh, global_batch)``   the train/prefill batch
  leaves (tokens, labels, modality stand-ins);
* ``cache_specs(cfg, mesh, batch, seq_len)`` every decode-state leaf of
  ``lm.init_cache`` (plus the enc-dec's cross-attention caches);
* ``token_spec(cfg, mesh, global_batch)``    the (B, 1) decode token.

Guarantees, as the reference's: every sharded dim divides the product of
its mesh axes, falling back to replication when nothing divides; no spec
dim mixes tensor- and batch-region axes; a spec exists for every cache
leaf. Shapes come from ``lm.abstract_params`` and ``lm.init_cache`` on the
``meta`` device, never from real weights.
"""

from __future__ import annotations

import math
from typing import Any

from repro_torch.dist import rules
from repro_torch.dist.legalize import (
    PartitionSpec,
    first_legal,
    largest_dividing_suffix,
    spec_from_placements,
    validate_spec,
)
from repro_torch.dist.mesh_axes import MeshView
from repro_torch.models.config import ModelConfig, modality_batch_leaves

# Leaf names that are containers for a packed (FCMP-carrier) weight: the
# spec is derived from the *parent* weight name.
_PACKED_KEYS = ("packed", "scale")


def _leaf_name(path: tuple[str, ...]) -> str:
    """Logical leaf name: packed carriers report their parent weight."""
    if path and path[-1] in _PACKED_KEYS:
        if path[-1] == "scale":
            return "scale"  # per-channel scales replicate
        return path[-2] if len(path) >= 2 else path[-1]
    return path[-1] if path else ""


def leaves_with_paths(tree: dict[str, Any], path: tuple[str, ...] = ()):
    """(path, tensor) of every leaf of a nested dict, in insertion order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves_with_paths(value, path + (key,))
        else:
            yield path + (key,), value


def _tree_of(flat: dict[tuple[str, ...], Any]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for path, value in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return out


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def param_specs(cfg: ModelConfig, mesh) -> dict[str, Any]:
    """Spec tree mirroring ``lm.abstract_params(cfg).tree()``.

    Tensor-region only: parameters never occupy the batch axes (plain DP
    replicates them), so the optimizer state and checkpoint layers can
    apply this tree verbatim (the AdamW moments mirror the parameters).
    """
    from repro_torch.models import lm

    mv = MeshView.of(mesh)
    specs = {}
    for path, leaf in leaves_with_paths(lm.abstract_params(cfg).tree()):
        shape = tuple(leaf.shape)
        cands = rules.param_candidates(_leaf_name(path), shape, mv.tensor_axes,
                                       family=cfg.family)
        hit = first_legal(shape, cands, mv)
        spec = spec_from_placements(shape, [hit] if hit else [])
        validate_spec(shape, spec, mv)
        specs[path] = spec
    return _tree_of(specs)


def sharded_byte_fraction(cfg: ModelConfig, mesh) -> float:
    """Fraction of parameter bytes with at least one sharded dim (the
    policy's effectiveness metric; the paper's Eq. 1 efficiency analogue).
    """
    from repro_torch.models import lm

    specs = dict(leaves_with_paths(param_specs(cfg, mesh)))
    total = sharded = 0
    for path, leaf in leaves_with_paths(lm.abstract_params(cfg).tree()):
        nbytes = leaf.numel() * leaf.element_size()
        total += nbytes
        if any(e is not None for e in specs[path]):
            sharded += nbytes
    return sharded / max(total, 1)


# --------------------------------------------------------------------------
# Batch / token
# --------------------------------------------------------------------------


def _batch_placement(mv: MeshView, global_batch: int) -> tuple[str, ...]:
    """DP axes for the batch dim: the longest suffix-aligned run of batch
    axes whose product divides ``global_batch`` (replicate when none)."""
    return largest_dividing_suffix(mv, mv.batch_axes, global_batch)


def batch_specs(cfg: ModelConfig, mesh, global_batch: int) -> dict[str, PartitionSpec]:
    """Specs for the train/prefill batch leaves.

    Batch-region only: activations shard over ('pod', 'data'); combining
    both DP axes in one dim entry is legal (same region); the tensor axis
    never appears.
    """
    mv = MeshView.of(mesh)
    ba = _batch_placement(mv, global_batch)

    def batch_leaf(ndim: int) -> PartitionSpec:
        shape = (global_batch,) + (1,) * (ndim - 1)
        spec = spec_from_placements(shape, [(0, ba)] if ba else [])
        validate_spec(shape, spec, mv)
        return spec

    out = {"tokens": batch_leaf(2), "labels": batch_leaf(2)}
    for name, rest in modality_batch_leaves(cfg).items():
        out[name] = batch_leaf(1 + len(rest))
    return out


def token_spec(cfg: ModelConfig, mesh, global_batch: int) -> PartitionSpec:
    """Spec for the (B, 1) decode token."""
    mv = MeshView.of(mesh)
    ba = _batch_placement(mv, global_batch)
    return spec_from_placements((global_batch, 1), [(0, ba)] if ba else [])


# --------------------------------------------------------------------------
# Decode cache
# --------------------------------------------------------------------------


def cache_specs(
    cfg: ModelConfig, mesh, global_batch: int, seq_len: int, *, cache=None
) -> dict[str, PartitionSpec]:
    """Specs for every decode-state leaf of ``lm.init_cache``.

    Completeness is structural: the cache is built on the ``meta`` device
    (no allocation; pass an already-built ``cache`` to skip that) and
    every leaf gets a spec. The enc-dec family's decode state adds its
    cross-attention caches ``cross_k`` / ``cross_v`` (L, B, F, Hkv, D), as
    ``encdec.init_decode_state`` does. Attention caches shard batch over
    DP and KV heads over TP (head_dim when heads don't divide); SSM state
    shards its head dim; the scalar ``len`` replicates.
    """
    from repro_torch.models import lm

    mv = MeshView.of(mesh)
    ba = _batch_placement(mv, global_batch)
    if cache is None:
        cache = lm.init_cache(cfg, global_batch, seq_len, device="meta")
    if cfg.family == "encdec":
        from repro_torch.models.encdec import with_cross_caches

        cache = with_cross_caches(cache, cfg, global_batch)

    out: dict[str, PartitionSpec] = {}
    for name, leaf in cache.items():
        shape = tuple(leaf.shape)
        placements = []
        # batch dim: every cache leaf of rank >= 2 carries batch at dim 1
        if len(shape) >= 2 and ba and shape[1] % math.prod(mv.shape[a] for a in ba) == 0:
            placements.append((1, ba))
        hit = first_legal(shape, rules.cache_candidates(name, shape, mv.tensor_axes), mv)
        if hit:
            placements.append(hit)
        spec = spec_from_placements(shape, placements)
        validate_spec(shape, spec, mv)
        out[name] = spec
    return out
