"""Carry the reference's weights into the port.

``params_from_reference`` takes the JAX package's LM parameter pytree with
numpy leaves (the caller runs ``jax.tree.map(np.asarray, params)``) and
returns the port's ``LMParams``: stacked ``(L, ...)`` leaves (the SSM
family's Mamba2 leaves among them), the hybrid's ``shared`` block, the
enc-dec's ``enc_layers`` and packed ``{"packed", "scale"}`` dicts carry
over byte for byte.
``cnn_params_from_reference`` does the same for the CNN's
``{layer: {w, bn_*, act_scale}}`` tree. ``jax.random``
initialisation cannot be reproduced in torch, so this is how parity tests
give both packages identical weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LMParams

# leaves that stay f32 whatever the model dtype (norm gains, packed scales,
# the MoE router and the Mamba2 leaves the reference keeps in f32)
F32_LEAVES = ("ln1", "ln2", "ln_x", "final_norm", "enc_final_norm", "scale", "router",
              "dt_bias", "a_log", "d_skip", "gate_norm")


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _convert(tree: dict[str, Any], device, dtype) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _convert(leaf, device, dtype)
            continue
        t = _tensor(leaf)
        if dtype is not None and t.is_floating_point() and name not in F32_LEAVES:
            t = t.to(dtype)
        out[name] = t.to(device)
    return out


def params_from_reference(
    tree: dict[str, Any],
    cfg: ModelConfig,
    device: str | torch.device,
    dtype: torch.dtype | None = None,
    trainable: bool = False,
) -> LMParams:
    """The reference's parameter tree (numpy or torch leaves) as
    ``LMParams`` on ``device``. ``dtype`` casts the float weight leaves
    (not the f32 norm gains and packed scales); None keeps every leaf's
    own dtype, so the bytes carry over unchanged. ``trainable`` makes the
    float leaves require gradients."""
    if "layers" not in tree or not isinstance(tree["layers"], dict):
        raise ValueError("expected the reference's tree with stacked 'layers'")
    if cfg.family == "ssm":  # Mamba2 layers only: no FFN to check
        return LMParams(_convert(tree, device, dtype), trainable)
    # the hybrid's FFN is its shared block's, the enc-dec's both stacks';
    # MoE experts are dense at any w_bits (the reference never packs them)
    ffns = {"hybrid": ("shared",), "encdec": ("layers", "enc_layers")}.get(
        cfg.family, ("layers",))
    want_packed = cfg.w_bits in (1, 2) and cfg.family != "moe"
    for ffn in ffns:
        if not isinstance(tree.get(ffn), dict):
            raise ValueError(f"expected the reference's {cfg.family} tree with '{ffn}'")
        for name in ("w1", "w3", "w2"):
            packed = isinstance(tree[ffn].get(name), dict)
            if packed != want_packed:
                raise ValueError(
                    f"{ffn}/{name} is {'packed' if packed else 'dense'} but "
                    f"cfg.w_bits is {cfg.w_bits} (family {cfg.family!r})"
                )
    return LMParams(_convert(tree, device, dtype), trainable)


def params_from_checkpoint(
    root: str,
    cfg: ModelConfig,
    device: str | torch.device,
    step: int | None = None,
    trainable: bool = False,
) -> LMParams:
    """The parameters of a checkpoint of ``(params, opt_state)`` that
    either package's ``CheckpointManager`` wrote under ``root`` (its
    ``0/...`` leaves; the newest step unless ``step`` is given), as
    ``LMParams`` on ``device``, byte for byte."""
    from repro_torch.ckpt.manager import CheckpointManager

    values, _ = CheckpointManager(root).read(step)
    tree: dict[str, Any] = {}
    for key, arr in values.items():
        parts = key.split("/")
        if parts[0] != "0":
            continue
        node = tree
        for name in parts[1:-1]:
            node = node.setdefault(name, {})
        node[parts[-1]] = arr
    if not tree:
        raise ValueError(f"no parameter leaves (0/...) in the checkpoint under {root}")
    return params_from_reference(tree, cfg, device, trainable=trainable)


def params_to_reference(params: LMParams) -> dict[str, Any]:
    """The port's parameters as the reference's tree of numpy arrays (bf16
    leaves as ml_dtypes' bfloat16, which the reference's environment has),
    ready for its ``lm`` functions and ``CheckpointManager``."""

    def conv(leaf):
        if isinstance(leaf, dict):
            return {k: conv(v) for k, v in leaf.items()}
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return conv(params.tree())


CNN_LEAVES = ("w", "bn_gamma", "bn_beta", "bn_mu", "bn_var", "act_scale")


def cnn_params_from_reference(
    tree: dict[str, Any], device: str | torch.device
) -> dict[str, dict[str, torch.Tensor]]:
    """The reference's CNN parameters ``{layer: {w (HWIO), bn_gamma,
    bn_beta, bn_mu, bn_var, act_scale}}`` (numpy or torch leaves) as the
    port's, on ``device``, byte for byte."""
    out = {}
    for layer, leaves in tree.items():
        if not isinstance(leaves, dict) or set(leaves) != set(CNN_LEAVES):
            got = sorted(leaves) if isinstance(leaves, dict) else type(leaves).__name__
            raise ValueError(f"layer {layer!r}: expected leaves {CNN_LEAVES}, got {got}")
        out[layer] = {name: _tensor(a).to(device) for name, a in leaves.items()}
    return out
