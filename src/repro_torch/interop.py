"""Carry the reference's weights into the port.

``params_from_reference`` takes the JAX package's LM parameter pytree with
numpy leaves (the caller runs ``jax.tree.map(np.asarray, params)``) and
returns the port's ``LMParams``: stacked ``(L, ...)`` leaves and packed
``{"packed", "scale"}`` dicts carry over byte for byte.
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

# leaves that stay f32 whatever the model dtype (norm gains, packed scales)
F32_LEAVES = ("ln1", "ln2", "final_norm", "scale")


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
) -> LMParams:
    """The reference's parameter tree (numpy or torch leaves) as
    ``LMParams`` on ``device``. ``dtype`` casts the float weight leaves
    (not the f32 norm gains and packed scales); None keeps every leaf's
    own dtype, so the bytes carry over unchanged."""
    if "layers" not in tree or not isinstance(tree["layers"], dict):
        raise ValueError("expected the reference's tree with stacked 'layers'")
    for name in ("w1", "w3", "w2"):
        packed = isinstance(tree["layers"].get(name), dict)
        if packed != (cfg.w_bits in (1, 2)):
            raise ValueError(
                f"layers/{name} is {'packed' if packed else 'dense'} but "
                f"cfg.w_bits is {cfg.w_bits}"
            )
    return LMParams(_convert(tree, device, dtype))


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
