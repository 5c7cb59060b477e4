"""FINN streamlining: fold BatchNorm + quantized activation into integer
thresholds (paper §III-B). The port of ``repro.quant.streamline``.

A streamlined MVAU computes ``o = sum_k [acc >= T_k]`` on the raw
accumulator instead of ``quant_act(BN(acc))``. The A-bit activation maps z
to level l when z crosses ``t_l = s * (l - 2^(A-1) + 0.5)``; with
``z = gamma * (acc - mu) / sigma + beta`` the accumulator-domain threshold
is ``T_l = (t_l - beta) * sigma / gamma + mu`` for gamma > 0, and the
comparison flips for gamma < 0, which is normalised by negating both the
accumulator and the thresholds (FINN's sign canonicalisation).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ThresholdSpec:
    """Per-channel thresholds: shape (channels, n_levels-1), ascending."""

    thresholds: torch.Tensor
    signs: torch.Tensor  # +1/-1 per channel (gamma sign canonicalisation)
    offset: float  # output integer offset (signed representation)
    scale: torch.Tensor  # activation scale s (to map level -> value)


def act_level_thresholds(scale: torch.Tensor, bits: int, signed: bool = True):
    """Activation-domain decision boundaries of an LSQ-style quantizer:
    (boundaries, integer offset of the lowest level)."""
    scale = torch.as_tensor(scale, dtype=torch.float32)
    if signed:
        levels = torch.arange(-(2 ** (bits - 1)) + 1, 2 ** (bits - 1),
                              dtype=torch.float32, device=scale.device)
        offset = -(2 ** (bits - 1))
    else:
        levels = torch.arange(1, 2**bits, dtype=torch.float32, device=scale.device)
        offset = 0
    # round-to-nearest: the boundary between l-1 and l sits at (l - 0.5) * s
    return (levels - 0.5) * scale, float(offset)


def bn_act_to_thresholds(
    gamma, beta, mu, var, act_scale, bits: int, eps: float = 1e-5
) -> ThresholdSpec:
    """Fold BN(gamma, beta, mu, var) + quant-act(scale, bits) into thresholds."""
    gamma = torch.as_tensor(gamma)
    sigma = torch.sqrt(torch.as_tensor(var) + eps)
    scale = torch.as_tensor(act_scale, dtype=torch.float32, device=gamma.device)
    t_act, offset = act_level_thresholds(scale, bits)
    t_act = t_act.expand(gamma.shape[0], t_act.shape[-1])  # (C, L)
    safe_gamma = torch.where(torch.abs(gamma) < 1e-12, torch.full_like(gamma, 1e-12), gamma)
    T = (t_act - beta[:, None]) * (sigma / safe_gamma)[:, None] + mu[:, None]
    signs = torch.where(gamma >= 0, 1.0, -1.0).to(gamma.dtype)
    # canonicalise: for gamma < 0 the comparison flips; store ascending
    T = torch.where(signs[:, None] > 0, T, -T)
    T = torch.sort(T, dim=1).values
    return ThresholdSpec(T, signs, offset, scale)


def thresholding_int(acc: torch.Tensor, spec: ThresholdSpec) -> torch.Tensor:
    """Integer levels ``offset + sum_k [sign*acc >= T_k]`` (int32), what the
    FPGA datapath carries. ``acc``: (..., C) raw accumulator."""
    x = acc * spec.signs
    return (x[..., None] >= spec.thresholds).sum(dim=-1, dtype=torch.int32) + int(spec.offset)


def thresholding(acc: torch.Tensor, spec: ThresholdSpec) -> torch.Tensor:
    """Quantized activation *value* (level * scale), drop-in for BN+act in
    the float graph."""
    return thresholding_int(acc, spec).to(acc.dtype) * spec.scale


def reference_bn_act(acc, gamma, beta, mu, var, act_scale, bits, eps=1e-5):
    """The unstreamlined graph: BN then round-to-nearest signed quant."""
    z = gamma * (acc - mu) / torch.sqrt(var + eps) + beta
    qn, qp = 2 ** (bits - 1), 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(z / act_scale), -qn, qp) * act_scale
