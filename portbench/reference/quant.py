"""The configuration's weight quantizer, and the lower precision of the
control, in plain PyTorch.

``ternary_2bit`` is the 2-bit FFN quantizer as the configuration states it:
per output column of a (K, N) bfloat16 weight, the threshold is 0.7 times
the column's mean |w|, the weights above it keep their sign, and the scale
is the mean |w| of the kept weights. The column mean, the threshold and the
kept sum are rounded to bfloat16, as the stated quantizer computes them
in the weight's dtype; the sums here are taken in float64 first.

``fp8_matmul`` is the control's product: both operands rounded to float8
e4m3, the activation with one scale a row and the weight one a column (the
amax over 448), the product taken in float32.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def ternary_2bit(w: torch.Tensor) -> torch.Tensor:
    """The dequantized float32 (K, N) of a (K, N) weight; the column mean,
    threshold and kept sum are rounded to the weight's dtype."""
    a = w.abs()
    mean = a.to(torch.float64).mean(dim=0).to(w.dtype)
    thr = (mean.to(torch.float32) * torch.tensor(0.7, dtype=torch.float32)).to(w.dtype)
    keep = a > thr
    kept_sum = (a.to(torch.float64) * keep).sum(dim=0).to(w.dtype)
    count = keep.sum(dim=0).clamp(min=1).to(torch.float32)
    scale = kept_sum.to(torch.float32) / count
    return torch.sign(w.to(torch.float32)) * keep * scale


def fp8_round(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` (float32) rounded to e4m3 with one scale per slice along
    ``dim`` (the amax over 448), returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N), both rounded to e4m3 first."""
    return fp8_round(x, -1) @ fp8_round(w, 0)
