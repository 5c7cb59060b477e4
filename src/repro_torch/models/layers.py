"""Shared layers: RMSNorm, RoPE, SwiGLU, embeddings, projections.

Port of ``repro.models.layers`` (the serving subset). Plain matmuls go to
``torch.matmul``; packed FFN weights go through ``models.lm.packed_dense``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * g.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    # a Python-float base: a tensor base would be a host-to-device copy,
    # which blocks the host on every call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (float(theta) ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) in the compute dtype of x."""
    return torch.matmul(x, w.to(x.dtype))


def swiglu(x, w1, w3, w2):
    h = F.silu(dense(x, w1)) * dense(x, w3)
    return dense(h, w2)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Tied/untied unembedding; padded vocab columns masked to -1e30."""
    out = torch.matmul(x, table.to(x.dtype).t()).to(torch.float32)
    pv = table.shape[0]
    if pv > vocab:
        out[..., vocab:] = -1e30
    return out
