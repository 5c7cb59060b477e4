"""Shared layers: RMSNorm, RoPE, SwiGLU, embeddings, projections.

Port of ``repro.models.layers``: the serving subset and the training
losses. Plain matmuls go to ``torch.matmul``; packed FFN weights go
through ``models.lm.packed_dense``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


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


def cross_entropy(logit: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token CE over all positions; logit (..., V), labels (...)."""
    logp = torch.log_softmax(logit, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def _chunk_nll(xi: torch.Tensor, li: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Summed CE of one chunk: xi (B, c, d), li (B, c)."""
    lg = torch.matmul(xi, table.to(xi.dtype).t()).to(torch.float32)
    pv = table.shape[0]
    if pv > vocab:
        col = torch.arange(pv, device=lg.device)
        lg = torch.where(col < vocab, lg, torch.full_like(lg, -1e30))
    m = torch.amax(lg, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lg - m), dim=-1))
    picked = torch.gather(lg, -1, li.long()[..., None])[..., 0]
    return torch.sum(lse - picked)


def chunked_softmax_xent(
    x: torch.Tensor,
    table: torch.Tensor,
    labels: torch.Tensor,
    vocab: int,
    chunk: int = 512,
) -> torch.Tensor:
    """Fused unembed + CE over sequence chunks: the live logits buffer is
    (B, chunk, V), and each chunk is recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    inside its scan). x: (B, S, d) final hidden states; table: (V_padded,
    d); labels: (B, S). Returns the mean CE. Falls back to one chunk when
    ``chunk`` does not divide S, as the reference does. The label pick is
    a gather here (the reference's masked reduction exists for a
    vocab-sharded mesh; the value is the same)."""
    b, s, _ = x.shape
    c = min(chunk, s)
    if s % c != 0:
        c = s
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + checkpoint(
            _chunk_nll, x[:, i : i + c], labels[:, i : i + c], table, vocab,
            use_reentrant=False,
        )
    return total / (b * s)
