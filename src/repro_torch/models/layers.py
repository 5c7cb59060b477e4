"""Shared layers: RMSNorm, RoPE, SwiGLU, embeddings, projections.

Port of ``repro.models.layers``: the serving subset and the training
losses. Plain matmuls go to ``torch.matmul``; packed FFN weights go
through ``models.lm.packed_dense``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
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


def spread(x: torch.Tensor) -> bool:
    """Whether ``x`` is a ``DTensor`` over a mesh of more than one rank
    (where ``DTensor`` needs another formulation of an op; on one rank the
    plain op runs, and the walk reads what it reads on a plain tensor)."""
    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def shard_whole(x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` as it is, unless it is a ``DTensor`` whose dim ``dim`` is
    sharded over mesh dims whose product ``parts`` does not divide: then
    those mesh dims are gathered, so each shard holds whole parts (a head,
    a KV group), the replication GSPMD falls back to there."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    pl, n = list(x.placements), 1
    for i, (p, size) in enumerate(zip(pl, x.device_mesh.shape)):
        if isinstance(p, Shard) and p.dim == dim:
            if parts % (n * size):
                pl[i] = Replicate()
            else:
                n *= size
    return x.redistribute(x.device_mesh, pl)


def split_heads(x: torch.Tensor, heads: int, dim: int) -> torch.Tensor:
    """(..., heads * dim) -> (..., heads, dim), a ``DTensor``'s shards
    holding whole heads (``shard_whole``)."""
    x = shard_whole(x, -1, heads)
    return x.reshape(*x.shape[:-1], heads, dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., heads, dim) -> (..., heads * dim). A ``DTensor`` split on its
    last dim (split-d decode's output) is gathered there first: a flat
    (heads * dim) dim cannot hold a shard of each head."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        pl = [Replicate() if p.is_shard(last) else p for p in x.placements]
        x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ w: (K, N) in the compute dtype of x; over ``DTensor``s
    on the local shards, placed as the weight's sharding asks
    (``kernels.ops.sharded_matmul``)."""
    if isinstance(w, DTensor):
        from repro_torch.kernels.ops import sharded_matmul

        return sharded_matmul(torch.matmul, x, w.to(x.dtype))
    return torch.matmul(x, w.to(x.dtype))


def swiglu(x, w1, w3, w2):
    h = F.silu(dense(x, w1)) * dense(x, w3)
    return dense(h, w2)


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype) -> torch.Tensor:
    """The table's rows of ``tokens`` in ``dtype``: an index; over a
    ``DTensor`` table on a mesh of several ranks ``F.embedding``, whose
    sharding strategy (a vocab-sharded table gives a masked partial
    lookup) and backward ``DTensor`` registers, its rows then reduced
    and laid out as the tokens are (the rest replicated)."""
    if spread(table):
        rows = F.embedding(tokens.long(), table)
        pl = [p if isinstance(tokens, DTensor) and p.is_shard() else Replicate()
              for p in (tokens.placements if isinstance(tokens, DTensor) else rows.placements)]
        return rows.redistribute(table.device_mesh, pl).to(dtype)
    return table[tokens.long()].to(dtype)


def logits(x: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Tied/untied unembedding; padded vocab columns masked to -1e30."""
    out = dense(x, table.t()).to(torch.float32)
    pv = table.shape[0]
    if pv > vocab and spread(out):  # a slice of vocab-sharded logits would gather them
        return torch.where(torch.arange(pv, device=out.device) < vocab, out, -1e30)
    if pv > vocab:
        out[..., vocab:] = -1e30
    return out


def _pick(t: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``t[..., labels]`` along the last dim: a gather, or over a
    ``DTensor`` whose last dim is split (vocab-sharded logits) the
    reference's masked reduction (iota == label), a partial sum that
    reduces without gathering the logits. The value is the same."""
    if isinstance(t, DTensor) and any(
            p.is_shard(t.dim() - 1) and n > 1 for p, n in zip(t.placements, t.device_mesh.shape)):
        col = torch.arange(t.shape[-1], device=t.device)
        return torch.sum(torch.where(col == labels.long()[..., None], t, 0.0), dim=-1)
    return torch.gather(t, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logit: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean next-token CE over all positions; logit (..., V), labels (...).
    Over a ``DTensor`` spread over ranks the log-softmax is written out as
    max and sum reductions, which run on vocab shards (``DTensor``'s
    softmax gathers the vocab)."""
    if spread(logit):
        m = torch.amax(logit, dim=-1, keepdim=True)
        logp = logit - (m + torch.log(torch.sum(torch.exp(logit - m), dim=-1, keepdim=True)))
    else:
        logp = torch.log_softmax(logit, dim=-1)
    return -torch.mean(_pick(logp, labels))


def _chunk_nll(xi: torch.Tensor, li: torch.Tensor, table: torch.Tensor, vocab: int) -> torch.Tensor:
    """Summed CE of one chunk: xi (B, c, d), li (B, c)."""
    lg = dense(xi, table.t()).to(torch.float32)
    pv = table.shape[0]
    if pv > vocab:
        col = torch.arange(pv, device=lg.device)
        lg = torch.where(col < vocab, lg, torch.full_like(lg, -1e30))
    m = torch.amax(lg, dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lg - m), dim=-1))
    return torch.sum(lse - _pick(lg, li))


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
    a gather on plain tensors, the reference's masked reduction on
    ``DTensor``s (``_pick``)."""
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
