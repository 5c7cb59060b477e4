"""Attention: the flash kernel for prompts, plain torch over pool rows
and per-slot caches.

Port of ``repro.models.attention``. ``flash_attention`` goes to
``kernels.ops.flash_attention`` (the CUDA kernel on the card, its plain
version on the CPU). ``decode_attention`` and ``chunk_attention`` attend
over rows gathered from the KV pool with a dense masked softmax in f32;
the reference has no Pallas kernel for them either. ``cache_insert``
writes a decode step's K/V row into a per-slot ring cache in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq % Hkv == 0; q_offset
    an int or a one-element int32 tensor on q's device. Returns (B, Sq,
    Hq, D)."""
    return ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cache_len: broadcastable to
    (B, 1), the current length (the new token sits at cache_len - 1).
    """
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(torch.float32)
    scores = torch.einsum(
        "bhgd,bshd->bhgs", qg, k_cache.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    valid = pos[None] < cache_len
    if window > 0:
        valid &= pos[None] > cache_len - 1 - window
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgs,bshd->bhgd", p.to(v_cache.dtype).to(torch.float32),
        v_cache.to(torch.float32),
    )
    return out.reshape(b, 1, hq, d).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,
    k_rows: torch.Tensor,
    v_rows: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Multi-token causal attention against gathered pool rows.

    q: (B, C, Hq, D); k_rows/v_rows: (B, S, Hkv, D) in logical order (row
    i holds position i); q_pos: (B, C) absolute positions of the chunk
    tokens. Rows past the chunk (scratch padding included) are masked by
    causality.
    """
    b, c, hq, d = q.shape
    _, s, hkv, _ = k_rows.shape
    g = hq // hkv
    qg = q.reshape(b, c, hkv, g, d).to(torch.float32)
    scores = torch.einsum(
        "bqhgd,bshd->bhgqs", qg, k_rows.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(s, device=q.device)
    valid = q_pos[:, :, None] >= k_pos[None, None, :]  # (B, C, S)
    if window > 0:
        valid &= q_pos[:, :, None] - k_pos[None, None, :] < window
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqs,bshd->bqhgd", p.to(v_rows.dtype).to(torch.float32),
        v_rows.to(torch.float32),
    )
    return out.reshape(b, c, hq, d).to(q.dtype)


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: int | torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, Hkv, D) into ``cache`` (B, W, Hkv, D) at ring
    position ``pos`` along dim 1, in place, and return ``cache`` (the
    reference's ``cache_insert`` rebuilds the array). ``pos`` is an int or
    a one-element integer tensor on the cache's device, clamped into the
    cache as ``dynamic_update_slice`` clamps it; a device tensor keeps a
    captured step's position out of its graph."""
    idx = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    idx = torch.clamp(idx, 0, cache.shape[1] - new.shape[1])
    return cache.index_copy_(1, idx, new.to(cache.dtype))
