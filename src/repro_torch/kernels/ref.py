"""Plain PyTorch versions of the port's kernels.

Ports of ``repro.kernels.ref``. The wrappers take these for tensors on the
CPU (the tests), and ``chip_smoke.py`` holds each CUDA kernel against them
on the card. They repeat the kernels' arithmetic in f32 and are no
yardstick of speed.
"""

from __future__ import annotations

import math

import torch

from repro_torch.quant.quantizers import unpack_bits

NEG_INF = -1e30


def decode_weights(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """uint8 carrier -> f32 weight values.

    bits=1: codes {0,1} -> {-1,+1};  bits=2: codes {0,1,2} -> {-1,0,+1};
    bits=4/8: codes centred at 2^(bits-1).
    """
    codes = unpack_bits(packed, bits, k).to(torch.float32)
    if bits == 1:
        return codes * 2.0 - 1.0
    if bits == 2:
        return codes - 1.0
    return codes - float(2 ** (bits - 1))


def packed_matmul_ref(
    x: torch.Tensor, packed_w: torch.Tensor, scale: torch.Tensor, bits: int, k: int
) -> torch.Tensor:
    """Unpack, then a dense f32 matmul. x: (M, K); packed_w: (K*bits/8, N)
    uint8; scale: (N,). Returns (M, N) f32."""
    w = decode_weights(packed_w, bits, k)
    return (x.to(torch.float32) @ w) * scale[None, :].to(torch.float32)


def stream_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor | None,
    bits: int,
    k: int,
) -> torch.Tensor:
    """Plain version of ``stream_matmul``: decode the whole weight once,
    then one f32 matmul times the scale; the same arithmetic as
    ``packed_matmul_ref`` and the resident dense path, which is what keeps
    budgeted decode token-identical on the CPU.

    x: (M, K); w: (ceil(K*bits/8), N) uint8 carrier, or (K, N) float rows
    if bits=0; scale: (N,) or None (no scaling). Returns (M, N) f32.
    """
    vals = w.to(torch.float32) if bits == 0 else decode_weights(w, bits, k)
    out = x.to(torch.float32) @ vals
    if scale is None:
        return out
    return out * scale[None, :].to(torch.float32)


def mvau_ref(
    x: torch.Tensor,
    packed_w: torch.Tensor,
    thresholds: torch.Tensor,
    signs: torch.Tensor,
    offset: int,
    bits: int,
    k: int,
) -> torch.Tensor:
    """Plain version of the fused MVAU: packed matmul, then integer
    thresholding. x: (M, K); packed_w: (ceil(K*bits/8), N) uint8;
    thresholds: (N, L) ascending per output channel; signs: (N,) in
    {-1,+1}. Returns int32 levels ``offset + #{l : sign*acc >= T_l}``."""
    acc = (x.to(torch.float32) @ decode_weights(packed_w, bits, k)) * signs[None, :]
    levels = (acc[..., None] >= thresholds[None, :, :]).sum(dim=-1, dtype=torch.int32)
    return levels + offset


def flash_fwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-softmax version of ``flash_fwd`` over the (B*H, S, D) layout.

    q: (BH, Sq, D); k/v: (BKV, Sk, D) with BH % BKV == 0; q row ``bh``
    reads kv row ``bh // (BH // BKV)``. Query ``i`` sits at position
    ``q_offset + i``; ``q_offset`` is an int or a one-element integer
    tensor on q's device, used on the device. Returns (out (BH, Sq, D) in q's dtype, lse (BH, Sq)
    f32); a row that sees no key gets out 0 and lse -1e30, as the kernel.
    """
    bh, sq, d = q.shape
    g = bh // k.shape[0]
    kf = k.to(torch.float32).repeat_interleave(g, dim=0)
    vf = v.to(torch.float32).repeat_interleave(g, dim=0)
    s = (q.to(torch.float32) @ kf.transpose(1, 2)) * (1.0 / math.sqrt(d))
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    ok = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = (p @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse


def _bwd_terms(q, k, v, lse, do, delta, causal, window, q_offset):
    """p and ds of the backward, f32, with k and v repeated to the q rows:
    p = exp(s - lse) on the visible pairs, masked before the exp (a row
    that saw no key has lse -1e30), 0 elsewhere; ds = p * (do.v - delta)
    * scale."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    g = bh // bkv
    scale = 1.0 / math.sqrt(d)
    kf = k.to(torch.float32).repeat_interleave(g, dim=0)
    vf = v.to(torch.float32).repeat_interleave(g, dim=0)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    s = (q.to(torch.float32) @ kf.transpose(1, 2)) * scale
    p = torch.exp(torch.where(ok, s - lse[..., None], torch.full_like(s, NEG_INF)))
    ds = p * (do.to(torch.float32) @ vf.transpose(1, 2) - delta[..., None]) * scale
    return p, ds, kf


def flash_bwd_dq_ref(
    q, k, v, out, lse, do, *, causal: bool = True, window: int = 0, q_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dq pass: (dq = ds @ k in q's dtype, delta = rowsum(do * out)
    (BH, Sq) f32, which the dk/dv pass reads)."""
    delta = torch.sum(do.to(torch.float32) * out.to(torch.float32), dim=-1)
    _, ds, kf = _bwd_terms(q, k, v, lse, do, delta, causal, window, q_offset)
    return (ds @ kf).to(q.dtype), delta


def flash_bwd_dkv_ref(
    q, k, v, do, lse, delta, *, causal: bool = True, window: int = 0, q_offset: int = 0
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv pass: dk = ds^T @ q and dv = p^T @ do per q row, summed
    over each GQA group of g = BH // BKV rows (what ``ops._fa_bwd`` does to
    the TPU kernel's per-q-head partials), in k's dtype."""
    bkv, sk, d = k.shape
    g = q.shape[0] // bkv
    p, ds, _ = _bwd_terms(q, k, v, lse, do, delta, causal, window, q_offset)
    dk = (ds.transpose(1, 2) @ q.to(torch.float32)).reshape(bkv, g, sk, d).sum(dim=1)
    dv = (p.transpose(1, 2) @ do.to(torch.float32)).reshape(bkv, g, sk, d).sum(dim=1)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense version of ``flash_bwd`` (both passes) over the (B*H, S, D)
    layout, in f32. q, out, do: (BH, Sq, D); k, v: (BKV, Sk, D); lse:
    (BH, Sq) f32 from the forward. Returns (dq in q's dtype, dk in k's
    dtype, dv in v's dtype), dk and dv summed over each GQA group."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq, delta = flash_bwd_dq_ref(q, k, v, out, lse, do, **kw)
    dk, dv = flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv
