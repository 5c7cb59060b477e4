"""Public entry points of the port's kernels.

Port of ``repro.kernels.ops`` for what the serve, train and CNN paths use. The CUDA
kernels mask their own ragged edges, so no block padding happens here;
these functions only flatten batch dims and lay out heads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mvau as _mvau
from repro_torch.kernels import packed_matmul as _pm
from repro_torch.kernels import weight_stream as _ws
from repro_torch.quant.quantizers import pack_bits


def packed_matmul(
    x: torch.Tensor, carrier: torch.Tensor, scale: torch.Tensor, *, bits: int, k: int
) -> torch.Tensor:
    """Batched packed matmul. x: (..., K); carrier: (K*bits/8, N); scale:
    (N,). Returns (..., N) f32."""
    lead = x.shape[:-1]
    out = _pm.packed_matmul(x.reshape(-1, k).contiguous(), carrier, scale, bits, k)
    return out.reshape(*lead, carrier.shape[1])


def stream_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor | None = None,
    *,
    bits: int = 0,
    k: int,
    stream_depth: int = 2,
) -> torch.Tensor:
    """Batched weight-streaming matmul. x: (..., K); w: (ceil(K*bits/8), N)
    uint8 carrier or (K, N) float rows (bits=0); scale: (N,) or None.
    Returns (..., N) f32. The kernel masks ragged K and N itself, so
    nothing is padded here."""
    lead = x.shape[:-1]
    out = _ws.stream_matmul(
        x.reshape(-1, k).contiguous(), w, scale, bits, k, stream_depth
    )
    return out.reshape(*lead, w.shape[1])


def mvau(
    x: torch.Tensor,
    carrier: torch.Tensor,
    thresholds: torch.Tensor,
    signs: torch.Tensor,
    *,
    bits: int,
    k: int,
    offset: int = 0,
) -> torch.Tensor:
    """Fused packed matmul + thresholding. x: (..., K), cast to f32 as the
    reference's kernel casts it; carrier: (ceil(K*bits/8), N); thresholds:
    (N, L); signs: (N,). Returns (..., N) int32 levels. The kernel masks
    ragged M, N and K itself, so nothing is padded here (the reference pads
    N with +inf thresholds and sign +1, and K with zeros)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).to(torch.float32).contiguous()
    out = _mvau.mvau(x2, carrier, thresholds, signs, bits, k, offset)
    return out.reshape(*lead, carrier.shape[1])


def pack_weights(w_values: torch.Tensor, bits: int) -> torch.Tensor:
    """Float weight values (K, N) -> uint8 carrier (K*bits/8, N), padding K
    to a byte boundary. Inverse of ``ref.decode_weights``."""
    per = 8 // bits
    k = w_values.shape[0]
    kp = -(-k // per) * per
    w = torch.cat([w_values, w_values.new_zeros((kp - k,) + tuple(w_values.shape[1:]))])
    if bits == 1:
        codes = (w > 0).to(torch.uint8)
    elif bits == 2:
        codes = (torch.sign(w) + 1).to(torch.uint8)
    else:
        codes = (torch.round(w) + 2 ** (bits - 1)).to(torch.uint8)
    return pack_bits(codes, bits)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``_fa`` custom VJP over the (B*H, S, D) layout:
    forward is ``flash_fwd``, saving (q, k, v, out, lse); backward is
    ``flash_bwd``, whose dk/dv pass already sums each GQA group (the
    reference's ``_fa_bwd`` sums the TPU kernel's per-q-head partials)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        out, lse = _fa.flash_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        # do arrives through the head transposes: the kernels read rows
        dq, dk, dv = _fa.flash_bwd(q, k, v, out, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """Flash attention, differentiable. q: (B, Sq, Hq, D); k/v: (B, Sk,
    Hkv, D); q_offset an int or a one-element int32 tensor on q's device
    (the forward only: the backward kernels take an int, so a tensor
    offset with inputs that need a gradient raises).

    Heads go to the kernels' (B*H, S, D) layout with row order b*H + h,
    which is what their GQA map (``bh // g``) expects. Returns (B, Sq, Hq,
    D); its gradient runs ``flash_bwd``'s two kernels.
    """
    if isinstance(q_offset, torch.Tensor) and torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise ValueError(
            "a tensor q_offset is forward-only (flash_bwd takes an int): pass "
            "an int where a gradient is needed, or run under torch.no_grad()"
        )
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(b * hq, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    out = _FlashAttention.apply(qf, kf, vf, causal, window, q_offset)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


_COUNTERS = {
    "packed_matmul": _pm.COUNTER,
    "flash_fwd": _fa.COUNTER,
    "flash_bwd_dq": _fa.DQ_COUNTER,
    "flash_bwd_dkv": _fa.DKV_COUNTER,
    "stream_matmul": _ws.COUNTER,
    "mvau": _mvau.COUNTER,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last ``reset_launch_counts``."""
    return {name: c.count for name, c in _COUNTERS.items()}


def launch_routes() -> dict[str, dict[str, int]]:
    """Launches by route since the last ``reset_launch_counts``, for the
    wrappers with several kernels (``packed_matmul``: gemv / mma /
    tiled_f32; ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``: mma / f32)."""
    return {name: dict(c.routes) for name, c in _COUNTERS.items() if c.routes}


_NONCAUSAL = {
    "flash_fwd": _fa.NONCAUSAL_COUNTER,
    "flash_bwd_dq": _fa.NONCAUSAL_DQ_COUNTER,
    "flash_bwd_dkv": _fa.NONCAUSAL_DKV_COUNTER,
}


def noncausal_flash_launches(name: str = "flash_fwd") -> dict[str, int]:
    """The launches of ``name`` (``flash_fwd``, ``flash_bwd_dq`` or
    ``flash_bwd_dkv``) with ``causal=False`` since the last
    ``reset_launch_counts``, by route (they are in ``launch_counts()``'s
    count of ``name`` too)."""
    return dict(_NONCAUSAL[name].routes)


def reset_launch_counts() -> None:
    for c in (*_COUNTERS.values(), *_NONCAUSAL.values()):
        c.count = 0
        c.routes.clear()
