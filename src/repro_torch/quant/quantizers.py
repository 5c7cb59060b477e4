"""Quantizers and bit packing: the port of ``repro.quant.quantizers``.

The forward quantizers of the paper's QAT graph (§III-A): binary /
ternary / int-N weights through a straight-through estimator, and LSQ
learned-scale activations. Their values equal the reference's: ``_ste``
is ``x + (q - x).detach()`` (not ``q``: the two differ by an ulp, and the
streamlined path's weight magnitude sees it), binary maps 0 to +1, and
``torch.round`` rounds half to even as ``jnp.round`` does. Their
gradients equal the reference's too: ``_ste``'s backward is the identity,
and LSQ is an autograd Function with the Esser et al. backward of the
reference's ``custom_vjp``.

Bit packing is the carrier format of the packed-weight kernels. Weight
``k = i*per + j`` (``per = 8 // bits``) sits in carrier row ``i`` at bit
offset ``j*bits``. Besides the reference's 1/2/4 bits, 8 bits is accepted
(one code per byte), so ``ops.pack_weights`` covers every width
``kernels.ref.decode_weights`` decodes.
"""

from __future__ import annotations

import math

import torch

_BITS = (1, 2, 4, 8)


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward ``x + (q - x)``, backward identity."""
    return x + (q - x).detach()


class _LSQ(torch.autograd.Function):
    """LSQ with the Esser et al. gradient (the reference's ``_lsq_fwd`` /
    ``_lsq_bwd``): dx passes where -qn <= x/s <= qp; ds sums
    g * (inside ? q - v : q) over every element, times 1/sqrt(n * qp)."""

    @staticmethod
    def forward(ctx, x, scale, qn: int, qp: int):
        s = torch.clamp(scale.to(x.dtype), min=1e-8)
        v = x / s
        q = torch.clamp(torch.round(v), -qn, qp)
        ctx.save_for_backward(v, q)
        ctx.qn, ctx.qp = qn, qp
        ctx.scale_shape, ctx.scale_dtype = scale.shape, scale.dtype
        return q * s

    @staticmethod
    def backward(ctx, g):
        v, q = ctx.saved_tensors
        inside = (v >= -ctx.qn) & (v <= ctx.qp)
        dx = torch.where(inside, g, torch.zeros_like(g))
        ds_elem = torch.where(inside, q - v, q)
        gscale = 1.0 / math.sqrt(max(1, v.numel()) * max(1, ctx.qp))
        ds = (torch.sum(g * ds_elem) * gscale).to(ctx.scale_dtype)
        return dx, ds.reshape(ctx.scale_shape), None, None


def lsq_quantize(x: torch.Tensor, scale, qn: int, qp: int) -> torch.Tensor:
    """LSQ: q = clip(round(x/s), -qn, qp) * s, s = max(scale, 1e-8), with
    the Esser et al. gradient in x and in ``scale``."""
    scale = torch.as_tensor(scale, device=x.device)
    if not scale.is_floating_point():
        scale = scale.to(x.dtype)
    return _LSQ.apply(x, scale, qn, qp)


def int_act(x: torch.Tensor, scale, bits: int, signed: bool = True) -> torch.Tensor:
    """LSQ-quantized activation (2-bit / 4-bit in the paper)."""
    if signed:
        qn, qp = 2 ** (bits - 1), 2 ** (bits - 1) - 1
    else:
        qn, qp = 0, 2**bits - 1
    return lsq_quantize(x, scale, qn, qp)


def init_act_scale(bits: int = 2, device=None) -> torch.Tensor:
    """LSQ init ~ 2<|x|>/sqrt(qp); a constant, as in the reference."""
    return torch.tensor(2.0 / math.sqrt(2 ** (bits - 1) - 0.5), dtype=torch.float32,
                        device=device)


def _out_axes(w: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(w.dim() - 1))  # every axis but the last (out channels)


def binary_weight(w: torch.Tensor) -> torch.Tensor:
    """1-bit: sign(w) * E|w| per output channel, with sign(0) = +1."""
    alpha = torch.mean(torch.abs(w), dim=_out_axes(w), keepdim=True)
    q = torch.where(w >= 0, 1.0, -1.0).to(w.dtype) * alpha
    return _ste(w, q)


def ternary_weight(w: torch.Tensor, delta_frac: float = 0.7) -> torch.Tensor:
    """2-bit ternary (Li et al.): t = 0.7*E|w|, levels {-a, 0, +a}."""
    axes = _out_axes(w)
    mean_abs = torch.mean(torch.abs(w), dim=axes, keepdim=True)
    mask = (torch.abs(w) > delta_frac * mean_abs).to(w.dtype)
    alpha_num = torch.sum(torch.abs(w) * mask, dim=axes, keepdim=True)
    alpha = alpha_num / torch.clamp(torch.sum(mask, dim=axes, keepdim=True), min=1.0)
    return _ste(w, torch.sign(w) * mask * alpha)


def int_weight(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric signed int-N weights (first/last layers, 8-bit)."""
    qp = 2 ** (bits - 1) - 1
    s = torch.amax(torch.abs(w), dim=_out_axes(w), keepdim=True) / qp
    s = torch.clamp(s, min=1e-8)
    return _ste(w, torch.clamp(torch.round(w / s), -qp - 1, qp) * s)


def quantize_weight(w: torch.Tensor, w_bits: int) -> torch.Tensor:
    if w_bits == 1:
        return binary_weight(w)
    if w_bits == 2:
        return ternary_weight(w)
    return int_weight(w, w_bits)


def pack_bits(q_codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer codes in [0, 2^bits) along axis 0 into a uint8 carrier.

    Axis 0 (the reduction dim) must be a multiple of ``8 // bits``.
    """
    if bits not in _BITS:
        raise ValueError(f"bits must be one of {_BITS}, got {bits}")
    per = 8 // bits
    k = q_codes.shape[0]
    if k % per:
        raise ValueError(f"reduction dim {k} not a multiple of {per}")
    q = q_codes.to(torch.uint8).reshape((k // per, per) + tuple(q_codes.shape[1:]))
    out = torch.zeros_like(q[:, 0])
    for j in range(per):
        out |= q[:, j] << (j * bits)
    return out


def unpack_bits(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack_bits``: uint8 carrier -> integer codes, axis 0."""
    if bits not in _BITS:
        raise ValueError(f"bits must be one of {_BITS}, got {bits}")
    per = 8 // bits
    shifts = (
        torch.arange(per, dtype=torch.uint8, device=packed.device) * bits
    ).reshape((1, per) + (1,) * (packed.dim() - 1))
    mask = (1 << bits) - 1
    codes = (packed.unsqueeze(1) >> shifts) & mask
    out = codes.reshape((packed.shape[0] * per,) + tuple(packed.shape[1:]))
    return out[:k]


def codes_from_binary(w_sign: torch.Tensor) -> torch.Tensor:
    """{-1,+1} -> {0,1} codes."""
    return (w_sign > 0).to(torch.uint8)


def binary_from_codes(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * 2.0 - 1.0


def codes_from_ternary(w_tern: torch.Tensor) -> torch.Tensor:
    """{-1,0,+1} -> {0,1,2} codes (2-bit)."""
    return (w_tern + 1).to(torch.uint8)


def ternary_from_codes(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) - 1.0
