"""Bit packing: the carrier format of the packed-weight kernels.

Port of ``repro.quant.quantizers.pack_bits`` / ``unpack_bits`` on uint8
tensors. Weight ``k = i*per + j`` (``per = 8 // bits``) sits in carrier
row ``i`` at bit offset ``j*bits``. Besides the reference's 1/2/4 bits,
8 bits is accepted (one code per byte), so ``ops.pack_weights`` covers
every width ``kernels.ref.decode_weights`` decodes.
"""

from __future__ import annotations

import torch

_BITS = (1, 2, 4, 8)


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
