"""``packed_matmul``: matmul against 1/2-bit packed weights on Hopper.

Replaces the TPU kernel ``src/repro/kernels/packed_matmul.py::packed_matmul``
(``_packed_matmul_kernel``, ``_decode_block``) with the hand-written CUDA
kernel ``csrc/packed_matmul.cu``. What bounds it on the H100: at decode M
is the lane count, so it moves the uint8 carrier (0.6 MB for 960x2560 at
2 bits, ~0.2 us at 3.35 TB/s) and is launch-bound; at prefill it is bound
by operations. The design reads the carrier straight from device memory
and decodes it in registers next to the multiply-add, so the decoded
weight never reaches device memory (the paper's 8x/16x fewer weight
bytes). A GEMV-shaped path serves M <= 16, a shared-memory tiled path
the rest; both mask ragged M/N edges themselves.

On a CPU tensor the wrapper runs the plain version (``ref.packed_matmul_ref``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_matmul_ref

COUNTER = _build.LaunchCounter()
BITS = (1, 2)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P]


def _check(x, carrier, scale, bits: int, k: int) -> None:
    if bits not in BITS:
        raise ValueError(f"packed_matmul takes bits in {BITS}, got {bits}")
    per = 8 // bits
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if k % per:
        raise ValueError(f"K={k} is not a multiple of 8/bits={per}")
    if carrier.dtype != torch.uint8 or carrier.dim() != 2 or carrier.shape[0] != k // per:
        raise ValueError(
            f"carrier must be uint8 ({k // per}, N), got {carrier.dtype} "
            f"{tuple(carrier.shape)}"
        )
    n = carrier.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be float32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == carrier.device == scale.device):
        raise ValueError("x, carrier and scale must be on one device")


def packed_matmul(
    x: torch.Tensor, carrier: torch.Tensor, scale: torch.Tensor, bits: int, k: int
) -> torch.Tensor:
    """out[m, n] = (x[m] . decode(carrier)[:, n]) * scale[n], f32 (M, N).

    x: (M, K) f32/bf16; carrier: (K*bits/8, N) uint8; scale: (N,) f32.
    """
    _check(x, carrier, scale, bits, k)
    if x.device.type == "cpu":
        return packed_matmul_ref(x, carrier, scale, bits, k)
    if x.device.type != "cuda":
        raise ValueError(f"packed_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and carrier.is_contiguous() and scale.is_contiguous()):
        raise ValueError("packed_matmul needs contiguous x, carrier and scale")
    m, n = x.shape[0], carrier.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load("packed_matmul", "packed_matmul_launch", _ARGTYPES)
    rc = lib.packed_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), carrier.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, k, n, bits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "packed_matmul")
    COUNTER.count += 1
    return out
