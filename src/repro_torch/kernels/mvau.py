"""``mvau``: the fused MVAU (packed matmul + integer thresholding) on Hopper.

Replaces the TPU kernel ``src/repro/kernels/mvau.py::mvau``
(``_mvau_kernel``) with the hand-written CUDA kernel ``csrc/mvau.cu``. It
runs every 1/2-bit convolution and FC layer of the streamlined CNN path
(``models.cnn.conv_as_mvau``): the im2col columns times the packed
weights, then the folded BN + activation as a count of the ascending
thresholds each sign-canonicalised accumulator reaches. What bounds it on
the H100: the bytes of the f32 columns at the wide layers (M up to 200704
at batch 256) and, above them, the instruction throughput of the
multiply; the few output tiles of the narrow ones (M = 256). The kernel
multiplies on the tensor cores: each f32 value of x is split into
three bf16 parts whose sum is exactly x, each pass against the exact
-1/0/+1 weights accumulates in f32, and the f32 accumulator is thresholded
in registers, so only int32 levels reach device memory. Where the output
has too few 64x64 tiles for the card's SMs, ``split_plan`` splits the K
sweep over a thread-block cluster that sums its partial tiles in a fixed
order: one launch a layer. Ragged M, N and K are masked in the kernel, so
nothing is padded here.

On a CPU tensor the wrapper runs the plain version (``ref.mvau_ref``); on
a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import packed_matmul as _pm
from repro_torch.kernels.ref import mvau_ref

COUNTER = _build.LaunchCounter()
BITS = (1, 2)
MAX_LEVELS = 15  # thresholds per channel the kernel stages (4-bit activations)
# the kernel's output tile and K step (csrc/mvau.cu)
BM, BN, BK = 64, 64, 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]


def split_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, K steps per split) of the kernel's K sweep: ``packed_matmul``'s
    plan over this kernel's 64x64 tiles and 32-deep steps. CNV's narrow
    layers at batch 256 (conv5, fc0, fc1: 16-32 tiles) get 4-8 splits, at
    least 128 blocks for 132 SMs; the wide ones are not split."""
    return _pm.split_plan(m, k, n, sms, bm=BM, bn=BN, bk=BK)


def _check(x, carrier, thresholds, signs, bits: int, k: int) -> None:
    if bits not in BITS:
        raise ValueError(f"mvau takes bits in {BITS}, got {bits}")
    if x.dim() != 2 or x.shape[1] != k or k < 1:
        raise ValueError(f"x must be (M, {k}) with K >= 1, got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    rows = -(-k // (8 // bits))
    if carrier.dtype != torch.uint8 or carrier.dim() != 2 or carrier.shape[0] != rows:
        raise ValueError(
            f"carrier must be uint8 ({rows}, N), got {carrier.dtype} {tuple(carrier.shape)}"
        )
    n = carrier.shape[1]
    if (thresholds.dtype != torch.float32 or thresholds.dim() != 2
            or thresholds.shape[0] != n or not 1 <= thresholds.shape[1] <= MAX_LEVELS):
        raise ValueError(
            f"thresholds must be float32 ({n}, L) with 1 <= L <= {MAX_LEVELS}, got "
            f"{thresholds.dtype} {tuple(thresholds.shape)}"
        )
    if signs.dtype != torch.float32 or tuple(signs.shape) != (n,):
        raise ValueError(f"signs must be float32 ({n},), got {signs.dtype} {tuple(signs.shape)}")
    if len({x.device, carrier.device, thresholds.device, signs.device}) != 1:
        raise ValueError("x, carrier, thresholds and signs must be on one device")


@_build.reports_work("mvau", lambda x, carrier, thresholds, signs, bits, k, offset=0:
                     2.0 * x.shape[0] * k * carrier.shape[1])
def mvau(
    x: torch.Tensor,
    carrier: torch.Tensor,
    thresholds: torch.Tensor,
    signs: torch.Tensor,
    bits: int,
    k: int,
    offset: int = 0,
) -> torch.Tensor:
    """out[m, n] = offset + #{l : signs[n] * (x[m] . decode(carrier)[:, n]) >=
    thresholds[n, l]}, int32 (M, N).

    x: (M, K) f32; carrier: (ceil(K*bits/8), N) uint8; thresholds: (N, L)
    f32 ascending, 1 <= L <= 15; signs: (N,) f32 in {-1, +1}.
    """
    _check(x, carrier, thresholds, signs, bits, k)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], carrier.shape[1]), dtype=torch.int32, device="meta")
    if x.device.type == "cpu":
        return mvau_ref(x, carrier, thresholds, signs, offset, bits, k)
    if x.device.type != "cuda":
        raise ValueError(f"mvau runs on cuda or cpu, not {x.device}")
    if not all(t.is_contiguous() for t in (x, carrier, thresholds, signs)):
        raise ValueError("mvau needs contiguous x, carrier, thresholds and signs")
    m, n = x.shape[0], carrier.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    if n > 65535 * BN:
        raise ValueError(f"mvau's grid takes at most 65535 x {BN} columns, got N={n}")
    splits, cps = split_plan(m, k, n, _build.sm_count(x.device.index))
    lib = _build.load("mvau", "mvau_launch", _ARGTYPES)
    rc = lib.mvau_launch(
        x.data_ptr(), carrier.data_ptr(), thresholds.data_ptr(), signs.data_ptr(),
        out.data_ptr(), m, k, n, thresholds.shape[1], int(offset), bits, splits, cps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "mvau")
    COUNTER.add()
    return out
