"""``stream_matmul``: matmul with the weight streamed through a ring, on Hopper.

Replaces the TPU kernel ``src/repro/kernels/weight_stream.py::stream_matmul``
(``_stream_kernel``, ``_decode_chunk``) with the hand-written CUDA kernel
``csrc/weight_stream.cu``. It runs the FFN of every layer that budgeted
decode streams: the weight (a 1/2-bit uint8 carrier, or dense bf16/f32
rows for bits 0) is pulled from device memory K-chunk by K-chunk through
a ``stream_depth``-stage shared-memory ring filled by ``cp.async``, and
carrier codes are decoded in registers next to the multiply-add. What
bounds it on the H100: moving the weight (0.6 MB at 2 bits, 4.9 MB in
bf16 for 960x2560) and launch latency, since decode M is the lane count.
To fill the card's 132 SMs the K sweep is split across CTAs
(``split_plan``) and the partial sums are reduced in a fixed order by a
second kernel, ``split_reduce``: a split call launches two kernels, and
each has its own counter (``COUNTER``, ``REDUCE_COUNTER``).

On a CPU tensor the wrapper runs the plain version
(``ref.stream_matmul_ref``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stream_matmul_ref

COUNTER = _build.LaunchCounter()  # stream_kernel: one launch per call
REDUCE_COUNTER = _build.LaunchCounter()  # split_reduce: one per split call
BITS = (0, 1, 2)
MAX_DEPTH = 8  # cp.async.wait_group immediates the kernel dispatches on

# kernel geometry (csrc/weight_stream.cu): x rows and output columns per
# CTA, and weight storage rows per ring stage
MT, BN, ROWS = 8, 64, 32
X_SMEM_MAX = 64 * 1024  # bytes of one CTA's f32 x tile
CTAS_PER_SM = 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(m: int, k: int, n: int, bits: int, sms: int) -> tuple[int, int]:
    """(splits, chunks per split) of the K sweep.

    The weight has ``nk`` ring stages of ``ROWS`` storage rows. Without a
    split the grid is ``cdiv(n, BN) * cdiv(m, MT)`` CTAs (15 at N=960),
    far fewer than the SMs, so the stages are dealt out to ``splits`` CTAs
    per column block until there are about ``CTAS_PER_SM`` CTAs per SM,
    and so that a CTA's f32 x tile stays within ``X_SMEM_MAX``. Every
    split gets at least one stage.
    """
    per = 8 // bits if bits else 1
    nk = _cdiv(_cdiv(k, per), ROWS)
    tiles = _cdiv(n, BN) * _cdiv(m, MT)
    want = max(1, min(nk, _cdiv(CTAS_PER_SM * sms, tiles)))
    cps = _cdiv(nk, want)
    cps = max(1, min(cps, X_SMEM_MAX // (MT * ROWS * per * 4)))
    return _cdiv(nk, cps), cps


def _check(x, w, scale, bits: int, k: int, depth: int) -> None:
    if bits not in BITS:
        raise ValueError(f"stream_matmul takes bits in {BITS}, got {bits}")
    if not 2 <= depth <= MAX_DEPTH:
        raise ValueError(f"stream_depth must be in [2, {MAX_DEPTH}], got {depth}")
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    rows = _cdiv(k, 8 // bits) if bits else k
    want = torch.uint8 if bits else (torch.float32, torch.bfloat16)
    ok_dtype = w.dtype == want if bits else w.dtype in want
    if not ok_dtype or w.dim() != 2 or w.shape[0] != rows:
        raise ValueError(
            f"w must be ({rows}, N) {'uint8' if bits else 'float32/bfloat16'} "
            f"for bits={bits}, got {w.dtype} {tuple(w.shape)}"
        )
    n = w.shape[1]
    if scale is not None and (scale.dtype != torch.float32 or tuple(scale.shape) != (n,)):
        raise ValueError(f"scale must be float32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    devices = {x.device, w.device} | ({scale.device} if scale is not None else set())
    if len(devices) != 1:
        raise ValueError("x, w and scale must be on one device")


def stream_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor | None,
    bits: int,
    k: int,
    stream_depth: int = 2,
) -> torch.Tensor:
    """out[m, n] = (x[m] . decode(w)[:, n]) * scale[n], f32 (M, N).

    x: (M, K) f32/bf16; w: (ceil(K*bits/8), N) uint8 for bits 1/2, or (K,
    N) f32/bf16 rows for bits 0; scale: (N,) f32 or None (no scaling);
    ``stream_depth`` in [2, 8] is the ring's stage count.
    """
    _check(x, w, scale, bits, k, stream_depth)
    if x.device.type == "cpu":
        return stream_matmul_ref(x, w, scale, bits, k)
    if x.device.type != "cuda":
        raise ValueError(f"stream_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()
            and (scale is None or scale.is_contiguous())):
        raise ValueError("stream_matmul needs contiguous x, w and scale")
    m, n = x.shape[0], w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    splits, cps = split_plan(m, k, n, bits, _build.sm_count(x.device.index))
    part = (
        torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        if splits > 1
        else out
    )
    lib = _build.load("weight_stream", "stream_matmul_launch", _ARGTYPES)
    rc = lib.stream_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), bits,
        int(w.dtype == torch.bfloat16), scale.data_ptr() if scale is not None else None,
        out.data_ptr(), part.data_ptr(), m, k, n, splits, cps, stream_depth,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "stream_matmul")
    COUNTER.count += 1
    if splits > 1:
        REDUCE_COUNTER.count += 1
    return out
