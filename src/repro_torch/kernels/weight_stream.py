"""``stream_matmul``: matmul with the weight streamed through a ring, on Hopper.

Replaces the TPU kernel ``src/repro/kernels/weight_stream.py::stream_matmul``
(``_stream_kernel``, ``_decode_chunk``) with the hand-written CUDA kernel
``csrc/weight_stream.cu``, one launch a call. It runs the FFN of every
layer that budgeted decode streams: the weight (a 1/2-bit uint8 carrier,
or dense bf16/f32 rows for bits 0) is pulled from device memory K-stage by
K-stage through a ``stream_depth``-slot shared-memory ring filled by
``cp.async``. What bounds it on the H100: moving the weight (0.6 MB at 2
bits, 4.9 MB in bf16 for 960x2560) and latency, since decode M is the lane
count. The geometry is ``packed_matmul``'s decode GEMV's: a block covers a
16-row tile of x and 32 columns, and ``split_plan`` splits the K sweep
over a thread-block cluster of up to 8 blocks until the grid covers the
card's SMs; the splits are summed in split order in the cluster's shared
memory. ``stage_len`` sizes a ring stage so that at the decode shapes a
split's whole K range fits in ``stream_depth`` stages (all of it in flight
before the first wait), within ``RING_MAX`` bytes of shared memory: the
ring, not the weight, sets the footprint. Each warp copies, waits on and
consumes its own 16-deep slabs of a stage, so no block barrier stands in
the sweep. bf16 x against 1/2-bit codes or bf16 rows runs on the tensor
cores (exact products, f32 sums); f32 x or f32 rows on f32 FMAs.

On a CPU tensor the wrapper runs the plain version
(``ref.stream_matmul_ref``); on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import packed_matmul as _pm
from repro_torch.kernels.ref import stream_matmul_ref

COUNTER = _build.LaunchCounter()
BITS = (0, 1, 2)
MAX_DEPTH = 8  # cp.async.wait_group immediates the kernel dispatches on

# kernel geometry (csrc/weight_stream.cu): x rows and output columns a
# block, and the K step of the split and of a ring stage (the mma's k of
# 16: whole carrier rows at 1 and 2 bits)
MT, BN, BK = 16, 32, 16
RING_MAX = 96 * 1024  # shared-memory bytes of one block's ring: two blocks fit an SM
STAGE_MIN = 8 * BK  # a stage of fewer slabs than warps leaves warps idle

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(m: int, k: int, n: int, sms: int) -> tuple[int, int]:
    """(splits, K values per split) of the K sweep: ``packed_matmul``'s
    ``split_plan`` with this kernel's geometry. 960x2560 at M <= 16 gives
    80 column blocks x 2 splits, 2560x960 30 x 5."""
    splits, cps = _pm.split_plan(m, k, n, sms, bm=MT, bn=BN, bk=BK)
    return splits, cps * BK


def slot_bytes(sk: int, bits: int, w_size: int, x_size: int) -> int:
    """Shared-memory bytes of one ring slot of ``sk`` K values: the
    stage's weight rows (carrier rows of BN bytes, or dense rows padded to
    BN + 16 / w_size elements) and its (MT, sk + 16 / x_size) x slice."""
    k_bytes = BN // (8 // bits) if bits else (BN + 16 // w_size) * w_size
    return sk * (k_bytes + MT * x_size) + MT * 16


def stage_len(kps: int, depth: int, bits: int, w_size: int, x_size: int) -> int:
    """K values of a ring stage: a split's ``kps`` over ``depth`` stages,
    rounded up to ``BK``, so the whole split is in flight at once; at least
    ``STAGE_MIN`` (a 16-deep slab for each of the block's 8 warps) where the
    split is that long; capped so the ring stays within ``RING_MAX``, past
    which it cycles."""
    per_k = slot_bytes(1, bits, w_size, x_size) - MT * 16
    cap = (RING_MAX // depth - MT * 16) // per_k // BK * BK
    want = max(_cdiv(_cdiv(kps, depth), BK) * BK, min(STAGE_MIN, kps))
    return max(BK, min(want, cap))


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


@_build.reports_work("stream_matmul",
                     lambda x, w, scale, bits, k, stream_depth=2:
                     2.0 * x.shape[0] * k * w.shape[1])
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
    ``stream_depth`` in [2, 8] is the ring's slot count.
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
    if k == 0:
        return out.zero_()
    splits, kps = split_plan(m, k, n, _build.sm_count(x.device.index))
    sk = stage_len(kps, stream_depth, bits, w.element_size(), x.element_size())
    lib = _build.load("weight_stream", "stream_matmul_launch", _ARGTYPES)
    rc = lib.stream_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(), bits,
        int(w.dtype == torch.bfloat16), scale.data_ptr() if scale is not None else None,
        out.data_ptr(), m, k, n, splits, kps, sk, stream_depth,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "stream_matmul")
    COUNTER.add()
    return out
