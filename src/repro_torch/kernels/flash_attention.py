"""``flash_fwd``: online-softmax attention forward on Hopper.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py::flash_fwd``
(``_fwd_kernel``) with the hand-written CUDA kernel ``csrc/flash_fwd.cu``.
What bounds it on the H100: at the serve path's prefill shapes (Sq = Sk =
512, D = 64, 15 heads) it is bound by operations. The design runs one
block per (bh, 64-query tile) with one thread per query row, stages K/V
tiles in shared memory, keeps the f32 online-softmax state in registers,
maps GQA by ``bh // g`` without replicating K/V, and never loads a tile the
causal / window mask hides. Any Sq and Sk are handled by masking, not by
a block-divisor search; D must be 32, 64 or 128.

On a CPU tensor the wrapper runs the plain version (``ref.flash_fwd_ref``);
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_fwd_ref

COUNTER = _build.LaunchCounter()
HEAD_DIMS = (32, 64, 128)


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def _check(q, k, v, window: int, q_offset: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(
            f"need q (BH, Sq, D) and k, v (BKV, Sk, D); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if q.shape[2] != k.shape[2] or k.shape[0] == 0 or q.shape[0] % k.shape[0]:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on D or GQA grouping"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0, got {window}, {q_offset}")


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, D); k/v: (BKV, Sk, D); BH % BKV == 0 (GQA).

    Returns (out (BH, Sq, D) in q's dtype, lse (BH, Sq) f32).
    """
    _check(q, k, v, window, q_offset)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_fwd takes head dims {HEAD_DIMS}, got {d}")
    if bh > 65535:
        raise ValueError(f"flash_fwd takes at most 65535 (batch x head) rows, got {bh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd needs contiguous q, k and v")
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    lib = _build.load("flash_fwd", "flash_fwd_launch", _ARGTYPES)
    rc = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, sq, k.shape[1], d, bh // k.shape[0],
        int(causal), window, q_offset, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_fwd")
    COUNTER.count += 1
    return out, lse
