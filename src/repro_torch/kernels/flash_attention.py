"""Flash attention on Hopper: ``flash_fwd`` and its two backward passes.

``flash_fwd`` replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_fwd`` (``_fwd_kernel``) with
the hand-written CUDA kernel ``csrc/flash_fwd.cu``.
What bounds it on the H100: at the serve path's prefill shapes (Sq = Sk =
512, D = 64, 15 heads) it is bound by operations. Both routes run one
block per (bh, 64-query tile), keep the online-softmax state in f32, map
GQA by ``bh // g`` without replicating K/V, never load a tile the causal /
window mask hides, and handle any Sq and Sk by masking, not by a
block-divisor search; D must be 32, 64, 80 or 128.

* bf16 (the serve and train paths): tensor cores. Four warps of 16 query
  rows hold their Q fragments in registers; K/V tiles of 64 keys arrive
  through a 2-stage ``cp.async`` ring; S = QK^T and O += PV are
  ``mma.sync`` (bf16 in, f32 accumulate), with P rounded to bf16 in
  registers before PV, as the reference's kernel does. q, k and v must be
  16-byte aligned.
* f32: the CUDA-core kernel, one thread per query row, f32 throughout.

``flash_bwd`` replaces the TPU kernel's backward (``flash_bwd``:
``_dq_kernel`` and ``_dkv_kernel``) with the two passes of
``csrc/flash_bwd.cu``, one wrapper each: ``flash_bwd_dq`` also writes
delta = rowsum(do * out) for ``flash_bwd_dkv``, which sums each GQA group
inside the block, so it returns the kv-head gradients, not the TPU
kernel's per-q-head partials. In bf16 (the train path) both passes run
all five tile products on the tensor cores (``mma.sync``, f32
accumulate), with P and dS rounded to bf16 in registers where the
reference rounds them; in f32 they run on the CUDA cores. Each pass has
its own launch counter, by route as ``flash_fwd``'s.

On a CPU tensor a wrapper runs the plain version (``ref.flash_fwd_ref``,
``ref.flash_bwd_ref``); on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_bwd_dkv_ref, flash_bwd_dq_ref, flash_fwd_ref

COUNTER = _build.LaunchCounter()
DQ_COUNTER = _build.LaunchCounter()  # flash_bwd's dq pass
DKV_COUNTER = _build.LaunchCounter()  # flash_bwd's dk/dv pass
# each wrapper's launches with ``causal=False`` (the enc-dec encoder and
# its cross-attention), counted again here by route beside its counter
NONCAUSAL_COUNTER = _build.LaunchCounter()
NONCAUSAL_DQ_COUNTER = _build.LaunchCounter()
NONCAUSAL_DKV_COUNTER = _build.LaunchCounter()
HEAD_DIMS = (32, 64, 80, 128)


_P, _I = ctypes.c_void_p, ctypes.c_int
# flash_fwd_launch: 5 pointers, 9 ints, the device q_offset's pointer (or
# null), scale, stream
_ARGTYPES = [_P] * 5 + [_I] * 9 + [_P, ctypes.c_float, _P]
# flash_bwd_dq_launch and flash_bwd_dkv_launch: 8 pointers, 9 ints, scale, stream
_BWD_ARGTYPES = [_P] * 8 + [_I] * 9 + [ctypes.c_float, _P]


def _check(q, k, v, window: int, q_offset) -> None:
    """The inputs' shapes, types and devices. ``q_offset`` is an int, or a
    one-element int32 tensor on q's device whose value is not read here (a
    read would synchronise the host, which a CUDA graph capture forbids)."""
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
    if isinstance(q_offset, torch.Tensor):
        if (q_offset.numel(), q_offset.dtype, q_offset.device) != (1, torch.int32, q.device):
            raise ValueError(
                f"a tensor q_offset must be one int32 on q's device {q.device}, got "
                f"{q_offset.numel()} x {q_offset.dtype} on {q_offset.device}"
            )
        q_offset = 0
    if window < 0 or q_offset < 0:
        raise ValueError(f"window and q_offset must be >= 0, got {window}, {q_offset}")


def _launch_ready(name: str, q, *tensors) -> bool:
    """True to launch the CUDA kernel, False to run the plain version (CPU
    tensors); raises for anything the kernel does not take (the bf16
    kernels copy 16 bytes at a time, so their inputs must be 16-byte
    aligned)."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.shape[0] > 65535:
        raise ValueError(f"{name} takes at most 65535 (batch x head) rows, got {q.shape[0]}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"{name} takes head dims {HEAD_DIMS}, got {q.shape[2]}")
    if not all(t.is_contiguous() for t in (q, *tensors)):
        raise ValueError(f"{name} needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, *tensors) if t.dtype == torch.bfloat16):
        raise ValueError(f"{name}'s bf16 kernel copies 16 bytes at a time: its bf16 "
                         "inputs must be 16-byte aligned")
    return True


def _attn_dots(n: int):
    """Dot flops of a flash pass whose plain version runs ``n`` (BH, Sq,
    Sk, D) products: 2 (QK^T, PV) forward, 3 (QK^T, dO V^T, dS K) for
    dq, 4 (QK^T, dO V^T, dS^T Q, P^T dO) for dk/dv."""
    return lambda q, k, *args, **kwargs: (
        2.0 * n * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2])


@_build.reports_work("flash_fwd", _attn_dots(2))
def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q: (BH, Sq, D); k/v: (BKV, Sk, D); BH % BKV == 0 (GQA). ``q_offset``
    (query i sits at position q_offset + i) is an int, a kernel argument,
    or a one-element int32 tensor on q's device, which the kernel reads:
    one captured launch then serves every offset written into it.

    Returns (out (BH, Sq, D) in q's dtype, lse (BH, Sq) f32).
    """
    _check(q, k, v, window, q_offset)
    if not _launch_ready("flash_fwd", q, k, v):
        return flash_fwd_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    on_device = isinstance(q_offset, torch.Tensor)
    lib = _build.load("flash_fwd", "flash_fwd_launch", _ARGTYPES)
    rc = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        int(q.dtype == torch.bfloat16), bh, sq, k.shape[1], d, bh // k.shape[0],
        int(causal), window, 0 if on_device else q_offset,
        q_offset.data_ptr() if on_device else None, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_fwd")
    route = "mma" if q.dtype == torch.bfloat16 else "f32"
    COUNTER.add(route)
    if not causal:
        NONCAUSAL_COUNTER.add(route)
    return out, lse


def _check_bwd(q, rows: dict, stats: dict) -> None:
    """The backward's extra inputs: each of ``rows`` (out, do) like q, each
    of ``stats`` (lse, delta) f32 (BH, Sq) on q's device."""
    for name, t in rows.items():
        if (t.shape, t.dtype, t.device) != (q.shape, q.dtype, q.device):
            raise ValueError(
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device} must match q "
                f"{tuple(q.shape)} {q.dtype} on {q.device}"
            )
    for name, t in stats.items():
        if t.shape != q.shape[:2] or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{name} must be f32 {tuple(q.shape[:2])} on q's device, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


@_build.reports_work("flash_bwd_dq", _attn_dots(3))
def flash_bwd_dq(q, k, v, out, lse, do, *, causal=True, window=0, q_offset=0):
    """The dq pass of ``flash_bwd``. Returns (dq (BH, Sq, D) in q's dtype,
    delta = rowsum(do * out) (BH, Sq) f32 for the dk/dv pass)."""
    _check(q, k, v, window, q_offset)
    _check_bwd(q, {"out": out, "do": do}, {"lse": lse})
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if not _launch_ready("flash_bwd_dq", q, k, v, out, lse, do):
        return flash_bwd_dq_ref(q, k, v, out, lse, do, **kw)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return dq, delta
    lib = _build.load("flash_bwd", "flash_bwd_dq_launch", _BWD_ARGTYPES)
    rc = lib.flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dq.data_ptr(), delta.data_ptr(), int(q.dtype == torch.bfloat16),
        bh, sq, k.shape[1], d, bh // k.shape[0], int(causal), window, q_offset,
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dq")
    route = "mma" if q.dtype == torch.bfloat16 else "f32"
    DQ_COUNTER.add(route)
    if not causal:
        NONCAUSAL_DQ_COUNTER.add(route)
    return dq, delta


@_build.reports_work("flash_bwd_dkv", _attn_dots(4))
def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal=True, window=0, q_offset=0):
    """The dk/dv pass of ``flash_bwd``, reading the dq pass's delta.
    Returns (dk, dv) (BKV, Sk, D) in k's dtype, each summed over its GQA
    group."""
    _check(q, k, v, window, q_offset)
    _check_bwd(q, {"do": do}, {"lse": lse, "delta": delta})
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if not _launch_ready("flash_bwd_dkv", q, k, v, do, lse, delta):
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, **kw)
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if sk == 0:
        return dk, dv
    lib = _build.load("flash_bwd", "flash_bwd_dkv_launch", _BWD_ARGTYPES)
    rc = lib.flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), int(q.dtype == torch.bfloat16),
        bkv, sq, sk, d, bh // bkv, int(causal), window, q_offset, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(lib, rc, "flash_bwd_dkv")
    route = "mma" if q.dtype == torch.bfloat16 else "f32"
    DKV_COUNTER.add(route)
    if not causal:
        NONCAUSAL_DKV_COUNTER.add(route)
    return dk, dv


def flash_bwd(
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
    """Gradients of ``flash_fwd``: the dq pass, then the dk/dv pass. q,
    out, do: (BH, Sq, D); k/v: (BKV, Sk, D); lse: (BH, Sq) f32 from the
    forward.

    Returns (dq (BH, Sq, D) in q's dtype, dk, dv (BKV, Sk, D) in k's
    dtype, each summed over its GQA group)."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    dq, delta = flash_bwd_dq(q, k, v, out, lse, do, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv
