"""``packed_matmul``: matmul against 1/2-bit packed weights on Hopper.

Replaces the TPU kernel ``src/repro/kernels/packed_matmul.py::packed_matmul``
(``_packed_matmul_kernel``, ``_decode_block``) with the hand-written CUDA
kernel ``csrc/packed_matmul.cu``. The decoded weight never reaches device
memory (the paper's 8x/16x fewer weight bytes than bf16); each path
decodes the carrier next to its multiply and masks ragged M, N and K
itself. Three paths, by M and x's dtype:

* M <= 16 (decode; bound by moving the carrier and by launch latency): a
  GEMV whose block covers every row of x and 32 columns, so the carrier is
  read once. ``split_plan``, given the GEMV's geometry, splits the K sweep
  over a thread-block cluster until the grid covers the card's SMs (150-160
  blocks at the decode shapes, where the columns alone give 30-80). A
  block requests all its carrier bytes with 16-byte ``cp.async`` copies
  before it stages x, then decodes carrier words in registers next to f32
  FMAs; the splits are summed in a fixed order in shared memory.
* M > 16 with bf16 x (prefill; bound by operations): tensor cores. x tiles
  and carrier bytes go through a ``cp.async`` ring, the codes are decoded
  into a shared bf16 tile of -1/0/+1 (exact) that ``ldmatrix.trans``
  reads as the B operand of ``mma.sync`` (f32 accumulate), and the scale
  is applied in the epilogue. Where the output has too few 64x128 tiles
  for the card's SMs, ``mma_plan`` splits the K sweep over a
  thread-block cluster, whose blocks sum their partial tiles in a fixed
  order in shared memory: one launch, the same bits every run. The split
  follows K and N only, never M, so a row's bits do not depend on how
  many rows share its launch: a prompt prefilled whole, in chunks, or
  after a prefix-cache hit gives the same K/V rows and logits.
* M > 16 with f32 x: the shared-memory tiled kernel on the CUDA cores (TF32
  would round x, and the +-1/0 sums are exact only in f32).

On a CPU tensor the wrapper runs the plain version (``ref.packed_matmul_ref``);
on a CUDA tensor it launches the kernel or raises; on a ``meta`` tensor (the
dry run's stand-ins) it returns an empty ``meta`` result of the kernel's
shape and dtype, and an op walk counts the same work.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import packed_matmul_ref

COUNTER = _build.LaunchCounter()
BITS = (1, 2)
GEMV_MAX_M = 16  # larger M takes the tiled paths
# the GEMV's geometry: all M <= 16 rows and GEMV_BN columns a block, its K
# split in steps of GEMV_BK values (whole carrier rows, 16-byte x loads)
GEMV_BN, GEMV_BK = 32, 8
# the mma path's geometry (csrc/packed_matmul.cu): output tile, K step, and
# the most blocks one cluster (one output tile's K split) may hold
BM, BN, BK = 64, 128, 64
MAX_SPLITS = 8
# the row count the mma path plans its K split for, whatever M is (the
# default prefill chunk): M would change the split, and with it the order
# in which a row's K sum is taken
PLAN_ROWS = 256


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(
    m: int, k: int, n: int, sms: int, bm: int = BM, bn: int = BN, bk: int = BK
) -> tuple[int, int]:
    """(splits, K steps per split) of a tiled kernel's K sweep; by default
    the mma path's tiles (the GEMV and ``mvau`` pass their own).

    The output gives ``cdiv(m, bm) * cdiv(n, bn)`` tiles (32 at M=256,
    N=960 for the mma path), fewer than the SMs at the prefill shapes, so
    the sweep's ``cdiv(k, bk)`` steps are dealt out to up to
    ``MAX_SPLITS`` blocks per tile until the grid covers the SMs. Split
    ``s`` takes steps ``[s*cps, min((s+1)*cps, nk))``: every split at least
    one, each range a multiple of bk (the last ends at k).
    """
    nk = _cdiv(k, bk)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    want = max(1, min(MAX_SPLITS, nk, _cdiv(sms, tiles)))
    cps = _cdiv(nk, want)
    return _cdiv(nk, cps), cps


def mma_plan(k: int, n: int, sms: int) -> tuple[int, int]:
    """The mma path's (splits, K steps per split): ``split_plan`` at
    ``PLAN_ROWS`` rows, the same for every M."""
    return split_plan(PLAN_ROWS, k, n, sms)


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


@_build.reports_work("packed_matmul",
                     lambda x, carrier, scale, bits, k: 2.0 * x.shape[0] * k * carrier.shape[1])
def packed_matmul(
    x: torch.Tensor, carrier: torch.Tensor, scale: torch.Tensor, bits: int, k: int
) -> torch.Tensor:
    """out[m, n] = (x[m] . decode(carrier)[:, n]) * scale[n], f32 (M, N).

    x: (M, K) f32/bf16; carrier: (K*bits/8, N) uint8; scale: (N,) f32.
    """
    _check(x, carrier, scale, bits, k)
    if x.device.type == "meta":
        return torch.empty((x.shape[0], carrier.shape[1]), dtype=torch.float32, device="meta")
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
    if k == 0:
        return out.zero_()
    sms = _build.sm_count(x.device.index)
    if m <= GEMV_MAX_M:
        splits, cps = split_plan(m, k, n, sms, bm=GEMV_MAX_M, bn=GEMV_BN, bk=GEMV_BK)
    elif x.dtype == torch.bfloat16:
        splits, cps = mma_plan(k, n, sms)
    else:
        splits, cps = 1, _cdiv(k, BK)
    lib = _build.load("packed_matmul", "packed_matmul_launch", _ARGTYPES)
    rc = lib.packed_matmul_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), carrier.data_ptr(),
        scale.data_ptr(), out.data_ptr(), m, k, n, bits, splits, cps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "packed_matmul")
    COUNTER.add("gemv" if m <= GEMV_MAX_M else "mma" if x.dtype == torch.bfloat16 else "tiled_f32")
    return out
