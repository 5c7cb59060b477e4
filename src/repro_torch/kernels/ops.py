"""Public entry points of the port's kernels.

Port of ``repro.kernels.ops`` for what the serve, train and CNN paths use. The CUDA
kernels mask their own ragged edges, so no block padding happens here;
these functions only flatten batch dims and lay out heads.

Given ``DTensor``s (the dry run's stand-ins on a device mesh), each of
them is the call site of its kernel's ``local_map``: it states the
placements the kernel takes, redistributes its arguments into them (the
op walk sees those collectives), and runs the kernel on the local shards,
so the kernel's report is one device's work (``mvau``, on no mesh path,
refuses them). A matmul kernel takes its
weight as the sharding policy placed it: columns sharded (``w1``, ``w3``:
``Shard(1)``) give column-sharded outputs, rows sharded (``w2``) want x
sharded on K and give a ``Partial`` output; x keeps its rows' sharding.
Attention takes the batch and the query heads sharded, the K/V heads
with them where they divide (else whole, each shard reading its query
heads' K/V heads), the rest replicated.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mvau as _mvau
from repro_torch.kernels import packed_matmul as _pm
from repro_torch.kernels import weight_stream as _ws
from repro_torch.quant.quantizers import pack_bits


def matmul_placements(x: DTensor, w: DTensor):
    """(x's, w's, the per-column leaf's (scale) and the output's
    placements) of a matmul over DTensors, the weight kept where the policy
    placed it, as GSPMD propagates it: on each mesh dim, columns of w
    sharded give the output's last dim sharded; rows of w sharded want x's
    last dim sharded and give a ``Partial`` sum; w replicated keeps x's row
    sharding. x's rows never share a mesh dim with w's columns."""
    xl, wl, cl, ol = [], [], [], []
    last = x.dim() - 1
    for px, pw in zip(x.placements, w.placements):
        if isinstance(pw, Shard) and pw.dim == 1:
            xl.append(Replicate()), wl.append(pw), cl.append(Shard(0)), ol.append(Shard(last))
        elif isinstance(pw, Shard):
            xl.append(Shard(last)), wl.append(pw), cl.append(Replicate()), ol.append(Partial())
        else:
            p = px if isinstance(px, Shard) and px.dim < last else Replicate()
            xl.append(p), wl.append(Replicate()), cl.append(Replicate()), ol.append(p)
    return xl, wl, cl, ol


def reduce_partial(t: DTensor) -> DTensor:
    """``t`` with every ``Partial`` sum reduced (an all-reduce, as after a
    Megatron row-parallel product): ``DTensor`` would keep the sum pending
    and reduce it again at each nonlinear use (an RMSNorm's mean and its
    product each), where the reference reduces it once."""
    pl = [Replicate() if p.is_partial() else p for p in t.placements]
    return t if pl == list(t.placements) else t.redistribute(t.device_mesh, pl)


def sharded_matmul(fn, x: torch.Tensor, w: DTensor, col: DTensor | None = None) -> DTensor:
    """``fn(x_local, w_local[, col_local])`` on the local shards of
    x (..., K) @ w (K, N) over DTensors (``local_map``), the one place a
    matmul meets a mesh: the model's dense products (``fn`` a plain
    matmul) and the packed and streamed kernels. x takes the placements
    ``matmul_placements`` gives for w's (x's row shards stay); ``col`` is
    the per-column leaf (a scale) or None. A row-sharded weight's
    ``Partial`` output is reduced after the call (``reduce_partial``).
    The gradients' placements are stated: x's is a ``Partial`` sum where
    w's columns are split, w's where x's rows are, the column leaf's
    where either x's rows or w's rows are. Left to itself, ``DTensor``
    picks the cheapest move per op (it may move the weight, or gather a
    folded activation's rows)."""
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    xl, wl, cl, ol = matmul_placements(x, w)
    last = x.dim() - 1
    rows = [q.is_shard() and q.dim < last for q in xl]  # x's rows split on this mesh dim
    x_grad = [Partial() if p.is_shard(1) else q for p, q in zip(wl, xl)]
    w_grad = [Partial() if r else p for p, r in zip(wl, rows)]
    c_grad = [Partial() if r or p.is_shard(0) else c for p, c, r in zip(wl, cl, rows)]
    args = [x.redistribute(mesh, xl), w.redistribute(mesh, wl)]
    in_pl, grad_pl = (xl, wl), (x_grad, w_grad)
    if col is not None:
        args.append(col.redistribute(mesh, cl))
        in_pl, grad_pl = in_pl + (cl,), grad_pl + (c_grad,)
    return reduce_partial(local_map(fn, out_placements=ol, in_placements=in_pl,
                                    in_grad_placements=grad_pl, device_mesh=mesh)(*args))


def packed_matmul(
    x: torch.Tensor, carrier: torch.Tensor, scale: torch.Tensor, *, bits: int, k: int
) -> torch.Tensor:
    """Batched packed matmul. x: (..., K); carrier: (K*bits/8, N); scale:
    (N,). Returns (..., N) f32."""
    if isinstance(carrier, DTensor):
        return sharded_matmul(
            lambda xl, cl, sl: packed_matmul(xl, cl, sl, bits=bits, k=xl.shape[-1]),
            x, carrier, scale)
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
    if isinstance(w, DTensor):
        return sharded_matmul(
            lambda xl, wl, *sl: stream_matmul(
                xl, wl, sl[0] if sl else None, bits=bits, k=xl.shape[-1],
                stream_depth=stream_depth),
            x, w, scale)
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
    if isinstance(carrier, DTensor):
        raise ValueError("mvau takes local tensors: the CNN path runs on no mesh")
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
    if isinstance(q, DTensor):
        return sharded_heads(
            lambda ql, kl, vl: flash_attention(ql, kl, vl, causal=causal, window=window,
                                               q_offset=q_offset), q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    qf = q.transpose(1, 2).reshape(b * hq, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * hkv, sk, d).contiguous()
    out = _FlashAttention.apply(qf, kf, vf, causal, window, q_offset)
    return out.reshape(b, hq, sq, d).transpose(1, 2)


def sharded_heads(fn, q: DTensor, k, v) -> DTensor:
    """``fn(q_local, k_local, v_local)``, an attention over (B, S, H, D)
    q and (B, S', Hkv, D) k/v, on the local shards of DTensors (the flash
    kernel; the model's decode attention): on each mesh dim the batch
    (dim 0) stays sharded where q's is, and q's heads (dim 2) where q's
    are and the product of the mesh dims sharding them divides the query
    heads; all else is gathered first. K/V heads shard with q's where that
    product divides them too; where it does not (GQA: fewer KV heads than
    shards), K/V stay whole on those mesh dims and each shard takes the KV
    heads its query heads read, as GSPMD runs it, their gradients then a
    ``Partial`` sum."""
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    q_pl, heads, head_dims = [], 1, []
    for i, (p, n) in enumerate(zip(q.placements, mesh.shape)):
        if isinstance(p, Shard) and p.dim == 0:
            q_pl.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and hq % (heads * n) == 0:
            heads *= n
            head_dims.append(i)
            q_pl.append(Shard(2))
        else:
            q_pl.append(Replicate())
    whole_kv = hkv % heads != 0
    kv_pl = [Replicate() if whole_kv and i in head_dims else p for i, p in enumerate(q_pl)]
    kv_grad = [Partial() if whole_kv and i in head_dims else p for i, p in enumerate(q_pl)]
    shard = 0  # this rank's index among the query-head shards
    for i in head_dims:
        shard = shard * mesh.shape[i] + mesh.get_local_rank(i)

    def local(ql, kl, vl):
        if whole_kv:  # the KV heads this shard's query heads read
            g = hq // hkv
            lo, hi = shard * ql.shape[2] // g, ((shard + 1) * ql.shape[2] - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl)

    on_shards = local_map(local, out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl),
                          in_grad_placements=(q_pl, kv_grad, kv_grad), device_mesh=mesh)
    return on_shards(q.redistribute(mesh, q_pl), k.redistribute(mesh, kv_pl),
                     v.redistribute(mesh, kv_pl))


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
