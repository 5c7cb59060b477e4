"""Attention: the flash kernel for prompts, plain torch over pool rows
and per-slot caches.

Port of ``repro.models.attention``. ``flash_attention`` goes to
``kernels.ops.flash_attention`` (the CUDA kernel on the card, its plain
version on the CPU), or, after ``set_attn_impl("scan")``, to
``flash_attention_scan``, the reference's scan-of-scans online softmax in
plain torch (the §Perf baseline the flash kernel is measured against; the
reference has no Pallas kernel behind it either). The switch is read only
where the reference reads it: whole-sequence attention
(``lm._attn_block``) and the enc-dec's cross-attention. The paged chunk
paths and the sequence-sharded prefill call the kernel directly, since
the reference's counterparts of those never take the switch.
``decode_attention`` and ``chunk_attention`` attend over rows gathered
from the KV pool with a dense masked softmax in f32; the reference has no
Pallas kernel for them either. ``cache_insert`` writes a decode step's
K/V row into a per-slot ring cache in place.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models.layers import shard_whole

NEG_INF = -1e30
# The mesh axes of the two variants the dry run's hooks switch on (the
# reference's defaults, which its dry run keeps): heads or the head dim
# split over MODEL_AXIS, the batch over those of BATCH_AXES the mesh has.
MODEL_AXIS = "model"
BATCH_AXES = ("pod", "data")


def _batch_axes(mesh) -> tuple[str, ...] | None:
    """The axes of BATCH_AXES that ``mesh`` has, or None."""
    return tuple(a for a in BATCH_AXES if a in mesh.mesh_dim_names) or None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq % Hkv == 0; q_offset
    an int or a one-element int32 tensor on q's device. Returns (B, Sq,
    Hq, D). The implementation is ``set_attn_impl``'s: 'fa2' (the default)
    the flash kernels, 'scan' ``flash_attention_scan``."""
    if _ATTN_IMPL["name"] == "scan":
        return flash_attention_scan(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset
    )


_ATTN_IMPL = {"name": "fa2"}


def set_attn_impl(name: str) -> None:
    """'fa2' | 'scan': switch ``flash_attention``'s path (the dry run's
    A/B). Process-wide, as the reference's."""
    if name not in ("fa2", "scan"):
        raise ValueError(f"attention implementation {name!r}: 'fa2' or 'scan'")
    _ATTN_IMPL["name"] = name


def _pick_block(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target (the reference's: a
    whisper 1500-frame or vlm 32768 + 256 sequence takes a ragged one)."""
    for d in range(min(target, s), 0, -1):
        if s % d == 0:
            return d
    return 1


def flash_attention_scan(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_block: int = 512,
    kv_block: int = 1024,
    q_offset: int | torch.Tensor = 0,
) -> torch.Tensor:
    """The reference's naive scan-of-scans online softmax, in plain torch:
    query blocks (outer) over KV blocks (inner), every (q block, kv block)
    pair computed and masked, none skipped. Blocks are the largest
    divisors of Sq / Sk at most ``q_block`` / ``kv_block``. Scores, the
    running max and sum and the accumulator are f32 (bf16 inputs widen
    before each product, which is exact, as ``preferred_element_type``
    accumulates); P rounds to v's dtype before PV; a fully masked block's
    P is zeroed explicitly (exp(NEG_INF - NEG_INF) would be 1) and the
    final sum guarded by 1e-30. Shapes as ``flash_attention``; q_offset
    an int or a one-element tensor on q's device. Differentiable by
    autograd. Over ``DTensor``s it runs on the local shards as the flash
    kernel does (``ops.sharded_heads``)."""
    if isinstance(q, DTensor):
        return ops.sharded_heads(
            lambda ql, kl, vl: flash_attention_scan(
                ql, kl, vl, causal=causal, window=window, q_block=q_block,
                kv_block=kv_block, q_offset=q_offset), q, k, v)
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    qb, kb = _pick_block(sq, q_block), _pick_block(sk, kv_block)
    nq, nk = sq // qb, sk // kb
    qg = q.reshape(b, nq, qb, hkv, g, d).to(torch.float32)
    kg = k.reshape(b, nk, kb, hkv, d).to(torch.float32)
    vg = v.reshape(b, nk, kb, hkv, d)
    if isinstance(q_offset, torch.Tensor):
        q_offset = q_offset.reshape(()).long()
    rows, cols = torch.arange(qb, device=q.device), torch.arange(kb, device=q.device)
    blocks = []
    for qi in range(nq):
        q_pos = q_offset + qi * qb + rows
        m_run = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, hkv, g, qb), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hkv, g, qb, d), dtype=torch.float32, device=q.device)
        for kj in range(nk):
            k_pos = kj * kb + cols
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, qi], kg[:, kj]) * scale
            valid = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            if causal:
                valid = valid & (q_pos[:, None] >= k_pos[None, :])
            if window > 0:
                valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(torch.float32),
                              vg[:, kj].to(torch.float32))
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4))  # (B, qb, Hkv, G, D)
    return torch.stack(blocks, dim=1).reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cache_len: broadcastable to
    (B, 1), the current length (the new token sits at cache_len - 1).
    Over a ``DTensor`` cache whose heads are split it runs on the local
    shards as the flash kernel does (``kernels.ops.sharded_heads``): its
    grouped products would otherwise flatten a split heads dim. Where the
    cache's heads are whole, q's heads are gathered until each shard
    holds whole KV groups (``shard_whole``), and the cache stays put.
    """
    if isinstance(k_cache, DTensor) and any(p.is_shard(2) for p in k_cache.placements):
        cl = cache_len.to_local() if isinstance(cache_len, DTensor) else cache_len
        return ops.sharded_heads(
            lambda ql, kl, vl: decode_attention(ql, kl, vl, cl, window=window),
            q, k_cache, v_cache)
    b, _, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    g = hq // hkv
    qg = shard_whole(q, 2, hkv).reshape(b, hkv, g, d).to(torch.float32)
    scores = torch.einsum(
        "bhgd,bshd->bhgs", qg, k_cache.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    valid = pos[None] < cache_len
    if window > 0:
        valid &= pos[None] > cache_len - 1 - window
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgs,bshd->bhgd", p.to(v_cache.dtype).to(torch.float32),
        v_cache.to(torch.float32),
    )
    return out.reshape(b, 1, hq, d).to(q.dtype)


def chunk_attention(
    q: torch.Tensor,
    k_rows: torch.Tensor,
    v_rows: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    window: int = 0,
) -> torch.Tensor:
    """Multi-token causal attention against gathered pool rows.

    q: (B, C, Hq, D); k_rows/v_rows: (B, S, Hkv, D) in logical order (row
    i holds position i); q_pos: (B, C) absolute positions of the chunk
    tokens. Rows past the chunk (scratch padding included) are masked by
    causality.
    """
    b, c, hq, d = q.shape
    _, s, hkv, _ = k_rows.shape
    g = hq // hkv
    qg = shard_whole(q, 2, hkv).reshape(b, c, hkv, g, d).to(torch.float32)
    scores = torch.einsum(
        "bqhgd,bshd->bhgqs", qg, k_rows.to(torch.float32)
    ) * (1.0 / math.sqrt(d))
    k_pos = torch.arange(s, device=q.device)
    valid = q_pos[:, :, None] >= k_pos[None, None, :]  # (B, C, S)
    if window > 0:
        valid &= q_pos[:, :, None] - k_pos[None, None, :] < window
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhgqs,bshd->bqhgd", p.to(v_rows.dtype).to(torch.float32),
        v_rows.to(torch.float32),
    )
    return out.reshape(b, c, hq, d).to(q.dtype)


def flash_attention_seq_sharded(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    mesh,
) -> torch.Tensor:
    """Sequence-sharded prefill attention over ``DTensor``s (the
    reference's ``flash_attention_seq_sharded``): where the heads do not
    divide the MODEL_AXIS shards and the batch does not divide the mesh,
    each MODEL_AXIS shard runs its slice of the query sequence against the
    whole K/V, so attention's compute and bytes drop by the axis size
    instead of running replicated. The batch shards over BATCH_AXES. Each
    shard calls ``flash_fwd`` (``ops.flash_attention``) with ``q_offset``
    its coordinate on MODEL_AXIS times the local length, whatever
    ``set_attn_impl`` says: the kernel takes the offset, so the reference's
    scan is not needed here. Forward only (prefill).
    """
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.legalize import PartitionSpec, placements_of

    ba = _batch_axes(mesh)
    q_pl = placements_of(PartitionSpec(ba, MODEL_AXIS), mesh)
    kv_pl = placements_of(PartitionSpec(ba), mesh)
    local_s = q.shape[1] // mesh.shape[mesh.mesh_dim_names.index(MODEL_AXIS)]
    offset = mesh.get_local_rank(MODEL_AXIS) * local_s
    fn = local_map(
        lambda ql, kl, vl: ops.flash_attention(ql, kl, vl, causal=causal, window=window,
                                               q_offset=offset),
        out_placements=q_pl, in_placements=(q_pl, kv_pl, kv_pl), device_mesh=mesh)
    return fn(q.redistribute(mesh, q_pl), k.redistribute(mesh, kv_pl),
              v.redistribute(mesh, kv_pl))


def split_d_scores(q: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """A head-dim shard's partial decode scores (B, Hkv, G, S), f32 and
    unscaled: q (B, 1, Hq, Dl) against k (B, S, Hkv, Dl) over the local
    slice of D. Their sum over the shards is the whole product."""
    b, _, hq, dl = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, dl).to(torch.float32)
    return torch.einsum("bhgd,bshd->bhgs", qg, k_cache.to(torch.float32))


def split_d_finish(
    scores: torch.Tensor, v_cache: torch.Tensor, cache_len, head_dim: int, *,
    window: int = 0, dtype=None,
) -> torch.Tensor:
    """The rest of split-d decode attention on one shard, from the summed
    ``scores`` (``split_d_scores`` over every shard): scale by the whole
    head dim, mask, softmax (the same on every shard), then P V over the
    local slice of v (B, S, Hkv, Dl) -> (B, 1, Hq, Dl) in ``dtype``."""
    b, hkv, g, s = scores.shape
    scores = scores * (1.0 / math.sqrt(head_dim))
    pos = torch.arange(s, device=scores.device)
    valid = pos[None] < cache_len
    if window > 0:
        valid &= pos[None] > cache_len - 1 - window
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(b, 1, hkv * g, v_cache.shape[-1]).to(dtype or v_cache.dtype)


def decode_attention_split_d(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len,
    *,
    window: int = 0,
    mesh,
) -> torch.Tensor:
    """Decode attention with the cache head-dim-sharded over MODEL_AXIS
    (the reference's ``decode_attention_split_d``), over ``DTensor``s:
    where the KV heads do not divide MODEL_AXIS, the cache stays in its
    head-dim-sharded layout instead of being gathered every step. Each
    shard computes partial scores over its slice of D
    (``split_d_scores``), one all-reduce (a functional collective over
    MODEL_AXIS) sums them, the softmax runs on every shard, and P V returns
    head-dim-sharded (``split_d_finish``). The batch shards over
    BATCH_AXES; ``cache_len`` is replicated."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.dist.legalize import PartitionSpec, placements_of

    pl = placements_of(PartitionSpec(_batch_axes(mesh), None, None, MODEL_AXIS), mesh)
    d = q.shape[-1]
    sub = mesh[MODEL_AXIS]

    def local(ql, kl, vl):
        scores = funcol.all_reduce(split_d_scores(ql, kl), "sum", sub)
        return split_d_finish(scores, vl, cl, d, window=window, dtype=ql.dtype)

    cl = cache_len.to_local() if isinstance(cache_len, DTensor) else cache_len
    fn = local_map(local, out_placements=pl, in_placements=(pl, pl, pl), device_mesh=mesh)
    return fn(*(t.redistribute(mesh, pl) for t in (q, k_cache, v_cache)))


def cache_insert(cache: torch.Tensor, new: torch.Tensor, pos: int | torch.Tensor) -> torch.Tensor:
    """Write ``new`` (B, 1, Hkv, D) into ``cache`` (B, W, Hkv, D) at ring
    position ``pos`` along dim 1, in place, and return ``cache`` (the
    reference's ``cache_insert`` rebuilds the array). ``pos`` is an int or
    a one-element integer tensor on the cache's device, clamped into the
    cache as ``dynamic_update_slice`` clamps it; a device tensor keeps a
    captured step's position out of its graph. A ``DTensor`` cache (the
    dry run's) takes the row in its own placements (dim 1 is never
    sharded), written into its local shard."""
    if isinstance(cache, DTensor):
        new = new.redistribute(cache.device_mesh, cache.placements)
        pos = pos.to_local() if isinstance(pos, DTensor) else pos
        cache_insert(cache.to_local(), new.to_local(), pos)
        return cache
    idx = torch.as_tensor(pos, device=cache.device).reshape(1).long()
    idx = torch.clamp(idx, 0, cache.shape[1] - new.shape[1])
    return cache.index_copy_(1, idx, new.to(cache.dtype))
