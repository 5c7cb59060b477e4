"""Mamba2 / SSD (state-space duality) layer: chunked scan and O(1) decode.

Port of ``repro.models.ssm``. The SSD recurrence
``h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t``, ``y_t = C_t h_t + D x_t``
is evaluated in chunked form (Dao & Gu 2024, arXiv:2405.21060 §6): within
a chunk of length Q the output is an attention-like product with a decay
mask; across chunks a loop carries the (H, P, N) state (the reference's
``lax.scan``). Decode is the pure recurrence on a persistent state.

Plain PyTorch: the reference has no Pallas kernel for any of these. The
reference's f32 accumulation and its casts back to ``x.dtype`` are kept,
and so is its chunk rule: the largest divisor of S that is at most
``chunk``, so a prime S longer than ``chunk`` runs chunks of one token.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _roles(x: DTensor, dim: int) -> list[str | None]:
    """Per mesh dim of a ``DTensor`` x (B, ..., H, ...): "batch" where x's
    dim 0 is sharded, "heads" where its dim ``dim`` (heads, or a
    depthwise conv's channels) is and the product of those mesh dims
    divides it, else None."""
    roles, n = [], 1
    for p, size in zip(x.placements, x.device_mesh.shape):
        if p.is_shard(0):
            roles.append("batch")
        elif p.is_shard(dim) and x.shape[dim] % (n * size) == 0:
            n *= size
            roles.append("heads")
        else:
            roles.append(None)
    return roles


def _placed(roles, batch: int | None, heads: int | None, grad: bool = False) -> list:
    """Placements of a tensor whose batch dim is ``batch`` and heads dim
    ``heads`` (None: it has none) on a mesh of these roles; with ``grad``
    its gradient's: a ``Partial`` sum over the shards of a role's mesh dim
    that the tensor has no dim for."""
    out = []
    for r in roles:
        if r == "batch" and batch is not None:
            out.append(Shard(batch))
        elif r == "heads" and heads is not None:
            out.append(Shard(heads))
        else:
            out.append(Partial() if grad and r is not None else Replicate())
    return out


def _on_shards(fn, x: DTensor, head_dim: int, args, outs):
    """``fn`` of plain tensors run on the local shards of DTensors
    (``local_map``), batch and heads split as x's are, so no op inside
    meets a sharded dim it would have to gather or flatten. ``args``:
    (tensor, its batch dim, its heads dim) each, a plain tensor taken as
    replicated; ``outs``: (batch dim, heads dim) of each output."""
    from torch.distributed.tensor.experimental import local_map

    mesh, roles = x.device_mesh, _roles(x, head_dim)
    ts = [t if isinstance(t, DTensor) else
          DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
          for t, _, _ in args]
    in_pl = tuple(_placed(roles, b, h) for _, b, h in args)
    grad_pl = tuple(_placed(roles, b, h, grad=True) for _, b, h in args)
    on_shards = local_map(fn, out_placements=tuple(_placed(roles, b, h) for b, h in outs),
                          in_placements=in_pl, in_grad_placements=grad_pl, device_mesh=mesh)
    return on_shards(*(t.redistribute(mesh, pl) for t, pl in zip(ts, in_pl)))


def segsum(log_decay: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: L[i, j] = sum_{k=j+1..i} a_k for i >= j, else
    -inf. log_decay: (..., Q). Returns the (..., Q, Q) lower-triangular
    log-decay mask."""
    q = log_decay.shape[-1]
    cs = torch.cumsum(log_decay, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=log_decay.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def chunk_len(s: int, chunk: int) -> int:
    """The chunk ``ssd_chunked`` runs for S = ``s``: ``chunk`` when it
    divides S, else the largest divisor of S below it."""
    if s % chunk == 0:
        return chunk
    return next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)


def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a_log: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d_skip: torch.Tensor,
    chunk: int,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.

    x: (Bt, S, H, P) inputs; dt: (Bt, S, H) positive step sizes; a_log:
    (H,) with A = -exp(a_log) < 0; b, c: (Bt, S, N) shared across heads;
    d_skip: (H,) skip gain; h0: (Bt, H, P, N) f32 carried state or None
    (zeros). Returns y (Bt, S, H, P) in x's dtype and the final f32 state
    (Bt, H, P, N). Over ``DTensor``s it runs on each shard's batch rows
    and heads (``_on_shards``; b and c whole on the heads' shards)."""
    if isinstance(x, DTensor):
        args = [(x, 0, 2), (dt, 0, 2), (a_log, None, 0), (b, 0, None), (c, 0, None),
                (d_skip, None, 0)] + ([(h0, 0, 1)] if h0 is not None else [])
        return _on_shards(lambda *ts: ssd_chunked(*ts[:6], chunk, h0=ts[6] if h0 is not None
                                                  else None),
                          x, 2, args, [(0, 2), (0, 1)])
    bt, s, h, p = x.shape
    n = b.shape[-1]
    chunk = chunk_len(s, chunk)
    nc = s // chunk
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))  # (H,)

    xc = x.reshape(bt, nc, chunk, h, p)
    dtc = dt.reshape(bt, nc, chunk, h).to(f32)
    bc = b.reshape(bt, nc, chunk, n)
    cc = c.reshape(bt, nc, chunk, n)

    dta = dtc * a  # (Bt, nc, Q, H): log-decay per step
    # intra-chunk: Y = ((C B^T) * decay mask * dt at the source step) X
    w = torch.exp(segsum(dta.transpose(2, 3)))  # (Bt, nc, H, Q, Q)
    cb = torch.matmul(cc, bc.transpose(-1, -2))  # (Bt, nc, Q, Q) in b's dtype
    w = cb[:, :, None] * w
    w = w * dtc.transpose(2, 3)[:, :, :, None, :]
    # (Bt, nc, H, Q, Q) @ (Bt, nc, H, Q, P) -> (Bt, nc, Q, H, P)
    y_intra = torch.matmul(w.to(x.dtype), xc.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    del w

    # chunk-final states: S_c = sum_k exp(sum_{j>k} dta_j) dt_k B_k x_k
    dta_cum = torch.cumsum(dta, dim=2)
    decay_to_end = torch.exp(dta_cum[:, :, -1:, :] - dta_cum)  # (Bt, nc, Q, H)
    xs = (decay_to_end * dtc)[..., None] * xc.to(f32)  # (Bt, nc, Q, H, P)
    # (Bt, nc, H*P, Q) @ (Bt, nc, Q, N) -> (Bt, nc, H, P, N)
    sc = torch.matmul(
        xs.reshape(bt, nc, chunk, h * p).transpose(2, 3), bc.to(f32)
    ).reshape(bt, nc, h, p, n)
    chunk_decay = torch.exp(dta_cum[:, :, -1, :])  # (Bt, nc, H)

    # inter-chunk recurrence: the state entering each chunk
    hprev = torch.zeros((bt, h, p, n), dtype=f32, device=x.device) if h0 is None else h0.to(f32)
    hprevs = []
    for i in range(nc):
        hprevs.append(hprev)
        hprev = hprev * chunk_decay[:, i, :, None, None] + sc[:, i]
    hprevs = torch.stack(hprevs, dim=1)  # (Bt, nc, H, P, N)

    # inter-chunk contribution: y = exp(cum decay) * C_t h_prev
    # (Bt, nc, 1, Q, N) @ (Bt, nc, H, N, P) -> (Bt, nc, H, Q, P)
    y_inter = torch.matmul(cc.to(f32)[:, :, None], hprevs.transpose(-1, -2))
    y_inter = y_inter.permute(0, 1, 3, 2, 4) * torch.exp(dta_cum)[..., None]

    y = (y_intra.to(f32) + y_inter).reshape(bt, s, h, p)
    y = y + x.to(f32) * d_skip.to(f32)[None, None, :, None]
    return y.to(x.dtype), hprev


def ssd_decode_step(
    h: torch.Tensor,
    x: torch.Tensor,
    dt: torch.Tensor,
    a_log: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d_skip: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence. h: (Bt, H, P, N) f32; x: (Bt, H, P); dt:
    (Bt, H); b, c: (Bt, N). Returns (y (Bt, H, P) in x's dtype, the new
    f32 state). Over ``DTensor``s it runs on each shard's batch rows and
    heads (``_on_shards``)."""
    if isinstance(x, DTensor):
        return _on_shards(ssd_decode_step, x, 1,
                          [(h, 0, 1), (x, 0, 1), (dt, 0, 1), (a_log, None, 0), (b, 0, None),
                           (c, 0, None), (d_skip, None, 0)], [(0, 1), (0, 1)])
    f32 = torch.float32
    dt = dt.to(f32)
    a = -torch.exp(a_log.to(f32))
    dec = torch.exp(dt * a)[..., None, None]  # (Bt, H, 1, 1)
    inc = (dt[..., None] * x.to(f32))[..., None] * b[:, None, None, :].to(f32)
    h_new = h * dec + inc
    # (Bt, H, P, N) @ (Bt, 1, N, 1) -> (Bt, H, P)
    y = torch.matmul(h_new, c.to(f32)[:, None, :, None])[..., 0]
    y = y + x.to(f32) * d_skip[None, :, None]
    return y.to(x.dtype), h_new


def causal_conv(
    x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None
) -> torch.Tensor:
    """Depthwise causal conv1d and SiLU. x: (Bt, S, C); w: (K, C).

    ``state`` (Bt, K-1, C) holds the trailing pre-conv inputs of an
    already-consumed prefix (the decode path's conv buffer): when given,
    the left context comes from it instead of zero padding, which is what
    lets a suffix prefill resume mid-sequence with the cold start's
    windows. Over ``DTensor``s it runs on each shard's batch rows and
    channels (``_on_shards``: the conv is depthwise)."""
    if isinstance(x, DTensor):
        args = [(x, 0, 2), (w, None, 1)] + ([(state, 0, 2)] if state is not None else [])
        return _on_shards(lambda xl, wl, *sl: causal_conv(xl, wl, sl[0] if sl else None),
                          x, 2, args, [(0, 2)])
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(k):
        out = out + xp[:, j : j + s].to(torch.float32) * w[j].to(torch.float32)
    return F.silu(out).to(x.dtype)


def conv_decode_step(
    buf: torch.Tensor, xt: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """buf: (Bt, K-1, C) trailing inputs; xt: (Bt, C). Returns (y (Bt, C),
    the new buffer)."""
    window = torch.cat([buf, xt[:, None]], dim=1)  # (Bt, K, C)
    y = (window.to(torch.float32) * w.to(torch.float32)).sum(dim=1)
    return F.silu(y).to(xt.dtype), window[:, 1:]
