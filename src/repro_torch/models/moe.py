"""Mixture-of-Experts FFN: the capacity dispatch that training (and the
fixed-batch engine's decode step) runs, and the dropless per-token
dispatch that the pool engine serves with.

Port of ``repro.models.moe`` (``moe_capacity``, ``_token_gates``,
``moe_ffn``, ``moe_ffn_dropless``, and the expert-parallel hook
``set_moe_ep_axis``, which the dry run sets).

``moe_ffn`` is GShard's grouped dispatch, one group per batch row: each
expert takes the ``moe_capacity`` tokens of its row with the largest gate
(a stable descending sort of the (B, E, S) gate, so that equal gates go to
the lower position first, as ``lax.top_k`` orders them; tokens beyond
capacity drop), the chosen rows are gathered, the expert FFN runs as batched einsums in the
model dtype, and the outputs, scaled by their gates, are summed back into
their rows. The sum is ``index_put`` with ``accumulate=True`` (and the
gather's gradient is the same op), which CUDA runs as a sort, then a sum
of each index's run in a fixed order, so a call gives the same bits every
time (``index_add_`` on CUDA floats uses atomics and does not). It also
returns the Switch load-balance loss, in f32.

The dropless dispatch: every token keeps its full top-k mix with no
capacity competition, so a token's output is a function of its own hidden
state and the expert weights only: chunked prefill, a bare-suffix prefill
after a prefix-cache hit and padded batching are exact.

Experts are visited in expert order, each over all B*S rows, and
accumulated as ``acc + g_e[:, None] * y_e`` in f32, as the reference's
``lax.scan`` does. A resident expert is three f32 ``torch.matmul``s on its
weights cast to f32 (the reference computes them outside any Pallas
kernel). A cold expert (``stream_mask``, from a residency plan) runs
``kernels.ops.stream_matmul`` three times on its weight rows as stored
(bf16 at the serving dtype): the reference's f32 cast of a bf16 weight is
exact and the kernel keeps f32 x on f32 FMAs, so it computes the same
function from half the bytes. On the CPU the streamed and resident paths
are the same arithmetic, bit for bit.

A row's bits must not follow the number of rows in its call: the prefix
cache prefills a suffix where a cold prefill runs the whole prompt, and
both must give a token the same K/V rows. cuBLAS picks its f32 GEMM
(tiles, split K) by the row count, and on the H100 a row's product comes
out other bits at most row counts than at 256 (it does not follow the
row's place within a call, nor zero rows padded after it). So the two
prefill entry points pass ``fixed_rows=True``: every f32 product of the
call (the router's and the resident experts') runs in ``EXPERT_ROWS``-row
calls, the last padded with zero rows, whatever its row count, and each
row has the bits of a 256-row call wherever it lies. Decode and verify
steps run unpadded: the rows they write are never held against a cold
prefill's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, shard_whole, spread

EXPERT_ROWS = 256  # rows of every f32 product call of a prefill

# The expert-parallel hook (the reference's moe.py:35-55): pin the (B, E,
# ...) dispatch tensors of ``moe_ffn`` to ("data", axis), so the expert
# einsums run on the expert shards rather than replicated. Module state
# that the dry run sets and resets per cell; it acts on ``DTensor``s only.
_EP = {"axis": None}


def set_moe_ep_axis(axis) -> None:
    _EP["axis"] = axis


def _ep_shard_bec(t):
    """A (B, E, ...) dispatch tensor redistributed to B on 'data', E on the
    EP axis (the reference's ``with_sharding_constraint``)."""
    if _EP["axis"] is None or not isinstance(t, DTensor):
        return t
    from repro_torch.dist.legalize import PartitionSpec, placements_of

    return t.redistribute(t.device_mesh, placements_of(
        PartitionSpec("data", _EP["axis"]), t.device_mesh))


def _fixed_rows(fn, x: torch.Tensor, fixed: bool) -> torch.Tensor:
    """``fn`` (a row-wise function of x (M, K)) over x: with ``fixed``, in
    ``EXPERT_ROWS``-row calls, the last padded with zero rows; else as is."""
    if not fixed:
        return fn(x)
    m = x.shape[0]
    pad = -m % EXPERT_ROWS
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return torch.cat([fn(t) for t in x.split(EXPERT_ROWS)])[:m]


def moe_capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Per-group expert capacity (groups are batch rows): ``S * k * cf /
    E`` truncated, at least 1, rounded up to a multiple of 8 only from 8
    on, then clamped to the group size, as the reference computes it."""
    cap = int(group_tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.n_experts)
    cap = max(1, cap)
    if cap >= 8:
        cap = (cap + 7) // 8 * 8
    return min(group_tokens, cap)


def _token_gates(
    x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig, fixed_rows: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-token top-k routing. x: (B, S, d); router: (d, E) f32.

    Returns (gate (B, S, E): the renormalised top-k probabilities, zero
    off the top-k; probs (B, S, E); top_i (B, S, k) the chosen experts).
    Depends on each token's own hidden state only. The reference's one-hot
    einsum becomes a scatter, which places the same values. ``fixed_rows``
    runs the logits' product in ``EXPERT_ROWS``-row calls."""
    k = cfg.experts_per_token
    if isinstance(router, DTensor):
        # the product on the local shards (layers.dense); the routing over
        # all E experts on every shard, as small as (B, S, E)
        logits = shard_whole(dense(x.to(torch.float32), router), -1, 1)
    else:
        x2 = x.to(torch.float32).reshape(-1, x.shape[-1])
        router = router.to(torch.float32)
        logits = _fixed_rows(lambda t: t @ router, x2, fixed_rows).reshape(
            x.shape[:-1] + (-1,))
    probs = torch.softmax(logits, dim=-1)
    top_g, top_i = torch.topk(probs, k, dim=-1)
    top_g = top_g / torch.clamp(top_g.sum(dim=-1, keepdim=True), min=1e-9)
    return _scatter_last(probs, top_i, top_g), probs, top_i


def _scatter_last(like: torch.Tensor, idx: torch.Tensor, src) -> torch.Tensor:
    """Zeros like ``like`` with ``src`` at ``idx`` along the last dim (the
    k picks of ``idx`` are distinct): a scatter, or over a ``DTensor``
    spread over ranks the reference's one-hot sum (``DTensor`` runs no
    in-place scatter whose placements it must change)."""
    if spread(like):
        hot = F.one_hot(idx, like.shape[-1]).to(like.dtype)
        src = src[..., None] if isinstance(src, torch.Tensor) else src
        return (hot * src).sum(dim=-2)
    return torch.zeros_like(like).scatter_(-1, idx, src)


def expert_counts(top_i: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(E,) f32 routed-token slots per expert, padded rows included (the
    reference's one-hot sum; a scatter of ones, exact in f32)."""
    idx = top_i.reshape(-1)
    ones = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
    return torch.zeros(n_experts, dtype=torch.float32, device=idx.device).scatter_add_(
        0, idx, ones
    )


def _resident(x2, w1e, w3e, w2e, fixed_rows: bool = False):
    """The expert on its weights cast to f32, as the reference computes it."""
    w1f, w3f, w2f = (w.to(torch.float32) for w in (w1e, w3e, w2e))
    return _fixed_rows(lambda t: (F.silu(t @ w1f) * (t @ w3f)) @ w2f, x2, fixed_rows)


def _streamed(x2, w1e, w3e, w2e, depth: int):
    d, ff = w1e.shape
    h = F.silu(
        ops.stream_matmul(x2, w1e, bits=0, k=d, stream_depth=depth)
    ) * ops.stream_matmul(x2, w3e, bits=0, k=d, stream_depth=depth)
    return ops.stream_matmul(h, w2e, bits=0, k=ff, stream_depth=depth)


def moe_ffn_dropless(
    x: torch.Tensor,
    router: torch.Tensor,
    w1: torch.Tensor,
    w3: torch.Tensor,
    w2: torch.Tensor,
    cfg: ModelConfig,
    *,
    stream_mask: tuple[bool, ...] | None = None,
    stream_depth: int = 2,
    fixed_rows: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dropless per-token dispatch. x: (B, S, d); router: (d, E); w1/w3:
    (E, d, ff); w2: (E, ff, d).

    ``stream_mask`` is a host tuple of E bools: a True expert streams its
    w1/w3/w2 through ``stream_matmul``'s ``stream_depth``-slot ring, a
    False one runs resident. Being a host tuple, it is a static choice per
    expert inside a captured CUDA graph. None keeps every expert resident.
    ``fixed_rows`` runs the router's and the resident experts' f32 products
    in ``EXPERT_ROWS``-row calls (a prefill's: a row's bits then do not
    follow the call's row count).

    Returns (output (B, S, d) in x's dtype, per-expert routed-token counts
    (E,) f32; padded rows route too and are counted).
    """
    b, s, d = x.shape
    e = cfg.n_experts
    if stream_mask is not None and len(stream_mask) != e:
        raise ValueError(f"stream_mask has {len(stream_mask)} flags for {e} experts")
    gate, _, top_i = _token_gates(x, router, cfg, fixed_rows)
    counts = expert_counts(top_i, e)
    x2 = x.to(torch.float32).reshape(b * s, d)
    g2 = gate.reshape(b * s, e)
    acc = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    for i in range(e):
        if stream_mask is not None and stream_mask[i]:
            y = _streamed(x2, w1[i], w3[i], w2[i], stream_depth)
        else:
            y = _resident(x2, w1[i], w3[i], w2[i], fixed_rows)
        acc = acc + g2[:, i, None] * y
    return acc.reshape(b, s, d).to(x.dtype), counts


def moe_ffn(
    x: torch.Tensor,
    router: torch.Tensor,
    w1: torch.Tensor,
    w3: torch.Tensor,
    w2: torch.Tensor,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The capacity dispatch (the reference's ``moe_ffn``). x: (B, S, d);
    router: (d, E); w1/w3: (E, d, ff); w2: (E, ff, d).

    Returns (output (B, S, d) in x's dtype, the Switch aux loss ``E *
    sum_e f_e * p_e`` as an f32 scalar: f_e the share of routed slots that
    go to expert e, p_e its mean router probability)."""
    b, s, d = x.shape
    e = cfg.n_experts
    gate, probs, top_i = _token_gates(x, router, cfg)
    # the reference's one-hot (B, S, k, E) summed over k: top-k picks distinct experts
    picked = _scatter_last(probs, top_i, 1.0)
    aux = e * torch.sum(picked.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    cap = moe_capacity(cfg, s)
    # each expert's C largest gates of its row, ties to the lower position
    # (lax.top_k's order; torch.topk leaves ties unordered)
    sel_g, sel_i = torch.sort(gate.transpose(1, 2), dim=-1, descending=True, stable=True)
    sel_g, sel_i = sel_g[..., :cap], _ep_shard_bec(sel_i[..., :cap])  # (B, E, C)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, e * cap)
    idx = sel_i.reshape(b, e * cap)
    xe = _ep_shard_bec(x[rows, idx].reshape(b, e, cap, d))  # row-local gather, in x's dtype
    h = F.silu(torch.einsum("becd,edf->becf", xe, w1.to(xe.dtype))) * torch.einsum(
        "becd,edf->becf", xe, w3.to(xe.dtype))
    ye = torch.einsum("becf,efd->becd", h, w2.to(h.dtype))
    gate_scale = ((sel_g > 0.0) * sel_g).to(ye.dtype)
    ye = _ep_shard_bec(ye * gate_scale[..., None]).reshape(b, e * cap, d)
    y = torch.zeros_like(x).index_put((rows, idx), ye, accumulate=True)
    return y, aux.to(torch.float32)
