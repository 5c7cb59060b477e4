"""Dense, vlm, MoE, hybrid and SSM LM families: packed FFN weights, the
training forward and loss, the pool serving forward, the fixed-batch
decode step, sampling; and the enc-dec family's parameters and cache
(its forward, loss and decode step are ``models.encdec``'s).

Port of ``repro.models.lm``. The full-sequence forward (``trunk``,
``forward``, ``prefill``) and ``loss_fn`` take every family but enc-dec.
The vlm family (InternVL's backbone) is the dense family with precomputed
patch embeddings (``prefix_embeds``, (B, P, d)) ahead of the token
embeddings there; it serves text tokens through every dense entry point,
as the reference serves it. The MoE family's FFN is the capacity dispatch
``models.moe.moe_ffn`` in the forward and the fixed-batch decode step,
whose Switch aux loss ``trunk`` sums over the layers, and the dropless
``moe_ffn_dropless`` in the pool's serve entry points, which append the
(L, E) expert-load tally to their outputs, as the reference's do. The
hybrid family (Zamba2: Mamba2 layers, one shared attention + FFN block
after every ``hybrid_attn_every`` of them) runs the shared block's leaves
at every application, so its gradient is the sum over them; the pool
serves it through its own entry points (``prefill_with_cache_hybrid``,
``decode_step_paged_hybrid``, ``prefill_suffix_paged_hybrid``), which
carry a per-lane SSM state beside the pool, and the attention-family
entry points refuse it. The fixed-batch engine's entry points
(``init_cache``, ``decode_step``, ``prefill``) serve every family but
enc-dec over a static per-slot cache, updated in place so a captured CUDA
graph binds it; the pure-SSM family (Mamba2) is served only through them,
as in the reference. The reference's
parameter pytree becomes ``LMParams``, an ``nn.Module`` that keeps the
same stacked ``(L, ...)`` per-layer leaves (and the hybrid's unstacked
``shared`` subtree, the enc-dec's ``enc_layers``): float weights are
parameters (frozen unless built with ``trainable=True``), the FCMP-packed
FFN leaves are ``{"packed", "scale"}`` pairs of buffers (uint8 carrier,
f32 per-channel scale). The reference's ``lax.scan`` over layers is a
Python loop over views of the stacked leaves, so each layer's gradient
lands in its slice of the stacked leaf.

With ``cfg.w_bits`` in {1, 2} every dense-family FFN matmul (and the
hybrid's shared FFN, both of the enc-dec's FFN stacks) goes through
``kernels.ops.packed_matmul``: on the card the carrier is decoded in
registers by the CUDA kernel and never expanded in device memory. Under
a residency plan, the decode FFN of each streamed layer goes through
``kernels.ops.stream_matmul`` instead (dense or packed); for MoE the plan
streams single experts. MoE experts are never packed, whatever
``w_bits`` is, as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import (
    ATTN_KV_FAMILIES,
    ATTN_SERVED_FAMILIES,
    FORWARD_FAMILIES,
    PORTED_FAMILIES,
    TRAIN_FAMILIES,
    ModelConfig,
    torch_dtype,
)
from repro_torch.models.layers import (
    apply_rope,
    chunked_softmax_xent,
    cross_entropy,
    dense,
    embed,
    logits as unembed_logits,
    merge_heads,
    rms_norm,
    split_heads,
    swiglu,
)
from repro_torch.quant.quantizers import pack_bits


def _require_ported(
    cfg: ModelConfig, what: str, families: tuple[str, ...] = PORTED_FAMILIES
) -> None:
    if cfg.family not in families:
        raise ValueError(
            f"{what}: family {cfg.family!r} is not ported to it "
            f"(ported: {', '.join(families)})"
        )


# --------------------------------------------------------------------------
# Packed (FCMP) weight leaves
# --------------------------------------------------------------------------


def make_packed(w: torch.Tensor, bits: int) -> dict[str, torch.Tensor]:
    """Quantize + pack a float weight (..., K, N) into the carrier format:
    {"packed": uint8 (..., K*bits/8, N), "scale": f32 (..., N)}."""
    if bits == 1:
        scale = torch.mean(torch.abs(w), dim=-2)
        codes = (w > 0).to(torch.uint8)
    elif bits == 2:
        mean_abs = torch.mean(torch.abs(w), dim=-2, keepdim=True)
        mask = torch.abs(w) > 0.7 * mean_abs
        scale = torch.sum(torch.abs(w) * mask, dim=-2) / torch.clamp(
            torch.sum(mask, dim=-2).to(torch.float32), min=1.0
        )
        codes = (torch.sign(w) * mask + 1).to(torch.uint8)
    else:
        raise ValueError(f"make_packed takes bits 1 or 2, got {bits}")
    packed = pack_bits(torch.movedim(codes, -2, 0), bits)
    return {
        "packed": torch.movedim(packed, 0, -2).contiguous(),
        "scale": scale.to(torch.float32),
    }


def _unpack_codes(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 carrier (..., Kc, N) -> codes (..., Kc*per, N) along axis -2."""
    per = 8 // bits
    shifts = torch.arange(per, dtype=torch.uint8, device=packed.device) * bits
    planes = (packed[..., None, :] >> shifts[:, None]) & ((1 << bits) - 1)
    return planes.reshape(
        packed.shape[:-2] + (packed.shape[-2] * per, packed.shape[-1])
    )


def packed_dense(x: torch.Tensor, w: Any, bits: int) -> torch.Tensor:
    """Matmul against a dense or packed weight leaf. The packed product
    is f32 out of the kernel and is cast to x's dtype, as the reference's
    einsum in x's dtype returns it."""
    if not isinstance(w, dict):
        return dense(x, w)
    k = x.shape[-1]
    out = ops.packed_matmul(x, w["packed"], w["scale"], bits=bits, k=k)
    return out.to(x.dtype)


def packed_swiglu(x, w1, w3, w2, bits: int):
    h = F.silu(packed_dense(x, w1, bits)) * packed_dense(x, w3, bits)
    return packed_dense(h, w2, bits)


def _streamed_matmul(x: torch.Tensor, w: Any, bits: int, depth: int) -> torch.Tensor:
    """Matmul with the weight streamed through ``stream_matmul``'s
    ``depth``-stage ring; its f32 product is cast to x's dtype, as in
    ``packed_dense``."""
    k = x.shape[-1]
    if isinstance(w, dict):
        out = ops.stream_matmul(
            x, w["packed"], w["scale"], bits=bits, k=k, stream_depth=depth
        )
    else:
        out = ops.stream_matmul(x, w, None, bits=0, k=k, stream_depth=depth)
    return out.to(x.dtype)


def streamed_swiglu(x, w1, w3, w2, bits: int, depth: int):
    """The FFN of a layer the residency plan streams: every mat streamed."""
    h = F.silu(_streamed_matmul(x, w1, bits, depth)) * _streamed_matmul(
        x, w3, bits, depth
    )
    return _streamed_matmul(h, w2, bits, depth)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


class _Leaves(nn.Module):
    """Named stacked leaves: packed {"packed", "scale"} pairs become
    submodules of buffers (never trained), the other leaves parameters,
    which require gradients if ``trainable`` and they are floats."""

    def __init__(self, tree: dict[str, Any], trainable: bool = False):
        super().__init__()
        self.names = tuple(tree)
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                pair = nn.Module()
                pair.register_buffer("packed", leaf["packed"])
                pair.register_buffer("scale", leaf["scale"])
                self.add_module(name, pair)
            else:
                grad = trainable and leaf.is_floating_point()
                self.register_parameter(name, nn.Parameter(leaf, requires_grad=grad))

    def leaf(self, name: str):
        v = getattr(self, name)
        if isinstance(v, nn.Module):
            return {"packed": v.packed, "scale": v.scale}
        return v

    def tree(self) -> dict[str, Any]:
        return {n: self.leaf(n) for n in self.names}


def _layer_views(leaves: _Leaves, i: int) -> dict[str, Any]:
    """Views of stack entry ``i`` of every leaf (packed leaves stay pairs)."""
    return {
        name: {"packed": v["packed"][i], "scale": v["scale"][i]} if isinstance(v, dict) else v[i]
        for name, v in leaves.tree().items()
    }


class LMParams(nn.Module):
    """The parameter tree of ``init_params`` as a module: top-level leaves
    (``embed``, ``final_norm``, ``unembed`` when untied; the enc-dec's
    ``enc_final_norm``) plus ``layers``, whose leaves are stacked over the
    layer axis, for the hybrid family ``shared``, the one attention + FFN
    block every super-block applies (unstacked leaves), and for the
    enc-dec family ``enc_layers``, the encoder's stacked layers.
    ``trainable`` makes the float leaves require gradients (training);
    serving keeps them frozen, so it builds no autograd graph."""

    SUBTREES = ("layers", "shared", "enc_layers")

    def __init__(self, tree: dict[str, Any], trainable: bool = False):
        super().__init__()
        self.top = _Leaves(
            {k: v for k, v in tree.items() if k not in self.SUBTREES}, trainable
        )
        self.layers = _Leaves(tree["layers"], trainable)
        self.shared = _Leaves(tree["shared"], trainable) if "shared" in tree else None
        self.enc_layers = (
            _Leaves(tree["enc_layers"], trainable) if "enc_layers" in tree else None
        )

    def __getitem__(self, name: str):
        return self.top.leaf(name)

    def layer(self, i: int) -> dict[str, Any]:
        """Views of layer ``i``'s leaves (packed leaves stay pairs)."""
        return _layer_views(self.layers, i)

    def enc_layer(self, i: int) -> dict[str, Any]:
        """Views of the enc-dec encoder's layer ``i``'s leaves."""
        return _layer_views(self.enc_layers, i)

    def shared_block(self) -> dict[str, Any]:
        """The hybrid's shared attention + FFN block's leaves."""
        return self.shared.tree()

    def tree(self) -> dict[str, Any]:
        out = {**self.top.tree(), "layers": self.layers.tree()}
        if self.shared is not None:
            out["shared"] = self.shared.tree()
        if self.enc_layers is not None:
            out["enc_layers"] = self.enc_layers.tree()
        return out


EMBED_ROWS = 8192  # embedding rows drawn at a time by init_params
FFN_LEAVES = ("w1", "w3", "w2")
PACK_WORKERS = 4  # host threads of pack_ffn, each packing one layer at a time


def pack_ffn(w: torch.Tensor, bits: int) -> dict[str, torch.Tensor]:
    """A stacked dense FFN leaf (L, K, N) packed by ``make_packed`` one
    layer at a time on the host, into a pair on ``w``'s device. ``make_packed``
    reduces in the weight's dtype, and the card reduces in another order than
    the host, so packing on the host keeps the packed weights the same bits
    wherever the dense ones live. ``PACK_WORKERS`` threads pack layers
    concurrently (each layer the same ``make_packed`` call, so the same
    bits; torch's intra-op thread count is process-wide, so each thread's
    ops share it); the host holds a layer per thread."""
    l, k, n = w.shape
    out = {
        "packed": torch.empty((l, k * bits // 8, n), dtype=torch.uint8, device=w.device),
        "scale": torch.empty((l, n), dtype=torch.float32, device=w.device),
    }
    with ThreadPoolExecutor(min(PACK_WORKERS, l)) as pool:
        for i, layer in enumerate(pool.map(lambda j: make_packed(w[j].cpu(), bits), range(l))):
            for key, leaf in out.items():
                leaf[i] = layer[key]
    return out


def pack_ffn_params(params: LMParams, bits: int) -> LMParams:
    """Dense ``params`` with their FFN leaves packed (``pack_ffn``; the
    hybrid's shared FFN a (1, K, N) stack of one; the enc-dec's encoder
    FFN too), the other leaves shared: bitwise ``init_params`` at
    ``w_bits=bits`` when ``params`` is its dense (``w_bits=0``) draw of the
    same seed."""
    tree = params.tree()
    for stack in ("layers", "enc_layers"):
        if stack in tree:
            tree[stack] = {name: pack_ffn(leaf, bits) if name in FFN_LEAVES else leaf
                           for name, leaf in tree[stack].items()}
    if "shared" in tree:
        tree["shared"] = {
            name: ({k: v[0] for k, v in pack_ffn(leaf[None], bits).items()}
                   if name in FFN_LEAVES else leaf)
            for name, leaf in tree["shared"].items()}
    return LMParams(tree)


def init_params(
    cfg: ModelConfig, seed: int = 0, device=None, trainable: bool = False
) -> LMParams:
    """Random weights with the shapes and scales of the reference's
    ``lm.init_params`` (lm.py:204), drawn from a CPU ``torch.Generator``
    so every device gets the same numbers (JAX's numbers differ: share
    weights across the packages with ``interop.params_from_reference``).
    The weights land on ``device``: CUDA unless the caller asks for the
    CPU. ``trainable`` makes the float leaves require gradients.

    Each leaf is drawn in slices (a layer, or ``EMBED_ROWS`` embedding
    rows) in f32, scaled, rounded to the model dtype and written into its
    place on ``device``; with ``cfg.w_bits`` 1/2 the dense family's FFN
    leaves are then packed (``pack_ffn``). So the host holds one slice at a
    time (367 MB of f32 at phi3-medium's widest, not the 14.7 GB of its
    stacked ``w1``; one layer's 64 experts, 537 MB at olmoe).

    The vlm family draws as the dense family does (the reference's
    lm.py:216). The MoE family (the reference's lm.py:223) adds a
    ``router`` leaf (L, d, E) kept in f32 and stacks its expert FFNs as (L,
    E, d, ff) and (L, E, ff, d), dense at any ``w_bits``. The enc-dec
    family (lm.py:253) stacks decoder ``layers`` (``ln1``, ``ln_x``,
    ``ln2``, the attention, the ``x_``-prefixed cross-attention
    projections, the FFN) and encoder ``enc_layers`` (``ln1``, ``ln2``,
    attention, FFN) and adds ``enc_final_norm``; both FFN stacks pack at
    ``w_bits`` 1/2. The SSM (lm.py:234) and hybrid (lm.py:239) families
    stack ``ln1`` and the Mamba2 leaves (the reference's ``_init_ssm``;
    ``dt_bias``, ``a_log``, ``d_skip`` and ``gate_norm`` in f32), drawn by
    the same code; SSM has no FFN, and hybrid then draws one ``shared``
    block: its norms, attention projections and a 2-D FFN, packed at
    ``w_bits`` 1/2.
    A slice of a multiple of 16 values takes the same draws from the
    generator as the whole leaf would, so the numbers are those of one
    draw per leaf.
    """
    _require_ported(cfg, "init_params")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, std, dtype) -> torch.Tensor:
        host = torch.randn(shape, generator=gen, dtype=torch.float32).mul_(std)
        return host.to(device=device, dtype=dtype)

    def normal(shape, std, step, dtype) -> torch.Tensor:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(0, shape[0], step):
            out[i:i + step] = draw((min(step, shape[0] - i),) + shape[1:], std, dtype)
        return out

    def const(shape, value) -> torch.Tensor:
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return LMParams(_param_tree(cfg, normal, const, pack_ffn), trainable)


def abstract_params(cfg: ModelConfig) -> LMParams:
    """The parameter tree of ``init_params(cfg)`` on the ``meta`` device:
    every leaf's shape and dtype (the reference's ``abstract_params``,
    lm.py:278, under ``jax.eval_shape``), with no storage and no draw. It
    lays the tree out with ``init_params``'s own code; the packed FFN
    leaves (``w_bits`` 1/2) get the carrier pair ``pack_ffn`` makes, a
    uint8 (..., K * bits / 8, N) and an f32 scale (..., N), built from the
    shapes, since the packer itself needs values."""
    _require_ported(cfg, "abstract_params")

    def empty(shape, std=0.0, step=1, dtype=torch.float32) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, device="meta")

    def pack(w, bits) -> dict[str, torch.Tensor]:
        *lead, k, n = w.shape
        return {"packed": empty((*lead, k * bits // 8, n), dtype=torch.uint8),
                "scale": empty((*lead, n))}

    return LMParams(_param_tree(cfg, empty, lambda shape, value: empty(shape), pack))


def _param_tree(cfg: ModelConfig, normal, const, pack) -> dict[str, Any]:
    """The layout of ``init_params``'s tree, for every family, over three
    leaf constructors: ``normal(shape, std, step, dtype)`` a drawn leaf
    (called in draw order), ``const(shape, value)`` an f32 constant, and
    ``pack(w, bits)`` a stacked FFN leaf (L, K, N) as its carrier pair."""
    dt = torch_dtype(cfg)
    d, ff, l, pv = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.padded_vocab
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv

    def leaf(shape, std, step=1, dtype=dt) -> torch.Tensor:
        return normal(shape, std, step, dtype)

    moe = cfg.family == "moe"
    lead = (cfg.n_experts,) if moe else ()

    def ffn(k, n, std, count=l):
        w = leaf((count,) + lead + (k, n), std)
        return pack(w, cfg.w_bits) if cfg.w_bits in (1, 2) and not moe else w

    def ones(*shape):
        return const(shape, 1.0)

    s = d ** -0.5

    def attn_ffn(count, prefixes=("",)):
        """A stack's attention projections (each of ``prefixes``: the
        enc-dec's cross-attention is ``x_``), then its FFN, in draw order."""
        out = {}
        for pre in prefixes:
            out.update({
                f"{pre}wq": leaf((count, d, hq * hd), s),
                f"{pre}wk": leaf((count, d, hkv * hd), s),
                f"{pre}wv": leaf((count, d, hkv * hd), s),
                f"{pre}wo": leaf((count, hq * hd, d), s),
            })
        return {**out, "w1": ffn(d, ff, s, count), "w3": ffn(d, ff, s, count),
                "w2": ffn(ff, d, s * 0.5, count)}

    tree: dict[str, Any] = {
        "embed": leaf((pv, d), 0.02, EMBED_ROWS),
        "final_norm": ones(d),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = leaf((pv, d), 0.02, EMBED_ROWS)
    if cfg.family in ("ssm", "hybrid"):
        if cfg.family == "hybrid" and l % cfg.hybrid_attn_every:
            raise ValueError(f"{cfg.name}: {l} layers are no whole number of "
                             f"super-blocks of {cfg.hybrid_attn_every}")
        di, st, nh, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
        tree["layers"] = {
            "ln1": const((l, d), 1.0),
            "in_z": leaf((l, d, di), s),
            "in_x": leaf((l, d, di), s),
            "in_b": leaf((l, d, st), s),
            "in_c": leaf((l, d, st), s),
            "in_dt": leaf((l, d, nh), s),
            "dt_bias": const((l, nh), 0.0),
            "conv_x": leaf((l, k, di), 0.3),
            "conv_b": leaf((l, k, st), 0.3),
            "conv_c": leaf((l, k, st), 0.3),
            "a_log": const((l, nh), 0.0),  # A = -1
            "d_skip": const((l, nh), 1.0),
            "gate_norm": const((l, di), 1.0),
            "out": leaf((l, di, d), di ** -0.5),
        }
        if cfg.family == "ssm":
            return tree
        w1, w3, w2 = (leaf((1, a, b), std) for a, b, std in (
            (d, ff, s), (d, ff, s), (ff, d, s * 0.5)))
        if cfg.w_bits in (1, 2):
            w1, w3, w2 = (pack(w, cfg.w_bits) for w in (w1, w3, w2))
        tree["shared"] = {
            "ln1": const((d,), 1.0),
            "ln2": const((d,), 1.0),
            "wq": leaf((1, d, hq * hd), s)[0],
            "wk": leaf((1, d, hkv * hd), s)[0],
            "wv": leaf((1, d, hkv * hd), s)[0],
            "wo": leaf((1, hq * hd, d), s)[0],
            **{name: ({key: v[0] for key, v in w.items()} if isinstance(w, dict) else w[0])
               for name, w in (("w1", w1), ("w3", w3), ("w2", w2))},
        }
        return tree
    if cfg.family == "encdec":
        le = cfg.n_enc_layers
        tree["layers"] = {"ln1": ones(l, d), "ln_x": ones(l, d), "ln2": ones(l, d),
                          **attn_ffn(l, ("", "x_"))}
        tree["enc_layers"] = {"ln1": ones(le, d), "ln2": ones(le, d), **attn_ffn(le)}
        tree["enc_final_norm"] = ones(d)
        return tree
    tree["layers"] = {
        "ln1": ones(l, d),
        "ln2": ones(l, d),
        "wq": leaf((l, d, hq * hd), s),
        "wk": leaf((l, d, hkv * hd), s),
        "wv": leaf((l, d, hkv * hd), s),
        "wo": leaf((l, hq * hd, d), s),
        **({"router": leaf((l, d, cfg.n_experts), 0.02, dtype=torch.float32)}
           if moe else {}),
        "w1": ffn(d, ff, s),
        "w3": ffn(d, ff, s),
        "w2": ffn(ff, d, s * 0.5),
    }
    return tree


# --------------------------------------------------------------------------
# Layer bodies
# --------------------------------------------------------------------------


# The reference's mesh hooks (its lm.py:295-325 and 630-638), module state
# that the dry run (``launch.dryrun.lower_cell``) sets and resets per cell;
# each acts on ``DTensor``s only, so a run on plain tensors never sees it.
# Batch resharding of the attention region: where the heads do not divide
# the model axis, attention would run replicated over it; a spec like
# PartitionSpec(("data", "model")) reshards q/k/v batch-wise instead.
_ATTN_BATCH_SHARD = {"spec": None}
# Sequence-sharded prefill attention, where the batch reshard does not
# apply (prefill batch 32 on 256 devices).
# The two variants split over ``attention.MODEL_AXIS`` and put the batch
# over ``attention.BATCH_AXES``.
_ATTN_SEQ_SHARD = {"mesh": None}
# Split-d decode attention: where the KV heads do not divide the model
# axis, the cache stays head-dim-sharded (``attention.decode_attention_split_d``).
_DECODE_SPLIT_D = {"mesh": None}


def set_attn_batch_sharding(spec) -> None:
    """``PartitionSpec`` of the attention region's batch dim, or None."""
    _ATTN_BATCH_SHARD["spec"] = spec


def set_attn_seq_sharding(mesh) -> None:
    """Enable (``mesh`` not None) or disable sequence-sharded prefill attention."""
    _ATTN_SEQ_SHARD["mesh"] = mesh


def set_decode_split_d(mesh) -> None:
    """Enable (``mesh`` not None) or disable split-d decode attention."""
    _DECODE_SPLIT_D["mesh"] = mesh


def _attn_shard(t):
    """``t`` redistributed batch-wise over ``_ATTN_BATCH_SHARD``'s spec (the
    reference's ``with_sharding_constraint``), other dims replicated."""
    spec = _ATTN_BATCH_SHARD["spec"]
    if spec is None or not isinstance(t, DTensor):
        return t
    from repro_torch.dist.legalize import placements_of

    return t.redistribute(t.device_mesh, placements_of(spec, t.device_mesh))


def _qkv(lp, cfg: ModelConfig, x, positions):
    """Pre-norm q/k/v projection + RoPE shared by every attention path;
    x: (B, S, d), positions: (B|1, S)."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = split_heads(dense(h, lp["wq"]), cfg.n_heads, cfg.hd)
    k = split_heads(dense(h, lp["wk"]), cfg.n_kv, cfg.hd)
    v = split_heads(dense(h, lp["wv"]), cfg.n_kv, cfg.hd)
    return (
        apply_rope(q, positions, cfg.rope_theta),
        apply_rope(k, positions, cfg.rope_theta),
        v,
    )


def _residual(x, y):
    """x + y, a ``DTensor`` y first laid out as the residual stream x is:
    a hook's reshard or ``DTensor``'s own choice of an op's output layout
    must not move the stream (the reference's stream keeps its sharding)."""
    if isinstance(y, DTensor) and y.placements != x.placements:
        y = y.redistribute(x.device_mesh, x.placements)
    return x + y


def _attn_block(lp, cfg: ModelConfig, x, positions, *, causal=True, window=0):
    """Full-sequence attention sub-block (pre-norm residual)."""
    s = x.shape[1]
    q, k, v = _qkv(lp, cfg, x, positions)
    seq_mesh = _ATTN_SEQ_SHARD["mesh"]
    if (seq_mesh is not None and isinstance(q, DTensor)
            and s % seq_mesh.shape[seq_mesh.mesh_dim_names.index(attn.MODEL_AXIS)] == 0):
        o = attn.flash_attention_seq_sharded(q, k, v, causal=causal, window=window,
                                             mesh=seq_mesh)
    else:
        q, k, v = _attn_shard(q), _attn_shard(k), _attn_shard(v)
        o = attn.flash_attention(q, k, v, causal=causal, window=window)
    return _residual(x, dense(merge_heads(o), lp["wo"])), (k, v)


def _ffn_block(lp, cfg: ModelConfig, x, ln_name="ln2"):
    """Pre-norm FFN residual: (x + FFN(norm(x)), aux). For the MoE family
    the FFN is the capacity dispatch (``moe.moe_ffn``) and aux its Switch
    loss, an f32 scalar; elsewhere the dense FFN (packed carriers when
    ``cfg.w_bits`` is 1/2) and aux 0.0."""
    h = rms_norm(x, lp[ln_name], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_lib.moe_ffn(h, lp["router"], lp["w1"], lp["w3"], lp["w2"], cfg)
        return _residual(x, y), aux
    if cfg.w_bits in (1, 2):
        y = packed_swiglu(h, lp["w1"], lp["w3"], lp["w2"], cfg.w_bits)
    else:
        y = swiglu(h, lp["w1"], lp["w3"], lp["w2"])
    return _residual(x, y), 0.0


def _ffn_block_streamed(lp, cfg: ModelConfig, x, depth: int):
    """``_ffn_block`` for a layer the residency plan streams: the same
    pre-norm residual, weights through ``stream_matmul``."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + streamed_swiglu(h, lp["w1"], lp["w3"], lp["w2"], cfg.w_bits, depth)


def _serve_ffn(lp, cfg: ModelConfig, x, tallies: list, *, expert_mask=None,
               stream_depth=2, fixed_rows=False):
    """The FFN residual of a serve entry point: the dense block, or for
    MoE the reference's ``_ffn_block(dropless=True)``: pre-norm, then the
    dropless dispatch (``expert_mask``, (E,) host bools, streams the
    flagged experts; ``fixed_rows``, set by the two prefill entry points,
    gives a row the same bits whatever the call's row count), whose (E,)
    tally is appended to ``tallies``."""
    if cfg.family != "moe":
        return _ffn_block(lp, cfg, x)[0]
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, counts = moe_lib.moe_ffn_dropless(
        h, lp["router"], lp["w1"], lp["w3"], lp["w2"], cfg,
        stream_mask=expert_mask, stream_depth=stream_depth, fixed_rows=fixed_rows,
    )
    tallies.append(counts)
    return x + y


def _with_tally(cfg: ModelConfig, out: tuple, tallies: list) -> tuple:
    """A serve entry point's outputs, with the (L, E) tally appended for
    the MoE family."""
    return out + (torch.stack(tallies),) if cfg.family == "moe" else out


def _unembed(params: LMParams, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(x, table, cfg.vocab)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _conv_tail(u: torch.Tensor, k: int, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Last ``k-1`` pre-conv inputs of a (B, S, C) sequence, left-padded
    with zeros when the sequence is shorter: the decode-time
    ``conv_decode_step`` buffer after the sequence has been consumed.
    ``prev`` (B, K-1, C) is the buffer carried in from an earlier chunk
    of the same sequence (suffix prefill)."""
    if prev is not None:
        u = torch.cat([prev.to(u.dtype), u], dim=1)
    b, s, c = u.shape
    tail = u[:, max(0, s - (k - 1)):]
    pad = (k - 1) - tail.shape[1]
    if pad > 0:
        tail = torch.cat([u.new_zeros((b, pad, c)), tail], dim=1)
    return tail


def _ssm_block(lp, cfg: ModelConfig, x, state=None, conv_bufs=None):
    """Mamba2 block (the reference's lm.py:406): the sequence path (state
    None), the one-token decode path (state given, S == 1), or the
    sequence-with-state path (state given, S > 1: a suffix resumed from a
    carried SSD state and conv buffers, the prefix-cache and chunked
    prefill case).

    Every path returns ``(x_out, new_state, new_bufs)``: the sequence
    paths' state and buffers are the post-sequence decode state (the final
    SSD state and the trailing pre-conv inputs), which hands a prefilled
    request straight to the per-token recurrence."""
    b = x.shape[0]
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    z = dense(h, lp["in_z"])
    xi = dense(h, lp["in_x"])
    bi = dense(h, lp["in_b"])
    ci = dense(h, lp["in_c"])
    dt = _softplus(dense(h, lp["in_dt"]).to(torch.float32) + lp["dt_bias"])
    if state is None or x.shape[1] > 1:
        k = cfg.conv_kernel
        cx, cb, cc = conv_bufs if conv_bufs is not None else (None,) * 3
        new_bufs = (_conv_tail(xi, k, cx), _conv_tail(bi, k, cb), _conv_tail(ci, k, cc))
        xi = ssm_lib.causal_conv(xi, lp["conv_x"], state=cx)
        bi = ssm_lib.causal_conv(bi, lp["conv_b"], state=cb)
        ci = ssm_lib.causal_conv(ci, lp["conv_c"], state=cc)
        s = x.shape[1]
        xh = split_heads(xi, cfg.ssm_heads, cfg.ssm_head_dim)
        y, new_state = ssm_lib.ssd_chunked(
            xh, dt, lp["a_log"], bi, ci, lp["d_skip"], cfg.ssm_chunk, h0=state
        )
        y = y.reshape(b, s, cfg.d_inner)
    else:
        cx, cb, cc = conv_bufs
        xi1, cx = ssm_lib.conv_decode_step(cx, xi[:, 0], lp["conv_x"])
        bi1, cb = ssm_lib.conv_decode_step(cb, bi[:, 0], lp["conv_b"])
        ci1, cc = ssm_lib.conv_decode_step(cc, ci[:, 0], lp["conv_c"])
        xh = xi1.reshape(b, cfg.ssm_heads, cfg.ssm_head_dim)
        y1, new_state = ssm_lib.ssd_decode_step(
            state, xh, dt[:, 0], lp["a_log"], bi1, ci1, lp["d_skip"]
        )
        y = y1.reshape(b, 1, cfg.d_inner)
        new_bufs = (cx, cb, cc)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), lp["gate_norm"], cfg.norm_eps)
    return x + dense(y, lp["out"]), new_state, new_bufs


# --------------------------------------------------------------------------
# Forward and loss (train / full sequence)
# --------------------------------------------------------------------------

REMAT_MODES = ("none", "dots", "full")


def _layer(params: LMParams, i: int, cfg: ModelConfig, x, positions):
    """Layer ``i`` of the trunk (the reference's ``_make_layer_fn``) ->
    (x, aux): for the dense, vlm and MoE families attention, then the FFN
    (aux: the MoE's Switch loss, else 0.0), each a pre-norm residual; for
    the SSM and hybrid families a Mamba2 block over the whole sequence
    (aux 0.0)."""
    lp = params.layer(i)
    if cfg.family in ("ssm", "hybrid"):
        return _ssm_block(lp, cfg, x)[0], 0.0
    x, _ = _attn_block(lp, cfg, x, positions, causal=True, window=cfg.sliding_window)
    return _ffn_block(lp, cfg, x)


_DOTS = (torch.ops.aten.mm.default,)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the 2-D matmul outputs (the projections),
    recompute the rest, as the reference's
    ``checkpoint_dots_with_no_batch_dims`` policy does."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(remat: str) -> dict:
    if remat == "dots":
        return dict(context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
    return {}


def _refuse_encdec(cfg: ModelConfig, what: str) -> None:
    """The enc-dec family's layers carry cross-attention: its forward, loss
    and decode step are ``models.encdec``'s, never the dense layer's."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{what}: family 'encdec' runs cross-attention into the encoder; "
            f"use encdec.{what}"
        )


def trunk(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    prefix_embeds: torch.Tensor | None = None,
    remat: str = "none",
) -> tuple[torch.Tensor, torch.Tensor]:
    """All layers + final norm, without the unembedding.

    tokens: (B, S). ``prefix_embeds`` (B, P, d) are precomputed modality
    embeddings (the vlm's patches), concatenated ahead of the token
    embeddings in the model dtype; positions run over P + S. Returns
    (hidden states over the token positions (B, S, d), aux loss: the MoE
    layers' Switch losses summed, an f32 scalar, 0 for the other
    families). The hybrid family applies the shared attention + FFN block
    after every ``hybrid_attn_every`` Mamba2 layers (the reference's
    ``_hybrid_stack``). ``remat`` "full" recomputes each layer in the
    backward (``torch.utils.checkpoint``, non-reentrant), "dots" recomputes
    all but the 2-D matmul outputs, "none" keeps every activation; as in
    the reference, the hybrid's shared block is never recomputed. Enc-dec
    raises, naming ``encdec.trunk``."""
    _refuse_encdec(cfg, "trunk")
    _require_ported(cfg, "trunk", FORWARD_FAMILIES)
    if remat not in REMAT_MODES:
        raise ValueError(f"remat must be one of {REMAT_MODES}, got {remat!r}")
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    n_prefix = 0
    if prefix_embeds is not None:
        n_prefix = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.shared_block() if cfg.family == "hybrid" else None
    for i in range(cfg.n_layers):
        if remat == "none":
            x, a = _layer(params, i, cfg, x, positions)
        else:
            x, a = checkpoint(
                _layer, params, i, cfg, x, positions, use_reentrant=False,
                **_remat_kwargs(remat),
            )
        aux = aux + a
        if shared is not None and (i + 1) % cfg.hybrid_attn_every == 0:
            x, _ = _attn_block(shared, cfg, x, positions, causal=True)
            x, a = _ffn_block(shared, cfg, x)
            aux = aux + a
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x[:, n_prefix:], aux


def forward(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    prefix_embeds: torch.Tensor | None = None,
    remat: str = "none",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. tokens: (B, S); ``prefix_embeds`` as in
    ``trunk``. Returns (logits over the token positions (B, S, V) f32,
    aux)."""
    x, aux = trunk(params, cfg, tokens, prefix_embeds=prefix_embeds, remat=remat)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(x, table, cfg.vocab), aux


def loss_fn(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    prefix_embeds: torch.Tensor | None = None,
    remat: str = "none",
    aux_weight: float = 0.01,
    ce_chunk: int = 0,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Training loss ``ce + aux_weight * aux``, returned with (ce, aux).
    ``prefix_embeds`` as in ``trunk`` (the vlm's patches; the loss is over
    the token positions). ``ce_chunk > 0`` switches to the fused chunked
    unembed + CE, which never holds the (B, S, V) logits. Every family but
    enc-dec, whose loss is ``encdec.loss_fn``."""
    _refuse_encdec(cfg, "loss_fn")
    _require_ported(cfg, "loss_fn", TRAIN_FAMILIES)
    if ce_chunk:
        x, aux = trunk(params, cfg, tokens, prefix_embeds=prefix_embeds, remat=remat)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        ce = chunked_softmax_xent(x, table, labels, cfg.vocab, chunk=ce_chunk)
    else:
        lg, aux = forward(params, cfg, tokens, prefix_embeds=prefix_embeds, remat=remat)
        ce = cross_entropy(lg, labels, cfg.vocab)
    return ce + aux_weight * aux, (ce, aux)


# --------------------------------------------------------------------------
# Serving entry points over the shared KV pool
# --------------------------------------------------------------------------


@torch.no_grad()
def prefill_with_cache(
    params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
    last_idx: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence prefill that keeps the per-layer K/V rows.

    tokens: (B, S) right-padded prompts; ``last_idx`` the index of the
    last real token (causality keeps the padded tail inert), an int or a
    one-element integer tensor on the tokens' device, selected on the
    device either way, so one captured prefill serves every prompt length
    of its bucket. Returns
    (next-token logits (B, 1, V) f32, ks, vs stacked (L, B, S, n_kv, hd),
    already RoPE'd: exactly the rows the pool stores); the MoE family
    appends the (L, E) expert-load tally (padded rows route and count).
    """
    _require_ported(cfg, "prefill_with_cache", ATTN_SERVED_FAMILIES)
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs, tallies = [], [], []
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        x, (k, v) = _attn_block(
            lp, cfg, x, positions, causal=True, window=cfg.sliding_window
        )
        x = _serve_ffn(lp, cfg, x, tallies, fixed_rows=True)
        ks.append(k)
        vs.append(v)
    idx = torch.as_tensor(last_idx, device=x.device).reshape(1).long()
    lg = _unembed(params, cfg, x.index_select(1, idx))
    return _with_tally(cfg, (lg, torch.stack(ks), torch.stack(vs)), tallies)


@torch.no_grad()
def decode_step_paged(
    params: LMParams,
    cfg: ModelConfig,
    token: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    row_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    stream_mask: tuple[bool, ...] | None = None,
    stream_depth: int = 2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One serving step against a shared row-addressed KV pool.

    token: (B, 1) next token per lane; pool_k/pool_v: (L, R, n_kv, hd);
    row_table: (B, S_max) physical row of each lane's logical position
    (scratch-padded); lengths: (B,) tokens already held per lane. The new
    token's K/V row goes to ``row_table[b, lengths[b]]`` by an in-place
    indexed write into the pool (the reference rebuilds the arrays), then
    each lane attends over its gathered rows at its own depth.

    ``stream_mask`` (from a ``runtime.residency`` plan) turns on budgeted
    decode. For the dense family it is (L,) bools: a layer flagged True
    runs its FFN through ``stream_matmul`` with a ``stream_depth``-stage
    ring, the others the resident path. For MoE it is (L, E) bools: the
    flagged experts of each layer stream, the others stay resident. The
    reference's ``lax.cond`` per scanned layer is an ``if`` here.

    Returns (logits (B, 1, V) f32, pool_k, pool_v), the pools being the
    same tensors, updated in place; the MoE family appends the (L, E)
    expert-load tally (idle lanes route and count).
    """
    _require_ported(cfg, "decode_step_paged", ATTN_SERVED_FAMILIES)
    moe = cfg.family == "moe"
    if stream_mask is not None and (
        len(stream_mask) != cfg.n_layers
        or (moe and any(not isinstance(row, (tuple, list)) or len(row) != cfg.n_experts
                        for row in stream_mask))
    ):
        want = f"({cfg.n_layers}, {cfg.n_experts})" if moe else f"({cfg.n_layers},)"
        raise ValueError(f"stream_mask must have shape {want} flags for {cfg.name}")
    x = embed(token, params["embed"], torch_dtype(cfg))
    b = x.shape[0]
    s_max = row_table.shape[1]
    lengths = lengths.long()
    row_table = row_table.long()
    pos_b = lengths[:, None]  # (B, 1) position of the incoming token
    write_rows = torch.gather(
        row_table, 1, torch.clamp(lengths, 0, s_max - 1)[:, None]
    )[:, 0]
    tallies = []
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        pk, pv = pool_k[i], pool_v[i]
        q, k, v = _qkv(lp, cfg, x, pos_b)
        pk[write_rows] = k[:, 0].to(pk.dtype)
        pv[write_rows] = v[:, 0].to(pv.dtype)
        o = attn.decode_attention(
            q, pk[row_table], pv[row_table], (lengths + 1)[:, None],
            window=cfg.sliding_window,
        )
        x = x + dense(o.reshape(b, 1, -1), lp["wo"])
        if moe:
            x = _serve_ffn(
                lp, cfg, x, tallies, stream_depth=stream_depth,
                expert_mask=None if stream_mask is None else tuple(stream_mask[i]),
            )
        elif stream_mask is not None and stream_mask[i]:
            x = _ffn_block_streamed(lp, cfg, x, stream_depth)
        else:
            x, _ = _ffn_block(lp, cfg, x)
    return _with_tally(cfg, (_unembed(params, cfg, x), pool_k, pool_v), tallies)


@torch.no_grad()
def prefill_chunk_paged(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    row_table: torch.Tensor,
    write_rows: torch.Tensor,
    start: int | torch.Tensor,
    last_idx: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill one chunk of a prompt against the shared KV pool.

    tokens: (B, C) chunk tokens, right-padded; write_rows: (B, C)
    physical pool row per chunk token (scratch row for padding);
    row_table: (B, S_max) the request's full row table; start: position
    of the chunk's first token; last_idx: in-chunk index of the prompt's
    last token. Each of the two is an int or a one-element integer tensor
    on the pool's device, and is used on the device either way: ``start``
    is the base of the RoPE positions and ``flash_fwd``'s device
    ``q_offset``, ``last_idx`` an ``index_select``, so one captured chunk
    serves every start and every last index. The chunk's K/V rows are
    written into the pool in place, then the chunk attends causally over
    the gathered rows through the flash kernel with ``q_offset = start``
    (rows past the chunk, scratch padding included, are masked by
    causality), which computes what the reference's ``chunk_attention``
    computes.

    Returns (logits at last_idx (B, 1, V) f32, pool_k, pool_v), the
    pools updated in place; the MoE family appends the (L, E) expert-load
    tally (the dropless dispatch makes a chunk boundary invisible to
    routing, so chunked equals single-shot prefill).
    """
    _require_ported(cfg, "prefill_chunk_paged", ATTN_SERVED_FAMILIES)
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    b, c, _ = x.shape
    q_offset = torch.as_tensor(start, device=x.device).reshape(1).to(torch.int32)
    positions = q_offset.long() + torch.arange(c, device=x.device)[None, :]
    row_table = row_table.long()
    write_rows = write_rows.long()
    tallies = []
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        pk, pv = pool_k[i], pool_v[i]
        q, k, v = _qkv(lp, cfg, x, positions)
        pk[write_rows] = k.to(pk.dtype)
        pv[write_rows] = v.to(pv.dtype)
        # the kernel whatever set_attn_impl says: the reference's chunk
        # path attends with its own dense chunk_attention, not the switch
        o = ops.flash_attention(
            q, pk[row_table], pv[row_table], causal=True,
            window=cfg.sliding_window, q_offset=q_offset,
        )
        x = x + dense(o.reshape(b, c, -1), lp["wo"])
        x = _serve_ffn(lp, cfg, x, tallies, fixed_rows=True)
    idx = torch.as_tensor(last_idx, device=x.device).reshape(1).long()
    x_last = x.index_select(1, idx)
    return _with_tally(cfg, (_unembed(params, cfg, x_last), pool_k, pool_v), tallies)


@torch.no_grad()
def verify_chunk_paged(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    row_table: torch.Tensor,
    write_rows: torch.Tensor,
    starts: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score a depth-C draft chain per lane against the shared KV pool.

    The speculative-decoding verifier (``runtime.speculative``): each lane
    feeds its pending token plus the drafter's proposals as one chunk, so
    the target scores every draft position in one batched step instead of
    C sequential ``decode_step_paged`` calls. ``prefill_chunk_paged``
    generalised two ways: ``starts`` is per lane (decode lanes sit at
    different depths), and the full (B, C, V) logits come back, since
    longest-accepted-prefix selection needs the distribution at every
    draft position. The chain's K/V rows are written into the lanes' own
    blocks in place; rows past a lane's accepted prefix are overwritten by
    the next chain, which makes rejection free.

    tokens: (B, C) draft chains, right-padded; write_rows: (B, C) physical
    pool row per chain token (the scratch row for padding); row_table:
    (B, S_max); starts: (B,) position of each lane's first fed token. The
    chain attends through the plain ``chunk_attention`` with per-lane
    query positions, as the reference's does (``flash_fwd`` takes one
    ``q_offset`` for the batch).

    Returns (logits (B, C, V) f32, pool_k, pool_v), the pools updated in
    place; the MoE family appends the (L, E) expert-load tally.
    """
    _require_ported(cfg, "verify_chunk_paged", ATTN_SERVED_FAMILIES)
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    b, c, _ = x.shape
    positions = starts.long()[:, None] + torch.arange(c, device=x.device)[None, :]
    row_table = row_table.long()
    write_rows = write_rows.long()
    tallies = []
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        pk, pv = pool_k[i], pool_v[i]
        q, k, v = _qkv(lp, cfg, x, positions)
        pk[write_rows] = k.to(pk.dtype)
        pv[write_rows] = v.to(pv.dtype)
        o = attn.chunk_attention(
            q, pk[row_table], pv[row_table], positions, window=cfg.sliding_window
        )
        x = x + dense(o.reshape(b, c, -1), lp["wo"])
        x = _serve_ffn(lp, cfg, x, tallies)
    return _with_tally(cfg, (_unembed(params, cfg, x), pool_k, pool_v), tallies)


# --------------------------------------------------------------------------
# Hybrid (Zamba2) paged serving: the shared attention blocks' KV pages
# through the pool, the SSM conv buffers and state stay per decode lane
# --------------------------------------------------------------------------

LANE_KEYS = ("ssm", "conv_x", "conv_b", "conv_c")


def init_ssm_lane_state(cfg: ModelConfig, slots: int, device=None) -> dict[str, torch.Tensor]:
    """Per-lane SSM decode state of the hybrid pool scheduler, on
    ``device`` (CUDA unless the caller asks for the CPU).

    Unlike the attention KV cache it is fixed-size per lane (the SSD
    recurrence is O(1) in sequence length), so it never pages: leaves are
    (L, slots, ...) and a lane's slice is overwritten on admission. The
    SSD state is f32; the conv buffers are in the model dtype."""
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    l, k = cfg.n_layers, cfg.conv_kernel
    return {
        "ssm": torch.zeros((l, slots, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((l, slots, k - 1, cfg.d_inner), dtype=dt, device=device),
        "conv_b": torch.zeros((l, slots, k - 1, cfg.ssm_state), dtype=dt, device=device),
        "conv_c": torch.zeros((l, slots, k - 1, cfg.ssm_state), dtype=dt, device=device),
    }


def _lane_views(lane_state: dict, i: int) -> tuple[torch.Tensor, tuple]:
    """Layer ``i``'s SSD state and conv buffers: views into the lanes."""
    return lane_state["ssm"][i], tuple(lane_state[key][i] for key in LANE_KEYS[1:])


def _store_lane(lane_state: dict, i: int, state, bufs) -> None:
    """Write layer ``i``'s new SSD state and conv buffers into the lanes,
    in place: a captured step keeps its lane buffers' addresses."""
    for key, t in zip(LANE_KEYS, (state, *bufs)):
        lane_state[key][i].copy_(t)


def _shared_after(cfg: ModelConfig, i: int) -> int | None:
    """The shared block's KV-cache layer that follows SSM layer ``i``, or
    None inside a super-block."""
    every = cfg.hybrid_attn_every
    return (i + 1) // every - 1 if (i + 1) % every == 0 else None


@torch.no_grad()
def prefill_with_cache_hybrid(
    params: LMParams, cfg: ModelConfig, tokens: torch.Tensor,
    last_idx: int | torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Hybrid whole-prompt prefill keeping both kinds of decode state.

    tokens: (B, S) prompts, **unpadded** (the final SSD state integrates
    every position, so a padded tail would pollute it: the scheduler
    prefills hybrid prompts at their own length, eagerly on the card).
    The shared block's attention runs ``flash_fwd``, causal. Returns
    (next-token logits (B, 1, V) f32, ks, vs stacked (n_super, B, S, n_kv,
    hd): the shared blocks' K/V rows for the pool, and the lane-state dict
    of ``init_ssm_lane_state`` with leaves (L, B, ...))."""
    _require_ported(cfg, "prefill_with_cache_hybrid", ("hybrid",))
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    shared = params.shared_block()
    lane: dict[str, list] = {key: [] for key in LANE_KEYS}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, st, bufs = _ssm_block(params.layer(i), cfg, x)
        for key, t in zip(LANE_KEYS, (st, *bufs)):
            lane[key].append(t)
        if _shared_after(cfg, i) is not None:
            x, (k, v) = _attn_block(shared, cfg, x, positions, causal=True)
            x, _ = _ffn_block(shared, cfg, x)
            ks.append(k)
            vs.append(v)
    idx = torch.as_tensor(last_idx, device=x.device).reshape(1).long()
    lg = _unembed(params, cfg, x.index_select(1, idx))
    return lg, torch.stack(ks), torch.stack(vs), {k: torch.stack(v) for k, v in lane.items()}


@torch.no_grad()
def decode_step_paged_hybrid(
    params: LMParams,
    cfg: ModelConfig,
    token: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    row_table: torch.Tensor,
    lengths: torch.Tensor,
    lane_state: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """``decode_step_paged`` for the hybrid family.

    The shared attention block after each super-block writes and gathers
    its K/V rows through the pool (pool_k/pool_v are (n_super, R, n_kv,
    hd), addressed by the same per-lane ``row_table``/``lengths`` as the
    attention families; the plain ``decode_attention``), while each SSM
    layer advances the per-lane ``lane_state`` (leaves (L, B, ...)) by one
    token. Every lane steps, idle ones included (a lane's state is
    overwritten on admission). Returns (logits (B, 1, V) f32, pool_k,
    pool_v, lane_state): the pools and the lane state are the same
    tensors, updated in place, so a captured step binds them."""
    _require_ported(cfg, "decode_step_paged_hybrid", ("hybrid",))
    x = embed(token, params["embed"], torch_dtype(cfg))
    b = x.shape[0]
    s_max = row_table.shape[1]
    lengths = lengths.long()
    row_table = row_table.long()
    pos_b = lengths[:, None]
    write_rows = torch.gather(row_table, 1, torch.clamp(lengths, 0, s_max - 1)[:, None])[:, 0]
    shared = params.shared_block()
    for i in range(cfg.n_layers):
        state, bufs = _lane_views(lane_state, i)
        x, state, bufs = _ssm_block(params.layer(i), cfg, x, state=state, conv_bufs=bufs)
        _store_lane(lane_state, i, state, bufs)
        j = _shared_after(cfg, i)
        if j is None:
            continue
        pk, pv = pool_k[j], pool_v[j]
        q, k, v = _qkv(shared, cfg, x, pos_b)
        pk[write_rows] = k[:, 0].to(pk.dtype)
        pv[write_rows] = v[:, 0].to(pv.dtype)
        o = attn.decode_attention(q, pk[row_table], pv[row_table], (lengths + 1)[:, None])
        x = x + dense(o.reshape(b, 1, -1), shared["wo"])
        x, _ = _ffn_block(shared, cfg, x)
    return _unembed(params, cfg, x), pool_k, pool_v, lane_state


@torch.no_grad()
def prefill_suffix_paged_hybrid(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    row_table: torch.Tensor,
    write_rows: torch.Tensor,
    start: int | torch.Tensor,
    last_idx: int | torch.Tensor,
    lane_state: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Hybrid prefill of a prompt suffix, resumed from carried state.

    Positions ``0..start-1`` were served already: by a cached prefix
    (their shared-attention K/V rows sit in the pool, gathered through
    ``row_table``, and ``lane_state`` is the anchor's snapshot) or by the
    prompt's earlier chunks (``lane_state`` carried from the last one).
    The suffix's SSD scan starts from the carried state and its causal
    convs take their left context from the carried conv buffers, so the
    result is the cold whole-prompt prefill's, up to the order of the
    SSD's sums (another chunk partition).

    tokens: (B, C) **unpadded** suffix; write_rows: (B, C) physical pool
    row per suffix token; start: position of the suffix's first token;
    last_idx: in-suffix index of the prompt's last token; each of the two
    an int or a one-element integer tensor, used on the device either way
    (``start`` is ``flash_fwd``'s device ``q_offset``), so one captured
    step serves every start. The shared block's attention runs
    ``flash_fwd`` over the gathered rows with ``q_offset = start`` (the
    reference's plain ``chunk_attention``, as in ``prefill_chunk_paged``).
    Returns (logits at last_idx (B, 1, V) f32, pool_k, pool_v,
    lane_state), the pools and ``lane_state`` (leaves (L, B, ...)) updated
    in place."""
    _require_ported(cfg, "prefill_suffix_paged_hybrid", ("hybrid",))
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    b, c, _ = x.shape
    q_offset = torch.as_tensor(start, device=x.device).reshape(1).to(torch.int32)
    positions = q_offset.long() + torch.arange(c, device=x.device)[None, :]
    row_table = row_table.long()
    write_rows = write_rows.long()
    shared = params.shared_block()
    for i in range(cfg.n_layers):
        state, bufs = _lane_views(lane_state, i)
        x, state, bufs = _ssm_block(params.layer(i), cfg, x, state=state, conv_bufs=bufs)
        _store_lane(lane_state, i, state, bufs)
        j = _shared_after(cfg, i)
        if j is None:
            continue
        pk, pv = pool_k[j], pool_v[j]
        q, k, v = _qkv(shared, cfg, x, positions)
        pk[write_rows] = k.to(pk.dtype)
        pv[write_rows] = v.to(pv.dtype)
        o = ops.flash_attention(  # the kernel, as the dense chunk path's
            q, pk[row_table], pv[row_table], causal=True, q_offset=q_offset
        )
        x = x + dense(o.reshape(b, c, -1), shared["wo"])
        x, _ = _ffn_block(shared, cfg, x)
    idx = torch.as_tensor(last_idx, device=x.device).reshape(1).long()
    return _unembed(params, cfg, x.index_select(1, idx)), pool_k, pool_v, lane_state


# --------------------------------------------------------------------------
# Fixed-batch decode: a static per-slot cache, one-token steps, prefill
# --------------------------------------------------------------------------


def init_cache(
    cfg: ModelConfig, batch: int, max_len: int, device=None
) -> dict[str, torch.Tensor]:
    """The fixed-batch engine's decode state (the reference's lm.py:597),
    on ``device`` (CUDA unless the caller asks for the CPU): attention
    caches (L, B, W, Hkv, D) with W = min(max_len, sliding_window) for the
    dense, vlm, MoE and enc-dec families (the enc-dec's decoder
    self-attention; ``encdec.init_decode_state`` adds its cross K/V); for
    SSM and hybrid the SSD state (L, B, H, P, N) in f32 and the conv
    buffers (L, B, K-1, C) in the model dtype; for
    hybrid also the shared block's (n_super, B, max_len, Hkv, D) caches;
    and ``len``, the lockstep position, an int32 of one element on the
    device, so a captured step reads it there. ``decode_step`` updates
    every leaf in place: the tensors never move (``zero_cache`` resets
    them at a wave boundary)."""
    _require_ported(cfg, "init_cache")
    device = resolve_device(device)
    dt = torch_dtype(cfg)
    cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    if cfg.family in ATTN_KV_FAMILIES + ("encdec",):
        kv_shape = (cfg.n_layers, batch, w, cfg.n_kv, cfg.hd)
        cache["k"] = torch.zeros(kv_shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=dt, device=device)
    if cfg.family in ("ssm", "hybrid"):
        cache.update(init_ssm_lane_state(cfg, batch, device))
    if cfg.family == "hybrid":
        kv_shape = (cfg.n_kv_cache_layers, batch, max_len, cfg.n_kv, cfg.hd)
        cache["k"] = torch.zeros(kv_shape, dtype=dt, device=device)
        cache["v"] = torch.zeros(kv_shape, dtype=dt, device=device)
    return cache


def zero_cache(cache: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Reset a cache in place to ``init_cache``'s state: the fixed
    engine's wave boundary, where the reference allocates a fresh cache; a
    captured step keeps binding the same tensors."""
    for leaf in cache.values():
        leaf.zero_()
    return cache


def _decode_attn_block(lp, cfg: ModelConfig, x, k_cache, v_cache, pos, *, window=0):
    """One-token attention against one layer's per-slot cache (the
    reference's lm.py:648): the new K/V row goes to ring slot ``pos % W``
    under a window, ``min(pos, W - 1)`` otherwise, in place; ``pos`` is the
    step's position, a 0-dim integer tensor on the device."""
    b = x.shape[0]
    q, k, v = _qkv(lp, cfg, x, pos.reshape(1, 1).expand(b, 1))
    w = k_cache.shape[1]
    slot = pos % w if window else torch.clamp(pos, max=w - 1)
    attn.cache_insert(k_cache, k, slot)
    attn.cache_insert(v_cache, v, slot)
    if _DECODE_SPLIT_D["mesh"] is not None and isinstance(q, DTensor):
        o = attn.decode_attention_split_d(
            q, k_cache, v_cache, torch.clamp(pos + 1, max=w), window=window,
            mesh=_DECODE_SPLIT_D["mesh"])
    else:
        o = attn.decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=w),
                                  window=window)
    return x + dense(merge_heads(o), lp["wo"])


@torch.no_grad()
def decode_step(
    params: LMParams, cfg: ModelConfig, token: torch.Tensor, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One fixed-batch serving step (the reference's lm.py:670): token (B,
    1) at the lockstep position ``cache["len"]`` -> (logits (B, 1, V) f32,
    cache). The dense family runs each layer's attention over its ring
    cache, then the FFN (``packed_matmul`` at ``w_bits`` 1/2); SSM advances
    each Mamba2 layer's SSD state and conv buffers by one token; hybrid
    does that and after each super-block applies the shared attention +
    FFN block over its cache. The returned cache is the same dict and the
    same tensors, updated in place (``len`` too), so a captured step binds
    them. The vlm family decodes text tokens as the dense family does; the
    MoE family too, its FFN the capacity dispatch (``moe.moe_ffn``) over
    groups of one token, as the reference's fixed decode runs it: a group
    of one fits every expert's capacity, so each token keeps its whole
    top-k mix. The enc-dec family raises, naming ``encdec.decode_step``."""
    _refuse_encdec(cfg, "decode_step")
    _require_ported(cfg, "decode_step")
    x = embed(token, params["embed"], torch_dtype(cfg))
    pos = cache["len"].long()
    if cfg.family in ("dense", "vlm", "moe"):
        for i in range(cfg.n_layers):
            lp = params.layer(i)
            x = _decode_attn_block(lp, cfg, x, cache["k"][i], cache["v"][i], pos,
                                   window=cfg.sliding_window)
            x, _ = _ffn_block(lp, cfg, x)
    else:
        hybrid = cfg.family == "hybrid"
        shared = params.shared_block() if hybrid else None
        for i in range(cfg.n_layers):
            state, bufs = _lane_views(cache, i)
            x, state, bufs = _ssm_block(params.layer(i), cfg, x, state=state, conv_bufs=bufs)
            _store_lane(cache, i, state, bufs)
            j = _shared_after(cfg, i) if hybrid else None
            if j is not None:
                x = _decode_attn_block(shared, cfg, x, cache["k"][j], cache["v"][j], pos)
                x, _ = _ffn_block(shared, cfg, x)
    cache["len"].add_(1)
    return _unembed(params, cfg, x), cache


@torch.no_grad()
def prefill(
    params: LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    prefix_embeds: torch.Tensor | None = None,
) -> torch.Tensor:
    """The reference's ``prefill`` (lm.py:760): the full-sequence forward's
    logits (B, S, V) f32 over the token positions; filling a cache is the
    serving engine's job."""
    lg, _ = forward(params, cfg, tokens, prefix_embeds=prefix_embeds)
    return lg


# --------------------------------------------------------------------------
# Sampling (host-side numpy, copied from the reference)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decode sampling policy. ``temperature == 0`` is exact greedy; top-k
    and top-p restrict the support before renormalising. The scheduler
    draws from an rng keyed on (seed, request id, position)."""

    temperature: float = 0.0
    top_k: int = 0  # 0 = unrestricted
    top_p: float = 1.0  # 1.0 = unrestricted
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_logits(row, sp: SamplingParams, rng=None) -> int:
    """Draw one token from a (V,) numpy logits row under ``sp``.

    Greedy (temperature 0) never touches ``rng``; top_k=1 collapses to
    greedy regardless of temperature; top_k >= V is unrestricted.
    """
    row = np.asarray(row, np.float64)
    if sp.is_greedy or sp.top_k == 1:
        return int(np.argmax(row))
    logits = row / sp.temperature
    top_k = min(sp.top_k, len(row))
    if top_k > 0:
        kth = np.partition(logits, -top_k)[-top_k]
        logits = np.where(logits >= kth, logits, -np.inf)
    logits = logits - np.max(logits)
    probs = np.exp(logits)
    probs /= probs.sum()
    if sp.top_p < 1.0:
        order = np.argsort(-probs)
        csum = np.cumsum(probs[order])
        cut = int(np.searchsorted(csum, sp.top_p)) + 1
        mask = np.zeros_like(probs, bool)
        mask[order[:cut]] = True
        probs = np.where(mask, probs, 0.0)
        probs /= probs.sum()
    return int(rng.choice(len(probs), p=probs))
