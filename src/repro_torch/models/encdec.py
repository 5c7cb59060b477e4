"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of ``repro.models.encdec``. The conv frontend is a stub: the caller
supplies precomputed frame embeddings (B, frontend_len, d). The encoder is
a bidirectional transformer over the frames, its attention the
``flash_fwd`` kernel with ``causal=False``; the decoder is a causal
transformer with cross-attention into the encoder's output (``flash_fwd``
again, not causal, Sq decoder tokens over the frames). Decoding runs the
decoder over the fixed-batch cache of ``lm.init_cache`` (a self-attention
ring per layer) plus each layer's cross K/V, computed once by
``init_decode_state`` into preallocated (L, B, F, Hkv, D) leaves; every
leaf is updated in place, so a captured step binds the whole cache and
takes only the token. The parameters are ``lm.init_params``' enc-dec tree
(``LMParams`` with ``enc_layers``). ``loss_fn`` is the teacher-forced
decoder's cross-entropy; its backward runs ``flash_bwd`` not causal
through the encoder and the cross-attention, causal through the decoder's
self-attention.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import (
    cross_entropy,
    dense,
    embed,
    logits as unembed_logits,
    merge_heads,
    rms_norm,
    split_heads,
)


def _require_encdec(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "encdec":
        raise ValueError(f"encdec.{what} takes the enc-dec family, got {cfg.family!r}")


def _cross_attn_block(lp, cfg: ModelConfig, x, enc_k, enc_v):
    """Cross-attention residual: queries from the decoder stream (no RoPE),
    K/V precomputed from the encoder's output."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    q = split_heads(dense(h, lp["x_wq"]), cfg.n_heads, cfg.hd)
    o = attn.flash_attention(q, enc_k, enc_v, causal=False)
    return x + dense(merge_heads(o), lp["x_wo"])


def _cross_kv(lp, cfg: ModelConfig, enc_out):
    """One decoder layer's cross K/V (B, F, Hkv, D) from the encoder states."""
    b, se, _ = enc_out.shape
    k = split_heads(dense(enc_out, lp["x_wk"]), cfg.n_kv, cfg.hd)
    v = split_heads(dense(enc_out, lp["x_wv"]), cfg.n_kv, cfg.hd)
    return k, v


def encode(params: lm.LMParams, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, d) stubbed frontend embeddings -> encoder states (B,
    F, d) in the model dtype: bidirectional attention + FFN layers, then
    the encoder's final norm."""
    _require_encdec(cfg, "encode")
    x = frames.to(torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_enc_layers):
        lp = params.enc_layer(i)
        x, _ = lm._attn_block(lp, cfg, x, positions, causal=False)
        x, _ = lm._ffn_block(lp, cfg, x)
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def trunk(
    params: lm.LMParams, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder hidden states (pre-unembedding) (B, S, d),
    and the aux loss (0)."""
    enc = encode(params, cfg, frames)
    x = embed(tokens, params["embed"], torch_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        x, _ = lm._attn_block(lp, cfg, x, positions, causal=True)
        x = _cross_attn_block(lp, cfg, x, *_cross_kv(lp, cfg, enc))
        x, _ = lm._ffn_block(lp, cfg, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(
    params: lm.LMParams, cfg: ModelConfig, tokens: torch.Tensor, frames: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder logits (B, S, V) f32 and aux. tokens: (B,
    S); frames: (B, F, d)."""
    x, aux = trunk(params, cfg, tokens, frames)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(x, table, cfg.vocab), aux


def loss_fn(
    params: lm.LMParams,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    frames: torch.Tensor,
    aux_weight: float = 0.0,
) -> tuple[torch.Tensor, tuple[torch.Tensor]]:
    """Training loss (the reference's ``encdec.loss_fn``): the decoder's
    cross-entropy over ``labels`` plus ``aux_weight * aux`` (aux is 0: the
    enc-dec family has no MoE layer), returned with (aux,)."""
    lg, aux = forward(params, cfg, tokens, frames)
    return cross_entropy(lg, labels, cfg.vocab) + aux_weight * aux, (aux,)


def cross_cache_struct(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """A ``meta`` stand-in for one cross-attention cache leaf, (L, B, F,
    Hkv, D) in the model dtype: the one source of its shape for
    ``launch.specs`` (input stand-ins) and ``dist.sharding`` (cache specs)."""
    shape = (cfg.n_layers, batch, cfg.frontend_len, cfg.n_kv, cfg.hd)
    return torch.empty(shape, dtype=torch_dtype(cfg), device="meta")


def with_cross_caches(cache: dict, cfg: ModelConfig, batch: int) -> dict:
    """A copy of ``cache`` with ``meta`` cross-attention leaves
    ``cross_k`` / ``cross_v`` added where missing: the one place the
    decode-state tree gains its enc-dec extras."""
    out = dict(cache)
    out.setdefault("cross_k", cross_cache_struct(cfg, batch))
    out.setdefault("cross_v", cross_cache_struct(cfg, batch))
    return out


@torch.no_grad()
def init_decode_state(
    params: lm.LMParams,
    cfg: ModelConfig,
    frames: torch.Tensor,
    max_len: int,
    cache: dict[str, torch.Tensor] | None = None,
) -> dict[str, torch.Tensor]:
    """The decode state on the frames' device: ``lm.init_cache``'s
    self-attention rings and ``len``, plus ``cross_k`` / ``cross_v`` (L, B,
    F, Hkv, D), each decoder layer's cross K/V of the encoded frames. Given
    an earlier ``cache`` of the same shapes, it is zeroed and refilled in
    place instead, so a step captured over it keeps binding it."""
    enc = encode(params, cfg, frames)
    b, f, _ = enc.shape
    if cache is None:
        cache = lm.init_cache(cfg, b, max_len, device=frames.device)
        shape = (cfg.n_layers, b, f, cfg.n_kv, cfg.hd)
        for key in ("cross_k", "cross_v"):
            cache[key] = torch.empty(shape, dtype=enc.dtype, device=enc.device)
    else:
        lm.zero_cache(cache)
    for i in range(cfg.n_layers):
        k, v = _cross_kv(params.layer(i), cfg, enc)
        cache["cross_k"][i].copy_(k)
        cache["cross_v"][i].copy_(v)
    return cache


@torch.no_grad()
def decode_step(
    params: lm.LMParams, cfg: ModelConfig, token: torch.Tensor, cache: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decoder step: token (B, 1) at position ``cache["len"]`` ->
    (logits (B, 1, V) f32, cache). Each layer writes its self-attention
    K/V row into its ring in place (``lm._decode_attn_block``), attends
    over the cross K/V of all F frames (``attention.decode_attention``),
    then runs its FFN; ``len`` advances in place. The returned cache is the
    same dict and the same tensors."""
    _require_encdec(cfg, "decode_step")
    x = embed(token, params["embed"], torch_dtype(cfg))
    pos = cache["len"].long()
    b = x.shape[0]
    frames = cache["cross_k"].shape[2]
    for i in range(cfg.n_layers):
        lp = params.layer(i)
        x = lm._decode_attn_block(lp, cfg, x, cache["k"][i], cache["v"][i], pos)
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        q = split_heads(dense(h, lp["x_wq"]), cfg.n_heads, cfg.hd)
        o = attn.decode_attention(q, cache["cross_k"][i], cache["cross_v"][i], frames)
        x = x + dense(merge_heads(o), lp["x_wo"])
        x, _ = lm._ffn_block(lp, cfg, x)
    cache["len"].add_(1)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed_logits(x, table, cfg.vocab), cache
