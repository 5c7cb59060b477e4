"""Model configuration: the port's own copy of ``repro.models.config``.

``ModelConfig``, ``reduced``, ``pad_to``, ``modality_batch_leaves``,
the assigned input shapes (``ShapeConfig``, ``SHAPES``,
``shape_applicable``) and the family tuples, copied so that the port
never imports the reference package. ``dtype`` stays a string
("bfloat16" / "float32"); ``torch_dtype`` maps it to torch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Families whose decode state is a growing attention KV cache.
ATTN_KV_FAMILIES = ("dense", "vlm", "moe")
# Families the KV-pool serving path covers in the reference.
PAGED_FAMILIES = ATTN_KV_FAMILIES + ("hybrid",)
# Families whose prompts can prefill in budget-sized chunks across rounds.
CHUNKABLE_FAMILIES = ("dense", "vlm", "moe", "hybrid")
# Families whose prompt KV can be served out of a radix prefix cache.
PREFIX_CACHE_FAMILIES = ("dense", "vlm", "moe", "hybrid")
# Families whose dense FFN stores 1/2-bit weights as packed uint8 carriers.
PACKING_FAMILIES = ("dense", "vlm", "encdec", "hybrid")
# Families the port serves: every family of the reference.
PORTED_FAMILIES = ("dense", "vlm", "encdec", "moe", "hybrid", "ssm")
# The served families the KV pool, the scheduler and the residency plan
# take: ported and paged (pure ssm serves through the fixed-batch engine,
# enc-dec through its own decode state: ``models.encdec``).
POOL_FAMILIES = tuple(f for f in PORTED_FAMILIES if f in PAGED_FAMILIES)
# The served families whose every layer is an attention layer: the
# attention-KV entry points (``prefill_with_cache``, ``decode_step_paged``,
# ``prefill_chunk_paged``, ``verify_chunk_paged``) and budgeted decode
# take these; hybrid serves through its own entry points.
ATTN_SERVED_FAMILIES = tuple(f for f in PORTED_FAMILIES if f in ATTN_KV_FAMILIES)
# Families the port trains: every family (enc-dec through
# ``models.encdec.loss_fn``, the others through ``lm.loss_fn``).
TRAIN_FAMILIES = PORTED_FAMILIES
# Families whose full-sequence forward (``lm.trunk``, ``forward``,
# ``prefill``) the port runs: every family but enc-dec, which runs
# ``models.encdec.trunk``.
FORWARD_FAMILIES = tuple(f for f in PORTED_FAMILIES if f != "encdec")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    sliding_window: int = 0  # 0 -> full attention
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (Zamba2): one shared attention block every k SSM layers ---
    hybrid_attn_every: int = 0
    # --- encoder-decoder (Whisper backbone) ---
    n_enc_layers: int = 0
    frontend_len: int = 0
    # --- vlm ---
    n_patches: int = 0
    # --- common ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad: int = 256
    w_bits: int = 0  # 0 = dense weights; 1/2 = packed uint8 carriers
    dtype: Any = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab, self.vocab_pad)

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM, hybrid, or sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def n_kv_cache_layers(self) -> int:
        """Layers that hold a growing KV cache."""
        if self.family == "hybrid":
            return self.n_layers // max(1, self.hybrid_attn_every)
        if self.family in ATTN_KV_FAMILIES or self.family == "encdec":
            return self.n_layers
        return 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, ff, v = self.d_model, self.d_ff, self.padded_vocab
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv
        attn = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
        dense_ffn = 3 * d * ff
        per_layer = 0
        if self.family in ("dense", "vlm", "encdec"):
            per_layer = attn + dense_ffn + 2 * d
        elif self.family == "moe":
            per_layer = attn + self.n_experts * dense_ffn + d * self.n_experts + 2 * d
        elif self.family in ("ssm", "hybrid"):
            di, st, nhs = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = (
                d * (2 * di + 2 * st + nhs)  # in-proj (z, x, B, C, dt)
                + self.conv_kernel * (di + 2 * st)  # causal conv
                + di * d  # out-proj
                + 2 * nhs  # A_log, D
                + di  # gate norm
            )
            per_layer = ssm + 2 * d
        total = self.n_layers * per_layer
        if self.family == "hybrid":
            total += attn + dense_ffn + 2 * d  # one shared block, reused
        if self.family == "encdec":
            # the encoder's layers, and the decoder's cross-attention
            total += self.n_enc_layers * (attn + dense_ffn + 2 * d)
            total += self.n_layers * (attn + 2 * d)
        emb = v * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def active_params(self) -> int:
        """Params touched per token (MoE activates top-k of E experts)."""
        if self.family != "moe":
            return self.n_params()
        inactive = (
            self.n_layers * (self.n_experts - self.experts_per_token)
            * 3 * self.d_model * self.d_ff
        )
        return self.n_params() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and the reason when it does
    not: a 500k-token decode needs sub-quadratic attention (an enc-dec
    never runs it)."""
    if shape.name == "long_500k" and (
        not cfg.supports_long_context or cfg.family == "encdec"
    ):
        return False, "SKIP(full-attention: 500k dense KV is sub-quadratic-only)"
    return True, ""


def modality_batch_leaves(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Extra (non-token) batch leaves per family: name -> per-example
    shape (batch dim excluded): the vlm's patch embeddings, the enc-dec's
    audio frames (both stubbed frontends' outputs)."""
    if cfg.family == "vlm":
        return {"prefix_embeds": (cfg.n_patches, cfg.d_model)}
    if cfg.family == "encdec":
        return {"frames": (cfg.frontend_len, cfg.d_model)}
    return {}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, str(cfg.dtype))


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized config of the same family (CPU-runnable)."""
    small = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        vocab_pad=64,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2)
        if cfg.experts_per_token
        else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        ssm_chunk=16,
        hybrid_attn_every=min(cfg.hybrid_attn_every, 2)
        if cfg.hybrid_attn_every
        else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        frontend_len=min(cfg.frontend_len, 32) if cfg.frontend_len else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
