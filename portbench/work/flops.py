"""Work counted from shapes: the model FLOPs of a served token, and the
bytes and FLOPs of the packed FFN products of a decode step.

Sizes come from a configuration file's keys. Nothing here reads the
program: the counts are the benchmark's own.
"""

from __future__ import annotations

from work.peaks import H100_SXM


def matmul_params(c: dict) -> int:
    """Weights a token multiplies by: the attention projections, the FFN
    (the router and the k experts a token takes, for an MoE) of every
    layer, and the unembedding over the vocabulary."""
    d, ff = int(c["hidden_size"]), int(c["intermediate_size"])
    h, hkv, hd = int(c["num_attention_heads"]), int(c["num_key_value_heads"]), int(c["head_dim"])
    attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
    if int(c.get("num_experts", 0)):
        ffn = d * int(c["num_experts"]) + int(c["num_experts_per_tok"]) * 3 * d * ff
    else:
        ffn = 3 * d * ff
    return int(c["num_hidden_layers"]) * (attn + ffn) + int(c["vocab_size"]) * d


def attention_flops(c: dict, context: int) -> int:
    """QK and PV of one token over ``context`` keys, every layer."""
    return 4 * int(c["num_hidden_layers"]) * int(c["num_attention_heads"]) * int(c["head_dim"]) * context


def token_flops(c: dict, context: int) -> int:
    """Model FLOPs of one token at ``context`` keys (itself included)."""
    return 2 * matmul_params(c) + attention_flops(c, context)


def span_attention_flops(c: dict, first: int, last: int) -> int:
    """Attention FLOPs of the tokens at positions first..last-1, each over
    position + 1 keys."""
    n = last - first
    if n <= 0:
        return 0
    keys = n * (first + last + 1) // 2  # sum of (p + 1) for p in [first, last)
    return attention_flops(c, 1) * keys


def packed_ffn_products(c: dict, rows: int) -> list[dict]:
    """The packed FFN products of one decode step at ``rows`` rows (w1, w3
    and w2 of every layer): each with its bytes (the codes and the f32
    scale read once, x read in bfloat16, y written in float32) and FLOPs."""
    d, ff, bits = int(c["hidden_size"]), int(c["intermediate_size"]), int(c["w_bits"])
    out = []
    for k, n in ((d, ff), (d, ff), (ff, d)):
        out.append({
            "k": k, "n": n,
            "bytes": k * n * bits // 8 + 4 * n + 2 * rows * k + 4 * rows * n,
            "flops": 2 * rows * k * n,
        })
    return out * int(c["num_hidden_layers"])


def least_seconds(bytes_: float, flops: float, peaks: dict = H100_SXM) -> float:
    """The roofline's least time: the larger of the bytes over the HBM rate
    and the FLOPs over the bf16 rate."""
    return max(bytes_ / peaks["hbm_bytes_per_s"], flops / peaks["bf16_flops"])
