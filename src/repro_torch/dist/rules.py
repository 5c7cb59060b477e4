"""Per-family leaf rules: which dims of which leaves want which region:
the port's copy of ``repro.dist.rules``.

Each rule is an *ordered candidate list* ``[(dim, axes), ...]`` handed to
``legalize.first_legal``: the first divisible placement wins, later
entries are the fallback ladder, and an empty list (or no legal candidate)
means replicate. Negative dims count from the trailing edge so one rule
covers stacked (leading layer axis), expert-stacked and unstacked variants
of the same logical weight.

The naming convention is the one ``models.lm.init_params`` establishes:

* column-parallel (shard the output features): ``wq wk wv`` (+ ``x_``
  cross-attention twins), the SSM in-projections ``in_z in_x in_b in_c
  in_dt``, the FFN up-projections ``w1 w3`` and the MoE ``router``;
* row-parallel (shard the input features, so the matmul's partial sums
  meet in one all-reduce): ``wo``/``x_wo``, ``w2`` and the SSM ``out``;
* table-sharded on dim 0: ``embed`` / ``unembed`` (``vocab_pad`` keeps
  the padded vocab divisible by any realistic TP degree);
* expert-parallel: MoE expert stacks ``(L, E, d, ff)`` shard the expert
  axis first — the paper's best-fit family of many oddly-shaped buffers
  maps one expert group per model-axis slice;
* replicated: norms, biases and the per-channel quantization ``scale``
  vectors (small, consumed everywhere).
"""

from __future__ import annotations

COLUMN_PARALLEL = {
    "wq", "wk", "wv", "x_wq", "x_wk", "x_wv",
    "in_z", "in_x", "in_b", "in_c", "in_dt",
    "w1", "w3", "router",
}
ROW_PARALLEL = {"wo", "x_wo", "w2", "out"}
TABLE = {"embed", "unembed"}
CONV = {"conv_x", "conv_b", "conv_c"}
REPLICATED = {
    "ln1", "ln2", "ln_x", "final_norm", "enc_final_norm",
    "gate_norm", "dt_bias", "a_log", "d_skip", "scale",
}
# MoE expert stacks carry (layer, expert, in, out); only these leaf names
# ever have the expert lead under the 'moe' family.
EXPERT_STACKED = {"w1", "w3", "w2"}


def param_candidates(
    name: str,
    shape: tuple[int, ...],
    tensor_axes: tuple[str, ...],
    *,
    family: str = "dense",
) -> list[tuple[int, tuple[str, ...]]]:
    """Ordered (dim, axes) candidates for one named parameter leaf.

    ``name`` is the logical leaf name; packed carriers pass their parent
    weight's name (the carrier shards exactly like the weight it encodes —
    packing changed the word width, not the bin geometry).
    """
    tp = tuple(tensor_axes)
    if not tp or len(shape) < 1:
        return []
    if name in REPLICATED:
        return []
    if name in TABLE:
        # vocab dim first; the embedding width is the fallback
        return [(0, tp), (-1, tp)]
    if len(shape) < 2:
        return []
    if family == "moe" and name in EXPERT_STACKED and len(shape) == 4:
        # expert-parallel first, then the within-expert matmul dims
        col_or_row = (-1, tp) if name != "w2" else (-2, tp)
        return [(1, tp), col_or_row, ((-2, tp) if name != "w2" else (-1, tp))]
    if name in COLUMN_PARALLEL:
        return [(-1, tp), (-2, tp)]
    if name in ROW_PARALLEL:
        return [(-2, tp), (-1, tp)]
    if name in CONV:
        # (L, K, channels): channels only — K is the tap count (3..4)
        return [(-1, tp)]
    # unknown leaf: generic fallback, trailing dims first (features live
    # last by convention), never the leading stacked-layer dim
    return [(d, tp) for d in range(len(shape) - 1, 0, -1)]


def cache_candidates(
    name: str,
    shape: tuple[int, ...],
    tensor_axes: tuple[str, ...],
) -> list[tuple[int, tuple[str, ...]]]:
    """Tensor-region candidates for one decode-state leaf.

    Attention caches ``(L, B, S, H, D)`` prefer the KV-head dim; when the
    head count does not divide TP the head_dim is next — matching the
    split-d decode layout (the reference's
    ``attention.decode_attention_split_d``) that keeps the cache resident
    instead of resharding it every step. SSM
    state ``(L, B, H, P, N)`` shards its head dim; conv rings shard their
    channel dim.
    """
    tp = tuple(tensor_axes)
    if not tp:
        return []
    if name in ("k", "v", "cross_k", "cross_v") and len(shape) == 5:
        return [(3, tp), (4, tp)]
    if name == "ssm" and len(shape) == 5:
        return [(2, tp), (3, tp)]
    if name in CONV and len(shape) == 4:
        return [(3, tp)]
    return []
