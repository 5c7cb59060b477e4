"""Execute a residency plan: budgeted paged decode over a split weight set.

Port of ``repro.runtime.residency.executor`` for the dense, vlm and MoE
families. The plan's ``layer_stream_mask`` splits the layers into
*resident* (the FFN runs the ordinary path: ``packed_matmul``, or
``torch.matmul`` for dense weights) and *streamed* (the FFN runs
``stream_matmul``, whose ring depth is the plan's ``stream_ahead``, the
GALS R_F); for MoE its ``expert_stream_mask`` does the same per (layer,
expert) inside the dropless dispatch. ``Scheduler`` builds that step with
``runtime.steps.make_budgeted_paged_serve_step`` over ``plan.stream_mask``.
On the CPU both paths resolve to plain versions with the same arithmetic,
so budgeted decode is token-identical to the unbudgeted path there.
"""

from __future__ import annotations

from repro_torch.models.config import ATTN_SERVED_FAMILIES, ModelConfig


# the reference's refusal (repro.runtime.residency.executor)
BUDGET_REFUSAL = (
    "budgeted decode needs a streamable-FFN attention family; got {family!r} "
    "(ssm/hybrid state is out of the residency executor's scope)"
)


def supports_budgeted_decode(cfg: ModelConfig) -> bool:
    """Budgeted decode = paged decode + a streamable FFN weight set, for
    the attention families the port serves, as the reference's: dense and
    vlm (a per-layer stream mask) and moe (per (layer, expert) over the
    dropless dispatch). Like the reference, it leaves out hybrid, whose
    SSM state is out of the executor's scope."""
    return cfg.family in ATTN_SERVED_FAMILIES
