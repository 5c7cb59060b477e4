"""Execute a residency plan: budgeted paged decode over a split weight set.

Port of ``repro.runtime.residency.executor`` for the dense and MoE
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

from repro_torch.models.config import PORTED_FAMILIES, ModelConfig


def supports_budgeted_decode(cfg: ModelConfig) -> bool:
    """Budgeted decode = paged decode + a streamable FFN weight set, for
    the families the port serves: dense (a per-layer stream mask) and moe
    (per (layer, expert) over the dropless dispatch). The reference also
    covers vlm, which is not ported."""
    return cfg.family in PORTED_FAMILIES
