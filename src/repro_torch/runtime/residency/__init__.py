"""Budgeted weight residency (the executed analogue of FCMP's §V port).

``plan`` compiles a :class:`RuntimeResidencyPlan` from (model config x
budget) with the ``core.packing`` solvers running over
``core.vmem_plan.WeightBlock`` carriers; ``Scheduler(residency=plan)``
threads the plan into the paged serve step, so resident layers (MoE:
experts) run the ordinary FFN path and streamed ones run
``kernels.weight_stream.stream_matmul``.
"""

from repro_torch.runtime.residency.executor import BUDGET_REFUSAL, supports_budgeted_decode
from repro_torch.runtime.residency.plan import (
    RuntimeResidencyPlan,
    TrafficProfile,
    compile_residency_plan,
    fixed_hbm_bytes,
    read_weight,
    stream_ahead_depth,
    weight_blocks,
)

__all__ = [
    "BUDGET_REFUSAL",
    "RuntimeResidencyPlan",
    "TrafficProfile",
    "compile_residency_plan",
    "fixed_hbm_bytes",
    "read_weight",
    "stream_ahead_depth",
    "supports_budgeted_decode",
    "weight_blocks",
]
