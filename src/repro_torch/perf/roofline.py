"""Three-term roofline of one step, from its op walk: the port's
counterpart of ``repro.perf.roofline``.

    compute term    = dot_flops / peak FLOP/s            (per device)
    memory term     = traffic_bytes / HBM bandwidth      (per device)
    collective term = collective_bytes / link bandwidth  (per device)

The reference reads the three counts from the compiled SPMD module's HLO
(``perf.hlo_analysis``); the port reads them from ``perf.op_analysis``,
a walk of the ATen ops (and the kernels' own reports) of one eager step.
The walk runs on one process, so its counts are one device's.

``HW`` is the card the port runs on, the H100 SXM. Its HBM bandwidth and
bf16 peak are ``core.resource_model.H100_SXM``'s (NVIDIA's data sheet),
so the two records cannot drift apart; its link bandwidth is NVLink 4's,
from the same data sheet: 900 GB/s both ways, so 450 GB/s one way, the
rate of a prefill-to-decode handoff. The field names are the reference's,
so a record built from the reference's values compares field for field;
``ici_bw`` keeps its name, though on this card the link is NVLink, not a
TPU's ICI. No TPU figure is kept here.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.resource_model import H100_SXM

NVLINK4_ONE_WAY_BW = 450e9  # bytes/s: half of NVLink 4's 900 GB/s, both ways


@dataclasses.dataclass(frozen=True)
class HwModel:
    name: str = H100_SXM.name
    peak_flops: float = H100_SXM.peak_bf16_flops  # bf16, dense
    hbm_bw: float = H100_SXM.hbm_bw  # bytes/s
    ici_bw: float = NVLINK4_ONE_WAY_BW  # bytes/s one way; NVLink on this card


HW = HwModel()


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    name: str
    flops: float  # per-device dot flops
    hbm_bytes: float  # per-device bytes moved
    coll_bytes: float  # per-device collective operand bytes
    coll_breakdown: dict
    model_flops: float  # 6*N*D (dense) / 6*N_active*D (MoE), total
    n_devices: int
    hw: HwModel = HW

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.hw.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap model: step >= max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total dot flops (recompute and redundancy waste)."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the peak-bound step time."""
        useful_t = (self.model_flops / self.n_devices) / self.hw.peak_flops
        return useful_t / self.step_time if self.step_time else 0.0

    def row(self) -> str:
        return (
            f"{self.name:34s} {self.t_compute*1e3:9.2f} "
            f"{self.t_memory*1e3:9.2f} {self.t_collective*1e3:9.2f} "
            f"{self.bottleneck:10s} {self.useful_flops_ratio:6.2f} "
            f"{self.roofline_fraction*100:6.1f}%"
        )


def model_flops(cfg, shape) -> float:
    """6*N*D for training; 2*N*D for a single forward (prefill); 2*N_active*B
    per decoded token."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    # decode: one token per sequence in the batch
    return 2.0 * n_active * shape.global_batch


def roofline(name: str, cost, cfg, shape, n_devices: int, hw: HwModel = HW) -> RooflineReport:
    """The roofline of one step from its ``op_analysis.OpCost`` (the
    reference takes the compiled artifact and walks its HLO)."""
    return RooflineReport(
        name=name,
        flops=cost.dot_flops,
        hbm_bytes=cost.traffic_bytes,
        coll_bytes=cost.total_collective_bytes,
        coll_breakdown=dict(cost.collective_bytes),
        model_flops=model_flops(cfg, shape),
        n_devices=n_devices,
        hw=hw,
    )
