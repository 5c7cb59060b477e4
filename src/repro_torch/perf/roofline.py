"""The hardware record the fleet's cost model reads: the port's
counterpart of ``repro.perf.roofline``'s ``HwModel`` and ``HW``.

``HW`` is the card the port runs on, the H100 SXM. Its HBM bandwidth and
bf16 peak are ``core.resource_model.H100_SXM``'s (NVIDIA's data sheet),
so the two records cannot drift apart; its link bandwidth is NVLink 4's,
from the same data sheet: 900 GB/s both ways, so 450 GB/s one way, the
rate of a prefill-to-decode handoff. The field names are the reference's,
so a record built from the reference's values compares field for field;
``ici_bw`` keeps its name, though on this card the link is NVLink, not a
TPU's ICI. No TPU figure is kept here. The reference's ``RooflineReport``
and the rest of its module have no counterpart yet.
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
