"""OCM mapping-efficiency reports (paper Eq. 1, Tables I/IV).

The port's copy of ``repro.core.efficiency``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buffers import WeightBuffer
from repro_torch.core.packing import PackItem, Packing, baseline_packing
from repro_torch.core.resource_model import BRAM18, FpgaDevice, RamPrimitive, fcmp_lut_overhead


@dataclasses.dataclass(frozen=True)
class MemSubsystemReport:
    """One row of Table IV."""

    name: str
    n_buffers: int
    brams: int
    efficiency: float  # E, Eq. 1
    lut_overhead: float
    max_height: int
    odd_height_bins: int

    def row(self) -> str:
        return (
            f"{self.name:28s} {self.n_buffers:5d} {self.brams:6d} "
            f"{100*self.efficiency:6.1f}% {self.lut_overhead/1000:7.1f}k "
            f"H_B={self.max_height}"
        )


def report(name: str, packing: Packing, ram: RamPrimitive = BRAM18) -> MemSubsystemReport:
    heights = packing.heights
    max_h = max(heights) if heights else 0
    odd = packing.odd_height_bins
    # the odd/even split applies to one buffer per odd bin; its stream width
    # bounds the DWC cost
    widths = packing.bin_widths_bits()
    odd_w = max(
        (w for w, b in zip(widths, packing.bins) if len(b) > 1 and len(b) % 2 == 1),
        default=0,
    )
    lut = fcmp_lut_overhead(widths, heights, odd, odd_w)
    return MemSubsystemReport(
        name=name,
        n_buffers=len(packing.items),
        brams=packing.total_blocks,
        efficiency=packing.efficiency,
        lut_overhead=lut,
        max_height=max_h,
        odd_height_bins=odd,
    )


def baseline_report(
    name: str, buffers: Sequence[WeightBuffer], ram: RamPrimitive = BRAM18
) -> MemSubsystemReport:
    items = [PackItem(b) for b in buffers]
    return report(name, baseline_packing(items, ram), ram)


def device_utilization(
    dev: FpgaDevice, brams: int, luts: float
) -> dict[str, float]:
    return {
        "bram_pct": 100.0 * brams / dev.bram18,
        "lut_pct": 100.0 * luts / dev.luts,
        "fits": brams <= dev.bram18 and luts <= dev.luts,
    }
