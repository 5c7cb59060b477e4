"""Folding-solution search (paper §III-B "modelling exercise").

Chooses per-layer (PE, SIMD) to maximise pipeline throughput subject to a
device's LUT/BRAM budget: iteratively doubles the parallelism of the
slowest stage (largest II) while resources allow — the standard FINN
balancing strategy.

The port's copy of ``repro.core.folding``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buffers import Folding, LayerSpec, mvau_buffer, mvau_cycles
from repro_torch.core.dataflow import PipelineModel
from repro_torch.core.resource_model import BRAM18, FpgaDevice

# Calibrated MVAU compute cost: LUTs per (PE x SIMD) lane for low-precision
# (XNOR-popcount style) arithmetic, incl. accumulators + thresholding.
LUT_PER_LANE_W1 = 5.5
LUT_PER_LANE_W2 = 9.0


def mvau_luts(layer: LayerSpec, f: Folding) -> float:
    per_lane = LUT_PER_LANE_W1 if layer.w_bits == 1 else LUT_PER_LANE_W2
    return per_lane * f.pe * f.simd + 120.0  # fixed control overhead


@dataclasses.dataclass
class FoldingSolution:
    layers: list[LayerSpec]
    foldings: list[Folding]

    def model(self, f_mhz: float) -> PipelineModel:
        return PipelineModel(tuple(self.layers), tuple(self.foldings), f_mhz)

    @property
    def luts(self) -> float:
        return sum(mvau_luts(l, f) for l, f in zip(self.layers, self.foldings))

    @property
    def brams(self) -> int:
        return sum(
            mvau_buffer(l, f).blocks(BRAM18)
            for l, f in zip(self.layers, self.foldings)
        )


def _grow_options(layer: LayerSpec, f: Folding) -> list[Folding]:
    """Legal parallelism-doubling moves for one layer."""
    opts = []
    if (layer.c_out // f.pe) % 2 == 0:
        opts.append(Folding(f.pe * 2, f.simd))
    fold_in = layer.k * layer.k * layer.c_in
    if (fold_in // f.simd) % 2 == 0:
        opts.append(Folding(f.pe, f.simd * 2))
    return opts


def search_folding(
    layers: Sequence[LayerSpec],
    device: FpgaDevice,
    lut_budget_frac: float = 0.7,
    bram_budget_frac: float = 0.9,
    target_ii: int | None = None,
) -> FoldingSolution:
    """Greedy throughput-balancing folding search.

    Repeatedly doubles parallelism of the current bottleneck layer while the
    design fits ``lut_budget_frac`` of LUTs and ``bram_budget_frac`` of
    BRAM18s (OCM is the expected bottleneck, paper Table I).
    """
    sol = FoldingSolution(list(layers), [Folding(1, 1) for _ in layers])
    lut_budget = device.luts * lut_budget_frac
    bram_budget = device.bram18 * bram_budget_frac
    while True:
        cycles = [mvau_cycles(l, f) for l, f in zip(sol.layers, sol.foldings)]
        worst = max(range(len(cycles)), key=lambda i: cycles[i])
        if target_ii is not None and cycles[worst] <= target_ii:
            return sol
        layer, f = sol.layers[worst], sol.foldings[worst]
        grown = False
        for cand in _grow_options(layer, f):
            old = sol.foldings[worst]
            sol.foldings[worst] = cand
            if sol.luts <= lut_budget and sol.brams <= bram_budget:
                grown = True
                break
            sol.foldings[worst] = old
        if not grown:
            # bottleneck layer cannot grow: try the next-worst layers once,
            # else stop — pipeline is resource-bound.
            order = sorted(range(len(cycles)), key=lambda i: -cycles[i])
            for i in order[1:]:
                for cand in _grow_options(sol.layers[i], sol.foldings[i]):
                    old = sol.foldings[i]
                    sol.foldings[i] = cand
                    if (
                        sol.luts <= lut_budget
                        and sol.brams <= bram_budget
                        and mvau_cycles(sol.layers[i], cand) >= cycles[worst] // 4
                    ):
                        grown = True
                        break
                    sol.foldings[i] = old
                if grown:
                    break
            if not grown:
                return sol
