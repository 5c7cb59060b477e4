"""Logical weight buffers: the port's copy of ``WeightBuffer`` from
``repro.core.buffers``, the class the packing solvers operate on."""

from __future__ import annotations

import dataclasses

from repro_torch.core.resource_model import BRAM18, RamPrimitive


@dataclasses.dataclass(frozen=True)
class WeightBuffer:
    """A logical weight memory: what packing operates on."""

    name: str
    width_bits: int
    depth_words: int
    w_bits: int  # precision of the packed weights (for efficiency accounting)

    @property
    def bits(self) -> int:
        return self.width_bits * self.depth_words

    def blocks(self, ram: RamPrimitive = BRAM18) -> int:
        return ram.blocks_for(self.width_bits, self.depth_words)

    def efficiency(self, ram: RamPrimitive = BRAM18) -> float:
        return ram.efficiency_for(self.width_bits, self.depth_words)
