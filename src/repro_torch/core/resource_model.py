"""Memory-resource models: the port's copy of ``repro.core.resource_model``.

Keeps what the packing solvers need (``RamPrimitive``, ``BRAM18``) and
replaces the reference's TPU records with one for the card the port runs
on, ``H100_SXM``. Its figures are NVIDIA's data-sheet values for the H100
SXM part; none is a TPU figure.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class RamPrimitive:
    """A fixed-geometry on-chip RAM block.

    ``configs`` is the set of legal (width_bits, depth_words) aspect ratios
    the primitive supports; ``capacity_bits`` is identical across configs.
    """

    name: str
    capacity_bits: int
    n_ports: int
    configs: tuple[tuple[int, int], ...]

    def blocks_for(self, width_bits: int, depth_words: int) -> int:
        """Physical blocks needed for one logical buffer, best legal config:
        the aspect ratio minimising ceil(w/W) * ceil(d/D)."""
        if width_bits <= 0 or depth_words <= 0:
            return 0
        return min(
            math.ceil(width_bits / w_cfg) * math.ceil(depth_words / d_cfg)
            for w_cfg, d_cfg in self.configs
        )

    def efficiency_for(self, width_bits: int, depth_words: int) -> float:
        """Mapping efficiency of a single buffer (paper Eq. 1, one buffer)."""
        n = self.blocks_for(width_bits, depth_words)
        if n == 0:
            return 1.0
        return (width_bits * depth_words) / (n * self.capacity_bits)


# Xilinx 18 Kib BRAM: true-dual-port widths up to 18; the 36-wide config is
# the simple-dual-port mode, legal for read-only weight memories.
BRAM18 = RamPrimitive(
    name="BRAM18",
    capacity_bits=18 * 1024,
    n_ports=2,
    configs=((1, 16384), (2, 8192), (4, 4096), (9, 2048), (18, 1024), (36, 512)),
)


@dataclasses.dataclass(frozen=True)
class GpuChip:
    """An NVIDIA GPU as the residency planner sees it.

    The planner's padding granule is a ``(tile_rows, tile_row_bytes)``
    pair of the uint8 weight carrier: a block of ``r`` carrier rows and
    ``c`` byte columns occupies ``ceil(r / tile_rows) * ceil(c /
    tile_row_bytes)`` tiles, however oddly it is shaped, which is what a
    BRAM's fixed aspect ratios are on the FPGA. On the H100 the granule is
    8 rows x 128 B: 128 B is one L2 cache line, and also one pass of the
    32 shared-memory banks x 4 B, so a carrier column block of 128 B is
    the unit both the L2 and a shared-memory ring move without waste. With
    this granule the plan has the same bins as the reference's plan.
    """

    name: str
    sms: int
    smem_per_sm_bytes: int
    l2_bytes: int
    hbm_bytes: int
    hbm_bw: float  # bytes/s
    peak_bf16_flops: float  # dense tensor-core FLOP/s
    tile_rows: int = 8
    tile_row_bytes: int = 128

    @property
    def tile_bytes(self) -> int:
        return self.tile_rows * self.tile_row_bytes

    def tile_blocks_for(self, rows: int, cols: int) -> int:
        return math.ceil(rows / self.tile_rows) * math.ceil(cols / self.tile_row_bytes)


# NVIDIA H100 SXM data sheet and Hopper architecture white paper.
H100_SXM = GpuChip(
    name="h100_sxm",
    sms=132,
    smem_per_sm_bytes=228 * 1024,
    l2_bytes=50 * 1024**2,
    hbm_bytes=80 * 1024**3,
    hbm_bw=3.35e12,
    peak_bf16_flops=989e12,
)
