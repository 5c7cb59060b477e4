"""Memory-resource models: the port's copy of ``repro.core.resource_model``.

Keeps the FPGA side as it is: the RAM primitives (``BRAM18``, ``URAM``),
the FPGA device records (``DEVICES``, Xilinx data-sheet resource counts)
and the LUT-overhead model of the GALS memory subsystem. It replaces the
reference's TPU records with one for the card the port runs on,
``H100_SXM``, whose figures are NVIDIA's data-sheet values for the H100
SXM part, and its TPU porting ladder (``TPU_TIERS``) with a ladder of
NVIDIA parts, ``GPU_TIERS``, each from its data sheet. No figure here is
measured, and none is a TPU's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


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


# UltraRAM: fixed 72x4096, 2 ports.
URAM = RamPrimitive(
    name="URAM",
    capacity_bits=288 * 1024,
    n_ports=2,
    configs=((72, 4096),),
)


@dataclasses.dataclass(frozen=True)
class FpgaDevice:
    name: str
    luts: int
    bram18: int
    uram: int
    dsp: int
    slrs: int = 1
    # Nominal achievable clock for BRAM primitives vs compiled dataflow
    # compute logic (paper section IV: memory primitives are specified for
    # >600 MHz while HLS compute closes at 100-300 MHz).
    f_mem_max_mhz: float = 600.0
    f_compute_typ_mhz: float = 200.0

    @property
    def ocm_bits(self) -> int:
        return self.bram18 * BRAM18.capacity_bits + self.uram * URAM.capacity_bits


# Resource counts per Xilinx data sheets (DS190, DS962, U250/U280 product
# briefs). BRAM is counted in 18 Kib units (1 BRAM36 = 2 BRAM18).
DEVICES: dict[str, FpgaDevice] = {
    "zynq7020": FpgaDevice("zynq7020", luts=53_200, bram18=280, uram=0, dsp=220),
    "zynq7012s": FpgaDevice("zynq7012s", luts=34_400, bram18=144, uram=0, dsp=120),
    "u250": FpgaDevice(
        "u250", luts=1_728_000, bram18=5376, uram=1280, dsp=12_288, slrs=4
    ),
    "u280": FpgaDevice(
        "u280", luts=1_304_000, bram18=4032, uram=960, dsp=9024, slrs=3
    ),
}


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

    ``onchip_bytes`` is the planner's on-chip budget, the role a TPU's
    VMEM plays in the reference: the L2. It is the only on-chip store that
    outlives a kernel launch (shared memory and registers are a launch's
    own), so it is the only place a weight could stay resident across
    decode steps.
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

    @property
    def onchip_bytes(self) -> int:
        return self.l2_bytes

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

# The porting ladder (the paper's §V question, one level up the
# hierarchy, as the reference's ``TPU_TIERS``): can a model and its
# traffic move from a bigger card to a smaller or cheaper one, and at what
# loss in throughput? The rungs differ in memory bandwidth, peak and
# memory size; a port that streams more weight bytes a decode step loses
# most where bandwidth is scarce. Every figure is from the part's NVIDIA
# data sheet (dense bf16 tensor-core FLOP/s, without sparsity) and its
# architecture white paper (SMs, shared memory per SM, L2); none is
# measured.
# NVIDIA L4 Tensor Core GPU data sheet; Ada Lovelace architecture white paper.
L4 = GpuChip(
    name="l4",
    sms=58,
    smem_per_sm_bytes=100 * 1024,
    l2_bytes=48 * 1024**2,
    hbm_bytes=24 * 1024**3,  # GDDR6
    hbm_bw=300e9,
    peak_bf16_flops=121e12,
)
# NVIDIA L40S data sheet; Ada Lovelace architecture white paper.
L40S = GpuChip(
    name="l40s",
    sms=142,
    smem_per_sm_bytes=100 * 1024,
    l2_bytes=96 * 1024**2,
    hbm_bytes=48 * 1024**3,  # GDDR6
    hbm_bw=864e9,
    peak_bf16_flops=362e12,
)
# NVIDIA A100 Tensor Core GPU data sheet (80GB PCIe); Ampere architecture
# white paper. The PCIe part, not the SXM one (2,039 GB/s), keeps the
# ladder ordered by bandwidth below the H100 PCIe.
A100_PCIE = GpuChip(
    name="a100_pcie",
    sms=108,
    smem_per_sm_bytes=164 * 1024,
    l2_bytes=40 * 1024**2,
    hbm_bytes=80 * 1024**3,
    hbm_bw=1.935e12,
    peak_bf16_flops=312e12,
)
# NVIDIA H100 Tensor Core GPU data sheet (PCIe); Hopper architecture white paper.
H100_PCIE = GpuChip(
    name="h100_pcie",
    sms=114,
    smem_per_sm_bytes=228 * 1024,
    l2_bytes=50 * 1024**2,
    hbm_bytes=80 * 1024**3,
    hbm_bw=2.0e12,
    peak_bf16_flops=756e12,
)
# Ordered small -> large by (hbm_bw, peak_bf16_flops): the porting sweep
# walks this ladder as the paper walks U250 -> U280 and 7020 -> 7012S.
# Only the last rung is the card the port runs and measures on.
GPU_TIERS: dict[str, GpuChip] = {
    "l4": L4,
    "l40s": L40S,
    "a100_pcie": A100_PCIE,
    "h100_pcie": H100_PCIE,
    "h100_sxm": H100_SXM,
}


# --------------------------------------------------------------------------
# FCMP LUT-overhead model
# --------------------------------------------------------------------------

# The GALS transformation (paper Fig. 6) adds, per packed memory bin:
#   * a weight streamer: address generator + round-robin port scheduler,
#   * one AXI-stream CDC FIFO per logical buffer (width-proportional),
#   * for odd bin heights, data-width converters (DWC) on the split buffer.
# The constants below are calibrated against Table IV:
#   CNV-W1A1-P4:  96 bins  -> 3.9 kLUT      CNV-W2A2-P4: 188 bins -> 1.8 kLUT*
#   RN50-U250-P4: 1632 bins -> 51.9 kLUT    RN50-U250-P3: 1804 -> 64.9 kLUT
# (*packed CNV-W2A2 shares streamers across nearly-full bins; the paper's
# numbers bound our model from below/above; we target the RN50-scale fit,
# which dominates any real design decision.)

LUT_PER_STREAMER = 18.0  # address gen + scheduler per occupied bin
LUT_PER_BUFFER = 9.0  # stream decoupling / tagging per logical buffer
LUT_PER_FIFO_BIT = 0.45  # CDC FIFO cost per bit of stream width
LUT_PER_DWC_BIT = 1.1  # data width converter per bit (odd heights only)


def fcmp_lut_overhead(
    bin_widths_bits: Sequence[int],
    buffers_per_bin: Sequence[int],
    odd_height_bins: int = 0,
    odd_split_width_bits: int = 0,
) -> float:
    """Estimate LUT overhead of the packed memory subsystem (Table IV)."""
    assert len(bin_widths_bits) == len(buffers_per_bin)
    luts = 0.0
    for w, nb in zip(bin_widths_bits, buffers_per_bin):
        if nb <= 1:
            # A lone buffer keeps the plain (non-GALS) streamer: no overhead.
            continue
        luts += LUT_PER_STREAMER
        luts += LUT_PER_BUFFER * nb
        luts += LUT_PER_FIFO_BIT * w * nb
    luts += LUT_PER_DWC_BIT * odd_split_width_bits * odd_height_bins
    return luts
