"""Weight-block tiles for the residency planner, on the H100.

The port's copy of the packing bridge in ``repro.core.vmem_plan`` (the
module keeps its name so the counterpart is easy to find). There the tile
is the TPU's (8, 128) VMEM allocation unit. Here it is ``GpuChip``'s
padding granule, 8 carrier rows x 128 B (one L2 line wide): a weight
block of logical shape (r, c) at b bits/weight occupies
``ceil(r*b/8 / 8) * ceil(c / 128)`` tiles, however oddly it is shaped,
the BRAM aspect-ratio waste of the paper one level down. ``pack_blocks``
runs the paper's bin-packing solvers over those tiles so oddly shaped
blocks share tiles; the residency plan then decides, bin by bin, which
layers run the resident kernel path and which stream their weights.
``plan_vmem_residency`` is the reference's per-block greedy plan
(``ResidencyPlan``), and ``blocks_from_buffers`` turns the FPGA side's
weight buffers into blocks; the runtime plans with
``runtime.residency.plan`` instead, as the reference's runtime does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.buffers import WeightBuffer
from repro_torch.core.packing import SOLVERS, GaParams, PackItem, Packing, pack_genetic
from repro_torch.core.resource_model import H100_SXM, GpuChip, RamPrimitive


@dataclasses.dataclass(frozen=True)
class WeightBlock:
    """One layer's packed weight tensor on a single device."""

    name: str
    rows: int  # reduction dim
    cols: int  # output dim
    bits_per_weight: int

    @property
    def logical_bytes(self) -> int:
        return self.rows * self.cols * self.bits_per_weight // 8

    def padded_bytes(self, chip: GpuChip = H100_SXM) -> int:
        """Bytes of the uint8 carrier (rows*bits/8, cols) after padding to
        the chip's tile granule."""
        carrier_rows = math.ceil(self.rows * self.bits_per_weight / 8)
        return chip.tile_blocks_for(carrier_rows, self.cols) * chip.tile_bytes

    def packing_efficiency(self, chip: GpuChip = H100_SXM) -> float:
        return self.logical_bytes / max(1, self.padded_bytes(chip))


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    blocks: tuple[WeightBlock, ...]
    resident: tuple[bool, ...]  # True = held on chip for the whole step
    vmem_budget_bytes: int

    @property
    def resident_bytes(self) -> int:
        return sum(b.padded_bytes() for b, r in zip(self.blocks, self.resident) if r)

    @property
    def streamed_bytes(self) -> int:
        """Bytes re-read per step for the blocks not resident."""
        return sum(b.padded_bytes() for b, r in zip(self.blocks, self.resident) if not r)

    @property
    def hbm_traffic_reduction(self) -> float:
        total = sum(b.padded_bytes() for b in self.blocks)
        return 1.0 - self.streamed_bytes / max(1, total)


def plan_vmem_residency(
    blocks: Sequence[WeightBlock],
    vmem_budget_bytes: int,
    reserve_frac: float = 0.5,
) -> ResidencyPlan:
    """Greedy knapsack by reuse value: every resident byte saves one byte
    of streaming, so blocks with the worst tile-padding efficiency go
    first (they pay their padding once on chip instead of on every
    stream), then the smallest, until ``(1 - reserve_frac)`` of the budget
    is spent."""
    budget = int(vmem_budget_bytes * (1.0 - reserve_frac))
    order = sorted(
        range(len(blocks)),
        key=lambda i: (blocks[i].packing_efficiency(), blocks[i].padded_bytes()),
    )
    resident = [False] * len(blocks)
    used = 0
    for i in order:
        b = blocks[i].padded_bytes()
        if used + b <= budget:
            resident[i] = True
            used += b
    return ResidencyPlan(tuple(blocks), tuple(resident), vmem_budget_bytes)


def blocks_from_buffers(
    buffers: Sequence[WeightBuffer], rows_of: dict[str, tuple[int, int]]
) -> list[WeightBlock]:
    """One block per buffer, its (rows, cols) from ``rows_of`` by name."""
    return [
        WeightBlock(b.name, *rows_of[b.name], bits_per_weight=b.w_bits)
        for b in buffers
    ]


def vmem_tile_ram(chip: GpuChip = H100_SXM) -> RamPrimitive:
    """One carrier tile of ``chip`` as a RAM primitive.

    A carrier column is 8 bits wide and a tile holds ``tile_rows`` carrier
    rows of ``tile_row_bytes`` columns, so ``blocks_for(cols*8,
    carrier_rows)`` equals ``chip.tile_blocks_for(carrier_rows, cols)``
    exactly: the bridge that lets the bin-packing solvers run over weight
    blocks.
    """
    return RamPrimitive(
        name=f"TILE_{chip.name}",
        capacity_bits=chip.tile_bytes * 8,
        n_ports=2,
        configs=((chip.tile_row_bytes * 8, chip.tile_rows),),
    )


def block_item(
    block: WeightBlock, chip: GpuChip = H100_SXM, region: str = ""
) -> PackItem:
    """A WeightBlock's uint8 carrier as a packable buffer: width = cols * 8
    bits (one carrier byte per output channel), depth = carrier rows."""
    carrier_rows = math.ceil(block.rows * block.bits_per_weight / 8)
    buf = WeightBuffer(
        block.name,
        width_bits=block.cols * 8,
        depth_words=carrier_rows,
        w_bits=block.bits_per_weight,
    )
    return PackItem(buf, region=region)


def pack_blocks(
    blocks: Sequence[WeightBlock],
    *,
    chip: GpuChip = H100_SXM,
    max_height: int = 4,
    solver: str = "ffd",
    regions: Sequence[str] | None = None,
) -> Packing:
    """Bin-pack weight-block carriers into shared tile groups.
    ``Packing.total_blocks`` is the tile count of the packed layout and
    ``Packing.efficiency`` paper Eq. 1 over tiles. ``solver`` is a key of
    ``core.packing.SOLVERS`` or ``"ga"``, the paper's genetic packer
    (``pack_genetic``, Table III's defaults at ``max_height``)."""
    items = [
        block_item(b, chip, region=(regions[i] if regions else ""))
        for i, b in enumerate(blocks)
    ]
    if solver == "ga":
        return pack_genetic(items, GaParams(max_height=max_height), vmem_tile_ram(chip))
    return SOLVERS[solver](items, max_height, vmem_tile_ram(chip))
