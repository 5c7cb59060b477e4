"""Compile a weight-residency plan: which FFN layers run resident, which stream.

Port of ``repro.runtime.residency.plan`` over a ``GpuChip``, the H100
record (``core.resource_model.H100_SXM``) unless the caller passes
another (``launch.port`` walks ``GPU_TIERS``):

  * the *streamable set* is the FFN weight blocks, the weight memories
    FCMP packs on the FPGA (for MoE, each expert's three mats);
    attention projections, norms, the router and the embedding stay
    outside the plan,
  * ``core.vmem_plan.pack_blocks`` runs the paper's bin-packing solvers
    over the blocks' uint8 carriers so oddly shaped blocks share tiles,
  * a greedy knapsack marks whole *regions* (one layer each; one expert
    for MoE) as resident, densest traffic first (an expert block is read
    with probability top_k / E a step), until the budget is spent; every
    other layer (expert) streams its weights each decode step through
    ``kernels.weight_stream.stream_matmul``,
  * the paper's ``R_F`` becomes the depth of that kernel's shared-memory
    ring (``stream_ahead_depth``): bit-packing leaves a memory-bandwidth
    surplus (bf16 -> 1/2-bit moves 8-16x fewer bytes) that funds deeper
    prefetch, as the memory-clock surplus funds bin heights > N_ports.

What "resident" means on the H100: it selects the kernel and pins
nothing, as in the reference, whose resident layers run the ordinary
matmul with weights read from HBM on every step. A resident layer runs
the port's ordinary FFN path (``packed_matmul``, or ``torch.matmul`` for
dense weights); a streamed layer runs ``stream_matmul``. The budget's
bytes and the streamed bytes of ``summary`` are plan arithmetic, not a
reservation or a measurement on the card: both paths read every FFN
weight from HBM on every decode step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.gals import N_PORTS
from repro_torch.core.packing import Packing, bin_cost
from repro_torch.core.resource_model import H100_SXM, GpuChip
from repro_torch.core.vmem_plan import WeightBlock, pack_blocks, vmem_tile_ram
from repro_torch.models.config import ModelConfig, torch_dtype

MAX_STREAM_DEPTH = 8
CHIP = H100_SXM
MAX_HEIGHT = 4  # bin height H_B of the packing, as in the reference's default


@dataclasses.dataclass(frozen=True)
class TrafficProfile:
    """What the serve tier is asked to do (the paper's §V "at what
    traffic?"): the dense plan does not depend on it; ``fixed_hbm_bytes``
    does."""

    lanes: int = 8  # concurrent decode lanes (batch)
    prompt_len: int = 512
    gen_len: int = 128

    @property
    def mean_context(self) -> int:
        """Average KV rows held per lane over a request's decode phase."""
        return self.prompt_len + self.gen_len // 2


def _dtype_bytes(cfg: ModelConfig) -> int:
    return torch.empty((), dtype=torch_dtype(cfg)).element_size()


def _block_bits(cfg: ModelConfig) -> int:
    return cfg.w_bits if cfg.w_bits in (1, 2) else _dtype_bytes(cfg) * 8


def weight_blocks(cfg: ModelConfig) -> tuple[WeightBlock, ...]:
    """The streamable weight-block set of one model replica: one block per
    FFN matmul per layer, named ``L{l}.{mat}``, with ``bits_per_weight``
    the packed precision or the dense dtype width; for MoE one block per
    expert mat, ``L{l}.e{e}.{mat}``, always at the dense dtype's width
    (experts are never packed); for hybrid the shared block's three,
    ``shared.{mat}``; for enc-dec the decoder's FFN blocks; for SSM none
    (no FFN to pack or stream). Budgeted decode runs none of hybrid, SSM
    and enc-dec (``executor.supports_budgeted_decode``, as in the
    reference), but their plans list and price the blocks."""
    if cfg.family == "ssm":
        return ()
    d, ff = cfg.d_model, cfg.d_ff
    mats = {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}
    if cfg.family == "hybrid":
        bits = _block_bits(cfg)
        return tuple(WeightBlock(f"shared.{mat}", r, c, bits) for mat, (r, c) in mats.items())
    if cfg.family == "moe":
        ebits = _dtype_bytes(cfg) * 8
        return tuple(
            WeightBlock(f"L{l:03d}.e{e}.{mat}", r, c, ebits)
            for l in range(cfg.n_layers)
            for e in range(cfg.n_experts)
            for mat, (r, c) in mats.items()
        )
    bits = _block_bits(cfg)
    return tuple(
        WeightBlock(f"L{l:03d}.{mat}", r, c, bits)
        for l in range(cfg.n_layers)
        for mat, (r, c) in mats.items()
    )


def _region_of(name: str) -> str:
    """The executor granularity a block belongs to: its layer (``L000``),
    or its expert for MoE (``L000.e3``). Bins never mix regions and the
    knapsack marks whole regions, so every resident byte is one the
    executor can use."""
    return name.rsplit(".", 1)[0]


def read_weight(name: str, cfg: ModelConfig) -> float:
    """Expected reads of a block per decode step (the Eq. 2 traffic
    term): top_k / E for an MoE expert block, the shared block's
    applications (n_layers / hybrid_attn_every) for a hybrid shared
    block, 1 otherwise."""
    if cfg.family == "moe" and ".e" in name:
        return cfg.experts_per_token / max(1, cfg.n_experts)
    if cfg.family == "hybrid" and name.startswith("shared."):
        return cfg.n_layers / max(1, cfg.hybrid_attn_every)
    return 1.0


def fixed_hbm_bytes(cfg: ModelConfig, traffic: TrafficProfile) -> int:
    """Per-decode-step bytes outside the plan: attention projections, the
    unembedding row product, and the lanes' KV-row reads (plan
    arithmetic, as in the reference)."""
    d, hd = cfg.d_model, cfg.hd
    attn = cfg.n_layers * (
        d * cfg.n_heads * hd + 2 * d * cfg.n_kv * hd + cfg.n_heads * hd * d
    )
    unembed = cfg.padded_vocab * d
    kv = traffic.lanes * cfg.n_layers * 2 * cfg.n_kv * hd * traffic.mean_context
    return (attn + unembed + kv) * _dtype_bytes(cfg)


def stream_ahead_depth(cfg: ModelConfig) -> int:
    """GALS Eq. 2 mapped to the ring: R_F is the bandwidth surplus of
    bit-packing (dense-dtype bits / packed bits), and the ring depth is
    the virtual ports that surplus funds per bin height, ``N_ports * R_F
    / H_B``, clamped to [2, 8] (a ring needs 2 slots to overlap at all).
    bf16: 2-bit -> 4, 1-bit -> 8, dense -> 2."""
    r_f = _dtype_bytes(cfg) * 8 / _block_bits(cfg)
    depth = math.floor(N_PORTS * r_f / MAX_HEIGHT)
    return max(2, min(MAX_STREAM_DEPTH, depth))


@dataclasses.dataclass(frozen=True)
class RuntimeResidencyPlan:
    """A compiled residency schedule."""

    model: str
    chip: GpuChip
    blocks: tuple[WeightBlock, ...]
    bins: tuple[tuple[int, ...], ...]  # tile-bin membership (block indices)
    bin_tiles: tuple[int, ...]  # tiles per bin
    resident: tuple[bool, ...]  # per *bin*
    vmem_budget_bytes: int
    stream_ahead: int
    read_weights: tuple[float, ...]  # per block: expected reads a decode step

    @property
    def resident_bytes(self) -> int:
        return sum(
            t * self.chip.tile_bytes for t, r in zip(self.bin_tiles, self.resident) if r
        )

    def block_resident(self) -> dict[str, bool]:
        out = {}
        for b, r in zip(self.bins, self.resident):
            for i in b:
                out[self.blocks[i].name] = r
        return out

    @property
    def resident_block_count(self) -> int:
        return sum(len(b) for b, r in zip(self.bins, self.resident) if r)

    @property
    def resident_fraction(self) -> float:
        return self.resident_block_count / max(1, len(self.blocks))

    @property
    def streamable_bytes_per_step(self) -> float:
        """Expected padded weight bytes per decode step of the whole
        streamable set, resident or not, each block weighted by its reads
        a step (plan arithmetic)."""
        return sum(
            w * b.padded_bytes(self.chip) for b, w in zip(self.blocks, self.read_weights)
        )

    @property
    def streamed_bytes_per_step(self) -> float:
        """Expected padded weight bytes per decode step that the plan sends
        through ``stream_matmul`` (plan arithmetic: on the H100 the resident
        path reads its weights from HBM every step too, and the port's
        dropless dispatch runs every expert every step)."""
        res = self.block_resident()
        return sum(
            w * b.padded_bytes(self.chip)
            for b, w in zip(self.blocks, self.read_weights)
            if not res[b.name]
        )

    @property
    def hbm_traffic_reduction(self) -> float:
        """Share of the streamable bytes the plan keeps off
        ``stream_matmul`` (plan arithmetic; the reference's name)."""
        return 1.0 - self.streamed_bytes_per_step / max(
            1.0, self.streamable_bytes_per_step
        )

    @property
    def ring_bytes(self) -> int:
        """Bytes of a ``stream_ahead``-slot ring sized for the largest
        streamed block, as the reference sizes its VMEM ring (plan
        arithmetic: ``stream_matmul``'s ring on the card is a few KB of
        shared memory a block). The memory ledger reports it as the
        ``ring-slot`` owner."""
        res = self.block_resident()
        slot = max(
            (b.padded_bytes(self.chip) for b in self.blocks if not res[b.name]),
            default=0,
        )
        return int(self.stream_ahead * slot)

    @property
    def stream_fraction(self) -> float:
        """Share of the streamable bytes the plan streams."""
        return self.streamed_bytes_per_step / max(1, self.streamable_bytes_per_step)

    def layer_stream_mask(self, cfg: ModelConfig) -> tuple[bool, ...]:
        """Per-layer 'FFN is streamed' flags: a layer runs resident only if
        *all* of its FFN mats are resident."""
        res = self.block_resident()
        mask = []
        for l in range(cfg.n_layers):
            prefix = f"L{l:03d}."
            mine = [r for n, r in res.items() if n.startswith(prefix)]
            mask.append(not (mine and all(mine)))
        return tuple(mask)

    def expert_stream_mask(self, cfg: ModelConfig) -> tuple[tuple[bool, ...], ...]:
        """Per-(layer, expert) 'FFN is streamed' flags for the MoE
        executor, (n_layers, n_experts): an expert runs resident only if
        all three of its mats are resident (the knapsack marks whole
        ``L{l}.e{e}`` regions, so it is all or nothing per expert)."""
        res = self.block_resident()
        by_region: dict[str, list[bool]] = {}
        for name, r in res.items():
            by_region.setdefault(_region_of(name), []).append(r)
        return tuple(
            tuple(
                not all(by_region.get(f"L{l:03d}.e{e}", [False]))
                for e in range(cfg.n_experts)
            )
            for l in range(cfg.n_layers)
        )

    def stream_mask(self, cfg: ModelConfig):
        """The decode step's mask: ``expert_stream_mask`` for MoE,
        ``layer_stream_mask`` for the dense family."""
        if cfg.family == "moe":
            return self.expert_stream_mask(cfg)
        return self.layer_stream_mask(cfg)

    def summary(self) -> dict:
        return {
            "model": self.model,
            "chip": self.chip.name,
            "n_blocks": len(self.blocks),
            "n_bins": len(self.bins),
            "vmem_budget_mib": round(self.vmem_budget_bytes / 2**20, 3),
            "resident_blocks": self.resident_block_count,
            "resident_fraction": round(self.resident_fraction, 4),
            "resident_mib": round(self.resident_bytes / 2**20, 3),
            "planned_streamed_mib_per_step": round(
                self.streamed_bytes_per_step / 2**20, 3
            ),
            "planned_stream_fraction": round(self.stream_fraction, 4),
            "stream_ahead": self.stream_ahead,
        }


def compile_residency_plan(
    cfg: ModelConfig,
    *,
    vmem_budget_bytes: int,
    chip: GpuChip = CHIP,
    solver: str = "ffd",
) -> RuntimeResidencyPlan:
    """Pack carriers into tile bins of ``chip`` (``solver``: FFD, or the
    GA ``launch.port --solver ga`` asks for; bins of ``MAX_HEIGHT``), then
    knapsack *regions* into the budget, ranked by traffic value density:
    expected weight bytes avoided per step (a block's bytes times its
    ``read_weight``) per budget byte. ``chip`` is the H100 on the serve
    path; ``launch.port`` walks ``GPU_TIERS``. The reference also takes a
    traffic profile, which the plan does not depend on, and a bin height,
    which the port fixes to the reference's default: no caller of the port
    sets them."""
    blocks = weight_blocks(cfg)
    weights = tuple(read_weight(b.name, cfg) for b in blocks)
    regions = tuple(_region_of(b.name) for b in blocks)
    packing: Packing = pack_blocks(
        blocks, chip=chip, max_height=MAX_HEIGHT, solver=solver, regions=regions
    )
    ram = vmem_tile_ram(chip)
    bins = tuple(tuple(b) for b in packing.bins)
    bin_tiles = tuple(bin_cost([packing.items[i] for i in b], ram)[0] for b in bins)
    groups: dict[str, list[int]] = {}
    for j, b in enumerate(bins):
        groups.setdefault(regions[b[0]], []).append(j)

    def group_cost(js: list[int]) -> int:
        return sum(bin_tiles[j] for j in js) * chip.tile_bytes

    def density(js: list[int]) -> float:
        avoided = sum(weights[i] * blocks[i].padded_bytes(chip) for j in js for i in bins[j])
        return avoided / max(1, group_cost(js))

    order = sorted(groups.values(), key=density, reverse=True)
    resident = [False] * len(bins)
    used = 0
    for js in order:
        cost = group_cost(js)
        if used + cost <= vmem_budget_bytes:
            for j in js:
                resident[j] = True
            used += cost
    return RuntimeResidencyPlan(
        model=cfg.name,
        chip=chip,
        blocks=blocks,
        bins=bins,
        bin_tiles=bin_tiles,
        resident=tuple(resident),
        vmem_budget_bytes=vmem_budget_bytes,
        stream_ahead=stream_ahead_depth(cfg),
        read_weights=weights,
    )
