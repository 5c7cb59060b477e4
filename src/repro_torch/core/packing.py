"""Buffer-to-bin packing (paper §II-C, §IV; GA of Kroes et al. [18]).

The port's copy of ``repro.core.packing``. A *bin* is a packed physical
memory structure holding up to ``H_B`` logical buffers, all streamed
through the structure's two ports. Three solvers, in increasing quality
order: ``pack_ffd`` (first-fit decreasing), ``pack_anneal`` (simulated
annealing, MPack style) and ``pack_genetic`` (tournament GA with the
paper's Table III hyperparameters). They are pure Python, seeded with
Python's ``random`` exactly as the reference seeds it, so the same items
give the same bins in both packages. Bins never mix ``region`` tags.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Sequence

from repro_torch.core.buffers import WeightBuffer
from repro_torch.core.resource_model import BRAM18, RamPrimitive


@dataclasses.dataclass(frozen=True)
class PackItem:
    """A buffer plus packing metadata."""

    buffer: WeightBuffer
    region: str = ""

    @property
    def width(self) -> int:
        return self.buffer.width_bits

    @property
    def depth(self) -> int:
        return self.buffer.depth_words


def bin_cost(
    items: Sequence[PackItem], ram: RamPrimitive = BRAM18
) -> tuple[int, str]:
    """Physical blocks for one bin and the chosen layout.

    Horizontal co-location stacks buffers along the address space
    (width = max, depth = sum); vertical concatenates words
    (width = sum, depth = max). Synthesis picks whichever is cheaper.
    """
    if not items:
        return 0, "empty"
    if len(items) == 1:
        return items[0].buffer.blocks(ram), "single"
    w = [it.width for it in items]
    d = [it.depth for it in items]
    cost_h = ram.blocks_for(max(w), sum(d))
    cost_v = ram.blocks_for(sum(w), max(d))
    if cost_v < cost_h:
        return cost_v, "vertical"
    return cost_h, "horizontal"


@dataclasses.dataclass
class Packing:
    """A full packing solution: list of bins, each a list of item indices."""

    items: list[PackItem]
    bins: list[list[int]]
    ram: RamPrimitive = BRAM18

    def validate(self, max_height: int) -> None:
        seen: set[int] = set()
        for b in self.bins:
            if len(b) > max_height:
                raise ValueError(f"bin height {len(b)} > H_B={max_height}")
            regions = {self.items[i].region for i in b}
            if len(regions) > 1:
                raise ValueError(f"bin mixes regions {regions}")
            seen.update(b)
        if seen != set(range(len(self.items))):
            raise ValueError("packing is not a partition of the items")

    @property
    def total_blocks(self) -> int:
        return sum(bin_cost([self.items[i] for i in b], self.ram)[0] for b in self.bins)

    @property
    def efficiency(self) -> float:
        """Paper Eq. 1: useful parameter bits / physical RAM bits."""
        useful = sum(it.buffer.bits for it in self.items)
        blocks = self.total_blocks
        if blocks == 0:
            return 1.0
        return useful / (blocks * self.ram.capacity_bits)

    @property
    def heights(self) -> list[int]:
        return [len(b) for b in self.bins]

    @property
    def odd_height_bins(self) -> int:
        return sum(1 for b in self.bins if len(b) > 1 and len(b) % 2 == 1)

    def bin_widths_bits(self) -> list[int]:
        out = []
        for b in self.bins:
            its = [self.items[i] for i in b]
            _, layout = bin_cost(its, self.ram)
            if layout == "vertical":
                out.append(sum(it.width for it in its))
            else:
                out.append(max((it.width for it in its), default=0))
        return out


def baseline_packing(items: Sequence[PackItem], ram: RamPrimitive = BRAM18) -> Packing:
    """No packing: one buffer per memory structure (the FINN default)."""
    return Packing(list(items), [[i] for i in range(len(items))], ram)


# --------------------------------------------------------------------------
# First-fit decreasing
# --------------------------------------------------------------------------


def pack_ffd(
    items: Sequence[PackItem],
    max_height: int,
    ram: RamPrimitive = BRAM18,
) -> Packing:
    """First-fit-decreasing on buffer size; admits an item into the first bin
    where it reduces total block count versus opening a new bin."""
    order = sorted(range(len(items)), key=lambda i: -items[i].buffer.bits)
    bins: list[list[int]] = []
    bin_blocks: list[int] = []
    for i in order:
        it = items[i]
        solo = bin_cost([it], ram)[0]
        best_j, best_delta = -1, 0
        for j, b in enumerate(bins):
            if len(b) >= max_height:
                continue
            if items[b[0]].region != it.region:
                continue
            merged = bin_cost([items[k] for k in b] + [it], ram)[0]
            delta = merged - bin_blocks[j] - solo  # <0 means packing saves RAM
            if delta < best_delta:
                best_delta, best_j = delta, j
        if best_j >= 0:
            bins[best_j].append(i)
            bin_blocks[best_j] = bin_cost([items[k] for k in bins[best_j]], ram)[0]
        else:
            bins.append([i])
            bin_blocks.append(solo)
    p = Packing(list(items), bins, ram)
    p.validate(max_height)
    return p


# --------------------------------------------------------------------------
# Simulated annealing (MPack-style)
# --------------------------------------------------------------------------


def pack_anneal(
    items: Sequence[PackItem],
    max_height: int,
    ram: RamPrimitive = BRAM18,
    steps: int = 4000,
    t0: float = 2.0,
    seed: int = 0,
) -> Packing:
    rng = random.Random(seed)
    cur = pack_ffd(items, max_height, ram)
    bins = [list(b) for b in cur.bins]

    def cost_of(b: list[int]) -> int:
        return bin_cost([items[i] for i in b], ram)[0]

    costs = [cost_of(b) for b in bins]
    total = sum(costs)
    best_bins, best_total = [list(b) for b in bins], total
    n = len(items)
    for step in range(steps):
        t = t0 * (1.0 - step / steps) + 1e-6
        # move a random item to a random other bin (or a fresh bin)
        src = rng.randrange(len(bins))
        if not bins[src]:
            continue
        i = rng.choice(bins[src])
        dst = rng.randrange(len(bins) + 1)
        if dst == src:
            continue
        if dst < len(bins):
            if len(bins[dst]) >= max_height or (
                bins[dst] and items[bins[dst][0]].region != items[i].region
            ):
                continue
        old_src, old_dst = costs[src], costs[dst] if dst < len(bins) else 0
        new_src_bin = [k for k in bins[src] if k != i]
        new_dst_bin = (bins[dst] + [i]) if dst < len(bins) else [i]
        new_src, new_dst = cost_of(new_src_bin), cost_of(new_dst_bin)
        delta = (new_src + new_dst) - (old_src + old_dst)
        if delta <= 0 or rng.random() < math.exp(-delta / t):
            bins[src] = new_src_bin
            costs[src] = new_src
            if dst < len(bins):
                bins[dst] = new_dst_bin
                costs[dst] = new_dst
            else:
                bins.append(new_dst_bin)
                costs.append(new_dst)
            total += delta
            if total < best_total:
                best_total = total
                best_bins = [list(b) for b in bins if b]
    best_bins = [b for b in best_bins if b]
    p = Packing(list(items), best_bins, ram)
    p.validate(max_height)
    return p


# --------------------------------------------------------------------------
# Genetic algorithm (Kroes et al. [18]; paper Table III hyperparameters)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GaParams:
    """Table III. ``p_adm_w`` / ``p_adm_h`` are admission probabilities for
    width-increasing (vertical) and height-increasing (horizontal)
    co-locations during offspring repair; ``p_mut`` is per-gene mutation."""

    max_height: int = 4  # H_B
    population: int = 50  # N_p
    tournament: int = 5  # N_t
    p_adm_w: float = 0.0
    p_adm_h: float = 0.1
    p_mut: float = 0.3
    generations: int = 60
    seed: int = 0


GA_PARAMS_CNV = GaParams(population=50, p_mut=0.3)
GA_PARAMS_RN50 = GaParams(population=75, p_mut=0.4)


def _genome_cost(
    genome: list[int], items: Sequence[PackItem], ram: RamPrimitive, max_height: int
) -> int:
    groups: dict[int, list[int]] = {}
    for i, g in enumerate(genome):
        groups.setdefault(g, []).append(i)
    total = 0
    for b in groups.values():
        c, _ = bin_cost([items[i] for i in b], ram)
        total += c
        if len(b) > max_height:  # infeasible: heavy penalty
            total += 10_000 * (len(b) - max_height)
        if len({items[i].region for i in b}) > 1:
            total += 100_000
    return total


def pack_genetic(
    items: Sequence[PackItem],
    params: GaParams = GaParams(),
    ram: RamPrimitive = BRAM18,
) -> Packing:
    rng = random.Random(params.seed)
    n = len(items)
    if n == 0:
        return Packing([], [], ram)

    # Seed population: FFD solution + randomized variants.
    ffd = pack_ffd(items, params.max_height, ram)
    base = [0] * n
    for g, b in enumerate(ffd.bins):
        for i in b:
            base[i] = g

    def random_genome() -> list[int]:
        g = list(base)
        for i in range(n):
            if rng.random() < 0.5:
                g[i] = rng.randrange(n)
        return g

    pop = [list(base)] + [random_genome() for _ in range(params.population - 1)]
    fit = [_genome_cost(g, items, ram, params.max_height) for g in pop]

    def tournament() -> list[int]:
        cand = rng.sample(range(len(pop)), min(params.tournament, len(pop)))
        return pop[min(cand, key=lambda i: fit[i])]

    def repair(genome: list[int]) -> list[int]:
        """Greedy local repair with the paper's admission probabilities:
        try to merge under-full bins; admit width-growing merges with
        p_adm_w, height-growing merges with p_adm_h."""
        groups: dict[int, list[int]] = {}
        for i, g in enumerate(genome):
            groups.setdefault(g, []).append(i)
        # split over-full bins
        next_id = max(groups) + 1
        for g in list(groups):
            while len(groups[g]) > params.max_height:
                i = groups[g].pop()
                groups[next_id] = [i]
                next_id += 1
        # opportunistic merges of the two smallest bins in a region
        bins = list(groups.values())
        rng.shuffle(bins)
        merged: list[list[int]] = []
        for b in bins:
            placed = False
            for m in merged:
                if len(m) + len(b) > params.max_height:
                    continue
                if items[m[0]].region != items[b[0]].region:
                    continue
                c_sep = bin_cost([items[i] for i in m], ram)[0] + bin_cost(
                    [items[i] for i in b], ram
                )[0]
                c_mrg, layout = bin_cost([items[i] for i in m + b], ram)
                if c_mrg < c_sep:
                    m.extend(b)
                    placed = True
                    break
                # admission probabilities let the GA explore "paying" merges
                p = params.p_adm_w if layout == "vertical" else params.p_adm_h
                if c_mrg == c_sep and rng.random() < p:
                    m.extend(b)
                    placed = True
                    break
            if not placed:
                merged.append(list(b))
        out = [0] * n
        for g, b in enumerate(merged):
            for i in b:
                out[i] = g
        return out

    best_g, best_f = min(zip(pop, fit), key=lambda t: t[1])
    for _gen in range(params.generations):
        new_pop: list[list[int]] = []
        while len(new_pop) < params.population:
            a, b = tournament(), tournament()
            child = [a[i] if rng.random() < 0.5 else b[i] for i in range(n)]
            for i in range(n):
                if rng.random() < params.p_mut / n * 10:  # a few genes per child
                    child[i] = rng.randrange(n)
            child = repair(child)
            new_pop.append(child)
        pop = new_pop
        fit = [_genome_cost(g, items, ram, params.max_height) for g in pop]
        gbest, fbest = min(zip(pop, fit), key=lambda t: t[1])
        if fbest < best_f:
            best_g, best_f = list(gbest), fbest
        # elitism
        worst = max(range(len(pop)), key=lambda i: fit[i])
        pop[worst], fit[worst] = list(best_g), best_f

    groups: dict[int, list[int]] = {}
    for i, g in enumerate(best_g):
        groups.setdefault(g, []).append(i)
    p = Packing(list(items), [b for b in groups.values() if b], ram)
    p.validate(params.max_height)
    return p


SOLVERS: dict[str, Callable[..., Packing]] = {
    "ffd": pack_ffd,
    "anneal": pack_anneal,
}
