"""Dataflow-pipeline performance model (FPS, latency, TOp/s).

A custom-dataflow accelerator is a pipeline of per-layer compute units; the
steady-state throughput is set by the slowest stage's initiation interval
(II, cycles per inference) and the clock:

    FPS     = F_c / max_i II_i
    latency = sum_i II_i / F_c        (first-inference pipeline fill)
    TOp/s   = 2 * total MACs * FPS

The port's copy of ``repro.core.dataflow``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.buffers import Folding, LayerSpec, mvau_cycles


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    layers: tuple[LayerSpec, ...]
    foldings: tuple[Folding, ...]
    f_compute_mhz: float

    def cycles(self) -> list[int]:
        return [mvau_cycles(l, f) for l, f in zip(self.layers, self.foldings)]

    @property
    def max_ii(self) -> int:
        return max(self.cycles())

    @property
    def fps(self) -> float:
        return self.f_compute_mhz * 1e6 / self.max_ii

    @property
    def latency_s(self) -> float:
        """First-inference latency = pipeline fill.

        In streaming dataflow a layer emits its first outputs after seeing
        only ~K rows of its input, so its fill contribution is
        II * min(1, K / sqrt(out_pixels)) — full II only for FC layers
        (out_pixels = 1). This reproduces the paper's 1.9 ms for RN50 at
        370 us steady-state II; the naive sum-of-II bound would give 19 ms.
        """
        import math

        total = 0.0
        for l, c in zip(self.layers, self.cycles()):
            frac = min(1.0, l.k / math.sqrt(max(1, l.out_pixels)))
            total += c * frac
        return total / (self.f_compute_mhz * 1e6)

    @property
    def total_macs(self) -> int:
        return sum(l.macs for l in self.layers)

    @property
    def tops(self) -> float:
        """Effective tera-ops/s (2 ops per MAC) at steady state."""
        return 2.0 * self.total_macs * self.fps / 1e12

    def scaled_clock(self, f_compute_mhz: float) -> "PipelineModel":
        return dataclasses.replace(self, f_compute_mhz=f_compute_mhz)

    def folded(self, factor: int) -> "PipelineModel":
        """Uniformly reduce parallelism by ``factor`` (the paper's F2
        alternative): every II grows by ~factor, FPS drops by ~factor."""
        new = []
        for l, f in zip(self.layers, self.foldings):
            pe, simd = f.pe, f.simd
            rem = factor
            while rem > 1 and pe > 1 and (pe % 2 == 0):
                pe //= 2
                rem //= 2
            while rem > 1 and simd > 1 and (simd % 2 == 0):
                simd //= 2
                rem //= 2
            new.append(Folding(pe, simd))
        return dataclasses.replace(self, foldings=tuple(new))


def balance_report(model: PipelineModel) -> str:
    cyc = model.cycles()
    lines = [f"{'layer':24s} {'II':>10s} {'PE':>4s} {'SIMD':>5s}"]
    for l, f, c in zip(model.layers, model.foldings, cyc):
        lines.append(f"{l.name:24s} {c:10d} {f.pe:4d} {f.simd:5d}")
    lines.append(
        f"max II {model.max_ii}  FPS {model.fps:.0f}  "
        f"latency {model.latency_s*1e3:.2f} ms  {model.tops:.1f} TOp/s"
    )
    return "\n".join(lines)
