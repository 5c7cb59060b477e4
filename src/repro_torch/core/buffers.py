"""Logical weight-buffer shape derivation for FINN-style dataflow layers:
the port's copy of ``repro.core.buffers``.

In a FINN Matrix-Vector-Activation Unit (MVAU) the weight memory shape is a
*function of the folding*, not only of the parameter count (paper §II-B):

    width_bits  = PE * SIMD * W
    depth_words = (K^2 * C / SIMD) * (F / PE)

so doubling compute parallelism halves depth and doubles width, which maps
progressively worse onto fixed 1024x18 BRAMs (paper Fig. 2). This module
derives the logical buffer set of an accelerator from its topology + folding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

from repro_torch.core.resource_model import BRAM18, RamPrimitive


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One dataflow compute layer (conv expressed as matrix-vector).

    For a conv layer: ``c_in`` input channels, ``c_out`` filters, ``k`` kernel
    dim, ``out_pixels`` output spatial positions (H_out*W_out). An FC layer is
    k=1, out_pixels=1.
    """

    name: str
    c_in: int
    c_out: int
    k: int = 1
    out_pixels: int = 1
    w_bits: int = 1  # weight precision

    @property
    def n_params(self) -> int:
        return self.k * self.k * self.c_in * self.c_out

    @property
    def param_bits(self) -> int:
        return self.n_params * self.w_bits

    @property
    def macs(self) -> int:
        """MACs per inference for this layer."""
        return self.n_params * self.out_pixels


@dataclasses.dataclass(frozen=True)
class Folding:
    """FINN folding solution for one layer: PE filters x SIMD inputs / cycle."""

    pe: int
    simd: int

    def validate(self, layer: LayerSpec) -> None:
        if layer.c_out % self.pe != 0:
            raise ValueError(
                f"{layer.name}: PE={self.pe} must divide c_out={layer.c_out}"
            )
        fold_in = layer.k * layer.k * layer.c_in
        if fold_in % self.simd != 0:
            raise ValueError(
                f"{layer.name}: SIMD={self.simd} must divide K^2*C={fold_in}"
            )


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


def mvau_buffer(layer: LayerSpec, folding: Folding) -> WeightBuffer:
    """Weight buffer of an MVAU at the given folding (paper §II-B(a))."""
    folding.validate(layer)
    width = folding.pe * folding.simd * layer.w_bits
    depth = (layer.k * layer.k * layer.c_in // folding.simd) * (
        layer.c_out // folding.pe
    )
    return WeightBuffer(layer.name, width, depth, layer.w_bits)


def mvau_cycles(layer: LayerSpec, folding: Folding) -> int:
    """Initiation interval (cycles per inference) of an MVAU."""
    folds = (layer.k * layer.k * layer.c_in // folding.simd) * (
        layer.c_out // folding.pe
    )
    return folds * layer.out_pixels


def buffer_set(
    layers: Iterable[LayerSpec], foldings: Iterable[Folding]
) -> list[WeightBuffer]:
    return [mvau_buffer(l, f) for l, f in zip(layers, foldings, strict=True)]


def kernel_efficiency_bound(k: int) -> float:
    """Paper §II-B(b): best-case efficiency from odd kernel sizes alone.

    Buffer depths are multiples of K^2; with power-of-two RAM depths the
    ceiling is K^2 / 2^ceil(log2(K^2)).
    """
    k2 = k * k
    return k2 / (2 ** math.ceil(math.log2(k2)))
