"""Frequency-compensation model (paper §IV, Eq. 2; Fig. 7): the port's
copy of ``repro.core.gals``.

The GALS transformation splits each MVAU into a weight-storage block (memory
clock domain, ``F_m``) and a compute block (``F_c``), connected by async
FIFOs. With frequency ratio ``R_F = F_m / F_c`` a 2-port BRAM exposes
``2*R_F`` virtual ports per compute cycle, so a bin of height ``H_B``
sustains full readback iff

    H_B <= N_ports * R_F            (Eq. 2)

Integer ratios serve even bin heights with simple round-robin port schedules
(Fig. 7a). Fractional ratios ``R_F = N_b/2`` serve odd heights by splitting
one buffer into odd/even-address halves on different ports (Fig. 7b); the
split buffer momentarily gets *more* than its required throughput
(``2*N_b/(N_b+1)`` reads/compute-cycle), the surplus is returned to the other
streams by backpressure-driven adaptive slot allocation.
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction


N_PORTS = 2  # dual-port BRAM


def virtual_ports(r_f: float, n_ports: int = N_PORTS) -> int:
    """Virtual ports exposed to the compute domain."""
    return math.floor(n_ports * r_f + 1e-9)


def max_bin_height(r_f: float, n_ports: int = N_PORTS) -> int:
    """Largest bin height sustainable without throughput loss (Eq. 2)."""
    return virtual_ports(r_f, n_ports)


def required_rf(h_b: int, n_ports: int = N_PORTS) -> Fraction:
    """Minimum frequency ratio for bin height ``h_b`` (Eq. 2 inverted).

    h_b=4 -> 2 (paper's P4 experiments); h_b=3 -> 3/2 (P3, fractional).
    """
    if h_b < 1:
        raise ValueError("bin height must be >= 1")
    return Fraction(h_b, n_ports)


def needs_odd_even_split(h_b: int, n_ports: int = N_PORTS) -> bool:
    """Odd heights > 1 need the Fig. 7b odd/even address split + DWCs."""
    return h_b > 1 and (h_b % n_ports) != 0


def reads_per_compute_cycle(h_b: int, r_f: float, n_ports: int = N_PORTS) -> float:
    """Per-buffer readback rate seen by compute, w/o backpressure (Fig. 7)."""
    if h_b <= 0:
        raise ValueError("empty bin")
    return n_ports * r_f / h_b


def split_buffer_rate(n_b: int) -> Fraction:
    """Rate of the odd/even-split buffer at R_F = N_b/2 (Fig. 7b): the split
    buffer is read on both ports, 2*N_b/(N_b+1) reads per compute cycle."""
    return Fraction(2 * n_b, n_b + 1)


@dataclasses.dataclass(frozen=True)
class GalsOperatingPoint:
    """An implemented design point (Table V row)."""

    f_compute_mhz: float  # achieved compute clock
    f_memory_mhz: float  # achieved memory clock
    h_b: int  # max bin height in the packing
    f_compute_baseline_mhz: float  # non-packed baseline compute clock

    @property
    def r_f(self) -> float:
        return self.f_memory_mhz / self.f_compute_mhz

    @property
    def effective_rate_mhz(self) -> float:
        """Pipeline rate: compute is throttled to the slower of its own clock
        and the packed memory's per-buffer delivery rate (paper Table V:
        min(F_c, F_m/2) for H_B=4)."""
        delivery = N_PORTS * self.f_memory_mhz / self.h_b
        return min(self.f_compute_mhz, delivery)

    @property
    def delta_fps(self) -> float:
        """Relative throughput reduction vs the non-packed baseline."""
        return 1.0 - self.effective_rate_mhz / self.f_compute_baseline_mhz

    @property
    def throughput_preserved(self) -> bool:
        return self.r_f + 1e-9 >= self.h_b / N_PORTS


def folding_delta_fps(fold_factor: int) -> float:
    """The alternative the paper compares against: F2 folding halves
    per-cycle parallelism -> ~(1 - 1/fold) throughput loss at equal clocks."""
    return 1.0 - 1.0 / fold_factor
