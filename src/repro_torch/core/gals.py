"""Frequency compensation (paper §IV, Eq. 2): the port's copy of
``N_PORTS`` and ``required_rf`` from ``repro.core.gals``.

With memory/compute clock ratio ``R_F`` a dual-port memory serves
``N_ports * R_F`` logical buffers per compute cycle, so a bin of height
``H_B`` sustains full readback iff ``H_B <= N_ports * R_F``.
"""

from __future__ import annotations

from fractions import Fraction

N_PORTS = 2  # dual-port BRAM


def required_rf(h_b: int, n_ports: int = N_PORTS) -> Fraction:
    """Minimum frequency ratio for bin height ``h_b`` (Eq. 2 inverted).

    h_b=4 -> 2 (paper's P4 experiments); h_b=3 -> 3/2 (P3, fractional).
    """
    if h_b < 1:
        raise ValueError("bin height must be >= 1")
    return Fraction(h_b, n_ports)
