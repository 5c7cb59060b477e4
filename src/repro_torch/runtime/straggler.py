"""Straggler detection: per-host step-time EWMA vs the fleet median.

The port's copy of ``repro.runtime.straggler``.

At multi-pod scale a single slow host (thermal throttling, failing HBM,
noisy neighbour on the DCN) gates every synchronous step. The monitor keeps
an EWMA of per-host step times, flags hosts slower than ``k x median``, and
exposes a hook the runtime uses to trigger mitigation (re-shard away from
the host / evict + elastic restart — simulated in tests, since this
container has one real host).
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class StragglerMonitor:
    n_hosts: int
    alpha: float = 0.2  # EWMA coefficient
    threshold: float = 1.5  # flag hosts slower than threshold x median
    min_steps: int = 3  # warm-up before flagging
    on_straggler: Callable[[int, float, float], None] | None = None

    def __post_init__(self):
        self.ewma = [0.0] * self.n_hosts
        self.count = 0
        self.flagged: set[int] = set()

    def record_step(self, host_times: list[float]) -> list[int]:
        """Feed one synchronous step's per-host wall times; returns newly
        flagged host ids."""
        assert len(host_times) == self.n_hosts
        for h, t in enumerate(host_times):
            if self.count == 0:
                self.ewma[h] = t
            else:
                self.ewma[h] = (1 - self.alpha) * self.ewma[h] + self.alpha * t
        self.count += 1
        newly = []
        if self.count >= self.min_steps:
            med = sorted(self.ewma)[self.n_hosts // 2]
            for h, e in enumerate(self.ewma):
                if e > self.threshold * med and h not in self.flagged:
                    self.flagged.add(h)
                    newly.append(h)
                    if self.on_straggler is not None:
                        self.on_straggler(h, e, med)
                elif e <= self.threshold * med and h in self.flagged:
                    self.flagged.discard(h)  # recovered
        return newly

    @property
    def healthy_hosts(self) -> list[int]:
        return [h for h in range(self.n_hosts) if h not in self.flagged]
