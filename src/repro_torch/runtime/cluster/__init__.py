"""Multi-engine fleet serving: the port of ``repro.runtime.cluster``.

The single-engine path (``runtime.scheduler`` over ``runtime.kv_pool``)
scales out here: N engine replicas behind a router (``cluster.router``),
optionally split into prefill and decode roles with a KV-block handoff
and GALS-ratio provisioning (``cluster.disagg``), driven by a
seed-deterministic synthetic trace with TTFT/TPOT/goodput SLO accounting
(``cluster.traffic``). Engines run the real model on the card (or the
CPU) and charge time on a roofline virtual clock calibrated to the H100's
data sheet (``cluster.engine``): the fleet's SLO numbers are modelled,
its token streams real.
"""

from repro_torch.runtime.cluster.disagg import (
    DisaggCluster,
    RoleRates,
    measured_role_rates,
    provision_split,
)
from repro_torch.runtime.cluster.engine import Engine, StepCostModel
from repro_torch.runtime.cluster.router import FleetCluster, FleetRunResult, Router
from repro_torch.runtime.memledger import MemLedger, MemPolicy, MemPressureMonitor
from repro_torch.runtime.spans import SLOMonitor, SpanRecorder, VirtualClock
from repro_torch.runtime.cluster.traffic import (
    ClientRequest,
    RequestTiming,
    SloPolicy,
    SloReport,
    TrafficSpec,
    slo_report,
    synthesize,
)

__all__ = [
    "ClientRequest",
    "DisaggCluster",
    "Engine",
    "FleetCluster",
    "FleetRunResult",
    "MemLedger",
    "MemPolicy",
    "MemPressureMonitor",
    "RequestTiming",
    "RoleRates",
    "Router",
    "SLOMonitor",
    "SloPolicy",
    "SloReport",
    "SpanRecorder",
    "StepCostModel",
    "TrafficSpec",
    "VirtualClock",
    "measured_role_rates",
    "provision_split",
    "slo_report",
    "synthesize",
]
