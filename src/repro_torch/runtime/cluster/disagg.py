"""Disaggregated prefill/decode serving with GALS-ratio provisioning.
Port of ``repro.runtime.cluster.disagg``.

The paper's GALS transformation splits each MVAU into a memory domain and
a compute domain and buys back throughput with the frequency ratio
``R_F = F_m / F_c`` (Eq. 2: a packed memory feeds ``H_B`` streams iff
``H_B <= N_ports * R_F``). One level up, a serving fleet has the same
two-domain shape:

    memory domain (producer)   -> prefill engines: turn prompts into K/V
    compute domain (consumer)  -> decode engines: turn K/V into tokens
    async FIFO between domains -> the KV-block handoff
    rate ratio R_F             -> per-engine request rates rho_p / rho_d
    bin height H_B             -> decode engines fed per prefill engine
    Eq. 2 feasibility          -> ceil(n_d / n_p) <= N_ports * R_F
                                  via ``core.gals.required_rf``

``provision_split`` turns a total engine count and the two roles' rates
into the (n_prefill, n_decode) split: among all splits it maximises the
sustainable request throughput ``min(n_p * rho_p, n_d * rho_d)``,
preferring splits whose ratio satisfies Eq. 2 and then the larger decode
side. The handoff FIFO is one stream per prefill engine, so ``N_PORTS``
here is 1.

Decode on engine B of a request prefilled on engine A gives the
single-engine token stream: the payload carries the exact K/V rows (in
block order), the first sampled token and, for a hybrid, a device copy of
the SSM lane state at the prompt's end; sampling is keyed on (seed,
fleet-wide rid, position).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.gals import required_rf
from repro_torch.models.config import PAGED_FAMILIES, ModelConfig
from repro_torch.models.lm import SamplingParams
from repro_torch.runtime.cluster.engine import Engine, StepCostModel
from repro_torch.runtime.cluster.router import FleetCluster, Router
from repro_torch.runtime.cluster.traffic import TrafficSpec
from repro_torch.runtime.spans import SLOMonitor

# one KV-handoff stream per prefill engine (the async-FIFO analogue)
HANDOFF_PORTS = 1


@dataclasses.dataclass(frozen=True)
class RoleRates:
    """Measured per-engine request service rates (requests / virtual s)."""

    prefill_req_rate: float  # rho_p: prompts one prefill engine sustains
    decode_req_rate: float  # rho_d: requests one decode engine sustains

    @property
    def r_f(self) -> float:
        """The fleet-level frequency ratio F_m / F_c."""
        return self.prefill_req_rate / self.decode_req_rate


def measured_role_rates(
    cost: StepCostModel, spec: TrafficSpec, *, slots: int
) -> RoleRates:
    """Rates under the cluster's own cost model at the trace's mean prompt
    and output lengths: modelled rates, not measured ones (a deployment
    would plug its measured rates in here instead)."""
    rho_p = cost.prefill_rate(spec.mean_prompt_len) / spec.mean_prompt_len
    rho_d = cost.decode_rate(slots) / spec.mean_gen_len
    return RoleRates(prefill_req_rate=rho_p, decode_req_rate=rho_d)


def provision_split(
    n_engines: int, rates: RoleRates, n_ports: int = HANDOFF_PORTS
) -> tuple[int, int]:
    """(n_prefill, n_decode) from the Eq. 2 ratio algebra (see module
    docstring). Needs at least one engine per role."""
    if n_engines < 2:
        raise ValueError("disaggregation needs >= 2 engines")
    best_key = None
    best = (1, n_engines - 1)
    for n_p in range(1, n_engines):
        n_d = n_engines - n_p
        h_b = math.ceil(n_d / n_p)  # decode consumers per prefill producer
        rf_needed = required_rf(h_b, n_ports)  # Eq. 2 inverted
        fed = rates.r_f + 1e-9 >= float(rf_needed)
        throughput = min(
            n_p * rates.prefill_req_rate, n_d * rates.decode_req_rate
        )
        key = (throughput, fed, n_d)
        if best_key is None or key > best_key:
            best_key, best = key, (n_p, n_d)
    return best


class DisaggCluster(FleetCluster):
    """Prefill engines feed decode engines through KV-block handoffs.

    ``split`` forces an (n_prefill, n_decode) role split; when None the
    GALS-ratio provisioning above sizes it from the traffic spec.
    ``compiled`` goes to every engine's scheduler.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_engines: int,
        slots: int,
        max_len: int,
        block_tokens: int,
        cost: StepCostModel,
        spec: TrafficSpec | None = None,
        split: tuple[int, int] | None = None,
        policy: str = "least-loaded",
        token_budget: int | None = None,
        sampling: SamplingParams | None = None,
        prefix_cache: bool = False,
        speculative=None,
        tracker=None,
        trace_spans: bool = True,
        slo=None,
        mem_policy=None,
        compiled: bool | None = None,
    ):
        # a hybrid disaggregates too: its payload carries the lane state
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                "disaggregated serving ships KV-block payloads; family "
                f"{cfg.family!r} decode state does not fit the wire format"
            )
        if split is None:
            if spec is None:
                raise ValueError("need a TrafficSpec (or explicit split)")
            split = provision_split(
                n_engines, measured_role_rates(cost, spec, slots=slots)
            )
        n_p, n_d = split
        if n_p < 1 or n_d < 1 or n_p + n_d != n_engines:
            raise ValueError(f"bad split {split} for {n_engines} engines")
        self.cfg = cfg
        self.split = split
        self.tracker = tracker
        self.slo = slo
        mk = lambda i, role: Engine(
            i,
            cfg,
            params,
            slots=slots,
            max_len=max_len,
            block_tokens=block_tokens,
            cost=cost,
            role=role,
            token_budget=token_budget,
            sampling=sampling,
            prefix_cache=prefix_cache,
            speculative=speculative,
            tracker=tracker,
            trace_spans=trace_spans,
            slo=slo,
            mem_policy=mem_policy,
            compiled=compiled,
        )
        self.prefill_engines = [mk(i, "prefill") for i in range(n_p)]
        self.decode_engines = [mk(n_p + i, "decode") for i in range(n_d)]
        self.engines = self.prefill_engines + self.decode_engines
        # arrivals route over the prefill tier only
        self.router = Router(self.prefill_engines, policy)
        self.timings = {}
        self._by_rid = {}
        self._awaiting: list = []  # payloads no decode engine can hold yet
        self.slo_monitor = SLOMonitor(slo)

    def _route_payloads(self) -> None:
        """Move prefilled KV payloads to the least-loaded decode engine
        that can hold their full token commitment."""
        ready = self._awaiting
        self._awaiting = []
        for e in self.prefill_engines:
            ready.extend(e.outbox)
            e.outbox.clear()
        ready.sort(key=lambda rp: (rp[0], rp[1].rid))
        for ready_at, payload in ready:
            cands = [
                d
                for d in self.decode_engines
                if d.can_accept(payload.total_tokens)
            ]
            if not cands:
                self._awaiting.append((ready_at, payload))
                continue
            target = min(cands, key=lambda d: (d.load_tokens, d.engine_id))
            target.offer_import(ready_at, payload)

    def _in_flight(self) -> bool:
        return bool(self._awaiting)
