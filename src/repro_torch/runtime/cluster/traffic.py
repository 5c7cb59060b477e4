"""Seed-deterministic synthetic serving traffic and SLO metrics: the
port's copy of ``repro.runtime.cluster.traffic`` (numpy only, the same
generator and seed sequence, so a spec gives the reference's arrays).

The fleet layer measures time on a *virtual clock* (``cluster.engine``):
arrivals, TTFT, TPOT and goodput are all in virtual seconds, so a trace
replays bit-identically on any host. These are modelled seconds, not
measured ones. The generator draws Poisson arrivals, a discrete
prompt/output length mix, and session reuse (a fraction of arrivals
continue an existing session; the router's affinity policy keeps those
on one engine).

SLO metrics follow the serving literature:

  * TTFT: time to first token, from arrival to the first token being
    available *on the engine that serves the client* (for disaggregated
    serving that is the decode engine, so a decode backlog shows up in
    TTFT);
  * TPOT: time per output token over the decode phase;
  * goodput: generated tokens of SLO-meeting requests per virtual second
    (a request outside its TTFT/TPOT SLO contributes nothing).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

LengthMix = tuple[tuple[int, float], ...]


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """A synthetic workload: Poisson arrivals over a length/session mix."""

    n_requests: int = 32
    arrival_rate: float = 100.0  # requests per virtual second
    prompt_lens: LengthMix = ((8, 0.5), (16, 0.35), (24, 0.15))
    gen_lens: LengthMix = ((8, 0.7), (16, 0.3))
    session_reuse: float = 0.3  # fraction of arrivals continuing a session
    vocab: int = 512
    seed: int = 0

    def _mean(self, mix: LengthMix) -> float:
        w = sum(p for _, p in mix)
        return sum(l * p for l, p in mix) / w

    @property
    def mean_prompt_len(self) -> float:
        return self._mean(self.prompt_lens)

    @property
    def mean_gen_len(self) -> float:
        return self._mean(self.gen_lens)

    @property
    def max_total_tokens(self) -> int:
        return max(l for l, _ in self.prompt_lens) + max(
            l for l, _ in self.gen_lens
        )


@dataclasses.dataclass(frozen=True)
class ClientRequest:
    """One arrival. ``rid`` is the fleet-wide request id: the sampler is
    keyed on it, so the token stream does not depend on the engine."""

    rid: int
    t_arrival: float
    prompt: np.ndarray
    max_new_tokens: int
    session: int

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new_tokens


def synthesize(spec: TrafficSpec) -> list[ClientRequest]:
    """Generate the trace. Deterministic in ``spec.seed`` only."""
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 0x7AFF1C]))
    plens, pw = zip(*spec.prompt_lens)
    glens, gw = zip(*spec.gen_lens)
    pw = np.asarray(pw, float) / sum(pw)
    gw = np.asarray(gw, float) / sum(gw)
    t = 0.0
    n_sessions = 0
    out: list[ClientRequest] = []
    for rid in range(spec.n_requests):
        t += float(rng.exponential(1.0 / spec.arrival_rate))
        if n_sessions and float(rng.random()) < spec.session_reuse:
            session = int(rng.integers(n_sessions))
        else:
            session = n_sessions
            n_sessions += 1
        p = int(rng.choice(plens, p=pw))
        g = int(rng.choice(glens, p=gw))
        prompt = rng.integers(0, spec.vocab, size=(p,)).astype(np.int32)
        out.append(ClientRequest(rid, t, prompt, g, session))
    return out


# --------------------------------------------------------------------------
# SLO accounting
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """Per-request latency objectives, in virtual seconds.

    ``target`` is the availability objective: the fraction of requests
    that must meet the TTFT/TPOT bounds. Its complement (1 - target) is
    the error budget that ``spans.SLOMonitor`` burn rates are measured
    against. TTFT here is *submit-relative* (arrival to first token),
    so queue wait counts against the objective.
    """

    ttft: float
    tpot: float
    target: float = 0.9


@dataclasses.dataclass
class RequestTiming:
    """Virtual-time milestones of one request's life in the fleet."""

    rid: int
    t_arrival: float
    t_first: float = math.nan
    t_done: float = math.nan
    n_tokens: int = 0
    t_admit: float = math.nan  # engine admission (end of queue wait)

    @property
    def ttft(self) -> float:
        """Submit-relative TTFT: arrival to first token. This is the
        client's TTFT, queue wait included, and the one SLO policies are
        enforced against."""
        return self.t_first - self.t_arrival

    @property
    def ttft_admit(self) -> float:
        """Admission-relative TTFT: engine pickup to first token. It hides
        the queue wait, which is why reports carry both."""
        return self.t_first - self.t_admit

    @property
    def queue_wait(self) -> float:
        return self.t_admit - self.t_arrival

    @property
    def tpot(self) -> float:
        if self.n_tokens <= 1:
            return 0.0
        return (self.t_done - self.t_first) / (self.n_tokens - 1)

    def meets(self, slo: SloPolicy) -> bool:
        return (
            not math.isnan(self.t_first)
            and not math.isnan(self.t_done)
            and self.ttft <= slo.ttft
            and self.tpot <= slo.tpot
        )


def _pct(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


@dataclasses.dataclass
class SloReport:
    """Percentile latencies + goodput for one fleet run."""

    n_requests: int
    completed: int
    makespan: float
    generated_tokens: int
    ttft_p50: float
    ttft_p95: float
    ttft_p99: float
    tpot_p50: float
    tpot_p95: float
    tpot_p99: float
    slo_met: int
    goodput_tokens_per_s: float
    throughput_tokens_per_s: float
    # admission-relative TTFT + queue wait (ttft_* above is
    # submit-relative; the spread between the two IS the queue)
    ttft_admit_p50: float = 0.0
    ttft_admit_p95: float = 0.0
    ttft_admit_p99: float = 0.0
    queue_wait_p50: float = 0.0
    queue_wait_p95: float = 0.0
    queue_wait_p99: float = 0.0

    def row(self) -> dict:
        return {
            k: (round(v, 6) if isinstance(v, float) else v)
            for k, v in dataclasses.asdict(self).items()
        }


def slo_report(
    timings: dict[int, RequestTiming], slo: SloPolicy
) -> SloReport:
    done = [t for t in timings.values() if not math.isnan(t.t_done)]
    ttfts = [t.ttft for t in done]
    tpots = [t.tpot for t in done]
    admits = [t for t in done if not math.isnan(t.t_admit)]
    ttfts_admit = [t.ttft_admit for t in admits]
    waits = [t.queue_wait for t in admits]
    makespan = max((t.t_done for t in done), default=0.0)
    met = [t for t in done if t.meets(slo)]
    total = sum(t.n_tokens for t in done)
    good = sum(t.n_tokens for t in met)
    return SloReport(
        n_requests=len(timings),
        completed=len(done),
        makespan=makespan,
        generated_tokens=total,
        ttft_p50=_pct(ttfts, 50),
        ttft_p95=_pct(ttfts, 95),
        ttft_p99=_pct(ttfts, 99),
        tpot_p50=_pct(tpots, 50),
        tpot_p95=_pct(tpots, 95),
        tpot_p99=_pct(tpots, 99),
        slo_met=len(met),
        goodput_tokens_per_s=good / makespan if makespan > 0 else 0.0,
        throughput_tokens_per_s=total / makespan if makespan > 0 else 0.0,
        ttft_admit_p50=_pct(ttfts_admit, 50),
        ttft_admit_p95=_pct(ttfts_admit, 95),
        ttft_admit_p99=_pct(ttfts_admit, 99),
        queue_wait_p50=_pct(waits, 50),
        queue_wait_p95=_pct(waits, 95),
        queue_wait_p99=_pct(waits, 99),
    )
