"""Fleet-serving entry point: N engines behind a router, on a virtual clock.
Port of ``repro.launch.fleet``, flag for flag, with ``--device``.

Modes::

    single  one engine (the pool scheduler, fleet-instrumented)
    fleet   N identical engines behind the router (least-loaded, affinity
            or prefix-aware dispatch, token-budget-aware admission)
    disagg  prefill and decode engine roles with a KV-block handoff; the
            role split is provisioned from ``core.gals.required_rf``
            applied to the modelled prefill/decode rates (override with
            --split P,D)

Engines run the real model (token streams are identical across modes at
temperature 0), on CUDA unless ``--device cpu`` is given; without a GPU
and without ``--device cpu`` it exits with an error, and never falls back
to the CPU. On the card every engine's steps run as CUDA graphs of its
own. Time is charged on a roofline virtual clock calibrated to the
*full-size* arch and the H100's data sheet (``perf.roofline.HW``), so the
TTFT / TPOT / goodput it prints are modelled, not measured, and
deterministic. Exit codes: 2 for an unknown arch, a family with no paged
serving path or a bad split, 1 for a run that left a request incomplete.

Before the run it prints each engine's production placement over a 16x16
(data x model) mesh view (``dist.placement``, plan arithmetic: no device
or process group is touched), as the reference does; an engine count that
divides no data-parallel axis prints the planner's reason instead.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.fleet --arch smollm_360m \\
        --smoke --device cpu --mode disagg --engines 4
    PYTHONPATH=src python -m repro_torch.launch.fleet --arch smollm-360m \\
        --mode disagg --engines 4 --quant 2 --slots 8
"""

import argparse
import dataclasses
import json
import sys

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.dist.mesh_axes import MeshView
from repro_torch.dist.placement import plan_engine_placement
from repro_torch.models import lm
from repro_torch.models.config import PAGED_FAMILIES, PREFIX_CACHE_FAMILIES
from repro_torch.runtime.cluster import (
    DisaggCluster,
    FleetCluster,
    SloPolicy,
    StepCostModel,
    TrafficSpec,
    measured_role_rates,
    synthesize,
)
from repro_torch.runtime.kv_pool import choose_block_tokens


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (costs still calibrate "
                         "to the full-size arch)")
    ap.add_argument("--mode", choices=["single", "fleet", "disagg"],
                    default="fleet")
    ap.add_argument("--engines", type=int, default=2)
    ap.add_argument("--policy",
                    choices=["least-loaded", "affinity", "prefix-aware"],
                    default="least-loaded")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="per-engine radix prefix caches over the KV pools "
                         "(--no-prefix-cache disables)")
    ap.add_argument("--split", default="",
                    help="disagg role split 'P,D'; empty = GALS-ratio "
                         "provisioning from the modelled rates")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--arrival-rate", type=float, default=2000.0,
                    help="Poisson arrivals per virtual second")
    ap.add_argument("--session-reuse", type=float, default=0.3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=0,
                    help="0 = sized from the trace's longest request")
    ap.add_argument("--block-tokens", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--slo-ttft", type=float, default=0.03,
                    help="TTFT SLO in virtual seconds")
    ap.add_argument("--slo-tpot", type=float, default=0.002,
                    help="per-token SLO in virtual seconds")
    ap.add_argument("--speculate", default="",
                    help="speculative decoding drafter per engine: 'ngram' "
                         "or an arch id whose packed twin drafts "
                         "(dense/vlm/moe families)")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="draft chain depth k")
    ap.add_argument("--spec-quant", type=int, default=2, choices=[1, 2],
                    help="packed-carrier width of a model drafter's FFN")
    ap.add_argument("--quant", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--json", default="", help="write the SLO report here")
    ap.add_argument("--trace-out", default="",
                    help="append one JSONL record per engine round "
                         "(runtime.tracker stream, all engines interleaved; "
                         "replay with runtime.tracker.replay_summary)")
    ap.add_argument("--trace-spans", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="emit per-request lifecycle span records into "
                         "--trace-out (runtime.spans; export with "
                         "perf.trace_export; --no-trace-spans for "
                         "rounds-only streams)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap


def build_cluster(cfg, full_cfg, params, args, spec):
    """The cluster ``args`` asks for, over ``params`` (one copy, shared by
    every engine; on the card every engine's steps run as CUDA graphs)."""
    cost = StepCostModel.for_config(full_cfg, slots=args.slots)
    max_len = args.max_len or spec.max_total_tokens + 8
    block_tokens = args.block_tokens or choose_block_tokens(
        [spec.max_total_tokens] * spec.n_requests
    )
    sampling = lm.SamplingParams(temperature=args.temperature, seed=args.seed)
    tracker = None
    if args.trace_out:
        from repro_torch.runtime.tracker import JsonlTracker

        tracker = JsonlTracker(args.trace_out)
    speculative = None
    if args.speculate:
        from repro_torch.runtime.speculative import SpecConfig, resolve

        # resolved once (validation and cost config); each engine builds
        # its own drafter from it
        speculative = resolve(
            cfg,
            SpecConfig(drafter=args.speculate, depth=args.spec_depth, quant=args.spec_quant),
            smoke=args.smoke,
        )
    common = dict(
        slots=args.slots,
        max_len=max_len,
        block_tokens=block_tokens,
        cost=cost,
        sampling=sampling,
        prefix_cache=args.prefix_cache and cfg.family in PREFIX_CACHE_FAMILIES,
        speculative=speculative,
        tracker=tracker,
        trace_spans=args.trace_spans,
        slo=SloPolicy(ttft=args.slo_ttft, tpot=args.slo_tpot),
    )
    n = 1 if args.mode == "single" else args.engines
    if args.mode == "disagg":
        split = None
        if args.split:
            p, d = args.split.split(",")
            split = (int(p), int(d))
        return DisaggCluster(
            cfg, params, n_engines=n, spec=spec, split=split, policy=args.policy, **common,
        )
    return FleetCluster(cfg, params, n_engines=n, policy=args.policy, **common)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        full_cfg = get_config(args.arch)
    except ValueError as e:
        print(f"[fleet] {e}")
        return 2
    if cfg.family not in PAGED_FAMILIES:
        print(f"[fleet] family {cfg.family!r} has no paged serving path; "
              "use an attention-KV or hybrid arch")
        return 2
    # every paged family disaggregates: a hybrid's handoff carries its SSM
    # lane state next to the KV-block rows
    if args.prefix_cache and cfg.family not in PREFIX_CACHE_FAMILIES:
        print(f"[fleet] note: family {cfg.family!r} cannot prefix-cache; "
              "serving uncached")
    if args.quant:
        cfg = dataclasses.replace(cfg, w_bits=args.quant)
        full_cfg = dataclasses.replace(full_cfg, w_bits=args.quant)

    use_prefix = args.prefix_cache and cfg.family in PREFIX_CACHE_FAMILIES
    spec = TrafficSpec(
        n_requests=args.requests,
        arrival_rate=args.arrival_rate,
        session_reuse=args.session_reuse,
        vocab=cfg.vocab,
        seed=args.seed,
    )
    trace = synthesize(spec)
    device = resolve_device(args.device)
    params = lm.init_params(cfg, args.seed, device=device)
    try:
        cluster = build_cluster(cfg, full_cfg, params, args, spec)
    except ValueError as e:
        print(f"[fleet] {e}")
        return 2

    n = len(cluster.engines)
    if args.mode == "disagg":
        rates = measured_role_rates(
            StepCostModel.for_config(full_cfg, slots=args.slots), spec, slots=args.slots,
        )
        print(
            f"[fleet] GALS rates: rho_p {rates.prefill_req_rate:.0f} req/s, "
            f"rho_d {rates.decode_req_rate:.0f} req/s, R_F {rates.r_f:.2f} "
            f"-> split {cluster.split[0]} prefill : {cluster.split[1]} decode"
            + (" (forced)" if args.split else " (Eq. 2 provisioned)")
        )
    # production placement of the engines over the single-pod mesh view
    view = MeshView(("data", "model"), (16, 16))
    try:
        for pl in plan_engine_placement(view, n):
            print(f"[fleet] {pl.describe()}")
    except ValueError as e:
        print(f"[fleet] placement: {e}")

    result = cluster.run(trace)
    if cluster.tracker is not None:
        cluster.tracker.finish()
        print(f"[fleet] wrote round-level tracker stream {args.trace_out}")
    report = result.report(SloPolicy(ttft=args.slo_ttft, tpot=args.slo_tpot))
    r = report.row()
    print(
        f"[fleet/{args.mode}] {n} engines, {r['completed']}/"
        f"{r['n_requests']} requests, {r['generated_tokens']} tokens in "
        f"{r['makespan']*1e3:.1f} virtual ms "
        f"({r['throughput_tokens_per_s']:.0f} tok/s, goodput "
        f"{r['goodput_tokens_per_s']:.0f} tok/s, {r['slo_met']} in-SLO)"
    )
    print(
        f"[fleet/{args.mode}] TTFT p50/p95/p99 {r['ttft_p50']*1e3:.1f}/"
        f"{r['ttft_p95']*1e3:.1f}/{r['ttft_p99']*1e3:.1f} ms, "
        f"TPOT p50/p99 {r['tpot_p50']*1e3:.2f}/{r['tpot_p99']*1e3:.2f} ms"
    )
    print(
        f"[fleet/{args.mode}] queue wait p50/p95 "
        f"{r['queue_wait_p50']*1e3:.2f}/{r['queue_wait_p95']*1e3:.2f} ms, "
        f"TTFT-from-admit p95 {r['ttft_admit_p95']*1e3:.1f} ms "
        "(spread from TTFT p95 is the queue)"
    )
    ss = result.slo_summary
    if ss:
        burns = ", ".join(
            f"{k[5:]}={ss[k]:.2f}" for k in sorted(ss) if k.startswith("burn_")
        )
        print(
            f"[fleet/{args.mode}] SLO monitor: {ss.get('observed', 0)} "
            f"observed, {ss.get('violations', 0)} violations"
            + (f", burn rates [{burns}]" if burns else "")
        )
    ms = result.mem_summary
    if ms:
        print(
            f"[fleet/mem] signal {ms['signal']}, peak occupancy "
            f"{ms['peak_occupancy']*100:.1f}%, min headroom "
            f"{ms['headroom_blocks']} blocks, {ms['evicted_blocks']} "
            f"blocks evicted fleet-wide"
            + (
                f", pressure on engines {ms['pressure_engines']}"
                if ms.get("pressure_engines")
                else ""
            )
        )
    for s in result.engine_summaries:
        line = (
            f"[fleet]   engine {s['engine']} ({s['role']}): "
            f"{s['completed']} done, {s['handoffs']} handoffs, "
            f"{s['prefill_tokens']} prefill tokens, "
            f"{s['decode_steps']} decode steps, clock {s['clock_s']*1e3:.1f} ms"
        )
        if use_prefix:
            line += (
                f", prefix hit rate {s['prefix_hit_rate']*100:.1f}% "
                f"({s['prefix_hit_tokens']} tokens, "
                f"{s['shared_blocks_peak']} shared blocks peak, "
                f"{s['cached_blocks']} cached)"
            )
        if args.speculate and s.get("verify_steps"):
            line += (
                f", spec {s['accepted_per_step']:.2f} accepted/verify "
                f"({s['accepted_tokens']} tokens / {s['verify_steps']} "
                "steps)"
            )
        mem = s.get("mem") or {}
        if mem:
            # the peak's snapshot: the report at the end sees an empty pool
            frag = mem.get("frag_at_peak") or s.get("fragmentation") or {}
            line += (
                f", mem peak {mem['peak_occupancy']*100:.0f}% occ "
                f"({mem['evicted_blocks']} evicted, packing "
                f"{frag.get('baseline_efficiency', 1.0)*100:.0f}%)"
            )
        print(line)
    if args.json:
        payload = {
            "mode": args.mode,
            "engines": n,
            "policy": args.policy,
            "speculate": args.speculate,
            "spec_depth": args.spec_depth if args.speculate else 0,
            "split": list(getattr(cluster, "split", ()) or ()),
            "report": r,
            "engine_summaries": result.engine_summaries,
            "slo_summary": result.slo_summary,
            "mem_summary": result.mem_summary,
        }
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"[fleet] wrote {args.json}")
    ok = report.completed == spec.n_requests
    if not ok:
        print(f"[fleet] INCOMPLETE: {report.completed}/{spec.n_requests}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
