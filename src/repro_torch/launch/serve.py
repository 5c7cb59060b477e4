"""Serving entry point: continuous batching over a shared KV pool, in PyTorch.

Port of ``repro.launch.serve``. Its pool engine (the default): one
physical KV pool (``runtime.kv_pool``), token-budget admission, bucketed one-step or
chunked prefill, and paged decode lanes that each run at their own depth
(``runtime.scheduler``), with the radix prefix cache over the pool on by
default, as in the reference (``--no-prefix-cache`` turns it off). Runs
on CUDA unless ``--device cpu`` is given; without a GPU and without
``--device cpu`` it exits with an error. On the card every step runs as a
captured CUDA graph (the reference's jitted steps): the decode step, the
prefill chunk and the whole-prompt prefill of each bucket; on the CPU
every step runs eagerly.

``--arch`` takes every arch: smollm-360m (the default),
llama3.2-1b, h2o-danube-1.8b and phi3-medium-14b, the vlm arch
internvl2-76b (its text tokens, served as a dense arch, as the reference
serves it; its patch-embedding prefix runs through
``runtime.steps.make_prefill_step``), and the MoE archs
olmoe-1b-7b and moonshot-v1-16b-a3b (or their module ids). An MoE arch
serves through the dropless expert dispatch and prints a ``[serve/moe]``
line (routed tokens, load entropy, the share routed to resident experts);
``--quant`` leaves its experts dense, with the reference's note, and
``--vmem-budget`` streams its cold experts. The hybrid arch zamba2-2.7b
serves through the same pool engine with a per-lane SSM state beside the
pool, unpadded prompts, chunks that resume from the carried state and
prefix-cache anchors (host copies of a lane's state); ``--quant`` packs
its one shared FFN (the Mamba2 layers have none), and ``--speculate`` and
``--vmem-budget`` exit 2 with the reference's reasons (an SSM state cannot
roll back a rejected chain; it is out of the residency executor's scope).
It prints a ``[serve/hybrid]`` line: the lanes' state on the card, and the
anchors' host copies (count, MB, ms each). The enc-dec arch whisper-tiny
prints the reference's line and exits 0: its encoder, cross-attention and
decode step (``models.encdec``) run in the tests and the smoke run, not
through this CLI.

``--engine fixed`` runs the reference's fixed-batch loop instead
(``run_fixed_engine``): per-slot caches, lanes in lockstep, prompts
replayed token by token through the decode step, greedy decoding; the A/B
baseline, and the only engine of the SSM family: ``--arch mamba2-1.3b``
switches to it with the reference's message, as every family outside the
paged ones does. On the card each of its steps is one CUDA graph. With
it, ``--vmem-budget`` and ``--speculate`` exit 2 with the reference's
reasons; ``--trace-out`` stays with the pool engine, as in the reference.
An MoE arch on it decodes through the capacity dispatch
(``moe.moe_ffn``), as the reference's fixed loop does.

``--speculate`` serves with speculative decoding (``runtime.speculative``):
``ngram`` (the self-drafting suffix match) or an arch whose packed twin,
at ``--spec-quant`` bits, drafts ``--spec-depth``-token chains; a drafter
that cannot serve the target exits 2 with the compatible drafters listed.
It prints the reference's ``[serve/spec]`` line.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m --quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-medium-14b --quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b --smoke --device cpu --quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b --smoke --device cpu --quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --no-prefix-cache
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --speculate ngram
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --speculate smollm_360m --spec-quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --vmem-budget 0.25
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b --smoke --device cpu --vmem-budget 0.5
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --quant 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --smoke --device cpu --prefill-chunk 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --batch 8 --prompt-len 128 --gen-len 64 --max-len 192
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --quant 2 --engine fixed
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu --trace-out t.jsonl
    PYTHONPATH=src python -m repro_torch.perf.trace_export t.jsonl --check

``--vmem-budget`` (MiB) serves budgeted decode under a residency plan
and prints the reference's ``[serve/residency]`` line. ``--trace-out``
appends the run's round records, request spans (``--no-trace-spans``
leaves them out) and memory-ledger records to a JSONL file, as the
reference does; a memory ledger and its pressure monitor run on every
run and give the ``[serve/mem]`` line. Besides the reference's
``[serve/pool]`` and ``[serve/prefix]`` lines it prints each kernel's
launch count, and a ``[serve/metrics]`` line with the run's numbers (the
seconds ``init_params`` took to draw the weights among them, the host ms
of a verify step and of a model drafter's steps, each to its logits on the
host, and every request's tokens) as JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.config import PACKING_FAMILIES, PAGED_FAMILIES
from repro_torch.runtime.kv_pool import KVPool, choose_block_tokens
from repro_torch.runtime.memledger import MemLedger, MemPressureMonitor
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.residency import (
    BUDGET_REFUSAL,
    RuntimeResidencyPlan,
    compile_residency_plan,
    supports_budgeted_decode,
)
from repro_torch.runtime.scheduler import Scheduler
from repro_torch.runtime.spans import SpanRecorder
from repro_torch.runtime.speculative import SpecConfig, build_speculator, resolve
from repro_torch.runtime.steps import CapturedStep, make_serve_step
from repro_torch.runtime.tracker import JsonlTracker


def make_requests(args, vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(args.seed)
    return [
        rng.integers(0, vocab, size=(args.prompt_len,)).astype(np.int32)
        for _ in range(args.requests)
    ]


def build_residency_plan(cfg, args) -> RuntimeResidencyPlan | None:
    """Compile the ``--vmem-budget`` residency plan (None when unbudgeted)."""
    if not args.vmem_budget:
        return None
    if not supports_budgeted_decode(cfg):
        raise ValueError(BUDGET_REFUSAL.format(family=cfg.family))
    return compile_residency_plan(
        cfg, vmem_budget_bytes=int(args.vmem_budget * 2**20)
    )


def spec_config(args) -> SpecConfig | None:
    """The ``--speculate`` / ``--spec-depth`` / ``--spec-quant`` choice."""
    if not args.speculate:
        return None
    return SpecConfig(drafter=args.speculate, depth=args.spec_depth, quant=args.spec_quant)


def build_pool_engine(
    cfg, params, args, device, residency=None, *, compiled: bool | None = None,
    speculative=None,
) -> Scheduler:
    """The pool scheduler of ``args``; ``compiled`` is the scheduler's
    (None: CUDA graphs on the card, eager on the CPU). ``speculative`` is
    a built ``Speculator``; None builds the one ``--speculate`` names
    (none without it)."""
    total = args.prompt_len + args.gen_len
    block_tokens = args.block_tokens or choose_block_tokens(
        [total] * args.requests
    )
    pool = KVPool.for_slots(
        cfg, slots=args.batch, max_len=args.max_len,
        block_tokens=block_tokens, device=device,
    )
    prefix_cache = PrefixCache(pool) if args.prefix_cache else None
    tracker = spans = None
    if args.trace_out:
        tracker = JsonlTracker(args.trace_out)
        if args.trace_spans:
            # standalone serving stamps spans on the host's monotonic clock
            spans = SpanRecorder(time.monotonic, tracker=tracker)
    # no engine stamp: standalone round records carry none either, and the
    # ledger's and the metrics' engine keys must agree for validate_ledger
    ledger = MemLedger(time.monotonic, tracker=tracker)
    spec = spec_config(args)
    if speculative is None and spec is not None:
        speculative = build_speculator(
            cfg, params, spec, slots=args.batch, max_len=args.max_len, smoke=args.smoke
        )
    return Scheduler(
        cfg,
        params,
        pool,
        slots=args.batch,
        max_len=args.max_len,
        token_budget=args.token_budget or None,
        decode_per_round=args.rf or None,
        sampling=lm.SamplingParams(
            temperature=args.temperature,
            top_k=args.top_k,
            top_p=args.top_p,
            seed=args.seed,
        ),
        prefill_chunk=args.prefill_chunk or None,
        residency=residency,
        compiled=compiled,
        prefix_cache=prefix_cache,
        speculative=speculative,
        tracker=tracker,
        spans=spans,
        ledger=ledger,
        mem_monitor=MemPressureMonitor(),
    )


def _replay_step_ms(sched, stats) -> float | None:
    """The mean decode step without the decode graph's eager first call
    and capture (both inside ``decode_time``); None when not compiled."""
    g = sched.decode_graph
    if g is None or stats.decode_steps < 2:
        return None
    setup = g.first_call_s + g.capture_s
    return (stats.decode_time - setup) / (stats.decode_steps - 1) * 1e3


def _spec_metrics(sched, stats) -> dict:
    """The speculative keys of ``[serve/metrics]``: the reference's
    counters, and host ms: a verify step's (its graphs' first calls and
    captures left out of ``verify_step_ms_replay``), a drafter's proposal
    per verify step, and a model drafter's decode step and prompt prefill,
    each to its logits on the host."""
    spec = sched.speculative
    out = {
        "speculate": spec.name if spec is not None else "",
        "spec_depth": spec.depth if spec is not None else 0,
        "accepted_tokens": stats.accepted_tokens,
        "draft_tokens": stats.draft_tokens,
        "verify_steps": stats.verify_steps,
        "accepted_per_step": stats.accepted_per_step,
    }
    if spec is None:
        return out
    n = stats.verify_steps
    setup = sum(g.first_call_s + g.capture_s for g in sched.verify_graphs.values())
    replays = sum(g.replays for g in sched.verify_graphs.values())
    ds = getattr(spec.drafter, "stats", None)
    out.update(
        verify_step_ms=sched.verify_s / n * 1e3 if n else 0.0,
        verify_step_ms_replay=(
            (sched.verify_s - setup) / replays * 1e3 if replays else None
        ),
        verify_graph_lengths=sorted(sched.verify_graphs),
        verify_steps_by_length={str(k): c for k, c in sorted(sched.verify_lengths.items())},
        propose_ms_per_verify_step=sched.propose_s / n * 1e3 if n else 0.0,
        draft_steps=ds.decode_steps if ds else 0,
        draft_step_ms=ds.decode_s / ds.decode_steps * 1e3 if ds and ds.decode_steps else None,
        draft_prefills=ds.prefills if ds else 0,
        draft_prefill_ms=ds.prefill_s / ds.prefills * 1e3 if ds and ds.prefills else None,
    )
    return out


def _hybrid_metrics(sched) -> dict:
    """The hybrid keys of ``[serve/metrics]``: the lanes' SSM state on the
    pool's device, and the prefix cache's anchors: the host copies taken
    (``Scheduler._lane_snapshot``), their MB and host ms each."""
    n = sched.snapshots
    return {
        "lane_state_mib": sum(v.nbytes for v in sched._lane_state.values()) / 2**20,
        "snapshots": n,
        "snapshot_mib": sched.snapshot_bytes / 2**20,
        "snapshot_ms_mean": sched.snapshot_s / n * 1e3 if n else None,
        "anchors": sched.prefix_cache.stats()["anchors"] if sched.prefix_cache else 0,
    }


def run_pool_engine(
    cfg, params, args, device, residency=None, *, compiled: bool | None = None
) -> dict:
    sched = build_pool_engine(cfg, params, args, device, residency, compiled=compiled)
    for prompt in make_requests(args, cfg.vocab):
        sched.submit(prompt, args.gen_len)
    t0 = time.monotonic()
    stats = sched.run()
    dt = time.monotonic() - t0
    if sched.tracker is not None:
        sched.tracker.finish()
    outputs = sched.outputs()
    if stats.completed != args.requests or any(
        len(v) != args.gen_len for v in outputs.values()
    ):
        raise RuntimeError(
            f"served {stats.completed}/{args.requests} requests; output "
            f"lengths {sorted({len(v) for v in outputs.values()})} != {args.gen_len}"
        )
    return {
        "engine": "pool",
        "device": str(device),
        "compiled": sched.compiled,
        "requests": args.requests,
        "completed": stats.completed,
        "generated_tokens": stats.generated_tokens,
        "steps": stats.prefill_steps + stats.decode_steps,
        "prefill_steps": stats.prefill_steps,
        "decode_steps": stats.decode_steps,
        "wall_s": dt,
        "tokens_per_s": stats.generated_tokens / dt if dt > 0 else 0.0,
        "decode_step_ms": (
            stats.decode_time / stats.decode_steps * 1e3
            if stats.decode_steps
            else 0.0
        ),
        "mean_ttft_s": stats.mean_ttft,
        "pool_utilization": stats.steady_state_utilization,
        "block_tokens": sched.pool.block_tokens,
        "prefix_cache": sched.prefix_cache is not None,
        "prefix_hits": stats.prefix_hits,
        "prefix_hit_tokens": stats.prefix_hit_tokens,
        "prefix_hit_rate": stats.prefix_hit_rate,
        "shared_blocks_peak": stats.shared_blocks_peak,
        "cached_blocks": sched.pool.cached_blocks,
        "prefill_tokens": stats.prefill_tokens,
        **_spec_metrics(sched, stats),
        "expert_tokens": stats.expert_tokens,
        "moe": sched.moe_gauges() if cfg.family == "moe" else None,
        "hybrid": _hybrid_metrics(sched) if cfg.family == "hybrid" else None,
        "residency": residency.summary() if residency is not None else None,
        "graphs": len(sched.graphs),
        "graph_replays": sum(g.replays for g in sched.graphs),
        "graph_pool_bytes": sum(g.pool_bytes for g in sched.graphs),
        "graph_first_call_s": sum(g.first_call_s for g in sched.graphs),
        "graph_capture_s": sum(g.capture_s for g in sched.graphs),
        "decode_step_ms_replay": _replay_step_ms(sched, stats),
        "span_records": sched.spans.n_spans if sched.spans else 0,
        "mem": sched.mem_summary(),
        "mem_records": sched.ledger.n_records,
        "fragmentation": sched.pool.fragmentation_report(),
        "outputs": outputs,
    }


def check_fixed_geometry(args) -> None:
    """The fixed engine's ring cache holds ``--max-len`` rows: a request
    past them would clobber its own history (``ValueError``, exit 2)."""
    if args.prompt_len + args.gen_len > args.max_len:
        raise ValueError(
            f"request needs {args.prompt_len + args.gen_len} tokens "
            f"> max_len {args.max_len}"
        )


def run_fixed_engine(cfg, params, args, device, *, compiled: bool | None = None) -> dict:
    """The reference's fixed-batch loop (``serve.py:200``): per-slot
    caches (``lm.init_cache``), lockstep positions, prompts replayed token
    by token through the decode step, greedy argmax, and the queue drained
    to empty (``requests % batch != 0`` included). At each wave boundary
    the cache is zeroed in place (the reference allocates a fresh one) and
    every lane's token reset to 0, so a wave's first step feeds token 0 at
    position 0 before the prompt's first token, as the reference's does.

    ``compiled`` (None: on a CUDA device) runs every decode step as one
    ``CapturedStep`` over the cache: the step's only input is the (B, 1)
    token; the cache and its ``len`` are the graph's static buffers. There
    is no fallback: a capture that fails raises. The metrics are the
    reference's (``prefill_steps`` 0, ``decode_step_ms`` over the steps
    that generate, host bookkeeping included, ``mean_ttft_s``), with the
    graph's numbers and ``decode_step_ms_replay``: the host ms of a step
    call to its argmax on the host, over the replays."""
    check_fixed_geometry(args)
    device = torch.device(device)
    if compiled is None:
        compiled = device.type == "cuda"
    if compiled and device.type != "cuda":
        raise ValueError(
            f"compiled steps are CUDA graphs; {device} has none "
            "(pass compiled=False or leave it None)"
        )
    b = args.batch
    cache = lm.init_cache(cfg, b, args.max_len, device=device)
    serve_step = make_serve_step(cfg)
    graph = None
    if compiled:
        graph = CapturedStep(lambda t: serve_step(params, t, cache)[0], device=device,
                             mempool=torch.cuda.graph_pool_handle())
        step = graph
    else:
        def step(t):
            return serve_step(params, t.to(device), cache)[0]

    queue = make_requests(args, cfg.vocab)
    active: list[int | None] = [None] * b
    to_go = np.zeros(b, np.int32)
    fed = np.zeros((b,), np.int32)
    prompts: list[np.ndarray | None] = [None] * b
    outputs: dict[int, list[int]] = {}
    ttft: dict[int, float] = {}
    next_req = done = steps = gen_steps = 0
    decode_time = replay_time = 0.0
    t0 = time.monotonic()
    token = np.zeros((b, 1), np.int32)
    while done < args.requests:
        if next_req < len(queue) and all(a is None for a in active):
            # wave boundary (lockstep lengths drain all slots at once)
            lm.zero_cache(cache)
            token[:] = 0
        for i in range(b):
            if active[i] is None and next_req < len(queue):
                active[i] = next_req
                prompts[i] = queue[next_req]
                fed[i] = 0
                to_go[i] = args.gen_len
                outputs[next_req] = []
                next_req += 1
        ts = time.monotonic()
        logits = step(torch.from_numpy(token))
        nxt = logits[:, 0, :].argmax(dim=-1).to(torch.int32).cpu().numpy()
        if steps:
            replay_time += time.monotonic() - ts
        steps += 1
        generated_this_step = 0
        for i in range(b):
            if active[i] is None:
                continue
            if fed[i] < len(prompts[i]):  # still feeding the prompt
                token[i, 0] = prompts[i][fed[i]]
                fed[i] += 1
            else:
                if not outputs[active[i]]:
                    ttft[active[i]] = time.monotonic() - t0
                generated_this_step += 1
                outputs[active[i]].append(int(nxt[i]))
                token[i, 0] = nxt[i]
                to_go[i] -= 1
                if to_go[i] <= 0:
                    done += 1
                    active[i] = None
        if generated_this_step:
            # a decoding step, counted once per step, host bookkeeping included
            decode_time += time.monotonic() - ts
            gen_steps += 1
        if steps > args.requests * (args.prompt_len + args.gen_len) + 64:
            raise RuntimeError("serving loop failed to drain the queue")
    dt = time.monotonic() - t0
    total_tokens = sum(len(v) for v in outputs.values())
    graphs = [graph] if graph is not None else []
    return {
        "engine": "fixed",
        "device": str(device),
        "compiled": compiled,
        "requests": args.requests,
        "completed": done,
        "generated_tokens": total_tokens,
        "steps": steps,
        "prefill_steps": 0,
        "decode_steps": steps,
        "wall_s": dt,
        "tokens_per_s": total_tokens / dt if dt > 0 else 0.0,
        "decode_step_ms": decode_time / gen_steps * 1e3 if gen_steps else 0.0,
        "mean_ttft_s": sum(ttft.values()) / len(ttft) if ttft else 0.0,
        "pool_utilization": 0.0,
        "block_tokens": 0,
        "prefix_cache": False,
        "prefix_hits": 0,
        "prefix_hit_tokens": 0,
        "prefix_hit_rate": 0.0,
        "shared_blocks_peak": 0,
        "cached_blocks": 0,
        "cache_mib": sum(v.nbytes for v in cache.values()) / 2**20,
        "graphs": len(graphs),
        "graph_replays": sum(g.replays for g in graphs),
        "graph_pool_bytes": sum(g.pool_bytes for g in graphs),
        "graph_first_call_s": sum(g.first_call_s for g in graphs),
        "graph_capture_s": sum(g.capture_s for g in graphs),
        "decode_step_ms_replay": (
            replay_time / (steps - 1) * 1e3 if compiled and steps > 1 else None
        ),
        "outputs": outputs,
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=["pool", "fixed"], default="pool",
                    help="pool: continuous batching over the KV pool; fixed: the "
                         "fixed-batch loop over per-slot caches (lockstep "
                         "positions, prompts replayed through the decode step), "
                         "the A/B baseline and the SSM family's engine")
    ap.add_argument("--block-tokens", type=int, default=0,
                    help="KV-pool block size; 0 = bin-cost sweep")
    ap.add_argument("--rf", type=int, default=0,
                    help="decode steps per admission round; 0 = Eq. 2 default")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="admission token budget; 0 = pool capacity")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk size for long prompts; "
                         "0 = the admission token budget")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix cache over the KV pool: requests "
                         "adopt their longest cached prefix's blocks and "
                         "prefill only the unmatched suffix "
                         "(--no-prefix-cache disables)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature; 0 = greedy")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the top-k logits; 0 = off")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass; 1.0 = off")
    ap.add_argument("--speculate", default="",
                    help="speculative decoding drafter: 'ngram' (self-drafting "
                         "suffix match) or an arch id whose packed twin drafts "
                         "for the target (dense or vlm family)")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="draft chain depth k: each verify step scores the "
                         "pending token plus k-1 proposals")
    ap.add_argument("--spec-quant", type=int, default=2, choices=[1, 2],
                    help="packed-carrier width of a model drafter's FFN "
                         "(the twin's w_bits)")
    ap.add_argument("--quant", type=int, default=0, choices=[0, 1, 2],
                    help="serve with FCMP-packed 1/2-bit FFN weights")
    ap.add_argument("--vmem-budget", type=float, default=0.0,
                    help="MiB of FFN weight tiles (plan arithmetic, 8 rows x "
                         "128 B per tile) whose layers run the resident path; "
                         "on the H100 that selects the kernel (packed_matmul "
                         "or matmul) and pins nothing on chip. Every other "
                         "layer streams its FFN weights each decode step "
                         "through stream_matmul's shared-memory ring "
                         "(0 = unbudgeted)")
    ap.add_argument("--trace-out", default="",
                    help="append one JSONL record per scheduler round, with "
                         "the memory ledger's records (runtime.tracker stream)")
    ap.add_argument("--trace-spans", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="emit per-request lifecycle span records into "
                         "--trace-out (host-clock stamps; export with "
                         "repro_torch.perf.trace_export; --no-trace-spans "
                         "for rounds-only streams)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    except ValueError as e:
        print(f"[serve] {e}")
        return 2
    if cfg.family == "encdec":
        print("[serve] encdec serving is exercised in tests; use an LM arch")
        return 0
    if args.quant:
        if cfg.family not in PACKING_FAMILIES:
            print(f"[serve] note: --quant has no effect on family "
                  f"{cfg.family!r} (no dense FFN to pack)")
        else:
            cfg = dataclasses.replace(cfg, w_bits=args.quant)
    engine = args.engine
    if engine == "pool" and cfg.family not in PAGED_FAMILIES:
        print(f"[serve] family {cfg.family!r} keeps fixed-size per-slot "
              "decode state and holds no KV rows; using the fixed-batch "
              "engine")
        engine = "fixed"
    if engine == "fixed":
        if args.vmem_budget:
            print(f"[serve] --vmem-budget needs the pool engine's paged decode; "
                  f"family {cfg.family!r} / --engine fixed cannot run budgeted")
            return 2
        if args.speculate:
            print(f"[serve] --speculate needs the pool engine's paged verify; "
                  f"family {cfg.family!r} / --engine fixed cannot speculate")
            return 2
    try:
        if engine == "fixed":
            check_fixed_geometry(args)  # before the weights are drawn
            residency = None
        else:
            residency = build_residency_plan(cfg, args)
            spec = spec_config(args)
            if spec is not None:
                resolve(cfg, spec, smoke=args.smoke)  # before the weights are drawn
    except ValueError as e:
        print(f"[serve] {e}")
        return 2
    device = resolve_device(args.device)
    t0 = time.monotonic()
    params = lm.init_params(cfg, args.seed, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    init_s = time.monotonic() - t0
    before, before_routes = ops.launch_counts(), ops.launch_routes()
    try:
        if engine == "fixed":
            m = run_fixed_engine(cfg, params, args, device)
        else:
            m = run_pool_engine(cfg, params, args, device, residency)
    except ValueError as e:
        # bad request/budget geometry (e.g. prompt+gen > --max-len)
        print(f"[serve] {e}")
        return 2
    m["init_s"] = init_s
    m["kernel_launches"] = {
        name: n - before[name] for name, n in ops.launch_counts().items()
    }
    m["kernel_launches_by_route"] = {
        name: {r: n - before_routes.get(name, {}).get(r, 0) for r, n in by.items()}
        for name, by in ops.launch_routes().items()
    }
    pool = m["engine"] == "pool"
    print(
        f"[serve/{m['engine']}] {m['requests']} requests, "
        f"{m['generated_tokens']} generated tokens in {m['steps']} steps "
        f"({m['prefill_steps']} prefill + {m['decode_steps']} decode), "
        f"{m['wall_s']:.1f}s ({m['tokens_per_s']:.1f} tok/s, "
        f"TTFT {m['mean_ttft_s']*1e3:.0f} ms), "
        + (f"pool utilization {m['pool_utilization']*100:.1f}%; " if pool
           else f"per-slot cache {m['cache_mib']:.1f} MiB; ")
        + f"weights of {cfg.name} drawn in {init_s:.1f}s"
    )
    if pool and m["speculate"]:
        print(
            f"[serve/spec] drafter {m['speculate']} depth {m['spec_depth']}: "
            f"{m['accepted_tokens']} tokens from {m['verify_steps']} verify "
            f"steps ({m['accepted_per_step']:.2f} accepted/step, "
            f"{m['draft_tokens']} drafted)"
        )
    if pool and m["prefix_cache"]:
        print(
            f"[serve/prefix] {m['prefix_hits']} prefix hits, "
            f"{m['prefix_hit_tokens']} prompt tokens served from cache "
            f"(hit rate {m['prefix_hit_rate']*100:.1f}%), "
            f"{m['shared_blocks_peak']} shared blocks at peak, "
            f"{m['cached_blocks']} blocks cached at drain"
        )
    if pool and m["residency"]:
        r = m["residency"]
        streamed = ""
        if cfg.family == "moe":
            mask = residency.expert_stream_mask(cfg)
            streamed = (f"; {sum(map(sum, mask))} of {cfg.n_layers * cfg.n_experts} "
                        f"experts streamed")
        print(
            f"[serve/residency] {r['resident_blocks']}/{r['n_blocks']} "
            f"weight blocks resident{streamed}, stream-ahead depth {r['stream_ahead']} "
            f"(R_F); plan arithmetic, not measured: {r['resident_mib']:.2f} "
            f"of {r['vmem_budget_mib']:.2f} MiB budget in tiles, "
            f"{r['planned_stream_fraction']*100:.0f}% of the FFN weight bytes "
            f"({r['planned_streamed_mib_per_step']:.2f} MiB per step) through "
            f"stream_matmul; the HBM traffic on the card is the same, since "
            f"resident layers also read their weights every step"
        )
    if pool and m["moe"] is not None:
        g = m["moe"]
        line = (f"[serve/moe] {m['expert_tokens']} routed (token, expert) slots, "
                f"load entropy {g.get('moe_expert_entropy', 0.0):.4f}, "
                f"{g.get('moe_hot_expert_fraction', 0.0)*100:.1f}% routed to "
                f"resident experts")
        if "moe_streamed_experts" in g:
            line += (f", {g['moe_streamed_experts']} streamed experts, "
                     f"{g['moe_stream_mask_occupancy']*100:.1f}% of them routed to")
        print(line)
    if pool and m["hybrid"] is not None:
        h = m["hybrid"]
        line = (f"[serve/hybrid] lane SSM state {h['lane_state_mib']:.1f} MiB on "
                f"{m['device']}, {h['snapshots']} anchor copies to the host "
                f"({h['snapshot_mib']:.1f} MiB")
        if h["snapshot_ms_mean"] is not None:
            line += f", {h['snapshot_ms_mean']:.2f} ms each"
        print(line + f"), {h['anchors']} anchors cached at drain")
    if m["compiled"]:
        print(
            f"[serve/graphs] serve steps compiled: "
            f"{m['graphs']} CUDA graphs, {m['graph_replays']} replays, "
            f"{m['graph_pool_bytes'] / 2**20:.1f} MiB in their memory pool; "
            f"first calls {m['graph_first_call_s']:.3f}s and captures "
            f"{m['graph_capture_s']:.3f}s"
            + (
                f"; decode step {m['decode_step_ms']:.2f} ms mean, "
                f"{m['decode_step_ms_replay']:.2f} ms without its first "
                f"call and capture"
                if m["decode_step_ms_replay"] is not None
                else ""
            )
        )
    if pool:
        mm = m["mem"]
        frag = mm.get("frag_at_peak") or {}
        line = (
            f"[serve/mem] signal {mm['signal']}, peak occupancy "
            f"{mm['peak_occupancy']*100:.1f}% "
            f"({mm['peak_held_blocks']} blocks, headroom "
            f"{mm['headroom_blocks']}), {mm['evicted_blocks']} blocks "
            f"evicted, {m['mem_records']} ledger records"
        )
        if frag:
            line += (
                f", packing at peak "
                f"{frag.get('baseline_efficiency', 1.0)*100:.1f}% "
                f"(FFD bound {frag.get('ffd_efficiency', 1.0)*100:.1f}%)"
            )
        print(line)
    print(
        "[serve/kernels] "
        + ", ".join(f"{k} {n} launches" for k, n in m["kernel_launches"].items())
    )
    print("[serve/metrics] " + json.dumps(m))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
