"""The production dry run: walk every (arch x shape x mesh) cell on a fake
256- or 512-rank process group.

The port's counterpart of ``repro.launch.dryrun``, and the proof that the
distribution config holds together without the hardware. The reference
lowers and compiles each cell's step for 512 placeholder host devices and
reads the compiled module's memory and cost analyses. Here each cell's
step runs once, on ``meta`` ``DTensor`` stand-ins over a ``DeviceMesh`` of
a fake process group (``launch.mesh``): no storage, no device and no
network. ``perf.op_analysis.analyze`` walks the run and counts rank 0's
local ops, kernel reports and the collectives ``DTensor`` issues: the
counterpart of the reference's per-device SPMD module. The record's three
terms are modelled from ``perf.roofline.HW`` (the H100 SXM's data-sheet
HBM rate and bf16 peak, and NVLink 4's one-way rate); none is measured.
NVLink joins 8 GPUs, so a 16-wide 'model' axis spans two NVLink domains
and its collective term is a lower bound.

Differences from the reference's record: one ``t_walk_s`` stands for
``t_lower_s`` and ``t_compile_s`` (nothing is compiled); ``memory`` has no
``generated_code_size_in_bytes`` (no code is generated), and its
``temp_size_in_bytes`` is the walk's peak live bytes less the arguments';
``hooks`` names the mesh hooks the cell set and ``replicated_ops`` the ops
``DTensor`` ran on gathered inputs (bytes entering each all-gather).

``--attn-impl scan`` walks the cells with ``attention.set_attn_impl("scan")``
(the reference's scan-of-scans online softmax in plain torch, every block
pair computed) where the reference's dry run switches its attention, and
puts the switch back after; the sequence-sharded prefill and the paged
chunk paths keep the kernel, as the reference's keep their own paths.

``DTensor``'s sharding strategies and a few private names the walk reads
(``op_analysis._collective_origin``, ``_clear_sharding_caches``) change
between torch releases, and so may a record. The whole sweep was run on
torch 2.11 and 2.13 (TESTED_TORCH); on an older torch the CLI refuses
(exit 2).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe_1b_7b \\
        --shape train_4k --multi-pod --json out.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import ARCH_IDS, canonical_arch, get_config
from repro_torch.dist.legalize import PartitionSpec
from repro_torch.dist.mesh_axes import MeshView
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models import lm
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import SHAPES, ModelConfig, shape_applicable
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.perf import op_analysis
from repro_torch.perf.roofline import roofline
from repro_torch.runtime.steps import make_prefill_step, make_serve_step, make_train_step

HOOKS = ("attn_batch_sharding", "attn_seq_sharding", "moe_ep_axis", "decode_split_d")
TESTED_TORCH = ((2, 11), (2, 13))  # (major, minor) of the releases the sweep was run on


def torch_release() -> tuple[int, int]:
    """(major, minor) of the running torch."""
    major, minor = torch.__version__.split(".")[:2]
    return int(major), int(minor)


@dataclasses.dataclass
class Lowered:
    """A cell's step closed over its ``DTensor`` stand-ins: the
    counterpart of the reference's lowered module, which ``walk`` runs
    once under the op walk (its ``compile()`` and analyses)."""

    fn: Callable
    args: tuple

    def walk(self) -> op_analysis.OpCost:
        return op_analysis.analyze(self.fn, *self.args)


def reset_hooks() -> None:
    """Clear the four mesh hooks."""
    lm.set_attn_batch_sharding(None)
    lm.set_attn_seq_sharding(None)
    moe_lib.set_moe_ep_axis(None)
    lm.set_decode_split_d(None)


def set_hooks(cfg: ModelConfig, shape, mesh, constraints: bool = True) -> list[str]:
    """Set the four mesh hooks under the reference's conditions
    (``lower_cell``, its dryrun.py:56-112); returns the names of those set."""
    mv = MeshView.of(mesh)
    tp = mv.shape.get("model", 1)
    reset_hooks()
    fired = []
    # heads that do not divide TP: reshard attention batch-wise over the
    # largest axis combination the batch divides
    if constraints and cfg.n_heads % tp != 0 and shape.kind in ("train", "prefill"):
        for axes in (tuple(mv.axis_names), ("data", "model"), ("data",)):
            axes = tuple(a for a in axes if a in mv.axis_names)
            if "model" in axes and shape.global_batch % mv.product(axes) == 0:
                lm.set_attn_batch_sharding(PartitionSpec(axes))
                fired.append("attn_batch_sharding")
                break
    # where the batch reshard did not apply: sequence-sharded prefill
    if (constraints and cfg.n_heads % tp != 0 and shape.kind == "prefill"
            and lm._ATTN_BATCH_SHARD["spec"] is None and shape.seq_len % tp == 0):
        lm.set_attn_seq_sharding(mesh)
        fired.append("attn_seq_sharding")
    # MoE dispatch tensors pinned to the expert axis
    if constraints and cfg.family == "moe" and cfg.n_experts % tp == 0:
        moe_lib.set_moe_ep_axis("model")
        fired.append("moe_ep_axis")
    # KV heads that do not divide TP: split-d decode keeps the cache resident
    if (constraints and shape.kind == "decode" and cfg.n_kv % tp != 0 and cfg.hd % tp == 0
            and shape.global_batch % (mv.product(mv.axis_names) // tp) == 0):
        lm.set_decode_split_d(mesh)
        fired.append("decode_split_d")
    return fired


def _placed_as(tree, placements):
    """Every ``DTensor`` leaf of ``tree`` redistributed to ``placements``
    (the reference's ``out_shardings``; DTensor leaves a reduction
    ``Partial`` until something needs it)."""
    if isinstance(tree, DTensor):
        return tree.redistribute(tree.device_mesh, placements)
    if isinstance(tree, OptState):
        return OptState(*(_placed_as(t, p) for t, p in zip(tree, placements)))
    return {k: _placed_as(t, placements[k]) for k, t in tree.items()}


def lower_cell(
    cfg: ModelConfig,
    shape_name: str,
    mesh,
    *,
    remat: str = "full",
    ce_chunk: int = 512,
    constraints: bool = True,
) -> tuple[Lowered, dict]:
    """Build one (arch, shape) cell on ``mesh``. Returns (``Lowered``, meta
    {"kind", "hooks"}).

    The step comes from ``runtime.steps`` as the reference's does; its
    inputs are ``meta`` ``DTensor``s placed by the policy (the reference's
    ``in_shardings``), and it ends by redistributing its outputs to the
    reference's ``out_shardings``: the train step's parameters and
    optimizer state, the decode step's cache, each to its own placements.
    The reference donates those inputs; the port's steps update them in
    place, so there is nothing to donate. The hooks stay set until
    ``reset_hooks`` (``run_cell`` resets them after the walk)."""
    shape = SHAPES[shape_name]
    hooks = set_hooks(cfg, shape, mesh, constraints)
    p_sh = S.param_shardings(cfg, mesh)
    params = lm.LMParams(S.distribute_abstract(
        S.abstract_params(cfg).tree(), mesh, p_sh, trainable=shape.kind == "train"),
        trainable=shape.kind == "train")
    if shape.kind == "train":
        opt = AdamW()
        step = make_train_step(cfg, opt, remat=remat, ce_chunk=ce_chunk)
        o_sh = S.opt_shardings(cfg, mesh, opt)

        def run(params, opt_state, batch):
            with implicit_replication():
                params, opt_state, metrics = step(params, opt_state, batch)
                return _placed_as(params.tree(), p_sh), _placed_as(opt_state, o_sh), metrics

        args = (params, S.distribute_abstract(S.abstract_opt_state(cfg, opt), mesh, o_sh),
                S.distribute_abstract(S.abstract_batch(cfg, shape), mesh,
                                      S.batch_shardings(cfg, shape, mesh)))
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg)

        def run(params, batch):
            with implicit_replication():
                return step(params, batch)

        args = (params, S.distribute_abstract(S.abstract_batch(cfg, shape), mesh,
                                              S.batch_shardings(cfg, shape, mesh)))
    else:  # decode
        step = make_serve_step(cfg)
        c_sh = S.cache_shardings(cfg, shape, mesh)

        def run(params, token, cache):
            with implicit_replication():
                logits, cache = step(params, token, cache)
                return logits, _placed_as(cache, c_sh)

        args = (params,
                S.distribute_abstract(S.abstract_token(cfg, shape), mesh,
                                      S.token_shardings(cfg, shape, mesh)),
                S.distribute_abstract(S.abstract_cache(cfg, shape), mesh, c_sh))
    return Lowered(run, args), {"kind": shape.kind, "hooks": hooks}


def fold_residency(rec: dict, cfg: ModelConfig, shape, vmem_budget_mib: float) -> dict:
    """Fold a ``runtime.residency`` plan into a decode roofline record
    (the dry-run analogue of serving with ``--vmem-budget``): the record's
    memory term re-quoted with the plan's kept-off bytes subtracted, the
    saving divided across the mesh's devices, and the budgeted
    bottleneck. The port's plan does not depend on the traffic profile, so
    none is passed."""
    from repro_torch.perf.roofline import HW
    from repro_torch.runtime.residency import compile_residency_plan
    from repro_torch.runtime.residency.executor import supports_budgeted_decode

    rec = dict(rec)
    rec["vmem_budget_mib"] = vmem_budget_mib
    if shape.kind != "decode" or not supports_budgeted_decode(cfg):
        rec["residency"] = None  # the budget has nothing to pin in this cell
        return rec
    n_dev = 512 if rec["mesh"] == "2x16x16" else 256
    plan = compile_residency_plan(cfg, vmem_budget_bytes=int(vmem_budget_mib * 2**20))
    saved_per_dev = (plan.streamable_bytes_per_step - plan.streamed_bytes_per_step) / n_dev
    hbm_budgeted = max(0.0, rec["hbm_bytes_per_dev"] - saved_per_dev)
    t_mem = hbm_budgeted / HW.hbm_bw
    rec["residency"] = plan.summary()
    rec["hbm_bytes_per_dev_budgeted"] = hbm_budgeted
    rec["t_memory_budgeted_ms"] = t_mem * 1e3
    terms = {"compute": rec["t_compute_ms"], "memory": t_mem * 1e3,
             "collective": rec["t_collective_ms"]}
    rec["bottleneck_budgeted"] = max(terms, key=terms.get)
    return rec


def _clear_sharding_caches() -> None:
    """Empty ``DTensor``'s sharding-propagation caches (Python and, where
    this torch has it, C++), so each cell starts from none: an output spec
    cached by another arch's cell has been seen to mis-shape a gradient."""
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(type(prop), "_propagate_tensor_meta_cached", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", lambda: None)()


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    remat: str = "full",
    ce_chunk: int = 512,
    quant: int = 0,
    constraints: bool = True,
    vmem_budget_mib: float = 0.0,
) -> dict:
    """Walk one cell; return the reference's record (``t_walk_s`` for its
    two timings, and the ``hooks`` / ``replicated_ops`` keys)."""
    cfg = get_config(arch)
    if quant:
        cfg = dataclasses.replace(cfg, w_bits=quant)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod), "status": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size()
    _clear_sharding_caches()
    t0 = time.monotonic()
    try:
        lowered, meta = lower_cell(cfg, shape_name, mesh, remat=remat, ce_chunk=ce_chunk,
                                   constraints=constraints)
        cost = lowered.walk()
    finally:
        reset_hooks()
    t_walk = time.monotonic() - t0
    rl = roofline(f"{arch}/{shape_name}", cost, cfg, shape, n_dev)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": _mesh_name(multi_pod),
        "status": "OK",
        "kind": meta["kind"],
        "quant": quant,
        "remat": remat,
        "t_walk_s": round(t_walk, 1),
        "memory": {
            "argument_size_in_bytes": cost.argument_bytes,
            "output_size_in_bytes": cost.output_bytes,
            "temp_size_in_bytes": cost.peak_live_bytes - cost.argument_bytes,
        },
        "flops_per_dev": rl.flops,
        "hbm_bytes_per_dev": rl.hbm_bytes,
        "coll_bytes_per_dev": rl.coll_bytes,
        "coll_breakdown": rl.coll_breakdown,
        "model_flops": rl.model_flops,
        "t_compute_ms": rl.t_compute * 1e3,
        "t_memory_ms": rl.t_memory * 1e3,
        "t_collective_ms": rl.t_collective * 1e3,
        "bottleneck": rl.bottleneck,
        "useful_flops_ratio": rl.useful_flops_ratio,
        "roofline_fraction": rl.roofline_fraction,
        "hooks": meta["hooks"],
        "replicated_ops": {k.split(": ", 1)[1]: v for k, v in sorted(cost.implicit.items())
                           if k.startswith("all-gather")},
    }
    if vmem_budget_mib:
        rec = fold_residency(rec, cfg, shape, vmem_budget_mib)
    print(
        f"[dryrun] {arch:22s} {shape_name:12s} {rec['mesh']:8s} OK  "
        f"walk {t_walk:6.1f}s  "
        f"Tc {rec['t_compute_ms']:8.2f}ms Tm {rec['t_memory_ms']:8.2f}ms "
        f"Tcoll {rec['t_collective_ms']:8.2f}ms -> {rec['bottleneck']}"
        f"  hooks {','.join(meta['hooks']) or '-'}",
        flush=True,
    )
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Walk every (arch x shape x mesh) cell's step once on meta DTensor "
        "stand-ins over a fake 256- or 512-rank process group (no GPU, no network) and "
        "report each cell's per-device compute, memory and collective terms. The rates are "
        "modelled from the H100 SXM data sheet and NVLink 4's one-way rate, not measured; "
        "a 16-wide model axis spans two 8-GPU NVLink domains, so the collective term is a "
        "lower bound.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--ce-chunk", type=int, default=512)
    ap.add_argument("--quant", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--attn-impl", default="fa2", choices=["fa2", "scan"],
                    help="fa2: the port's flash kernels; scan: the reference's scan-of-scans "
                    "online softmax in plain torch (attention.flash_attention_scan), the "
                    "baseline the kernels are measured against")
    ap.add_argument("--no-constraints", action="store_true",
                    help="disable the mesh hooks (the paper-faithful baseline)")
    ap.add_argument("--vmem-budget", type=float, default=0.0,
                    help="MiB of on-chip budget for resident weight blocks: decode cells of "
                    "the families budgeted decode runs also quote the budgeted HBM bytes and "
                    "memory term from the residency plan")
    ap.add_argument("--json", default="")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if torch_release() < TESTED_TORCH[0]:
        print(f"[dryrun] torch {torch.__version__} is older than the releases the dry run was "
              f"run on ({', '.join('%d.%d' % v for v in TESTED_TORCH)}): its DTensor shards "
              "some of the cells' ops otherwise or not at all")
        return 2
    if args.arch != "all":
        try:
            canonical_arch(args.arch)
        except ValueError as e:
            print(f"[dryrun] {e}")
            return 2
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    prev_impl = attn._ATTN_IMPL["name"]
    attn.set_attn_impl(args.attn_impl)  # process-wide; put back after the cells
    try:
        records, failures = _run_cells(args, archs, shapes, meshes)
    finally:
        attn.set_attn_impl(prev_impl)
    if args.json:
        with open(args.json, "a") as fh:
            for r in records:
                fh.write(json.dumps(r) + "\n")
    n_ok = sum(1 for r in records if r["status"] == "OK")
    n_skip = sum(1 for r in records if r["status"].startswith("SKIP"))
    print(f"[dryrun] {n_ok} OK, {n_skip} skipped, {len(failures)} failed")
    return 1 if failures else 0


def _run_cells(args, archs, shapes, meshes) -> tuple[list[dict], list[dict]]:
    """Every (arch, shape, mesh) cell's record, and the failed ones."""
    records, failures = [], []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(
                        arch, shape, multi_pod=mp, remat=args.remat, ce_chunk=args.ce_chunk,
                        quant=args.quant, constraints=not args.no_constraints,
                        vmem_budget_mib=args.vmem_budget,
                    )
                except Exception as e:  # noqa: BLE001: report every failure
                    rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    failures.append(rec)
                    print(f"[dryrun] {arch} {shape} FAILED: {e}", flush=True)
                records.append(rec)
    return records, failures


if __name__ == "__main__":
    sys.exit(main())
