"""Training entry point, in PyTorch.

Port of ``repro.launch.train``: AdamW over the stacked parameters,
``runtime.train.TrainLoop`` over ``TokenPipeline`` batches, with atomic
async checkpoints in the reference's format and deterministic resume. It
trains the families whose batches are tokens and labels alone: dense,
MoE (the capacity dispatch and its aux loss), SSM and hybrid. The vlm and
enc-dec families need batches that carry ``prefix_embeds`` / ``frames``,
which ``TokenPipeline`` does not yield (the reference's CLI fails there
with a ``KeyError`` at the first step): this CLI exits 2 with that
reason, and they train through ``runtime.steps.make_train_step`` on such
batches. Attention runs the flash kernels forward and backward
(``flash_fwd``, ``flash_bwd``). Runs on CUDA unless ``--device cpu`` is
given; without a GPU and without ``--device cpu`` it raises.

On a mesh: launched under ``torchrun`` (``WORLD_SIZE`` in the
environment), each rank joins the process group (``nccl`` for CUDA, each
rank on ``cuda:{LOCAL_RANK}``; ``gloo`` for ``--device cpu``), trains on
the reference's ``fit_mesh`` (a ``("data", "model")`` ``DeviceMesh``
over every rank) or, with ``--production-mesh``, on the 16 x 16 mesh of
exactly 256 ranks (any other size, or no group, exits 2), and destroys the
group before it returns. A group the caller already made is used and left
alone. Parameters and AdamW state are ``DTensor``s laid out by the
sharding policy (``launch.specs``) from the seeded draw every rank makes
alike; the batch's rows split over ``data``; the step runs under
``implicit_replication()`` as the dry run's; the loss is read whole;
checkpoints keep the reference's format (``ckpt.manager``); only rank 0
prints. Without such an environment it trains on plain tensors.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --batch 8 --seq 512 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3 --batch 2 --seq 32 --ckpt /tmp/ckpt
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
        --smoke --device cpu --steps 3 --batch 4 --seq 64

Besides the reference's ``[train]`` lines it prints each kernel's launch
count and a ``[train/metrics]`` line with the run's numbers as JSON (for
MoE also the last step's aux loss; the mesh's shape and axis names and the
world size). ``main(argv, params=...)`` trains weights the caller already
holds, the ones ``lm.init_params(cfg, --seed)`` would draw, in place of a
fresh draw.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_real_mesh
from repro_torch.models import lm
from repro_torch.models.config import PACKING_FAMILIES, ShapeConfig, modality_batch_leaves
from repro_torch.optim.adamw import AdamW, OptState
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig

PRODUCTION_MESH = ((16, 16), ("data", "model"))


def fit_mesh_shape(n: int) -> tuple[int, int]:
    """The reference's ``fit_mesh`` rule over ``n`` devices: 'model' is
    the first of 16, 8, 4, 2, 1 that divides n, 'data' the rest."""
    model = 1
    for m in (16, 8, 4, 2, 1):
        if n % m == 0 and m <= n:
            model = m
            break
    return n // model, model


def fit_mesh():
    """Largest (data, model) mesh the process group's ranks support (the
    reference's ``fit_mesh`` over its devices), over the real group."""
    return make_real_mesh(fit_mesh_shape(dist.get_world_size()), ("data", "model"))


def _join_group(device: str) -> bool:
    """Join the process group a launcher's environment describes
    (``WORLD_SIZE`` set, as ``torchrun`` sets it): ``nccl`` on
    ``cuda:{LOCAL_RANK}`` for a CUDA device, ``gloo`` otherwise. Returns
    whether this call made the group (a group that exists is used)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if torch.device(device).type == "cuda":
        resolve_device(device)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return True


def _distribute(tree, mesh, placements):
    """The leaves of ``tree`` (nested dicts, an ``OptState`` or a tensor)
    as ``DTensor``s laid out by ``placements`` (the same structure), each
    rank keeping its shard of its own copy: every rank holds the same
    values, so nothing moves between ranks."""
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree.detach(), mesh, placements, src_data_rank=None)
    if isinstance(tree, OptState):
        return OptState(*(_distribute(t, mesh, p) for t, p in zip(tree, placements)))
    return {k: _distribute(t, mesh, placements[k]) for k, t in tree.items()}


def mesh_step(step_fn, mesh, batch_placements):
    """``step_fn`` on a mesh: the batch laid out by ``batch_placements``
    (its rows over 'data'), the step under ``implicit_replication()`` as
    the dry run runs it, and the metrics read whole."""

    def run(params, opt_state, batch):
        batch = {k: distribute_tensor(v, mesh, batch_placements[k], src_data_rank=None)
                 for k, v in batch.items()}
        with implicit_replication():
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        return params, opt_state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                                   for k, v in metrics.items()}

    return run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_360m")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remat", default="none", choices=list(lm.REMAT_MODES))
    ap.add_argument("--ce-chunk", type=int, default=0)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 ('data', 'model') mesh: needs a process group of "
                    "exactly 256 ranks")
    ap.add_argument("--quant", type=int, default=0, choices=[0, 1, 2])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap


def main(argv=None, params: lm.LMParams | None = None) -> int:
    """The CLI. ``params``: the weights of ``--arch`` at ``--seed`` already
    drawn on the device (``lm.init_params``), trained in place of a fresh
    draw; None draws them."""
    args = build_parser().parse_args(argv)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    except ValueError as e:
        print(f"[train] {e}")
        return 2
    if args.quant:
        if cfg.family in PACKING_FAMILIES:
            # packed uint8 carriers are inference-only: no gradients, no moments
            print(
                f"[train] --quant {args.quant} is not trainable: "
                f"{cfg.family!r} archs pack FFN weights into inference-only "
                "uint8 carriers. Train dense (no --quant), then quantize the "
                "checkpoint for serving (launch/serve.py)."
            )
            return 2
        print(f"[train] note: --quant has no effect on family "
              f"{cfg.family!r} (no dense FFN to pack); ignoring")
    leaves = modality_batch_leaves(cfg)
    if leaves:
        print(f"[train] family {cfg.family!r} trains on batches that carry "
              f"{', '.join(map(repr, leaves))}, which this CLI's TokenPipeline does not "
              "yield (the reference's CLI fails with a KeyError at its first step); "
              "train it through runtime.steps.make_train_step on such batches")
        return 2
    made = _join_group(args.device)
    try:
        return _train(args, cfg, params)
    finally:
        if made:
            dist.destroy_process_group()


def _train(args, cfg, params) -> int:
    """The run, in or out of a process group (``main`` joins and leaves it)."""
    mesh, world = None, 1
    if dist.is_initialized():
        world = dist.get_world_size()
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if args.production_mesh and world != math.prod(PRODUCTION_MESH[0]):
        say(f"[train] --production-mesh needs a process group of "
            f"{math.prod(PRODUCTION_MESH[0])} ranks (a 16x16 ('data', 'model') mesh); "
            + (f"this one has {world}" if dist.is_initialized() else
               "there is none: launch the ranks under torchrun"))
        return 2
    if dist.is_initialized():
        mesh = make_real_mesh(*PRODUCTION_MESH) if args.production_mesh else fit_mesh()
    if mesh is not None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = resolve_device(args.device)
    if params is None:
        params = lm.init_params(cfg, args.seed, device=device, trainable=True)
    opt = AdamW(lr=args.lr)
    step_fn = make_train_step(cfg, opt, remat=args.remat, ce_chunk=args.ce_chunk)
    if mesh is None:
        params = lm.LMParams(params.tree(), trainable=True)
        opt_state = opt.init(params)
    else:
        opt_state = _distribute(opt.init(params), mesh, specs.opt_shardings(cfg, mesh, opt))
        params = lm.LMParams(_distribute(params.tree(), mesh, specs.param_shardings(cfg, mesh)),
                             trainable=True)
        shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
        step_fn = mesh_step(step_fn, mesh, specs.batch_shardings(cfg, shape, mesh))
    n_params = sum(p.numel() for p in params.parameters())
    say(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, device {device}"
        + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}" if mesh is not None else ""))
    pipeline = TokenPipeline(
        vocab=cfg.vocab, batch=args.batch, seq_len=args.seq, seed=args.seed
    )
    ckpt = CheckpointManager(args.ckpt) if args.ckpt else None
    loop = TrainLoop(
        step_fn=step_fn,
        pipeline=pipeline,
        ckpt=ckpt,
        config=TrainLoopConfig(n_steps=args.steps, ckpt_every=args.ckpt_every, log_every=10),
    )
    params, opt_state, start = loop.restore_or_init(params, opt_state)
    if start:
        say(f"[train] resumed from step {start}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = ops.launch_counts()
    params, opt_state, log = loop.run(params, opt_state, start)
    launches = {name: n - before[name] for name, n in ops.launch_counts().items()}
    if not log:
        say(f"[train] nothing to do: the checkpoint is at step {start} of {args.steps}")
        return 0

    first, last = log[0]["loss"], log[-1]["loss"]
    say(f"[train] steps {start}..{len(log)+start}: loss {first:.4f} -> {last:.4f}")
    for e in log[:: max(1, len(log) // 10)]:
        say(f"  step {e['step']:5d} loss {e['loss']:.4f} {e['time_s']*1e3:7.1f} ms")
    times = [e["time_s"] for e in log]
    steady = times[1:] or times  # the first step also builds the kernels
    tokens = args.batch * args.seq
    say("[train/kernels] " + ", ".join(f"{k} {n} launches" for k, n in launches.items()))
    say("[train/metrics] " + json.dumps({
        "arch": cfg.name,
        "device": str(device),
        "mesh": ({"shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)}
                 if mesh is not None else None),
        "world_size": world,
        "steps": len(log),
        "batch": args.batch,
        "seq": args.seq,
        "remat": args.remat,
        "tokens_per_s": tokens * len(steady) / sum(steady),
        "step_ms_median": statistics.median(times) * 1e3,
        "first_step_ms": times[0] * 1e3,
        "peak_device_mem_gib": (
            torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None
        ),
        "first_loss": first,
        "last_loss": last,
        "losses": [e["loss"] for e in log],
        **({"last_aux": log[-1]["aux"]} if cfg.family == "moe" else {}),
        "kernel_launches": launches,
    }))
    return 0 if math.isfinite(last) else 1


if __name__ == "__main__":
    raise SystemExit(main())
