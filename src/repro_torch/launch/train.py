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
given; without a GPU and without ``--device cpu`` it raises. The
reference's ``--production-mesh`` is mesh code and is not ported.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
        --batch 8 --seq 512 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 3 --batch 2 --seq 32 --ckpt /tmp/ckpt

Besides the reference's ``[train]`` lines it prints each kernel's launch
count and a ``[train/metrics]`` line with the run's numbers as JSON (for
MoE also the last step's aux loss). ``main(argv, params=...)`` trains
weights the caller already holds, the ones ``lm.init_params(cfg,
--seed)`` would draw, in place of a fresh draw.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import lm
from repro_torch.models.config import PACKING_FAMILIES, modality_batch_leaves
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig


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
    device = resolve_device(args.device)
    if params is None:
        params = lm.init_params(cfg, args.seed, device=device, trainable=True)
    else:
        params = lm.LMParams(params.tree(), trainable=True)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params, device {device}")

    opt = AdamW(lr=args.lr)
    step_fn = make_train_step(cfg, opt, remat=args.remat, ce_chunk=args.ce_chunk)
    opt_state = opt.init(params)
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
        print(f"[train] resumed from step {start}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = ops.launch_counts()
    params, opt_state, log = loop.run(params, opt_state, start)
    launches = {name: n - before[name] for name, n in ops.launch_counts().items()}
    if not log:
        print(f"[train] nothing to do: the checkpoint is at step {start} of {args.steps}")
        return 0

    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"[train] steps {start}..{len(log)+start}: loss {first:.4f} -> {last:.4f}")
    for e in log[:: max(1, len(log) // 10)]:
        print(f"  step {e['step']:5d} loss {e['loss']:.4f} {e['time_s']*1e3:7.1f} ms")
    times = [e["time_s"] for e in log]
    steady = times[1:] or times  # the first step also builds the kernels
    tokens = args.batch * args.seq
    print("[train/kernels] " + ", ".join(f"{k} {n} launches" for k, n in launches.items()))
    print("[train/metrics] " + json.dumps({
        "arch": cfg.name,
        "device": str(device),
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
