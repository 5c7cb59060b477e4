#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits nonzero with no result:

1. device  -- a CUDA card must be present; its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` reports them.
2. build   -- ``nvcc`` builds every kernel from ``src/repro_torch/csrc``
              (one process per source, started together).
3. kernels -- each kernel's wrapper on the card at the serve path's shapes,
              held against its plain PyTorch version on the same inputs;
              median device times over 30 runs, L2 flushed before each,
              beside the plain version, one library call as a yardstick
              (never used by the port) and the bound from bytes and flops.
4. prefill -- smollm-360m at full width and depth with 2-bit FFN carriers:
              ``prefill_with_cache`` on a 512-token prompt in bf16 on the
              card against float32 on the CPU, same weights; then one
              paged decode step of 8 lanes profiled (host ms against the
              card's kernel ms), with 2-bit and with dense FFN weights.
5. serve   -- ``repro_torch.launch.serve.main`` at full width and depth,
              --quant 2 then --quant 0, with launch counters reset just
              before and read just after; the --quant 2 run must launch
              both kernels.

The last lines are nvidia-smi's, then ``{"kernels": [...]}``, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
REPS = 30
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers the host's enqueue
PROMPT, CHUNK, LANES, MAX_LEN = 512, 256, 8, 640

# tolerances, each with its reason
PACKED_REL_TOL = 1e-5  # both sides f32 sums of exact +-1/0 weights; only order differs
FLASH_OUT_TOL = 2e-2  # both f32 inside, each rounds its output to bf16 once (~1 ulp)
FLASH_LSE_TOL = 1e-3  # f32 log-sum-exp; summation order only
PREFILL_MIN_COS = 0.99  # bf16 activations over 32 layers vs float32
PREFILL_TOP1_SLACK = 0.1  # the card's top-1 token must be within 0.1 of the CPU max logit


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(phase_name: str, **fields) -> None:
    print(json.dumps({"phase": phase_name, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}; run it from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------- 1. device ----------------
    smi = nvidia_smi()
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---------------- 2. build ----------------
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    _build.build_all()
    phase("build", seconds=time.monotonic() - t0, dir=str(_build.BUILD_DIR))

    from repro_torch.configs import get_config
    from repro_torch.interop import params_from_reference
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import packed_matmul as pm
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import lm

    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def median_ms(fn) -> float:
        """Device time of ``fn``: median over REPS runs, each with the L2
        flushed before it, and a ~1 ms device-side sleep ahead of it so the
        card is still busy while the host enqueues ``fn`` (otherwise the
        events would time the host's launch overhead)."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(REPS):
            flush_buf.zero_()  # evict the 50 MB L2: each layer's weights arrive cold
            torch.cuda._sleep(SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)

    gen = torch.Generator(device="cpu").manual_seed(0)

    # ---------------- 3. kernels vs their plain versions ----------------
    cfg = get_config("smollm_360m")
    d, ff = cfg.d_model, cfg.d_ff
    packed_cases = []
    for bits in (1, 2):
        for k, n in ((d, ff), (ff, d)):
            w = lm.make_packed(torch.randn((k, n), generator=gen).to(dev), bits)
            w_dec = (ref.decode_weights(w["packed"], bits, k)).to(torch.bfloat16)
            for m in (LANES, CHUNK, PROMPT):
                x = torch.randn((m, k), generator=gen).to(dev, torch.bfloat16)
                got = pm.packed_matmul(x, w["packed"], w["scale"], bits, k)
                want = ref.packed_matmul_ref(x, w["packed"], w["scale"], bits, k)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / max(want.abs().max().item(), 1e-30)
                if not math.isfinite(err) or rel > PACKED_REL_TOL:
                    fail(f"packed_matmul bits={bits} M={m} K={k} N={n}: rel err {rel}")
                n_bytes = x.numel() * 2 + w["packed"].numel() + n * 4 + m * n * 4
                b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n)
                case = dict(
                    bits=bits, m=m, k=k, n=n, max_abs_err=err, rel_err=rel,
                    ms=median_ms(lambda: pm.packed_matmul(x, w["packed"], w["scale"], bits, k)),
                    plain_ms=median_ms(lambda: ref.packed_matmul_ref(x, w["packed"], w["scale"], bits, k)),
                    library_ms=median_ms(lambda: torch.matmul(x, w_dec) * w["scale"]),
                    bound_ms=b_ms, bound_by=b_by,
                )
                packed_cases.append(case)
                phase("kernel", name="packed_matmul", **case)

    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    flash_cases = []
    # (label, Sq, Sk, causal, window, q_offset): full-prompt prefill, a
    # sliding window, and the chunk-prefill shape (a 256-token chunk at
    # offset 256 over the 640 gathered pool rows)
    for label, sq, sk, causal, window, q_off in (
        ("prefill_causal", PROMPT, PROMPT, True, 0, 0),
        ("window_128", PROMPT, PROMPT, True, 128, 0),
        ("chunk_q_offset", CHUNK, MAX_LEN, True, 0, CHUNK),
    ):
        q = torch.randn((hq, sq, hd), generator=gen).to(dev, torch.bfloat16)
        kk = torch.randn((hkv, sk, hd), generator=gen).to(dev, torch.bfloat16)
        vv = torch.randn((hkv, sk, hd), generator=gen).to(dev, torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out, lse = fa.flash_fwd(q, kk, vv, **kw)
        want_o, want_lse = ref.flash_fwd_ref(q, kk, vv, **kw)
        torch.cuda.synchronize()
        err = (out.float() - want_o.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if not (err <= FLASH_OUT_TOL and lse_err <= FLASH_LSE_TOL):
            fail(f"flash_fwd {label}: out err {err}, lse err {lse_err}")
        qp = q_off + np.arange(sq)[:, None]
        kp = np.arange(sk)[None, :]
        vis = np.ones((sq, sk), bool)
        if causal:
            vis &= qp >= kp
        if window:
            vis &= qp - kp < window
        pairs = int(vis.sum()) * hq
        n_bytes = 2 * (q.numel() * 2 + kk.numel() + vv.numel()) + lse.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * hd * pairs)
        mask = torch.from_numpy(vis).to(dev)
        q4, k4, v4 = q[None], kk[None], vv[None]
        case = dict(
            case=label, sq=sq, sk=sk, heads=hq, kv_heads=hkv, d=hd, window=window,
            q_offset=q_off, max_abs_err=err, lse_err=lse_err,
            ms=median_ms(lambda: fa.flash_fwd(q, kk, vv, **kw)),
            plain_ms=median_ms(lambda: ref.flash_fwd_ref(q, kk, vv, **kw)),
            library_ms=median_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=True
                )
            ) if label != "prefill_causal" else median_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True
                )
            ),
            bound_ms=b_ms, bound_by=b_by,
        )
        flash_cases.append(case)
        phase("kernel", name="flash_fwd", **case)

    # ---------------- 4. full-width prefill, card vs CPU ----------------
    cfg2 = dataclasses.replace(cfg, w_bits=2)
    params = lm.init_params(cfg2, 0, device=dev)
    cpu_cfg = dataclasses.replace(cfg2, dtype="float32")
    cpu_params = params_from_reference(
        _to_cpu(params.tree()), cpu_cfg, device="cpu", dtype=torch.float32
    )
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, size=(1, PROMPT))
    )
    t0 = time.monotonic()
    lg_gpu, ks, _ = lm.prefill_with_cache(params, cfg2, tokens.to(dev), PROMPT - 1)
    torch.cuda.synchronize()
    gpu_s = time.monotonic() - t0
    t0 = time.monotonic()
    lg_cpu, _, _ = lm.prefill_with_cache(cpu_params, cpu_cfg, tokens, PROMPT - 1)
    cpu_s = time.monotonic() - t0
    a = lg_gpu[0, 0, : cfg.vocab].float().cpu()
    b = lg_cpu[0, 0, : cfg.vocab]
    cos = F.cosine_similarity(a, b, dim=0).item()
    top_gpu, top_cpu = int(a.argmax()), int(b.argmax())
    slack = (b.max() - b[top_gpu]).item()
    phase("prefill", tokens=PROMPT, cosine=cos, top1_card=top_gpu, top1_cpu=top_cpu,
          top1_cpu_logit_gap=slack, max_abs_logit_err=(a - b).abs().max().item(),
          card_s=gpu_s, cpu_s=cpu_s, kv_rows_finite=bool(torch.isfinite(ks).all()))
    if not (cos >= PREFILL_MIN_COS and slack <= PREFILL_TOP1_SLACK):
        fail(f"prefill card vs CPU: cosine {cos}, top-1 gap {slack}")
    del cpu_params, ks

    # ---------------- where a decode step's time goes ----------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_decode(p, c) -> dict:
        """One paged decode step of 8 lanes at depth PROMPT + 8: host wall
        time per step (synchronised) against the card's kernel time in a
        torch.profiler window, and the kernels that take it."""
        rows = LANES * MAX_LEN + 16
        pk = torch.zeros((c.n_layers, rows, hkv, hd), dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        table = (16 + torch.arange(LANES * MAX_LEN, device=dev)).reshape(LANES, MAX_LEN)
        tok = torch.zeros((LANES, 1), dtype=torch.long, device=dev)
        lens = torch.full((LANES,), PROMPT + 8, device=dev)

        def step():
            lm.decode_step_paged(p, c, tok, pk, pv, table, lens)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in kern:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 3e3
        dev_ms = sum(by_name.values())
        return dict(
            w_bits=c.w_bits, host_step_ms=wall_ms, device_step_ms=dev_ms,
            device_busy_share=dev_ms / wall_ms, kernels_per_step=len(kern) / 3,
            top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
        )

    phase("decode_profile", **profile_decode(params, cfg2))
    del params
    params0 = lm.init_params(cfg, 0, device=dev)
    phase("decode_profile", **profile_decode(params0, cfg))
    del params0

    # ---------------- 5. serve at full width and depth ----------------
    runs = {}
    ops.reset_launch_counts()
    for quant in (2, 0):
        argv = [
            "--arch", "smollm_360m", "--quant", str(quant), "--requests", "16",
            "--batch", str(LANES), "--prompt-len", str(PROMPT), "--gen-len", "64",
            "--max-len", str(MAX_LEN), "--prefill-chunk", str(CHUNK),
        ]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        text = buf.getvalue()
        sys.stderr.write(text)
        if rc != 0:
            fail(f"serve --quant {quant} exited {rc}")
        metrics = json.loads(
            next(l for l in text.splitlines() if l.startswith("[serve/metrics] "))
            .split(" ", 1)[1]
        )
        if metrics["completed"] != 16 or metrics["generated_tokens"] != 16 * 64:
            fail(f"serve --quant {quant}: {metrics}")
        runs[quant] = metrics
        phase("serve", quant=quant, **metrics)
    launches = ops.launch_counts()
    if min(runs[2]["kernel_launches"].values()) <= 0:
        fail(f"serve --quant 2 skipped a kernel: {runs[2]['kernel_launches']}")

    # ---------------- result ----------------
    head_pm = next(c for c in packed_cases if (c["bits"], c["m"], c["k"]) == (2, LANES, d))
    head_fa = flash_cases[0]
    kernels = [
        dict(name="packed_matmul", route="cuda",
             source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul.py:74",
             launches=launches["packed_matmul"],
             shape=f"bits=2 M={LANES} K={d} N={ff} bf16",
             tolerance=f"rel {PACKED_REL_TOL}",
             **{k: head_pm[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             cases=packed_cases),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:218",
             launches=launches["flash_fwd"],
             shape=f"causal Sq=Sk={PROMPT} Hq={hq} Hkv={hkv} D={hd} bf16",
             tolerance=f"out abs {FLASH_OUT_TOL}, lse abs {FLASH_LSE_TOL}",
             **{k: head_fa[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             cases=flash_cases),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    sys.exit(main())
