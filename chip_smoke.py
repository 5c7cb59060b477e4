#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--only kernels|prefill|moe|hybrid|ssm|vlm|encdec|fleet|
                                  train_families|analysis]
                          [--src DIR] [--log FILE]

Phases, one JSON line each; any failure exits nonzero with no result:

1. device  -- a CUDA card must be present; its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` reports them.
2. build   -- ``nvcc`` builds every kernel from ``src/repro_torch/csrc``
              (one process per source, started together); beside it
              ``nvcc -Xptxas -v`` reports each kernel's registers and
              spills, and any spill fails the run.
3. kernels -- each kernel's wrapper on the card at the serve path's shapes,
              held against its plain PyTorch version on the same inputs;
              median device times over 30 runs, L2 flushed before each,
              beside the plain version, one library call as a yardstick
              (never used by the port), the bound from bytes and flops, and
              the host's enqueue time per call. ``packed_matmul`` and
              ``flash_fwd`` on both routes (bf16 on the tensor cores, f32 on
              the CUDA cores), plus ragged, split-K and no-key-row cases
              checked for agreement only (the GEMV at M 1/5/16, ragged K,
              odd N, f32 x and K of one carrier row among them; each case
              line names its K split); each row's bits independent of M
              (the mma path at 17-240 rows against its M=256 launch, the
              GEMV at 1-15 against M=16); and the timing floor: the median
              of a one-element fill. ``stream_matmul`` (one launch a call:
              split K summed in a cluster) at bits 2/1/0 at the plan's ring
              depths, M 1/8/16 at both decode shapes timed beside the GEMV
              on the same carrier, plus ragged M/N/K, f32 x, an 8-way split
              and ring-edge cases (fewer stages than the depth, as many,
              and cycling past it) checked for agreement only; each case
              line names its splits, stage length and stages, and a second
              run must give the same bits.
              ``mvau`` (tensor cores on a three-part bf16 split of x) at
              the CNV layer shapes at batch 256 (bits 1/2, L=3; conv5, fc0
              and fc1 split K in a cluster), plus ragged M/N/K, a ragged
              M < 64 split-K case, L=1/15 and +inf thresholds, each timed
              too; a second run must give the same levels.
              ``flash_bwd``'s two passes (dq, dk/dv) at the train step's
              shape (batch 8 x 512 tokens, 15/5 heads, D 64, bf16, causal;
              tensor cores), the library's yardstick the backward of
              ``scaled_dot_product_attention``; window, q_offset, ragged
              Sq/Sk, G=1, D 32/128, rows without keys, f32 (CUDA cores)
              and not-causal cases for agreement; a second run of both
              passes must give the same bits.
              ``flash_fwd`` with a device ``q_offset`` (one int32 on the
              card) at the chunk shape, starts 0, 37, 256 and 383: bitwise
              the host-int launch at the same offset, both timed; and a
              causal 208 x 208 bucket (a partial 64-row tile) against the
              plain version. Phase 5 (c)'s shapes, from a generator of
              their own: ``packed_matmul``'s mma path at M 24 and 32 (the
              verify step on 8 lanes at chains 3 and 4) and 640 (the twin
              drafter's prompt prefill) at both FFN shapes, bits 1 and 2
              (bits 2 at M 32 and 640 timed), and a causal 640 x 640
              ``flash_fwd``.
              The other dense archs' shapes: at each one's FFN shapes
              (2048x8192, 2560x6912, 5120x17920 and back; bits 2) the GEMV
              and ``stream_matmul`` at M=8 and the mma path at M=256, timed,
              and its rows independent of M at one shape per arch; the
              prefill's causal attention at llama's (32/8, D 64) and phi3's
              (40/10, D 128) heads; the MoE family's: ``stream_matmul`` at
              bits 0 with f32 x on bf16 rows (a cold expert) at olmoe's
              2048x1024 and 1024x2048, M 8 timed beside ``torch.matmul`` on
              the f32 weight, M 1 and 16 and moonshot's 2048x1408 and
              1408x2048 for agreement, and ``flash_fwd`` causal 512 and the
              chunk at olmoe's 16/16 heads, D 128, timed; the twin's 640 x
              640 prefill and the mma path at M 24 are timed too; the vlm
              and enc-dec families': ``packed_matmul`` at 2 bits at
              internvl2-76b's 8192x28672 and 28672x8192 (the GEMV at M 8,
              the mma path at M 256) and whisper-tiny's 384x1536 and
              1536x384 (the GEMV at M 8, the mma path at M 12000: 8 lanes
              x 1500 frames), each timed with its planned split, and each
              row's bits independent of M at those shapes (whisper's also
              against the head of a 12000-row launch); ``flash_fwd`` not
              causal at whisper's encoder (48 lanes x heads, 1500 x 1500,
              D 64) and cross-attention (64 tokens over 1500 frames), both
              timed, the encoder also on the f32 route and a ragged cross
              case checked; causal at internvl's 64/8 heads (G 8), D 128:
              the 512-token prefill and the chunk, timed; head dim
              80 (h2o-danube's 32/8 heads) on
              both routes: causal 512, the chunk, the 4096 window at a chunk
              past it (Sq 256 over Sk 4352 at q_offset 4096), ragged cases,
              a device q_offset bitwise the host int, and both backward
              passes at the gradient check's shape (timed) and ragged.
              The train_families phase's ``flash_bwd`` shapes (both passes,
              timed, batch 2): head dim 128 causal at olmoe's 16/16 and
              internvl's 64/8 heads (256 tokens), and not causal at
              whisper's 6/6 heads, D 64: the encoder (1500 x 1500) and the
              cross-attention (256 tokens over 1500 frames).
              Each serve-path kernel (the GEMV, ``packed_matmul``'s and
              ``flash_fwd``'s ``mma`` routes, ``stream_kernel``) at a
              serve shape compiled into a CUDA graph
              (``runtime.steps.CapturedStep``): the replay must be bitwise
              the eager launch and count one launch by its route; and a
              fault inside a capture (a launch refused by its launch
              function) must raise and leave nothing captured.
4. prefill -- smollm-360m at full width and depth with 2-bit FFN carriers:
              ``prefill_with_cache`` on a 512-token prompt in bf16 on the
              card against float32 on the CPU, same weights; the serve
              path's second 256-token prefill chunk profiled (host ms
              against the card's, split into flash_fwd, packed_matmul and
              the rest), eager and compiled (a captured CUDA graph) in
              turns; then one
              paged decode step of 8 lanes profiled (host ms against the
              card's kernel ms, the GEMV's and stream_matmul's shares),
              with 2-bit and with dense FFN weights, and at 2 bits under a
              half-budget residency plan, each eager and compiled (the
              2-bit steps twice, in turns), whose logits are held against
              the unbudgeted step's. The compiled chunk's and decode
              steps' replays are held against the eager step on copies of
              the same pool state: logits and pools bitwise equal; the
              chunk graph, captured at start 256, also replayed at starts
              37 and 383 (one graph serves every start), each held against
              the eager step at that start. The whole-prompt prefill of a
              bucket (16: the GEMV route; 208: a partial flash tile) as a
              graph, bitwise its eager step in logits, K/V rows and the
              pools they are written to; a 208-token bucket profiled eager
              and compiled in turns.
5. serve   -- ``repro_torch.launch.serve.main`` at full width and depth,
              --quant 2 then --quant 0, each unbudgeted and then with
              ``--vmem-budget`` at half the plan's tile bytes, with launch
              counters reset just before each run and read just after;
              with the prefix cache on, as ``serve`` has it by default;
              every decode step and prefill chunk runs as a CUDA graph (2
              graphs a run: the decode step and one chunk graph for every
              start; every step but each graph's first is a replay). The
              --quant 2 runs
              also run with every step eager (``Scheduler(compiled=False)``
              through ``run_pool_engine``), in turns: the 16 greedy token
              streams and the launch counts must be identical, and the
              unbudgeted pair runs with --trace-out, whose spans must tile
              every request, whose ledger must integrate to every round's
              gauges (``validate_trace``, ``validate_ledger``) and whose
              per-request queue / prefill / decode ms are printed; the
              --quant 2 run must launch packed_matmul and flash_fwd (by
              route: prefill through packed_matmul's and flash_fwd's
              tensor-core kernels, decode through the GEMV, never an f32
              route), each budgeted run stream_matmul exactly 3 x streamed
              layers x decode steps (one launch a call), each unbudgeted
              run never. Then (a) 16 short prompts (36-240 tokens, four
              16-token buckets), 32 generated each, 8 lanes, --quant 2,
              through serve's engine, eager and compiled in turns: the
              tokens and launch counts identical, one graph per bucket,
              each whole-prompt prefill's host ms; and (b) the reference's
              multi-turn shared-prefix traffic (4 sessions x 4 turns of 96
              new tokens, a sibling 3 tokens short of each turn prompt; 32
              generated, 8 lanes, --prefill-chunk 256, --quant 2, compiled)
              with the cache and without: identical tokens and every
              sampled position's logits row bitwise equal, a prompt's K
              rows the same bits from a prefill of its first half and of
              all of it, and each op of that prefill (RMSNorm, the four
              projections, flash_fwd as a bucket and as a chunk at a
              device q_offset, the three packed FFN matmuls) giving a
              row the same bits at half the rows and padded to the chunk;
              shared blocks at peak > 0, exactly one chunk
              graph, and prefill tokens cut by at least 30%; a third,
              cached run with a planted fault (the copy-on-write copy
              skipped) must be seen to differ; and a follow-up turn: the
              first wave's 8 requests, then each one's prompt + output +
              96 fresh tokens, without the cache and with it
              teacher-forced by the uncached run's tokens (the follow-ups
              adopt the K/V rows decode wrote: the GEMV's, where a cold
              prefill runs the mma path): the logits at every sampled
              position within FOLLOWUP_LOGIT_STEPS bf16 steps, the argmax
              the same at FOLLOWUP_MIN_ARGMAX. Then (c) speculative
              decoding on the serve cell's traffic (--spec-depth 4), on the
              --quant 2 target and on a dequantized one (seed 0's FFN
              leaves decoded from their 2-bit carriers,
              ``dequantize_ffn_params``, whose twin packs them again
              losslessly): (i) on serve's engine (n-gram drafter,
              compiled), its lanes prefilled with 8 random 640-token
              prompts, one verify step of 4 tokens on 8 lanes against the
              same tokens fed through 4 decode steps, on copies of one
              pool state; a gate holds the verify path's logits to plain
              decode's: the largest |logit difference| and top-1 / top-2
              gap shift within SPEC_LOGIT_STEPS bf16 steps at the largest
              |logit|, the argmax the same at SPEC_MIN_ARGMAX_SHARE of the
              positions; a planted fault (every start one too far) must
              fail the same gate; the scheduler's own verify graph
              (``_run_verify``) at each chain length 1-4 (1 and 4
              dequantized), each replay bitwise the eager step in logits
              and pools, and profiled (card ms); the twin drafter as serve
              builds it (``build_speculator``), its steps as graphs,
              against an eager drafter on the same weights: ``start_lane``
              (the 640-token prompt prefill's graph) and ``propose`` (the
              decode graph), the graphs' outputs, the proposals and both
              drafters' buffers bitwise, both graphs profiled; (ii) plain
              compiled decode of the cell, every sampled logits row kept,
              then the same streams teacher-forced through speculative
              serving (a drafter proposing plain decode's tokens, taken in
              place of each sample), through the same gate; (iii) the
              n-gram drafter through ``serve.main`` at --quant 2, eager
              and compiled in turns, each with --trace-out (spans and
              ledger validated); (iv) the twin (--speculate smollm_360m
              --spec-quant 2) on the dequantized target through
              ``run_pool_engine``, eager and compiled. For each drafter:
              compiled and eager identical in tokens and launches by route;
              launches exactly flash_fwd 32 x (prefill chunks + drafter
              prefills) on its tensor-core route, packed_matmul 96 x
              (verify steps of <= 16 rows at --quant 2 + drafter decode
              steps) on the GEMV and 96 x (chunks and the longer verify
              steps at --quant 2 + drafter prefills) on the mma path, no
              other kernel; one graph per verify chain length, the
              drafter's two, every other call a replay; the streams equal
              to plain compiled decode's counted, and every stream that
              parts does so where plain decode's top-1 / top-2 gap lies
              within (ii)'s largest shift of that gap. Then the
              fixed-batch engine (``serve --engine fixed``) at --quant 2 on
              the same weights: its decode step (8 lanes over a static
              per-slot cache) captured, FIXED_REPLAYS replays in a row each
              bitwise the eager step, logits and every cache leaf (``len``
              included); its cell (8 x (128 + 64) tokens, 8 lanes) through
              ``run_fixed_engine`` eager and compiled: identical tokens and
              launches by route, exactly 3 x layers x steps launches of
              ``packed_matmul``, all on the GEMV (M = 8), no other kernel,
              one graph, every step but its first call a replay. Then (d)
              the fleet (``runtime.cluster``) on phase 5's weights: one
              trace (FLEET_REQUESTS = 24 requests, prompts 128 / 512 /
              1024, 64 / 128 generated, 2000 arrivals a virtual second,
              seed 1), 8 lanes
              an engine, the prefix cache on, greedy, compiled, the cost
              model the H100 data sheet's, in ``benchmarks/fleet_bench.py``'s
              four modes: single (1 engine), fleet2 (2), disagg_gals (4,
              split by ``provision_split``) and disagg_naive (4, split
              2:2, prefill engine 0 drained at the median arrival): every
              stream identical to single's with its max_new_tokens,
              ``validate()`` on every pool, a handoff a request in each
              disagg run, no decode graph on a prefill engine and no prefill graph
              on a decode engine, prefill on the tensor-core kernels and
              decode on the GEMV (no f32 route, no stream_matmul); each
              handoff's payload MiB, ``export_blocks`` ms and import ms
              (CUDA events); on the trace's first 8 requests at 8 tokens
              each (the eager step takes ~55 ms on the host), single
              against disagg_gals under seeded sampling identical, and
              disagg_gals eager against compiled identical in tokens and
              launches by route; then
              ``repro_torch.launch.fleet.main`` (disagg, 4 engines, 2 bits,
              8 slots, its own trace and draw) returning 0, its stream
              passing ``validate_trace`` and ``validate_ledger`` and
              replaying to each engine's counters. Measured: wall s,
              tokens/s, graphs, capture s, KV and graph pool MiB per
              engine, the decode step's host ms; modelled (the virtual
              clock): the SLO report, the split, and the cost model's
              decode step beside the measured one.
analysis   -- (after phase 7, on phase 5's weights; ``--only analysis`` runs it alone
              after the build, with no measured serve cell beside the
              model) where a model fits and what bounds a step, each
              number beside the card's name and power limit: (a)
              ``launch.port.lm_port_rows`` over ``GPU_TIERS`` (data-sheet
              arithmetic, no device) for smollm-360m, phi3-medium-14b and
              internvl2-76b at --quant 2 and 0 (each rung's fits_hbm,
              modelled tokens/s, packed against dense), and the h100_sxm
              rung's modelled tokens/s for smollm-360m beside phase 5's
              measured compiled tokens/s at the same traffic (8 lanes, 512
              + 64), recorded, not gated; (b) the op walk
              (``perf.op_analysis``) of three eager steps of smollm-360m at
              full size: the pool's decode step (8 lanes, depth 520) and a
              256-token prefill chunk at 2 bits, and a train step (8 x 512,
              --remat none) on dense weights (a packed carrier has no
              gradient); each step's card ms (CUDA-event median of 20:
              the captured replay for the decode step and the chunk, the
              eager step for training), its dot flops, bytes, model flops,
              the useful-compute share model_flops / (card_s * 989 TFLOP/s)
              and the bytes share traffic_bytes / (card_s * 3.35 TB/s), its
              roofline (``perf.roofline``) and the walk's top 5 ops by
              bytes. Gates: every share in (0, 1.05] (above, the count is
              wrong); the walk's kernel launches equal the launch counters'
              over the same step; the train walk's dot flops at least 0.9
              x its model flops (the backward is counted); (c)
              ``dist.sharding``: every full-size arch's ``param_specs`` on
              16x16 and 2x16x16 mesh views validated leaf by leaf, and
              ``sharded_byte_fraction`` printed.
4-5 (the other dense archs: llama3.2-1b, h2o-danube-1.8b, phi3-medium-14b;
              run last, after phase 7), each in turn, with
              2-bit FFN carriers unless named: the
              512-token prefill at full width and depth 2 (2 of 16 / 24 / 40
              layers, so the CPU's float32 side stays in seconds) in bf16 on
              the card against float32 on the CPU; for h2o-danube a
              depth-1 run (WINDOW_LAYERS) past its 4096-token window (a 4352-token prompt in
              256-token chunks, then 16 greedy decode steps), every chunk's
              and step's logits against the CPU's, and the CPU without the
              window beside it; ``init_params`` at full width and depth
              (phi3: 16 of its 40 layers, SERVED_LAYERS, to fit the run's
              time limit) (seconds, host memory, device MiB); its decode step and
              prefill chunk captured, each replay bitwise its eager step;
              a compiled decode step and prefill chunk profiled (card ms);
              the serve cell (16 x (512 + 64), 8 lanes, --prefill-chunk 256,
              --max-len 640, the prefix cache on) at --quant 2 on those
              weights, eagerly and compiled in turns (identical tokens and
              launches by route: prefill on the tensor-core kernels, decode
              on the GEMV, never an f32 route or stream_matmul), and at
              --quant 0 compiled through ``serve.main`` (its own weights).
moe        -- (after 4-5; ``--only moe`` runs it alone after the build)
              olmoe-1b-7b at full width and 4 of its 16 layers (MOE_LAYERS;
              16 until the train_families phase needed the time, then 12,
              8 until a slow host's run overran the limit; 64
              experts top-8, the dropless dispatch, every expert over every
              row in f32):
              (a) a 512-token prefill at 2 of its 16 layers, layer by
              layer, each layer fed the CPU's float32 input: the (token,
              layer) expert sets the card (bf16 hidden state) changes only
              at a near-tie (the CPU's k-th and (k+1)-th router
              probabilities within MOE_FLIP_GAP), the FFN output on the
              tokens whose set agrees within MOE_FFN_REL_TOL, each layer's
              tally within 2k per changed set; the card's FFN on the
              CPU's own f32 hidden state within MOE_FFN_F32_REL_TOL (TF32
              and bf16 expert products, printed beside, must read above
              it); the end-to-end logits printed, not gated; (b) ``init_params`` at 4 layers
              (seconds, host memory, device MiB); (c) the decode step, a
              chunk (at starts 256 and 37), a 208-token bucket and a
              verify step of 4 on 8 lanes, each captured and its replay
              bitwise its eager step, the (L, E) tally included; the
              compiled decode step and chunk profiled (card ms by kind: the
              f32 GEMMs, the experts' f32 casts, the rest), and the
              compiled verify step timed unpadded and with its products in
              256-row calls; (d) the serve
              cell (16 x (512 + 64), 8 lanes, --prefill-chunk 256,
              --max-len 640, the prefix cache on) through serve's engine,
              eager and compiled: identical tokens and launches by route,
              flash_fwd 12 a chunk on its tensor-core route, no
              packed_matmul, no stream_matmul, the MoE gauges; the
              compiled run under the process's own f32 matmul settings
              (TF32 off: PyTorch's default, and no file of the port sets
              it); (e) the cell at half the plan's expert tile bytes:
              stream_matmul exactly 3 x streamed experts x decode steps;
              teacher-forced with (d)'s tokens, the logits within
              MOE_BUDGET_LOGIT_STEPS bf16 steps and the argmax the same at
              SPEC_MIN_ARGMAX_SHARE; run free, each stream that parts does
              so at a near-tie; (f) phase 5 (b)'s shared-prefix traffic
              with and without the cache: identical tokens and every
              sampled logits row bitwise, a prompt's K rows the same bits
              from half and all of it at every layer, and the router's and
              the experts' f32 products (256-row calls) giving a row the
              same bits at half the rows and padded to the chunk; a
              16-token prompt (a 16-row bucket) and one that extends it,
              cached and uncached bitwise, the block's K rows and a 16-row
              call's products the longer prefill's bits; (g) the
              n-gram drafter at --spec-depth 4 on 8 of the cell's prompts,
              eager and compiled identical in tokens and launches, parting
              from plain decode only at near-ties, and phase 5 (c)'s gate (a
              verify step against 4 decode steps on a prefilled pool: 4
              bf16 steps, 85% argmax); (h) moonshot-v1-16b-a3b at 2 of
              its 48 layers (a full draw takes ~200 s on the host; 8 until
              the hybrid phase needed the time, 4 until the train_families
              phase did): (a), (f)'s 16-token prompt check, its 9216-block
              residency plan timed, and the compiled serve cell once; (i)
              (run before (h)) olmoe on the fixed-batch engine, its decode
              step the capacity dispatch over groups of one token: the step
              captured, FIXED_REPLAYS replays bitwise eager, every cache
              leaf included, and one wave of the fixed cell (8 x (32 +
              32): MOE_FIXED) eager and compiled, identical tokens and
              launches (none).
hybrid     -- (after the MoE phase; ``--only hybrid`` runs it alone after the
              build) zamba2-2.7b at full width and depth (54 Mamba2 layers,
              one shared attention + FFN block after every 6): (a)
              ``init_params`` once, dense (seconds, host memory, device
              MiB), the 2-bit copy packing its shared FFN from that draw
              (``pack_ffn_params``); (b) one super-block (6 SSM layers and
              the shared block) at full width in bf16 on the card against
              float32 on the CPU, same weights: a 256-token whole-prompt
              prefill, the next 256 tokens as a suffix resumed from the
              carried lane state at a device start, then 4 greedy decode
              steps; the logits (``logits_vs_cpu``), the K/V rows (within
              HYB_KV_REL_TOL) and the lane state leaf by leaf after each
              stage (within HYB_LANE_REL_TOL, cosine >= HYB_LANE_MIN_COS);
              (c) ``packed_matmul`` at 2 and 1 bits at 2560x10240 and
              10240x2560 (the GEMV at M 8, the mma path at M 256 and 93)
              and ``flash_fwd`` at 32/32 heads, D 80 (causal 512, the chunk
              256 over 512 at 256, a ragged 93-token prompt; a device
              q_offset bitwise the host int), each against its plain
              version and timed beside the library call and the bound;
              (d) the decode step (8 lanes) and the full-width suffix
              chunk captured, each replay bitwise its eager step in
              logits, pools and every lane-state leaf (the chunk at starts
              256 and 37), each profiled (card ms, busy share, kernels)
              with the Mamba2 blocks' share (a graph of them alone against
              the step's), and a prime 257-token prompt (SSD chunks of one
              token) timed beside a 256-token one; (e) the serve cell
              (16 x (512 + 64), 8 lanes, --prefill-chunk 256, --max-len
              640, the prefix cache on) compiled at --quant 2 and 0, and at
              --quant 2 eager and compiled at 8 of its 16 requests (a cut
              of the eager run, to fit the time limit): identical tokens
              and launches by route (flash_fwd 9 a chunk on its
              tensor-core route, packed_matmul 27 a step, chunks on the
              mma path and decode on the GEMV; the decode and chunk
              graphs, every other step a replay); (f) phase 5 (b)'s
              shared-prefix traffic at --quant 2, compiled: without the
              cache, with it teacher-forced by the uncached run's tokens,
              without it over the cached run's partition (--prefill-chunk
              96, forced the same), and for two turns with every anchor's
              lane state zeroed (a planted control); prefill tokens, hit
              rate, TTFT, the anchors' host copies (ms, MB) and host
              memory; the gate: the cached logits within
              HYB_WARM_LOGIT_STEPS bf16 steps of the uncached run's, the
              argmax the same at HYB_WARM_MIN_ARGMAX of the positions (an
              anchor's state was summed over another chunk partition), and
              bitwise those of the uncached run over the cached run's own
              partition; the planted control failing that gate, every
              position of a request that hit no anchor bitwise, and the
              prefill tokens cut by at least PREFIX_MIN_CUT.
ssm        -- (after the hybrid phase; ``--only ssm`` runs it alone after the
              build) mamba2-1.3b at full width and depth (48 Mamba2 layers,
              d_model 2048, 64 SSM heads, state 128) through the
              fixed-batch engine: (a) ``init_params`` (seconds, host
              memory, device MiB); (b) its first SSM_CPU_LAYERS layers at
              full width in bf16 on the card against float32 on the CPU,
              same weights: 256 positions on 2 lanes through
              ``decode_step``, every position's logits (``logits_vs_cpu``'s
              gates), and along the positions the SSD state and the conv
              buffers leaf by leaf (within SSM_STATE_REL_TOL, cosine >=
              SSM_STATE_MIN_COS), their error not growing (SSM_GROWTH);
              (c) the decode step (8 lanes) captured, FIXED_REPLAYS replays
              in a row each bitwise the eager step, every cache leaf and
              ``len`` included; (d) a 512-token prompt replayed through the
              compiled decode step and teacher-forced against
              ``lm.prefill`` (the SSD in chunks): the largest logit gap in
              bf16 steps and the argmax share, in bf16 (within
              SSM_PREFILL_LOGIT_STEPS, at least SSM_PREFILL_MIN_ARGMAX) and
              on the same weights in float32 (within SSM_F32_LOGIT_STEPS,
              at least SSM_F32_MIN_ARGMAX); (e) the fixed-engine cell (8 x
              (128 + 64), 8 lanes) eager and compiled: identical tokens and
              launches by route (none of the six kernels), one graph,
              every step but its first call a replay; tokens/s, mean TTFT,
              decode step ms (mean and replay), capture s and the graph
              pool's MiB; (f) one decode step profiled eager and compiled
              (card ms, busy share, kernels). They run in the order a, b,
              c, f, e, d.
6. cnn     -- the paper's CNV at full width (w1a2, then w2a2), random
              weights with randomised BN statistics and 256 random images
              from a seed: ``cnn_forward_streamlined`` on the card against
              the float32 plain path on the CPU, layer by layer (each layer
              fed the CPU's input; levels equal but for ties) and end to
              end (argmax agreement); images/s at batch 256 and 1, the
              card's time per layer split into mvau / im2col / the rest
              (torch.profiler) with ``mvau``'s share of the card, and
              exactly 7 ``mvau`` launches a forward. Run right after phase
              3, before phase 4: run after phases 4-5 (or 4-5 and the
              other dense archs), its profiler windows lost kernel
              records, an ``mvau``'s among them, in six full runs.
7. train   -- smollm-360m: first a gradient check at full width and depth
              4 (batch 2 x 256), ``loss_fn`` and its backward in bf16 on the
              card against float32 on the CPU, same weights (loss within
              2e-2, each leaf's gradient cosine >= 0.99), and with
              ``remat`` full and dots on the card against none; then
              ``repro_torch.launch.train.main`` at full width and depth,
              batch 8 x 512, 20 steps, then 5 with ``--remat full``, launch
              counters reset just before each run and read just after
              (``flash_bwd_dq`` and ``flash_bwd_dkv`` 32 x steps each,
              ``flash_fwd`` 32 or 64 x steps, all three on their
              tensor-core routes, the loss finite and falling);
              one train step under torch.profiler (host ms against the
              card's kernel ms, the largest kernels, flash's share); a
              checkpoint of the trained state saved and restored into
              fresh modules on the card, bit for bit. Last, h2o-danube's
              gradient check at full width and depth 2 (head dim 80: both
              ``flash_bwd`` passes on their tensor-core kernels).

vlm        -- (after the SSM phase; ``--only vlm`` runs it alone after the
              build) internvl2-76b at full width (d_model 8192, 64/8 heads,
              D 128, d_ff 28672, vocab 128256) and SERVED_LAYERS (4) of its
              80 layers, 2-bit FFN carriers: (a) ``init_params``
              (seconds, host memory, device MiB) and the whole backbone's
              bytes at bf16 / 2 / 1 bits (arithmetic); (b) its first
              VLM_CPU_LAYERS layers in bf16 on the card against float32 on
              the CPU, same weights: the 512-token prefill
              (``prefill_vs_cpu``) and ``make_prefill_step`` with 256
              seeded patch embeddings ahead of 64 tokens
              (``logits_vs_cpu``; the card closer to the CPU than a
              text-only prefill is); the pool's decode step and chunk
              captured, each replay bitwise its eager step; (e) a decode
              step profiled eager and compiled and a compiled chunk (card
              ms, busy share, kernels); (c) the serve cell (16 x (512 +
              64), 8 lanes, --prefill-chunk 256, --max-len 640, the prefix
              cache on) at --quant 2 compiled, then at 8 requests eager and
              compiled: identical tokens and launches by route; (d) the
              fixed engine: its decode graph's FIXED_REPLAYS replays
              bitwise eager, every cache leaf included, and its cell (8 x
              (128 + 64)) eager and compiled, every FFN matmul on the GEMV.
encdec     -- (last; ``--only encdec`` runs it alone after the build)
              whisper-tiny at full size (4 + 4 layers, d 384, 6/6 heads,
              1500 frames): (a) ``init_params`` at --quant 0 (the host
              draw) and 2 (drawn on the card): the 2-bit leaves, the
              encoder's included, bitwise the dense draw packed; (b) 8
              seeded frame sets (8, 1500, 384) in bf16 on the card against
              float32 on the CPU: the encoder's states (each lane's cosine
              >= PREFILL_MIN_COS), each lane's prefill logits over 32
              decoder tokens (``make_prefill_step``) and 32 decode steps
              teacher-forced with the card's greedy tokens
              (``logits_vs_cpu``); (c) the decode step
              (``make_serve_step``) as one ``CapturedStep`` over the whole
              cache: FIXED_REPLAYS replays bitwise the eager step, every
              leaf (``cross_k``, ``cross_v``, ``k``, ``v``, ``len``)
              included; (d) greedy decoding of 64 tokens on 8 lanes, eager
              and compiled: identical tokens and launches by route
              (``flash_fwd`` 4 not-causal launches in the encoder,
              ``packed_matmul`` 12 on the mma path there and 12 a step on
              the GEMV), tokens/s, step ms (mean and replay), and a decode
              step's card ms and kernels.
train_families -- (last; ``--only train_families`` runs it alone after the
              build, drawing its weights) training the MoE, hybrid, SSM,
              vlm and enc-dec families on the card, on the dense weights
              their phases drew (olmoe's first 8 layers, copied; internvl's
              first layer, its FFN the 2-bit carriers' decoded values):
              (a) gradients at full width, ``make_loss_fn`` and its backward
              in bf16 on the card against float32 on the CPU, same weights
              and batch (2 x 256 tokens; internvl's 256 seeded patch
              embeddings ahead of them, whisper's 1500 seeded frames): the
              loss within GRAD_LOSS_RTOL, each leaf's cosine >=
              GRAD_MIN_COS, the flash kernels one launch a pass per
              attention layer on the tensor cores, the not-causal ones
              counted (whisper at full size; mamba2 and olmoe at 2 layers,
              zamba2 at one super-block, internvl at 1 layer); olmoe's
              ``moe_ffn`` output, aux and gradients the same bits in two
              runs; (b) zamba2-2.7b at full size through
              ``repro_torch.launch.train.main`` (8 x 512, --remat full, 4
              steps at lr 3e-4; the shared block is not recomputed):
              ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` 9 x
              steps each, all mma, the loss finite and falling, step ms,
              tokens/s and peak device GiB; (c) ``make_train_step``, 4 steps
              each at lr 3e-4: whisper-tiny at full size (8 x 256; the not-causal
              backward on the main path, 8 of its 12 attention layers a
              step), mamba2-1.3b at full size (4 x 512, --remat full) and
              olmoe-1b-7b at 4 of its 16 layers (4 x 512; its aux loss a
              step): the loss finite and falling, launches exact by route.

The MoE, hybrid, SSM, vlm and enc-dec phases hand their dense weights on to
the train_families phase (a full run only), so it draws none.

A ``seconds`` line follows each phase (and each new arch), with the host's
resident memory and its peak over the phase. From phase 4 on, the later
phases' weights are drawn ahead on a host thread while the card runs the
phase before theirs (``lm.init_params(c, 0, device="cpu")``, bitwise the
card's draw; the thread makes no CUDA call, so the graphs captured
meanwhile stay valid), and a dense arch's 2-bit copy is packed from that
draw on another host thread as soon as the draw is done; each ``init``
line says what the host threads took and what the run waited for.

The last lines are nvidia-smi's, then ``{"kernels": [...]}``, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
F32_FLOPS = 67e12  # float32 outside the tensor cores, NVIDIA data sheet
REPS = 30
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clock: covers the host's enqueue
PROMPT, CHUNK, LANES, MAX_LEN = 512, 256, 8, 640
BUCKET = 208  # a whole-prompt bucket whose length is no multiple of flash's 64-row tile
# phase 5 (a): short prompts in four 16-token buckets (48, 112, 160, 240)
SHORT_LENS = ((48, 40, 45, 36), (100, 97, 110, 112), (150, 155, 160, 145), (240, 230, 225, 236))
SHORT_GEN, SHORT_MAX_LEN = 32, 272
# phase 5 (b): the reference's prefix bench traffic at full width
SESSIONS, TURNS, TURN_TOKENS, SESSION_GEN, SESSION_MAX_LEN = 4, 4, 96, 32, 416
# (b)'s follow-up turn, teacher-forced cached against uncached: the
# verify-against-decode gate's values (SPEC_LOGIT_STEPS, SPEC_MIN_ARGMAX_SHARE)
FOLLOWUP_LOGIT_STEPS = 4
FOLLOWUP_MIN_ARGMAX = 0.85
# (d) the fleet's trace (benchmarks/fleet_bench.py's four modes at the
# serve cell's lengths; 24 requests, not 32, and the seeded and the eager
# pairs on its first 8 at 8 tokens each, to fit the run's time limit: an
# eager decode step takes ~55 ms on the host) and launch/fleet.py's SLOs
# (virtual seconds)
FLEET_REQUESTS = 24
FLEET_CHECK_REQUESTS, FLEET_CHECK_GEN = 8, 8
FLEET_PROMPT_LENS = ((128, 0.5), (512, 0.35), (1024, 0.15))
FLEET_GEN_LENS = ((64, 0.7), (128, 0.3))
FLEET_SLO_TTFT, FLEET_SLO_TPOT = 0.03, 0.002
SPEC_DEPTH = 4  # phase 5 (c): --spec-depth, the serve cell's
# phase 5 (c)'s gate on the verify path's logits against plain decode's
# (which run other kernels, summing in other orders): the largest |logit
# difference| and top-1 / top-2 gap shift within this many bf16 steps at
# the largest |logit|, and the argmax the same at this share of positions
SPEC_LOGIT_STEPS = 4
SPEC_MIN_ARGMAX_SHARE = 0.85
PREFIX_MIN_CUT = 0.30  # the reference's prefix_bench floor on the prefill-token cut
TOP_LOGITS = 8  # logits kept per sampled position, to read a gap where streams part
# the mma path's row counts held against its M=256 launch, row by row: the
# short buckets, the trace's prompts and the chunk's partial tails
INVARIANT_MS = (17, 48, 96, 112, 160, 192, 208, 240)

# tolerances, each with its reason
PACKED_REL_TOL = 1e-5  # both sides f32 sums of exact +-1/0 weights; only order differs
# the bf16 kernel rounds P to bf16 before PV, as the reference's kernel
# does (p.astype(v.dtype)), where the plain version keeps P in f32; each
# side rounds its output to bf16 once (~1 ulp)
FLASH_OUT_TOL = 2e-2
FLASH_LSE_TOL = 1e-3  # f32 log-sum-exp; summation order only
PREFILL_MIN_COS = 0.99  # bf16 activations over 32 layers vs float32
PREFILL_TOP1_SLACK = 0.1  # the card's top-1 token must be within 0.1 of the CPU max logit
STREAM_REL_TOL = 1e-5  # both sides f32 sums of exact values (bf16 x and rows, +-1/0 codes); only order differs
BUDGET_MIN_COS = 0.999  # the two FFN kernels round bf16 activations in other orders over 32 layers
BUDGET_TOP1_SLACK = 0.1  # the budgeted top-1 token must be within 0.1 of the unbudgeted max logit
# mvau: both sides sum the same f32 products (exact +-1/0 weights) in other
# orders, so a level may differ only where the plain version's sign*acc
# lies within this of a threshold (relative to 1 + |T|)
MVAU_TIE_TOL = 1e-5
CNN_BATCH, CNN_RUNS, CNN_PROFILED = 256, 20, 3
CNN_MIN_ARGMAX = 0.99  # card vs CPU logits: argmax agreement over the 256 images
CNN_LOGIT_TOL = 1e-4  # fc2 (a plain f32 conv, TF32 off) card vs CPU, relative to 1 + max|logit|
CNN_MVAU_PER_FORWARD = 7  # conv1-5, fc0, fc1: every 1/2-bit layer of CNV
# flash_bwd against its plain version in f32 on the same inputs, relative to
# the largest |value| of each output: bf16 outputs round once, which moves
# an element by up to 2^-8 of itself; f32 only sums in another order
FLASH_BWD_TOL = 5e-3
FLASH_BWD_TOL_F32 = 1e-5
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, REMAT_STEPS = 8, 512, 20, 5
GRAD_DEPTH, GRAD_BATCH, GRAD_SEQ = 4, 2, 256
GRAD_LOSS_RTOL = 2e-2  # bf16 weights and activations on the card vs float32 on the CPU
GRAD_MIN_COS = 0.99  # the same, per gradient leaf
REMAT_MIN_COS = 0.9999  # --remat full/dots vs none on the card: atomics order only
# the other dense archs, each served at full width and depth (phases 4-5)
NEW_ARCHS = ("llama3p2_1b", "h2o_danube_1p8b", "phi3_medium_14b")
# ... but phi3, served at 16 of its 40 layers (32 from the hybrid phase on,
# until a slow host's whole run overran its limit; with all 40 the run had
# ended 63.3 s short of it on the H100: its draw and packing, ~210 s at 40
# layers, are the run's longest host work);
# and internvl2-76b (the vlm phase) at 4 of its 80 layers at full width: its
# whole backbone is ~141 GB in bf16 and ~42 GB with 2-bit FFN carriers, which
# one 80 GB card holds, but its draw alone would take ~500 s on the host
SERVED_LAYERS = {"phi3_medium_14b": 16, "internvl2_76b": 4}
WINDOW_STEPS = 16  # decode steps of h2o-danube's run past its window
# layers of that run, 1 (2 before the train_families phase came): its
# float32 CPU side over the 4352-token prompt, windowed and not, took 52.3
# of the danube phase's 74.4 s at 2 layers on the H100's host; the gate
# (the card past the window 0.053 from the windowed CPU, the window moving
# the CPU's logits 1.03) had a 20x margin
WINDOW_LAYERS = 1
# the MoE phase: olmoe at full width and MOE_LAYERS of its 16 layers (all
# 16 until the train_families phase came, then 12, then 8: the run's time
# limit, which slow hosts' runs at 12 and at 8 overran), moonshot
# cut to MOON_LAYERS of its 48
# layers (its full draw would take ~200 s on the host; 8 until the hybrid
# phase came, 4 until the train_families phase: each cut makes room within
# the run's time limit); each prefill check at MOE_CHECK_LAYERS layers, so
# the CPU's float32 experts stay in seconds
MOE_ARCH, MOE_LAYERS, MOON_ARCH, MOON_LAYERS, MOE_CHECK_LAYERS = (
    "olmoe_1b_7b", 4, "moonshot_v1_16b_a3b", 2, 2)
MOE_SPEC_REQUESTS, MOE_SPEC_GEN = 8, 32  # (g): one wave of the cell's prompts
# (i): the fixed-engine wave's prompt and generated tokens (its eager run at
# the fixed cell's 128 + 64 took 11.3 s on the H100's host)
MOE_FIXED = (32, 32)
SHORT_PREFIX_GEN = 8  # (f): tokens generated per request of the short-prefix check
# routing on the card (bf16 hidden state) against the CPU (f32), each layer
# fed the CPU's input: a token may take another expert set only where its
# k-th and (k+1)-th router probabilities (CPU) lie within MOE_FLIP_GAP; on
# the tokens whose set agrees, the FFN output within MOE_FFN_REL_TOL of the
# largest |CPU output| (bf16 attention and hidden state against f32)
MOE_FLIP_GAP = 2e-3  # ~3x the largest gap at a change measured on the H100 (7.0e-4)
MOE_FFN_REL_TOL = 2e-2  # 2x the largest error measured there (9.7e-3)
# the card's FFN on the CPU's own f32 hidden state against the CPU's: only
# the f32 sums' order differs, so the output within MOE_FFN_F32_REL_TOL of
# the largest |CPU output|, a limit that TF32 or bf16 expert products fail
# (on the H100: f32 read at most 1.2e-6; TF32 5.1e-4 and up, bf16 4.2e-3 and up)
MOE_FFN_F32_REL_TOL = 1e-5
# budgeted (stream_matmul) against unbudgeted (cuBLAS) serving, teacher-
# forced: the two sum the experts' f32 products in other orders, so the
# logits may part by this many bf16 steps at the largest |logit|
MOE_BUDGET_LOGIT_STEPS = 4  # phase 5 (c)'s SPEC_LOGIT_STEPS; measured on the H100: 1
# the hybrid phase: zamba2-2.7b at full width and depth; its card-vs-CPU
# check at one super-block (hybrid_attn_every SSM layers and the shared block)
HYB_ARCH = "zamba2_2p7b"
HYB_DECODE_STEPS = 4  # (b): greedy decode steps after the 512-token prompt
HYB_RAGGED_M = 93  # (c): a ragged M and prompt (a sibling's 93-token suffix)
HYB_PRIME = 257  # (d): a prime prompt past ssm_chunk: SSD chunks of one token
# (b) bf16 on the card against float32 on the CPU, one super-block: the lane
# state leaf by leaf over its layers, and the shared block's K/V rows
# (read on the H100: the SSD state 0.031-0.034 along the 516 positions, the
# conv buffers 0.017-0.023, cosines >= 0.9994; the K/V rows 0.025)
HYB_LANE_REL_TOL = 0.1
HYB_LANE_MIN_COS = 0.99
HYB_KV_REL_TOL = 0.05
HYB_EAGER_REQUESTS = 8  # (e): the eager run (and its compiled twin) at 8 of the cell's 16
# (f) cached against uncached serving, teacher-forced. A cached request
# resumes from an anchor taken where its last turn's prompt ended, so its
# prompt is summed in 96-token pieces (chunk by chunk through the SSD), a
# cold prefill in 256-token chunks: another order of bf16 sums through 54
# layers. Read on the H100 (random weights: near-flat logits, max |logit|
# 5.5): 14 bf16 steps at most, the argmax the same at 82.5% of 1024
# positions. Bound: HYB_WARM_LOGIT_STEPS steps and HYB_WARM_MIN_ARGMAX; the
# cached run must also equal, bitwise, uncached serving over its own
# partition (--prefill-chunk TURN_TOKENS), which a zeroed anchor lane fails
HYB_WARM_LOGIT_STEPS = 24
HYB_WARM_MIN_ARGMAX = 0.75
# the fixed-batch engine (``serve --engine fixed``): the cell of the SSM
# phase (e) and of phase 5's smollm-360m case: FIXED_REQUESTS requests of
# FIXED_PROMPT + FIXED_GEN tokens on LANES lanes, eager and compiled
FIXED_REQUESTS, FIXED_PROMPT, FIXED_GEN = 8, 128, 64
FIXED_MAX_LEN = FIXED_PROMPT + FIXED_GEN
FIXED_REPLAYS = 3  # replays held bitwise against the eager step, in a row
# the SSM phase: mamba2-1.3b at full width and depth through the fixed-batch
# engine; its card-vs-CPU check at SSM_CPU_LAYERS of its layers
SSM_ARCH = "mamba2_1p3b"
SSM_CPU_LAYERS = 2
SSM_CPU_LANES = 2
SSM_CPU_POSITIONS = 256  # (b): decode steps fed to both sides
SSM_HOLD_EVERY = 32  # (b): the state held at position 7 and every 32nd
# (b) bf16 on the card against float32 on the CPU: the SSD state and the
# conv buffers leaf by leaf over the layers, and their error along the
# positions. Read on the H100 (2 layers, 256 positions): the SSD state
# 0.0104-0.0126, the conv buffers 0.0061-0.0078, cosines >= 0.99997, the
# late error 0.95-0.99x the early. Bounds: ~3x the reading (as the hybrid
# phase's lane bound is ~3x its own), and the largest error at positions
# >= 192 within SSM_GROWTH of the largest at 7-63 (a state that forgets
# does not gather error)
SSM_STATE_REL_TOL = 0.04
SSM_STATE_MIN_COS = 0.999
SSM_GROWTH = 2.0
SSM_PREFILL_PROMPT = 512  # (d): two SSD chunks of 256
# (d) the fixed decode step (the SSD recurrence, its state in f32) replayed
# through a prompt, teacher-forced, against ``prefill`` over it (the
# chunked SSD, whose C.B^T, decay weights and intra-chunk product round to
# bf16), 48 layers deep on random weights (near-flat logits, max |logit|
# 5.5). Read on the H100 in bf16: 53.8 bf16 steps at most (flat along the
# prompt: 50.9, 53.8, 38.9, 43.8 by quarter), the argmax the same at 55.3%
# of 512 positions; the same weights widened to float32: 0.029 steps
# (9.0e-4), the argmax the same at every position. So the bf16 gap is the
# two paths' rounding carried through 48 layers, not a fault. Bounds: bf16
# SSM_PREFILL_LOGIT_STEPS steps and SSM_PREFILL_MIN_ARGMAX (~1.5x the
# reading); float32 SSM_F32_LOGIT_STEPS (of the bf16 run's step) and
# SSM_F32_MIN_ARGMAX, which a fault in either path fails
SSM_PREFILL_LOGIT_STEPS = 80
SSM_PREFILL_MIN_ARGMAX = 0.4
SSM_F32_LOGIT_STEPS = 0.5
SSM_F32_MIN_ARGMAX = 0.95
# the vlm phase: internvl2-76b at full width, SERVED_LAYERS of its layers, 2-bit
# FFN carriers; its checks against the CPU at VLM_CPU_LAYERS of them, the
# patch prefill on VLM_PATCHES seeded patch embeddings ahead of VLM_TOKENS
# tokens; eager against compiled serving at VLM_EAGER_REQUESTS of the cell's
# 16 requests (the eager run's cut)
VLM_ARCH = "internvl2_76b"
VLM_CPU_LAYERS = 2
VLM_PATCHES, VLM_TOKENS = 256, 64
VLM_EAGER_REQUESTS = 8
# the enc-dec phase: whisper-tiny at full size (4 + 4 layers, d 384, 1500
# frames) on LANES lanes: ENC_TOKENS decoder tokens in the prefill and
# teacher-forced decode steps against the CPU, ENC_GEN greedy tokens a lane
ENC_ARCH = "whisper_tiny"
ENC_TOKENS, ENC_GEN = 32, 64
# the train_families phase (last, on the weights the family phases drew):
# (a) each family's gradients at full width against the CPU, at
# TF_GRAD_LAYERS layers (zamba2: one super-block; whisper at full size);
# (b) zamba2-2.7b at full size through the train CLI, TF_HYB_BATCH x
# TF_HYB_SEQ tokens, --remat full; (c) make_train_step at TF_SHORT's (batch,
# seq, remat) for each arch, olmoe at TF_MOE_LAYERS of its 16 layers (at 12 B
# a parameter all 16 would need ~83 GB); TF_STEPS steps a run at TF_LR, the
# train CLI's default (on the H100, at 4 steps: zamba2's loss rose at the
# second step at 3e-2 (10.9 -> 16.4) and 1e-2 (-> 12.1), swung at 3e-3
# (8.98, 12.25, 8.25) and fell at 3e-4 (10.886, 10.890, 10.729, 10.628);
# olmoe's swung at 3e-2 (12.7, 15.8, 23.0, 10.0))
TF_GRAD_LAYERS = {"olmoe_1b_7b": 2, "mamba2_1p3b": 2, "internvl2_76b": 1}
TF_MOE_LAYERS = 4  # the MoE phase's weights, MOE_LAYERS deep
TF_HYB_BATCH, TF_HYB_SEQ = 8, 512
TF_SHORT = {"whisper_tiny": (8, 256, "none"), "mamba2_1p3b": (4, 512, "full"),
            "olmoe_1b_7b": (4, 512, "none")}
TF_STEPS, TF_LR = 4, 3e-4
# the seeded scale of a modality batch leaf, as the vlm and enc-dec phases draw them
MODALITY_STD = {"prefix_embeds": 0.02, "frames": 1.0}


HOST_POOLS: list = []  # the host-draw threads' executors, cancelled on a failure


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    for pool in HOST_POOLS:
        pool.shutdown(wait=False, cancel_futures=True)
    sys.exit(1)


PHASE_LOG: list[Path] = []  # --log: a file that also gets every phase line and the kernels line


def phase(phase_name: str, **fields) -> None:
    line = json.dumps({"phase": phase_name, **fields})
    print(line, flush=True)
    for path in PHASE_LOG:
        with open(path, "a") as fh:
            fh.write(line + "\n")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def start_ptxas(build) -> dict:
    """``nvcc -Xptxas -v`` on every kernel source, one process each, started
    together (beside the build)."""
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    return {
        name: subprocess.Popen(
            [build._nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", os.devnull,
             str(build.CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in build.kernel_names()
    }


def ptxas_report(procs: dict) -> dict[str, dict]:
    """Registers and spill bytes of every kernel entry, by source and
    (demangled, where ``c++filt`` is found) name."""
    entries = {}
    for source, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v failed on {source}.cu:\n{log}")
        entry = None
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                entry = (source, m.group(1))
                entries[entry] = {}
            elif entry and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
                entries[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            elif entry and (m := re.search(r"Used (\d+) registers", line)):
                entries[entry]["registers"] = int(m.group(1))
    names = [mangled for _, mangled in entries]
    if shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [n.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
                     for n in out]
    return {f"{source}:{name}": r for ((source, _), r), name in zip(entries.items(), names)}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--only", choices=("kernels", "prefill", "moe", "hybrid", "ssm", "vlm",
                                       "encdec", "fleet", "train_families", "analysis"),
                    help="kernels: stop after phase 3 (build, and hold each kernel against "
                         "its plain version); prefill: build, then only phase 4's prefill "
                         "check and profile; moe: build, then only the MoE phase; hybrid: "
                         "build, then only the hybrid phase; ssm: build, then only the SSM "
                         "phase; vlm, encdec: build, then only that family's phase; fleet: "
                         "build, then only phase 5 (b)'s follow-up turn and phase 5 (d); "
                         "train_families: build, then only that phase, on weights it draws; "
                         "analysis: build, then only the analysis phase (no measured serve "
                         "cell beside the model). Each prints no result")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the source tree whose repro_torch to run (default: src beside this "
                         "script); another commit's, to compare the two in one call")
    ap.add_argument("--log", type=Path,
                    help="also append every phase line and the kernels line to this file "
                         "(the end of a long run's output may not hold them all)")
    opts = ap.parse_args(argv)
    if opts.log:
        opts.log.parent.mkdir(parents=True, exist_ok=True)
        PHASE_LOG.append(opts.log)
    if not (opts.src / "repro_torch" / "csrc").is_dir():
        fail(f"no src/repro_torch in {opts.src}; run {Path(__file__).name} from a checkout")
    sys.path.insert(0, str(opts.src.resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    # the process's own f32 matmul settings, before this script sets them
    # for its calls: the MoE phase serves under these
    tf32_default = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    clock = [time.monotonic()] * 2  # the run's start, the last phase's end

    host_peak, host_done = [0], threading.Event()

    def phase_seconds(name: str) -> None:
        """The phase's seconds, the run's, the card's memory after it, and
        the host's resident memory now and at its peak during the phase
        (host draws ahead of their phase included)."""
        now = time.monotonic()
        phase("seconds", done=name, seconds=now - clock[1], run_seconds=now - clock[0],
              device_allocated_mib=torch.cuda.memory_allocated() / 2**20,
              device_reserved_mib=torch.cuda.memory_reserved() / 2**20,
              device_peak_mib=torch.cuda.max_memory_allocated() / 2**20,
              host_rss_mib=rss() / 2**20, host_rss_peak_mib=host_peak[0] / 2**20)
        host_peak[0] = rss()
        clock[1] = now

    # ---------------- 1. device ----------------
    smi = nvidia_smi()
    phase("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)

    # ---------------- 2. build ----------------
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    ptxas = start_ptxas(_build)
    _build.build_all()
    phase("build", seconds=time.monotonic() - t0, dir=str(_build.BUILD_DIR))
    report = ptxas_report(ptxas)
    phase("ptxas", kernels=report)
    spills = [name for name, r in report.items() if r["spill_stores"] or r["spill_loads"]]
    if spills:
        fail(f"ptxas reports register spills in {spills}")

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

    def host_us(fn, n=200) -> float:
        """Host time per call of ``fn`` (enqueue only: no synchronise
        between calls), the share of a step a kernel's wrapper costs the
        host."""
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    gen = torch.Generator(device="cpu").manual_seed(0)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_window(step, window=3) -> tuple[dict, dict[str, float]]:
        """Host wall ms of ``step`` (synchronised, mean of 10 after 3 warm-up
        runs) against the card's kernel ms in a torch.profiler window of
        ``window`` steps;
        with each kernel's ms per step by (cut) name, and the median of 10
        CUDA-event spans around one step each (the card's start-to-end time
        of a step, idle gaps included)."""
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(10):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) / 10 * 1e3
        spans_ms = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            spans_ms.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(window):
                step()
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name: dict[str, float] = {}
        for e in kern:
            by_name[e.name[:60]] = (by_name.get(e.name[:60], 0.0)
                                    + e.time_range.elapsed_us() / (window * 1e3))
        dev_ms = sum(by_name.values())
        return dict(host_step_ms=wall_ms, device_step_ms=dev_ms,
                    device_busy_share=dev_ms / wall_ms, kernels_per_step=len(kern) / window,
                    event_step_ms=statistics.median(spans_ms)), by_name

    from repro_torch.models import encdec
    from repro_torch.runtime.steps import CapturedStep, make_prefill_step, make_serve_step

    def replay_matches(label, i, replays, want_replays, pairs) -> dict:
        """Replay ``i`` of a graph (``replays`` counted so far, which must
        be ``want_replays``) against the eager step: each of ``pairs``
        (name: (replayed, eager)) bitwise equal (the max |diff| and cosine
        are printed beside), or the run fails."""
        torch.cuda.synchronize()
        out = {"case": label, "replay": i, "replays": replays}
        for key, (a, b) in pairs.items():
            a2, b2 = a.float().flatten(), b.float().flatten()
            out[f"{key}_bitwise"] = same_bits(a, b)
            out[f"{key}_max_abs_diff"] = (a2 - b2).abs().max().item()
            out[f"{key}_cosine"] = F.cosine_similarity(a2, b2, dim=0).item()
        phase("graph_vs_eager", **out)
        if replays != want_replays or not all(out[f"{k}_bitwise"] for k in pairs):
            fail(f"{label}: replay {i} is not the eager step: {out}")
        return out

    def hold_replay(label, step_fn, host_in, pk0, pv0, replay_in=None) -> list[dict]:
        """``step_fn(pool_k, pool_v, *inputs) -> logits`` compiled
        (``CapturedStep``) on a copy of the pools: its first call and
        capture on ``host_in``; then, for each of ``replay_in`` (default:
        ``host_in`` again), the copy restored to the same state and one
        replay on those inputs, against the eager step on another copy.
        Logits and both pools must be bitwise equal to the eager step's
        (the max |diff| and cosine are printed beside)."""
        kg, vg = pk0.clone(), pv0.clone()
        graph = CapturedStep(lambda *xs: step_fn(kg, vg, *xs), device=dev,
                             mempool=torch.cuda.graph_pool_handle())
        graph(*host_in)
        outs = []
        for i, inputs in enumerate(replay_in or (host_in,)):
            ke, ve = pk0.clone(), pv0.clone()
            lg_e = step_fn(ke, ve, *(t.to(dev) for t in inputs))
            kg.copy_(pk0)
            vg.copy_(pv0)
            lg_r = graph(*inputs)
            torch.cuda.synchronize()
            outs.append(replay_matches(label, i, graph.replays, i + 1, {
                "logits": (lg_r, lg_e), "pool_k": (kg, ke), "pool_v": (vg, ve)}))
            del ke, ve
        del graph, kg, vg
        return outs

    def logits_vs_cpu(a, b, label, **fields) -> dict:
        """Next-token logits from the card (``a``) against the CPU's (``b``):
        their cosine >= PREFILL_MIN_COS and the card's top-1 token within
        PREFILL_TOP1_SLACK of the CPU's max logit, or the run fails."""
        a, b = a.float().cpu(), b.float()
        cos = F.cosine_similarity(a, b, dim=0).item()
        top_gpu, top_cpu = int(a.argmax()), int(b.argmax())
        slack = (b.max() - b[top_gpu]).item()
        out = dict(**fields, cosine=cos, top1_card=top_gpu, top1_cpu=top_cpu,
                   top1_cpu_logit_gap=slack, max_abs_logit_err=(a - b).abs().max().item())
        if not (cos >= PREFILL_MIN_COS and slack <= PREFILL_TOP1_SLACK):
            fail(f"{label} card vs CPU: cosine {cos}, top-1 gap {slack}")
        return out

    def cpu_copy(c, params):
        """The config and weights in float32 on the CPU (the same weights)."""
        cpu_c = dataclasses.replace(c, dtype="float32")
        return cpu_c, params_from_reference(_to_cpu(params.tree()), cpu_c, device="cpu",
                                            dtype=torch.float32)

    def prefill_vs_cpu(c, params, **fields) -> None:
        """``prefill_with_cache`` on a PROMPT-token prompt in bf16 on the
        card against float32 on the CPU, same weights (``logits_vs_cpu``)."""
        cpu_c, cpu_params = cpu_copy(c, params)
        tokens = torch.from_numpy(
            np.random.default_rng(0).integers(0, c.vocab, size=(1, PROMPT))
        )
        t0 = time.monotonic()
        lg_gpu, ks, _ = lm.prefill_with_cache(params, c, tokens.to(dev), PROMPT - 1)
        torch.cuda.synchronize()
        gpu_s = time.monotonic() - t0
        t0 = time.monotonic()
        lg_cpu, _, _ = lm.prefill_with_cache(cpu_params, cpu_c, tokens, PROMPT - 1)
        cpu_s = time.monotonic() - t0
        out = logits_vs_cpu(lg_gpu[0, 0, : c.vocab], lg_cpu[0, 0, : c.vocab],
                            f"prefill {c.name}", **fields, tokens=PROMPT)
        phase("prefill", **out, card_s=gpu_s, cpu_s=cpu_s,
              kv_rows_finite=bool(torch.isfinite(ks).all()))

    def chunk_profile(step) -> dict:
        """``profile_window`` of a prefill chunk, its card ms split into
        ``flash_fwd``, ``packed_matmul`` and the rest."""
        stats, by_name = profile_window(step)
        split = {"flash_fwd": 0.0, "packed_matmul": 0.0, "rest": 0.0}
        for name, ms in by_name.items():
            if "flash_fwd" in name:
                split["flash_fwd"] += ms
            elif any(k in name for k in ("mma_kernel<", "tiled_kernel<", "gemv_kernel<")):
                split["packed_matmul"] += ms
            else:
                split["rest"] += ms
        return dict(**stats, device_ms_by_kernel=split,
                    top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))

    def prefill_phase():
        """Phase 4's prefill: smollm-360m at full width and depth with 2-bit
        FFN carriers, ``prefill_with_cache`` on a 512-token prompt in bf16
        on the card against float32 on the CPU, same weights; then the
        serve path's second prefill chunk (``prefill_chunk_paged``: CHUNK
        tokens at start CHUNK over MAX_LEN pool rows, batch 1) profiled:
        host ms against the card's kernel ms, split into ``flash_fwd``,
        ``packed_matmul`` and the rest. Returns (params, config)."""
        cfg2 = dataclasses.replace(get_config("smollm_360m"), w_bits=2)
        params = lm.init_params(cfg2, 0, device=dev)
        prefill_vs_cpu(cfg2, params)

        pk = torch.zeros((cfg2.n_layers, MAX_LEN + 16, cfg2.n_kv, cfg2.hd),
                         dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        table = (16 + torch.arange(MAX_LEN, device=dev))[None]
        chunk = torch.from_numpy(
            np.random.default_rng(2).integers(0, cfg2.vocab, size=(1, CHUNK))).to(dev)

        # the scheduler's chunk: start and last index as device tensors;
        # compiled, host inputs copied into the graph's buffers
        def chunk_in_at(start):
            return (chunk.cpu(), table.cpu(), table[:, start:start + CHUNK].cpu(),
                    torch.tensor([start]), torch.tensor([CHUNK - 1]))

        chunk_in = chunk_in_at(CHUNK)
        chunk_dev = tuple(t.to(dev) for t in chunk_in)

        def chunk_step():
            lm.prefill_chunk_paged(params, cfg2, chunk_dev[0], pk, pv, *chunk_dev[1:])

        def chunk_fn(k_, v_, tok, rows, wr, start, last):
            return lm.prefill_chunk_paged(params, cfg2, tok, k_, v_, rows, wr, start, last)[0]

        chunk_graph = CapturedStep(lambda *xs: chunk_fn(pk, pv, *xs), device=dev,
                                   mempool=torch.cuda.graph_pool_handle())

        def chunk_graph_step():
            chunk_graph(*chunk_in)

        # eager and compiled in turns: the host's speed drifts within a call
        for compiled, step in ((False, chunk_step), (True, chunk_graph_step),
                               (True, chunk_graph_step), (False, chunk_step)):
            phase("prefill_profile", src=str(opts.src), compiled=compiled, chunk=CHUNK,
                  start=CHUNK, pool_rows=MAX_LEN, **chunk_profile(step))
        del chunk_graph, pk, pv
        rows0 = (cfg2.n_layers, MAX_LEN + 16, cfg2.n_kv, cfg2.hd)
        hold_gen = torch.Generator(device="cpu").manual_seed(4)
        pk0 = torch.randn(rows0, generator=hold_gen).to(dev, torch.bfloat16)
        pv0 = torch.randn(rows0, generator=hold_gen).to(dev, torch.bfloat16)
        # the scheduler's one chunk graph: captured at start CHUNK, then
        # replayed at that start and at two others (37, 383: mid-block, as
        # after a prefix-cache hit), each against the eager step there
        hold_replay("prefill chunk, --quant 2", chunk_fn, chunk_in, pk0, pv0,
                    replay_in=[chunk_in_at(s) for s in (CHUNK, 37, MAX_LEN - CHUNK - 1)])

        # whole-prompt prefill, one graph per bucket: 16 (packed_matmul's
        # GEMV route) and 208 (flash_fwd's partial 64-row tile), the prompt
        # ending mid-bucket; the replay's logits and K/V rows, and the pools
        # after the scheduler's write of those rows, bitwise the eager step's
        def bucket_fn(tok, last):
            return lm.prefill_with_cache(params, cfg2, tok, last)

        for bucket, p in ((16, 11), (BUCKET, BUCKET - 5)):
            tok = torch.zeros((1, bucket), dtype=torch.long)
            tok[0, :p] = torch.from_numpy(
                np.random.default_rng(bucket).integers(0, cfg2.vocab, size=p))
            b_in = (tok, torch.tensor([p - 1]))
            rows = torch.arange(16, 16 + bucket, device=dev)
            rows[p:] = 0  # padding goes to the scratch row, as write_prefill sends it
            graph = CapturedStep(bucket_fn, device=dev, mempool=torch.cuda.graph_pool_handle())
            graph(*b_in)
            got = graph(*b_in)
            want = bucket_fn(*(t.to(dev) for t in b_in))
            pools = []
            for lg_, ks_, vs_ in (got, want):
                k_, v_ = pk0.clone(), pv0.clone()
                k_.index_copy_(1, rows, ks_[:, 0])
                v_.index_copy_(1, rows, vs_[:, 0])
                pools.append((k_, v_))
            torch.cuda.synchronize()
            out = dict(case=f"prefill bucket {bucket} ({p} tokens), --quant 2",
                       replays=graph.replays,
                       logits_bitwise=same_bits(got[0], want[0]),
                       ks_bitwise=same_bits(got[1], want[1]),
                       vs_bitwise=same_bits(got[2], want[2]),
                       # the scratch row takes the padding's writes in no set order
                       pool_k_bitwise=same_bits(pools[0][0][:, 1:], pools[1][0][:, 1:]),
                       pool_v_bitwise=same_bits(pools[0][1][:, 1:], pools[1][1][:, 1:]),
                       logits_max_abs_diff=(got[0] - want[0]).abs().max().item())
            phase("graph_vs_eager", **out)
            if graph.replays != 1 or not all(v for k, v in out.items() if k.endswith("bitwise")):
                fail(f"prefill bucket {bucket}: the replay is not the eager step: {out}")
            del graph, got, want, pools

        # a bucket's prefill, host ms against the card's, eager and compiled
        # in turns (the scheduler's: device last index; compiled, host inputs
        # copied into the graph's buffers)
        tok = torch.from_numpy(
            np.random.default_rng(3).integers(0, cfg2.vocab, size=(1, BUCKET)))
        b_in = (tok, torch.tensor([BUCKET - 1]))
        b_dev = tuple(t.to(dev) for t in b_in)
        graph = CapturedStep(bucket_fn, device=dev, mempool=torch.cuda.graph_pool_handle())
        for compiled in (False, True, True, False):
            step = (lambda: graph(*b_in)) if compiled else (lambda: bucket_fn(*b_dev))
            stats, by_name = profile_window(step)
            phase("bucket_profile", src=str(opts.src), compiled=compiled, bucket=BUCKET,
                  **stats, top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
        del graph, pk0, pv0
        return params, cfg2

    # ---- shared by phase 5, the other archs and the MoE phase ----
    launches = dict.fromkeys(ops.launch_counts(), 0)
    # launches by route, main path
    routes = {name: {} for name in ("packed_matmul", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}

    def add_routes(by_route):
        for name, counts in by_route.items():
            for route, n in counts.items():
                routes[name][route] = routes[name].get(route, 0) + n

    def drive(sched, waves, gen) -> dict:
        """Each wave submitted, then rounds until it drains, launch counters
        reset just before and read just after; every whole-prompt prefill
        timed to the card's finish (host ms), and of every sampled position
        a digest of its whole logits row and its TOP_LOGITS largest logits
        kept."""
        prefill_s = []
        top, digests = {}, {}
        run_prefill = sched._run_prefill
        sample_one = sched._sample_one

        def recording_sample(req, row):
            ids = np.argpartition(row, -TOP_LOGITS)[-TOP_LOGITS:]
            top[req.rid, len(req.output)] = {int(i): float(row[i]) for i in ids}
            digests[req.rid, len(req.output)] = hashlib.blake2b(
                np.ascontiguousarray(row).tobytes(), digest_size=16).digest()
            return sample_one(req, row)

        def timed_prefill(tokens, last):
            t0 = time.perf_counter()
            out = run_prefill(tokens, last)
            torch.cuda.synchronize()
            prefill_s.append((tokens.shape[1], time.perf_counter() - t0))
            return out

        sched._run_prefill = timed_prefill
        sched._sample_one = recording_sample
        ops.reset_launch_counts()
        t0 = time.monotonic()
        for wave in waves:
            for p in wave:
                sched.submit(p, gen)
            while sched.queue or any(r is not None for r in sched.active):
                sched.round()
            sched.pool.validate()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        st = sched.stats
        bucket_graphs = sched.prefill_buckets
        first = {}
        for b, t in prefill_s:
            first.setdefault(b, t)
        replayed = [t for i, (b, t) in enumerate(prefill_s)
                    if any(bb == b for bb, _ in prefill_s[:i])]
        return dict(
            counts=counts, by_route=by_route, outputs=sched.outputs(), top_logits=top,
            digests=digests,
            metrics=dict(
                compiled=sched.compiled, prefix_cache=sched.prefix_cache is not None,
                requests=len(sched.requests), completed=st.completed,
                generated_tokens=st.generated_tokens, wall_s=wall,
                tokens_per_s=st.generated_tokens / wall, mean_ttft_s=st.mean_ttft,
                prefill_steps=st.prefill_steps, prefill_tokens=st.prefill_tokens,
                prefix_hits=st.prefix_hits, prefix_hit_tokens=st.prefix_hit_tokens,
                prefix_hit_rate=st.prefix_hit_rate, cow_copies=sched.pool.cow_copies,
                shared_blocks_peak=st.shared_blocks_peak,
                evicted_blocks=(sched.prefix_cache.evicted_blocks
                                if sched.prefix_cache is not None else 0),
                graphs=len(sched.graphs), bucket_graphs=bucket_graphs,
                chunk_graphs=len(sched.graphs) - len(bucket_graphs)
                - (sched.decode_graph is not None),
                graph_capture_s=sum(g.capture_s for g in sched.graphs),
                graph_first_call_s=sum(g.first_call_s for g in sched.graphs),
                whole_prompt_prefills=len(prefill_s),
                prefill_host_ms_mean=(statistics.fmean(t for _, t in prefill_s) * 1e3
                                      if prefill_s else None),
                prefill_host_ms_repeat_bucket_mean=(
                    statistics.fmean(replayed) * 1e3 if replayed else None),
                prefill_host_ms_first_of_bucket_mean=(
                    statistics.fmean(first.values()) * 1e3 if first else None),
            ))

    def session_waves(vocab, seed=3):
        """(b) the reference's prefix bench traffic (``_session_waves``): per
        session a nested turn prompt (the last turn's plus TURN_TOKENS fresh
        tokens) and a sibling sharing all but its last 3 tokens, so siblings
        match mid-block (copy-on-write)."""
        rng = np.random.default_rng(seed)
        fresh = lambda n: rng.integers(0, vocab, size=(n,)).astype(np.int32)  # noqa: E731
        prompts = [fresh(TURN_TOKENS) for _ in range(SESSIONS)]
        waves = []
        for t in range(TURNS):
            if t:
                prompts = [np.concatenate([p, fresh(TURN_TOKENS)]) for p in prompts]
            waves.append([x for p in prompts for x in (p, np.concatenate([p[:-3], fresh(3)]))])
        return waves

    page = os.sysconf("SC_PAGE_SIZE")

    def rss() -> int:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * page

    # the host's resident memory, sampled every 50 ms for the whole run: each
    # ``seconds`` line reads its peak since the line before
    host_peak[0] = rss()

    def sample_host() -> None:
        while not host_done.wait(0.05):
            host_peak[0] = max(host_peak[0], rss())

    threading.Thread(target=sample_host, daemon=True).start()

    # ---- weights drawn ahead on host threads ----
    # ``lm.init_params(c, 0, device="cpu")`` is bitwise the card's draw (the
    # same generator, seed and order; the card's draw rounds to the model
    # dtype on the host too), so the next arch's weights are drawn on a host
    # thread while the card runs the phase before, and moved to the card
    # when their phase starts (``timed_init``). The threads make no CUDA
    # call: a CUDA call from another thread would invalidate a graph the
    # phase captures meanwhile (global capture mode), so they touch
    # pageable host tensors only (no pinned memory). One thread draws, in
    # the order asked; another packs (``pack_ffn_params`` of a host draw).
    draw_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="host-draw")
    pack_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="host-pack")
    HOST_POOLS.extend((draw_pool, pack_pool))
    prefetched: dict = {}

    def host_job(fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        return out, time.monotonic() - t0

    packed_ahead: dict = {}

    def draw_then_pack(c, bits):
        """The host draw of ``c`` (seed 0); with ``bits``, its FFN
        leaves then packed on the pack thread (``pack_ffn_params``, bitwise
        ``init_params`` at those bits), queued as soon as the draw is done,
        for ``take_packed``."""
        host = lm.init_params(c, 0, device="cpu")
        if bits:
            packed_ahead[c] = pack_pool.submit(host_job, lm.pack_ffn_params, host, bits)
        return host

    def prefetch(*configs, packed_bits=0) -> None:
        """Queue the host draw of each config on the draw thread."""
        for c in configs:
            if c not in prefetched:
                prefetched[c] = draw_pool.submit(host_job, draw_then_pack, c, packed_bits)

    def to_card(p):
        """A host ``LMParams`` copied to the card (the host copy stays)."""
        def move(node):
            return ({k: move(v) for k, v in node.items()} if isinstance(node, dict)
                    else node.to(dev))
        out = lm.LMParams(move(p.tree()))
        torch.cuda.synchronize()
        return out

    def take(future) -> tuple:
        """A host job's result and its seconds, and the seconds the card's
        side waited for it."""
        t0 = time.monotonic()
        out, job_s = future.result()
        return out, job_s, time.monotonic() - t0

    def timed_init(c) -> tuple:
        """``lm.init_params(c, 0)`` on the card: the weights and their
        numbers. Weights ``prefetch`` queued come from the host draw,
        copied to the card: ``init_s`` is the host thread's draw plus the
        copy, ``foreground_s`` what the run waited for them (the wait and
        the copy). Others are drawn on the card here: the seconds it took
        (to the card's finish), the host's resident memory at its start and
        at its peak (sampled every 20 ms; memory freed by earlier phases
        and kept by the host allocator is reused, so the peak may not
        rise). Either way, the weights' device MiB."""
        dev0 = torch.cuda.memory_allocated()
        if c in prefetched:
            host, draw_s, wait_s = take(prefetched.pop(c))
            t0 = time.monotonic()
            p = to_card(host)
            move_s = time.monotonic() - t0
            return p, dict(init_s=draw_s + move_s, drawn_on_host_thread=True, draw_s=draw_s,
                           wait_s=wait_s, move_s=move_s, foreground_s=wait_s + move_s,
                           host_rss_mib=rss() / 2**20,
                           weights_mib=(torch.cuda.memory_allocated() - dev0) / 2**20)
        base, peak, done = rss(), [0], threading.Event()

        def sample():
            while not done.wait(0.02):
                peak[0] = max(peak[0], rss())

        sampler = threading.Thread(target=sample)
        sampler.start()
        t0 = time.monotonic()
        try:
            p = lm.init_params(c, 0, device=dev)
            torch.cuda.synchronize()
            init_s = time.monotonic() - t0
        finally:
            done.set()
            sampler.join()
        return p, dict(init_s=init_s, init_host_rss_mib_start=base / 2**20,
                       init_host_rss_mib_peak=max(peak[0], rss()) / 2**20,
                       weights_mib=(torch.cuda.memory_allocated() - dev0) / 2**20)

    def take_packed(c, params) -> tuple:
        """``params`` (``c``'s dense weights on the card) with their FFN
        leaves packed at 2 bits: the pack thread's copy of the host draw
        where ``prefetch`` queued one, else packed here from the card's
        copy; and the seconds the packing took and the run waited."""
        t0 = time.monotonic()
        if c in packed_ahead:
            host, pack_s, wait_s = take(packed_ahead.pop(c))
            packed = to_card(host)
            return packed, dict(pack_s=pack_s, packed_on_host_thread=True, wait_s=wait_s,
                                foreground_s=time.monotonic() - t0)
        packed = lm.pack_ffn_params(params, 2)
        torch.cuda.synchronize()
        pack_s = time.monotonic() - t0
        return packed, dict(pack_s=pack_s, foreground_s=pack_s)

    def arch_configs(arch) -> tuple:
        """A dense arch's two draws in ``serve_arch``: 2 layers at 2 bits
        (the check against the CPU), dense at its served depth."""
        full = get_config(arch)
        return (dataclasses.replace(full, n_layers=2, w_bits=2),
                dataclasses.replace(full, w_bits=0,
                                    n_layers=SERVED_LAYERS.get(arch, full.n_layers)))

    def prefetch_after(name) -> None:
        """Queue the host draws that follow ``name``'s phase (a full run
        only): from phase 4 on, each arch's weights behind the phases
        before its own; the dense archs' served draws then packed at 2
        bits on the pack thread."""
        if opts.only:
            return
        if name == "phase 4":
            for arch in NEW_ARCHS:
                c2, cq0 = arch_configs(arch)
                prefetch(c2)
                prefetch(cq0, packed_bits=2)
        elif name == NEW_ARCHS[0]:
            prefetch(moe_served_config(),
                     dataclasses.replace(get_config(MOON_ARCH), n_layers=MOON_LAYERS))
        elif name == MOE_ARCH:
            prefetch(get_config(HYB_ARCH), get_config(SSM_ARCH))
        elif name == HYB_ARCH:
            prefetch(vlm_served_config(), dataclasses.replace(get_config(ENC_ARCH), w_bits=0))

    # ---- the kernel cases of phase 3, and of the hybrid phase's (c) ----
    packed_cases = []
    packed_checks = []

    def packed_case(bits, m, k, n, dt, timed, g=gen):
        """``packed_matmul`` on the card against its plain version on the
        same inputs (rel err within PACKED_REL_TOL); timed cases beside the
        plain version, the library's matmul on the pre-decoded weight and
        the bound. A second run must give the same bits (the tensor-core
        path, bf16 x with M > 16, sums its K split in a fixed order)."""
        w = lm.make_packed(torch.randn((k, n), generator=g).to(dev), bits)
        x = torch.randn((m, k), generator=g).to(dev, dt)
        got = pm.packed_matmul(x, w["packed"], w["scale"], bits, k)
        want = ref.packed_matmul_ref(x, w["packed"], w["scale"], bits, k)
        again = pm.packed_matmul(x, w["packed"], w["scale"], bits, k)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        path = ("gemv" if m <= pm.GEMV_MAX_M else "mma" if dt == torch.bfloat16 else "tiled_f32")
        label = f"packed_matmul {path} bits={bits} M={m} K={k} N={n} x={dt}"
        if not math.isfinite(err) or rel > PACKED_REL_TOL:
            fail(f"{label}: rel err {rel}")
        if not same_bits(got, again):
            fail(f"{label}: two runs differ")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        splits, k_per_split = 1, k
        if path == "gemv":
            splits, cps = pm.split_plan(m, k, n, sms, bm=pm.GEMV_MAX_M, bn=pm.GEMV_BN, bk=pm.GEMV_BK)
            k_per_split = cps * pm.GEMV_BK
        elif path == "mma":
            splits, cps = pm.mma_plan(k, n, sms)
            k_per_split = cps * pm.BK
        base = dict(bits=bits, m=m, k=k, n=n, x=str(dt).replace("torch.", ""), path=path,
                    splits=splits, k_per_split=min(k, k_per_split), max_abs_err=err, rel_err=rel)
        if not timed:
            packed_checks.append(base)
            phase("kernel", name="packed_matmul", check_only=True, **base)
            return
        w_dec = ref.decode_weights(w["packed"], bits, k).to(dt)
        n_bytes = x.numel() * x.element_size() + w["packed"].numel() + n * 4 + m * n * 4
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n, peak)
        case = dict(
            **base,
            ms=median_ms(lambda: pm.packed_matmul(x, w["packed"], w["scale"], bits, k)),
            host_us=host_us(lambda: pm.packed_matmul(x, w["packed"], w["scale"], bits, k)),
            plain_ms=median_ms(lambda: ref.packed_matmul_ref(x, w["packed"], w["scale"], bits, k)),
            library_ms=median_ms(lambda: torch.matmul(x, w_dec) * w["scale"]),
            bound_ms=b_ms, bound_by=b_by,
        )
        packed_cases.append(case)
        phase("kernel", name="packed_matmul", **case)

    flash_cases = []
    flash_checks = []

    def flash_case(label, h, h_kv, sq, sk, dh, causal, window, q_off, dt, timed, g=gen):
        """``flash_fwd`` on the card against its plain version on the same
        inputs (out within FLASH_OUT_TOL, lse within FLASH_LSE_TOL); timed
        cases beside the plain version, SDPA and the bound. Rows that see
        no key must give out exactly 0 and lse <= -1e29."""
        q = torch.randn((h, sq, dh), generator=g).to(dev, dt)
        kk = torch.randn((h_kv, sk, dh), generator=g).to(dev, dt)
        vv = torch.randn((h_kv, sk, dh), generator=g).to(dev, dt)
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
        blind = torch.from_numpy(~vis.any(axis=1)).to(dev)
        blind_rows = int(blind.sum())
        if blind_rows and not (bool((out[:, blind] == 0).all())
                               and lse[:, blind].max().item() <= -1e29):
            fail(f"flash_fwd {label}: rows that see no key give out != 0 or lse > -1e29")
        base = dict(case=label, sq=sq, sk=sk, heads=h, kv_heads=h_kv, d=dh, causal=causal,
                    window=window, q_offset=q_off, dtype=str(dt).replace("torch.", ""),
                    rows_without_keys=blind_rows, max_abs_err=err, lse_err=lse_err)
        if not timed:
            flash_checks.append(base)
            phase("kernel", name="flash_fwd", check_only=True, **base)
            return
        pairs = int(vis.sum()) * h
        e = q.element_size()
        n_bytes = e * (2 * q.numel() + kk.numel() + vv.numel()) + lse.numel() * 4
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        b_ms, b_by = bound_ms(n_bytes, 4.0 * dh * pairs, peak)
        mask = torch.from_numpy(vis).to(dev)
        q4, k4, v4 = q[None], kk[None], vv[None]
        case = dict(
            **base,
            ms=median_ms(lambda: fa.flash_fwd(q, kk, vv, **kw)),
            plain_ms=median_ms(lambda: ref.flash_fwd_ref(q, kk, vv, **kw)),
            library_ms=median_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=mask, enable_gqa=True
                )
            ) if not (causal and not window and q_off == 0 and sq == sk) else median_ms(
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True, enable_gqa=True
                )
            ),
            bound_ms=b_ms, bound_by=b_by,
        )
        flash_cases.append(case)
        phase("kernel", name="flash_fwd", **case)

    # the dense weights each family phase hands on to the train_families
    # phase (a full run only): arch -> LMParams on the card
    held: dict = {}

    # ---------------- the MoE family (run last; --only moe: alone) ----------------
    from repro_torch.models import moe as moe_lib

    def moe_split(by_name) -> dict[str, float]:
        """A profile's card ms by kind: the f32 GEMMs (the experts' and the
        router's, with cuBLAS's split-K reduction), the unrolled elementwise
        copies (the experts' f32 casts), flash_fwd, stream_matmul, the rest."""
        split = dict.fromkeys(("f32_matmul", "f32_casts", "flash_fwd", "stream_matmul", "rest"),
                              0.0)
        for name, ms in by_name.items():
            if "flash_fwd" in name:
                split["flash_fwd"] += ms
            elif "stream_kernel" in name:
                split["stream_matmul"] += ms
            elif any(k in name for k in ("sgemm", "splitKreduce", "gemv2N", "gemvNSP")):
                split["f32_matmul"] += ms
            elif "unrolled_elementwise_kernel" in name:
                split["f32_casts"] += ms
            else:
                split["rest"] += ms
        return split

    def moe_profile(step) -> dict:
        """``profile_window`` of one step (a window of three MoE chunks came
        back with most of its kernels missing), its card ms by kind."""
        stats, by_name = profile_window(step, window=1)
        split = moe_split(by_name)
        return dict(**stats, device_ms_by_kind=split,
                    f32_matmul_share=split["f32_matmul"] / max(stats["device_step_ms"], 1e-9),
                    top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))

    def bf16_resident(x2, w1e, w3e, w2e, fixed_rows=False):
        """A resident expert with its products in bf16 (not the port's: it
        shows what MOE_FFN_F32_REL_TOL reads at a lower precision)."""
        xb, w1b, w3b, w2b = (t.to(torch.bfloat16) for t in (x2, w1e, w3e, w2e))
        return ((F.silu(xb @ w1b) * (xb @ w3b)) @ w2b).float()

    def moe_layers_vs_cpu(c, p) -> None:
        """(a) A PROMPT-token prefill at ``c``'s depth, layer by layer, each
        layer fed the CPU's input (f32, rounded to bf16 on the card): the
        (token, layer) expert sets the card's routing changes may lie only
        at a near-tie (the CPU's k-th and (k+1)-th router probabilities
        within MOE_FLIP_GAP); on the tokens whose set agrees the FFN output
        within MOE_FFN_REL_TOL of the largest |CPU output|; each layer's
        tally off the CPU's by at most 2k per changed set. The card's FFN
        on the CPU's f32 hidden state itself: its sets changed only at such a
        near-tie, and its output within MOE_FFN_F32_REL_TOL (the same FFN
        with TF32 and with bf16 expert products printed beside, each of
        which must read above it). The card's own end-to-end prefill is
        printed beside the CPU's, not gated: a changed set moves a token's
        output by a gate weight."""
        cpu_c, cpu_p = cpu_copy(c, p)
        k = c.experts_per_token
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, c.vocab, size=(1, PROMPT)))
        pos = torch.arange(PROMPT)[None]
        x = lm.embed(tokens, cpu_p["embed"], torch.float32)
        t0 = time.monotonic()
        layers = []
        for i in range(c.n_layers):
            lc, lg_ = cpu_p.layer(i), p.layer(i)
            xa_c, _ = lm._attn_block(lc, cpu_c, x, pos, window=c.sliding_window)
            xa_g, _ = lm._attn_block(lg_, c, x.to(dev, torch.bfloat16), pos.to(dev),
                                     window=c.sliding_window)
            h_c = lm.rms_norm(xa_c, lc["ln2"], c.norm_eps)
            h_g = lm.rms_norm(xa_g, lg_["ln2"], c.norm_eps)
            _, probs_c, top_c = moe_lib._token_gates(h_c, lc["router"], cpu_c, True)
            _, _, top_g = moe_lib._token_gates(h_g, lg_["router"], c, True)
            y_c, n_c = moe_lib.moe_ffn_dropless(h_c, lc["router"], lc["w1"], lc["w3"], lc["w2"],
                                                cpu_c, fixed_rows=True)
            ffn = lambda h: moe_lib.moe_ffn_dropless(  # noqa: E731
                h, lg_["router"], lg_["w1"], lg_["w3"], lg_["w2"], c, fixed_rows=True)
            y_g, n_g = ffn(h_g)
            # the CPU's own f32 hidden state on the card: the expert products'
            # precision alone (and what TF32 or bf16 products would read)
            h32 = h_c.to(dev)
            top_f = moe_lib._token_gates(h32, lg_["router"], c, True)[2]
            y_f = ffn(h32)[0]
            torch.backends.cuda.matmul.allow_tf32 = True
            y_tf32 = ffn(h32)[0]
            torch.backends.cuda.matmul.allow_tf32 = False
            resident = moe_lib._resident
            moe_lib._resident = bf16_resident
            try:
                y_bf16 = ffn(h32)[0]
            finally:
                moe_lib._resident = resident
            gap = probs_c[0].sort(-1, descending=True).values
            gap = gap[:, k - 1] - gap[:, k]
            set_c = torch.zeros(probs_c.shape[1:], dtype=torch.bool).scatter_(-1, top_c[0], True)

            def changed(top):
                return (set_c != torch.zeros_like(set_c).scatter_(-1, top[0].cpu(), True)).any(-1)

            def rel_err(y, same):
                yc = y_c[0][same]
                return ((y[0].float().cpu()[same] - yc).abs().max() / yc.abs().max()).item()

            flipped, flipped_f = changed(top_g), changed(top_f)
            n_flips, same_f = int(flipped.sum()), ~flipped_f
            layers.append(dict(
                layer=i, sets=PROMPT, sets_changed=n_flips,
                max_gap_at_change=gap[flipped].max().item() if n_flips else 0.0,
                min_gap=gap.min().item(),
                ffn_rel_err_where_sets_agree=rel_err(y_g, ~flipped),
                tally_l1=(n_g.cpu() - n_c).abs().sum().item(),
                f32_in_sets_changed=int(flipped_f.sum()),
                f32_in_max_gap_at_change=gap[flipped_f].max().item() if flipped_f.any() else 0.0,
                f32_in_ffn_rel_err=rel_err(y_f, same_f),
                f32_in_ffn_rel_err_tf32_products=rel_err(y_tf32, same_f),
                f32_in_ffn_rel_err_bf16_products=rel_err(y_bf16, same_f)))
            x = xa_c + y_c
        lg_cpu = lm._unembed(cpu_p, cpu_c, x[:, -1:])[0, 0, :c.vocab]
        lg_card, ks, _, tally = lm.prefill_with_cache(p, c, tokens.to(dev), PROMPT - 1)
        torch.cuda.synchronize()
        a, b = lg_card[0, 0, :c.vocab].float().cpu(), lg_cpu.float()
        phase("moe_prefill", arch=c.name, layers=c.n_layers, tokens=PROMPT, per_layer=layers,
              flip_gap_bound=MOE_FLIP_GAP, ffn_rel_tol=MOE_FFN_REL_TOL,
              ffn_f32_rel_tol=MOE_FFN_F32_REL_TOL,
              end_to_end_cosine=F.cosine_similarity(a, b, dim=0).item(),
              end_to_end_top1_card=int(a.argmax()), end_to_end_top1_cpu=int(b.argmax()),
              end_to_end_max_abs_logit_err=(a - b).abs().max().item(),
              tally_shape=list(tally.shape), tally_sum=tally.sum().item(),
              seconds=time.monotonic() - t0)
        for r in layers:
            if (r["max_gap_at_change"] > MOE_FLIP_GAP
                    or r["ffn_rel_err_where_sets_agree"] > MOE_FFN_REL_TOL
                    or r["tally_l1"] > 2 * k * r["sets_changed"]
                    or r["f32_in_max_gap_at_change"] > MOE_FLIP_GAP
                    or r["f32_in_ffn_rel_err"] > MOE_FFN_F32_REL_TOL):
                fail(f"{c.name} prefill, layer {r['layer']}, card vs CPU: {r}")
            if min(r["f32_in_ffn_rel_err_tf32_products"],
                   r["f32_in_ffn_rel_err_bf16_products"]) <= MOE_FFN_F32_REL_TOL:
                fail(f"{c.name} prefill, layer {r['layer']}: MOE_FFN_F32_REL_TOL does not "
                     f"tell f32 expert products from TF32 or bf16 ones: {r}")
        if not (torch.isfinite(a).all() and torch.isfinite(ks).all()
                and tally.sum().item() == c.n_layers * PROMPT * k):
            fail(f"{c.name} prefill: non-finite logits or K rows, or a tally of "
                 f"{tally.sum().item()} slots")

    def moe_graphs(c, p) -> None:
        """(c) The decode step, a chunk (at two starts), a whole-prompt bucket
        and a verify step, each captured, its replay bitwise its eager step
        in logits, pools, K/V rows and the (L, E) tally; then the compiled
        decode step and chunk profiled, and the compiled verify step timed
        as it runs and with its f32 products padded as a prefill's are."""
        rows0 = (c.n_layers, LANES * MAX_LEN + 16, c.n_kv, c.hd)
        pool_gen = torch.Generator(device=dev).manual_seed(4)
        pk0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        pv0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        table = (16 + torch.arange(LANES * MAX_LEN)).reshape(LANES, MAX_LEN)
        rng = np.random.default_rng(1)
        tok = torch.from_numpy(rng.integers(0, c.vocab, (LANES, 1)))

        def with_tally(out):
            return torch.cat([out[0].flatten().float(), out[-1].flatten()])

        hold_replay(f"{c.name} decode step (logits and tally)",
                    lambda k_, v_, t_, tb, ln: with_tally(
                        lm.decode_step_paged(p, c, t_, k_, v_, tb, ln)),
                    (tok, table, torch.full((LANES,), PROMPT + 8)), pk0, pv0)
        chunk = torch.from_numpy(rng.integers(0, c.vocab, size=(1, CHUNK)))
        one = table[:1]

        def chunk_in_at(start):
            return (chunk, one, one[:, start:start + CHUNK], torch.tensor([start]),
                    torch.tensor([CHUNK - 1]))

        hold_replay(f"{c.name} prefill chunk (logits and tally)",
                    lambda k_, v_, t_, rows, wr, st, last: with_tally(lm.prefill_chunk_paged(
                        p, c, t_, k_, v_, rows, wr, st, last)),
                    chunk_in_at(CHUNK), pk0, pv0, replay_in=[chunk_in_at(s) for s in (CHUNK, 37)])
        starts = torch.from_numpy(PROMPT + 8 + np.arange(LANES))
        wr = torch.stack([table[i, s:s + SPEC_DEPTH] for i, s in enumerate(starts.tolist())])
        vtok = torch.from_numpy(rng.integers(0, c.vocab, (LANES, SPEC_DEPTH)))
        hold_replay(f"{c.name} verify step, chain {SPEC_DEPTH} (logits and tally)",
                    lambda k_, v_, t_, tb, w_, st: with_tally(lm.verify_chunk_paged(
                        p, c, t_, k_, v_, tb, w_, st)),
                    (vtok, table, wr, starts), pk0, pv0)
        del pk0, pv0
        p_len = BUCKET - 5
        btok = torch.zeros((1, BUCKET), dtype=torch.long)
        btok[0, :p_len] = torch.from_numpy(rng.integers(0, c.vocab, size=p_len))
        b_in = (btok, torch.tensor([p_len - 1]))
        graph = CapturedStep(lambda t_, last: lm.prefill_with_cache(p, c, t_, last), device=dev,
                             mempool=torch.cuda.graph_pool_handle())
        graph(*b_in)
        got = graph(*b_in)
        want = lm.prefill_with_cache(p, c, *(t.to(dev) for t in b_in))
        torch.cuda.synchronize()
        out = dict(case=f"{c.name} prefill bucket {BUCKET} ({p_len} tokens)", replays=graph.replays,
                   capture_s=graph.capture_s, pool_mib=graph.pool_bytes / 2**20,
                   **{f"{name}_bitwise": same_bits(a, b) for name, a, b in zip(
                       ("logits", "ks", "vs", "tally"), got, want)})
        phase("graph_vs_eager", **out)
        if graph.replays != 1 or not all(v for key, v in out.items() if key.endswith("bitwise")):
            fail(f"{c.name} prefill bucket: the replay is not the eager step: {out}")
        del graph, got, want
        # where a compiled decode step's and chunk's card time goes
        pk1 = torch.zeros(rows0, dtype=torch.bfloat16, device=dev)
        pv1 = torch.zeros_like(pk1)
        graph = CapturedStep(lambda t_, tb, ln: lm.decode_step_paged(p, c, t_, pk1, pv1, tb, ln)[0],
                             device=dev, mempool=torch.cuda.graph_pool_handle())
        d_in = (tok, table, torch.full((LANES,), PROMPT + 8))
        graph(*d_in)
        phase("decode_profile", arch=c.name, compiled=True, capture_s=graph.capture_s,
              first_call_s=graph.first_call_s, graph_pool_mib=graph.pool_bytes / 2**20,
              **moe_profile(lambda: graph(*d_in)))
        graph = CapturedStep(lambda t_, rows, w_, st, last: lm.prefill_chunk_paged(
            p, c, t_, pk1, pv1, rows, w_, st, last)[0], device=dev,
            mempool=torch.cuda.graph_pool_handle())
        graph(*chunk_in_at(CHUNK))
        phase("prefill_profile", arch=c.name, compiled=True, chunk=CHUNK, start=CHUNK,
              capture_s=graph.capture_s, first_call_s=graph.first_call_s,
              graph_pool_mib=graph.pool_bytes / 2**20,
              **moe_profile(lambda: graph(*chunk_in_at(CHUNK))))
        # a compiled verify step's card ms as it runs (its f32 products
        # unpadded) and with them in 256-row calls, as a prefill runs them
        v_in, dropless, verify_ms = (vtok, table, wr, starts), moe_lib.moe_ffn_dropless, {}
        for fixed in (False, True):
            if fixed:
                moe_lib.moe_ffn_dropless = lambda *a, **kw: dropless(*a, **{**kw,
                                                                            "fixed_rows": True})
            try:
                graph = CapturedStep(lambda t_, tb, w_, st: lm.verify_chunk_paged(
                    p, c, t_, pk1, pv1, tb, w_, st)[0], device=dev,
                    mempool=torch.cuda.graph_pool_handle())
                graph(*v_in)
            finally:
                moe_lib.moe_ffn_dropless = dropless
            verify_ms["ms_products_in_256_row_calls" if fixed else "ms"] = median_ms(
                lambda: graph(*v_in))
        phase("verify_step_ms", arch=c.name, compiled=True, lanes=LANES, depth=SPEC_DEPTH,
              **verify_ms)
        del graph, pk1, pv1
        torch.cuda.empty_cache()

    def moe_cell(c, p, compiled, *, residency=None, extra=(), force=None,
                 requests=16, gen=64) -> dict:
        """The serve cell (``requests`` x (PROMPT + ``gen``), 8 lanes,
        --prefill-chunk CHUNK, --max-len MAX_LEN, the prefix cache on)
        through serve's engine (``build_pool_engine``) on ``p``, driven by
        ``drive``; ``force`` (rid -> tokens) feeds those tokens in place of
        each sample (teacher forcing), the logits still recorded."""
        args = serve.build_parser().parse_args(
            ["--arch", c.name, "--requests", str(requests), "--batch", str(LANES),
             "--prompt-len", str(PROMPT), "--gen-len", str(gen), "--max-len", str(MAX_LEN),
             "--prefill-chunk", str(CHUNK), *extra])
        sched = serve.build_pool_engine(c, p, args, dev, residency, compiled=compiled)
        if force is not None:
            sched._sample_one = lambda req, row: force[req.rid][len(req.output)]
        r = drive(sched, [serve.make_requests(args, c.vocab)], gen)
        st = sched.stats
        r["metrics"].update(
            decode_steps=st.decode_steps, verify_steps=st.verify_steps,
            accepted_tokens=st.accepted_tokens, draft_tokens=st.draft_tokens,
            decode_step_ms=st.decode_time / max(1, st.decode_steps) * 1e3,
            decode_step_ms_replay=serve._replay_step_ms(sched, st),
            graph_pool_mib=sum(g.pool_bytes for g in sched.graphs) / 2**20,
            expert_tokens=st.expert_tokens, **sched.moe_gauges())
        r["requests"], r["gen"] = requests, gen
        del sched
        return r

    def check_moe_cell(label, c, r, compiled, streamed=0) -> None:
        """Every request done; prefill on flash_fwd's tensor-core route,
        n_layers launches a chunk or bucket; no packed_matmul (experts never
        pack, attention is plain matmuls), ``stream_matmul`` exactly 3 x
        ``streamed`` experts x decode steps; no backward kernel; the tally
        top_k x n_layers a token; compiled: every step but each graph's
        first a replay."""
        m, counts, by_route = r["metrics"], r["counts"], r["by_route"]
        if m["completed"] != r["requests"] or m["generated_tokens"] != r["requests"] * r["gen"]:
            fail(f"{label}: {m['completed']} completed, {m['generated_tokens']} tokens")
        want_stream = 3 * streamed * m["decode_steps"]
        if (counts["packed_matmul"] or counts["stream_matmul"] != want_stream
                or counts["flash_fwd"] != c.n_layers * m["prefill_steps"]
                or by_route.get("flash_fwd", {}).keys() != {"mma"}
                or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]):
            fail(f"{label}: launches {counts} by route {by_route}; want stream_matmul "
                 f"3 x {streamed} x {m['decode_steps']} = {want_stream}, flash_fwd "
                 f"{c.n_layers} x {m['prefill_steps']} prefill steps, no packed_matmul")
        if m["expert_tokens"] % (c.experts_per_token * c.n_layers) or not m["expert_tokens"]:
            fail(f"{label}: {m['expert_tokens']} routed slots")
        if compiled and not (m["compiled"] and m["graphs"] >= 2):
            fail(f"{label}: compiled {m['compiled']}, {m['graphs']} graphs")

    def count_main_path(r) -> None:
        for name, n in r["counts"].items():
            launches[name] += n
        add_routes(r["by_route"])

    hybrid_launches = {}  # the hybrid phase's share of ``launches``, by route

    def count_hybrid(r) -> None:
        count_main_path(r)
        for name, by in r["by_route"].items():
            for route, n in by.items():
                hybrid_launches.setdefault(name, {})
                hybrid_launches[name][route] = hybrid_launches[name].get(route, 0) + n

    def top_gap(top: dict) -> float:
        a, b = sorted(top.values(), reverse=True)[:2]
        return a - b

    def forced_vs(forced, plain) -> dict:
        """Teacher-forced logits (``forced``'s TOP_LOGITS per position)
        against ``plain``'s at every sampled position: the largest |logit
        difference| over the ids both keep, the largest shift of plain's
        top-1 / top-2 gap, the positions whose argmax agrees, and plain's
        largest |logit|."""
        diff = shift = scale = 0.0
        agree = n = 0
        for key, want in plain["top_logits"].items():
            got = forced["top_logits"][key]
            diff = max(diff, max((abs(got[i] - want[i]) for i in want if i in got), default=0.0))
            t1, t2 = sorted(want, key=want.get, reverse=True)[:2]
            if t2 in got and t1 in got:
                shift = max(shift, abs((got[t1] - got[t2]) - (want[t1] - want[t2])))
            agree += max(got, key=got.get) == t1
            n += 1
            scale = max(scale, max(abs(v) for v in want.values()))
        return dict(max_abs_logit_diff=diff, max_top1_top2_gap_shift=shift, argmax_agree=agree,
                    positions=n, max_abs_logit=scale)

    def partings(run, plain) -> list[dict]:
        """The streams of ``run`` that part from ``plain``'s: where, and
        plain's top-1 / top-2 gap there."""
        out = []
        for rid, toks in run["outputs"].items():
            want = plain["outputs"][rid]
            j = next((i for i, (x, y) in enumerate(zip(toks, want)) if x != y), None)
            if j is not None:
                out.append(dict(rid=rid, position=j,
                                plain_gap=top_gap(plain["top_logits"][rid, j])))
        return out

    def moe_budget(c, p, plain) -> None:
        """(e) The serve cell compiled at half the plan's expert tile bytes:
        its cold experts stream through stream_matmul, exactly 3 x streamed
        experts x decode steps launches; teacher-forced with the unbudgeted
        (d) run's tokens, the logits within MOE_BUDGET_LOGIT_STEPS bf16 steps
        and the argmax the same at SPEC_MIN_ARGMAX_SHARE of the positions;
        run free, every stream that parts does so where the unbudgeted top-1
        / top-2 gap lies within the forced run's largest shift of it."""
        from repro_torch.runtime.residency import compile_residency_plan

        full = compile_residency_plan(c, vmem_budget_bytes=0)
        total = sum(full.bin_tiles) * full.chip.tile_bytes
        plan = compile_residency_plan(c, vmem_budget_bytes=total // 2)
        mask = np.asarray(plan.expert_stream_mask(c), bool)
        if not (mask.any() and not mask.all()) or plan.stream_mask(c) != plan.expert_stream_mask(c):
            fail(f"{c.name}: the half-budget plan does not split the experts "
                 f"({int(mask.sum())} of {mask.size} streamed)")
        streamed = int(mask.sum())
        t0 = time.monotonic()
        compile_residency_plan(c, vmem_budget_bytes=total // 2)
        plan_s = time.monotonic() - t0
        free = moe_cell(c, p, True, residency=plan)
        check_moe_cell(f"{c.name} budgeted", c, free, True, streamed)
        count_main_path(free)
        forced = moe_cell(c, p, True, residency=plan, force=plain["outputs"])
        check_moe_cell(f"{c.name} budgeted, teacher-forced", c, forced, True, streamed)
        fv = forced_vs(forced, plain)
        step = 2.0 ** (math.floor(math.log2(fv["max_abs_logit"])) - 7)
        parted = partings(free, plain)
        phase("moe_budgeted", arch=c.name, plan=plan.summary(), plan_blocks=len(plan.blocks),
              compile_plan_s=plan_s, streamed_experts=streamed, experts=mask.size,
              stream_ahead=plan.stream_ahead, forced=fv, bf16_step=step,
              bound=MOE_BUDGET_LOGIT_STEPS * step, streams_parted=len(parted),
              partings=parted[:8], launches_counted=free["counts"], **free["metrics"])
        if not (fv["max_abs_logit_diff"] <= MOE_BUDGET_LOGIT_STEPS * step
                and fv["argmax_agree"] >= SPEC_MIN_ARGMAX_SHARE * fv["positions"]):
            fail(f"{c.name} budgeted vs unbudgeted, teacher-forced: {fv}")
        if any(x["plain_gap"] > fv["max_top1_top2_gap_shift"] for x in parted):
            fail(f"{c.name} budgeted: a stream parts away from a near-tie: {parted[:4]}")

    def products_whose_rows_follow_m(c, p, s_len, row_counts) -> list[str]:
        """The router's and four experts' f32 products as a prefill runs them
        (``fixed_rows``) on ``s_len`` random rows: those whose first m rows
        come out other bits from an m-row call (each of ``row_counts``) or
        from the rows padded to CHUNK."""
        lp0 = p.layer(0)
        xh = torch.randn((s_len, c.d_model), generator=torch.Generator(device=dev).manual_seed(9),
                         device=dev)
        padded = torch.cat([xh, xh.new_zeros((CHUNK - s_len, c.d_model))])
        fns = {f"expert {e}": lambda t, w=(lp0["w1"][e], lp0["w3"][e], lp0["w2"][e]):
               moe_lib._resident(t, *w, fixed_rows=True) for e in range(4)}
        fns["router"] = lambda t: moe_lib._token_gates(t[None], lp0["router"], c, True)[1][0]
        off = []
        for name, fn in fns.items():
            y = fn(xh)
            if not (all(same_bits(fn(xh[:m]), y[:m]) for m in row_counts)
                    and same_bits(fn(padded)[:s_len], y)):
                off.append(name)
        return off

    def moe_shared_prefix(c, p) -> None:
        """(f) Phase 5 (b)'s shared-prefix traffic with the cache and
        without: identical tokens and every sampled position's logits row
        bitwise equal; a prompt's K rows the same bits from a prefill of its
        first half and of all of it; the router's and an expert's f32
        products give a row the same bits at half the rows and padded to
        CHUNK (a prefill runs each in 256-row calls)."""
        from repro_torch.runtime.kv_pool import KVPool
        from repro_torch.runtime.prefix_cache import PrefixCache
        from repro_torch.runtime.scheduler import Scheduler

        waves = session_waves(c.vocab)
        runs = {}
        for cached in (False, True):
            pool = KVPool.for_slots(c, slots=LANES, max_len=SESSION_MAX_LEN, block_tokens=16,
                                    device=dev)
            sched = Scheduler(c, p, pool, slots=LANES, max_len=SESSION_MAX_LEN,
                              prefill_chunk=CHUNK,
                              prefix_cache=PrefixCache(pool) if cached else None)
            r = drive(sched, waves, SESSION_GEN)
            r["metrics"]["expert_tokens"] = sched.stats.expert_tokens
            del sched, pool
            phase("serve_shared_prefix", arch=c.name, cached=cached, launches_counted=r["counts"],
                  launches_by_route=r["by_route"], **r["metrics"])
            count_main_path(r)
            runs[cached] = r
        warm, cold = runs[True], runs[False]
        rows_off = sorted(key for key in cold["digests"]
                          if warm["digests"].get(key) != cold["digests"][key])
        cut = 1.0 - warm["metrics"]["prefill_tokens"] / max(1, cold["metrics"]["prefill_tokens"])
        prompt = torch.from_numpy(waves[1][0][None]).to(dev)
        _, k_half, _, _ = lm.prefill_with_cache(p, c, prompt[:, :TURN_TOKENS], TURN_TOKENS - 1)
        _, k_all, _, _ = lm.prefill_with_cache(p, c, prompt, prompt.shape[1] - 1)
        k_off = [i for i in range(c.n_layers)
                 if not same_bits(k_half[i], k_all[i][:, :TURN_TOKENS])]
        s_len = prompt.shape[1]
        products_off = products_whose_rows_follow_m(c, p, s_len, (s_len // 2,))
        phase("serve_shared_prefix_cache_vs_none", arch=c.name,
              token_streams_identical=warm["outputs"] == cold["outputs"],
              positions=len(cold["digests"]), positions_whose_logits_differ=len(rows_off),
              layers_whose_k_rows_differ=k_off, f32_products_whose_rows_follow_m=products_off,
              prefill_token_cut=cut, **{f"{key}_{side}": r["metrics"][key] for key in (
                  "prefill_tokens", "mean_ttft_s", "tokens_per_s", "prefix_hit_rate",
                  "cow_copies", "shared_blocks_peak", "graphs", "expert_tokens")
                  for side, r in (("cache", warm), ("no_cache", cold))})
        if (warm["outputs"] != cold["outputs"] or rows_off or k_off or products_off
                or cut < PREFIX_MIN_CUT or not warm["metrics"]["shared_blocks_peak"]):
            fail(f"{c.name} shared prefix: cached and uncached differ: {len(rows_off)} logits "
                 f"rows, K rows at layers {k_off}, products {products_off}, cut {cut}")

    def moe_short_prefix(c, p) -> None:
        """(f) A prompt of one 16-token block (a 16-row bucket prefill),
        then a prompt that extends it by TURN_TOKENS, served compiled with
        the cache and without: the second adopts the first's block, and
        the streams and every sampled position's logits row are bitwise
        equal; the block's K rows the same bits from the 16-token prefill
        and from the longer one's; the router's and four experts' f32
        products give a 16-row call's rows the bits of the longer call's."""
        from repro_torch.runtime.kv_pool import KVPool
        from repro_torch.runtime.prefix_cache import PrefixCache
        from repro_torch.runtime.scheduler import Scheduler

        long = np.random.default_rng(8).integers(0, c.vocab, 16 + TURN_TOKENS).astype(np.int32)
        waves = [[long[:16]], [long]]
        runs = {}
        for cached in (False, True):
            pool = KVPool.for_slots(c, slots=LANES, max_len=SESSION_MAX_LEN, block_tokens=16,
                                    device=dev)
            sched = Scheduler(c, p, pool, slots=LANES, max_len=SESSION_MAX_LEN,
                              prefill_chunk=CHUNK,
                              prefix_cache=PrefixCache(pool) if cached else None)
            runs[cached] = drive(sched, waves, SHORT_PREFIX_GEN)
            del sched, pool
        warm, cold = runs[True], runs[False]
        rows_off = sorted(key for key in cold["digests"]
                          if warm["digests"].get(key) != cold["digests"][key])
        prompt = torch.from_numpy(long[None]).to(dev)
        _, k16, _, _ = lm.prefill_with_cache(p, c, prompt[:, :16], 15)
        _, k_all, _, _ = lm.prefill_with_cache(p, c, prompt, prompt.shape[1] - 1)
        k_off = [i for i in range(c.n_layers) if not same_bits(k16[i], k_all[i][:, :16])]
        products_off = products_whose_rows_follow_m(c, p, prompt.shape[1], (16,))
        hit = warm["metrics"]["prefix_hit_tokens"]
        phase("serve_short_prefix_cache_vs_none", arch=c.name, layers=c.n_layers,
              prompts=[16, len(long)], gen=SHORT_PREFIX_GEN,
              token_streams_identical=warm["outputs"] == cold["outputs"],
              positions=len(cold["digests"]), positions_whose_logits_differ=len(rows_off),
              prefix_hit_tokens=hit, layers_whose_k_rows_differ=k_off,
              f32_products_whose_rows_follow_m=products_off)
        if warm["outputs"] != cold["outputs"] or rows_off or k_off or products_off or hit < 16:
            fail(f"{c.name} short prefix: cached and uncached differ: {len(rows_off)} logits "
                 f"rows, K rows at layers {k_off}, products {products_off}, {hit} hit tokens")

    def moe_spec(c, p, plain) -> None:
        """(g) The n-gram drafter at --spec-depth SPEC_DEPTH on the cell's
        first MOE_SPEC_REQUESTS prompts, eager and compiled: identical
        tokens and launches; every stream that parts from plain compiled
        decode does so at a near-tie (plain's top-1 / top-2 gap within the
        gate's largest shift of it). The gate, phase 5 (c)'s: on a pool prefilled
        with 8 random (PROMPT + 8)-token prompts, one verify step of
        SPEC_DEPTH tokens on 8 lanes against the same tokens through
        SPEC_DEPTH decode steps, the logits within SPEC_LOGIT_STEPS bf16
        steps and the argmax the same at SPEC_MIN_ARGMAX_SHARE."""
        depth0 = PROMPT + 8
        rows0 = (c.n_layers, LANES * MAX_LEN + 16, c.n_kv, c.hd)
        pk0 = torch.zeros(rows0, dtype=torch.bfloat16, device=dev)
        pv0 = torch.zeros_like(pk0)
        table = (16 + torch.arange(LANES * MAX_LEN, device=dev)).reshape(LANES, MAX_LEN)
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, c.vocab, (LANES, depth0 + LANES))).to(dev)
        _, ks, vs, _ = lm.prefill_with_cache(p, c, prompts, depth0 - 1)
        rows = table[:, :depth0 + LANES].reshape(-1)
        pk0.index_copy_(1, rows, ks.flatten(1, 2))
        pv0.index_copy_(1, rows, vs.flatten(1, 2))
        del ks, vs
        starts = depth0 + torch.arange(LANES, device=dev)
        toks = torch.from_numpy(np.random.default_rng(6).integers(
            0, c.vocab, (LANES, SPEC_DEPTH))).to(dev)
        wr = torch.stack([table[i, s:s + SPEC_DEPTH] for i, s in enumerate(starts.tolist())])
        lg_v = lm.verify_chunk_paged(p, c, toks, pk0.clone(), pv0.clone(), table, wr,
                                     starts)[0][..., :c.vocab].float()
        kd, vd = pk0.clone(), pv0.clone()
        lg_d = torch.stack([lm.decode_step_paged(p, c, toks[:, j:j + 1], kd, vd, table,
                                                 starts + j)[0][:, 0, :c.vocab].float()
                            for j in range(SPEC_DEPTH)], 1)
        del pk0, pv0, kd, vd
        got, want = lg_v.flatten(0, 1), lg_d.flatten(0, 1)
        top2 = torch.topk(want, 2, dim=-1).indices
        gg, ww = got.gather(1, top2), want.gather(1, top2)
        shift = ((gg[:, 0] - gg[:, 1]) - (ww[:, 0] - ww[:, 1])).abs().max().item()
        diff = (got - want).abs().max().item()
        agree = int((got.argmax(-1) == want.argmax(-1)).sum())
        scale = want.abs().max().item()
        step = 2.0 ** (math.floor(math.log2(scale)) - 7)
        n = LANES * SPEC_DEPTH
        gate = dict(max_abs_logit=scale, bf16_step=step, max_abs_logit_diff=diff,
                    max_top1_top2_gap_shift=shift, max_abs_logit_diff_steps=diff / step,
                    argmax_agree=agree, positions=n,
                    within_gate=(diff <= SPEC_LOGIT_STEPS * step
                                 and shift <= SPEC_LOGIT_STEPS * step
                                 and agree >= SPEC_MIN_ARGMAX_SHARE * n))
        extra = ("--speculate", "ngram", "--spec-depth", str(SPEC_DEPTH))
        spec = {compiled: moe_cell(c, p, compiled, extra=extra, requests=MOE_SPEC_REQUESTS,
                                   gen=MOE_SPEC_GEN) for compiled in (False, True)}
        for compiled, r in spec.items():
            check_moe_cell(f"{c.name} n-gram ({'compiled' if compiled else 'eager'})", c, r,
                           compiled)
        count_main_path(spec[True])
        same_tokens = spec[True]["outputs"] == spec[False]["outputs"]
        same_launches = ((spec[True]["counts"], spec[True]["by_route"])
                         == (spec[False]["counts"], spec[False]["by_route"]))
        plain_part = {"outputs": {rid: t[:MOE_SPEC_GEN] for rid, t in plain["outputs"].items()
                                  if rid < MOE_SPEC_REQUESTS},
                      "top_logits": plain["top_logits"]}
        parted = partings(spec[True], plain_part)
        phase("moe_spec", arch=c.name, drafter="ngram", depth=SPEC_DEPTH, gate=gate,
              token_streams_identical=same_tokens, launch_counts_identical=same_launches,
              streams_equal_to_plain=MOE_SPEC_REQUESTS - len(parted), partings=parted[:8],
              launches_counted=spec[True]["counts"],
              **{f"{key}_{'compiled' if cc else 'eager'}": spec[cc]["metrics"][key]
                 for key in ("tokens_per_s", "mean_ttft_s", "verify_steps", "accepted_tokens",
                             "graphs", "wall_s") for cc in (False, True)})
        if not gate["within_gate"]:
            fail(f"{c.name} verify vs decode outside the gate: {gate}")
        if not (same_tokens and same_launches):
            fail(f"{c.name} n-gram: compiled and eager differ (tokens {same_tokens}, launches "
                 f"{same_launches})")
        if any(x["plain_gap"] > shift for x in parted):
            fail(f"{c.name} n-gram: a stream parts from plain decode away from a near-tie: "
                 f"{parted[:4]}")

    def moe_tf32_scan() -> list[str]:
        """The port's files that set TF32 or the f32 matmul precision."""
        return sorted(str(f.relative_to(opts.src)) for f in (opts.src / "repro_torch").rglob("*.py")
                      if re.search(r"allow_tf32\s*=|set_float32_matmul_precision\(",
                                   f.read_text()))

    def first_layers(c, p, n):
        """``c`` and ``p`` cut to their first ``n`` layers (views)."""
        tree = p.tree()
        tree["layers"] = {name: ({k: v[:n] for k, v in leaf.items()} if isinstance(leaf, dict)
                                 else leaf[:n]) for name, leaf in tree["layers"].items()}
        return dataclasses.replace(c, n_layers=n), lm.LMParams(tree)

    def moe_served_config():
        return dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)

    def moe_phase() -> None:
        """The MoE phase (the module docstring says what it holds)."""
        t_phase = time.monotonic()
        full = moe_served_config()
        params, init = timed_init(full)
        prefetch_after(MOE_ARCH)
        phase("init", arch=MOE_ARCH, layers=full.n_layers, depth_cut=(
            f"{full.n_layers} of 16 layers at full width: the run's time limit"), **init)
        moe_layers_vs_cpu(*first_layers(full, params, MOE_CHECK_LAYERS))
        moe_graphs(full, params)
        # (d) the serve cell, eager then compiled; the compiled run under the
        # process's own f32 matmul settings, which the port must not change
        eager = moe_cell(full, params, False)
        check_moe_cell(f"{MOE_ARCH} eager", full, eager, False)
        torch.backends.cuda.matmul.allow_tf32 = tf32_default[0]
        torch.set_float32_matmul_precision(tf32_default[1])
        compiled = moe_cell(full, params, True)
        tf32_after = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        check_moe_cell(f"{MOE_ARCH} compiled", full, compiled, True)
        count_main_path(compiled)
        tf32_files = moe_tf32_scan()
        same_tokens = compiled["outputs"] == eager["outputs"]
        same_launches = ((compiled["counts"], compiled["by_route"])
                         == (eager["counts"], eager["by_route"]))
        for mode, r in (("eager", eager), ("compiled", compiled)):
            phase("serve", arch=MOE_ARCH, mode=mode, init_s=init["init_s"],
                  launches_counted=r["counts"], launches_by_route=r["by_route"], **r["metrics"])
        phase("serve_compiled_vs_eager", arch=MOE_ARCH, token_streams_identical=same_tokens,
              launch_counts_identical=same_launches, tf32_process_default=tf32_default,
              tf32_after_serve=tf32_after, port_files_setting_tf32=tf32_files)
        if not (same_tokens and same_launches):
            fail(f"{MOE_ARCH}: compiled and eager serving differ (tokens {same_tokens}, "
                 f"launches {same_launches})")
        if tf32_default != (False, "highest") or tf32_after != tf32_default or tf32_files:
            fail(f"{MOE_ARCH}: f32 matmuls not in full f32: default {tf32_default}, after "
                 f"serving {tf32_after}, set in {tf32_files}")
        moe_budget(full, params, compiled)
        moe_shared_prefix(full, params)
        moe_short_prefix(full, params)
        moe_spec(full, params, compiled)
        # (i) the fixed-batch engine: its decode step (the capacity dispatch
        # over groups of one token) captured, FIXED_REPLAYS replays bitwise
        # the eager step, every cache leaf included; one wave of the fixed
        # cell eager and compiled: identical tokens and launches (none)
        cache0 = random_cache(full, LANES, FIXED_MAX_LEN, FIXED_PROMPT, seed=9)
        hold_cache_replay(f"{MOE_ARCH} fixed decode step", full, params, cache0)
        del cache0
        fixed_cell(f"serve {MOE_ARCH} --engine fixed", full, params, lambda steps: {},
                   *MOE_FIXED)
        if not opts.only:
            held[MOE_ARCH] = kept_layers(full, params, TF_MOE_LAYERS)
        del params
        torch.cuda.empty_cache()
        phase_seconds(f"moe {MOE_ARCH}")
        # (h) moonshot: the prefill check at MOE_CHECK_LAYERS layers, then the
        # compiled serve cell at MOON_LAYERS of its 48
        moon = get_config(MOON_ARCH)
        m8 = dataclasses.replace(moon, n_layers=MOON_LAYERS)
        p8, init8 = timed_init(m8)
        phase("init", arch=MOON_ARCH, layers=MOON_LAYERS, depth_cut=f"{MOON_LAYERS} of "
              f"{moon.n_layers} layers: a full draw takes ~200 s on the host", **init8)
        moe_layers_vs_cpu(*first_layers(m8, p8, MOE_CHECK_LAYERS))
        moe_short_prefix(m8, p8)
        from repro_torch.runtime.residency import compile_residency_plan

        t0 = time.monotonic()
        moon_plan = compile_residency_plan(moon, vmem_budget_bytes=0)
        phase("residency_plan", arch=MOON_ARCH, layers=moon.n_layers,
              blocks=len(moon_plan.blocks), compile_s=time.monotonic() - t0)
        r = moe_cell(m8, p8, True)
        check_moe_cell(f"{MOON_ARCH} compiled", m8, r, True)
        count_main_path(r)
        phase("serve", arch=MOON_ARCH, layers=MOON_LAYERS, mode="compiled",
              init_s=init8["init_s"], launches_counted=r["counts"],
              launches_by_route=r["by_route"], **r["metrics"])
        del p8
        torch.cuda.empty_cache()
        phase_seconds(f"moe {MOON_ARCH} at depth {MOON_LAYERS}")
        phase("moe_phase", seconds=time.monotonic() - t_phase)

    # ---------------- the hybrid family (--only hybrid: alone) ----------------
    def lane_vs_cpu(a, b) -> dict:
        """A lane state from the card against the CPU's (float32), leaf by
        leaf over the layers: the largest relative error ||a - b|| / ||b||
        of a layer's slice and the smallest cosine."""
        out = {}
        for key in lm.LANE_KEYS:
            x = a[key].float().cpu().reshape(a[key].shape[0], -1)
            y = b[key].float().reshape(b[key].shape[0], -1)
            out[key] = dict(
                max_rel_err=((x - y).norm(dim=1) / y.norm(dim=1).clamp_min(1e-30)).max().item(),
                min_cosine=F.cosine_similarity(x, y, dim=1).min().item())
        return out

    def rows_vs_cpu(a, b) -> dict:
        """K/V rows from the card against the CPU's: relative error and cosine."""
        x, y = a.float().cpu().flatten(), b.float().flatten()
        return dict(rel_err=((x - y).norm() / y.norm()).item(),
                    cosine=F.cosine_similarity(x, y, dim=0).item())

    def hybrid_vs_cpu(c, p) -> None:
        """(b) One super-block at full width (``c``: hybrid_attn_every SSM
        layers and the shared block) in bf16 on the card against float32 on
        the CPU, same weights: a CHUNK-token whole-prompt prefill, the next
        CHUNK tokens as a suffix resumed from the carried lane state at
        start CHUNK (a device tensor), then HYB_DECODE_STEPS greedy decode
        steps (the card's tokens fed to both sides). Logits by
        ``logits_vs_cpu``; K/V rows by relative error and cosine (within
        HYB_KV_REL_TOL); the lane state after each stage, leaf by leaf
        (within HYB_LANE_REL_TOL, cosine >= HYB_LANE_MIN_COS)."""
        cpu_c, cpu_p = cpu_copy(c, p)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(0, c.vocab, size=(1, PROMPT)))
        rows = PROMPT + HYB_DECODE_STEPS
        fed = []
        out = {}
        for name, (sc, sp, sd) in (("card", (c, p, dev)), ("cpu", (cpu_c, cpu_p, "cpu"))):
            t0 = time.monotonic()
            rec = {}
            lg, ks, vs, lane = lm.prefill_with_cache_hybrid(
                sp, sc, tokens[:, :CHUNK].to(sd), CHUNK - 1)
            rec["prefill"] = (lg[0, 0, :c.vocab], torch.cat([ks, vs]),
                              {k: v.clone() for k, v in lane.items()})
            pk = torch.zeros((sc.n_kv_cache_layers, rows + 16, sc.n_kv, sc.hd),
                             dtype=lm.torch_dtype(sc), device=sd)
            pv = torch.zeros_like(pk)
            pk[:, 16:16 + CHUNK], pv[:, 16:16 + CHUNK] = ks[:, 0], vs[:, 0]
            table = (16 + torch.arange(rows, device=sd))[None]
            lg, _, _, lane = lm.prefill_suffix_paged_hybrid(
                sp, sc, tokens[:, CHUNK:].to(sd), pk, pv, table, table[:, CHUNK:PROMPT],
                torch.tensor([CHUNK], device=sd), CHUNK - 1, lane)
            rec["suffix"] = (lg[0, 0, :c.vocab],
                             torch.cat([pk[:, 16 + CHUNK:16 + PROMPT], pv[:, 16 + CHUNK:16 + PROMPT]]),
                             {k: v.clone() for k, v in lane.items()})
            steps = []
            for i in range(HYB_DECODE_STEPS):
                if name == "card":
                    fed.append(int((steps[-1] if steps else rec["suffix"][0]).argmax()))
                tok = torch.tensor([[fed[i]]], device=sd)
                lg, _, _, lane = lm.decode_step_paged_hybrid(
                    sp, sc, tok, pk, pv, table, torch.tensor([PROMPT + i], device=sd), lane)
                steps.append(lg[0, 0, :c.vocab])
            rec["decode"] = (steps, {k: v.clone() for k, v in lane.items()})
            if name == "card":
                torch.cuda.synchronize()
            rec["s"] = time.monotonic() - t0
            out[name] = rec
        card, cpu = out["card"], out["cpu"]
        held = {stage: dict(logits=logits_vs_cpu(card[stage][0], cpu[stage][0],
                                                 f"{c.name} {stage}"),
                            kv_rows=rows_vs_cpu(card[stage][1], cpu[stage][1]),
                            lane=lane_vs_cpu(card[stage][2], cpu[stage][2]))
                for stage in ("prefill", "suffix")}
        held["decode"] = dict(
            logits=[logits_vs_cpu(a, b, f"{c.name} decode step {i}", step=i)
                    for i, (a, b) in enumerate(zip(card["decode"][0], cpu["decode"][0]))],
            lane=lane_vs_cpu(card["decode"][1], cpu["decode"][1]))
        phase("hybrid_vs_cpu", arch=c.name, layers=c.n_layers, depth_cut=(
            f"{c.n_layers} of {get_config(HYB_ARCH).n_layers} layers (one super-block): the "
            "CPU's float32 side stays in seconds"), prompt=PROMPT, chunk=CHUNK,
            decode_steps=HYB_DECODE_STEPS, card_s=card["s"], cpu_s=cpu["s"], **held)
        lanes = [held[s]["lane"] for s in ("prefill", "suffix")] + [held["decode"]["lane"]]
        bad = [(s, k, v) for s, lane in zip(("prefill", "suffix", "decode"), lanes)
               for k, v in lane.items()
               if not (v["max_rel_err"] <= HYB_LANE_REL_TOL and v["min_cosine"] >= HYB_LANE_MIN_COS)]
        bad += [(s, "kv_rows", held[s]["kv_rows"]) for s in ("prefill", "suffix")
                if not held[s]["kv_rows"]["rel_err"] <= HYB_KV_REL_TOL]
        if bad:
            fail(f"{c.name} card vs CPU: {bad[:4]}")

    def hold_lane_replay(label, step_fn, host_in, pk0, pv0, lane0, replay_in=None) -> None:
        """``hold_replay`` for a hybrid step ``step_fn(pool_k, pool_v, lane,
        *inputs) -> logits``: its first call and capture on copies of the
        pools and of the lane state ``lane0``, then each replay from the
        same state against the eager step on other copies; the logits, both
        pools and every lane-state leaf bitwise equal."""
        kg, vg = pk0.clone(), pv0.clone()
        lane_g = {k: v.clone() for k, v in lane0.items()}
        graph = CapturedStep(lambda *xs: step_fn(kg, vg, lane_g, *xs), device=dev,
                             mempool=torch.cuda.graph_pool_handle())
        graph(*host_in)
        for i, inputs in enumerate(replay_in or (host_in,)):
            ke, ve = pk0.clone(), pv0.clone()
            lane_e = {k: v.clone() for k, v in lane0.items()}
            lg_e = step_fn(ke, ve, lane_e, *(t.to(dev) for t in inputs))
            kg.copy_(pk0)
            vg.copy_(pv0)
            for k, v in lane0.items():
                lane_g[k].copy_(v)
            lg_r = graph(*inputs)
            replay_matches(label, i, graph.replays, i + 1, {
                "logits": (lg_r, lg_e), "pool_k": (kg, ke), "pool_v": (vg, ve),
                **{f"lane_{k}": (lane_g[k], lane_e[k]) for k in lm.LANE_KEYS}})
            del ke, ve, lane_e
        del graph, kg, vg, lane_g

    def ssm_blocks(p, c, x, lane):
        """The Mamba2 blocks of a hybrid step alone, on its lane state."""
        for i in range(c.n_layers):
            state, bufs = lm._lane_views(lane, i)
            x, state, bufs = lm._ssm_block(p.layer(i), c, x, state=state, conv_bufs=bufs)
            lm._store_lane(lane, i, state, bufs)
        return x

    def hybrid_profile(label, p, c, step_fn, host_in, lane, pk, pv) -> dict:
        """A compiled hybrid step (``step_fn(pool_k, pool_v, lane, *inputs)``)
        profiled (``profile_window``, one step a window: ~4k kernels), and
        the SSM blocks' share of its card time: a graph of the step's
        Mamba2 blocks alone (``ssm_blocks`` on the step's embedded tokens)
        against the step's graph, both by CUDA events (median of REPS)."""
        graph = CapturedStep(lambda *xs: step_fn(pk, pv, lane, *xs), device=dev,
                             mempool=torch.cuda.graph_pool_handle())
        ssm = CapturedStep(
            lambda t_, *_: ssm_blocks(p, c, lm.embed(t_, p["embed"], lm.torch_dtype(c)), lane),
            device=dev, mempool=torch.cuda.graph_pool_handle())
        graph(*host_in)
        ssm(*host_in)
        stats, by_name = profile_window(lambda: graph(*host_in), window=1)
        step_ms = median_ms(lambda: graph(*host_in))
        ssm_ms = median_ms(lambda: ssm(*host_in))
        out = dict(case=label, compiled=True, **stats, event_median_ms=step_ms,
                   ssm_blocks_ms=ssm_ms, ssm_share=ssm_ms / step_ms,
                   capture_s=graph.capture_s, graph_pool_mib=graph.pool_bytes / 2**20,
                   device_ms_by_kernel=dict(
                       flash_fwd=sum(v for k, v in by_name.items() if "flash_fwd" in k),
                       packed_matmul=sum(v for k, v in by_name.items() if any(
                           n in k for n in ("mma_kernel<", "tiled_kernel<", "gemv_kernel<")))),
                   top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))
        del graph, ssm
        return out

    def hybrid_graphs(c, p) -> None:
        """(d) The decode step (8 lanes at depth PROMPT + 8) and the full-width
        suffix chunk (CHUNK tokens at start CHUNK over MAX_LEN rows, lane state
        carried) as ``CapturedStep``s at full size, each replay bitwise its
        eager step, lane state included (the chunk graph also at start 37:
        its start is a device input); then each profiled."""
        rows = LANES * MAX_LEN + 16
        g = torch.Generator(device=dev).manual_seed(4)
        pk0 = torch.randn((c.n_kv_cache_layers, rows, c.n_kv, c.hd), generator=g, device=dev,
                          dtype=torch.bfloat16)
        pv0 = torch.randn(pk0.shape, generator=g, device=dev, dtype=torch.bfloat16)
        lane0 = {k: (0.5 * torch.randn(v.shape, generator=g, device=dev)).to(v.dtype)
                 for k, v in lm.init_ssm_lane_state(c, LANES, dev).items()}
        table = (16 + torch.arange(LANES * MAX_LEN)).reshape(LANES, MAX_LEN)
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, c.vocab, (LANES, 1)))
        decode_in = (tok, table, torch.full((LANES,), PROMPT + 8))

        def decode_fn(k_, v_, lane_, t_, tb, ln):
            return lm.decode_step_paged_hybrid(p, c, t_, k_, v_, tb, ln, lane_)[0]

        hold_lane_replay(f"{c.name} decode step, --quant {c.w_bits}", decode_fn, decode_in,
                         pk0, pv0, lane0)
        chunk = torch.from_numpy(np.random.default_rng(2).integers(0, c.vocab, size=(1, CHUNK)))
        one = table[:1]
        lane1 = {k: v[:, :1].contiguous() for k, v in lane0.items()}

        def chunk_in_at(start):
            return (chunk, one, one[:, start:start + CHUNK], torch.tensor([start]),
                    torch.tensor([CHUNK - 1]))

        def chunk_fn(k_, v_, lane_, t_, rt, wr, st, last):
            return lm.prefill_suffix_paged_hybrid(p, c, t_, k_, v_, rt, wr, st, last, lane_)[0]

        hold_lane_replay(f"{c.name} suffix chunk, --quant {c.w_bits}", chunk_fn,
                         chunk_in_at(CHUNK), pk0, pv0, lane1,
                         replay_in=[chunk_in_at(s) for s in (CHUNK, 37)])
        phase("decode_profile", arch=c.name, lanes=LANES, depth=PROMPT + 8, **hybrid_profile(
            "decode step", p, c, decode_fn, decode_in, lane0, pk0, pv0))
        phase("prefill_profile", arch=c.name, chunk=CHUNK, start=CHUNK, pool_rows=MAX_LEN,
              **hybrid_profile("suffix chunk", p, c, chunk_fn, chunk_in_at(CHUNK), lane1,
                               pk0, pv0))
        # a prompt of prime length past ssm_chunk: the reference's chunk rule
        # gives chunks of one token (a host loop of S steps a layer), beside a
        # CHUNK-token prompt, whole-prompt prefills at full depth
        times = {}
        for s_len in (CHUNK, HYB_PRIME):
            tok_s = torch.from_numpy(np.random.default_rng(s_len).integers(0, c.vocab, (1, s_len)))
            fn = lambda: lm.prefill_with_cache_hybrid(p, c, tok_s.to(dev), s_len - 1)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            fn()
            torch.cuda.synchronize()
            times[s_len] = (time.monotonic() - t0) * 1e3
        from repro_torch.models import ssm as ssm_lib

        phase("hybrid_prime_prompt", arch=c.name, prompts=list(times),
              ssd_chunk={s: ssm_lib.chunk_len(s, c.ssm_chunk) for s in times},
              host_ms_to_card_finish={str(s): t for s, t in times.items()})
        del pk0, pv0, lane0, lane1
        torch.cuda.empty_cache()

    def hybrid_cell(c, p, compiled, requests=16) -> dict:
        """(e) The serve cell (``requests`` x (PROMPT + 64), 8 lanes,
        --prefill-chunk CHUNK, --max-len MAX_LEN, the prefix cache on)
        through serve's engine on ``p``, driven by ``drive``."""
        args = serve.build_parser().parse_args(
            ["--arch", c.name, "--requests", str(requests), "--batch", str(LANES),
             "--prompt-len", str(PROMPT), "--gen-len", "64", "--max-len", str(MAX_LEN),
             "--prefill-chunk", str(CHUNK)])
        sched = serve.build_pool_engine(c, p, args, dev, compiled=compiled)
        r = drive(sched, [serve.make_requests(args, c.vocab)], 64)
        st = sched.stats
        r["metrics"].update(
            decode_steps=st.decode_steps,
            decode_step_ms=st.decode_time / max(1, st.decode_steps) * 1e3,
            decode_step_ms_replay=serve._replay_step_ms(sched, st),
            graph_replays=sum(g.replays for g in sched.graphs),
            graph_pool_mib=sum(g.pool_bytes for g in sched.graphs) / 2**20,
            hybrid=serve._hybrid_metrics(sched))
        r["requests"] = requests
        del sched
        return r

    def check_hybrid_cell(label, c, r, compiled) -> None:
        """Every request done; every prefill a full-width chunk (two a
        prompt); flash_fwd n_super a chunk on its tensor-core route;
        packed_matmul 3 n_super a step at 1/2 bits (chunks on the mma path,
        decode on the GEMV), none at 0; no other kernel; compiled: the decode
        and chunk graphs, every other step a replay."""
        m, counts, by_route = r["metrics"], r["counts"], r["by_route"]
        n_super = c.n_kv_cache_layers
        if m["completed"] != r["requests"] or m["generated_tokens"] != 64 * r["requests"]:
            fail(f"{label}: {m['completed']} completed, {m['generated_tokens']} tokens")
        pf, dec = m["prefill_steps"], m["decode_steps"]
        want_pm = ({"mma": 3 * n_super * pf, "gemv": 3 * n_super * dec} if c.w_bits else {})
        if (pf != 2 * r["requests"] or m["whole_prompt_prefills"]
                or counts["flash_fwd"] != n_super * pf
                or by_route.get("flash_fwd", {}) != {"mma": n_super * pf}
                or by_route.get("packed_matmul", {}) != want_pm
                or counts["packed_matmul"] != sum(want_pm.values())
                or counts["stream_matmul"] or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]):
            fail(f"{label}: {pf} prefill steps, launches {counts} by route {by_route}; want "
                 f"flash_fwd {n_super} x chunks, packed_matmul {want_pm}")
        if compiled and not (m["graphs"] == 2 and m["graph_replays"] == pf + dec - 2):
            fail(f"{label}: {m['graphs']} graphs, {m['graph_replays']} replays of {pf + dec} "
                 "steps: want the decode and the chunk graph, every other step a replay")

    def hybrid_shared_prefix(c, p) -> None:
        """(f) Phase 5 (b)'s shared-prefix traffic at --quant 2, compiled:
        without the cache (the main path's uncached run), with it
        teacher-forced by the uncached run's tokens, without it over the
        cached run's partition (--prefill-chunk TURN_TOKENS, forced the
        same), and, for its first two turns, cached with every anchor's
        lane state zeroed (a planted control). Each run's prefill tokens,
        hit rate, TTFT, the anchors' host copies (ms each, MB) and the
        host's memory. The gate: the cached run's logits at every sampled
        position within HYB_WARM_LOGIT_STEPS bf16 steps (at the largest
        |logit|) of the uncached run's, the argmax the same at
        HYB_WARM_MIN_ARGMAX of them, and bitwise those of the uncached run
        over its own partition (so the difference is the partition's, not
        the cache's); the planted control must fail it; the prefill tokens
        cut by at least PREFIX_MIN_CUT."""
        from repro_torch.runtime.kv_pool import KVPool
        from repro_torch.runtime.prefix_cache import PrefixCache
        from repro_torch.runtime.scheduler import Scheduler

        waves = session_waves(c.vocab)

        def run(cached, force=None, plant=False, chunk=CHUNK, turns=TURNS) -> dict:
            pool = KVPool.for_slots(c, slots=LANES, max_len=SESSION_MAX_LEN, block_tokens=16,
                                    device=dev)
            cache = PrefixCache(pool) if cached else None
            sched = Scheduler(c, p, pool, slots=LANES, max_len=SESSION_MAX_LEN,
                              prefill_chunk=chunk, prefix_cache=cache)
            hits = set()
            adopt = pool.adopt_prefix

            def adopting(rid, *args):
                hits.add(rid)
                adopt(rid, *args)

            pool.adopt_prefix = adopting
            if plant:
                lookup = cache.lookup

                def zeroed(prompt, **kw):
                    m = lookup(prompt, **kw)
                    if m is not None:
                        m = dataclasses.replace(m, lane_state={
                            k: torch.zeros_like(v) for k, v in m.lane_state.items()})
                    return m

                cache.lookup = zeroed
            if force is not None:
                sched._sample_one = lambda req, row: force[req.rid][len(req.output)]
            rss0 = rss()
            r = drive(sched, waves[:turns], SESSION_GEN)
            anchors = ([a for n in (cache.root, *cache._nodes) for a in n.anchors]
                       if cache is not None else [])
            r["hits"] = hits
            r["metrics"].update(
                hybrid=serve._hybrid_metrics(sched), hit_requests=len(hits),
                prefill_chunk=chunk, anchors_cached_mib=sum(
                    v.nbytes for a in anchors for v in a.lane_state.values()) / 2**20,
                host_rss_mib_before=rss0 / 2**20, host_rss_mib_after=rss() / 2**20)
            del sched, pool, cache, anchors
            return r

        cold = run(False)
        warm = run(True, force=cold["outputs"])
        cold_own = run(False, force=cold["outputs"], chunk=TURN_TOKENS)
        planted = run(True, force=cold["outputs"], plant=True, turns=2)
        runs = (("no_cache", cold), ("cache_teacher_forced", warm),
                ("no_cache_at_the_cache_s_partition", cold_own),
                ("cache_planted_zero_lanes_two_turns", planted))
        for name, r in runs:
            phase("serve_shared_prefix", arch=c.name, run=name, sessions=SESSIONS,
                  turns=len({k[0] for k in r["digests"]}) // (2 * SESSIONS),
                  turn_tokens=TURN_TOKENS, launches_counted=r["counts"],
                  launches_by_route=r["by_route"], **r["metrics"])
        count_hybrid(cold)
        count_hybrid(warm)

        def gate(r) -> dict:
            """``r`` against the uncached run (teacher-forced) and, bitwise,
            against the uncached run over the cached run's partition, at
            ``r``'s sampled positions."""
            plain = {key: cold["top_logits"][key] for key in r["top_logits"]}
            fv = forced_vs(r, dict(top_logits=plain))
            step = 2.0 ** (math.floor(math.log2(fv["max_abs_logit"])) - 7)
            off = [key for key in r["digests"] if r["digests"][key] != cold_own["digests"][key]]
            within = (fv["max_abs_logit_diff"] <= HYB_WARM_LOGIT_STEPS * step
                      and fv["argmax_agree"] >= HYB_WARM_MIN_ARGMAX * fv["positions"])
            return dict(**fv, bf16_step=step, bound=HYB_WARM_LOGIT_STEPS * step,
                        within_steps=within, positions_not_bitwise_own_partition=len(off),
                        holds=within and not off)

        g_warm, g_planted = gate(warm), gate(planted)
        # the requests that hit no anchor run cold's own partition: bitwise cold
        cold_keys = [key for key in cold["digests"] if key[0] not in warm["hits"]]
        cold_off = [key for key in cold_keys if warm["digests"][key] != cold["digests"][key]]
        cut = 1.0 - warm["metrics"]["prefill_tokens"] / max(1, cold["metrics"]["prefill_tokens"])
        phase("serve_shared_prefix_cache_vs_none", arch=c.name, cache=g_warm,
              planted_zero_lanes=g_planted, planted_fault_caught=not g_planted["holds"],
              positions_without_a_hit=len(cold_keys),
              positions_without_a_hit_not_bitwise=len(cold_off),
              prefill_token_cut=cut, **{f"{key}_{side}": r["metrics"][key] for key in (
                  "prefill_tokens", "mean_ttft_s", "tokens_per_s", "prefix_hit_rate",
                  "hit_requests", "cow_copies", "graphs") for side, r in (
                  ("cache", warm), ("no_cache", cold))})
        if not g_warm["holds"]:
            fail(f"{c.name} shared prefix, cached vs uncached (teacher-forced): {g_warm}")
        if g_planted["holds"]:
            fail(f"{c.name} shared prefix: zeroed anchor lanes went unseen: {g_planted}")
        if cold_off or not cold_keys:
            fail(f"{c.name} shared prefix: {len(cold_off)} of {len(cold_keys)} positions of "
                 "requests without a hit differ from the uncached run")
        if cut < PREFIX_MIN_CUT or not warm["hits"]:
            fail(f"{c.name} shared prefix: prefill cut {cut}, {len(warm['hits'])} hits")

    def hybrid_phase() -> None:
        """The hybrid phase (the module docstring says what it holds)."""
        t_phase = time.monotonic()
        full = get_config(HYB_ARCH)
        # (a) one dense draw at full size; the 2-bit copy packs its shared FFN
        params0, init = timed_init(dataclasses.replace(full, w_bits=0))
        prefetch_after(HYB_ARCH)
        phase("init", arch=HYB_ARCH, quant=0, layers=full.n_layers, **init)
        cq0, cq2 = (dataclasses.replace(full, w_bits=b) for b in (0, 2))
        t0 = time.monotonic()
        params2 = lm.pack_ffn_params(params0, 2)
        torch.cuda.synchronize()
        pack_s = time.monotonic() - t0
        phase("init", arch=HYB_ARCH, quant=2, layers=full.n_layers, dense_init_s=init["init_s"],
              pack_s=pack_s, weights_mib=sum(t.nbytes for t in itertools.chain(
                  params2.parameters(), params2.buffers())) / 2**20)
        # (b) one super-block at full width against the CPU
        hybrid_vs_cpu(*first_layers(cq2, params2, full.hybrid_attn_every))
        # (c) packed_matmul and flash_fwd at zamba2's shapes
        hg = torch.Generator(device="cpu").manual_seed(25)
        d_, ff_ = full.d_model, full.d_ff
        for bits in (2, 1):
            for k, n in ((d_, ff_), (ff_, d_)):
                for m in (LANES, CHUNK, HYB_RAGGED_M):
                    packed_case(bits, m, k, n, torch.bfloat16, timed=True, g=hg)
        h_, hd_ = full.n_heads, full.hd
        flash_case("zamba2_prefill_causal", h_, full.n_kv, PROMPT, PROMPT, hd_, True, 0, 0,
                   torch.bfloat16, True, g=hg)
        flash_case("zamba2_chunk_q_offset", h_, full.n_kv, CHUNK, PROMPT, hd_, True, 0, CHUNK,
                   torch.bfloat16, True, g=hg)
        flash_case("zamba2_ragged_prompt", h_, full.n_kv, HYB_RAGGED_M, HYB_RAGGED_M, hd_, True,
                   0, 0, torch.bfloat16, True, g=hg)
        q, k_, v_ = (torch.randn((h_, n_, hd_), generator=hg).to(dev, torch.bfloat16)
                     for n_ in (CHUNK, PROMPT, PROMPT))
        on_dev = fa.flash_fwd(q, k_, v_, causal=True,
                              q_offset=torch.tensor([CHUNK], dtype=torch.int32, device=dev))
        host = fa.flash_fwd(q, k_, v_, causal=True, q_offset=CHUNK)
        phase("kernel", name="flash_fwd", check_only=True, case="zamba2_device_q_offset",
              q_offset=CHUNK, bitwise_equal_to_host_int=all(map(same_bits, on_dev, host)))
        if not all(map(same_bits, on_dev, host)):
            fail("flash_fwd zamba2 chunk: the device q_offset differs from the host int")
        # (d) the decode step and the chunk as graphs at full size
        hybrid_graphs(cq2, params2)
        phase_seconds(f"hybrid {HYB_ARCH}: init, card vs CPU, kernels, graphs")
        # (e) the serve cell: --quant 2 and 0 compiled; --quant 2 eager and
        # compiled at HYB_EAGER_REQUESTS of its requests (a cut of the eager
        # run's length, to fit the run's time limit), for identical tokens
        # and launches
        cells = {}
        for mode, c_, p_, n in (
                ("compiled", cq2, params2, 16), ("compiled_q0", cq0, params0, 16),
                ("eager", cq2, params2, HYB_EAGER_REQUESTS),
                ("compiled_twin", cq2, params2, HYB_EAGER_REQUESTS)):
            r = hybrid_cell(c_, p_, mode != "eager", requests=n)
            check_hybrid_cell(f"{HYB_ARCH} {mode}", c_, r, mode != "eager")
            cells[mode] = r
            phase("serve", arch=HYB_ARCH, quant=c_.w_bits, mode=mode.split("_")[0],
                  init_s=init["init_s"], launches_counted=r["counts"],
                  launches_by_route=r["by_route"], **r["metrics"])
            if mode in ("compiled", "compiled_q0"):
                count_hybrid(r)
        eager, compiled = cells["eager"], cells["compiled_twin"]
        same_tokens = compiled["outputs"] == eager["outputs"]
        same_launches = ((compiled["counts"], compiled["by_route"])
                         == (eager["counts"], eager["by_route"]))
        phase("serve_compiled_vs_eager", arch=HYB_ARCH, quant=2, requests=HYB_EAGER_REQUESTS,
              token_streams_identical=same_tokens, launch_counts_identical=same_launches,
              first_streams_as_in_the_16_request_run=all(
                  cells["compiled"]["outputs"][rid] == toks
                  for rid, toks in compiled["outputs"].items()),
              **{f"{key}_{mode}": cells[mode]["metrics"][key]
                 for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s", "wall_s")
                 for mode in cells})
        if not (same_tokens and same_launches):
            fail(f"{HYB_ARCH} --quant 2: compiled and eager serving differ (tokens "
                 f"{same_tokens}, launches {same_launches})")
        del cells, eager, compiled
        # (f) the shared-prefix traffic, with the cache and without
        hybrid_shared_prefix(cq2, params2)
        if not opts.only:
            held[HYB_ARCH] = params0
        del params0, params2
        torch.cuda.empty_cache()
        phase_seconds(f"hybrid {HYB_ARCH}: serve")
        phase("hybrid_phase", seconds=time.monotonic() - t_phase,
              launches_on_the_main_path_by_route=hybrid_launches)

    # ---------------- the fixed-batch engine (phase 5's case and the SSM phase) ----------------
    fixed_launches = {}  # the fixed-engine runs' share of ``launches``, by route

    def random_cache(c, lanes, max_len, pos, seed):
        """``lm.init_cache`` on the card with every float leaf drawn at
        random (0.5 randn, in its dtype) and ``len`` at ``pos``."""
        g = torch.Generator(device=dev).manual_seed(seed)
        cache = lm.init_cache(c, lanes, max_len, device=dev)
        for key, leaf in cache.items():
            if leaf.is_floating_point():
                leaf.copy_(0.5 * torch.randn(leaf.shape, generator=g, device=dev))
        cache["len"].fill_(pos)
        return cache

    def hold_cache_replay(label, c, p, cache0) -> None:
        """The fixed decode step (``steps.make_serve_step``: ``lm.decode_step``,
        or ``encdec.decode_step`` over its cross K/V too) as a ``CapturedStep``
        over a copy of ``cache0``, and eagerly over another: the graph's
        first call and the eager step on the same token, then FIXED_REPLAYS
        replays in a row, each held against the eager step on the same
        token: the logits and every cache leaf (``len`` included) bitwise
        equal."""
        lanes = cache0["ssm" if "ssm" in cache0 else "k"].shape[1]
        cache_g = {k: v.clone() for k, v in cache0.items()}
        cache_e = {k: v.clone() for k, v in cache0.items()}
        serve_step = make_serve_step(c)
        graph = CapturedStep(lambda t_: serve_step(p, t_, cache_g)[0], device=dev,
                             mempool=torch.cuda.graph_pool_handle())
        toks = [torch.from_numpy(np.random.default_rng(20 + i).integers(0, c.vocab, (lanes, 1)))
                for i in range(FIXED_REPLAYS + 1)]
        graph(toks[0])
        serve_step(p, toks[0].to(dev), cache_e)
        for i in range(1, FIXED_REPLAYS + 1):
            lg_r = graph(toks[i])
            lg_e = serve_step(p, toks[i].to(dev), cache_e)[0]
            replay_matches(label, i - 1, graph.replays, i, {
                "logits": (lg_r, lg_e), **{f"cache_{k}": (cache_g[k], cache_e[k]) for k in cache0}})
        del graph, cache_g, cache_e

    def fixed_cell(label, c, p, want_counts, prompt=FIXED_PROMPT, gen=FIXED_GEN) -> dict:
        """The fixed-batch engine's cell (``serve.run_fixed_engine``: the
        reference's loop, lockstep lanes, prompts replayed through the
        decode step) on ``p``, eager and then compiled (every step a replay
        of one CUDA graph but the first call), launch counters reset just
        before each run and read just after: every request done, the
        tokens and the launch counts by route identical, and the counts
        ``want_counts(steps)`` (by route); the compiled run's launches
        counted on the main path, and returned by route. Requests of
        ``prompt`` + ``gen`` tokens (FIXED_PROMPT + FIXED_GEN unless named)."""
        args = serve.build_parser().parse_args(
            ["--arch", c.name, "--requests", str(FIXED_REQUESTS), "--batch", str(LANES),
             "--prompt-len", str(prompt), "--gen-len", str(gen),
             "--max-len", str(prompt + gen), "--engine", "fixed"])
        runs = {}
        for mode in ("eager", "compiled"):
            ops.reset_launch_counts()
            m = serve.run_fixed_engine(c, p, args, dev, compiled=mode == "compiled")
            torch.cuda.synchronize()
            counts, by_route = ops.launch_counts(), ops.launch_routes()
            runs[mode] = dict(metrics=m, counts=counts, by_route=by_route)
            phase("serve", arch=c.name, engine="fixed", quant=c.w_bits, mode=mode,
                  launches_counted=counts, launches_by_route=by_route,
                  graph_pool_mib=m["graph_pool_bytes"] / 2**20,
                  **{k: v for k, v in m.items() if k not in ("outputs", "engine")})
            want = want_counts(m["steps"])
            if (m["completed"] != FIXED_REQUESTS
                    or m["generated_tokens"] != FIXED_REQUESTS * gen
                    or by_route != {k: v for k, v in want.items() if v}
                    or counts != {name: sum(want.get(name, {}).values()) for name in counts}):
                fail(f"{label} ({mode}): {m['completed']} completed, launches {counts} by route "
                     f"{by_route}; want {want}")
            if mode == "compiled" and not (m["graphs"] == 1
                                           and m["graph_replays"] == m["steps"] - 1):
                fail(f"{label}: {m['graphs']} graphs, {m['graph_replays']} replays of "
                     f"{m['steps']} steps: want one graph, every step but its first a replay")
        eager, compiled = runs["eager"], runs["compiled"]
        same_tokens = eager["metrics"]["outputs"] == compiled["metrics"]["outputs"]
        same_launches = ((eager["counts"], eager["by_route"])
                         == (compiled["counts"], compiled["by_route"]))
        phase("serve_compiled_vs_eager", arch=c.name, engine="fixed", quant=c.w_bits,
              token_streams_identical=same_tokens, launch_counts_identical=same_launches,
              **{f"{key}_{mode}": runs[mode]["metrics"][key]
                 for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s", "wall_s")
                 for mode in runs})
        if not (same_tokens and same_launches):
            fail(f"{label}: compiled and eager fixed-engine serving differ (tokens "
                 f"{same_tokens}, launches {same_launches})")
        count_main_path(compiled)
        for name, by in compiled["by_route"].items():
            for route, n in by.items():
                fixed_launches.setdefault(name, {})
                fixed_launches[name][route] = fixed_launches[name].get(route, 0) + n
        return compiled["by_route"]

    # ---------------- the SSM family (--only ssm: alone) ----------------
    def ssm_vs_cpu(c, p) -> None:
        """(b) ``c`` (SSM_CPU_LAYERS layers at full width) in bf16 on the
        card against float32 on the CPU, same weights: SSM_CPU_POSITIONS
        random tokens on SSM_CPU_LANES lanes through ``decode_step`` on
        both; every position's logits (cosine >= PREFILL_MIN_COS, the card's
        top-1 within PREFILL_TOP1_SLACK of the CPU's max), and at position 7
        and every SSM_HOLD_EVERY-th the SSD state and the conv buffers, leaf
        by leaf over the layers (within SSM_STATE_REL_TOL, cosine >=
        SSM_STATE_MIN_COS), the error not growing along the positions
        (SSM_GROWTH). Every reading is printed before a gate fails."""
        cpu_c, cpu_p = cpu_copy(c, p)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, c.vocab, (SSM_CPU_LANES, SSM_CPU_POSITIONS)))
        sides = {"card": (c, p, dev), "cpu": (cpu_c, cpu_p, "cpu")}
        caches = {name: lm.init_cache(sc, SSM_CPU_LANES, SSM_CPU_POSITIONS, device=sd)
                  for name, (sc, _, sd) in sides.items()}
        secs = dict.fromkeys(sides, 0.0)
        held, cosines, slacks, errs = [], [], [], []
        for t in range(SSM_CPU_POSITIONS):
            lg = {}
            for name, (sc, sp, sd) in sides.items():
                t0 = time.monotonic()
                lg[name] = lm.decode_step(sp, sc, toks[:, t:t + 1].to(sd), caches[name])[0]
                if name == "card":
                    torch.cuda.synchronize()
                secs[name] += time.monotonic() - t0
            a = lg["card"][:, 0, :c.vocab].float().cpu()
            b = lg["cpu"][:, 0, :c.vocab].float()
            cosines.append(F.cosine_similarity(a, b, dim=-1).min().item())
            slacks.append((b.max(dim=-1).values - b.gather(1, a.argmax(dim=-1)[:, None])[:, 0])
                          .max().item())
            errs.append((a - b).abs().max().item())
            if t == 7 or (t + 1) % SSM_HOLD_EVERY == 0:
                held.append(dict(position=t, logits_cosine=cosines[-1],
                                 max_abs_logit_err=errs[-1],
                                 **lane_vs_cpu(caches["card"], caches["cpu"])))
        early = [h for h in held if h["position"] < 64]
        late = [h for h in held if h["position"] >= 192]
        growth = {key: max(h[key]["max_rel_err"] for h in late)
                  / max(max(h[key]["max_rel_err"] for h in early), 1e-30) for key in lm.LANE_KEYS}
        worst = {key: dict(max_rel_err=max(h[key]["max_rel_err"] for h in held),
                           min_cosine=min(h[key]["min_cosine"] for h in held))
                 for key in lm.LANE_KEYS}
        phase("ssm_vs_cpu", arch=c.name, layers=c.n_layers, lanes=SSM_CPU_LANES,
              positions=SSM_CPU_POSITIONS, depth_cut=(
                  f"{c.n_layers} of {get_config(SSM_ARCH).n_layers} layers: the CPU's float32 "
                  "side stays in seconds"), card_s=secs["card"], cpu_s=secs["cpu"],
              logits_min_cosine=min(cosines), logits_max_top1_cpu_logit_gap=max(slacks),
              max_abs_logit_err=max(errs), state=worst, state_error_growth=growth, held=held)
        if not (min(cosines) >= PREFILL_MIN_COS and max(slacks) <= PREFILL_TOP1_SLACK):
            fail(f"{c.name} decode, card vs CPU: logits cosine {min(cosines)}, top-1 gap "
                 f"{max(slacks)}")
        bad = {k: v for k, v in worst.items()
               if not (v["max_rel_err"] <= SSM_STATE_REL_TOL
                       and v["min_cosine"] >= SSM_STATE_MIN_COS)}
        if bad or max(growth.values()) > SSM_GROWTH:
            fail(f"{c.name} decode state, card vs CPU: {bad}, growth {growth}")

    def ssm_decode_vs_prefill(c, p) -> None:
        """(d) At full depth on the card: a SSM_PREFILL_PROMPT-token prompt
        replayed token by token through the fixed decode step (one lane, a
        CUDA graph) and teacher-forced against ``lm.prefill`` over it (the
        SSD over the whole prompt, in chunks of ``ssm_chunk``), at every
        position: the largest |logit difference| in bf16 steps at the
        largest |logit| and the share of positions whose argmax agrees; in
        bf16 (within SSM_PREFILL_LOGIT_STEPS, at least
        SSM_PREFILL_MIN_ARGMAX), and on the same weights widened to float32
        (within SSM_F32_LOGIT_STEPS, at least SSM_F32_MIN_ARGMAX): the
        control that tells the two paths' rounding from a fault."""
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, c.vocab, (1, SSM_PREFILL_PROMPT)))
        tree = p.tree()
        widened = lm.LMParams({**{k: v.float() for k, v in tree.items() if k != "layers"},
                               "layers": {k: v.float() for k, v in tree["layers"].items()}})
        out, step = {}, None
        for name, (sc, sp) in (("bf16", (c, p)),
                               ("f32", (dataclasses.replace(c, dtype="float32"), widened))):
            t0 = time.monotonic()
            want = lm.prefill(sp, sc, toks.to(dev))[0, :, :c.vocab].float()
            torch.cuda.synchronize()
            prefill_s = time.monotonic() - t0
            cache = lm.init_cache(sc, 1, SSM_PREFILL_PROMPT, device=dev)
            graph = CapturedStep(lambda t_: lm.decode_step(sp, sc, t_, cache)[0], device=dev,
                                 mempool=torch.cuda.graph_pool_handle())
            t0 = time.monotonic()
            got = torch.stack([graph(toks[:, t:t + 1])[0, 0, :c.vocab].clone()
                               for t in range(SSM_PREFILL_PROMPT)])
            torch.cuda.synchronize()
            decode_s = time.monotonic() - t0
            diff = (got - want).abs().max(dim=-1).values
            scale = want.abs().max().item()
            step = step or 2.0 ** (math.floor(math.log2(scale)) - 7)  # the bf16 run's
            quarter = SSM_PREFILL_PROMPT // 4
            out[name] = dict(
                max_abs_logit=scale, max_abs_logit_diff=diff.max().item(),
                max_bf16_steps=diff.max().item() / step,
                bf16_steps_by_quarter=[diff[i:i + quarter].max().item() / step
                                       for i in range(0, SSM_PREFILL_PROMPT, quarter)],
                argmax_agree_share=(got.argmax(dim=-1) == want.argmax(dim=-1)).float()
                .mean().item(),
                prefill_s=prefill_s, decode_s=decode_s,
                finite=bool(torch.isfinite(got).all() and torch.isfinite(want).all()))
            del graph, cache, got, want
        del widened
        torch.cuda.empty_cache()
        phase("ssm_decode_vs_prefill", arch=c.name, layers=c.n_layers, prompt=SSM_PREFILL_PROMPT,
              ssd_chunk=c.ssm_chunk, bf16_step=step, bound_bf16=dict(
                  steps=SSM_PREFILL_LOGIT_STEPS, argmax_share=SSM_PREFILL_MIN_ARGMAX),
              bound_f32=dict(steps=SSM_F32_LOGIT_STEPS, argmax_share=SSM_F32_MIN_ARGMAX), **out)
        held = all(r["finite"] for r in out.values()) and all(
            out[k]["max_bf16_steps"] <= steps and out[k]["argmax_agree_share"] >= share
            for k, steps, share in (("bf16", SSM_PREFILL_LOGIT_STEPS, SSM_PREFILL_MIN_ARGMAX),
                                    ("f32", SSM_F32_LOGIT_STEPS, SSM_F32_MIN_ARGMAX)))
        if not held:
            fail(f"{c.name} decode vs prefill: {out}")

    def ssm_phase() -> None:
        """The SSM phase (the module docstring says what it holds)."""
        t_phase = time.monotonic()
        full = get_config(SSM_ARCH)
        # (a) one draw at full size
        params, init = timed_init(full)
        phase("init", arch=SSM_ARCH, layers=full.n_layers, d_model=full.d_model,
              ssm_heads=full.ssm_heads, ssm_state=full.ssm_state, **init)
        # (b) SSM_CPU_LAYERS layers at full width against the CPU
        ssm_vs_cpu(*first_layers(full, params, SSM_CPU_LAYERS))
        # (c) the decode step as a graph, its replays bitwise the eager step
        cache0 = random_cache(full, LANES, FIXED_MAX_LEN, FIXED_PROMPT, seed=6)
        hold_cache_replay(f"{SSM_ARCH} fixed decode step", full, params, cache0)
        # (f) one decode step profiled, eager and compiled
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, full.vocab, (LANES, 1)))
        graph = CapturedStep(lambda t_: lm.decode_step(params, full, t_, cache0)[0],
                             device=dev, mempool=torch.cuda.graph_pool_handle())
        graph(tok)
        tok_dev = tok.to(dev)
        for compiled in (False, True):
            step = (lambda: graph(tok)) if compiled else (
                lambda: lm.decode_step(params, full, tok_dev, cache0))
            stats, by_name = profile_window(step, window=1)
            phase("decode_profile", arch=SSM_ARCH, engine="fixed", lanes=LANES,
                  compiled=compiled, **stats,
                  event_median_ms=median_ms(step) if compiled else None,
                  capture_s=graph.capture_s if compiled else None,
                  graph_pool_mib=graph.pool_bytes / 2**20 if compiled else None,
                  top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))
        del graph, cache0
        phase_seconds(f"ssm {SSM_ARCH}: init, card vs CPU, graphs")
        # (e) the fixed-engine cell, eager and compiled: no kernel of the six
        fixed_cell(f"serve {SSM_ARCH} --engine fixed", full, params, lambda steps: {})
        phase_seconds(f"ssm {SSM_ARCH}: serve")
        # (d) decode against prefill, teacher-forced, in bf16 and in f32
        ssm_decode_vs_prefill(full, params)
        if not opts.only:
            held[SSM_ARCH] = params
        del params
        torch.cuda.empty_cache()
        phase_seconds(f"ssm {SSM_ARCH}: decode vs prefill")
        phase("ssm_phase", seconds=time.monotonic() - t_phase)

    # ---- shared by phases 4-5, the other archs and the vlm phase ----
    def decode_kw(c, plan):
        return {} if plan is None else dict(
            stream_mask=plan.layer_stream_mask(c), stream_depth=plan.stream_ahead)

    def profile_decode(p, c, plan=None, compiled=False) -> dict:
        """One paged decode step of 8 lanes at depth PROMPT + 8: host wall
        time per step (synchronised) against the card's kernel time in a
        torch.profiler window, and the kernels that take it. With a plan,
        the step is budgeted (its streamed layers run stream_matmul).
        Compiled, it is the scheduler's captured step: host inputs copied
        into the graph's buffers, then one replay; eager, the inputs are
        already on the card."""
        kw = decode_kw(c, plan)
        rows = LANES * MAX_LEN + 16
        pk = torch.zeros((c.n_layers, rows, c.n_kv, c.hd), dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        table = (16 + torch.arange(LANES * MAX_LEN, device=dev)).reshape(LANES, MAX_LEN)
        tok = torch.zeros((LANES, 1), dtype=torch.long, device=dev)
        lens = torch.full((LANES,), PROMPT + 8, device=dev)

        if compiled:
            graph = CapturedStep(
                lambda t_, tb, ln: lm.decode_step_paged(p, c, t_, pk, pv, tb, ln, **kw)[0],
                device=dev, mempool=torch.cuda.graph_pool_handle())
            host_in = (tok.cpu(), table.cpu(), lens.cpu())

            def step():
                graph(*host_in)
        else:
            def step():
                lm.decode_step_paged(p, c, tok, pk, pv, table, lens, **kw)

        stats, by_name = profile_window(step)
        return dict(
            w_bits=c.w_bits, budgeted=plan is not None, compiled=compiled,
            streamed_layers=sum(kw.get("stream_mask", ())), **stats,
            gemv_ms=sum(ms for name, ms in by_name.items() if "gemv_kernel<" in name),
            stream_ms=sum(ms for name, ms in by_name.items() if "stream_kernel<" in name),
            top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]),
        )

    def outputs_of(metrics):
        return {int(rid): toks for rid, toks in metrics["outputs"].items()}

    def check_pool_run(label, metrics, counts, by_route, quant, compiled,
                       streamed_layers=0, residency=None, requests=16) -> None:
        """A serve cell run: every request (of ``requests``) done; 2 graphs
        (the decode step, one chunk graph for every start) and every other
        step a replay when compiled; the prefix cache on by default; prefill on the tensor-core
        kernels, decode on the GEMV at 2 bits, no f32 route, no backward
        kernel; ``stream_matmul`` 3 times a step for each of
        ``streamed_layers``, and the plan's ``residency`` where a budget
        set one."""
        if metrics["completed"] != requests or metrics["generated_tokens"] != requests * 64:
            fail(f"{label}: {metrics['completed']} completed, "
                 f"{metrics['generated_tokens']} tokens")
        if compiled and not (metrics["compiled"] and metrics["graphs"] == 2 and
                             metrics["graph_replays"] == metrics["steps"] - metrics["graphs"]):
            fail(f"{label}: compiled {metrics['compiled']}, {metrics['graphs']} graphs, "
                 f"{metrics['graph_replays']} replays of {metrics['steps']} steps: want the "
                 "decode step and one chunk graph for every start, every other step a replay")
        if not metrics["prefix_cache"]:
            fail(f"{label}: the prefix cache is not on by default")
        if residency is not None and metrics["residency"] != residency:
            fail(f"{label}: residency {metrics['residency']} is not the plan's {residency}")
        want_stream = 3 * streamed_layers * metrics["decode_steps"]
        if counts["stream_matmul"] != want_stream:
            fail(f"{label}: stream_matmul launched {counts['stream_matmul']} times, not "
                 f"3 x {streamed_layers} x {metrics['decode_steps']} = {want_stream}")
        want_pm = {"mma", "gemv"} if quant else set()
        pm_routes = by_route.get("packed_matmul", {})
        if (set(pm_routes) != want_pm or min(pm_routes.values(), default=1) <= 0
                or by_route.get("flash_fwd", {}).keys() != {"mma"}
                or counts["flash_bwd_dq"] or counts["flash_bwd_dkv"]):
            fail(f"{label}: launches {counts}, by route {by_route}")

    # ---------------- the vlm family (--only vlm: alone) ----------------
    family_launches = {"vlm": {}, "encdec": {}}  # the two phases' share of ``launches``
    noncausal_launches = {}  # flash_fwd's launches with causal=False on the main path

    def add_family(family, by_route) -> None:
        """A main-path run's launches by route, into the family phase's share."""
        for name, by in by_route.items():
            for route, n in by.items():
                family_launches[family].setdefault(name, {})
                family_launches[family][name][route] = (
                    family_launches[family][name].get(route, 0) + n)

    def vlm_served_config():
        return dataclasses.replace(get_config(VLM_ARCH), w_bits=2,
                                   n_layers=SERVED_LAYERS[VLM_ARCH])

    def patch_prefill_vs_cpu(c, p) -> None:
        """(b) ``make_prefill_step`` with VLM_PATCHES seeded patch embeddings
        ahead of VLM_TOKENS tokens, in bf16 on the card against float32 on
        the CPU, same weights (``logits_vs_cpu``); the CPU's text-only
        prefill of the same tokens beside it: the card must be closer to the
        CPU's patch prefill than the text-only one is (the patches move the
        logits more than bf16 does)."""
        cpu_c, cpu_p = cpu_copy(c, p)
        rng = np.random.default_rng(13)
        toks = torch.from_numpy(rng.integers(0, c.vocab, size=(1, VLM_TOKENS)))
        patches = torch.from_numpy(
            (rng.standard_normal((1, VLM_PATCHES, c.d_model)) * 0.02).astype(np.float32))
        t0 = time.monotonic()
        lg_card = make_prefill_step(c)(p, {"tokens": toks.to(dev), "labels": toks.to(dev),
                                           "prefix_embeds": patches.to(dev)})
        torch.cuda.synchronize()
        card_s = time.monotonic() - t0
        t0 = time.monotonic()
        step_cpu = make_prefill_step(cpu_c)
        lg_cpu = step_cpu(cpu_p, {"tokens": toks, "labels": toks, "prefix_embeds": patches})
        cpu_s = time.monotonic() - t0
        lg_text = lm.prefill(cpu_p, cpu_c, toks)[:, -1:]
        out = logits_vs_cpu(lg_card[0, 0, : c.vocab], lg_cpu[0, 0, : c.vocab],
                            f"{c.name} patch prefill", arch=VLM_ARCH, layers=c.n_layers,
                            patches=VLM_PATCHES, tokens=VLM_TOKENS)
        moves = (lg_cpu - lg_text)[0, 0, : c.vocab].abs().max().item()
        phase("vlm_prefill", **out, patches_move_cpu_logits=moves, card_s=card_s, cpu_s=cpu_s)
        if not out["max_abs_logit_err"] < moves:
            fail(f"{c.name} patch prefill: the card is {out['max_abs_logit_err']} from the CPU, "
                 f"the patches move the CPU's logits only {moves}")

    def vlm_phase() -> None:
        """The vlm phase (the module docstring says what it holds)."""
        t_phase = time.monotonic()
        full = get_config(VLM_ARCH)
        c = vlm_served_config()
        # (a) SERVED_LAYERS layers at full width, 2-bit FFN carriers
        params, init = timed_init(c)
        # the whole backbone's bytes (arithmetic): bf16 values, or 2-/1-bit
        # FFN carriers with their f32 scales beside bf16 attention and tables
        attn = full.d_model * full.hd * (2 * full.n_heads + 2 * full.n_kv)
        ffn = 3 * full.d_model * full.d_ff
        rest = 2 * (2 * full.padded_vocab * full.d_model + full.n_layers * attn)
        scales = 4 * full.n_layers * (2 * full.d_ff + full.d_model)
        phase("init", arch=VLM_ARCH, quant=2, layers=c.n_layers, depth_cut=(
            f"{c.n_layers} of {full.n_layers} layers at full width: a full-depth draw takes "
            "~500 s on the host"), **init,
            full_depth_gb_arithmetic={
                "bf16": (rest + 2 * full.n_layers * ffn) / 1e9,
                "bits2": (rest + full.n_layers * ffn / 4 + scales) / 1e9,
                "bits1": (rest + full.n_layers * ffn / 8 + scales) / 1e9})
        # (b) VLM_CPU_LAYERS layers against the CPU: a text prompt, and patches
        c2, p2 = first_layers(c, params, VLM_CPU_LAYERS)
        cut = f"{VLM_CPU_LAYERS} of {full.n_layers} layers: the CPU's float32 side stays in seconds"
        prefill_vs_cpu(c2, p2, arch=VLM_ARCH, layers=VLM_CPU_LAYERS, depth_cut=cut)
        patch_prefill_vs_cpu(c2, p2)
        del p2
        # the pool's decode step and chunk captured, each replay bitwise eager
        rows0 = (c.n_layers, LANES * MAX_LEN + 16, c.n_kv, c.hd)
        pool_gen = torch.Generator(device=dev).manual_seed(4)
        pk0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        pv0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        table = (16 + torch.arange(LANES * MAX_LEN)).reshape(LANES, MAX_LEN)
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, c.vocab, (LANES, 1)))
        hold_replay(f"{VLM_ARCH} decode step, --quant 2",
                    lambda k_, v_, t_, tb, ln: lm.decode_step_paged(
                        params, c, t_, k_, v_, tb, ln)[0],
                    (tok, table, torch.full((LANES,), PROMPT + 8)), pk0, pv0)
        chunk = torch.from_numpy(np.random.default_rng(2).integers(0, c.vocab, size=(1, CHUNK)))
        one = table[:1]

        def chunk_in_at(start):
            return (chunk, one, one[:, start:start + CHUNK], torch.tensor([start]),
                    torch.tensor([CHUNK - 1]))

        hold_replay(f"{VLM_ARCH} prefill chunk, --quant 2",
                    lambda k_, v_, t_, rows, wr, st, last: lm.prefill_chunk_paged(
                        params, c, t_, k_, v_, rows, wr, st, last)[0],
                    chunk_in_at(CHUNK), pk0, pv0, replay_in=[chunk_in_at(s) for s in (CHUNK, 37)])
        del pk0, pv0
        # (e) where a decode step's and a chunk's time goes
        for compiled in (False, True):
            phase("decode_profile", arch=VLM_ARCH, **profile_decode(params, c, compiled=compiled))
        pk1 = torch.zeros((c.n_layers, MAX_LEN + 16, c.n_kv, c.hd), dtype=torch.bfloat16,
                          device=dev)
        pv1 = torch.zeros_like(pk1)
        chunk_graph = CapturedStep(
            lambda t_, rows, wr, st, last: lm.prefill_chunk_paged(
                params, c, t_, pk1, pv1, rows, wr, st, last)[0],
            device=dev, mempool=torch.cuda.graph_pool_handle())
        phase("prefill_profile", arch=VLM_ARCH, compiled=True, chunk=CHUNK, start=CHUNK,
              pool_rows=MAX_LEN, **chunk_profile(lambda: chunk_graph(*chunk_in_at(CHUNK))))
        del chunk_graph, pk1, pv1
        phase_seconds(f"vlm {VLM_ARCH}: init, card vs CPU, graphs, profiles")
        # (c) the serve cell compiled; then eager and compiled at fewer requests
        argv = ["--arch", VLM_ARCH, "--batch", str(LANES), "--prompt-len", str(PROMPT),
                "--gen-len", "64", "--max-len", str(MAX_LEN), "--prefill-chunk", str(CHUNK),
                "--quant", "2"]
        by_mode = {}
        for mode, requests in (("compiled", 16), ("eager", VLM_EAGER_REQUESTS),
                               ("compiled", VLM_EAGER_REQUESTS)):
            args = serve.build_parser().parse_args(argv + ["--requests", str(requests)])
            ops.reset_launch_counts()
            metrics = serve.run_pool_engine(c, params, args, dev,
                                            compiled=None if mode == "compiled" else False)
            counts, by_route = ops.launch_counts(), ops.launch_routes()
            label = f"serve {VLM_ARCH} --quant 2 ({mode}, {requests} requests)"
            check_pool_run(label, metrics, counts, by_route, 2, mode == "compiled",
                           requests=requests)
            phase("serve", arch=VLM_ARCH, layers=c.n_layers, quant=2, mode=mode,
                  init_s=init["init_s"], launches_counted=counts, launches_by_route=by_route,
                  **{k: v for k, v in metrics.items() if k != "outputs"})
            if requests == 16:
                count_main_path(dict(counts=counts, by_route=by_route))
                add_family("vlm", by_route)
            else:
                by_mode[mode] = (metrics, counts, by_route)
        (cm, cc, cr), (em, ec, er) = by_mode["compiled"], by_mode["eager"]
        same_tokens = outputs_of(cm) == outputs_of(em)
        same_launches = (cc, cr) == (ec, er)
        phase("serve_compiled_vs_eager", arch=VLM_ARCH, quant=2, requests=VLM_EAGER_REQUESTS,
              token_streams_identical=same_tokens, launch_counts_identical=same_launches,
              **{f"{key}_{mode}": by_mode[mode][0][key]
                 for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s", "wall_s")
                 for mode in ("eager", "compiled")})
        if not (same_tokens and same_launches):
            fail(f"serve {VLM_ARCH} --quant 2: compiled and eager differ (tokens {same_tokens}, "
                 f"launches {cc} {cr} != {ec} {er})")
        # (d) the fixed engine: its decode graph's replays bitwise eager, its cell
        cache0 = random_cache(c, LANES, FIXED_MAX_LEN, FIXED_PROMPT, seed=8)
        hold_cache_replay(f"{VLM_ARCH} fixed decode step, --quant 2", c, params, cache0)
        del cache0
        add_family("vlm", fixed_cell(
            f"serve {VLM_ARCH} --engine fixed --quant 2", c, params,
            lambda steps: {"packed_matmul": {"gemv": 3 * c.n_layers * steps}}))
        if not opts.only:
            # one layer, dense: its FFN the 2-bit carriers' decoded values in bf16
            tree = dequantize_ffn_params(first_layers(c, params, 1)[1], 2).tree()
            tree["layers"] = {k: v.to(torch.bfloat16) if k in lm.FFN_LEAVES else v.clone()
                              for k, v in tree["layers"].items()}
            held[VLM_ARCH] = lm.LMParams(tree)
            del tree
        del params
        torch.cuda.empty_cache()
        phase_seconds(f"vlm {VLM_ARCH}: serve")
        phase("vlm_phase", seconds=time.monotonic() - t_phase)

    # ---------------- the enc-dec family (--only encdec: alone) ----------------
    def tree_leaves(tree, prefix=""):
        """[(name, tensor)] of a nested dict of tensors."""
        out = []
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out += tree_leaves(tree[k], f"{prefix}{k}/")
            else:
                out.append((prefix + k, tree[k]))
        return out

    def encdec_vs_cpu(c, p, frames) -> None:
        """(b) whisper at full size in bf16 on the card against float32 on
        the CPU, same weights and frames: the encoder's states (each lane's
        cosine >= PREFILL_MIN_COS), each lane's prefill logits over
        ENC_TOKENS decoder tokens (``make_prefill_step``), and ENC_TOKENS
        decode steps from ``init_decode_state`` teacher-forced with the
        card's greedy tokens, each lane's logits at every step
        (``logits_vs_cpu``)."""
        cpu_c, cpu_p = cpu_copy(c, p)
        t0 = time.monotonic()
        enc_card = encdec.encode(p, c, frames.to(dev)).float().cpu()
        enc_cpu = encdec.encode(cpu_p, cpu_c, frames)
        cos = [F.cosine_similarity(a.flatten(), b.flatten(), dim=0).item()
               for a, b in zip(enc_card, enc_cpu)]
        rel = ((enc_card - enc_cpu).abs().max() / enc_cpu.abs().max()).item()
        phase("encdec_encoder_vs_cpu", arch=ENC_ARCH, lanes=frames.shape[0],
              frames=frames.shape[1], min_cosine=min(cos), rel_err=rel,
              finite=bool(torch.isfinite(enc_card).all()))
        if not (min(cos) >= PREFILL_MIN_COS and torch.isfinite(enc_card).all()):
            fail(f"{ENC_ARCH} encoder states card vs CPU: cosines {cos}")
        toks = torch.from_numpy(
            np.random.default_rng(15).integers(0, c.vocab, size=(frames.shape[0], ENC_TOKENS)))
        lg_card = make_prefill_step(c)(p, {"tokens": toks.to(dev), "labels": toks.to(dev),
                                           "frames": frames.to(dev)})
        lg_cpu = make_prefill_step(cpu_c)(cpu_p, {"tokens": toks, "labels": toks,
                                                  "frames": frames})
        held = [logits_vs_cpu(lg_card[i, 0, : c.vocab], lg_cpu[i, 0, : c.vocab],
                              f"{ENC_ARCH} prefill lane {i}", lane=i)
                for i in range(frames.shape[0])]
        phase("encdec_prefill_vs_cpu", arch=ENC_ARCH, tokens=ENC_TOKENS,
              min_cosine=min(h["cosine"] for h in held),
              max_top1_cpu_logit_gap=max(h["top1_cpu_logit_gap"] for h in held),
              max_abs_logit_err=max(h["max_abs_logit_err"] for h in held))
        cache_card = encdec.init_decode_state(p, c, frames.to(dev), ENC_TOKENS)
        cache_cpu = encdec.init_decode_state(cpu_p, cpu_c, frames, ENC_TOKENS)
        tok = torch.zeros((frames.shape[0], 1), dtype=torch.long)
        held = []
        for step in range(ENC_TOKENS):
            lg_c = encdec.decode_step(p, c, tok.to(dev), cache_card)[0][:, 0, : c.vocab]
            lg_h = encdec.decode_step(cpu_p, cpu_c, tok, cache_cpu)[0][:, 0, : c.vocab]
            held += [logits_vs_cpu(lg_c[i], lg_h[i], f"{ENC_ARCH} decode step {step} lane {i}")
                     for i in range(frames.shape[0])]
            tok = lg_c.argmax(-1, keepdim=True).cpu()
        phase("encdec_decode_vs_cpu", arch=ENC_ARCH, steps=ENC_TOKENS, lanes=frames.shape[0],
              positions_held=len(held), min_cosine=min(h["cosine"] for h in held),
              max_top1_cpu_logit_gap=max(h["top1_cpu_logit_gap"] for h in held),
              max_abs_logit_err=max(h["max_abs_logit_err"] for h in held),
              top1_equal_share=statistics.fmean(h["top1_card"] == h["top1_cpu"] for h in held),
              seconds=time.monotonic() - t0)

    def encdec_greedy(c, p, frames, compiled) -> dict:
        """(d) ENC_GEN greedy tokens on each lane: ``init_decode_state`` of
        the frames, then the decode step (``make_serve_step``) eager or as
        one ``CapturedStep`` (each step but the first a replay), each
        step's argmax taken on the host as a serving loop would; launch
        counters reset just before and read just after. Returns the
        tokens, counts, metrics, and the step to profile."""
        serve_step = make_serve_step(c)
        ops.reset_launch_counts()
        t0 = time.monotonic()
        cache = encdec.init_decode_state(p, c, frames.to(dev), ENC_GEN)
        torch.cuda.synchronize()
        encode_s = time.monotonic() - t0
        graph = CapturedStep(lambda t_: serve_step(p, t_, cache)[0], device=dev,
                             mempool=torch.cuda.graph_pool_handle()) if compiled else None
        tok = torch.zeros((frames.shape[0], 1), dtype=torch.long)
        out, step_s = [], []
        for _ in range(ENC_GEN):
            ts = time.monotonic()
            lg = graph(tok) if compiled else serve_step(p, tok.to(dev), cache)[0]
            tok = lg[:, 0, : c.vocab].argmax(-1, keepdim=True).cpu()
            step_s.append(time.monotonic() - ts)
            out.append(tok[:, 0].tolist())
        wall = time.monotonic() - t0
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        noncausal = ops.noncausal_flash_launches()
        gen_tokens = frames.shape[0] * ENC_GEN
        metrics = dict(
            compiled=compiled, lanes=frames.shape[0], generated_tokens=gen_tokens,
            wall_s=wall, tokens_per_s=gen_tokens / wall,
            decode_tokens_per_s=gen_tokens / (wall - encode_s), encode_s=encode_s,
            step_ms_mean=statistics.fmean(step_s) * 1e3,
            step_ms_replay=statistics.fmean(step_s[1:]) * 1e3,
            capture_s=graph.capture_s if compiled else None,
            graph_replays=graph.replays if compiled else None,
            graph_pool_mib=graph.pool_bytes / 2**20 if compiled else None,
            cache_mib=sum(v.nbytes for v in cache.values()) / 2**20)
        step = (lambda: graph(tok)) if compiled else (
            lambda: serve_step(p, tok.to(dev), cache))
        return dict(tokens=out, counts=counts, by_route=by_route, noncausal=noncausal,
                    metrics=metrics, step=step)

    def encdec_phase() -> None:
        """The enc-dec phase (the module docstring says what it holds)."""
        t_phase = time.monotonic()
        full = get_config(ENC_ARCH)
        c0, c2 = (dataclasses.replace(full, w_bits=b) for b in (0, 2))
        # (a) the dense draw (from the host thread when queued) and the
        # 2-bit draw on the card: its FFN leaves, encoder's included, are
        # the dense draw's packed, bit for bit
        p0, init0 = timed_init(c0)
        phase("init", arch=ENC_ARCH, quant=0, layers=full.n_layers,
              enc_layers=full.n_enc_layers, **init0)
        p2, init2 = timed_init(c2)
        phase("init", arch=ENC_ARCH, quant=2, layers=full.n_layers,
              enc_layers=full.n_enc_layers, **init2)
        repacked = dict(tree_leaves(lm.pack_ffn_params(p0, 2).tree()))
        differ = [name for name, t in tree_leaves(p2.tree()) if not same_bits(t, repacked[name])]
        phase("init_bitwise", arch=ENC_ARCH, leaves=len(repacked), leaves_differing=differ,
              dense_drawn_on_host_thread=bool(init0.get("drawn_on_host_thread")))
        if differ or len(repacked) != len(tree_leaves(p2.tree())):
            fail(f"{ENC_ARCH}: the 2-bit draw is not the dense draw packed: {differ[:5]}")
        if not opts.only:
            held[ENC_ARCH] = p0
        del p0, repacked
        frames = torch.from_numpy(np.random.default_rng(14).standard_normal(
            (LANES, full.frontend_len, full.d_model)).astype(np.float32))
        # (b) the encoder, the prefill and decode steps against the CPU
        encdec_vs_cpu(c2, p2, frames)
        # (c) the decode step as one graph over the whole cache, every
        # leaf (cross_k / cross_v included) bitwise the eager step's
        cache0 = encdec.init_decode_state(p2, c2, frames.to(dev), ENC_GEN)
        for t in range(5):
            encdec.decode_step(p2, c2, torch.full((LANES, 1), t + 1, device=dev), cache0)
        hold_cache_replay(f"{ENC_ARCH} decode step, --quant 2", c2, p2, cache0)
        del cache0
        phase_seconds(f"encdec {ENC_ARCH}: init, card vs CPU, graph")
        # (d) greedy decoding, eager and compiled: identical tokens and
        # launches by route: the encoder's flash_fwd (not causal) and
        # packed_matmul on the mma path (M = 8 x 1500), the decode steps'
        # packed_matmul on the GEMV (M = 8)
        runs = {mode: encdec_greedy(c2, p2, frames, mode == "compiled")
                for mode in ("eager", "compiled")}
        want = {"packed_matmul": {"mma": 3 * full.n_enc_layers,
                                  "gemv": 3 * full.n_layers * ENC_GEN},
                "flash_fwd": {"mma": full.n_enc_layers}}
        for mode, r in runs.items():
            phase("encdec_greedy", arch=ENC_ARCH, quant=2, mode=mode, **r["metrics"],
                  launches_counted=r["counts"], launches_by_route=r["by_route"],
                  flash_fwd_noncausal=r["noncausal"])
            if r["by_route"] != want or r["noncausal"] != want["flash_fwd"]:
                fail(f"{ENC_ARCH} greedy ({mode}): launches by route {r['by_route']}, "
                     f"not causal {r['noncausal']}; want {want}")
        eager, compiled = runs["eager"], runs["compiled"]
        same_tokens = eager["tokens"] == compiled["tokens"]
        same_launches = (eager["counts"], eager["by_route"]) == (compiled["counts"],
                                                                 compiled["by_route"])
        phase("encdec_compiled_vs_eager", arch=ENC_ARCH, token_streams_identical=same_tokens,
              launch_counts_identical=same_launches,
              graph_replays=compiled["metrics"]["graph_replays"],
              **{f"{key}_{mode}": runs[mode]["metrics"][key]
                 for key in ("tokens_per_s", "decode_tokens_per_s", "step_ms_mean",
                             "step_ms_replay") for mode in runs})
        if not (same_tokens and same_launches and compiled["metrics"]["graph_replays"]
                == ENC_GEN - 1):
            fail(f"{ENC_ARCH}: compiled and eager greedy decoding differ (tokens {same_tokens}, "
                 f"launches {same_launches}, replays {compiled['metrics']['graph_replays']})")
        count_main_path(compiled)
        add_family("encdec", compiled["by_route"])
        for route, n in compiled["noncausal"].items():
            noncausal_launches[route] = noncausal_launches.get(route, 0) + n
        # a decode step's card ms, busy share and kernels, eager and compiled
        for mode, r in runs.items():
            stats, by_name = profile_window(r["step"], window=1)
            phase("decode_profile", arch=ENC_ARCH, engine="encdec", lanes=LANES,
                  compiled=mode == "compiled", **stats,
                  top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]))
        del runs, p2
        torch.cuda.empty_cache()
        phase_seconds(f"encdec {ENC_ARCH}: greedy decoding")
        phase("encdec_phase", seconds=time.monotonic() - t_phase)

    # ---- training: the gradient check (phase 7, train_families), and train_families ----
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.models.config import modality_batch_leaves
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.speculative import dequantize_ffn_params
    from repro_torch.runtime.steps import make_loss_fn, make_train_step

    def flat(tree, prefix=""):
        """[(name, tensor)] of a nested dict of tensors."""
        out = []
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out += flat(tree[k], f"{prefix}{k}/")
            else:
                out.append((prefix + k, tree[k]))
        return out

    def tree_map(fn, tree):
        return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}

    def train_batch(c, batch, seq, step, device):
        """A train batch: TokenPipeline's tokens and labels (seed 0) at
        ``step``, and the family's modality leaves (the vlm's patch
        embeddings, the enc-dec's frames) drawn from a seed."""
        tb = TokenPipeline(vocab=c.vocab, batch=batch, seq_len=seq, seed=0).batch_at(step)
        rng = np.random.default_rng(300 + step)
        for name, shape in modality_batch_leaves(c).items():
            tb[name] = (rng.standard_normal((batch, *shape))
                        * MODALITY_STD[name]).astype(np.float32)
        return {k: torch.from_numpy(v).to(device) for k, v in tb.items()}

    def loss_and_grads(p, c, device, remat="none"):
        loss = make_loss_fn(c, remat=remat)(p, train_batch(c, GRAD_BATCH, GRAD_SEQ, 0, device))
        names, leaves = zip(*flat(p.tree()))
        return loss.item(), dict(zip(names, torch.autograd.grad(loss, leaves)))

    def attention_layers(c) -> tuple[int, int]:
        """(attention layers a forward of ``c`` runs, of them not causal):
        one ``flash_fwd`` launch each, and one of each backward pass."""
        if c.family == "ssm":
            return 0, 0
        if c.family == "hybrid":
            return c.n_layers // c.hybrid_attn_every, 0
        if c.family == "encdec":
            return c.n_enc_layers + 2 * c.n_layers, c.n_enc_layers + c.n_layers
        return c.n_layers, 0

    FLASH_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def noncausal_by_name() -> dict:
        return {name: r for name in FLASH_NAMES if (r := ops.noncausal_flash_launches(name))}

    def grads_vs_cpu(c, p=None, **fields):
        """(a) gradients at full width: ``make_loss_fn`` and its backward in
        bf16 with the kernels on the card against float32 with the plain
        versions on the CPU, same weights and batch (GRAD_BATCH x GRAD_SEQ
        tokens, and the family's modality leaves): the loss within
        GRAD_LOSS_RTOL, each leaf's gradient cosine >= GRAD_MIN_COS, the
        flash kernels' launches by route (the not-causal ones too) exactly
        one a pass per attention layer, all on the tensor cores. ``p``: the
        weights (made trainable), else drawn (seed 0). Returns the card's
        weights, loss and gradients."""
        p = (lm.init_params(c, 0, device=dev, trainable=True) if p is None
             else lm.LMParams(p.tree(), trainable=True))
        cpu_c = dataclasses.replace(c, dtype="float32")
        t0 = time.monotonic()
        # the same values in f32 on the host: each leaf widened on the card
        # (exact), then copied (a host-side cast of internvl's 3 B values
        # takes tens of seconds)
        cpu_p = lm.LMParams(tree_map(lambda t: t.detach().float().cpu(), p.tree()),
                            trainable=True)
        copy_s = time.monotonic() - t0
        ops.reset_launch_counts()
        t0 = time.monotonic()
        loss_card, grads_card = loss_and_grads(p, c, dev)
        card_s = time.monotonic() - t0
        by_route, noncausal = ops.launch_routes(), noncausal_by_name()
        t0 = time.monotonic()
        loss_cpu, grads_cpu = loss_and_grads(cpu_p, cpu_c, "cpu")
        cpu_s = time.monotonic() - t0
        del cpu_p
        t0 = time.monotonic()
        cosines = {  # on the card: internvl's 3 B values take ~18 s on the host
            name: F.cosine_similarity(g.float().flatten(), grads_cpu[name].to(dev).flatten(),
                                      dim=0).item()
            for name, g in grads_card.items()
        }
        compare_s = time.monotonic() - t0
        del grads_cpu
        worst = min(cosines, key=cosines.get)
        loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
        phase("train_gradients", **fields, family=c.family, layers=c.n_layers,
              batch=GRAD_BATCH, seq=GRAD_SEQ, head_dim=c.hd, loss_card=loss_card,
              loss_cpu=loss_cpu, loss_rel_err=loss_rel, worst_leaf=worst,
              worst_cosine=cosines[worst], cosines=cosines, launches_by_route=by_route,
              launches_noncausal=noncausal, card_s=card_s, cpu_s=cpu_s, copy_s=copy_s,
              compare_s=compare_s)
        if not (loss_rel <= GRAD_LOSS_RTOL and cosines[worst] >= GRAD_MIN_COS):
            fail(f"train gradients {c.name} card vs CPU: loss rel err {loss_rel}, "
                 f"worst cosine {cosines[worst]} ({worst})")
        n, n_nc = attention_layers(c)
        want = {name: {"mma": n} for name in FLASH_NAMES} if n else {}
        want_nc = {name: {"mma": n_nc} for name in FLASH_NAMES} if n_nc else {}
        if by_route != want or noncausal != want_nc:
            fail(f"train gradients {c.name}: launches by route {by_route}, not causal "
                 f"{noncausal}; want {want}, {want_nc}")
        return p, loss_card, grads_card

    def falling(losses, steps) -> tuple[float, float, bool]:
        """Phase 7's gate: finite losses whose last k's mean (k = min(5,
        steps // 2)) lies below the first k's."""
        k = min(5, steps // 2)
        head, tail = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
        return head, tail, (len(losses) == steps and all(map(math.isfinite, losses))
                            and tail < head)

    def want_train_launches(c, steps, remat) -> tuple[dict, dict]:
        """(launch counts, not-causal launches by route) of ``steps`` train
        steps of ``c``: each attention layer's flash_fwd once a step (twice
        under --remat full where the layer is recomputed: every family but
        the hybrid, whose shared block is not, and enc-dec, which takes no
        remat) and each backward pass once."""
        n, n_nc = attention_layers(c)
        twice = remat == "full" and c.family not in ("hybrid", "encdec")
        counts = dict.fromkeys(ops.launch_counts(), 0) | {
            "flash_fwd": n * steps * (2 if twice else 1),
            "flash_bwd_dq": n * steps, "flash_bwd_dkv": n * steps}
        return counts, ({name: {"mma": n_nc * steps} for name in FLASH_NAMES} if n_nc else {})

    def check_train_launches(label, c, steps, remat, counts, by_route, noncausal) -> None:
        want, want_nc = want_train_launches(c, steps, remat)
        want_routes = {name: {"mma": want[name]} for name in FLASH_NAMES if want[name]}
        if counts != want or by_route != want_routes or noncausal != want_nc:
            fail(f"{label}: launches {counts} by route {by_route}, not causal {noncausal}; "
                 f"want {want}, all on the tensor-core kernels, not causal {want_nc}")

    def count_train_run(counts, by_route) -> None:
        for name, n in counts.items():
            launches[name] += n
        add_routes(by_route)

    def short_train(c, p, batch, seq, remat, **fields) -> None:
        """(c) TF_STEPS steps of ``make_train_step`` on the card (AdamW at
        TF_LR), each on a fresh batch: the loss finite and falling
        (``falling``), the launches exact, all on the tensor cores; step ms
        (median of the steps after the first), tokens/s and the peak device
        GiB; the MoE's aux loss a step."""
        p = lm.LMParams(p.tree(), trainable=True)
        opt = AdamW(lr=TF_LR)
        state = opt.init(p)
        step = make_train_step(c, opt, remat=remat)
        gc.collect()
        torch.cuda.synchronize()
        allocated_before = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, auxes, times = [], [], []
        for i in range(TF_STEPS):
            tb = train_batch(c, batch, seq, i, dev)
            t0 = time.monotonic()
            p, state, m = step(p, state, tb)
            losses.append(m["loss"].item())  # waits for the card
            times.append(time.monotonic() - t0)
            if "aux" in m:
                auxes.append(m["aux"].item())
        counts, by_route, noncausal = ops.launch_counts(), ops.launch_routes(), noncausal_by_name()
        head, tail, ok = falling(losses, TF_STEPS)
        steady = times[1:]
        phase("train", **fields, arch=c.name, family=c.family, entry="make_train_step",
              layers=c.n_layers, batch=batch, seq=seq, remat=remat, steps=TF_STEPS, lr=TF_LR,
              losses=losses, aux=auxes or None, first_losses_mean=head, last_losses_mean=tail,
              first_step_ms=times[0] * 1e3, step_ms_median=statistics.median(steady) * 1e3,
              tokens_per_s=batch * seq * len(steady) / sum(steady),
              peak_device_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
              device_allocated_gib_before=allocated_before,
              launches_counted=counts, launches_by_route=by_route,
              launches_noncausal=noncausal)
        if not ok:
            fail(f"train {c.name}: losses {losses} (the last steps' mean must be below the "
                 f"first's)")
        check_train_launches(f"train {c.name}", c, TF_STEPS, remat, counts, by_route, noncausal)
        count_train_run(counts, by_route)
        del p, state, opt

    def moe_same_bits_twice(c, p) -> None:
        """``moe_ffn`` at the gradient check's shape on layer 0 of ``p``:
        the output, the aux loss and every gradient the same bits in two
        runs (the combine and the gather's gradient sum each index's rows
        in a fixed order)."""
        from repro_torch.models import moe as moe_lib

        lp = p.layer(0)
        g = torch.Generator(device="cpu").manual_seed(33)
        x = torch.randn((GRAD_BATCH, GRAD_SEQ, c.d_model), generator=g).to(dev, torch.bfloat16)
        r = torch.randn(x.shape, generator=g).to(dev, torch.bfloat16)
        runs = []
        for _ in range(2):
            ins = [t.detach().clone().requires_grad_() for t in
                   (x, lp["router"], lp["w1"], lp["w3"], lp["w2"])]
            y, aux = moe_lib.moe_ffn(*ins, c)
            grads = torch.autograd.grad((y * r).float().sum() + aux, ins)
            runs.append((y, aux, *grads))
        torch.cuda.synchronize()
        names = ("y", "aux", "dx", "drouter", "dw1", "dw3", "dw2")
        same = {n: same_bits(a, b) for n, a, b in zip(names, *runs)}
        phase("moe_ffn_same_bits_twice", arch=c.name, batch=GRAD_BATCH, seq=GRAD_SEQ,
              capacity=moe_lib.moe_capacity(c, GRAD_SEQ), **same)
        if not all(same.values()):
            fail(f"moe_ffn on the card: two runs differ: {same}")

    def train_families_phase(held: dict) -> None:
        """The train_families phase (the module docstring says what it
        holds), on ``held``: arch -> the dense weights a family phase drew
        (olmoe cut to TF_MOE_LAYERS, internvl to one dense layer), each
        drawn here where missing."""
        t_phase = time.monotonic()
        run0 = dict(launches)

        def weights(arch, c):
            if arch in held:
                return held.pop(arch)
            p, init = timed_init(c)
            phase("init", arch=arch, layers=c.n_layers, quant=c.w_bits, **init)
            return p

        cfgs = train_family_configs()
        # whisper-tiny at full size: (a), then (c): the not-causal backward
        c, p = cfgs[ENC_ARCH], weights(ENC_ARCH, cfgs[ENC_ARCH])
        grads_vs_cpu(c, p, arch=ENC_ARCH)
        short_train(c, p, *TF_SHORT[ENC_ARCH])
        del p
        gc.collect()
        # mamba2-1.3b: (a) at 2 layers, (c) at full size
        c, p = cfgs[SSM_ARCH], weights(SSM_ARCH, cfgs[SSM_ARCH])
        n = TF_GRAD_LAYERS[SSM_ARCH]
        grads_vs_cpu(*first_layers(c, p, n), arch=SSM_ARCH,
                     depth_cut=f"{n} of {c.n_layers} layers: the CPU's float32 side stays "
                               "in seconds")
        short_train(c, p, *TF_SHORT[SSM_ARCH])
        del p
        gc.collect()
        # internvl2-76b: (a) at one dense layer with its 256 patches
        c, p = cfgs[VLM_ARCH], weights(VLM_ARCH, cfgs[VLM_ARCH])
        grads_vs_cpu(c, p, arch=VLM_ARCH, patches=c.n_patches,
                     depth_cut="1 of 80 layers at full width (~3.0 B values: f32 weights and "
                               "gradients on the host take ~24 GB)")
        del p
        gc.collect()
        torch.cuda.empty_cache()
        phase_seconds("train_families: whisper-tiny, mamba2-1.3b, internvl2-76b")
        # zamba2-2.7b: (a) at one super-block, (b) at full size through the CLI
        c, p = cfgs[HYB_ARCH], weights(HYB_ARCH, cfgs[HYB_ARCH])
        grads_vs_cpu(*first_layers(c, p, c.hybrid_attn_every), arch=HYB_ARCH,
                     depth_cut=f"one super-block ({c.hybrid_attn_every} Mamba2 layers and the "
                               "shared block)")
        argv = ["--arch", HYB_ARCH, "--batch", str(TF_HYB_BATCH), "--seq", str(TF_HYB_SEQ),
                "--steps", str(TF_STEPS), "--remat", "full", "--lr", str(TF_LR)]
        buf = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv, params=p)
        counts, by_route, noncausal = ops.launch_counts(), ops.launch_routes(), noncausal_by_name()
        text = buf.getvalue()
        sys.stderr.write(text)
        del p
        gc.collect()
        torch.cuda.empty_cache()
        if rc != 0:
            fail(f"train {HYB_ARCH} exited {rc}")
        metrics = json.loads(
            next(l for l in text.splitlines() if l.startswith("[train/metrics] ")).split(" ", 1)[1])
        head, tail, ok = falling(metrics["losses"], TF_STEPS)
        phase("train", family="hybrid", entry="repro_torch.launch.train.main",
              argv=argv, launches_counted=counts, launches_by_route=by_route,
              launches_noncausal=noncausal, first_losses_mean=head, last_losses_mean=tail,
              **metrics)
        if not ok:
            fail(f"train {HYB_ARCH}: losses {metrics['losses']} (the last steps' mean must be "
                 f"below the first's)")
        check_train_launches(f"train {HYB_ARCH}", c, TF_STEPS, "full", counts, by_route,
                             noncausal)
        count_train_run(counts, by_route)
        phase_seconds("train_families: zamba2-2.7b")
        # olmoe-1b-7b: the combine's bits, (a) at 2 layers, (c) at TF_MOE_LAYERS
        c, p = cfgs[MOE_ARCH], weights(MOE_ARCH, cfgs[MOE_ARCH])
        moe_same_bits_twice(c, p)
        n = TF_GRAD_LAYERS[MOE_ARCH]
        grads_vs_cpu(*first_layers(c, p, n), arch=MOE_ARCH,
                     depth_cut=f"{n} of 16 layers: the CPU's float32 experts stay in seconds")
        short_train(c, p, *TF_SHORT[MOE_ARCH],
                    depth_cut=f"{TF_MOE_LAYERS} of 16 layers: at 12 B a parameter (bf16 "
                              "weights and gradients, f32 moments) all 16 need ~83 GB")
        del p
        gc.collect()
        torch.cuda.empty_cache()
        phase_seconds("train_families: olmoe-1b-7b")
        phase("train_families_phase", seconds=time.monotonic() - t_phase,
              launches_on_the_main_path={k: launches[k] - run0[k] for k in launches})

    def train_family_configs() -> dict:
        """Each arch's config in the train_families phase, in its order, as
        the weights it takes were drawn: whisper dense, mamba2 at full size,
        internvl at one dense layer, zamba2 at full size, olmoe at
        TF_MOE_LAYERS layers (last: its 12 B a parameter need the most room)."""
        return {ENC_ARCH: dataclasses.replace(get_config(ENC_ARCH), w_bits=0),
                SSM_ARCH: get_config(SSM_ARCH),
                VLM_ARCH: dataclasses.replace(get_config(VLM_ARCH), n_layers=1, w_bits=0),
                HYB_ARCH: get_config(HYB_ARCH),
                MOE_ARCH: dataclasses.replace(get_config(MOE_ARCH), n_layers=TF_MOE_LAYERS)}

    def kept_layers(c, p, n) -> "lm.LMParams":
        """A copy on the card of ``p`` cut to its first ``n`` layers, so the
        weights it was cut from can be freed."""
        return lm.LMParams(tree_map(lambda t: t.detach().clone(),
                                    first_layers(c, p, n)[1].tree()))

        def copy(node):
            return ({k: copy(v) for k, v in node.items()} if isinstance(node, dict)
                    else node.detach().clone())
        return c, lm.LMParams(copy(p.tree()))

    # ---------------- phase 5 (b)'s follow-up turn (with --only fleet too) ----------------
    def followup_turn(c, p) -> None:
        """(b) K/V rows that decode made, adopted by a follow-up turn: the
        first wave of (b)'s traffic (8 prompts of TURN_TOKENS tokens,
        SESSION_GEN generated), then each request's follow-up (its prompt,
        its output and TURN_TOKENS fresh tokens), served without the cache
        and with it, teacher-forced by the uncached run's tokens. Cached,
        the follow-up adopts its transcript's blocks, whose generated rows
        the decode step made (the GEMV at M = LANES); uncached, one
        whole-prompt prefill makes them (the mma path). The gate: the
        largest |logit difference| at the follow-ups' sampled positions
        within FOLLOWUP_LOGIT_STEPS bf16 steps at the largest |logit|, the
        argmax the same at FOLLOWUP_MIN_ARGMAX of them; the first waves
        identical, and every follow-up a hit reaching into the generated
        rows."""
        from repro_torch.runtime.kv_pool import KVPool
        from repro_torch.runtime.prefix_cache import PrefixCache
        from repro_torch.runtime.scheduler import Scheduler

        t0 = time.monotonic()
        first = session_waves(c.vocab)[0]
        rng = np.random.default_rng(23)
        extra = [rng.integers(0, c.vocab, size=TURN_TOKENS).astype(np.int32) for _ in first]

        def run(cached, force=None) -> dict:
            pool = KVPool.for_slots(c, slots=LANES, max_len=SESSION_MAX_LEN, block_tokens=16,
                                    device=dev)
            sched = Scheduler(c, p, pool, slots=LANES, max_len=SESSION_MAX_LEN,
                              prefill_chunk=CHUNK,
                              prefix_cache=PrefixCache(pool) if cached else None)
            r1 = drive(sched, [first], SESSION_GEN)
            follow = [np.concatenate([prompt, np.asarray(r1["outputs"][i], np.int32), extra[i]])
                      for i, prompt in enumerate(first)]
            hit0 = sched.stats.prefix_hit_tokens
            if force is not None:
                sched._sample_one = lambda req, row: force[req.rid][len(req.output)]
            r2 = drive(sched, [follow], SESSION_GEN)
            r2["first_outputs"] = r1["outputs"]
            r2["followup_hit_tokens"] = sched.stats.prefix_hit_tokens - hit0
            r2["counts"] = {k: r1["counts"][k] + r2["counts"][k] for k in r2["counts"]}
            by_route = {}
            for r in (r1, r2):
                for name, by in r["by_route"].items():
                    for rt, n in by.items():
                        by_route.setdefault(name, {})
                        by_route[name][rt] = by_route[name].get(rt, 0) + n
            r2["by_route"] = by_route
            del sched, pool
            return r2

        cold = run(False)
        warm = run(True, force=cold["outputs"])
        count_main_path(cold)
        count_main_path(warm)
        keys = [key for key in cold["top_logits"] if key[0] >= len(first)]
        fv = forced_vs(dict(top_logits={k: warm["top_logits"][k] for k in keys}),
                       dict(top_logits={k: cold["top_logits"][k] for k in keys}))
        step = 2.0 ** (math.floor(math.log2(fv["max_abs_logit"])) - 7)
        transcripts = len(first) * (TURN_TOKENS + SESSION_GEN - 1)  # the tokens committed
        phase("serve_followup_turn", arch=c.name, quant=c.w_bits, requests=len(first),
              followup_tokens=TURN_TOKENS + SESSION_GEN + TURN_TOKENS, gen=SESSION_GEN,
              **fv, bf16_step=step,
              max_bf16_steps=fv["max_abs_logit_diff"] / step,
              argmax_share=fv["argmax_agree"] / fv["positions"],
              gate_steps=FOLLOWUP_LOGIT_STEPS, gate_argmax_share=FOLLOWUP_MIN_ARGMAX,
              followup_hit_tokens=warm["followup_hit_tokens"], transcript_tokens=transcripts,
              first_waves_identical=warm["first_outputs"] == cold["first_outputs"],
              launches_by_route_cache=warm["by_route"], launches_by_route_no_cache=cold["by_route"],
              seconds=time.monotonic() - t0)
        if warm["first_outputs"] != cold["first_outputs"]:
            fail("follow-up turn: the first waves differ cached and uncached")
        if warm["followup_hit_tokens"] < len(first) * (TURN_TOKENS + 16):
            fail(f"follow-up turn: {warm['followup_hit_tokens']} hit tokens: the follow-ups "
                 "did not adopt their generated rows")
        if not (fv["max_abs_logit_diff"] <= FOLLOWUP_LOGIT_STEPS * step
                and fv["argmax_agree"] >= FOLLOWUP_MIN_ARGMAX * fv["positions"]):
            fail(f"follow-up turn: cached vs uncached (teacher-forced) {fv}, bf16 step {step}")

    # ---------------- the fleet (phase 5 (d); --only fleet: alone) ----------------
    family_launches["fleet"] = {}

    @contextlib.contextmanager
    def heap_frozen():
        """The objects alive now frozen out of the collector's scans (they
        are not garbage: it collects first) until the block ends. The fleet
        phase captures ~34 graphs, each after a full collection
        (``CapturedStep``), which in the whole run's heap walks every object
        of the earlier phases; what the block itself leaves is collected as
        ever."""
        gc.collect()
        gc.freeze()
        try:
            yield
        finally:
            gc.unfreeze()

    def fleet_phase(c, p) -> None:
        """Phase 5 (d) (the module docstring says what it holds): ``c`` is
        smollm-360m's full config at 2 bits, ``p`` phase 5's weights."""
        from repro_torch.launch import fleet as fleet_cli
        from repro_torch.runtime import cluster as cl
        from repro_torch.runtime.kv_pool import choose_block_tokens
        from repro_torch.runtime.memledger import validate_ledger
        from repro_torch.runtime.spans import validate_trace
        from repro_torch.runtime.tracker import read_jsonl, replay_summary

        t_phase = time.monotonic()
        captures = []  # every run's engines' capture seconds
        spec = cl.TrafficSpec(n_requests=FLEET_REQUESTS, arrival_rate=2000.0,
                              prompt_lens=FLEET_PROMPT_LENS, gen_lens=FLEET_GEN_LENS,
                              session_reuse=0.3, vocab=c.vocab, seed=1)
        trace = cl.synthesize(spec)
        max_len = max(r.total_tokens for r in trace) + 8
        block = choose_block_tokens([spec.max_total_tokens] * spec.n_requests)
        cost = cl.StepCostModel.for_config(c, slots=LANES)  # the H100's data sheet
        rates = cl.measured_role_rates(cost, spec, slots=LANES)
        gals = cl.provision_split(4, rates)
        median = statistics.median(r.t_arrival for r in trace)
        slo = cl.SloPolicy(ttft=FLEET_SLO_TTFT, tpot=FLEET_SLO_TPOT)
        modes = {"single": (1, None, None), "fleet2": (2, None, None),
                 "disagg_gals": (4, None, None), "disagg_naive": (4, (2, 2), (0, median))}
        phase("fleet_cost_model", card=smi, modelled=True, hw="H100 SXM data sheet "
              "(perf.roofline.HW)", arch=c.name, w_bits=c.w_bits, slots=LANES,
              **dataclasses.asdict(cost), rho_p_req_s=rates.prefill_req_rate,
              rho_d_req_s=rates.decode_req_rate, r_f=rates.r_f, gals_split=list(gals),
              requests=spec.n_requests, max_len=max_len, block_tokens=block,
              median_arrival_s=median)

        def time_handoffs(cluster) -> list:
            """CUDA events around every ``export_blocks`` of the prefill
            engines and every adopting ``import_prefilled`` of the decode
            engines (with its host seconds); read once the run is done."""
            out = []
            for e in cluster.engines:
                sched = e.scheduler
                if e.role == "prefill":
                    def export(rid, n_tokens=None, inner=sched.pool.export_blocks):
                        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        a.record()
                        ids, ks, vs = inner(rid, n_tokens)
                        b.record()
                        out.append(("export", a, b, ks.nbytes + vs.nbytes, 0.0))
                        return ids, ks, vs

                    sched.pool.export_blocks = export
                elif e.role == "decode":
                    def adopt(payload, *, ready_at=None, inner=sched.import_prefilled):
                        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                        h0 = time.perf_counter()
                        a.record()
                        ok = inner(payload, ready_at=ready_at)
                        b.record()
                        if ok:
                            out.append(("import", a, b, payload.kv_bytes,
                                        time.perf_counter() - h0))
                        return ok

                    sched.import_prefilled = adopt
            return out

        # the seeded and the eager pairs' trace: the first requests, shorter
        checks = [dataclasses.replace(r, max_new_tokens=FLEET_CHECK_GEN)
                  for r in trace[:FLEET_CHECK_REQUESTS]]

        def run(mode, *, compiled=None, sampling=None, timed=False, trace=trace) -> dict:
            n, split, drain = modes[mode]
            common = dict(slots=LANES, max_len=max_len, block_tokens=block, cost=cost,
                          sampling=sampling, prefix_cache=True, slo=slo, compiled=compiled)
            if mode.startswith("disagg"):
                cluster = cl.DisaggCluster(c, p, n_engines=n, spec=spec, split=split, **common)
            else:
                cluster = cl.FleetCluster(c, p, n_engines=n, **common)
            handoffs = time_handoffs(cluster) if timed else []
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.monotonic()
            res = cluster.run(trace, drain_at=drain)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            counts, by_route = ops.launch_counts(), ops.launch_routes()
            label = f"fleet {mode} ({'eager' if compiled is False else 'compiled'}" + (
                ", seeded" if sampling else "") + f", {len(trace)} requests)"
            engines = []
            for e in cluster.engines:
                sched = e.scheduler
                sched.pool.validate()
                graphs = sched.graphs
                captures.extend(g.capture_s for g in graphs)
                if (e.role == "prefill" and sched.decode_graph is not None) or (
                        e.role == "decode" and (sched.prefill_buckets or len(graphs) > 1)):
                    fail(f"{label}: engine {e.engine_id} ({e.role}) captured "
                         f"{len(graphs)} graphs, buckets {sched.prefill_buckets}")
                st = sched.stats
                engines.append(dict(
                    engine=e.engine_id, role=e.role, completed=st.completed,
                    handoffs=st.handoffs, prefill_steps=st.prefill_steps,
                    decode_steps=st.decode_steps, graphs=len(graphs),
                    graph_replays=sum(g.replays for g in graphs),
                    capture_s=sum(g.capture_s for g in graphs),
                    graph_pool_mib=sum(g.pool_bytes for g in graphs) / 2**20,
                    kv_pool_mib=(sched.pool.k.nbytes + sched.pool.v.nbytes) / 2**20,
                    decode_step_host_ms=(st.decode_time / st.decode_steps * 1e3
                                         if st.decode_steps else None),
                    modelled_clock_s=e.clock))
            tokens = sum(len(v) for v in res.outputs.values())
            short = [r.rid for r in trace if len(res.outputs.get(r.rid, ())) != r.max_new_tokens]
            if short:
                fail(f"{label}: requests {short[:8]} did not get their max_new_tokens")
            # every prompt is > 16 rows: prefill on the mma path and flash's
            # tensor-core kernel, decode on the GEMV, 3 FFN matmuls a layer
            steps = {k: sum(x[k] for x in engines) for k in ("prefill_steps", "decode_steps")}
            want = {"packed_matmul": {"gemv": 3 * c.n_layers * steps["decode_steps"],
                                      "mma": 3 * c.n_layers * steps["prefill_steps"]},
                    "flash_fwd": {"mma": c.n_layers * steps["prefill_steps"]}}
            if by_route != want or counts["stream_matmul"] or counts["mvau"]:
                fail(f"{label}: launches {counts}, by route {by_route}, want {want}")
            report = res.report(slo).row()
            moved = sorted(rid for rid, eids in res.assignments.items() if len(eids) > 1)
            phase("fleet_run", card=smi, mode=mode, compiled=compiled is not False,
                  seeded=sampling is not None, requests=len(trace),
                  engines=len(cluster.engines),
                  split=list(getattr(cluster, "split", ()) or ()),
                  drain_at=list(drain) if drain else None, drained_requests_moved=moved,
                  measured=dict(wall_s=wall, generated_tokens=tokens, tokens_per_s=tokens / wall),
                  per_engine=engines, launches_counted=counts, launches_by_route=by_route,
                  modelled_slo=dict(makespan_s=report["makespan"], ttft_p50_s=report["ttft_p50"],
                                    ttft_p99_s=report["ttft_p99"], tpot_p50_s=report["tpot_p50"],
                                    tpot_p99_s=report["tpot_p99"], slo_met=report["slo_met"],
                                    goodput_tokens_per_s=report["goodput_tokens_per_s"],
                                    throughput_tokens_per_s=report["throughput_tokens_per_s"]))
            out = dict(outputs=res.outputs, counts=counts, by_route=by_route,
                       handoffs=sum(x["handoffs"] for x in engines), engines=engines)
            if timed:
                torch.cuda.synchronize()
                for kind in ("export", "import"):
                    xs = [(a.elapsed_time(b), nb, h) for k, a, b, nb, h in handoffs if k == kind]
                    ms = [x for x, _, _ in xs]
                    out[kind] = dict(count=len(xs),
                                     mean_mib=statistics.fmean(nb for _, nb, _ in xs) / 2**20,
                                     ms_mean=statistics.fmean(ms), ms_median=statistics.median(ms),
                                     ms_min=min(ms), ms_max=max(ms),
                                     host_ms_mean=statistics.fmean(h for _, _, h in xs) * 1e3)
            return out

        def count(r) -> None:
            count_main_path(r)
            add_family("fleet", r["by_route"])

        runs = {}
        for mode in modes:
            runs[mode] = r = run(mode, timed=mode == "disagg_gals")
            count(r)
        single = runs["single"]["outputs"]
        parted = {mode: sorted(rid for rid, toks in r["outputs"].items() if toks != single[rid])
                  for mode, r in runs.items()}
        hand = {mode: runs[mode]["handoffs"] for mode in ("disagg_gals", "disagg_naive")}
        g = runs["disagg_gals"]
        phase("fleet_handoffs", card=smi, measured=True, payloads=g["export"]["count"],
              payload_mib_mean=g["export"]["mean_mib"],
              export_blocks_ms={k: g["export"][f"ms_{k}"] for k in ("median", "mean", "min", "max")},
              import_ms={k: g["import"][f"ms_{k}"] for k in ("median", "mean", "min", "max")},
              import_host_ms_mean=g["import"]["host_ms_mean"], imports=g["import"]["count"],
              bytes_per_token=c.n_kv_cache_layers * 2 * c.n_kv * c.hd * 2,
              timing="CUDA events around export_blocks / import_prefilled, host gaps included")
        phase("fleet_streams", streams=len(single), parted_from_single=parted, handoffs=hand)
        if any(parted.values()) or any(n != spec.n_requests for n in hand.values()):
            fail(f"fleet: streams part from single's {parted}, handoffs {hand}")
        if g["export"]["count"] != spec.n_requests or g["import"]["count"] != spec.n_requests:
            fail(f"fleet: {g['export']['count']} exports, {g['import']['count']} imports")

        # seeded sampling: single against disagg_gals, and disagg_gals
        # eager against compiled (tokens and launches by route)
        seeded = lm.SamplingParams(temperature=0.8, top_k=16, top_p=0.9, seed=0)
        s1 = run("single", sampling=seeded, trace=checks)
        compiled = run("disagg_gals", sampling=seeded, trace=checks)
        eager = run("disagg_gals", sampling=seeded, compiled=False, trace=checks)
        for r in (s1, compiled, eager):
            count(r)
        same_seeded = s1["outputs"] == compiled["outputs"]
        same_tokens = eager["outputs"] == compiled["outputs"]
        same_launches = (eager["counts"], eager["by_route"]) == (
            compiled["counts"], compiled["by_route"])
        # a greedy stream's head is the greedy stream of the shorter request
        greedy_head = {r.rid: single[r.rid][:FLEET_CHECK_GEN] for r in checks}
        phase("fleet_checks", requests=len(checks), gen=FLEET_CHECK_GEN,
              seeded_single_vs_disagg_identical=same_seeded,
              seeded_differs_from_greedy=s1["outputs"] != greedy_head,
              disagg_gals_compiled_vs_eager_tokens_identical=same_tokens,
              disagg_gals_compiled_vs_eager_launches_identical=same_launches)
        if not (same_seeded and same_tokens and same_launches):
            fail(f"fleet: seeded identical {same_seeded}, compiled = eager tokens {same_tokens}, "
                 f"launches {same_launches} ({compiled['by_route']} vs {eager['by_route']})")

        # (b) the entry point: disagg on 4 engines, its interleaved stream
        out_dir = ROOT / "build" / "chip_smoke"
        out_dir.mkdir(parents=True, exist_ok=True)
        trace_path, json_path = out_dir / "fleet.jsonl", out_dir / "fleet.json"
        for path in (trace_path, json_path):
            path.unlink(missing_ok=True)
        argv = ["--arch", "smollm-360m", "--mode", "disagg", "--engines", "4", "--quant", "2",
                "--slots", str(LANES), "--requests", str(FLEET_REQUESTS),
                "--trace-out", str(trace_path), "--json", str(json_path)]
        buf = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            rc = fleet_cli.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        sys.stderr.write(buf.getvalue())
        if rc != 0:
            fail(f"repro_torch.launch.fleet.main({argv}) returned {rc}")
        count(dict(counts=counts, by_route=by_route))
        records = read_jsonl(trace_path)
        doc = json.loads(json_path.read_text())
        errors = validate_trace(records) + validate_ledger(records)
        for s in doc["engine_summaries"]:
            rep = replay_summary(records, engine=s["engine"])
            errors += [f"engine {s['engine']}: replayed {k} {rep[k]} != {s[k]}" for k in (
                "completed", "handoffs", "prefill_steps", "prefill_tokens", "decode_steps",
                "generated_tokens") if rep[k] != s[k]]
        r = doc["report"]
        phase("fleet_cli", card=smi, argv=argv, rc=rc, wall_s=wall, records=len(records),
              split=doc["split"], completed=r["completed"], generated_tokens=r["generated_tokens"],
              launches_counted=counts, launches_by_route=by_route, errors=errors[:8],
              modelled_slo={k: r[k] for k in ("makespan", "ttft_p50", "ttft_p99", "tpot_p50",
                                               "tpot_p99", "goodput_tokens_per_s")})
        if errors or r["completed"] != FLEET_REQUESTS:
            fail(f"fleet CLI: {r['completed']} completed; trace / ledger / replay: {errors[:8]}")
        measured = [x["decode_step_host_ms"] for x in g["engines"] if x["decode_step_host_ms"]]
        phase("fleet_modelled_vs_measured", card=smi,
              modelled_decode_s_per_step=cost.decode_s_per_step,
              modelled_prefill_s_per_token=cost.prefill_s_per_token,
              measured_compiled_decode_step_host_ms=statistics.fmean(measured),
              ratio=statistics.fmean(measured) / 1e3 / cost.decode_s_per_step)
        phase("fleet_phase", seconds=time.monotonic() - t_phase, graphs_captured=len(captures),
              capture_s=sum(captures))

    def analysis_phase(c, p, measured_tokens_per_s) -> None:
        """The analysis phase (the module docstring says what it holds):
        ``c`` is smollm-360m's full config at 2 bits, ``p`` phase 5's
        weights, ``measured_tokens_per_s`` phase 5's compiled serve cell's
        tokens/s by --quant (empty under ``--only analysis``)."""
        from repro_torch.configs import ARCH_IDS
        from repro_torch.data.pipeline import TokenPipeline
        from repro_torch.dist import sharding as shd
        from repro_torch.dist.legalize import validate_spec
        from repro_torch.dist.mesh_axes import MeshView
        from repro_torch.launch.port import lm_port_rows
        from repro_torch.models.config import ShapeConfig
        from repro_torch.optim.adamw import AdamW
        from repro_torch.perf import op_analysis
        from repro_torch.perf.roofline import HW, roofline
        from repro_torch.runtime.steps import make_train_step

        t_phase = time.monotonic()
        # (a) the port ladder: data-sheet arithmetic over GPU_TIERS
        traffic = dict(lanes=LANES, prompt_len=PROMPT, gen_len=64)
        keep = ("device", "variant", "fits_hbm", "tokens_per_s", "bound", "delta_fps_pct",
                "fcmp_vs_dense_speedup_pct")
        ladder = {}
        for arch in ("smollm_360m", "phi3_medium_14b", "internvl2_76b"):
            for quant in (2, 0):
                rows = lm_port_rows(arch, quant=quant, **traffic)
                ladder[arch, quant] = rows
                phase("port_ladder", card=smi, modelled=True, arch=arch, quant=quant, **traffic,
                      rows=[{k: r[k] for k in keep if k in r} for r in rows])
        for quant in (2, 0):
            variant = "fcmp_packed" if quant else "dense"
            modelled = next(r["tokens_per_s"] for r in ladder["smollm_360m", quant]
                            if (r["device"], r["variant"]) == ("h100_sxm", variant))
            measured = measured_tokens_per_s.get(quant)
            phase("port_h100_vs_measured", card=smi, arch="smollm_360m", quant=quant, **traffic,
                  modelled_tokens_per_s=modelled, measured_compiled_tokens_per_s=measured,
                  modelled_over_measured=modelled / measured if measured else None)

        # (b) the whole-step roofline: the op walk of each eager step, the
        # card's ms of the step as it runs (the captured replay, or eager)
        def card_ms(step, reps=20) -> float:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            spans = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                spans.append((start, end))
            torch.cuda.synchronize()
            return statistics.median(a.elapsed_time(b) for a, b in spans)

        def walk(label, eager, timed, shape, model_cfg, timed_as) -> None:
            ops.reset_launch_counts()
            cost = op_analysis.analyze(eager)
            torch.cuda.synchronize()
            counted = {k: n for k, n in ops.launch_counts().items() if n}
            ms = card_ms(timed)
            rep = roofline(label, cost, model_cfg, shape, n_devices=1)
            card_s = ms / 1e3
            shares = dict(useful_compute_share=rep.model_flops / (card_s * HW.peak_flops),
                          bytes_share=cost.traffic_bytes / (card_s * HW.hbm_bw))
            phase("step_roofline", card=smi, step=label, arch=model_cfg.name,
                  w_bits=model_cfg.w_bits, timed=timed_as, card_ms=ms, **shares,
                  dot_share=cost.dot_flops / (card_s * HW.peak_flops),
                  dot_flops=cost.dot_flops, traffic_bytes=cost.traffic_bytes,
                  model_flops=rep.model_flops, transcendentals=cost.transcendentals,
                  t_compute_ms=rep.t_compute * 1e3, t_memory_ms=rep.t_memory * 1e3,
                  bottleneck=rep.bottleneck, useful_flops_ratio=rep.useful_flops_ratio,
                  roofline_fraction=rep.roofline_fraction,
                  walk_kernel_launches=cost.kernel_launches, counted_launches=counted,
                  top_ops_by_bytes=[dict(bytes=v, op=op, shapes=sh, calls=n) for v, op, sh, n
                                    in op_analysis.top_contributors(cost, "traffic", 5)])
            bad = {k: v for k, v in shares.items() if not 0.0 < v <= 1.05}
            if bad:
                fail(f"{label}: shares {bad} outside (0, 1.05]: the walk's count is wrong")
            if cost.kernel_launches != counted:
                fail(f"{label}: the walk saw kernel launches {cost.kernel_launches}, the "
                     f"counters {counted}")
            if shape.kind == "train" and cost.dot_flops < 0.9 * rep.model_flops:
                fail(f"{label}: the walk's dot flops {cost.dot_flops:.4g} are below 0.9 x the "
                     f"model's {rep.model_flops:.4g}: the backward was not counted")

        rows = LANES * MAX_LEN + 16
        pk = torch.zeros((c.n_layers, rows, c.n_kv, c.hd), dtype=torch.bfloat16, device=dev)
        pv = torch.zeros_like(pk)
        table = (16 + torch.arange(LANES * MAX_LEN, device=dev)).reshape(LANES, MAX_LEN)
        tok = torch.from_numpy(np.random.default_rng(5).integers(0, c.vocab, (LANES, 1))).to(dev)
        lens = torch.full((LANES,), PROMPT + 8, device=dev)
        decode = CapturedStep(
            lambda t_, tb, ln: lm.decode_step_paged(p, c, t_, pk, pv, tb, ln)[0],
            device=dev, mempool=torch.cuda.graph_pool_handle())
        host_in = (tok.cpu(), table.cpu(), lens.cpu())
        decode(*host_in)
        walk("decode step, 8 lanes", lambda: lm.decode_step_paged(p, c, tok, pk, pv, table, lens),
             lambda: decode(*host_in), ShapeConfig("decode", 1, LANES, "decode"), c,
             "captured replay")
        del decode
        chunk_tok = torch.from_numpy(
            np.random.default_rng(6).integers(0, c.vocab, size=(1, CHUNK))).to(dev)
        ctable = (16 + torch.arange(MAX_LEN, device=dev))[None]
        chunk_in = (chunk_tok.cpu(), ctable.cpu(), ctable[:, CHUNK:2 * CHUNK].cpu(),
                    torch.tensor([CHUNK]), torch.tensor([CHUNK - 1]))
        chunk_dev = tuple(t.to(dev) for t in chunk_in)
        chunk = CapturedStep(
            lambda *xs: lm.prefill_chunk_paged(p, c, xs[0], pk, pv, *xs[1:])[0],
            device=dev, mempool=torch.cuda.graph_pool_handle())
        chunk(*chunk_in)
        walk(f"prefill chunk, {CHUNK} tokens at {CHUNK}",
             lambda: lm.prefill_chunk_paged(p, c, chunk_dev[0], pk, pv, *chunk_dev[1:]),
             lambda: chunk(*chunk_in), ShapeConfig("prefill_chunk", CHUNK, 1, "prefill"), c,
             "captured replay")
        del chunk, pk, pv
        dense = dataclasses.replace(c, w_bits=0)
        tparams = lm.init_params(dense, 0, device=dev, trainable=True)
        opt = AdamW()
        state = [opt.init(tparams)]
        step_fn = make_train_step(dense, opt, remat="none")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in TokenPipeline(
            vocab=dense.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0).batch_at(0).items()}

        def train_step():
            _, state[0], _ = step_fn(tparams, state[0], batch)

        train_step()
        walk(f"train step, {TRAIN_BATCH} x {TRAIN_SEQ}, --remat none", train_step, train_step,
             ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"), dense, "eager step")
        del tparams, state, step_fn
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the sharding policy at full size over production mesh views
        for mesh in (MeshView(("data", "model"), (16, 16)),
                     MeshView(("pod", "data", "model"), (2, 16, 16))):
            fractions = {}
            for arch in ARCH_IDS:
                acfg = get_config(arch)
                abstract = dict(shd.leaves_with_paths(lm.abstract_params(acfg).tree()))
                specs = list(shd.leaves_with_paths(shd.param_specs(acfg, mesh)))
                for path, spec in specs:
                    validate_spec(tuple(abstract[path].shape), spec, mesh)
                if len(specs) != len(abstract):
                    fail(f"sharding policy: {arch} has {len(specs)} specs for "
                         f"{len(abstract)} leaves")
                fractions[arch] = shd.sharded_byte_fraction(acfg, mesh)
            phase("sharding_policy", mesh=dict(zip(mesh.axis_names, mesh.sizes)),
                  validated=True, sharded_byte_fraction=fractions)
        phase("analysis_phase", seconds=time.monotonic() - t_phase)

    if opts.only == "fleet":
        cq = dataclasses.replace(get_config("smollm_360m"), w_bits=2)
        pq = lm.init_params(cq, 0, device=dev)
        followup_turn(cq, pq)
        phase_seconds("5 (b) follow-up turn")
        with heap_frozen():
            fleet_phase(cq, pq)
        phase_seconds("5 (d) fleet")
        print("[chip_smoke] --only fleet: stopped after the follow-up turn and the fleet",
              file=sys.stderr)
        return 0

    if opts.only == "analysis":
        cq = dataclasses.replace(get_config("smollm_360m"), w_bits=2)
        analysis_phase(cq, lm.init_params(cq, 0, device=dev), {})
        phase_seconds("analysis")
        print("[chip_smoke] --only analysis: stopped after the analysis phase", file=sys.stderr)
        return 0

    if opts.only == "train_families":
        prefetch(*train_family_configs().values())
        train_families_phase({})
        print("[chip_smoke] --only train_families: stopped after the train_families phase",
              file=sys.stderr)
        return 0

    if opts.only == "vlm":
        vlm_phase()
        print("[chip_smoke] --only vlm: stopped after the vlm phase", file=sys.stderr)
        return 0

    if opts.only == "encdec":
        encdec_phase()
        print("[chip_smoke] --only encdec: stopped after the enc-dec phase", file=sys.stderr)
        return 0

    if opts.only == "ssm":
        ssm_phase()
        print("[chip_smoke] --only ssm: stopped after the SSM phase", file=sys.stderr)
        return 0

    if opts.only == "hybrid":
        hybrid_phase()
        print("[chip_smoke] --only hybrid: stopped after the hybrid phase", file=sys.stderr)
        return 0

    if opts.only == "moe":
        moe_phase()
        print("[chip_smoke] --only moe: stopped after the MoE phase", file=sys.stderr)
        return 0

    if opts.only == "prefill":
        prefill_phase()
        print("[chip_smoke] --only prefill: stopped after the prefill profile", file=sys.stderr)
        return 0

    phase_seconds("1-2 device, build")

    # ---------------- 3. kernels vs their plain versions ----------------
    cfg = get_config("smollm_360m")
    d, ff = cfg.d_model, cfg.d_ff
    for bits in (1, 2):
        for k, n in ((d, ff), (ff, d)):
            for m in (LANES, CHUNK, PROMPT):
                packed_case(bits, m, k, n, torch.bfloat16, timed=True)
    # the f32-x route (the CUDA-core tiled kernel) at the chunk's M
    for k, n in ((d, ff), (ff, d)):
        packed_case(2, CHUNK, k, n, torch.float32, timed=True)
    # ragged M, N and K for the tensor-core path (K % 64 = 8, N % 128 = 104;
    # 8- and 4-block clusters), and K % 8 != 0 with an odd N, which take
    # the synchronous copies instead of cp.async
    for bits in (1, 2):
        for m in (17, 100, 300):
            packed_case(bits, m, 968, 1000, torch.bfloat16, timed=False)
    packed_case(2, 33, 972, 999, torch.bfloat16, timed=False)
    # the GEMV's edges, from a generator of their own (the later phases'
    # inputs stay as they were): M 1 and 16 at both decode shapes (timed:
    # the 8- and 16-row tiles against M=8), M 5; ragged K (968, and 972
    # at 2 bits: scalar x loads for bf16) with odd N (999, 1000: byte
    # loads of the carrier); f32 x; and a K of one carrier row, too short
    # to split
    gemv_gen = torch.Generator(device="cpu").manual_seed(1)
    for bits in (1, 2):
        for k, n in ((d, ff), (ff, d)):
            for m in (1, 16):
                packed_case(bits, m, k, n, torch.bfloat16, timed=True, g=gemv_gen)
            packed_case(bits, 5, k, n, torch.bfloat16, timed=False, g=gemv_gen)
            packed_case(bits, LANES, k, n, torch.float32, timed=False, g=gemv_gen)
        packed_case(bits, LANES, 968, 999, torch.bfloat16, timed=False, g=gemv_gen)
        packed_case(bits, 16, 968, 1000, torch.bfloat16, timed=False, g=gemv_gen)
    packed_case(2, 5, 972, 1000, torch.bfloat16, timed=False, g=gemv_gen)
    packed_case(2, LANES, 972, 999, torch.float32, timed=False, g=gemv_gen)
    packed_case(1, 3, 8, 1000, torch.bfloat16, timed=False, g=gemv_gen)
    # a row's bits must not follow M: the mma path at every M in
    # INVARIANT_MS bitwise equal, row by row, to the same rows in the
    # M=256 launch (a prompt's rows in a bucket, in a chunk, or prefilled
    # after a prefix-cache hit), and the GEMV's at M 1-15 to its M=16 rows
    inv_gen = torch.Generator(device="cpu").manual_seed(6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def rows_do_not_follow_m(bits, k, n, g, arch="smollm_360m", big_m=0):
        """The mma path's rows at every M of INVARIANT_MS bitwise the same
        rows of its M=256 launch, the GEMV's at M 1-15 those of its M=16
        launch; with ``big_m``, the M=256 launch's rows also bitwise the
        head of a ``big_m``-row launch."""
        w = lm.make_packed(torch.randn((k, n), generator=g).to(dev), bits)
        x = torch.randn((CHUNK, k), generator=g).to(dev, torch.bfloat16)
        full = pm.packed_matmul(x, w["packed"], w["scale"], bits, k)
        small = pm.packed_matmul(x[:16], w["packed"], w["scale"], bits, k)
        mma_off = [m for m in INVARIANT_MS if not same_bits(
            pm.packed_matmul(x[:m], w["packed"], w["scale"], bits, k), full[:m])]
        gemv_off = [m for m in range(1, 16) if not same_bits(
            pm.packed_matmul(x[:m], w["packed"], w["scale"], bits, k), small[:m])]
        if big_m:
            xb = torch.cat([x, torch.randn((big_m - CHUNK, k), generator=g).to(dev, x.dtype)])
            if not same_bits(pm.packed_matmul(xb, w["packed"], w["scale"], bits, k)[:CHUNK],
                             full):
                mma_off.append(big_m)
        phase("packed_matmul_rows_do_not_follow_m", arch=arch, bits=bits, k=k, n=n,
              mma_ms=INVARIANT_MS + ((big_m,) if big_m else ()),
              mma_splits=pm.mma_plan(k, n, sms)[0],
              mma_ms_whose_rows_differ=mma_off, gemv_ms_whose_rows_differ=gemv_off)
        if mma_off or gemv_off:
            fail(f"packed_matmul bits={bits} K={k} N={n}: rows follow M (mma at M "
                 f"{mma_off}, GEMV at M {gemv_off})")

    for bits in (1, 2):
        for k, n in ((d, ff), (ff, d)):
            rows_do_not_follow_m(bits, k, n, inv_gen)
    # what the timing method itself shows for a launch that does almost
    # nothing: the floor under the ~10 us kernel times above
    one = torch.empty(1, device=dev)
    timing_floor_ms = median_ms(lambda: one.fill_(0.0))
    phase("timing_floor", median_ms=timing_floor_ms, launch="torch.Tensor.fill_ of 1 element")

    hq, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    bf16 = torch.bfloat16
    # full-prompt prefill, a sliding window, and the chunk-prefill shape (a
    # 256-token chunk at offset 256 over the 640 gathered pool rows); then
    # the f32 route (the CUDA-core kernel) at the prefill shape
    flash_case("prefill_causal", hq, hkv, PROMPT, PROMPT, hd, True, 0, 0, bf16, True)
    flash_case("window_128", hq, hkv, PROMPT, PROMPT, hd, True, 128, 0, bf16, True)
    flash_case("chunk_q_offset", hq, hkv, CHUNK, MAX_LEN, hd, True, 0, CHUNK, bf16, True)
    flash_case("prefill_causal", hq, hkv, PROMPT, PROMPT, hd, True, 0, 0, torch.float32, True)
    # edges of the tensor-core kernel's fragments and masks, checked only
    for args in (
        ("d32", 4, 2, 256, 256, 32, True, 0, 0),
        ("d128", 4, 2, 256, 256, 128, True, 0, 0),
        ("ragged_200", hq, hkv, 200, 200, hd, True, 0, 0),
        ("ragged_q_offset_g3", 6, 2, 77, 333, hd, True, 0, 256),
        ("window_q_offset", 6, 2, 100, 400, hd, True, 77, 300),
        ("no_key_rows", 4, 2, 64, 64, hd, True, 128, 256),
        ("some_rows_without_keys", 4, 2, 96, 64, hd, True, 32, 40),
        ("d128_ragged_window", 4, 2, 130, 130, 128, True, 17, 0),
        ("not_causal", 6, 2, 100, 150, hd, False, 0, 0),
    ):
        flash_case(*args, bf16, False)
    blind = next(c["rows_without_keys"] for c in flash_checks if c["case"] == "no_key_rows")
    if blind != 64:
        fail(f"flash_fwd no_key_rows: {blind} rows without keys, not 64")
    # the device q_offset (one int32 on the card, which the kernel reads: the
    # scheduler's one chunk graph serves every start) at the chunk shape,
    # bitwise against the host-int launch at the same offset and within
    # tolerance of the plain version, both launches timed; then a
    # whole-prompt bucket whose Sq = Sk is no multiple of the 64-row tile.
    # Inputs from a generator of their own (the later phases' stay as they were)
    qo_gen = torch.Generator(device="cpu").manual_seed(5)
    qc, kc, vc = (torch.randn((h_, n_, hd), generator=qo_gen).to(dev, bf16)
                  for h_, n_ in ((hq, CHUNK), (hkv, MAX_LEN), (hkv, MAX_LEN)))
    q_offset_cases = []
    for start in (0, 37, CHUNK, MAX_LEN - CHUNK - 1):
        dev_off = torch.tensor([start], dtype=torch.int32, device=dev)
        host = fa.flash_fwd(qc, kc, vc, causal=True, q_offset=start)
        on_dev = fa.flash_fwd(qc, kc, vc, causal=True, q_offset=dev_off)
        want_o, want_lse = ref.flash_fwd_ref(qc, kc, vc, causal=True, q_offset=start)
        torch.cuda.synchronize()
        case = dict(
            case="device_q_offset", sq=CHUNK, sk=MAX_LEN, heads=hq, kv_heads=hkv, d=hd,
            q_offset=start, bitwise_equal_to_host_int=all(map(same_bits, on_dev, host)),
            max_abs_err=(on_dev[0].float() - want_o.float()).abs().max().item(),
            lse_err=(on_dev[1] - want_lse).abs().max().item(),
            ms_device_q_offset=median_ms(
                lambda: fa.flash_fwd(qc, kc, vc, causal=True, q_offset=dev_off)),
            ms_host_q_offset=median_ms(
                lambda: fa.flash_fwd(qc, kc, vc, causal=True, q_offset=start)),
        )
        q_offset_cases.append(case)
        phase("kernel", name="flash_fwd", check_only=True, **case)
        if not case["bitwise_equal_to_host_int"]:
            fail(f"flash_fwd device q_offset {start}: differs from the host-int launch")
        if not (case["max_abs_err"] <= FLASH_OUT_TOL and case["lse_err"] <= FLASH_LSE_TOL):
            fail(f"flash_fwd device q_offset {start}: out err {case['max_abs_err']}, "
                 f"lse err {case['lse_err']}")
    flash_case("bucket_208", hq, hkv, 208, 208, hd, True, 0, 0, bf16, False, g=qo_gen)
    # phase 5 (c)'s shapes, from a generator of their own: the verify step
    # at --quant 2 on 8 lanes (chains of 3 and 4: the mma path at M 24 and
    # 32) and the twin drafter's (1, MAX_LEN) prompt prefill (the mma path
    # at M = MAX_LEN, a causal MAX_LEN x MAX_LEN flash_fwd)
    spec_gen = torch.Generator(device="cpu").manual_seed(11)
    for bits in (1, 2):
        for k, n in ((d, ff), (ff, d)):
            for m in (LANES * (SPEC_DEPTH - 1), LANES * SPEC_DEPTH, MAX_LEN):
                packed_case(bits, m, k, n, bf16, timed=bits == 2, g=spec_gen)
    flash_case("drafter_prefill", hq, hkv, MAX_LEN, MAX_LEN, hd, True, 0, 0, bf16, True,
               g=spec_gen)

    def visible_pairs(sq, sk, causal, window, q_off) -> int:
        qp = q_off + np.arange(sq)[:, None]
        kp = np.arange(sk)[None, :]
        vis = np.ones((sq, sk), bool)
        if causal:
            vis &= qp >= kp
        if window:
            vis &= qp - kp < window
        return int(vis.sum())

    def flash_bwd_case(label, b, h, h_kv, sq, sk, dh, dt, timed=False,
                       causal=True, window=0, q_off=0, g=gen):
        """Both passes on the card against ``flash_bwd_dq_ref`` /
        ``flash_bwd_dkv_ref`` in f32 on the same inputs (the bf16 tensors
        upcast): every output within FLASH_BWD_TOL of its largest value."""
        q = torch.randn((b * h, sq, dh), generator=g).to(dev, dt)
        kk = torch.randn((b * h_kv, sk, dh), generator=g).to(dev, dt)
        vv = torch.randn((b * h_kv, sk, dh), generator=g).to(dev, dt)
        do = torch.randn((b * h, sq, dh), generator=g).to(dev, dt)
        kw = dict(causal=causal, window=window, q_offset=q_off)
        out, lse = fa.flash_fwd(q, kk, vv, **kw)
        dq, delta = fa.flash_bwd_dq(q, kk, vv, out, lse, do, **kw)
        dk, dv = fa.flash_bwd_dkv(q, kk, vv, do, lse, delta, **kw)
        again = (*fa.flash_bwd_dq(q, kk, vv, out, lse, do, **kw),
                 *fa.flash_bwd_dkv(q, kk, vv, do, lse, delta, **kw))
        q32, k32, v32, o32, do32 = (t.float() for t in (q, kk, vv, out, do))
        want_dq, want_delta = ref.flash_bwd_dq_ref(q32, k32, v32, o32, lse, do32, **kw)
        want_dk, want_dv = ref.flash_bwd_dkv_ref(q32, k32, v32, do32, lse, want_delta, **kw)
        torch.cuda.synchronize()
        tol = FLASH_BWD_TOL if dt == torch.bfloat16 else FLASH_BWD_TOL_F32
        errs = {}
        for name, got, want in (("dq", dq, want_dq), ("delta", delta, want_delta),
                                ("dk", dk, want_dk), ("dv", dv, want_dv)):
            err = (got.float() - want).abs().max().item()
            errs[name] = dict(max_abs_err=err, rel_err=err / max(want.abs().max().item(), 1e-30))
            if not (math.isfinite(err) and errs[name]["rel_err"] <= tol):
                fail(f"flash_bwd {label} {name}: rel err {errs[name]['rel_err']} > {tol}")
        if not all(map(same_bits, (dq, delta, dk, dv), again)):
            fail(f"flash_bwd {label}: two runs differ")
        base = dict(case=label, batch=b, heads=h, kv_heads=h_kv, sq=sq, sk=sk, d=dh,
                    dtype=str(dt).replace("torch.", ""), causal=causal, window=window,
                    q_offset=q_off)
        if not timed:
            phase("kernel", name="flash_bwd", **base, errors=errs)
            return None
        pairs = visible_pairs(sq, sk, causal, window, q_off) * b * h
        e = q.element_size()
        # each input read once, each output written once
        dq_bytes = e * (4 * q.numel() + 2 * kk.numel()) + 8 * lse.numel()
        dkv_bytes = e * (2 * q.numel() + 4 * kk.numel()) + 8 * lse.numel()
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        dq_bound, dq_by = bound_ms(dq_bytes, 6.0 * dh * pairs, peak)
        dkv_bound, dkv_by = bound_ms(dkv_bytes, 8.0 * dh * pairs, peak)
        # the library's yardstick: one backward of SDPA (dq, dk and dv together)
        q4 = q.reshape(b, h, sq, dh).detach().requires_grad_()
        k4 = kk.reshape(b, h_kv, sk, dh).detach().requires_grad_()
        v4 = vv.reshape(b, h_kv, sk, dh).detach().requires_grad_()
        o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal, enable_gqa=True)
        do4 = do.reshape(b, h, sq, dh)
        library = median_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True))
        dq_case = dict(
            **base, max_abs_err=errs["dq"]["max_abs_err"], errors=errs, pairs=pairs,
            ms=median_ms(lambda: fa.flash_bwd_dq(q, kk, vv, out, lse, do, **kw)),
            host_us=host_us(lambda: fa.flash_bwd_dq(q, kk, vv, out, lse, do, **kw)),
            plain_ms=median_ms(lambda: ref.flash_bwd_dq_ref(q, kk, vv, out, lse, do, **kw)),
            library_ms=library, bound_ms=dq_bound, bound_by=dq_by, bytes=dq_bytes,
            flops=6.0 * dh * pairs,
        )
        dkv_case = dict(
            **base, max_abs_err=max(errs["dk"]["max_abs_err"], errs["dv"]["max_abs_err"]),
            errors=errs, pairs=pairs,
            ms=median_ms(lambda: fa.flash_bwd_dkv(q, kk, vv, do, lse, delta, **kw)),
            host_us=host_us(lambda: fa.flash_bwd_dkv(q, kk, vv, do, lse, delta, **kw)),
            plain_ms=median_ms(lambda: ref.flash_bwd_dkv_ref(q, kk, vv, do, lse, delta, **kw)),
            library_ms=library, bound_ms=dkv_bound, bound_by=dkv_by, bytes=dkv_bytes,
            flops=8.0 * dh * pairs,
        )
        phase("kernel", name="flash_bwd_dq", **dq_case)
        phase("kernel", name="flash_bwd_dkv", **dkv_case)
        phase("kernel", name="flash_bwd", case=label, both_passes_ms=dq_case["ms"] + dkv_case["ms"],
              library_ms=library, plain_ms=median_ms(
                  lambda: ref.flash_bwd_ref(q, kk, vv, out, lse, do, **kw)))
        return dq_case, dkv_case

    head_dq, head_dkv = flash_bwd_case("train_causal", TRAIN_BATCH, hq, hkv, TRAIN_SEQ,
                                       TRAIN_SEQ, hd, bf16, timed=True)
    flash_bwd_checks = [
        ("window_128", 1, hq, hkv, PROMPT, PROMPT, hd, bf16, False, True, 128, 0),
        ("q_offset", 1, hq, hkv, CHUNK, MAX_LEN, hd, bf16, False, True, 0, CHUNK),
        ("ragged", 2, hq, hkv, 333, 333, hd, bf16, False, True, 0, 0),
        ("ragged_q_offset", 1, 6, 2, 77, 190, hd, bf16, False, True, 0, 113),
        ("g1", 2, 4, 4, 256, 256, hd, bf16, False, True, 0, 0),
        ("d32", 2, 4, 2, 200, 200, 32, bf16, False, True, 0, 0),
        ("d128", 2, 4, 2, 200, 200, 128, bf16, False, True, 0, 0),
        ("f32", 2, hq, hkv, 256, 256, hd, torch.float32, False, True, 0, 0),
        ("f32_d128_window", 1, 4, 2, 130, 130, 128, torch.float32, False, True, 17, 0),
        ("not_causal", 1, 6, 2, 64, 100, hd, bf16, False, False, 0, 0),
        # rows 56.. (positions 96..) see no key: dq 0, and nothing in dk/dv
        ("some_rows_without_keys", 1, 4, 2, 96, 64, hd, bf16, False, True, 32, 40),
        # D 128 stages 32 query rows at a time in the dk/dv pass
        ("d128_window_q_offset", 1, 4, 2, 130, 200, 128, bf16, False, True, 17, 70),
    ]
    for args in flash_bwd_checks:
        flash_bwd_case(*args)

    from repro_torch.kernels import weight_stream as ws
    from repro_torch.runtime.residency import compile_residency_plan, stream_ahead_depth

    def stream_case(m, k, n, bits, depth, timed, w_dtype=torch.bfloat16,
                    x_dtype=torch.bfloat16, g=gen, ring=None):
        """``stream_matmul`` on the card against its plain version on the
        same inputs (rel err within STREAM_REL_TOL), and the same bits on a
        second run. ``ring`` names how the split's stages must meet the
        depth ("fewer", "equal", or "cycles" past it). Timed cases beside the
        plain version, the library's matmul on the decoded weight, the bound,
        and ``packed_matmul``'s GEMV on the same carrier (bits 1/2)."""
        x = torch.randn((m, k), generator=g).to(dev, x_dtype)
        if bits:
            per = 8 // bits
            packed = lm.make_packed(torch.randn((k + (-k) % per, n), generator=g), bits)
            w = packed["packed"].to(dev)
            scale = packed["scale"].to(dev)
            w_dec = ref.decode_weights(w, bits, k).to(x_dtype)
        else:
            w = torch.randn((k, n), generator=g).to(dev, w_dtype)
            scale, w_dec = None, w.to(x_dtype)
        got = ws.stream_matmul(x, w, scale, bits, k, depth)
        want = ref.stream_matmul_ref(x, w, scale, bits, k)
        again = ws.stream_matmul(x, w, scale, bits, k, depth)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        label = (f"stream_matmul bits={bits} M={m} K={k} N={n} depth={depth} w={w.dtype} "
                 f"x={x_dtype}")
        if not math.isfinite(err) or rel > STREAM_REL_TOL:
            fail(f"{label}: rel err {rel}")
        if not same_bits(got, again):
            fail(f"{label}: two runs differ")
        splits, kps = ws.split_plan(m, k, n, sms)
        sk = ws.stage_len(kps, depth, bits, w.element_size(), x.element_size())
        stages = -(-min(k, kps) // sk)
        want_ring = {"fewer": stages < depth, "equal": stages == depth,
                     "cycles": stages > depth}
        if ring is not None and not want_ring[ring]:
            fail(f"{label}: {stages} stages of {sk} for depth {depth}, not '{ring}'")
        case = dict(bits=bits, m=m, k=k, n=n, depth=depth, w_dtype=str(w.dtype),
                    x_dtype=str(x_dtype).replace("torch.", ""), splits=splits,
                    k_per_split=min(k, kps), stage_k=sk, stages=stages, max_abs_err=err,
                    rel_err=rel)
        if timed:
            n_bytes = (x.numel() * x.element_size() + w.numel() * w.element_size() + m * n * 4
                       + (n * 4 if scale is not None else 0))
            tensor_cores = x_dtype == torch.bfloat16 and w.dtype != torch.float32
            b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n,
                                  BF16_FLOPS if tensor_cores else F32_FLOPS)
            sc = scale if scale is not None else torch.ones(n, device=dev)
            case.update(
                ms=median_ms(lambda: ws.stream_matmul(x, w, scale, bits, k, depth)),
                host_us=host_us(lambda: ws.stream_matmul(x, w, scale, bits, k, depth)),
                plain_ms=median_ms(lambda: ref.stream_matmul_ref(x, w, scale, bits, k)),
                library_ms=median_ms((lambda: torch.matmul(x, w_dec) * sc) if scale is not None
                                     else (lambda: torch.matmul(x, w_dec))),
                gemv_ms=(median_ms(lambda: pm.packed_matmul(x, w, scale, bits, k))
                         if bits and k % (8 // bits) == 0 else None),
                bound_ms=b_ms, bound_by=b_by,
            )
        phase("kernel", name="stream_matmul", **case)
        return case

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wide = 32 * 264  # 264 column blocks: the K sweep is not split
    stream_cases = []
    for bits in (2, 1, 0):
        depth = stream_ahead_depth(dataclasses.replace(cfg, w_bits=bits))
        for k, n in ((d, ff), (ff, d)):
            stream_cases.append(stream_case(LANES, k, n, bits, depth, timed=True))
    # ragged K and N (1-bit padding codes, unaligned row pitches), M over
    # one 16-row tile, 8 splits, and unsplit sweeps whose stages fall short
    # of the depth or meet it exactly
    for args in ((6, 100, 70, 1, 2), (6, 100, 70, 2, 3), (6, 100, 70, 0, 2)):
        stream_case(*args, timed=False)
    for k, ring in ((384, "fewer"), (512, "equal"), (1408, "equal")):
        stream_case(LANES, k, 64 * 264, 2, 4, timed=False, ring=ring)
    stream_case(20, ff, d, 2, 4, timed=False)
    stream_case(3, 8192, 100, 1, 8, timed=False, ring="equal")
    stream_case(LANES, d, ff, 0, 3, timed=False, w_dtype=torch.float32)
    # the new cases, from a generator of their own (the later phases'
    # inputs stay as they were): M 1 and 16 at both decode shapes (timed),
    # f32 x, a cluster of 8 splits, 3 row tiles (unsplit, so bf16 rows
    # cycle the ring), and the ring with fewer stages than its depth and
    # cycling past it, 8 stages (a multiple of the depth) or 9 and 15 (not)
    stream_gen = torch.Generator(device="cpu").manual_seed(2)
    for bits in (2, 0):
        depth = stream_ahead_depth(dataclasses.replace(cfg, w_bits=bits))
        for k, n in ((d, ff), (ff, d)):
            for m in (1, 16):
                stream_cases.append(stream_case(m, k, n, bits, depth, timed=True, g=stream_gen))
    for k, n in ((d, ff), (ff, d)):
        stream_case(LANES, k, n, 2, 4, timed=False, x_dtype=torch.float32, g=stream_gen)
        stream_case(LANES, k, n, 0, 2, timed=False, x_dtype=torch.float32, g=stream_gen)
    for args, ring in (((LANES, 4096, 512, 2, 4), "equal"), ((33, d, ff, 0, 2), "cycles"),
                       ((LANES, 40, wide, 2, 4), "fewer"), ((LANES, 400, wide, 1, 8), "fewer"),
                       ((LANES, 4864, wide, 2, 4), "cycles"), ((LANES, 5000, wide, 2, 4), "cycles"),
                       ((LANES, 1000, wide, 0, 2), "cycles")):
        stream_case(*args, timed=False, g=stream_gen, ring=ring)
    stream_case(LANES, 5000, wide, 2, 4, timed=False, x_dtype=torch.float32, g=stream_gen,
                ring="cycles")
    if ws.split_plan(LANES, 4096, 512, sms)[0] != 8:
        fail(f"stream_matmul M={LANES} K=4096 N=512 is not split 8 ways")

    # ---- the serve path's kernels inside a CUDA graph ----
    graph_checks = []

    def graph_case(name, route, fn, *inputs):
        """``fn`` (one wrapper call) compiled by ``CapturedStep`` (an eager
        first call, then the capture) and replayed on the same inputs: the
        first call's and the replay's outputs must be bitwise equal to an
        eager launch's; the capture counts no launch, a replay one (by its
        route, for a wrapper that counts routes). Times: the replay against
        the eager call, device medians."""
        def by_route():
            return ops.launch_routes().get(name, {}).get(route, 0) if route else 0

        eager = fn(*inputs)
        step = CapturedStep(fn, device=dev, mempool=torch.cuda.graph_pool_handle())
        c0, r0 = ops.launch_counts()[name], by_route()
        first = step(*inputs)
        c1 = ops.launch_counts()[name]
        replay = step(*inputs)
        c2, r2 = ops.launch_counts()[name], by_route()
        torch.cuda.synchronize()
        outs = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
        label = f"{name} {route} in a CUDA graph"
        if step.graph is None:
            fail(f"{label}: nothing was captured")
        if not all(same_bits(a, b) for a, b in zip(outs(first), outs(eager))):
            fail(f"{label}: the first (eager) call differs from an eager launch")
        if not all(same_bits(a, b) for a, b in zip(outs(replay), outs(eager))):
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs(replay), outs(eager)))
            fail(f"{label}: the replay differs from an eager launch (max |diff| {diff})")
        if (c1 - c0, c2 - c1, r2 - r0) != (1, 1, 2 if route else 0):
            fail(f"{label}: launches counted {c1 - c0} by the first call, {c2 - c1} by "
                 f"a replay, {r2 - r0} by route {route}; want 1, 1, 2")
        case = dict(kernel=name, route=route or "stream_kernel", bitwise_equal=True,
                    launches_first_call=c1 - c0, launches_per_replay=c2 - c1,
                    replay_ms=median_ms(lambda: step.graph.replay()),
                    eager_ms=median_ms(lambda: fn(*inputs)))
        graph_checks.append(case)
        phase("graph_kernel", **case)
        del step

    g_gen = torch.Generator(device="cpu").manual_seed(3)
    for m, route in ((LANES, "gemv"), (CHUNK, "mma")):
        w = lm.make_packed(torch.randn((d, ff), generator=g_gen).to(dev), 2)
        x = torch.randn((m, d), generator=g_gen).to(dev, torch.bfloat16)
        graph_case("packed_matmul", route,
                   lambda x_: pm.packed_matmul(x_, w["packed"], w["scale"], 2, d), x)
    qg = torch.randn((hq, CHUNK, hd), generator=g_gen).to(dev, torch.bfloat16)
    kg = torch.randn((hkv, MAX_LEN, hd), generator=g_gen).to(dev, torch.bfloat16)
    vg = torch.randn((hkv, MAX_LEN, hd), generator=g_gen).to(dev, torch.bfloat16)
    graph_case("flash_fwd", "mma",
               lambda q_, k_, v_: fa.flash_fwd(q_, k_, v_, causal=True, q_offset=CHUNK),
               qg, kg, vg)
    sdepth = stream_ahead_depth(dataclasses.replace(cfg, w_bits=2))
    sw = lm.make_packed(torch.randn((d, ff), generator=g_gen), 2)
    swp, sws = sw["packed"].to(dev), sw["scale"].to(dev)
    xs = torch.randn((LANES, d), generator=g_gen).to(dev, torch.bfloat16)
    graph_case("stream_matmul", None,
               lambda x_: ws.stream_matmul(x_, swp, sws, 2, d, sdepth), xs)

    # a fault inside a capture: the launch function refuses a split of 0
    # (cudaErrorInvalidValue, before any launch); _build.check must raise out
    # of the capture, and the step must stay uncaptured (no eager fallback)
    pm_lib = _build.load("packed_matmul", "packed_matmul_launch", pm._ARGTYPES)
    xf = torch.randn((LANES, d), generator=g_gen).to(dev, torch.bfloat16)
    wf = lm.make_packed(torch.randn((d, ff), generator=g_gen).to(dev), 2)
    calls = []

    def faulty(x_):
        splits, cps = (1, -(-d // pm.GEMV_BK)) if not calls else (0, 1)
        calls.append(splits)
        out = torch.empty((LANES, ff), dtype=torch.float32, device=dev)
        rc = pm_lib.packed_matmul_launch(
            x_.data_ptr(), 1, wf["packed"].data_ptr(), wf["scale"].data_ptr(),
            out.data_ptr(), LANES, d, ff, 2, splits, cps,
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(pm_lib, rc, "packed_matmul (a split of 0, inside a capture)")
        return out

    f_step = CapturedStep(faulty, device=dev, mempool=torch.cuda.graph_pool_handle())
    try:
        f_step(xf)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    torch.cuda.synchronize()
    if raised is None or calls != [1, 0] or f_step.graph is not None:
        fail(f"a fault inside a capture: raised {raised!r}, splits asked {calls}, "
             f"graph {'captured' if f_step.graph is not None else 'none'}")
    phase("graph_capture_fault", raised=raised, splits_asked=calls, captured=False)
    del f_step

    from repro_torch.kernels import mvau as mv
    from repro_torch.models import cnn
    from repro_torch.quant.quantizers import pack_bits

    gen_dev = torch.Generator(device=dev).manual_seed(0)
    act_scale = 2.0 / math.sqrt(1.5)  # the LSQ scale of CNV's 2-bit activations

    def near_threshold(acc, thr):
        """(M, N) mask: sign*acc lies within the tie tolerance of one of its
        column's thresholds (N, L)."""
        gap = (acc[..., None] - thr[None]).abs()
        near = (gap <= MVAU_TIE_TOL * (1.0 + thr.abs()[None])) & torch.isfinite(thr)[None]
        return near.any(dim=-1)

    def mvau_case(label, m, k, n, bits, n_levels, timed, inf_rows=0):
        """The kernel against ``mvau_ref`` on the same card tensors. x holds
        2-bit activation levels times their scale, as the im2col columns
        do; thresholds are sorted N(0, scale * sqrt(K))."""
        x = torch.randint(-2, 2, (m, k), generator=gen_dev, device=dev).float() * act_scale
        codes = torch.randint(0, 2 if bits == 1 else 3, (k + (-k) % (8 // bits), n),
                              generator=gen_dev, device=dev)
        carrier = pack_bits(codes, bits)
        thr = torch.sort(torch.randn((n, n_levels), generator=gen_dev, device=dev)
                         * act_scale * math.sqrt(k), dim=1).values
        thr[:inf_rows, n_levels // 2:] = math.inf
        signs = torch.randint(0, 2, (n,), generator=gen_dev, device=dev).float() * 2 - 1
        args = (x, carrier, thr, signs)
        got = mv.mvau(*args, bits, k, -2)
        again = mv.mvau(*args, bits, k, -2)
        want = ref.mvau_ref(x, carrier, thr, signs, -2, bits, k)
        w_dec = ref.decode_weights(carrier, bits, k)
        diff = got != want
        ties = near_threshold((x @ w_dec) * signs, thr)
        torch.cuda.synchronize()
        n_diff, n_bad = int(diff.sum()), int((diff & ~ties).sum())
        err = int((got - want).abs().max())
        if n_bad or got.dtype != torch.int32:
            fail(f"mvau {label} bits={bits} M={m} K={k} N={n} L={n_levels}: "
                 f"{n_bad} levels differ away from a threshold ({n_diff} in all)")
        if not torch.equal(got, again):
            fail(f"mvau {label} bits={bits} M={m} K={k} N={n}: two runs differ")
        case = dict(case=label, bits=bits, m=m, k=k, n=n, levels=n_levels,
                    splits=mv.split_plan(m, k, n, sms)[0],
                    inf_threshold_rows=inf_rows, max_abs_err=err,
                    tie_flips=n_diff, near_ties=int(ties.sum()))
        if timed:
            n_bytes = x.numel() * 4 + carrier.numel() + thr.numel() * 4 + n * 4 + m * n * 4
            b_ms, b_by = bound_ms(n_bytes, 2.0 * m * k * n + m * n * n_levels, F32_FLOPS)
            case.update(
                ms=median_ms(lambda: mv.mvau(*args, bits, k, -2)),
                host_us=host_us(lambda: mv.mvau(*args, bits, k, -2)),
                plain_ms=median_ms(lambda: ref.mvau_ref(x, carrier, thr, signs, -2, bits, k)),
                library_ms=median_ms(lambda: torch.matmul(x, w_dec)),
                bound_ms=b_ms, bound_by=b_by,
            )
        phase("kernel", name="mvau", **case)
        return case

    def cnv_mvau_shapes(batch):
        """(layer, M, K, N) of every 1/2-bit layer of CNV at ``batch``."""
        shapes, h = [], 32
        for sp in cnn.cnv_topology():
            h = (h + 2 * sp.pad - sp.k) // sp.stride + 1
            if sp.w_bits in (1, 2) and sp.a_bits > 0:
                shapes.append((sp.name, batch * h * h, sp.k * sp.k * sp.c_in, sp.c_out))
            if sp.pool:
                h //= 2
        return shapes

    mvau_cases = [
        mvau_case(name, m, k, n, bits, 3, timed=True)
        for bits in (1, 2) for name, m, k, n in cnv_mvau_shapes(CNN_BATCH)
    ]
    # the seven layer cases of one bit width summed: the kernel's, the
    # plain version's, the library matmul's and the bound's time for one
    # CNV forward at batch 256
    mvau_forward = []
    for bits in (1, 2):
        layer_cases = [c for c in mvau_cases if c["bits"] == bits]
        mvau_forward.append(dict(bits=bits, layers=len(layer_cases), **{
            key: sum(c[key] for c in layer_cases)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}))
        phase("kernel", name="mvau", case="cnv_forward", **mvau_forward[-1])
    # ragged M, N and K (1-bit padding codes), one and fifteen thresholds,
    # +inf thresholds; timed too, outside the forward's sums
    mvau_checks = [
        mvau_case(label, m, k, n, bits, n_levels, timed=True, inf_rows=inf_rows)
        for label, m, k, n, bits, n_levels, inf_rows in (
            ("ragged_l1", 1000, 100, 70, 1, 1, 0), ("ragged_l15", 1000, 100, 70, 1, 15, 20),
            ("ragged_l15", 1000, 100, 70, 2, 15, 20), ("ragged_m5", 5, 100, 70, 1, 3, 35),
            ("ragged_n3", 300, 24, 3, 2, 3, 1),
            # M < 64 with ragged K and N: one output tile column of two, K
            # split over an 8-block cluster
            ("ragged_split_m37", 37, 2300, 70, 1, 3, 10),
            ("ragged_split_m37", 37, 2300, 70, 2, 3, 10),
        )
    ]

    # ---- the other dense archs' shapes, from a generator of their own ----
    arch_gen = torch.Generator(device="cpu").manual_seed(8)
    for arch in NEW_ARCHS:
        ac = get_config(arch)
        depth2 = stream_ahead_depth(dataclasses.replace(ac, w_bits=2))
        # the FFN at 2 bits: decode (the GEMV, and stream_matmul on budgeted
        # layers) and a prefill chunk (the mma path)
        for k, n in ((ac.d_model, ac.d_ff), (ac.d_ff, ac.d_model)):
            packed_case(2, LANES, k, n, bf16, timed=True, g=arch_gen)
            packed_case(2, CHUNK, k, n, bf16, timed=True, g=arch_gen)
            stream_cases.append(stream_case(LANES, k, n, 2, depth2, timed=True, g=arch_gen))
        rows_do_not_follow_m(2, ac.d_model, ac.d_ff, arch_gen, arch)
        if ac.hd != 80:  # the prefill's attention at the arch's heads (D 80 below)
            flash_case(f"{arch}_prefill_causal", ac.n_heads, ac.n_kv, PROMPT, PROMPT, ac.hd,
                       True, 0, 0, bf16, True, g=arch_gen)
    # head dim 80 (h2o-danube's 32 / 8 heads) on both routes: the prefill, the
    # serve chunk, the window (4096) at a chunk past it, a ragged case, and
    # the device q_offset bitwise the host int
    dn = get_config("h2o_danube_1p8b")
    w80 = dn.sliding_window
    for dt in (bf16, torch.float32):
        flash_case("d80_prefill_causal", dn.n_heads, dn.n_kv, PROMPT, PROMPT, 80, True, 0, 0,
                   dt, True, g=arch_gen)
        flash_case("d80_chunk_q_offset", dn.n_heads, dn.n_kv, CHUNK, MAX_LEN, 80, True, 0,
                   CHUNK, dt, True, g=arch_gen)
        flash_case("d80_window_past_it", dn.n_heads, dn.n_kv, CHUNK, w80 + CHUNK, 80, True,
                   w80, w80, dt, True, g=arch_gen)
        flash_case("d80_ragged_q_offset", 6, 2, 77, 333, 80, True, 0, 256, dt, False, g=arch_gen)
        flash_case("d80_ragged_window", 4, 2, 130, 130, 80, True, 17, 0, dt, False, g=arch_gen)
        qc, kc, vc = (torch.randn((h_, n_, 80), generator=arch_gen).to(dev, dt)
                      for h_, n_ in ((dn.n_heads, CHUNK), (dn.n_kv, MAX_LEN), (dn.n_kv, MAX_LEN)))
        for start in (37, CHUNK):
            dev_off = torch.tensor([start], dtype=torch.int32, device=dev)
            host = fa.flash_fwd(qc, kc, vc, causal=True, q_offset=start)
            on_dev = fa.flash_fwd(qc, kc, vc, causal=True, q_offset=dev_off)
            torch.cuda.synchronize()
            same = all(map(same_bits, on_dev, host))
            case = dict(case="d80_device_q_offset", sq=CHUNK, sk=MAX_LEN, heads=dn.n_heads,
                        kv_heads=dn.n_kv, d=80, dtype=str(dt).replace("torch.", ""),
                        q_offset=start, bitwise_equal_to_host_int=same)
            q_offset_cases.append(case)
            phase("kernel", name="flash_fwd", check_only=True, **case)
            if not same:
                fail(f"flash_fwd D 80 {dt} device q_offset {start}: differs from the host int")
    # both backward passes at D 80, at the gradient check's shape (timed), and
    # a windowed ragged case at a q_offset (the dk/dv pass stages 64 rows)
    d80_bwd = []
    for dt in (bf16, torch.float32):
        d80_bwd.append(flash_bwd_case("d80_grad_causal", GRAD_BATCH, dn.n_heads, dn.n_kv,
                                      GRAD_SEQ, GRAD_SEQ, 80, dt, timed=True, g=arch_gen))
        flash_bwd_case("d80_window_q_offset", 1, 4, 2, 130, 200, 80, dt, False, True, 17, 70,
                       g=arch_gen)

    # ---- the MoE family's shapes, from a generator of their own ----
    # olmoe's experts (2048x1024, 1024x2048): a cold expert streams its bf16
    # rows against f32 x (the f32 FMA route) at decode's 8 lanes, timed
    # beside torch.matmul on the f32 weight, M 1 and 16 for agreement;
    # moonshot's (2048x1408, 1408x2048) for agreement; and the prefill's
    # attention at olmoe's 16/16 heads (G=1), D 128, and its chunk
    moe_gen = torch.Generator(device="cpu").manual_seed(12)
    olmoe = get_config("olmoe_1b_7b")
    moe_depth = stream_ahead_depth(olmoe)
    for k, n in ((olmoe.d_model, olmoe.d_ff), (olmoe.d_ff, olmoe.d_model)):
        stream_cases.append(stream_case(LANES, k, n, 0, moe_depth, timed=True,
                                        x_dtype=torch.float32, g=moe_gen))
        for m in (1, 16):
            stream_case(m, k, n, 0, moe_depth, timed=False, x_dtype=torch.float32, g=moe_gen)
    moon = get_config("moonshot_v1_16b_a3b")
    for k, n in ((moon.d_model, moon.d_ff), (moon.d_ff, moon.d_model)):
        for m in (1, LANES, 16):
            stream_case(m, k, n, 0, moe_depth, timed=False, x_dtype=torch.float32, g=moe_gen)
    flash_case("olmoe_prefill_causal", olmoe.n_heads, olmoe.n_kv, PROMPT, PROMPT, olmoe.hd,
               True, 0, 0, bf16, True, g=moe_gen)
    flash_case("olmoe_chunk_q_offset", olmoe.n_heads, olmoe.n_kv, CHUNK, MAX_LEN, olmoe.hd,
               True, 0, CHUNK, bf16, True, g=moe_gen)

    # ---- the vlm and enc-dec families' shapes, from a generator of their own ----
    # internvl2-76b's FFN (8192x28672 and back) at 2 bits: the GEMV at M 8
    # (decode) and the mma path at M 256 (a prefill chunk); whisper-tiny's
    # (384x1536 and back): the GEMV at M 8 and the mma path at M 12000 (the
    # encoder's 8 lanes x 1500 frames); each case line names its planned
    # split; a row's bits independent of M at each shape (whisper's also
    # against the head of a 12000-row launch). flash_fwd not causal at
    # whisper's encoder (8 lanes x 6 heads, 1500 x 1500, D 64: Sk is no
    # multiple of the 64-key tile) and cross-attention (64 decoder tokens
    # over 1500 frames), the encoder's also on the f32 route; and causal at
    # internvl's 64/8 heads (G 8), D 128: the prefill and the chunk
    fam_gen = torch.Generator(device="cpu").manual_seed(27)
    vlm_full, enc_full = get_config(VLM_ARCH), get_config(ENC_ARCH)
    for k, n in ((vlm_full.d_model, vlm_full.d_ff), (vlm_full.d_ff, vlm_full.d_model)):
        for m in (LANES, CHUNK):
            packed_case(2, m, k, n, bf16, timed=True, g=fam_gen)
        rows_do_not_follow_m(2, k, n, fam_gen, VLM_ARCH)
    enc_rows = LANES * enc_full.frontend_len
    for k, n in ((enc_full.d_model, enc_full.d_ff), (enc_full.d_ff, enc_full.d_model)):
        for m in (LANES, enc_rows):
            packed_case(2, m, k, n, bf16, timed=True, g=fam_gen)
        rows_do_not_follow_m(2, k, n, fam_gen, ENC_ARCH, big_m=enc_rows)
    eh, fl = LANES * enc_full.n_heads, enc_full.frontend_len
    flash_case("whisper_encoder", eh, eh, fl, fl, enc_full.hd, False, 0, 0, bf16, True,
               g=fam_gen)
    flash_case("whisper_cross", eh, eh, 64, fl, enc_full.hd, False, 0, 0, bf16, True, g=fam_gen)
    flash_case("whisper_encoder", eh, eh, fl, fl, enc_full.hd, False, 0, 0, torch.float32,
               False, g=fam_gen)
    flash_case("whisper_cross_ragged", 6, 6, 30, fl, enc_full.hd, False, 0, 0, bf16, False,
               g=fam_gen)
    flash_case("internvl_prefill_causal", vlm_full.n_heads, vlm_full.n_kv, PROMPT, PROMPT,
               vlm_full.hd, True, 0, 0, bf16, True, g=fam_gen)
    flash_case("internvl_chunk_q_offset", vlm_full.n_heads, vlm_full.n_kv, CHUNK, MAX_LEN,
               vlm_full.hd, True, 0, CHUNK, bf16, True, g=fam_gen)

    # ---- the train_families phase's flash_bwd shapes, from a generator of their own ----
    # both passes, timed, at the gradient check's batch: head dim 128 causal
    # at olmoe's 16/16 heads (G 1) and internvl's 64/8 (G 8); not causal at
    # whisper's 6/6 heads, D 64: the encoder (1500 x 1500: Sk no multiple of
    # the 64-key tile) and the cross-attention (GRAD_SEQ tokens over 1500
    # frames)
    bwd_gen = torch.Generator(device="cpu").manual_seed(29)
    family_bwd = [
        flash_bwd_case("olmoe_grad_causal", GRAD_BATCH, olmoe.n_heads, olmoe.n_kv, GRAD_SEQ,
                       GRAD_SEQ, olmoe.hd, bf16, timed=True, g=bwd_gen),
        flash_bwd_case("internvl_grad_causal", GRAD_BATCH, vlm_full.n_heads, vlm_full.n_kv,
                       GRAD_SEQ, GRAD_SEQ, vlm_full.hd, bf16, timed=True, g=bwd_gen),
        flash_bwd_case("whisper_encoder_not_causal", GRAD_BATCH, enc_full.n_heads,
                       enc_full.n_kv, fl, fl, enc_full.hd, bf16, timed=True, causal=False,
                       g=bwd_gen),
        flash_bwd_case("whisper_cross_not_causal", GRAD_BATCH, enc_full.n_heads, enc_full.n_kv,
                       GRAD_SEQ, fl, enc_full.hd, bf16, timed=True, causal=False, g=bwd_gen),
    ]

    phase_seconds("3 kernels")
    if opts.only == "kernels":
        print("[chip_smoke] --only kernels: stopped after phase 3", file=sys.stderr)
        return 0

    # ---------------- 6. CNV at full width, card vs CPU ----------------
    # run right after phase 3: the module docstring says why
    def cnn_setup(w_bits):
        """CNV with random weights from a seed, randomised BN statistics
        (a quarter of the gammas negative) and 256 random images."""
        specs = cnn.cnv_topology(w_bits=w_bits, a_bits=2)
        g = torch.Generator().manual_seed(w_bits)
        params = cnn.init_cnn_params(specs, g)
        for sp in specs:
            p = params[sp.name]
            p["bn_mu"] = torch.randn(sp.c_out, generator=g) * 0.2
            p["bn_var"] = torch.rand(sp.c_out, generator=g) * 2.0 + 0.1
            sign = torch.where(torch.rand(sp.c_out, generator=g) < 0.25, -1.0, 1.0)
            p["bn_gamma"] = sign * (0.5 + torch.rand(sp.c_out, generator=g))
            p["bn_beta"] = torch.randn(sp.c_out, generator=g) * 0.1
        return specs, params, torch.randn((CNN_BATCH, 32, 32, 3), generator=g)

    def cnn_layer_check(specs, sp_cpu, sp_card, trace) -> list[dict]:
        """Each layer on the card, fed the CPU plain path's input: its levels
        must equal the CPU's but where the CPU's sign*acc is a tie."""
        rows = []
        for sp, (name, x_in, y_cpu) in zip(specs, trace):
            y_card = cnn.streamlined_layer(sp_card[name], sp, x_in.to(dev)).cpu()
            if sp.a_bits == 0:  # the logits: a plain f32 convolution
                err = (y_card - y_cpu).abs().max().item()
                if not err <= CNN_LOGIT_TOL * (1.0 + y_cpu.abs().max().item()):
                    fail(f"cnn {name}: card vs CPU logits differ by {err}")
                rows.append(dict(layer=name, max_abs_err=err))
                continue
            spec = sp_cpu[name]["thresholds"]
            scale = spec.scale.item()
            diff = (torch.round(y_card / scale) != torch.round(y_cpu / scale)).reshape(-1, sp.c_out)
            n_diff = int(diff.sum())
            if n_diff:
                cols, _ = cnn.im2col(x_in, sp.k, sp.stride, sp.pad)
                wm = sp_cpu[name]["w"].reshape(-1, sp.c_out)
                if sp.w_bits in (1, 2):
                    carrier, thr = cnn.mvau_weights(wm, spec, sp.w_bits)
                    acc = cols @ ref.decode_weights(carrier, sp.w_bits, wm.shape[0])
                else:
                    thr, acc = spec.thresholds, cols @ wm
                n_bad = int((diff & ~near_threshold(acc * spec.signs, thr)).sum())
                if n_bad:
                    fail(f"cnn {name}: {n_bad} levels differ from the CPU's away from "
                         f"a threshold ({n_diff} in all)")
            rows.append(dict(layer=name, outputs=diff.numel(), tie_flips=n_diff))
        return rows

    def cnn_profile(fwd, xb, specs) -> dict:
        """The card's time per forward by layer (torch.profiler over
        CNN_PROFILED forwards), split into ``mvau``, ``im2col`` and the
        rest. The ``cnn.<layer>`` and ``im2col`` ranges carry the device
        time of the PyTorch kernels launched inside them; the profiler
        leaves ctypes launches out of the ranges, so each ``mvau`` kernel
        is given to its layer by launch order (one per quantized layer, in
        layer order)."""
        labels = {f"cnn.{sp.name}": sp.name for sp in specs}
        q_layers = [sp.name for sp in specs if sp.w_bits in (1, 2) and sp.a_bits > 0]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CNN_PROFILED):
                fwd(xb)
            torch.cuda.synchronize()
        per_layer = {sp.name: dict(total=0.0, mvau=0.0, im2col=0.0) for sp in specs}
        kernels_ms: dict[str, float] = {}
        mvau_events = []
        n_kernels = 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                if e.name in labels or e.name == "im2col":  # annotations, not kernels
                    continue
                n_kernels += 1
                key = e.name[:60]
                kernels_ms[key] = kernels_ms.get(key, 0.0) + e.time_range.elapsed_us() / CNN_PROFILED / 1e3
                if "mvau_kernel" in e.name:
                    mvau_events.append(e)
            elif e.name in labels:
                per_layer[labels[e.name]]["total"] += e.device_time_total / CNN_PROFILED / 1e3
            elif e.name == "im2col":
                up = e.cpu_parent
                while up is not None and up.name not in labels:
                    up = up.cpu_parent
                if up is not None:
                    per_layer[labels[up.name]]["im2col"] += e.device_time_total / CNN_PROFILED / 1e3
        mvau_events.sort(key=lambda e: e.time_range.start)
        if len(mvau_events) != len(q_layers) * CNN_PROFILED:
            us = [round(e.time_range.elapsed_us(), 1) for e in mvau_events]
            fail(f"cnn profile: {len(mvau_events)} mvau kernels for {CNN_PROFILED} forwards "
                 f"(their us in launch order: {us}; {n_kernels} kernel records in all)")
        for i, e in enumerate(mvau_events):
            ms = e.time_range.elapsed_us() / CNN_PROFILED / 1e3
            row = per_layer[q_layers[i % len(q_layers)]]
            row["mvau"] += ms
            row["total"] += ms
        for row in per_layer.values():
            row["rest"] = row["total"] - row["mvau"] - row["im2col"]
        return dict(
            per_layer_ms=per_layer,
            device_ms=sum(kernels_ms.values()),
            kernels_per_forward=n_kernels / CNN_PROFILED,
            mvau_ms=sum(r["mvau"] for r in per_layer.values()),
            mvau_share=sum(r["mvau"] for r in per_layer.values()) / sum(kernels_ms.values()),
            im2col_ms=sum(r["im2col"] for r in per_layer.values()),
            top_kernels_ms=dict(sorted(kernels_ms.items(), key=lambda kv: -kv[1])[:8]),
        )

    cnn_runs = []
    cnn_mvau_launches = cnn_forwards = 0
    for w_bits in (1, 2):
        specs, params, images = cnn_setup(w_bits)
        sp_cpu = cnn.streamline_params(params, specs)
        trace = []
        t0 = time.monotonic()
        logits_cpu = cnn.cnn_forward_streamlined(sp_cpu, specs, images, trace=trace)
        cpu_s = time.monotonic() - t0
        sp_card = cnn.streamline_params(
            {name: {k: v.to(dev) for k, v in p.items()} for name, p in params.items()}, specs)
        x_card = images.to(dev)
        layers = cnn_layer_check(specs, sp_cpu, sp_card, trace)
        del trace

        def fwd(xb):
            return cnn.cnn_forward_streamlined(sp_card, specs, xb)

        def counted(run, n_forwards):
            """``run`` with the launch counters reset just before and read
            just after: only mvau, exactly CNN_MVAU_PER_FORWARD a forward."""
            nonlocal cnn_mvau_launches, cnn_forwards
            ops.reset_launch_counts()
            out = run()
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            want = dict.fromkeys(counts, 0) | {"mvau": CNN_MVAU_PER_FORWARD * n_forwards}
            if counts != want:
                fail(f"cnn w{w_bits}a2: launches {counts}, not {want}")
            cnn_mvau_launches += counts["mvau"]
            cnn_forwards += n_forwards
            return out

        logits = counted(lambda: fwd(x_card), 1).cpu()
        agree = (logits.argmax(dim=1) == logits_cpu.argmax(dim=1)).float().mean().item()
        if not (tuple(logits.shape) == (CNN_BATCH, 10) and bool(torch.isfinite(logits).all())
                and agree >= CNN_MIN_ARGMAX):
            fail(f"cnn w{w_bits}a2 card vs CPU: shape {tuple(logits.shape)}, argmax agreement {agree}")
        speed = {}
        for batch in (CNN_BATCH, 1):
            xb = x_card[:batch].contiguous()
            for _ in range(3):
                fwd(xb)
            torch.cuda.synchronize()

            def timed_runs():
                times = []
                for _ in range(CNN_RUNS):
                    t0 = time.perf_counter()
                    fwd(xb)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                return statistics.median(times)

            med = counted(timed_runs, CNN_RUNS)
            speed[f"batch{batch}"] = dict(forward_ms=med * 1e3, images_per_s=batch / med)
        prof_row = counted(lambda: cnn_profile(fwd, x_card, specs), CNN_PROFILED)
        prof_row["device_busy_share"] = prof_row["device_ms"] / speed[f"batch{CNN_BATCH}"]["forward_ms"]
        run = dict(w_bits=w_bits, a_bits=2, batch=CNN_BATCH, argmax_agreement=agree,
                   max_abs_logit_diff=(logits - logits_cpu).abs().max().item(),
                   cpu_forward_s=cpu_s, layers=layers, speed=speed, profile=prof_row)
        cnn_runs.append(run)
        phase("cnn", **run)
        del sp_card, x_card, params, sp_cpu

    phase_seconds("6 cnn")

    # ---------------- 4. full-width prefill, card vs CPU ----------------
    # the dense archs' weights start drawing on the host threads now, behind
    # phases 4-7 (the MoE phase's behind the dense archs': host memory)
    prefetch_after("phase 4")
    params, cfg2 = prefill_phase()

    # ---------------- where a decode step's time goes ----------------
    def half_budget_plan(c):
        """The residency plan at half of its own total tile bytes."""
        full = compile_residency_plan(c, vmem_budget_bytes=0)
        total = sum(full.bin_tiles) * full.chip.tile_bytes
        plan = compile_residency_plan(c, vmem_budget_bytes=total // 2)
        mask = plan.layer_stream_mask(c)
        if not (any(mask) and not all(mask)):
            fail(f"half-budget plan of w_bits={c.w_bits} does not split the layers: {mask}")
        return plan, total / 2 / 2**20

    plan2, _ = half_budget_plan(cfg2)
    # eager and compiled, unbudgeted and budgeted; the host time of a step
    # drifts within a call: each pair runs twice, in turns
    for plan_, compiled in ((None, False), (None, True), (plan2, True), (plan2, False),
                            (plan2, False), (plan2, True), (None, True), (None, False)):
        phase("decode_profile", **profile_decode(params, cfg2, plan_, compiled))

    # the same weights and pool state through the budgeted and the
    # unbudgeted step: the logits must agree
    rows = LANES * MAX_LEN + 16
    pk0 = torch.randn((cfg2.n_layers, rows, hkv, hd), generator=gen).to(dev, torch.bfloat16)
    pv0 = torch.randn((cfg2.n_layers, rows, hkv, hd), generator=gen).to(dev, torch.bfloat16)
    table = (16 + torch.arange(LANES * MAX_LEN, device=dev)).reshape(LANES, MAX_LEN)
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (LANES, 1))).to(dev)
    lens = torch.full((LANES,), PROMPT + 8, device=dev)
    lg_full, _, _ = lm.decode_step_paged(params, cfg2, tok, pk0.clone(), pv0.clone(), table, lens)
    lg_bud, _, _ = lm.decode_step_paged(
        params, cfg2, tok, pk0.clone(), pv0.clone(), table, lens,
        stream_mask=plan2.layer_stream_mask(cfg2), stream_depth=plan2.stream_ahead)
    a = lg_bud[:, 0, : cfg.vocab].float()
    b = lg_full[:, 0, : cfg.vocab].float()
    cos = F.cosine_similarity(a, b, dim=-1).min().item()
    top_bud = a.argmax(dim=-1)
    slack = (b.max(dim=-1).values - b.gather(1, top_bud[:, None])[:, 0]).max().item()
    phase("budgeted_decode", lanes=LANES, streamed_layers=sum(plan2.layer_stream_mask(cfg2)),
          stream_ahead=plan2.stream_ahead, min_cosine=cos, max_top1_gap=slack,
          top1_equal=int((top_bud == b.argmax(dim=-1)).sum()),
          max_abs_logit_err=(a - b).abs().max().item(),
          finite=bool(torch.isfinite(a).all()))
    if not (cos >= BUDGET_MIN_COS and slack <= BUDGET_TOP1_SLACK and torch.isfinite(a).all()):
        fail(f"budgeted vs unbudgeted decode: cosine {cos}, top-1 gap {slack}")
    # the compiled decode step against the eager one on the same state
    decode_in = (tok.cpu(), table.cpu(), lens.cpu())
    for plan_, label in ((None, "unbudgeted"), (plan2, "budgeted")):
        kw = decode_kw(cfg2, plan_)
        hold_replay(f"decode step, --quant 2 {label}",
                    lambda k_, v_, t_, tb, ln: lm.decode_step_paged(
                        params, cfg2, t_, k_, v_, tb, ln, **kw)[0],
                    decode_in, pk0, pv0)
    del params, pk0, pv0
    params0 = lm.init_params(cfg, 0, device=dev)
    phase("decode_profile", **profile_decode(params0, cfg))
    phase("decode_profile", **profile_decode(params0, cfg, compiled=True))
    del params0

    phase_seconds("4 prefill and decode, smollm-360m")

    # ---------------- 5. serve at full width and depth ----------------
    from repro_torch.runtime.memledger import validate_ledger
    from repro_torch.runtime.spans import decompose, request_spans, validate_trace
    from repro_torch.runtime.tracker import read_jsonl, replay_summary
    from repro_torch.perf.trace_export import to_trace_events, validate_trace_events

    runs = {}
    trace_dir = ROOT / "build" / "chip_smoke"
    trace_dir.mkdir(parents=True, exist_ok=True)

    def check_trace(path, metrics, label,
                    phases=("queue", "prefill", "decode", "wait")) -> dict:
        """The run's ``--trace-out`` stream: the ledger integrates to every
        round's gauges (``validate_ledger``), the rounds replay to the run's
        counters, the export is loadable, and every request's spans tile
        [submit, done] (``validate_trace``; standalone round records carry
        no milestone events, as the reference's do not, so they are taken
        from the spans: admit at the queue span's end, first at the last
        prefill span's end, done at the last span's end). Returns the mean
        ms per request of each phase (``decompose``)."""
        records = read_jsonl(path)
        by_rid = request_spans(records)
        events = []
        for rid, ss in by_rid.items():
            prefill = [sp for sp in ss if sp["phase"] == "prefill"]
            if ss[0]["phase"] != "queue" or not prefill:
                fail(f"{label}: request {rid} spans {[sp['phase'] for sp in ss]}")
            events += [("admit", rid, ss[0]["t1"]), ("first", rid, prefill[-1]["t1"]),
                       ("done", rid, ss[-1]["t1"])]
        errors = validate_trace(records + [{"kind": "metrics", "events": events}])
        errors += validate_ledger(records)
        errors += validate_trace_events(to_trace_events(records))
        replay = replay_summary(records)
        for key in ("completed", "generated_tokens", "prefill_steps", "decode_steps"):
            if replay[key] != metrics[key]:
                errors.append(f"replayed {key} {replay[key]} != {metrics[key]}")
        if len(by_rid) != 16 or errors:
            fail(f"{label}: trace of {len(by_rid)} requests: {errors[:5]}")
        per = decompose(records)
        return dict(
            records=len(records), spans=sum(r.get("kind") == "span" for r in records),
            mem_records=sum(r.get("kind") == "mem" for r in records),
            mean_ms_per_request={
                ph: statistics.fmean(d.get(ph, 0.0) for d in per.values()) * 1e3
                for ph in phases})

    def eager_serve(argv) -> tuple[dict, dict, dict]:
        """The run of ``serve.main(argv)`` with every step eager: the same
        parser, plan, weights and engine (``run_pool_engine``), with the
        scheduler's ``compiled=False``, which no serve flag reaches."""
        args = serve.build_parser().parse_args(argv)
        ecfg = dataclasses.replace(get_config(args.arch), w_bits=args.quant)
        eparams = lm.init_params(ecfg, args.seed, device=dev)
        ops.reset_launch_counts()
        metrics = serve.run_pool_engine(ecfg, eparams, args, dev,
                                        serve.build_residency_plan(ecfg, args), compiled=False)
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        del eparams
        return metrics, counts, by_route

    def serve_main(argv, label) -> tuple[dict, dict, dict]:
        """``serve.main(argv)``, launch counters reset just before and read
        just after: its ``[serve/metrics]``, the counts and the counts by
        route; the rest of its output goes to stderr."""
        buf = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = serve.main(argv)
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        text = buf.getvalue()
        sys.stderr.write("".join(l + "\n" for l in text.splitlines()
                                 if not l.startswith("[serve/metrics] ")))
        if rc != 0:
            fail(f"{label} exited {rc}")
        metrics = json.loads(next(l for l in text.splitlines()
                                  if l.startswith("[serve/metrics] ")).split(" ", 1)[1])
        return metrics, counts, by_route

    # ---------------- 5 (c): speculative decoding ----------------
    def speculative_phase(cfg_q2, params_q2, plain_q2_run) -> None:
        """Phase 5 (c) (the module docstring says what it holds).
        ``plain_q2_run`` is phase 5's compiled --quant 2 run's metrics."""
        from repro_torch.runtime import speculative as spec

        cfg_q0 = dataclasses.replace(cfg, w_bits=0)
        t0 = time.monotonic()
        # the twin's lossless pairing: a dequantized target (its FFN leaves
        # the decoded 2-bit carriers of seed 0's dense draw, in bf16), whose
        # twin serve builds by packing them again (--spec-quant 2)
        dense0 = lm.init_params(cfg_q0, 0, device=dev)
        params_dq = spec.dequantize_ffn_params(dense0, 2)
        del dense0
        torch.cuda.synchronize()
        phase("spec_weights", target="dequantized smollm-360m (w_bits 0)",
              seconds=time.monotonic() - t0)
        spec_layers = cfg.n_layers
        spec_argv = ["--arch", "smollm_360m", "--requests", "16", "--batch", str(LANES),
                     "--prompt-len", str(PROMPT), "--gen-len", "64", "--max-len", str(MAX_LEN),
                     "--prefill-chunk", str(CHUNK), "--spec-depth", str(SPEC_DEPTH)]

        def logit_gate(label, max_diff, gap_shift, agree, n, scale, planted=False) -> dict:
            """The verify path's logits against plain decode's: the largest
            |difference| and the largest shift of plain decode's top-1 /
            top-2 gap within SPEC_LOGIT_STEPS bf16 steps at the largest
            |logit| (``scale``), and the argmax the same at no fewer than
            SPEC_MIN_ARGMAX_SHARE of the ``n`` positions, or the run fails;
            a ``planted`` fault must fail the same gate."""
            step = 2.0 ** (math.floor(math.log2(scale)) - 7)  # bf16: 8 significant bits
            ceiling = SPEC_LOGIT_STEPS * step
            within = (max_diff <= ceiling and gap_shift <= ceiling
                      and agree >= SPEC_MIN_ARGMAX_SHARE * n)
            out = dict(max_abs_logit=scale, bf16_step=step, ceiling=ceiling,
                       max_abs_logit_diff=max_diff, max_top1_top2_gap_shift=gap_shift,
                       max_abs_logit_diff_steps=max_diff / step,
                       max_top1_top2_gap_shift_steps=gap_shift / step,
                       argmax_agree=agree, positions=n, argmax_share=agree / n,
                       within_gate=within)
            if within == planted:
                fail(f"{label}: " + ("the planted fault passes the gate" if planted else
                                     "the verify path's logits lie outside the gate") + f": {out}")
            return out

        def rows_vs(got, want) -> tuple:
            """(N, V) logits rows against plain decode's ``want``: the
            largest |difference|, the largest shift of want's top-1 / top-2
            gap, the rows whose argmax agrees, and want's largest |logit|."""
            top2 = torch.topk(want, 2, dim=-1).indices
            g, w = got.gather(1, top2), want.gather(1, top2)
            shift = ((g[:, 0] - g[:, 1]) - (w[:, 0] - w[:, 1])).abs().max().item()
            return ((got - want).abs().max().item(), shift,
                    int((got.argmax(-1) == want.argmax(-1)).sum()), want.abs().max().item())

        def verify_checks(c, p, label, lengths) -> None:
            """On serve's engine for ``c`` / ``p`` with the n-gram drafter
            (compiled), its pool's lanes prefilled with 8 random 640-token
            prompts: (i) one verify step of SPEC_DEPTH tokens on every lane
            (lanes at depths PROMPT + 8 + i), eager, against the same tokens
            fed through SPEC_DEPTH decode steps on a copy of the pool
            (``logit_gate``; the K/V rows each wrote), and the planted fault,
            the verify step with every start one too far; then the
            scheduler's own verify graph (``_run_verify``) at each chain
            length in ``lengths``, each replay bitwise the eager step in
            logits and pools, at other tokens and depths too; its chain-4
            graph profiled."""
            args = serve.build_parser().parse_args(
                spec_argv + ["--quant", str(c.w_bits), "--speculate", "ngram"])
            sched = serve.build_pool_engine(c, p, args, dev)
            pool, s_max = sched.pool, sched.s_max
            base = pool.k.shape[1] - LANES * s_max
            table = (base + np.arange(LANES * s_max).reshape(LANES, s_max)).astype(np.int32)
            prompts = torch.from_numpy(np.random.default_rng(5).integers(
                0, c.vocab, (LANES, MAX_LEN))).to(dev)
            _, ks, vs = lm.prefill_with_cache(p, c, prompts, MAX_LEN - 1)
            rows = torch.from_numpy(table[:, :MAX_LEN].reshape(-1).astype(np.int64)).to(dev)
            pool.k.index_copy_(1, rows, ks.flatten(1, 2))
            pool.v.index_copy_(1, rows, vs.flatten(1, 2))
            del ks, vs, prompts
            sched._row_table[:] = table
            sched._table_dirty = True
            pk0, pv0 = pool.k.clone(), pool.v.clone()
            starts = (PROMPT + 8 + np.arange(LANES)).astype(np.int32)
            toks = np.random.default_rng(6).integers(0, c.vocab, (LANES, SPEC_DEPTH))
            other = np.random.default_rng(7).integers(0, c.vocab, (LANES, SPEC_DEPTH))

            def step_in(tokens, st, k):
                """The scheduler's host inputs of a chain of ``k``."""
                wr = np.take_along_axis(table, st[:, None] + np.arange(k)[None], 1)
                return tokens[:, :k].astype(np.int32), wr, st

            def eager(kk, vv, tokens, wr, st):
                return sched._verify(p, sched._to_device(tokens), kk, vv,
                                     sched._to_device(table), sched._to_device(wr),
                                     sched._to_device(st))[0]

            ke, ve = pk0.clone(), pv0.clone()
            lg_v = eager(ke, ve, *step_in(toks, starts, SPEC_DEPTH))[..., :c.vocab].float()
            kd, vd = pk0.clone(), pv0.clone()
            table_dev, starts_dev = sched._to_device(table), sched._to_device(starts)
            lg_d = torch.stack([lm.decode_step_paged(
                p, c, sched._to_device(toks[:, j:j + 1]), kd, vd, table_dev,
                starts_dev + j)[0][:, 0, :c.vocab].float() for j in range(SPEC_DEPTH)], 1)
            per_pos = []
            for j in range(SPEC_DEPTH):
                diff, _, agree, _ = rows_vs(lg_v[:, j], lg_d[:, j])
                per_pos.append(dict(position=j, max_abs_logit_diff=diff, argmax_agree=agree))
            want = lg_d.flatten(0, 1)
            n = LANES * SPEC_DEPTH
            diff, shift, agree, scale = rows_vs(lg_v.flatten(0, 1), want)
            gate = logit_gate(f"{label} verify vs decode", diff, shift, agree, n, scale)
            wr = step_in(toks, starts, SPEC_DEPTH)[1].reshape(-1).astype(np.int64)
            wr_dev = torch.from_numpy(wr).to(dev)
            kc, vc = pk0.clone(), pv0.clone()
            lg_c = eager(kc, vc, toks.astype(np.int32), wr.reshape(LANES, SPEC_DEPTH),
                         starts + 1)[..., :c.vocab].float().flatten(0, 1)
            diff, shift, agree, scale = rows_vs(lg_c, want)
            control = logit_gate(f"{label} planted fault (starts + 1)", diff, shift, agree, n,
                                 scale, planted=True)
            phase("spec_verify_vs_decode", target=label, lanes=LANES, chain=SPEC_DEPTH,
                  pool=f"{LANES} random {MAX_LEN}-token prompts, prefilled", depths=starts.tolist(),
                  positions=per_pos, gate=gate, planted_starts_plus_1=control,
                  k_rows_bitwise=same_bits(ke[:, wr_dev], kd[:, wr_dev]),
                  max_abs_k_row_diff=(ke[:, wr_dev].float() - kd[:, wr_dev].float()).abs().max().item(),
                  max_abs_v_row_diff=(ve[:, wr_dev].float() - vd[:, wr_dev].float()).abs().max().item())
            del ke, ve, kd, vd, kc, vc, lg_v, lg_d, lg_c, want
            for k in lengths:
                cases = [step_in(toks, starts, k), step_in(other, starts + 3, k)]
                pool.k.copy_(pk0)
                pool.v.copy_(pv0)
                sched._run_verify(*cases[0])  # the graph's first call and capture
                for i, inputs in enumerate(cases):
                    pool.k.copy_(pk0)
                    pool.v.copy_(pv0)
                    lg_r = sched._run_verify(*inputs)[0]
                    ke, ve = pk0.clone(), pv0.clone()
                    lg_e = eager(ke, ve, *inputs)
                    replay_matches(f"{label} served verify graph, chain {k}", i,
                                   sched.verify_graphs[k].replays, i + 1,
                                   {"logits": (lg_r, lg_e), "pool_k": (pool.k, ke),
                                    "pool_v": (pool.v, ve)})
                    del ke, ve
            stats, by_name = profile_window(
                lambda: sched._run_verify(*step_in(toks, starts, SPEC_DEPTH)))
            phase("spec_verify_profile", target=label, compiled=True, lanes=LANES,
                  chain=SPEC_DEPTH, **stats,
                  top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5]))
            del sched, pool, pk0, pv0
            torch.cuda.empty_cache()

        def drafter_checks() -> None:
            """The twin drafter as serve builds it (``build_speculator`` on
            the dequantized target, packing its FFN leaves at 2 bits) with
            its steps as CUDA graphs, against an eager drafter on the same
            weights: ``start_lane`` (the prompt prefill's graph at (1,
            MAX_LEN), the scatter into its buffers after it) on three lanes,
            then ``propose`` (SPEC_DEPTH steps of the decode graph over its
            static row table) and one more decode step; each replay's
            outputs (logits, the prefill's K/V rows, the proposals) and both
            drafters' buffers bitwise equal (the scratch row 0 aside: the
            padding's rows land there in no set order); both graphs
            profiled."""
            gs = spec.build_speculator(cfg_q0, params_dq, spec.SpecConfig(
                "smollm_360m", SPEC_DEPTH, 2), slots=LANES, max_len=MAX_LEN)
            gs.use_graphs(torch.cuda.graph_pool_handle())
            gd = gs.drafter
            ed = spec.ModelDrafter(gd.cfg, gd.params, slots=LANES, max_len=MAX_LEN)
            rng = np.random.default_rng(10)
            lanes = [(0, PROMPT), (3, PROMPT - 40), (5, PROMPT + 100)]  # (slot, prompt length)
            prompts = {s: rng.integers(0, cfg.vocab, n).astype(np.int32) for s, n in lanes}

            def padded(s):
                out = np.zeros((1, MAX_LEN), np.int32)
                out[0, :len(prompts[s])] = prompts[s]
                return out, len(prompts[s]) - 1

            def buffers():
                return {"drafter_k": (gd.k[:, 1:], ed.k[:, 1:]),
                        "drafter_v": (gd.v[:, 1:], ed.v[:, 1:])}

            gd.start_lane(0, prompts[0])  # the prefill graph's first call and capture
            ed.start_lane(0, prompts[0])
            for i, (s, _) in enumerate(lanes):
                gd.start_lane(s, prompts[s])
                ed.start_lane(s, prompts[s])
                got = gd._prefill_graph._outputs
                want = ed._run_prefill(*padded(s))
                replay_matches("twin drafter prompt prefill (served)", i,
                               gd._prefill_graph.replays, i + 1,
                               {"logits": (got[0], want[0]), "ks": (got[1], want[1]),
                                "vs": (got[2], want[2]), **buffers()})
            views = [spec.LaneDraft(slot=s, rid=s, pending=int(prompts[s][-1]), out_len=0,
                                    n_rows=len(prompts[s]),
                                    history=prompts[s]) for s, _ in lanes]
            sampling = lm.SamplingParams()
            props_g, _ = gd.propose(views, SPEC_DEPTH, sampling)
            props_e, _ = ed.propose(views, SPEC_DEPTH, sampling)
            # propose's first decode step is the graph's first call
            replay_matches("twin drafter propose (served decode graph)", SPEC_DEPTH - 2,
                           gd._decode_graph.replays, SPEC_DEPTH - 1,
                           {"proposals": (torch.from_numpy(props_g), torch.from_numpy(props_e)),
                            **buffers()})
            token = np.zeros((LANES, 1), np.int32)
            token[[s for s, _ in lanes], 0] = props_g[:, -1]
            lengths = gd.lengths + SPEC_DEPTH
            lg_g = gd._run_decode(token, lengths)
            lg_e = ed._run_decode(token, lengths)
            replay_matches("twin drafter decode step (served)", SPEC_DEPTH - 1,
                           gd._decode_graph.replays, SPEC_DEPTH,
                           {"logits": (lg_g, lg_e), **buffers()})
            for step, fn in (("twin drafter decode", lambda: gd._run_decode(token, lengths)),
                             ("twin drafter prefill", lambda: gd._run_prefill(*padded(3)))):
                stats, by_name = profile_window(fn)
                phase("spec_drafter_profile", step=step, compiled=True, lanes=LANES, **stats,
                      top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5]))
            del gs, gd, ed
            torch.cuda.empty_cache()

        verify_checks(cfg_q2, params_q2, "--quant 2", range(1, SPEC_DEPTH + 1))
        verify_checks(cfg_q0, params_dq, "dequantized --quant 0", (1, SPEC_DEPTH))
        drafter_checks()
        class OracleDrafter:
            """Proposes plain decode's own tokens (teacher forcing's drafter)."""

            is_model = False

            def __init__(self, oracle):
                self.oracle = oracle

            def start_lane(self, slot, prompt):
                return 0, 0

            def release_lane(self, slot):
                pass

            def accept(self, slot, n_rows):
                pass

            def propose(self, lanes, k, sampling):
                props = np.zeros((len(lanes), k - 1), np.int32)
                for j, ln in enumerate(lanes):
                    out = self.oracle[ln.rid]
                    for m in range(k - 1):
                        pos = ln.out_len + m
                        props[j, m] = out[pos] if pos < len(out) else 0
                return props, 0

        def observed_run(c, p, on_row, speculative=None) -> tuple:
            """The serve cell on ``serve``'s compiled engine, every sampled
            position's (V,) logits row handed to ``on_row((rid, position),
            row)``, which may return a token to take in place of the sample
            (teacher forcing). Returns (outputs, metrics)."""
            args = serve.build_parser().parse_args(spec_argv)
            sched = serve.build_pool_engine(c, p, args, dev, speculative=speculative)
            sample_one = sched._sample_one

            def observed(req, row):
                tok = sample_one(req, row)
                forced = on_row((req.rid, len(req.output)), row[: c.vocab])
                return tok if forced is None else forced

            sched._sample_one = observed
            for prompt in serve.make_requests(args, c.vocab):
                sched.submit(prompt, args.gen_len)
            t0 = time.monotonic()
            st = sched.run()
            wall = time.monotonic() - t0
            return sched.outputs(), dict(tokens_per_s=st.generated_tokens / wall,
                                         mean_ttft_s=st.mean_ttft, wall_s=wall,
                                         verify_steps=st.verify_steps,
                                         accepted_per_step=st.accepted_per_step)

        def plain_and_forced(c, p, label) -> dict:
            """(ii) Plain compiled decode of the serve cell, each sampled
            position's logits row and top-1 / top-2 gap kept; then the same
            streams teacher-forced through speculative serving (a drafter that
            proposes plain decode's tokens, which are also taken in place of
            each sample, so every chain is accepted whole and every verify row
            sees plain decode's history): the largest |logit difference|
            and top-1 / top-2 gap shift between the verify path and plain
            decode, through ``logit_gate``. Returns plain decode's streams
            and gaps, and the largest gap shift: the bound for a parting."""
            rows, gaps = {}, {}

            def keep(key, row):
                rows[key] = row.copy()
                top = int(np.argmax(row))
                gaps[key] = (top, float(row[top] - np.partition(row, -2)[-2]))

            plain_out, plain_m = observed_run(c, p, keep)
            diffs, agree, pair_shift = {}, 0, 0.0

            def force(key, row):
                nonlocal agree, pair_shift
                want = rows[key]
                diffs[key] = float(np.abs(row - want).max())
                top = int(np.argmax(want))
                second = int(np.argmax(np.where(np.arange(len(want)) == top, -np.inf, want)))
                agree += int(np.argmax(row) == top)
                pair_shift = max(pair_shift, abs(float((row[top] - row[second])
                                                       - (want[top] - want[second]))))
                return plain_out[key[0]][key[1]]

            forced_out, forced_m = observed_run(
                c, p, force, speculative=spec.Speculator(OracleDrafter(plain_out), depth=SPEC_DEPTH))
            if forced_out != plain_out or len(diffs) != len(rows):
                fail(f"{label}: the teacher-forced run did not follow plain decode")
            rid0 = [d for (rid, _), d in diffs.items() if rid == 0]
            gate = logit_gate(f"{label} teacher-forced", max(diffs.values()), pair_shift, agree,
                              len(diffs), max(float(np.abs(r).max()) for r in rows.values()))
            out = dict(target=label, gate=gate, max_abs_logit_diff_stream_0=max(rid0),
                       median_max_abs_logit_diff=statistics.median(diffs.values()),
                       positions_bitwise=sum(d == 0.0 for d in diffs.values()),
                       forced_verify_steps=forced_m["verify_steps"],
                       forced_accepted_per_step=forced_m["accepted_per_step"],
                       plain_tokens_per_s=plain_m["tokens_per_s"],
                       plain_mean_ttft_s=plain_m["mean_ttft_s"])
            phase("spec_teacher_forced", **out)
            del rows
            return dict(outputs=plain_out, gaps=gaps, bound=pair_shift, plain=plain_m)

        def check_spec_run(label, m, counts, by_route, quant, compiled, twin) -> None:
            """A speculative serve cell run: every request done, every decode
            token from a verify step; when compiled, one chunk graph, one
            verify graph per chain length seen and (twin) the drafter's decode
            and prefill graphs, every other call a replay; launches exactly:
            flash_fwd 32 x (prefill chunks + drafter prefills) on the tensor
            cores, packed_matmul 96 x (verify steps at <= 16 rows [quant] +
            drafter decode steps) on the GEMV and 96 x (prefill chunks and the
            rest of the verify steps [quant] + drafter prefills) on the mma
            path, nothing else."""
            if (m["completed"] != 16 or m["generated_tokens"] != 16 * 64 or m["decode_steps"]
                    or m["accepted_tokens"] != 16 * 63 or not m["verify_steps"]):
                fail(f"{label}: {m['completed']} completed, {m['generated_tokens']} tokens, "
                     f"{m['decode_steps']} decode steps, {m['accepted_tokens']} accepted")
            drafted = m["draft_steps"] + m["draft_prefills"]
            if twin != bool(drafted) or (twin and m["draft_prefills"] != 16):
                fail(f"{label}: {m['draft_steps']} drafter steps, {m['draft_prefills']} prefills")
            if compiled:
                n_graphs = 1 + len(m["verify_graph_lengths"]) + 2 * twin
                calls = m["prefill_steps"] + m["verify_steps"] + drafted
                if not (m["compiled"] and m["graphs"] == n_graphs
                        and m["graph_replays"] == calls - n_graphs
                        and m["verify_graph_lengths"] == sorted(map(int, m["verify_steps_by_length"]))):
                    fail(f"{label}: {m['graphs']} graphs (want {n_graphs}), {m['graph_replays']} "
                         f"replays of {calls} calls, verify graphs {m['verify_graph_lengths']}")
            short = sum(n for k, n in m["verify_steps_by_length"].items() if LANES * int(k) <= 16)
            long_ = m["verify_steps"] - short
            per = 3 * spec_layers
            want_pm = {"gemv": per * ((short if quant else 0) + m["draft_steps"]),
                       "mma": per * ((m["prefill_steps"] + long_ if quant else 0)
                                     + m["draft_prefills"])}
            want_pm = {k: v for k, v in want_pm.items() if v}
            want_fa = spec_layers * (m["prefill_steps"] + m["draft_prefills"])
            others = {k: n for k, n in counts.items() if k not in ("packed_matmul", "flash_fwd")}
            if (by_route.get("packed_matmul", {}) != want_pm
                    or by_route.get("flash_fwd", {}) != {"mma": want_fa}
                    or counts["packed_matmul"] != sum(want_pm.values())
                    or counts["flash_fwd"] != want_fa or any(others.values())):
                fail(f"{label}: launches {counts}, by route {by_route}; want packed_matmul "
                     f"{want_pm}, flash_fwd mma {want_fa}")

        def parted_streams(outputs, ref, label) -> dict:
            """The streams that part from plain compiled decode's, each with
            plain decode's top-1 / top-2 gap at its first differing position,
            which must lie within the teacher-forced run's largest shift of
            that gap, or the phase fails."""
            parted = []
            for rid, toks in outputs.items():
                plain = ref["outputs"][rid]
                j = next((i for i, (x, y) in enumerate(zip(toks, plain)) if x != y), None)
                if j is not None:
                    parted.append(dict(rid=rid, position=j, token=toks[j], plain_token=plain[j],
                                       plain_top1_top2_gap=ref["gaps"][rid, j][1]))
            out = dict(streams_identical=len(outputs) - len(parted), streams=len(outputs),
                       parted=parted, near_tie_bound=ref["bound"])
            wide = [q for q in parted if not q["plain_top1_top2_gap"] <= ref["bound"]]
            if wide:
                fail(f"{label}: streams part from plain decode where its top-1 / top-2 gap "
                     f"exceeds the verify path's largest shift of it {ref['bound']}: {wide}")
            return out

        spec_runs = {}
        for drafter, quant, c_, p_ in (("ngram", 2, cfg_q2, params_q2),
                                       ("smollm_360m", 0, cfg_q0, params_dq)):
            twin = drafter != "ngram"
            label = "dequantized --quant 0" if twin else "--quant 2"
            ref = plain_and_forced(c_, p_, label)
            argv = spec_argv + ["--quant", str(quant), "--speculate", drafter, "--spec-quant", "2"]
            by_mode = {}
            for mode in ("eager", "compiled"):
                run_label = f"serve --speculate {drafter} ({label}, {mode})"
                trace = trace_dir / f"serve_spec_{drafter}_{mode}.jsonl"
                trace.unlink(missing_ok=True)
                if twin:
                    # serve's engine on the dequantized target: --speculate
                    # builds the twin (its FFN leaves packed at --spec-quant)
                    ops.reset_launch_counts()
                    metrics = serve.run_pool_engine(
                        c_, p_, serve.build_parser().parse_args(argv), dev,
                        compiled=None if mode == "compiled" else False)
                    counts, by_route = ops.launch_counts(), ops.launch_routes()
                elif mode == "eager":
                    metrics, counts, by_route = eager_serve(argv + ["--trace-out", str(trace)])
                else:
                    metrics, counts, by_route = serve_main(argv + ["--trace-out", str(trace)],
                                                           run_label)
                check_spec_run(run_label, metrics, counts, by_route, quant, mode == "compiled", twin)
                trace_check = None if twin else check_trace(
                    trace, metrics, run_label,
                    phases=("queue", "prefill", "draft", "verify", "wait"))
                by_mode[mode] = dict(metrics=metrics, counts=counts, by_route=by_route)
                phase("serve_spec", drafter=drafter, target=label, mode=mode,
                      launches_counted=counts, launches_by_route=by_route, trace=trace_check,
                      **{k: v for k, v in metrics.items() if k != "outputs"})
                if mode == "compiled":
                    for name, n in counts.items():
                        launches[name] += n
                    add_routes(by_route)
            c, e = by_mode["compiled"], by_mode["eager"]
            same_tokens = outputs_of(c["metrics"]) == outputs_of(e["metrics"])
            same_launches = (c["counts"], c["by_route"]) == (e["counts"], e["by_route"])
            vs_plain = parted_streams(outputs_of(c["metrics"]), ref, run_label)
            cm = c["metrics"]
            spec_runs[drafter] = dict(
                drafter=drafter, target=label, token_streams_identical=same_tokens,
                launch_counts_identical=same_launches, vs_plain_compiled=vs_plain,
                eager_vs_plain_streams_identical=parted_streams(
                    outputs_of(e["metrics"]), ref, run_label + " eager")["streams_identical"],
                plain_tokens_per_s=ref["plain"]["tokens_per_s"],
                plain_mean_ttft_s=ref["plain"]["mean_ttft_s"],
                **{f"{key}_{mode}": by_mode[mode]["metrics"][key]
                   for key in ("tokens_per_s", "mean_ttft_s", "wall_s", "verify_step_ms")
                   for mode in ("eager", "compiled")},
                **{key: cm[key] for key in (
                    "accepted_per_step", "accepted_tokens", "draft_tokens", "verify_steps",
                    "verify_steps_by_length", "verify_step_ms_replay", "propose_ms_per_verify_step",
                    "draft_steps", "draft_step_ms", "draft_prefills", "draft_prefill_ms")})
            if not twin:
                # the plain recording run against phase 5's serve --quant 2 run
                spec_runs[drafter]["plain_streams_equal_phase_5_serve_run"] = (
                    outputs_of(plain_q2_run) == ref["outputs"])
            phase("serve_spec_compiled_vs_eager", **spec_runs[drafter])
            if not (same_tokens and same_launches):
                fail(f"serve --speculate {drafter}: compiled and eager differ (tokens "
                     f"{same_tokens}, launches {c['counts']} {c['by_route']} != "
                     f"{e['counts']} {e['by_route']})")
            del ref
        del params_dq
        torch.cuda.empty_cache()

    for quant in (2, 0):
        qcfg = dataclasses.replace(cfg, w_bits=quant)
        plan, budget_mib = half_budget_plan(qcfg)
        n_streamed = sum(plan.layer_stream_mask(qcfg))
        for budget in (0.0, budget_mib):
            argv = [
                "--arch", "smollm_360m", "--quant", str(quant), "--requests", "16",
                "--batch", str(LANES), "--prompt-len", str(PROMPT), "--gen-len", "64",
                "--max-len", str(MAX_LEN), "--prefill-chunk", str(CHUNK),
                "--vmem-budget", repr(budget),
            ]
            traced = quant == 2 and not budget
            # --quant 2 also runs eagerly, in turns with the compiled run
            modes = (("compiled",) if quant == 0 else
                     ("eager", "compiled") if not budget else ("compiled", "eager"))
            by_mode = {}
            for mode in modes:
                trace = trace_dir / f"serve_q{quant}_{mode}.jsonl"
                trace.unlink(missing_ok=True)
                run_argv = argv + (["--trace-out", str(trace)] if traced else [])
                if mode == "eager":
                    metrics, counts, by_route = eager_serve(run_argv)
                else:
                    metrics, counts, by_route = serve_main(
                        run_argv, f"serve --quant {quant} --vmem-budget {budget}")
                    for name, n in counts.items():
                        launches[name] += n
                    add_routes(by_route)
                label = f"serve --quant {quant} --vmem-budget {budget} ({mode})"
                check_pool_run(label, metrics, counts, by_route, quant, mode == "compiled",
                               streamed_layers=n_streamed if budget else 0,
                               residency=plan.summary() if budget else None)
                trace_check = check_trace(trace, metrics, label) if traced else None
                by_mode[mode] = dict(metrics=metrics, counts=counts, by_route=by_route,
                                     trace=trace_check)
                phase("serve", quant=quant, vmem_budget_mib=budget, mode=mode,
                      launches_counted=counts, launches_by_route=by_route, trace=trace_check,
                      **{k: v for k, v in metrics.items() if k != "outputs"})
            runs[quant, budget > 0] = by_mode["compiled"]["metrics"]
            if "eager" in by_mode:
                c, e = by_mode["compiled"], by_mode["eager"]
                same_tokens = outputs_of(c["metrics"]) == outputs_of(e["metrics"])
                same_launches = (c["counts"], c["by_route"]) == (e["counts"], e["by_route"])
                phase("serve_compiled_vs_eager", quant=quant, vmem_budget_mib=budget,
                      token_streams_identical=same_tokens, launch_counts_identical=same_launches,
                      **{f"{key}_{mode}": by_mode[mode]["metrics"][key]
                         for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s", "wall_s")
                         for mode in ("eager", "compiled")},
                      **({f"mean_ms_per_request_{mode}": by_mode[mode]["trace"][
                          "mean_ms_per_request"] for mode in ("eager", "compiled")}
                         if traced else {}))
                if not same_tokens:
                    fail(f"serve --quant {quant} --vmem-budget {budget}: compiled and eager "
                         "token streams differ")
                if not same_launches:
                    fail(f"serve --quant {quant} --vmem-budget {budget}: compiled launches "
                         f"{c['counts']} {c['by_route']} != eager {e['counts']} {e['by_route']}")
            if budget:
                print(f"[chip_smoke] --quant {quant} budgeted: {n_streamed} layers streamed")
    for quant in (2, 0):
        base, bud = runs[quant, False], runs[quant, True]
        phase("serve_budgeted_vs_unbudgeted", quant=quant, **{
            f"{key}_{side}": run[key]
            for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s")
            for side, run in (("unbudgeted", base), ("budgeted", bud))
        })

    from repro_torch.runtime.kv_pool import KVPool
    from repro_torch.runtime.prefix_cache import PrefixCache
    from repro_torch.runtime.scheduler import Scheduler

    cfg_q2 = dataclasses.replace(cfg, w_bits=2)
    params_q2 = lm.init_params(cfg_q2, 0, device=dev)

    def init_diff(card, other, bits) -> dict:
        """``card``'s leaves against ``other``'s, tree by tree: the dense
        leaves that differ in any bit, the packed codes that differ and the
        largest difference of a packed scale."""
        out = dict(dense_leaves_differing=0, codes_differing=0, max_abs_scale_diff=0.0)
        for name, a in card.items():
            b = other[name]
            if isinstance(a, dict) and "packed" not in a:
                for key, v in init_diff(a, b, bits).items():
                    out[key] = max(out[key], v) if key.startswith("max") else out[key] + v
            elif isinstance(a, dict):
                codes = lm._unpack_codes(b["packed"].to(dev), bits)
                out["codes_differing"] += int((lm._unpack_codes(a["packed"], bits) != codes).sum())
                out["max_abs_scale_diff"] = max(out["max_abs_scale_diff"], (
                    a["scale"] - b["scale"].to(dev)).abs().max().item())
            else:
                out["dense_leaves_differing"] += int(not same_bits(a, b.to(dev)))
        return out

    # the packed weights do not depend on the device they were drawn for,
    # nor on whether a dense draw was packed later (as the other archs are)
    across = dict(
        cpu_init=init_diff(params_q2.tree(), lm.init_params(cfg_q2, 0, device="cpu").tree(), 2),
        card_dense_packed=init_diff(params_q2.tree(), lm.pack_ffn_params(
            lm.init_params(cfg, 0, device=dev), 2).tree(), 2))
    phase("init_across_devices", arch=cfg.name, w_bits=2, card_init_vs=across)
    if any(v for diff in across.values() for v in diff.values()):
        fail(f"{cfg.name} w_bits 2: the card's init differs: {across}")
    torch.cuda.empty_cache()

    def short_prompt_run(compiled) -> dict:
        """(a) 16 requests of 48-240 tokens over four 16-token buckets, 32
        generated each, 8 lanes, --quant 2, through serve's engine (its
        defaults: the prefix cache on)."""
        args = serve.build_parser().parse_args([
            "--arch", "smollm_360m", "--quant", "2", "--batch", str(LANES),
            "--gen-len", str(SHORT_GEN), "--max-len", str(SHORT_MAX_LEN),
            "--block-tokens", "16", "--prefill-chunk", str(CHUNK)])
        sched = serve.build_pool_engine(cfg_q2, params_q2, args, dev, compiled=compiled)
        return drive(sched, [list(short_prompts)], SHORT_GEN)

    lengths = [n for group in SHORT_LENS for n in group]
    short_prompts = [np.random.default_rng(100 + i).integers(0, cfg.vocab, size=n)
                     .astype(np.int32) for i, n in enumerate(lengths)]
    short_prompts = [short_prompts[i] for i in np.random.default_rng(7).permutation(len(lengths))]
    short = {}
    for compiled in (False, True, True, False):
        r = short_prompt_run(compiled)
        phase("serve_short_prompts", launches_counted=r["counts"],
              launches_by_route=r["by_route"], **r["metrics"])
        if r["metrics"]["completed"] != len(lengths):
            fail(f"short prompts (compiled {compiled}): {r['metrics']['completed']} completed")
        if compiled:
            if r["metrics"]["bucket_graphs"] != sorted({-(-n // 16) * 16 for n in lengths}):
                fail(f"short prompts: bucket graphs {r['metrics']['bucket_graphs']}")
            if r["metrics"]["whole_prompt_prefills"] + r["metrics"]["prefix_hits"] != len(lengths):
                fail(f"short prompts: {r['metrics']['whole_prompt_prefills']} whole-prompt "
                     f"prefills")
        if min(r["counts"]["packed_matmul"], r["counts"]["flash_fwd"]) <= 0:
            fail(f"short prompts: skipped a kernel: {r['counts']}")
        if compiled not in short:
            short[compiled] = r
            if compiled:
                for name, n in r["counts"].items():
                    launches[name] += n
                add_routes(r["by_route"])
    same_tokens = short[True]["outputs"] == short[False]["outputs"]
    same_launches = ((short[True]["counts"], short[True]["by_route"])
                     == (short[False]["counts"], short[False]["by_route"]))
    phase("serve_short_prompts_compiled_vs_eager", token_streams_identical=same_tokens,
          launch_counts_identical=same_launches,
          **{f"{key}_{'compiled' if c else 'eager'}": short[c]["metrics"][key]
             for key in ("tokens_per_s", "mean_ttft_s", "prefill_host_ms_mean",
                         "prefill_host_ms_repeat_bucket_mean", "wall_s") for c in (False, True)})
    if not (same_tokens and same_launches):
        fail(f"short prompts: compiled and eager differ (tokens {same_tokens}, launches "
             f"{same_launches})")

    waves = session_waves(cfg.vocab)

    def skip_cow_copy(pool):
        """The planted fault: a copy-on-write adoption whose tail block is
        left unwritten (zeros where the matched rows should be)."""
        adopt, t = pool.adopt_prefix, pool.block_tokens

        def faulty(rid, shared, tail_block, n_tokens):
            adopt(rid, shared, tail_block, n_tokens)
            if tail_block is not None:
                b = pool.blocks_of(rid)[-1]
                pool.k[:, b * t:(b + 1) * t].zero_()
                pool.v[:, b * t:(b + 1) * t].zero_()

        pool.adopt_prefix = faulty

    shared = {}
    for run in ("no_cache", "cache", "cache_planted_fault"):
        cached = run != "no_cache"
        pool = KVPool.for_slots(cfg_q2, slots=LANES, max_len=SESSION_MAX_LEN, block_tokens=16,
                                device=dev)
        if run == "cache_planted_fault":
            skip_cow_copy(pool)
        sched = Scheduler(cfg_q2, params_q2, pool, slots=LANES, max_len=SESSION_MAX_LEN,
                          prefill_chunk=CHUNK,
                          prefix_cache=PrefixCache(pool) if cached else None)
        r = drive(sched, waves, SESSION_GEN)
        del sched, pool
        phase("serve_shared_prefix", run=run, sessions=SESSIONS, turns=TURNS,
              turn_tokens=TURN_TOKENS, launches_counted=r["counts"],
              launches_by_route=r["by_route"], **r["metrics"])
        shared[run] = r
        if run == "cache_planted_fault":
            continue  # a control, not the main path: its launches are not counted
        for name, n in r["counts"].items():
            launches[name] += n
        add_routes(r["by_route"])
        if min(r["counts"]["packed_matmul"], r["counts"]["flash_fwd"]) <= 0:
            fail(f"shared-prefix trace (cached {cached}): skipped a kernel: {r['counts']}")
    warm, cold = shared["cache"]["metrics"], shared["no_cache"]["metrics"]
    cut = 1.0 - warm["prefill_tokens"] / max(1, cold["prefill_tokens"])

    def against_uncached(run) -> dict:
        """A cached run against the uncached one: the streams that part
        (with the two tokens' logit gaps in both runs where they do), and
        the sampled positions whose whole logits row is not bitwise the
        uncached run's."""
        a, b = shared[run], shared["no_cache"]
        parted = []
        for rid, toks in a["outputs"].items():
            other = b["outputs"][rid]
            j = next((i for i, (x, y) in enumerate(zip(toks, other)) if x != y), None)
            if j is None:
                continue
            x, y = toks[j], other[j]
            ta, tb = a["top_logits"][rid, j], b["top_logits"][rid, j]
            parted.append(dict(rid=rid, position=j, token_cache=x, token_no_cache=y,
                               gap_cache=ta[x] - ta.get(y, -math.inf),
                               gap_no_cache=tb[y] - tb.get(x, -math.inf)))
        rows_off = sorted(key for key in b["digests"] if a["digests"].get(key) != b["digests"][key])
        top_diff = max((abs(a["top_logits"][key][i] - v) for key in rows_off
                        if key in a["top_logits"] for i, v in b["top_logits"][key].items()
                        if i in a["top_logits"][key]), default=0.0)
        return dict(streams_identical=len(a["outputs"]) - len(parted),
                    streams=len(a["outputs"]), parted=parted[:8],
                    positions=len(b["digests"]), positions_whose_logits_differ=len(rows_off),
                    max_abs_top_logit_diff=top_diff)

    honest, planted = against_uncached("cache"), against_uncached("cache_planted_fault")

    def ops_whose_rows_follow_m(tokens) -> dict[str, int]:
        """Along a whole-prompt prefill of ``tokens`` (S rows), each op of
        each layer fed that prefill's own input twice more: its first S/2
        rows (a bucket of half the length) and the rows padded to CHUNK (a
        chunk); flash also as a chunk at q_offset S/2 over the rows padded
        to MAX_LEN. Returns, per op, the layers whose rows came out other
        bits than in the S-row call."""
        s_len = tokens.shape[1]
        h_len = s_len // 2
        off = {}

        def same(name, a, b):
            off[name] = off.get(name, 0) + int(not same_bits(a, b))

        def pad(x, n):
            return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1]) + x.shape[2:])], 1)

        x = lm.embed(tokens, params_q2["embed"], lm.torch_dtype(cfg_q2))
        pos = torch.arange(s_len, device=dev)[None]
        for i in range(cfg_q2.n_layers):
            lp = params_q2.layer(i)
            h = lm.rms_norm(x, lp["ln1"], cfg_q2.norm_eps)
            same("rms_norm", lm.rms_norm(x[:, :h_len], lp["ln1"], cfg_q2.norm_eps), h[:, :h_len])
            qkv = {}
            for w in ("wq", "wk", "wv", "wo"):
                src = h if w != "wo" else qkv["o"]
                qkv[w] = y = lm.dense(src, lp[w])
                same(f"dense_{w}", lm.dense(src[:, :h_len], lp[w]), y[:, :h_len])
                same(f"dense_{w}", lm.dense(pad(src, CHUNK), lp[w])[:, :s_len], y)
                if w == "wv":
                    shape = lambda t, n: t.reshape(1, s_len, n, cfg_q2.hd)  # noqa: E731
                    q = lm.apply_rope(shape(qkv["wq"], cfg_q2.n_heads), pos, cfg_q2.rope_theta)
                    k = lm.apply_rope(shape(qkv["wk"], cfg_q2.n_kv), pos, cfg_q2.rope_theta)
                    v = shape(y, cfg_q2.n_kv)
                    o = ops.flash_attention(q, k, v, causal=True)
                    same("flash_fwd", ops.flash_attention(
                        q[:, :h_len], k[:, :h_len], v[:, :h_len], causal=True), o[:, :h_len])
                    start = torch.tensor([h_len], dtype=torch.int32, device=dev)
                    same("flash_fwd", ops.flash_attention(
                        pad(q[:, h_len:], CHUNK), pad(k, MAX_LEN), pad(v, MAX_LEN), causal=True,
                        q_offset=start)[:, :s_len - h_len], o[:, h_len:])
                    qkv["o"] = o.reshape(1, s_len, -1)
            x = x + qkv["wo"]
            h = lm.rms_norm(x, lp["ln2"], cfg_q2.norm_eps)[0]
            g = None
            for w in ("w1", "w3", "w2"):
                src = h if w != "w2" else g
                y = lm.packed_dense(src, lp[w], cfg_q2.w_bits)
                same(f"packed_matmul_{w}", lm.packed_dense(src[:h_len], lp[w], cfg_q2.w_bits),
                     y[:h_len])
                same(f"packed_matmul_{w}", lm.packed_dense(
                    pad(src[None], CHUNK)[0], lp[w], cfg_q2.w_bits)[:s_len], y)
                g = F.silu(y) if w == "w1" else g * y if w == "w3" else g
            x = x + y[None]
        return off

    rows_follow_m = ops_whose_rows_follow_m(torch.from_numpy(waves[1][0][None]).to(dev))
    # a prompt's K rows from a prefill of its first half and from one of
    # all of it (the cached and the uncached route's batches), at every layer
    half = torch.from_numpy(waves[1][0][None]).to(dev)
    _, k_half, _ = lm.prefill_with_cache(params_q2, cfg_q2, half[:, :TURN_TOKENS],
                                         TURN_TOKENS - 1)
    _, k_all, _ = lm.prefill_with_cache(params_q2, cfg_q2, half, half.shape[1] - 1)
    k_all = k_all[:, :, :TURN_TOKENS]
    k_layers_off = [i for i in range(cfg_q2.n_layers) if not same_bits(k_half[i], k_all[i])]
    phase("serve_shared_prefix_cache_vs_none",
          layers_whose_k_rows_differ=k_layers_off,
          layers_whose_op_rows_follow_m=rows_follow_m,
          token_streams_identical=honest["streams_identical"] == honest["streams"],
          logits_identical=honest["positions_whose_logits_differ"] == 0,
          cache=honest, planted_fault=planted,
          prefill_token_cut=cut, **{f"{key}_{side}": m[key] for key in (
              "prefill_tokens", "mean_ttft_s", "tokens_per_s", "prefix_hit_rate",
              "cow_copies", "shared_blocks_peak", "chunk_graphs", "graphs")
              for side, m in (("cache", warm), ("no_cache", cold))})
    if k_layers_off or any(rows_follow_m.values()):
        fail(f"shared-prefix trace: a prompt's K rows follow the prefill's length at "
             f"layers {k_layers_off[:8]}; op rows follow M: {rows_follow_m}")
    if honest["parted"] or honest["positions_whose_logits_differ"]:
        fail(f"shared-prefix trace: cached and uncached serving differ: "
             f"{honest['streams'] - honest['streams_identical']} streams part, the logits "
             f"of {honest['positions_whose_logits_differ']} positions differ; "
             f"{honest['parted'][:4]}")
    if not planted["positions_whose_logits_differ"]:
        fail("shared-prefix trace: a skipped copy-on-write copy went unseen by the comparison")
    if not (warm["shared_blocks_peak"] > 0 and warm["chunk_graphs"] == 1
            and cut >= PREFIX_MIN_CUT and warm["cow_copies"] > 0):
        fail(f"shared-prefix trace: shared peak {warm['shared_blocks_peak']}, chunk graphs "
             f"{warm['chunk_graphs']}, prefill cut {cut}, cow copies {warm['cow_copies']}")
    # a follow-up turn that adopts the rows decode made
    followup_turn(cfg_q2, params_q2)

    # the fixed-batch engine at --quant 2: its decode step a graph whose
    # replays are bitwise the eager step, every cache leaf included; the
    # cell eager and compiled, every FFN matmul on the GEMV (M = LANES)
    cache0 = random_cache(cfg_q2, LANES, FIXED_MAX_LEN, FIXED_PROMPT, seed=7)
    hold_cache_replay(f"{cfg.name} fixed decode step, --quant 2", cfg_q2, params_q2, cache0)
    del cache0
    fixed_cell(f"serve {cfg.name} --engine fixed --quant 2", cfg_q2, params_q2,
               lambda steps: {"packed_matmul": {"gemv": 3 * cfg_q2.n_layers * steps}})

    speculative_phase(cfg_q2, params_q2, runs[2, False])
    phase_seconds("5 serve, smollm-360m")
    with heap_frozen():
        fleet_phase(cfg_q2, params_q2)
    phase_seconds("5 (d) fleet, smollm-360m")

    # ------- 4-5 for the other dense archs, at full width (and depth) -------
    def window_vs_cpu(c, params) -> None:
        """Past the sliding window: a (window + CHUNK)-token prompt in
        CHUNK-token chunks, then WINDOW_STEPS greedy decode steps (the
        card's tokens fed to every side), in bf16 on the card against
        float32 on the CPU with the same weights; each chunk's and step's
        logits held by ``logits_vs_cpu``. The CPU also runs without the
        window: past it, the card must be closer to the windowed CPU than
        the unwindowed CPU is (the mask moves the logits more than bf16
        does)."""
        w = c.sliding_window
        n_prompt = w + CHUNK
        total = n_prompt + WINDOW_STEPS
        cpu_c, cpu_p = cpu_copy(c, params)
        prompt = torch.from_numpy(
            np.random.default_rng(9).integers(0, c.vocab, size=(1, n_prompt)))
        table = (16 + torch.arange(total))[None]
        sides = {"card": (c, params, dev), "cpu": (cpu_c, cpu_p, "cpu"),
                 "cpu_no_window": (dataclasses.replace(cpu_c, sliding_window=0), cpu_p, "cpu")}
        pools = {name: [torch.zeros((c.n_layers, total + 16, c.n_kv, c.hd),
                                    dtype=lm.torch_dtype(sc), device=sd) for _ in range(2)]
                 for name, (sc, _, sd) in sides.items()}
        logits = {name: [] for name in sides}
        t0 = time.monotonic()
        for s0 in range(0, n_prompt, CHUNK):
            for name, (sc, sp, sd) in sides.items():
                lg, _, _ = lm.prefill_chunk_paged(
                    sp, sc, prompt[:, s0:s0 + CHUNK].to(sd), *pools[name], table.to(sd),
                    table[:, s0:s0 + CHUNK].to(sd), s0, CHUNK - 1)
                logits[name].append(lg[0, 0, : c.vocab].float().cpu())
        for i in range(WINDOW_STEPS):
            tok = logits["card"][-1].argmax().reshape(1, 1)
            for name, (sc, sp, sd) in sides.items():
                lg, _, _ = lm.decode_step_paged(sp, sc, tok.to(sd), *pools[name], table.to(sd),
                                                torch.tensor([n_prompt + i], device=sd))
                logits[name].append(lg[0, 0, : c.vocab].float().cpu())
        positions = [s0 + CHUNK - 1 for s0 in range(0, n_prompt, CHUNK)] + [
            n_prompt + i for i in range(WINDOW_STEPS)]
        held = [logits_vs_cpu(a, b, f"{c.name} past its window", position=pos)
                for pos, a, b in zip(positions, logits["card"], logits["cpu"])]
        past = [i for i, pos in enumerate(positions) if pos >= w]
        err_past = max(held[i]["max_abs_logit_err"] for i in past)
        moves = min((logits["cpu"][i] - logits["cpu_no_window"][i]).abs().max().item()
                    for i in past)
        phase("window", arch=c.name, layers=c.n_layers, window=w, prompt=n_prompt, chunk=CHUNK,
              decode_steps=WINDOW_STEPS, positions_held=len(held), positions_past_window=len(past),
              min_cosine=min(h["cosine"] for h in held),
              max_top1_cpu_logit_gap=max(h["top1_cpu_logit_gap"] for h in held),
              max_abs_logit_err=max(h["max_abs_logit_err"] for h in held),
              max_abs_logit_err_past_window=err_past,
              window_moves_cpu_logits_min_over_positions=moves,
              seconds=time.monotonic() - t0)
        if not err_past < moves:
            fail(f"{c.name} past its window: the card is {err_past} from the windowed CPU, "
                 f"the unwindowed CPU only {moves}")

    def serve_arch(arch) -> None:
        """Phases 4 and 5 for one of the other dense archs: its prefill at
        full width and depth 2 against the CPU (and h2o-danube's run past its
        window); the serve cell at --quant 0 on one dense draw at full width
        and depth; that draw's FFN leaves packed (``pack_ffn_params``,
        bitwise ``init_params`` at w_bits 2); its decode step and prefill
        chunk captured, each replay bitwise its eager step; then the serve
        cell at --quant 2, eagerly and compiled in turns (identical tokens
        and launches)."""
        full = get_config(arch)
        c2, cq0 = arch_configs(arch)
        p2, init2 = timed_init(c2)
        prefill_vs_cpu(c2, p2, arch=arch, layers=2, depth_cut="2 of "
                       f"{full.n_layers} layers: the CPU's float32 side stays in seconds", **init2)
        if full.sliding_window:
            window_vs_cpu(*first_layers(c2, p2, WINDOW_LAYERS))
        del p2

        argv = ["--arch", arch, "--requests", "16", "--batch", str(LANES), "--prompt-len",
                str(PROMPT), "--gen-len", "64", "--max-len", str(MAX_LEN), "--prefill-chunk",
                str(CHUNK)]
        params0, init = timed_init(cq0)
        prefetch_after(arch)
        cut = {} if cq0.n_layers == full.n_layers else dict(depth_cut=(
            f"{cq0.n_layers} of {full.n_layers} layers: room for the hybrid phase within "
            "the run's time limit"))
        phase("init", arch=arch, quant=0, layers=cq0.n_layers, **cut, **init)
        ops.reset_launch_counts()
        metrics = serve.run_pool_engine(cq0, params0, serve.build_parser().parse_args(
            argv + ["--quant", "0"]), dev)
        counts, by_route = ops.launch_counts(), ops.launch_routes()
        check_pool_run(f"serve {arch} --quant 0", metrics, counts, by_route, 0, True)
        phase("serve", arch=arch, quant=0, mode="compiled", init_s=init["init_s"],
              launches_counted=counts, launches_by_route=by_route,
              **{k: v for k, v in metrics.items() if k != "outputs"})
        for name, n in counts.items():
            launches[name] += n
        add_routes(by_route)

        cq2 = dataclasses.replace(cq0, w_bits=2)
        params, packing = take_packed(cq0, params0)
        pack_s = packing["pack_s"]
        del params0
        torch.cuda.empty_cache()
        phase("init", arch=arch, quant=2, layers=cq2.n_layers, dense_init_s=init["init_s"],
              **packing, weights_mib=sum(t.nbytes for t in itertools.chain(
                  params.parameters(), params.buffers())) / 2**20)
        rows0 = (cq2.n_layers, LANES * MAX_LEN + 16, cq2.n_kv, cq2.hd)
        pool_gen = torch.Generator(device=dev).manual_seed(4)
        pk0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        pv0 = torch.randn(rows0, generator=pool_gen, device=dev, dtype=torch.bfloat16)
        table = (16 + torch.arange(LANES * MAX_LEN)).reshape(LANES, MAX_LEN)
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, cq2.vocab, (LANES, 1)))
        hold_replay(f"{arch} decode step, --quant 2",
                    lambda k_, v_, t_, tb, ln: lm.decode_step_paged(
                        params, cq2, t_, k_, v_, tb, ln)[0],
                    (tok, table, torch.full((LANES,), PROMPT + 8)), pk0, pv0)
        chunk = torch.from_numpy(
            np.random.default_rng(2).integers(0, cq2.vocab, size=(1, CHUNK)))
        one = table[:1]

        def chunk_in_at(start):
            return (chunk, one, one[:, start:start + CHUNK], torch.tensor([start]),
                    torch.tensor([CHUNK - 1]))

        hold_replay(f"{arch} prefill chunk, --quant 2",
                    lambda k_, v_, t_, rows, wr, st, last: lm.prefill_chunk_paged(
                        params, cq2, t_, k_, v_, rows, wr, st, last)[0],
                    chunk_in_at(CHUNK), pk0, pv0, replay_in=[chunk_in_at(s) for s in (CHUNK, 37)])
        del pk0, pv0
        # where a compiled decode step's and prefill chunk's time goes
        phase("decode_profile", arch=arch, **profile_decode(params, cq2, compiled=True))
        pk1 = torch.zeros((cq2.n_layers, MAX_LEN + 16, cq2.n_kv, cq2.hd),
                          dtype=torch.bfloat16, device=dev)
        pv1 = torch.zeros_like(pk1)
        chunk_graph = CapturedStep(
            lambda t_, rows, wr, st, last: lm.prefill_chunk_paged(
                params, cq2, t_, pk1, pv1, rows, wr, st, last)[0],
            device=dev, mempool=torch.cuda.graph_pool_handle())
        phase("prefill_profile", arch=arch, compiled=True, chunk=CHUNK, start=CHUNK,
              pool_rows=MAX_LEN, **chunk_profile(lambda: chunk_graph(*chunk_in_at(CHUNK))))
        del chunk_graph, pk1, pv1

        by_mode = {}
        for mode in ("eager", "compiled"):
            args = serve.build_parser().parse_args(argv + ["--quant", "2"])
            ops.reset_launch_counts()
            metrics = serve.run_pool_engine(cq2, params, args, dev,
                                            compiled=None if mode == "compiled" else False)
            counts, by_route = ops.launch_counts(), ops.launch_routes()
            label = f"serve {arch} --quant 2 ({mode})"
            check_pool_run(label, metrics, counts, by_route, 2, mode == "compiled")
            by_mode[mode] = (metrics, counts, by_route)
            phase("serve", arch=arch, quant=2, mode=mode, init_s=init["init_s"] + pack_s,
                  launches_counted=counts, launches_by_route=by_route,
                  **{k: v for k, v in metrics.items() if k != "outputs"})
        (cm, cc, cr), (em, ec, er) = by_mode["compiled"], by_mode["eager"]
        same_tokens = outputs_of(cm) == outputs_of(em)
        same_launches = (cc, cr) == (ec, er)
        phase("serve_compiled_vs_eager", arch=arch, quant=2, token_streams_identical=same_tokens,
              launch_counts_identical=same_launches,
              **{f"{key}_{mode}": by_mode[mode][0][key]
                 for key in ("tokens_per_s", "decode_step_ms", "mean_ttft_s", "wall_s")
                 for mode in ("eager", "compiled")})
        if not (same_tokens and same_launches):
            fail(f"serve {arch} --quant 2: compiled and eager differ (tokens {same_tokens}, "
                 f"launches {cc} {cr} != {ec} {er})")
        for name, n in cc.items():
            launches[name] += n
        add_routes(cr)
        del params, by_mode
        torch.cuda.empty_cache()

    # ---------------- 7. training at full width and depth ----------------
    # smollm-360m at depth 4, then h2o-danube-1.8b (head dim 80) at depth 2
    gcfg = dataclasses.replace(cfg, n_layers=GRAD_DEPTH)
    gparams, loss_card, grads_card = grads_vs_cpu(gcfg)
    # the recomputing modes on the card recompute the same bf16 forward
    # (the kernels are deterministic): the same loss (1e-5), and the same
    # gradients but for the order of the embedding backward's atomics
    for remat in ("full", "dots"):
        loss_r, grads_r = loss_and_grads(gparams, gcfg, dev, remat)
        cos_r = {
            name: F.cosine_similarity(g.float().flatten(), grads_card[name].float().flatten(),
                                      dim=0).item()
            for name, g in grads_r.items()
        }
        worst_r = min(cos_r, key=cos_r.get)
        phase("train_gradients_remat", remat=remat, loss=loss_r, loss_none=loss_card,
              worst_leaf=worst_r, worst_cosine_to_none=cos_r[worst_r])
        if abs(loss_r - loss_card) > 1e-5 * abs(loss_card) or cos_r[worst_r] < REMAT_MIN_COS:
            fail(f"--remat {remat} on the card: loss {loss_r} vs {loss_card}, "
                 f"worst cosine {cos_r[worst_r]} ({worst_r})")
    del gparams, grads_card, grads_r
    dn2 = dataclasses.replace(get_config("h2o_danube_1p8b"), n_layers=2)
    grads_vs_cpu(dn2, arch="h2o_danube_1p8b",
                 depth_cut="2 of 24 layers: the CPU's float32 side stays in seconds")

    # (b) the train CLI: 20 steps, then 5 under --remat full
    n_layers = cfg.n_layers
    train_runs = []
    for steps, remat in ((TRAIN_STEPS, "none"), (REMAT_STEPS, "full")):
        argv = ["--arch", "smollm_360m", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(steps), "--remat", remat]
        buf = io.StringIO()
        ops.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.main(argv)
        counts = ops.launch_counts()
        by_route = ops.launch_routes()
        text = buf.getvalue()
        sys.stderr.write(text)
        if rc != 0:
            fail(f"train --steps {steps} --remat {remat} exited {rc}")
        metrics = json.loads(
            next(l for l in text.splitlines() if l.startswith("[train/metrics] ")).split(" ", 1)[1]
        )
        losses = metrics["losses"]
        k = min(5, steps // 2)
        head, tail = statistics.mean(losses[:k]), statistics.mean(losses[-k:])
        if len(losses) != steps or not all(map(math.isfinite, losses)) or not tail < head:
            fail(f"train --remat {remat}: losses {losses} (mean of the last {k} must be "
                 f"below the first {k}'s)")
        want = dict.fromkeys(counts, 0) | {
            "flash_fwd": n_layers * steps * (2 if remat == "full" else 1),
            "flash_bwd_dq": n_layers * steps,
            "flash_bwd_dkv": n_layers * steps,
        }
        if counts != want:
            fail(f"train --remat {remat}: launches {counts}, not {want}")
        if by_route != {name: {"mma": want[name]}
                        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}:
            fail(f"train --remat {remat}: launches by route {by_route}, not all on the "
                 f"tensor-core kernels")
        for name, n in counts.items():
            launches[name] += n
        add_routes(by_route)
        run = dict(launches_counted=counts, launches_by_route=by_route, first_losses_mean=head,
                   last_losses_mean=tail, **metrics)
        train_runs.append(run)
        phase("train", **run)

    # (c) where a train step's time goes, and (d) the checkpoint of its state
    params = lm.init_params(cfg, 0, device=dev, trainable=True)
    opt = AdamW()
    state = [opt.init(params)]
    step_fn = make_train_step(cfg, opt, remat="none")
    pipe = TokenPipeline(vocab=cfg.vocab, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=0)

    def train_step(i):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
        _, state[0], m = step_fn(params, state[0], tb)
        return m

    for i in range(2):
        train_step(i)
    torch.cuda.synchronize()
    walls = []
    for i in range(2, 5):
        t0 = time.monotonic()
        train_step(i)
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_step(5)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kern:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    dev_ms = sum(by_name.values())
    host_ms = statistics.median(walls)

    def share(word):
        return sum(ms for name, ms in by_name.items() if word in name) / dev_ms

    step_profile = dict(
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, host_step_ms=host_ms, host_step_ms_runs=walls,
        device_step_ms=dev_ms, device_busy_share=dev_ms / host_ms, kernels_per_step=len(kern),
        flash_bwd_share=share("flash_bwd"), flash_fwd_share=share("flash_fwd"),
        top_kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5]),
    )
    phase("train_profile", **step_profile)

    ck_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    mgr = CheckpointManager(str(ck_dir), keep=1)
    t0 = time.monotonic()
    mgr.save(6, (params, state[0]), extra={"data_step": 6})
    save_s = time.monotonic() - t0
    fresh = lm.init_params(cfg, 1, device=dev, trainable=True)
    t0 = time.monotonic()
    (fresh, fresh_state), extra = mgr.restore((fresh, opt.init(fresh)))
    restore_s = time.monotonic() - t0
    want_tree = {"params": params.tree(), "mu": state[0].mu, "nu": state[0].nu,
                 "step": {"step": state[0].step}}
    got_tree = {"params": fresh.tree(), "mu": fresh_state.mu, "nu": fresh_state.nu,
                "step": {"step": fresh_state.step}}
    got_leaves = dict(flat(got_tree))
    differ = [name for name, t in flat(want_tree) if not same_bits(t, got_leaves[name])]
    ck_bytes = sum(f.stat().st_size for f in ck_dir.rglob("*.npy"))
    shutil.rmtree(ck_dir, ignore_errors=True)
    phase("train_checkpoint", leaves=len(got_leaves), bytes=ck_bytes, save_s=save_s,
          restore_s=restore_s, extra=extra, leaves_differing=differ)
    if differ or extra != {"data_step": 6}:
        fail(f"checkpoint on the card: {len(differ)} leaves differ after restore: {differ[:5]}")
    del params, state, fresh, fresh_state, want_tree, got_tree, got_leaves

    phase_seconds("7 train")

    # ---------------- the analysis phase, on phase 5's weights ----------------
    analysis_phase(cfg_q2, params_q2,
                   {quant: runs[quant, False]["tokens_per_s"] for quant in (2, 0)})
    del params_q2
    phase_seconds("analysis")

    # ---------------- 4-5 for the other dense archs (last) ----------------
    for arch in NEW_ARCHS:
        serve_arch(arch)
        phase_seconds(f"4-5 {arch}")

    # ---- the MoE, hybrid, SSM, vlm and enc-dec families, then train_families (last) ----
    moe_phase()
    hybrid_phase()
    ssm_phase()
    vlm_phase()
    encdec_phase()
    train_families_phase(held)
    leftover = [c.name for c in prefetched]
    draw_pool.shutdown(cancel_futures=True)
    pack_pool.shutdown(cancel_futures=True)
    host_done.set()
    if leftover or packed_ahead:
        fail(f"host draws queued and never taken: {leftover}, packs {list(packed_ahead)}")

    # ---------------- result ----------------
    head_pm = next(c for c in packed_cases if (c["bits"], c["m"], c["k"]) == (2, LANES, d))
    head_fa = flash_cases[0]
    head_sm = stream_cases[0]
    head_mv = next(c for c in mvau_cases if (c["case"], c["bits"]) == ("conv1", 1))
    nums = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")

    def route(kernel_name, takes, launched, head):
        """One route of a wrapper with several kernels: its launches on the
        main path and its numbers at its head case."""
        return dict(kernel=kernel_name, takes=takes, launches=launched,
                    shape={k: head[k] for k in head if k not in nums and k != "rel_err"},
                    **{k: head[k] for k in nums})

    def packed_head(m, k, x):
        return next(c for c in packed_cases if (c["bits"], c["m"], c["k"], c["x"]) == (2, m, k, x))

    def flash_head(dtype):
        return next(c for c in flash_cases if (c["case"], c["dtype"]) == ("prefill_causal", dtype))

    packed_routes = {
        "gemv": route("gemv_kernel", "M <= 16", routes["packed_matmul"].get("gemv", 0),
                      packed_head(LANES, d, "bfloat16")),
        "mma": route("mma_kernel", "M > 16, bf16 x (tensor cores)",
                     routes["packed_matmul"].get("mma", 0), packed_head(PROMPT, d, "bfloat16")),
        "tiled_f32": route("tiled_kernel", "M > 16, f32 x (CUDA cores)",
                           routes["packed_matmul"].get("tiled_f32", 0),
                           packed_head(CHUNK, d, "float32")),
    }
    flash_routes = {
        "mma": route("flash_fwd_mma_kernel", "bf16 (tensor cores)",
                     routes["flash_fwd"].get("mma", 0), flash_head("bfloat16")),
        "f32": route("flash_fwd_kernel", "f32 (CUDA cores)", routes["flash_fwd"].get("f32", 0),
                     flash_head("float32")),
    }
    kernels = [
        dict(name="packed_matmul", route="cuda",
             source="src/repro_torch/csrc/packed_matmul.cu",
             replaces="src/repro/kernels/packed_matmul.py:74",
             launches=launches["packed_matmul"],
             launches_hybrid_phase=hybrid_launches.get("packed_matmul", {}),
             launches_fixed_engine=fixed_launches.get("packed_matmul", {}),
             launches_vlm_phase=family_launches["vlm"].get("packed_matmul", {}),
             launches_encdec_phase=family_launches["encdec"].get("packed_matmul", {}),
             launches_fleet_phase=family_launches["fleet"].get("packed_matmul", {}),
             shape=f"bits=2 M={LANES} K={d} N={ff} bf16",
             tolerance=f"rel {PACKED_REL_TOL}",
             **{k: head_pm[k] for k in nums},
             timing_floor_ms=timing_floor_ms,
             routes=packed_routes,
             graph_replays=[c for c in graph_checks if c["kernel"] == "packed_matmul"],
             cases=packed_cases, check_cases=packed_checks),
        dict(name="flash_fwd", route="cuda",
             source="src/repro_torch/csrc/flash_fwd.cu",
             replaces="src/repro/kernels/flash_attention.py:218",
             launches=launches["flash_fwd"],
             launches_hybrid_phase=hybrid_launches.get("flash_fwd", {}),
             launches_vlm_phase=family_launches["vlm"].get("flash_fwd", {}),
             launches_encdec_phase=family_launches["encdec"].get("flash_fwd", {}),
             launches_fleet_phase=family_launches["fleet"].get("flash_fwd", {}),
             launches_noncausal=noncausal_launches,
             shape=f"causal Sq=Sk={PROMPT} Hq={hq} Hkv={hkv} D={hd} bf16",
             tolerance=f"out abs {FLASH_OUT_TOL}, lse abs {FLASH_LSE_TOL}",
             **{k: head_fa[k] for k in nums},
             routes=flash_routes,
             graph_replays=[c for c in graph_checks if c["kernel"] == "flash_fwd"],
             device_q_offset_cases=q_offset_cases,
             cases=flash_cases, check_cases=flash_checks),
        dict(name="stream_matmul", route="cuda",
             source="src/repro_torch/csrc/weight_stream.cu",
             replaces="src/repro/kernels/weight_stream.py:112",
             launches=launches["stream_matmul"],
             shape=f"bits=2 M={LANES} K={d} N={ff} depth={head_sm['depth']} bf16",
             tolerance=f"rel {STREAM_REL_TOL}",
             **{k: head_sm[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             graph_replays=[c for c in graph_checks if c["kernel"] == "stream_matmul"],
             cases=stream_cases),
        dict(name="mvau", route="cuda",
             source="src/repro_torch/csrc/mvau.cu",
             replaces="src/repro/kernels/mvau.py:57",
             launches=cnn_mvau_launches,
             forwards=cnn_forwards,
             launches_per_forward=cnn_mvau_launches / cnn_forwards,
             shape=f"conv1 bits=1 M={head_mv['m']} K={head_mv['k']} N={head_mv['n']} L=3 f32",
             tolerance=f"int32 levels equal, except where the plain sign*acc lies within "
                       f"{MVAU_TIE_TOL}*(1+|T|) of a threshold",
             library_call="torch.matmul(x, decoded weight) in f32: the matmul part only",
             **{k: head_mv[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
             cnv_forward=mvau_forward,
             cases=mvau_cases, check_cases=mvau_checks),
        dict(name="flash_bwd_dq", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:282",
             launches=launches["flash_bwd_dq"],
             launches_by_route=routes["flash_bwd_dq"],
             shape=f"causal B={TRAIN_BATCH} S={TRAIN_SEQ} Hq={hq} Hkv={hkv} D={hd} bf16",
             tolerance=f"rel {FLASH_BWD_TOL} of max|want| per output (bf16), "
                       f"{FLASH_BWD_TOL_F32} (f32), against the plain version in f32",
             library_call="backward of scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True): dq, dk and dv together",
             **{k: head_dq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "host_us")},
             cases=[head_dq] + [dq for dq, _ in d80_bwd + family_bwd]),
        dict(name="flash_bwd_dkv", route="cuda",
             source="src/repro_torch/csrc/flash_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:306",
             launches=launches["flash_bwd_dkv"],
             launches_by_route=routes["flash_bwd_dkv"],
             shape=f"causal B={TRAIN_BATCH} S={TRAIN_SEQ} Hq={hq} Hkv={hkv} D={hd} bf16",
             tolerance=f"rel {FLASH_BWD_TOL} of max|want| per output (bf16), "
                       f"{FLASH_BWD_TOL_F32} (f32), against the plain version in f32",
             library_call="backward of scaled_dot_product_attention(is_causal=True, "
                          "enable_gqa=True): dq, dk and dv together",
             **{k: head_dkv[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "host_us")},
             cases=[head_dkv] + [dkv for _, dkv in d80_bwd + family_bwd]),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    for path in PHASE_LOG:
        with open(path, "a") as fh:
            fh.write(json.dumps({"kernels": kernels}) + "\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu()


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (so -0.0 is not 0.0)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return bool(torch.equal(a, b))


if __name__ == "__main__":
    sys.exit(main())
