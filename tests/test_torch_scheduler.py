"""Port parity: the port's ``Scheduler`` over its ``KVPool`` against the
reference's on the same weights and submitted trace (every ported arch's
smoke config, and h2o-danube reduced with its head dim of 80), plus the
pool's allocator invariants and the CPU serve entry point."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.runtime.kv_pool import KVPool as JPool  # noqa: E402
from repro.runtime.kv_pool import choose_block_tokens as j_choose  # noqa: E402
from repro.runtime.scheduler import Scheduler as JSched  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.kv_pool import choose_block_tokens as t_choose  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402

SLOTS, MAX_LEN, BLOCK, CHUNK = 3, 40, 4, 12
# mixed prompt lengths; 17 and 21 exceed the prefill chunk and prefill in
# chunks across rounds, the rest in one bucketed step
PROMPT_LENS = (5, 17, 9, 3, 21, 12)
GEN = (6, 4, 8, 5, 3, 7)
COUNTERS = ("completed", "generated_tokens", "prefill_steps", "prefill_tokens",
            "decode_steps", "rounds")
# every ported arch's smoke config, and h2o-danube with head dim 80
CASES = ("smollm_360m", "llama3p2_1b", "h2o_danube_1p8b", "phi3_medium_14b",
         "h2o_danube_1p8b@d80")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=CASES)
def weights(request):
    arch, _, variant = request.param.partition("@")
    if variant == "d80":
        jc = j_reduced(j_full(arch), head_dim=80)
        tc = t_reduced(t_full(arch), head_dim=80)
    else:
        jc, tc = j_smoke(arch), t_smoke(arch)
    jc = dataclasses.replace(jc, w_bits=2)
    tc = dataclasses.replace(tc, w_bits=2)
    jp = jlm.init_params(jc, jax.random.key(3))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


def _trace(cfg):
    """The trace's prompts; under a sliding window each is longer by the
    window, so prefill, chunks and decode all run past it."""
    rng = np.random.default_rng(42)
    return [rng.integers(0, cfg.vocab, size=p + cfg.sliding_window).astype(np.int32)
            for p in PROMPT_LENS]


def _run(sched_cls, pool, cfg, params, sampling):
    sched = sched_cls(
        cfg, params, pool, slots=SLOTS, max_len=MAX_LEN + cfg.sliding_window,
        prefill_chunk=CHUNK, sampling=sampling,
    )
    for prompt, gen in zip(_trace(cfg), GEN):
        sched.submit(prompt, gen)
    stats = sched.run()
    return sched.outputs(), stats


@pytest.mark.parametrize(
    "sampling",
    [dict(), dict(temperature=0.9, top_k=20, seed=7)],
    ids=["greedy", "seeded"],
)
def test_scheduler_token_streams_match_reference(weights, sampling):
    jc, tc, jp, tp = weights
    max_len = MAX_LEN + jc.sliding_window
    j_out, j_stats = _run(
        JSched,
        JPool.for_slots(jc, slots=SLOTS, max_len=max_len, block_tokens=BLOCK),
        jc, jp, jlm.SamplingParams(**sampling),
    )
    t_out, t_stats = _run(
        TSched,
        TPool.for_slots(tc, slots=SLOTS, max_len=max_len, block_tokens=BLOCK,
                        device="cpu"),
        tc, tp, tlm.SamplingParams(**sampling),
    )
    assert t_out == j_out
    assert [len(t_out[r]) for r in sorted(t_out)] == list(GEN)
    for name in COUNTERS:
        assert getattr(t_stats, name) == getattr(j_stats, name), name
    assert t_stats.prefill_steps > len(PROMPT_LENS)  # chunked prefill ran
    assert t_stats.steady_state_utilization == pytest.approx(
        j_stats.steady_state_utilization
    )


def test_kv_pool_lifecycle_and_invariants():
    cfg = t_smoke("smollm_360m")
    pool = TPool.for_slots(cfg, slots=2, max_len=10, block_tokens=4, device="cpu")
    assert pool.usable_blocks == 6 and pool.blocks_for(9) == 3
    assert tuple(pool.k.shape) == (cfg.n_layers, 28, cfg.n_kv, cfg.hd)
    pool.admit(0, 10)
    pool.admit(1, 9)
    assert not pool.can_admit(1)
    ks = torch.randn((cfg.n_layers, 8, cfg.n_kv, cfg.hd))
    pool.write_prefill(0, ks, ks + 1, n_tokens=6)  # bucket 8, 2 padded rows
    rows = pool.rows_of(0)
    assert torch.equal(pool.k[:, torch.from_numpy(rows[:6]).long()], ks[:, :6])
    assert pool.rows_of(0, pad_to=12)[8:].tolist() == [0, 0, 0, 0]
    pool.note_tokens(1, 9)
    st = pool.stats()
    assert (st.held_blocks, st.held_tokens, st.committed_blocks) == (5, 15, 1)
    pool.validate()
    with pytest.raises(RuntimeError):
        pool.note_tokens(1, 13)  # beyond its 3-block commitment
    pool.release(0)
    pool.release(1)
    with pytest.raises(ValueError):
        pool.release(1)
    pool.validate()
    assert pool.free_blocks == 6 and pool.alloc_blocks == pool.freed_blocks == 5


def test_choose_block_tokens_matches_reference():
    for lengths in ([32] * 4, [5, 60, 130], [576] * 16, []):
        assert t_choose(lengths) == j_choose(lengths)


def test_serve_cli_runs_on_cpu(capsys):
    rc = serve.main([
        "--smoke", "--device", "cpu", "--quant", "2", "--requests", "4",
        "--batch", "2", "--prompt-len", "14", "--gen-len", "5",
        "--max-len", "24", "--prefill-chunk", "8",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[serve/pool] 4 requests, 20 generated tokens" in out
    assert "[serve/kernels] packed_matmul 0 launches, flash_fwd 0 launches" in out


def _serve_lines(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_serve_cli_prefix_cache_is_on_by_default(capsys):
    """``serve`` attaches the prefix cache unless ``--no-prefix-cache``, as
    the reference's does, and prints the reference's ``[serve/prefix]``
    line; its random prompts get no hits, so the two runs give the same
    tokens. The line equals the reference's on the same trace (nothing in
    it depends on the weights: no prompt shares a block)."""
    from repro.launch import serve as j_serve

    argv = ["--smoke", "--quant", "2", "--requests", "6", "--batch", "2",
            "--prompt-len", "14", "--gen-len", "5", "--max-len", "24",
            "--prefill-chunk", "8"]
    assert serve.build_parser().parse_args([]).prefix_cache is True
    runs = {}
    for flag in ([], ["--no-prefix-cache"]):
        lines = _serve_lines(serve.main, argv + flag + ["--device", "cpu"], capsys)
        m = json.loads(next(l for l in lines if l.startswith("[serve/metrics] "))
                       .split(" ", 1)[1])
        runs[bool(flag)] = (lines, m)
    (lines, m), (off_lines, off) = runs[False], runs[True]
    for key in ("prefix_cache", "prefix_hits", "prefix_hit_tokens", "prefix_hit_rate",
                "shared_blocks_peak"):
        assert key in m and key in off
    assert (m["prefix_cache"], off["prefix_cache"]) == (True, False)
    assert m["cached_blocks"] > 0 and off["cached_blocks"] == 0
    assert m["prefix_hits"] == off["prefix_hits"] == 0
    assert m["outputs"] == off["outputs"]
    prefix = [l for l in lines if l.startswith("[serve/prefix]")]
    assert len(prefix) == 1 and not any(l.startswith("[serve/prefix]") for l in off_lines)
    j_lines = _serve_lines(j_serve.main, argv, capsys)
    assert prefix == [l for l in j_lines if l.startswith("[serve/prefix]")]


def test_entry_points_do_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg = t_smoke("smollm_360m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPool.for_slots(cfg, slots=1, max_len=8, block_tokens=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_serve_cli_rejects_unported_arch(capsys):
    """``whisper_tiny`` prints the reference's line and exits 0, as the
    reference's serve does; an unknown arch exits 2, naming the archs."""
    assert serve.main(["--arch", "whisper_tiny", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == (
        "[serve] encdec serving is exercised in tests; use an LM arch\n")
    assert serve.main(["--arch", "no-such-arch", "--device", "cpu"]) == 2
    assert ("ported archs: h2o_danube_1p8b, llama3p2_1b, phi3_medium_14b, smollm_360m, "
            "internvl2_76b, whisper_tiny, olmoe_1b_7b, moonshot_v1_16b_a3b, zamba2_2p7b, "
            "mamba2_1p3b" in capsys.readouterr().out)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-1.8b", "phi3-medium-14b"])
def test_serve_cli_serves_the_other_dense_archs(arch, capsys):
    """``serve --arch`` takes each new arch by its assignment id and serves
    its smoke config on the CPU (h2o-danube's past its 64-token window),
    dense and packed."""
    for quant in ("0", "2"):
        lines = _serve_lines(serve.main, [
            "--arch", arch, "--smoke", "--device", "cpu", "--quant", quant, "--requests", "3",
            "--batch", "2", "--prompt-len", "70", "--gen-len", "4", "--max-len", "80",
            "--prefill-chunk", "32"], capsys)
        m = json.loads(next(l for l in lines if l.startswith("[serve/metrics] "))
                       .split(" ", 1)[1])
        assert (m["completed"], m["generated_tokens"]) == (3, 12)
        assert m["init_s"] >= 0 and m["prefix_cache"]
