"""Compiled steps on the CPU: what of them the CPU can check. The captured
CUDA graphs themselves run only on the card (``chip_smoke.py`` holds their
replays against the eager steps bit for bit); here: the device last index
of ``prefill_chunk_paged`` against its int form and the reference, the
launch-count bookkeeping that a replay adds, and that compiled steps are
refused where there are no graphs."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.runtime.kv_pool import KVPool as TPool  # noqa: E402
from repro_torch.runtime.scheduler import Scheduler as TSched  # noqa: E402
from repro_torch.runtime.steps import CapturedStep  # noqa: E402

# the reference's prefill parity tolerance (tests/test_torch_lm.py)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_launch_counts()
    yield
    ops.reset_launch_counts()


def _weights(w_bits):
    jc = dataclasses.replace(j_smoke("smollm_360m"), w_bits=w_bits)
    tc = dataclasses.replace(t_smoke("smollm_360m"), w_bits=w_bits)
    jp = jlm.init_params(jc, jax.random.key(5))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("w_bits", [0, 2])
@pytest.mark.parametrize("n", [1, 5, 8])
def test_chunk_prefill_device_last_index_matches_int_and_reference(w_bits, n):
    """One chunk of width 8 at start 6 whose prompt ends at in-chunk index
    n - 1: the tensor last index, the int form and the reference agree."""
    jc, tc, jp, tp = _weights(w_bits)
    rng = np.random.default_rng(10 + n)
    shape = (jc.n_layers, 32, jc.n_kv, jc.hd)
    pk = rng.normal(size=shape).astype(np.float32)
    pv = rng.normal(size=shape).astype(np.float32)
    c, start = 8, 6
    row_table = np.zeros((1, 16), np.int32)
    row_table[0, :14] = np.arange(4, 18)
    write_rows = np.zeros((1, c), np.int32)
    write_rows[0, :n] = row_table[0, start : start + n]
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :n] = rng.integers(0, jc.vocab, n)
    want, _, _ = jlm.prefill_chunk_paged(
        jp, jc, jnp.asarray(tokens), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(row_table), jnp.asarray(write_rows),
        jnp.asarray(start, jnp.int32), jnp.asarray(n - 1, jnp.int32),
    )

    def run(last):
        t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
        k, v = t(pk.copy()), t(pv.copy())
        lg, k2, v2 = tlm.prefill_chunk_paged(
            tp, tc, t(tokens), k, v, t(row_table), t(write_rows), start, last
        )
        assert k2 is k and v2 is v  # the pool is updated in place
        return lg, k, v

    lg_int, k_int, v_int = run(n - 1)
    lg_dev, k_dev, v_dev = run(torch.tensor([n - 1]))
    assert lg_dev.shape == (1, 1, lg_int.shape[-1])
    assert torch.equal(lg_dev, lg_int)
    assert torch.equal(k_dev, k_int) and torch.equal(v_dev, v_int)
    np.testing.assert_allclose(lg_dev.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    # a 0-d index selects the same row
    lg_0d, _, _ = run(torch.tensor(n - 1))
    assert torch.equal(lg_0d, lg_int)


def _sched(compiled, **kw):
    tc = t_smoke("smollm_360m")
    params = tlm.init_params(tc, 0, device="cpu")
    pool = TPool.for_slots(tc, slots=2, max_len=24, block_tokens=4, device="cpu")
    return TSched(tc, params, pool, slots=2, max_len=24, compiled=compiled, **kw)


def test_compiled_steps_on_a_cpu_pool_raise():
    with pytest.raises(ValueError, match="CUDA graphs"):
        _sched(True)


@pytest.mark.parametrize("compiled", [None, False])
def test_cpu_pool_runs_eagerly(compiled):
    sched = _sched(compiled, prefill_chunk=8)
    assert sched.compiled is False and sched._graph_pool is None
    rng = np.random.default_rng(0)
    for p in (5, 13):  # one whole-prompt prefill, one in two chunks
        sched.submit(rng.integers(0, 100, p).astype(np.int32), 4)
    stats = sched.run()
    assert stats.completed == 2 and stats.prefill_steps == 3
    assert sched._decode_graph is None and sched._chunk_graph is None
    assert sched._prefill_graphs == {} and sched.graphs == []


def test_captured_step_needs_a_cuda_device():
    with pytest.raises(ValueError, match="CUDA graph"):
        CapturedStep(lambda x: x, device="cpu", mempool=None)


def test_serve_engine_takes_compiled_only_as_a_keyword():
    """``compiled`` is the scheduler's keyword, reached through
    ``build_pool_engine``; the CLI has no flag for it."""
    args = serve.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--requests", "2"]
    )
    assert not hasattr(args, "compiled")
    tc = t_smoke("smollm_360m")
    params = tlm.init_params(tc, 0, device="cpu")
    with pytest.raises(ValueError, match="CUDA graphs"):
        serve.build_pool_engine(tc, params, args, torch.device("cpu"), compiled=True)
    assert serve.build_pool_engine(
        tc, params, args, torch.device("cpu")).compiled is False


def test_capture_records_launches_and_each_replay_counts_them():
    """What a capture meets is recorded, not counted; every replay counts
    it once, by route, as the eager launches would have."""
    a, b = _build.LaunchCounter(), _build.LaunchCounter()
    a.add("gemv")  # an eager launch counts at once
    with _build.recording_launches() as rec:
        a.add("gemv")
        a.add("mma")
        b.add()
        b.add()
    assert (a.count, a.routes, b.count, b.routes) == (1, {"gemv": 1}, 0, {})
    assert [(c is a, r) for c, r in rec.launches] == [
        (True, "gemv"), (True, "mma"), (False, None), (False, None)
    ]
    for i in range(1, 4):
        rec.replay()
        assert a.count == 1 + 2 * i and b.count == 2 * i
        assert a.routes == {"gemv": 1 + i, "mma": i} and b.routes == {}
    a.add("mma")  # counting resumes once the recording ends
    assert a.routes == {"gemv": 4, "mma": 4}


def test_recording_does_not_nest_and_always_ends():
    with _build.recording_launches():
        with pytest.raises(RuntimeError, match="nest"):
            with _build.recording_launches():
                pass
    with pytest.raises(KeyError):
        with _build.recording_launches():
            raise KeyError("a capture that fails")
    c = _build.LaunchCounter()
    c.add("x")
    assert c.count == 1  # the failed recording left counting on


def test_replayed_counts_reach_the_public_counters():
    """The wrappers' own counters: a recorded launch of each, replayed
    twice, reads as two launches a wrapper in ``ops.launch_counts`` and
    ``ops.launch_routes``."""
    from repro_torch.kernels import flash_attention, packed_matmul, weight_stream

    with _build.recording_launches() as rec:
        packed_matmul.COUNTER.add("gemv")
        flash_attention.COUNTER.add("mma")
        weight_stream.COUNTER.add()
    assert not any(ops.launch_counts().values())
    rec.replay()
    rec.replay()
    counts = ops.launch_counts()
    assert counts["packed_matmul"] == counts["flash_fwd"] == counts["stream_matmul"] == 2
    assert ops.launch_routes() == {"packed_matmul": {"gemv": 2}, "flash_fwd": {"mma": 2}}
