"""What moves data between four ranks: the train CLI on ``fit_mesh``'s (1, 4)
mesh, ``runtime/pipeline.pipeline_forward`` and
``optim/compression.int8_allreduce``, on a real 4-rank ``gloo`` group,
against the reference on 4 forced host devices; and the compression
module's quantizers and top-k error feedback against the reference's,
ties included.

One shared group of four rank processes (``file://`` store, loopback
only) and one reference child (``XLA_FLAGS`` forcing 4 host devices, as
``tests/test_distributed.py`` runs its checks) run together; the cases read
their results. The pipeline and the all-reduce take the numpy inputs of
the reference's ``test_pipeline_parallel_forward`` and
``test_int8_allreduce_multidevice`` (the latter's rows over 4 devices).

Run as a script, the file is one rank of the shared group:
``python tests/test_torch_mesh_collectives.py RANK INIT_FILE WORKDIR``.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"dense": "smollm_360m", "moe": "olmoe_1b_7b"}
STEPS = 3
ARGV = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--lr", "3e-2",
        "--steps", str(STEPS)]
MESH_RTOL = 1e-6  # as tests/test_torch_mesh_train.py: shard sums in another order
REF_RTOL = 1e-5  # test_torch_train's three-step tolerance
# f32 products of 8 terms through 4 stages on both sides, in other orders
PIPELINE_ATOL = 1e-6


def _pipeline_inputs():
    """``test_pipeline_parallel_forward``'s: 4 stages of (1, 8, 8), 6
    microbatches of (2, 8)."""
    rng = np.random.default_rng(0)
    ws = (rng.normal(size=(4, 1, 8, 8)) * 0.3).astype(np.float32)
    xs = rng.normal(size=(6, 2, 8)).astype(np.float32)
    return ws, xs


def _allreduce_input():
    """``test_int8_allreduce_multidevice``'s values, one row a rank."""
    return (np.arange(32, dtype=np.float32).reshape(WORLD, 8) / 32.0).astype(np.float32)


def _cli(argv) -> tuple[int, str]:
    from repro_torch.launch import train as ttrain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ttrain.main(argv)
    return rc, buf.getvalue()


def _metrics(text: str) -> dict:
    return json.loads(next(line for line in text.splitlines()
                           if line.startswith("[train/metrics] ")).split(" ", 1)[1])


def _rank_main(rank: int, init_file: str, work: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.optim.compression import int8_allreduce
    from repro_torch.runtime.pipeline import pipeline_forward

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    out = {tag: _cli(ARGV + ["--arch", arch]) for tag, arch in ARCHS.items()}
    stages = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
    ws, xs = (torch.from_numpy(a) for a in _pipeline_inputs())
    for form, params in (("dtensor", distribute_tensor(ws, stages, [Shard(0)])),
                         ("whole", ws)):
        out[f"pipeline_{form}"] = pipeline_forward(
            lambda w, x: x @ w[0], params, xs, mesh=stages, axis="stage").tolist()
    data = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    g = torch.from_numpy(_allreduce_input()[rank])
    out["int8_group"] = int8_allreduce(g, dist.group.WORLD).tolist()
    out["int8_mesh_axis"] = int8_allreduce(g, (data, "data")).tolist()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


REF_CHILD = """
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.ckpt import CheckpointManager
    from repro.compat import shard_map
    from repro.configs import get_smoke_config
    from repro.data.pipeline import TokenPipeline
    from repro.models import lm
    from repro.optim.adamw import AdamW
    from repro.optim.compression import int8_allreduce
    from repro.runtime.pipeline import pipeline_forward
    from repro.runtime.steps import make_train_step
    work, archs, steps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
    inputs = np.load(f"{work}/inputs.npz")
    out = {}
    mesh = jax.make_mesh((4,), ("stage",))
    out["pipeline"] = np.asarray(pipeline_forward(
        lambda w, x: x @ w[0], jnp.asarray(inputs["ws"]), jnp.asarray(inputs["xs"]),
        mesh=mesh, axis="stage")).tolist()
    data = jax.make_mesh((4,), ("data",))
    f = shard_map(lambda x: int8_allreduce(x[0], "data"), mesh=data, in_specs=P("data"),
                  out_specs=P())
    out["int8"] = np.asarray(f(jnp.asarray(inputs["g"]))).tolist()
    for tag, arch in archs.items():
        cfg = get_smoke_config(arch)
        opt = AdamW(lr=3e-2)
        params = lm.init_params(cfg, jax.random.key(0))
        (params, state), _ = CheckpointManager(f"{work}/ref_{tag}").restore(
            (params, opt.init(params)))
        params, state = jax.tree.map(jnp.asarray, (params, state))
        step = jax.jit(make_train_step(cfg, opt, remat="none"))
        pipe = TokenPipeline(vocab=cfg.vocab, batch=4, seq_len=32, seed=0)
        losses = []
        for i in range(steps):
            params, state, m = step(params, state, jax.tree.map(jnp.asarray, pipe.batch_at(i)))
            losses.append(float(m["loss"]))
        out[tag] = losses
    print("REF " + json.dumps(out))
"""


def _child_env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}")
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The plain runs and the reference's inputs made here, then the four
    ranks and the reference child together."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    work = str(tmp_path_factory.mktemp("mesh_collectives"))
    ws, xs = _pipeline_inputs()
    np.savez(os.path.join(work, "inputs.npz"), ws=ws, xs=xs, g=_allreduce_input())
    res = {"plain": {}}
    for tag, arch in ARCHS.items():
        rc, text = _cli(ARGV + ["--arch", arch])
        assert rc == 0, text
        res["plain"][tag] = _metrics(text)
        params = lm.init_params(get_smoke_config(arch), 0, device="cpu", trainable=True)
        CheckpointManager(os.path.join(work, f"ref_{tag}")).save(
            0, (params, AdamW(lr=3e-2).init(params)), extra={"data_step": 0})
    init_file = os.path.join(work, "init")
    procs = {f"rank{r}": subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), init_file, work], env=_child_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(WORLD)}
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_CHILD), work, json.dumps(ARCHS), str(STEPS)],
        env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for name, proc in procs.items():
            outs[name] = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name}: {outs[name][1][-3000:]}"
    finally:
        for proc in procs.values():
            proc.kill()
    res["ranks"] = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(WORLD)]
    res["reference"] = json.loads(next(line for line in outs["reference"][0].splitlines()
                                       if line.startswith("REF ")).split(" ", 1)[1])
    return res


@pytest.mark.parametrize("tag", list(ARCHS))
def test_cli_on_four_ranks_matches_the_plain_run(runs, tag):
    """fit_mesh's (1, 4) mesh: the plain run's losses within MESH_RTOL;
    ranks 1-3 print nothing."""
    rc, text = runs["ranks"][0][tag]
    m = _metrics(text)
    assert rc == 0 and m["mesh"] == {"shape": [1, 4], "axes": ["data", "model"]}
    assert m["world_size"] == WORLD
    np.testing.assert_allclose(m["losses"], runs["plain"][tag]["losses"], rtol=MESH_RTOL, atol=0)
    assert all(r[tag] == [0, ""] for r in runs["ranks"][1:])


@pytest.mark.parametrize("tag", list(ARCHS))
def test_cli_on_four_ranks_matches_the_reference_train_step(runs, tag):
    """The same losses against the reference's jitted single-device step
    on the same weights and batches, within REF_RTOL."""
    np.testing.assert_allclose(_metrics(runs["ranks"][0][tag][1])["losses"],
                               runs["reference"][tag], rtol=REF_RTOL, atol=0)


@pytest.mark.parametrize("form", ["dtensor", "whole"])
def test_pipeline_forward_matches_the_reference(runs, form):
    """GPipe over 4 stages, 6 microbatches: every rank holds the
    reference's output (its 4 forced devices) within PIPELINE_ATOL, with
    the stage parameters as a Shard(0) DTensor or whole; and both hold the
    sequential product."""
    want = np.asarray(runs["reference"]["pipeline"], np.float32)
    ws, xs = _pipeline_inputs()
    seq = xs
    for s in range(4):
        seq = np.einsum("mbi,ij->mbj", seq, ws[s, 0])
    np.testing.assert_allclose(want, seq, rtol=0, atol=1e-5)
    for r in runs["ranks"]:
        np.testing.assert_allclose(np.asarray(r[f"pipeline_{form}"], np.float32), want, rtol=0,
                                   atol=PIPELINE_ATOL)


@pytest.mark.parametrize("group", ["int8_group", "int8_mesh_axis"])
def test_int8_allreduce_matches_the_reference(runs, group):
    """The int8 all-reduce over 4 ranks (the group, or a mesh axis): every
    rank holds the reference's result bitwise (one agreed scale, int32
    sums of the same codes, the same f32 division), within 1e-2 of the
    mean as the reference's test asks."""
    want = np.asarray(runs["reference"]["int8"], np.float32)
    for r in runs["ranks"]:
        np.testing.assert_array_equal(np.asarray(r[group], np.float32), want)
    assert np.abs(want - _allreduce_input().mean(axis=0)).max() < 1e-2


# ---------------- the quantizers and top-k, one process ----------------


def _j():
    from repro.optim import compression as jc

    return jc


def _t():
    from repro_torch.optim import compression as tc

    return tc


QUANT_CASES = {
    # max 127 makes the scale 1: the codes are round(g), halves to even
    "halves": np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, -126.5], np.float32),
    "random": np.random.default_rng(1).normal(size=(6, 7)).astype(np.float32),
    "zeros": np.zeros((4,), np.float32),  # the 1e-12 scale floor
}


@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_int8_quantize_and_dequantize_match_the_reference(case):
    """Codes, scale and dequantized values bitwise the reference's."""
    import jax.numpy as jnp

    g = QUANT_CASES[case]
    jq, js = _j().int8_quantize(jnp.asarray(g))
    tq, ts = _t().int8_quantize(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_t().int8_dequantize(tq, ts).numpy(),
                                  np.asarray(_j().int8_dequantize(jq, js)))


TOPK_CASES = {
    # |g| ties at 3 (indices 1, 2, 4, 6) and at 2 (3, 7): the lower index first
    "ties": (np.array([1.0, -3.0, 3.0, 2.0, -3.0, 0.5, 3.0, -2.0], np.float32), 5),
    "random": (np.random.default_rng(2).normal(size=(5, 6)).astype(np.float32), 7),
}


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_compress_and_decompress_match_the_reference(case):
    """Values and indices the reference's, in its order (ties by the lower
    index), and the decompressed tensor bitwise."""
    import jax.numpy as jnp

    g, k = TOPK_CASES[case]
    jv, ji = _j().compress_topk(jnp.asarray(g), k)
    tv, ti = _t().compress_topk(torch.from_numpy(g), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_t().decompress_topk(tv, ti, g.shape).numpy(),
                                  np.asarray(_j().decompress_topk(jv, ji, g.shape)))


@pytest.mark.parametrize("case", list(TOPK_CASES))
def test_topk_error_feedback_matches_the_reference(case):
    """Three error-feedback steps carrying the error buffer on each side:
    what is sent, what is transmitted and the new error, bitwise (the tie
    case makes the choice of indices matter)."""
    import jax.numpy as jnp

    g, k = TOPK_CASES[case]
    jerr, terr = jnp.zeros(g.shape, jnp.float32), torch.zeros(g.shape)
    for step in range(3):
        gs = g * (1 + step)
        (jv, ji), jt, jerr = _j().topk_error_feedback_update(jnp.asarray(gs), jerr, k)
        (tv, ti), tt, terr = _t().topk_error_feedback_update(torch.from_numpy(gs), terr, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_the_port_exports_the_reference_s_compression_names():
    """``optim/__init__.py`` exports what the reference's does."""
    import repro.optim as jopt
    import repro_torch.optim as topt

    for name in ("compress_topk", "decompress_topk", "int8_allreduce",
                 "topk_error_feedback_update"):
        assert hasattr(jopt, name) and hasattr(topt, name)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
