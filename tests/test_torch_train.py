"""Port parity for training: the losses, ``loss_fn`` and its gradients, AdamW,
the train step, the data pipelines, checkpoints in both directions, the
train loop and the train CLI, against the reference on the CPU (smollm_360m
SMOKE, float32 unless a test says otherwise; ``loss_fn`` and its gradients
also at every other ported arch's smoke config and at h2o-danube reduced
with its head dim of 80), with the reference's weights carried over by
``interop`` and inputs made with numpy."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.config import reduced as j_reduced  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.runtime.steps import make_loss_fn as j_loss_fn  # noqa: E402
from repro.runtime.steps import make_train_step as j_train_step  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.interop import (  # noqa: E402
    params_from_checkpoint,
    params_from_reference,
    params_to_reference,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import reduced as t_reduced  # noqa: E402
from repro_torch.optim.adamw import AdamW, OptState  # noqa: E402
from repro_torch.runtime.steps import make_loss_fn, make_train_step  # noqa: E402
from repro_torch.runtime.train import TrainLoop, TrainLoopConfig  # noqa: E402

B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(dtype="float32", case="smollm_360m"):
    arch, _, variant = case.partition("@")
    if variant == "d80":  # h2o-danube's head dim of 80, reduced
        jc, tc = j_reduced(j_full(arch), head_dim=80), t_reduced(t_full(arch), head_dim=80)
    else:
        jc, tc = j_smoke(arch), t_smoke(arch)
    return dataclasses.replace(jc, dtype=dtype), dataclasses.replace(tc, dtype=dtype)


def _weights(seed=0, dtype="float32", case="smollm_360m"):
    jc, tc = _configs(dtype, case)
    tree = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(seed)))
    return jc, tc, tree, params_from_reference(tree, tc, "cpu", trainable=True)


def _batch(vocab, step=0, b=B, s=S):
    return jpipe.TokenPipeline(vocab=vocab, batch=b, seq_len=s, seed=1).batch_at(step)


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    """{'embed': ..., 'layers/wq': ...} of a nested dict."""
    return {
        "/".join(str(p.key) for p in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    lg = rng.normal(size=(2, 8, 96)).astype(np.float32) * 3
    lg[..., 90:] = -1e30  # padded vocab columns, as ``logits`` masks them
    labels = rng.integers(0, 90, size=(2, 8)).astype(np.int32)
    want = jlayers.cross_entropy(jnp.asarray(lg), jnp.asarray(labels), 90)
    got = tlayers.cross_entropy(torch.from_numpy(lg), torch.from_numpy(labels), 90)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("chunk", [8, 5, 512], ids=["chunked", "fallback", "one_chunk"])
def test_chunked_softmax_xent_matches_reference(chunk):
    """Value and gradients (x and the table) of the fused unembed + CE; a
    chunk that does not divide S falls back to one chunk, as in the
    reference. f32, 1e-5: sums over 96 logits and 32 positions."""
    rng = np.random.default_rng(chunk)
    x = rng.normal(size=(2, 32, 16)).astype(np.float32)
    table = rng.normal(size=(96, 16)).astype(np.float32)
    labels = rng.integers(0, 90, size=(2, 32)).astype(np.int32)

    def f(x, t):
        return jlayers.chunked_softmax_xent(x, t, jnp.asarray(labels), 90, chunk=chunk)

    want, (wdx, wdt) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt, tt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(table).requires_grad_()
    got = tlayers.chunked_softmax_xent(xt, tt, torch.from_numpy(labels), 90, chunk=chunk)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wdx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(wdt), rtol=1e-5, atol=1e-6)
    # the unchunked loss on the same inputs
    lg = tlayers.logits(torch.from_numpy(x), torch.from_numpy(table), 90)
    full = tlayers.cross_entropy(lg, torch.from_numpy(labels), 90)
    np.testing.assert_allclose(got.item(), full.item(), rtol=1e-5)


# --------------------------------------------------------------------------
# loss_fn and its gradients
# --------------------------------------------------------------------------

# f32 on both sides: the loss to 1e-5, each gradient leaf to 1e-4 of its
# own largest element (sums of up to S * d products in other orders)
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@pytest.mark.parametrize(
    "case,remat,ce_chunk",
    [("smollm_360m", "none", 0), ("smollm_360m", "full", 0), ("smollm_360m", "dots", 0),
     ("smollm_360m", "none", 8), ("smollm_360m", "full", 8)]
    + [(case, "none", 0) for case in ("llama3p2_1b", "h2o_danube_1p8b", "phi3_medium_14b",
                                      "h2o_danube_1p8b@d80")],
    ids=["none", "full", "dots", "none_chunked", "full_chunked", "llama3p2_1b",
         "h2o_danube_1p8b", "phi3_medium_14b", "h2o_danube_1p8b_d80"],
)
def test_loss_and_every_gradient_match_reference(case, remat, ce_chunk):
    """Under a sliding window the sequence is longer by the window, so the
    mask binds."""
    jc, tc, tree, params = _weights(case=case)
    batch = _batch(jc.vocab, s=S + jc.sliding_window)
    want, wgrads = jax.value_and_grad(j_loss_fn(jc, remat=remat, ce_chunk=ce_chunk))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    got = make_loss_fn(tc, remat=remat, ce_chunk=ce_chunk)(params, _tbatch(batch))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    tflat = _flat(params.tree())
    names = list(tflat)
    grads = torch.autograd.grad(got, [tflat[n] for n in names])
    wflat = _flat(wgrads)
    assert sorted(names) == sorted(wflat)
    for name, g in zip(names, grads):
        w = np.asarray(wflat[name])
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


def test_loss_fn_counts_kernels_and_rejects_unknown_remat():
    """On the CPU the wrappers run the plain versions, so no launch is
    counted; an unknown remat mode raises."""
    _, tc, _, params = _weights()
    ops.reset_launch_counts()
    loss, (ce, aux) = tlm.loss_fn(params, tc, *_tbatch(_batch(tc.vocab)).values())
    loss.backward()
    assert not any(ops.launch_counts().values())
    assert aux.item() == 0.0 and loss.item() == ce.item()
    with pytest.raises(ValueError, match="remat"):
        tlm.trunk(params, tc, torch.zeros((1, 4), dtype=torch.long), remat="some")


def test_trainable_switch_leaves_serving_frozen():
    _, tc, tree, _ = _weights()
    served = params_from_reference(tree, tc, "cpu")
    assert not any(p.requires_grad for p in served.parameters())
    assert not any(p.requires_grad for p in tlm.init_params(tc, 0, device="cpu").parameters())
    trained = tlm.init_params(tc, 0, device="cpu", trainable=True)
    assert all(p.requires_grad for p in trained.parameters())
    packed = tlm.init_params(dataclasses.replace(tc, w_bits=2), 0, device="cpu", trainable=True)
    assert not any(b.requires_grad for b in packed.buffers())


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def _toy_tree(rng):
    return {
        "w": rng.normal(size=(6, 5)).astype(np.float32),
        "layers": {
            "ln": (1.0 + 0.1 * rng.normal(size=(3, 5))).astype(np.float32),  # (L, d) norm gain
            "packed": rng.integers(0, 255, size=(4, 5)).astype(np.uint8),
        },
        "norm": (1.0 + 0.1 * rng.normal(size=(5,))).astype(np.float32),  # (d,)
    }


def test_adamw_updates_match_reference():
    """Two updates on identical gradients with clipping active (global
    norm ~30 > 1): parameters, moments and step equal the reference's to
    f32 rounding (1e-6); the stacked (L, d) gain decays and the (d,) one
    does not, as in the reference; the uint8 leaf stays frozen with
    scalar moments."""
    rng = np.random.default_rng(0)
    tree = _toy_tree(rng)
    grads = [jax.tree.map(lambda a: (rng.normal(size=a.shape) * 5).astype(np.float32), tree)
             for _ in range(2)]
    for g in grads:  # a packed carrier's tangent is float0 in the reference
        g["layers"]["packed"] = np.zeros((4, 5), dtype=jax.dtypes.float0)
    jopt, topt = JAdamW(lr=1e-2, warmup_steps=3), AdamW(lr=1e-2, warmup_steps=3)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    ts = topt.init(tp)
    assert ts.mu["layers"]["packed"].shape == () and ts.nu["w"].shape == (6, 5)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = {"w": torch.from_numpy(g["w"]), "norm": torch.from_numpy(g["norm"]),
              "layers": {"ln": torch.from_numpy(g["layers"]["ln"]), "packed": None}}
        tp, ts = topt.update(tg, ts, tp)
    assert int(ts.step) == int(js.step) == 2
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for name, w in _flat(want).items():
            np.testing.assert_allclose(_flat(got)[name].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tp["layers"]["packed"].numpy(), tree["layers"]["packed"])


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

LR = 1e-2


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` steps against the reference's jitted step
    on the same weights and batches (lr 1e-2, warm-up 1). The losses agree
    to 1e-5. A parameter may differ by at most 2 * lr per step: Adam's
    m / (sqrt(v) + eps) swings between -1 and +1 on a gradient near zero
    (near eps), which f32 summation order moves; all but 1% of the
    elements agree to 1e-5 (0.11% do not, at most, on these inputs)."""
    jc, tc, tree, params = _weights()
    jopt, topt = JAdamW(lr=LR, warmup_steps=1), AdamW(lr=LR, warmup_steps=1)
    jstep = jax.jit(j_train_step(jc, jopt, remat="none"))
    tstep = make_train_step(tc, topt, remat="none")
    jp = jax.tree.map(jnp.asarray, tree)
    js, ts = jopt.init(jp), topt.init(params)
    for step in range(3):
        batch = _batch(jc.vocab, step)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        params, ts, tm = tstep(params, ts, _tbatch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    tflat = _flat(params.tree())
    for name, w in _flat(jp).items():
        diff = np.abs(tflat[name].detach().numpy() - np.asarray(w))
        assert diff.max() <= 2 * LR * 3, (name, diff.max())
        assert (diff > 1e-5).mean() <= 1e-2, (name, (diff > 1e-5).mean())


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 7])
def test_pipelines_match_reference_bit_for_bit(step):
    for jp_, tp_ in (
        (jpipe.TokenPipeline(vocab=500, batch=3, seq_len=20, seed=4),
         tpipe.TokenPipeline(vocab=500, batch=3, seq_len=20, seed=4)),
        (jpipe.CifarPipeline(batch=3, seed=4), tpipe.CifarPipeline(batch=3, seed=4)),
    ):
        want, got = jp_.batch_at(step), tp_.batch_at(step)
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype and want[k].tobytes() == got[k].tobytes()
    p = tpipe.TokenPipeline(vocab=50, batch=1, seq_len=4)
    first = next(p)
    assert p.state.step == 1 and first["tokens"].shape == (1, 4)
    assert tpipe.PipelineState.from_dict(p.state.to_dict()) == p.state


# --------------------------------------------------------------------------
# checkpoints, both ways
# --------------------------------------------------------------------------


def _ref_trained(dtype, steps=1):
    """Reference (params, opt_state) after ``steps`` train steps, so the
    moments are not zero."""
    jc, tc = _configs(dtype)
    jopt = JAdamW(lr=LR, warmup_steps=1)
    jp = jlm.init_params(jc, jax.random.key(3))
    js = jopt.init(jp)
    step = jax.jit(j_train_step(jc, jopt, remat="none"))
    for i in range(steps):
        jp, js, _ = step(jp, js, jax.tree.map(jnp.asarray, _batch(jc.vocab, i)))
    return jc, tc, jp, js


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_reads_a_reference_checkpoint_and_continues(tmp_path, dtype):
    """The reference saves (params, opt_state); the port restores it into
    fresh modules byte for byte (bf16 leaves through their bits), reads
    the parameters alone with ``params_from_checkpoint``, and trains on."""
    jc, tc, jp, js = _ref_trained(dtype)
    JCkpt(str(tmp_path)).save(1, (jp, js), extra={"data_step": 1})
    params = tlm.init_params(tc, 9, device="cpu", trainable=True)
    opt = AdamW(lr=LR, warmup_steps=1)
    (params, state), extra = CheckpointManager(str(tmp_path)).restore((params, opt.init(params)))
    assert extra == {"data_step": 1} and int(state.step) == 1
    want = _flat({"p": jp, "mu": js.mu, "nu": js.nu})
    got = _flat({"p": params.tree(), "mu": state.mu, "nu": state.nu})
    assert sorted(got) == sorted(want)
    for name in want:
        assert _bytes(got[name]) == _bytes(want[name]), name
    alone = params_from_checkpoint(str(tmp_path), tc, "cpu")
    for name, t in _flat(alone.tree()).items():
        assert _bytes(t) == _bytes(want["p/" + name]), name
    _, state, m = make_train_step(tc, opt, remat="none")(params, state, _tbatch(_batch(tc.vocab, 1)))
    assert np.isfinite(m["loss"].item()) and int(state.step) == 2


def test_reference_restores_a_port_checkpoint_byte_equal(tmp_path):
    """The port trains a step and saves; the reference's manager restores
    (params, opt_state) into its own template byte for byte."""
    jc, tc, tree, params = _weights()
    opt = AdamW(lr=LR, warmup_steps=1)
    state = opt.init(params)
    params, state, _ = make_train_step(tc, opt, remat="none")(params, state, _tbatch(_batch(tc.vocab)))
    CheckpointManager(str(tmp_path)).save(1, (params, state), extra={"data_step": 1})
    jp = jax.tree.map(jnp.asarray, tree)
    (rp, rs), extra = JCkpt(str(tmp_path)).restore((jp, JAdamW().init(jp)))
    assert extra == {"data_step": 1} and int(rs.step) == 1
    want = _flat({"p": params.tree(), "mu": state.mu, "nu": state.nu})
    got = _flat({"p": rp, "mu": rs.mu, "nu": rs.nu})
    assert sorted(got) == sorted(want)
    for name in want:
        assert _bytes(got[name]) == _bytes(want[name]), name


def test_port_writes_the_reference_files_bf16_included(tmp_path):
    """The same (params, opt_state) saved by both managers: the same
    manifest and every shard file byte-identical, bf16 leaves ('<V2'
    header, raw bits) included, and the keys are the reference's
    (``0/embed``, ``1/.step``, ``1/.mu/layers/wq``, ...)."""
    jc, tc, jp, js = _ref_trained("bfloat16")
    params = params_from_reference(jax.tree.map(np.asarray, jp), tc, "cpu")
    state = OptState(torch.tensor(int(js.step), dtype=torch.int32),
                     *(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t) for t in (js.mu, js.nu)))
    JCkpt(str(tmp_path / "ref")).save(1, (jp, js), extra={"data_step": 1})
    CheckpointManager(str(tmp_path / "port")).save(1, (params, state), extra={"data_step": 1})
    ref_dir, port_dir = tmp_path / "ref" / "step_00000001", tmp_path / "port" / "step_00000001"
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    manifest = json.loads((port_dir / "manifest.json").read_text())
    assert manifest == json.loads((ref_dir / "manifest.json").read_text())
    assert {"0/embed", "0/layers/wq", "1/.step", "1/.mu/embed", "1/.nu/layers/wq"} <= set(manifest["leaves"])
    assert manifest["leaves"]["0/embed"]["dtype"] == "bfloat16"
    for f in os.listdir(ref_dir):
        assert (ref_dir / f).read_bytes() == (port_dir / f).read_bytes(), f


def test_params_to_reference_round_trips(tmp_path):
    """The port's bf16 parameters as the reference's numpy tree: the
    reference's forward takes it, and the bits come back unchanged."""
    jc, tc = _configs("bfloat16")
    params = tlm.init_params(tc, 2, device="cpu")
    tree = params_to_reference(params)
    assert tree["embed"].dtype.name == "bfloat16"
    back = params_from_reference(tree, tc, "cpu")
    for (name, a), b in zip(_flat(params.tree()).items(), _flat(back.tree()).values()):
        assert _bytes(a) == _bytes(b), name
    lg, _ = jlm.forward(jax.tree.map(jnp.asarray, tree), jc, jnp.zeros((1, 4), jnp.int32))
    assert np.isfinite(np.asarray(lg, np.float32)).all()


def test_checkpoint_async_retention_and_atomicity(tmp_path):
    """As the reference's: async saves snapshot first (a later in-place
    change does not leak into them), keep the newest ``keep``, and a
    half-written directory is never listed."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    os.makedirs(tmp_path / ".tmp-step_00000009")
    assert mgr.all_steps() == []
    t = {"a": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5, dtype=torch.int32)}
    for step in (1, 2, 3, 4):
        mgr.save(step, t, blocking=False)
        t["a"] += 1  # in place, after save returned
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    out = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.int32)}
    _, extra = mgr.restore(out)
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4) + 3) and extra == {}
    with pytest.raises(ValueError):  # a template leaf of another dtype
        mgr.restore({"a": torch.zeros(3, 4, dtype=torch.float64), "b": out["b"]})


# --------------------------------------------------------------------------
# train loop and CLI
# --------------------------------------------------------------------------


def _lm_problem():
    _, tc, _, params = _weights(seed=5)
    opt = AdamW(lr=LR, warmup_steps=1)
    return make_train_step(tc, opt, remat="full"), opt, params, tc


def test_trainloop_preemption_resume_bitwise(tmp_path):
    """Kill at step 7, resume from the step-6 checkpoint in a fresh model:
    final parameters and moments equal an uninterrupted run's bit for bit
    on the CPU (mirrors tests/test_ckpt_runtime.py on the smoke LM)."""
    cfgloop = TrainLoopConfig(n_steps=9, ckpt_every=3, ckpt_async=True)

    def pipe(tc):
        return tpipe.TokenPipeline(vocab=tc.vocab, batch=2, seq_len=16, seed=2)

    step_fn, opt, params, tc = _lm_problem()
    ref_params, ref_state, ref_log = TrainLoop(step_fn, pipe(tc), None, cfgloop).run(
        params, opt.init(params))

    step_fn, opt, params, tc = _lm_problem()
    ckpt = CheckpointManager(str(tmp_path), keep=3)

    class Preempt(RuntimeError):
        pass

    def bomb(step):
        if step == 7:
            raise Preempt()

    with pytest.raises(Preempt):
        TrainLoop(step_fn, pipe(tc), ckpt, cfgloop, pre_step_hook=bomb).run(params, opt.init(params))
    ckpt.wait()

    step_fn, opt, params, tc = _lm_problem()
    loop = TrainLoop(step_fn, pipe(tc), CheckpointManager(str(tmp_path), keep=3), cfgloop)
    params, state, start = loop.restore_or_init(params, opt.init(params))
    assert start == 6 and loop.pipeline.state.step == 6
    params, state, log = loop.run(params, state, start)
    assert [e["loss"] for e in log] == [e["loss"] for e in ref_log[6:]]
    want = _flat({"p": ref_params.tree(), "mu": ref_state.mu, "nu": ref_state.nu})
    got = _flat({"p": params.tree(), "mu": state.mu, "nu": state.nu})
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_train_cli_smoke_on_cpu_descends_and_resumes(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "64",
            "--lr", "3e-2", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    m = json.loads(next(l for l in out.splitlines() if l.startswith("[train/metrics] ")).split(" ", 1)[1])
    assert m["steps"] == 3 and m["device"] == "cpu" and m["peak_device_mem_gib"] is None
    assert all(np.isfinite(m["losses"])) and m["last_loss"] < m["first_loss"]
    assert m["tokens_per_s"] > 0 and not any(m["kernel_launches"].values())
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    argv[argv.index("--steps") + 1] = "4"
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and "steps 3..4" in out


def test_train_cli_refuses_quant_and_needs_a_device(monkeypatch, capsys):
    assert ttrain.main(["--smoke", "--device", "cpu", "--quant", "2"]) == 2
    assert "--quant 2 is not trainable" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--smoke", "--steps", "1"])
