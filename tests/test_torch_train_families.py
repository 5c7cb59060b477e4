"""Port parity for training the MoE, hybrid, SSM, vlm and enc-dec families:
``moe.moe_capacity`` and the capacity dispatch ``moe.moe_ffn`` with its
aux loss, the loss and every gradient through ``runtime.steps.make_loss_fn``
(the hybrid's shared block, the vlm's patch embeddings, the enc-dec's
frames), AdamW train steps, the train CLI and checkpoints, each against the
reference on the CPU at the archs' smoke configs in float32, with the
reference's weights carried over by ``interop`` and inputs made with numpy
from a seed."""

import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.runtime.steps import make_loss_fn as j_loss_fn  # noqa: E402
from repro.runtime.steps import make_train_step as j_train_step  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    FORWARD_FAMILIES,
    PORTED_FAMILIES,
    TRAIN_FAMILIES,
    modality_batch_leaves,
)
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.runtime.steps import make_loss_fn, make_train_step  # noqa: E402

ARCHS = ("olmoe_1b_7b", "moonshot_v1_16b_a3b", "zamba2_2p7b", "mamba2_1p3b",
         "internvl2_76b", "whisper_tiny")
B, S = 2, 32
# f32 on both sides: the loss to 1e-5, each gradient leaf to 1e-4 of its
# own largest element (sums in other orders), as tests/test_torch_train.py
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
LR = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, seed=0):
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    return jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.key(seed)))


def _weights(arch, seed=0):
    """(jc, tc, the reference's weights as numpy, the port's trainable copy)."""
    jc = dataclasses.replace(j_smoke(arch), dtype="float32")
    tc = dataclasses.replace(t_smoke(arch), dtype="float32")
    tree = _ref_tree(arch, seed)
    return jc, tc, tree, params_from_reference(tree, tc, "cpu", trainable=True)


def _batch(cfg, step=0, b=B, s=S):
    """Tokens and labels from the reference's pipeline; the vlm's patch
    embeddings and the enc-dec's frames drawn from a seed (0.02 normal)."""
    batch = jpipe.TokenPipeline(vocab=cfg.vocab, batch=b, seq_len=s, seed=1).batch_at(step)
    rng = np.random.default_rng(100 + step)
    for name, shape in modality_batch_leaves(cfg).items():
        batch[name] = (rng.standard_normal((b, *shape)) * 0.02).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat(tree):
    """{'embed': ..., 'layers/wq': ...} of a nested dict."""
    return {
        "/".join(str(p.key) for p in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
    }


def _assert_grads(names, grads, wflat):
    assert sorted(names) == sorted(wflat)
    for name, g in zip(names, grads):
        w = np.asarray(wflat[name])
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * scale, (name, err, scale)


# --------------------------------------------------------------------------
# families and the capacity dispatch
# --------------------------------------------------------------------------


def test_every_family_trains():
    assert TRAIN_FAMILIES == PORTED_FAMILIES and len(TRAIN_FAMILIES) == 6
    assert set(FORWARD_FAMILIES) == set(PORTED_FAMILIES) - {"encdec"}


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "moonshot_v1_16b_a3b", "olmoe_1b_7b@smoke"])
def test_moe_capacity_matches_reference(arch):
    """Group sizes 1..600: the round-up to 8 only from 8 on, the clamp to
    the group, at the full configs' 64 experts and the smoke config's 8."""
    name, _, smoke = arch.partition("@")
    jc, tc = (j_smoke(name), t_smoke(name)) if smoke else (j_full(name), t_full(name))
    got = [tmoe.moe_capacity(tc, s) for s in range(1, 601)]
    assert got == [jmoe.moe_capacity(jc, s) for s in range(1, 601)]
    assert all(1 <= c <= s for s, c in enumerate(got, 1))


def _moe_inputs(case, cfg, seed=3):
    """x (B, S, d): random rows, or ("crowded") rows near one shared
    vector, so that most tokens of a row pick the same experts and more
    than the capacity's worth of them compete for each."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if case == "crowded":
        x = x[:, :1] * 4.0 + 0.05 * x
    return x.astype(np.float32)


@pytest.mark.parametrize("case", ["random", "crowded"])
def test_moe_ffn_output_aux_and_gradients_match_reference(case):
    """``moe_ffn`` on layer 0's weights: the output and the aux loss, and
    the gradients of sum(y * r) + aux in x, the router and the three expert
    stacks. In the crowded case more than C tokens pick one expert, so
    capacity drops bind (checked on the routing)."""
    jc, tc, tree, _ = _weights("olmoe_1b_7b")
    x = _moe_inputs(case, jc)
    r = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    lp = {k: tree["layers"][k][0] for k in ("router", "w1", "w3", "w2")}

    def jloss(x_, router, w1, w3, w2):
        y, aux = jmoe.moe_ffn(x_, router, w1, w3, w2, jc)
        return jnp.sum(y * r) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=range(5), has_aux=True)(
        jnp.asarray(x), *(jnp.asarray(lp[k]) for k in ("router", "w1", "w3", "w2")))
    ins = [torch.from_numpy(np.array(a)).requires_grad_() for a in
           (x, lp["router"], lp["w1"], lp["w3"], lp["w2"])]
    y, aux = tmoe.moe_ffn(*ins, tc)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux, ins)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    assert aux.dtype == torch.float32
    for name, g, w in zip(("x", "router", "w1", "w3", "w2"), grads, jg):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= GRAD_TOL * float(np.abs(w).max()), name
    _, _, top_i = tmoe._token_gates(ins[0].detach(), ins[1].detach(), tc)
    picks = torch.zeros((B, jc.n_experts)).scatter_add_(
        1, top_i.reshape(B, -1), torch.ones(B, S * jc.experts_per_token))
    cap = tmoe.moe_capacity(tc, S)
    assert (int(picks.max()) > cap) == (case == "crowded"), (picks, cap)


# --------------------------------------------------------------------------
# the loss and every gradient
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ce_chunk", [0, 8])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_reference(arch, remat, ce_chunk):
    """``make_loss_fn`` against ``jax.value_and_grad`` of the reference's on
    the same weights and batch: the MoE's aux loss, the hybrid's shared
    block applied after every super-block (its gradient summed over the
    applications), the vlm's patch embeddings ahead of the tokens, the
    enc-dec's frames (it takes neither remat nor ce_chunk, in either
    package)."""
    jc, tc, tree, params = _weights(arch)
    batch = _batch(jc)
    want, wgrads = jax.value_and_grad(j_loss_fn(jc, remat=remat, ce_chunk=ce_chunk))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    got = make_loss_fn(tc, remat=remat, ce_chunk=ce_chunk)(params, _tbatch(batch))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    tflat = _flat(params.tree())
    names = list(tflat)
    _assert_grads(names, torch.autograd.grad(got, [tflat[n] for n in names]), _flat(wgrads))


def test_moe_aux_loss_enters_the_loss():
    """``lm.loss_fn``'s (ce, aux) are the reference's, aux the sum of the
    layers' Switch losses, and the loss is ce + aux_weight * aux; the
    kernels' plain versions run on the CPU, so nothing is counted."""
    jc, tc, tree, params = _weights("olmoe_1b_7b")
    batch = _batch(jc)
    toks, labels = (jnp.asarray(batch[k]) for k in ("tokens", "labels"))
    jl, (jce, jaux) = jlm.loss_fn(jax.tree.map(jnp.asarray, tree), jc, toks, labels,
                                  aux_weight=0.5)
    ops.reset_launch_counts()
    tl, (tce, taux) = tlm.loss_fn(params, tc, *(_tbatch(batch)[k] for k in ("tokens", "labels")),
                                  aux_weight=0.5)
    assert not any(ops.launch_counts().values())
    np.testing.assert_allclose([tl.item(), tce.item(), taux.item()],
                               [float(jl), float(jce), float(jaux)], rtol=1e-5)
    assert taux.item() > 0 and abs(tl.item() - (tce.item() + 0.5 * taux.item())) < 1e-5


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_train_step_takes_every_arch_with_the_reference_batch(arch):
    """As ``tests/test_archs.py::test_train_step_smoke``: the arch's smoke
    config, remat none, ce_chunk 16, the reference's ``_batch`` leaves
    (constant tokens, 0.01 patches and frames): a finite positive loss,
    the parameters moved, and but for MoE the reference's loss on the same
    weights (1e-5). With constant tokens every position of a row has the
    same hidden state up to rounding, so an MoE expert's choice of C of
    them is a near-tie that each package's rounding settles its own way:
    MoE's loss is held to 1e-2 here, and to 1e-5 on random tokens by
    ``test_loss_and_every_gradient_match_reference``."""
    jc, tc, tree, params = _weights(arch)
    batch = {"tokens": np.full((B, S), 3, np.int32), "labels": np.ones((B, S), np.int32)}
    for name, shape in modality_batch_leaves(jc).items():
        batch[name] = np.full((B, *shape), 0.01, np.float32)
    want = float(j_loss_fn(jc, remat="none", ce_chunk=16)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch)))
    opt = AdamW(warmup_steps=2)
    before = {k: v.detach().clone() for k, v in _flat(params.tree()).items()}
    _, _, m = make_train_step(tc, opt, remat="none", ce_chunk=16)(
        params, opt.init(params), _tbatch(batch))
    loss = m["loss"].item()
    assert np.isfinite(loss) and loss > 0
    np.testing.assert_allclose(loss, want, rtol=1e-2 if tc.family == "moe" else 1e-5)
    assert ("aux" in m) == (tc.family == "moe")
    moved = max(float((v.detach() - before[k]).abs().max())
                for k, v in _flat(params.tree()).items())
    assert moved > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps against the reference's jitted step
    on the same weights and batches (lr 1e-2, warm-up 1), as the dense
    family's test holds them: the losses to 1e-5, a parameter at most 2 *
    lr a step away (Adam's m / (sqrt(v) + eps) swings sign on a gradient
    near zero), all but 1% of each leaf's elements within 1e-5, or all but
    4 where 1% is fewer: the smoke hybrid's conv leaves hold 256 elements,
    and 3 of them (first moment ~1e-9 after one step) part by up to
    1.6e-4."""
    jc, tc, tree, params = _weights(arch)
    jopt, topt = JAdamW(lr=LR, warmup_steps=1), AdamW(lr=LR, warmup_steps=1)
    jstep = jax.jit(j_train_step(jc, jopt, remat="none"))
    tstep = make_train_step(tc, topt, remat="none")
    jp = jax.tree.map(jnp.asarray, tree)
    js, ts = jopt.init(jp), topt.init(params)
    for step in range(3):
        batch = _batch(jc, step)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        params, ts, tm = tstep(params, ts, _tbatch(batch))
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    tflat = _flat(params.tree())
    for name, w in _flat(jp).items():
        diff = np.abs(tflat[name].detach().numpy() - np.asarray(w))
        assert diff.max() <= 2 * LR * 3, (name, diff.max())
        assert (diff > 1e-5).sum() <= max(1e-2 * diff.size, 4), (name, (diff > 1e-5).sum())


# --------------------------------------------------------------------------
# checkpoints, both ways
# --------------------------------------------------------------------------


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "zamba2_2p7b"])
def test_checkpoints_carry_the_tree_both_ways(tmp_path, arch):
    """The port trains a step and saves; the reference's manager restores
    (params, opt_state) byte for byte (the MoE's router and expert stacks,
    the hybrid's Mamba2 leaves and ``shared`` block); the reference's save
    of the same state restores into fresh port modules byte for byte, and
    the port trains on from it."""
    jc, tc, tree, params = _weights(arch)
    opt = AdamW(lr=LR, warmup_steps=1)
    state = opt.init(params)
    params, state, _ = make_train_step(tc, opt, remat="none")(params, state, _tbatch(_batch(jc)))
    CheckpointManager(str(tmp_path / "port")).save(1, (params, state), extra={"data_step": 1})
    jp = jax.tree.map(jnp.asarray, tree)
    (rp, rs), extra = JCkpt(str(tmp_path / "port")).restore((jp, JAdamW().init(jp)))
    assert extra == {"data_step": 1} and int(rs.step) == 1
    want = _flat({"p": params.tree(), "mu": state.mu, "nu": state.nu})
    got = _flat({"p": rp, "mu": rs.mu, "nu": rs.nu})
    assert sorted(got) == sorted(want)
    for name in want:
        assert _bytes(got[name]) == _bytes(want[name]), name
    JCkpt(str(tmp_path / "ref")).save(1, (rp, rs), extra={"data_step": 1})
    fresh = tlm.init_params(tc, 9, device="cpu", trainable=True)
    (fresh, fstate), extra = CheckpointManager(str(tmp_path / "ref")).restore(
        (fresh, opt.init(fresh)))
    back = _flat({"p": fresh.tree(), "mu": fstate.mu, "nu": fstate.nu})
    for name in want:
        assert _bytes(back[name]) == _bytes(want[name]), name
    _, fstate, m = make_train_step(tc, opt, remat="none")(fresh, fstate, _tbatch(_batch(jc, 1)))
    assert np.isfinite(m["loss"].item()) and int(fstate.step) == 2


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------


def _metrics(out):
    return json.loads(next(l for l in out.splitlines() if l.startswith("[train/metrics] "))
                      .split(" ", 1)[1])


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mamba2_1p3b", "zamba2_2p7b"])
def test_train_cli_trains_the_token_families_and_resumes(tmp_path, capsys, arch):
    """``--smoke --device cpu`` on the MoE, SSM and hybrid archs: the loss
    finite and falling, no kernel launched (the plain versions run), the
    MoE's last aux loss reported, checkpoints at 2 and 3, and a resume."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "64", "--lr", "3e-2", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    assert ttrain.main(argv) == 0
    m = _metrics(capsys.readouterr().out)
    assert m["steps"] == 3 and m["device"] == "cpu" and m["peak_device_mem_gib"] is None
    assert all(np.isfinite(m["losses"])) and m["last_loss"] < m["first_loss"]
    assert not any(m["kernel_launches"].values())
    assert ("last_aux" in m) == (arch == "olmoe_1b_7b")
    if arch == "olmoe_1b_7b":
        assert np.isfinite(m["last_aux"]) and m["last_aux"] > 0
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3]
    argv[argv.index("--steps") + 1] = "4"
    assert ttrain.main(argv) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 3" in out and "steps 3..4" in out


def test_train_cli_takes_weights_the_caller_holds(capsys):
    """``main(argv, params=...)`` with the seed's own draw trains the same
    steps as a run that draws them."""
    argv = ["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "32", "--seed", "4"]
    assert ttrain.main(argv) == 0
    drawn = _metrics(capsys.readouterr().out)["losses"]
    held = tlm.init_params(t_smoke("mamba2_1p3b"), 4, device="cpu")
    assert ttrain.main(argv, params=held) == 0
    assert _metrics(capsys.readouterr().out)["losses"] == drawn


@pytest.mark.parametrize("arch,leaf", [("internvl2_76b", "prefix_embeds"),
                                       ("whisper_tiny", "frames")])
def test_train_cli_refuses_the_modality_families(capsys, arch, leaf):
    """The reference's CLI reaches its first step and fails there with a
    ``KeyError`` on the leaf ``TokenPipeline`` does not yield; the port's
    exits 2 with that reason before drawing any weight."""
    with pytest.raises(KeyError, match=leaf):
        jtrain.main(["--arch", arch, "--smoke", "--steps", "1", "--batch", "2",
                     "--seq", "16"])
    capsys.readouterr()
    assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert f"'{leaf}'" in out and "KeyError" in out and "make_train_step" in out


def test_train_cli_quant_note_on_the_unpacked_families(capsys):
    """``--quant`` on MoE and SSM archs prints the reference's note and
    trains dense; on a packing family it exits 2, as before."""
    for arch, family in (("olmoe_1b_7b", "moe"), ("mamba2_1p3b", "ssm")):
        assert ttrain.main(["--arch", arch, "--smoke", "--device", "cpu", "--quant", "2",
                            "--steps", "1", "--batch", "2", "--seq", "16"]) == 0
        out = capsys.readouterr().out
        assert (f"[train] note: --quant has no effect on family '{family}' (no dense FFN "
                "to pack); ignoring") in out
    assert ttrain.main(["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu", "--quant",
                        "1"]) == 2
    assert "--quant 1 is not trainable" in capsys.readouterr().out


def test_adamw_updates_a_large_leaf_in_blocks_with_the_same_bits(monkeypatch):
    """A leaf of more than ``UPDATE_ELEMS`` elements is updated a block of
    its leading axis at a time: three steps give the same bits as one
    block would (parameters in f32 and bf16, both moments), and the
    blocks' decay follows the whole leaf's rank (the (L, d) gain decays).
    The gradients' norm stays below the clip (1.0), so the clip factor is
    exactly 1 whatever order the blocked norm sums in."""
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((7, 5, 3), generator=gen),
            "ln": 1 + 0.1 * torch.randn((9, 4), generator=gen),
            "e": torch.randn((9, 2), generator=gen).to(torch.bfloat16),
            "norm": torch.randn((6,), generator=gen)}
    grads = {k: 0.02 * torch.randn(v.shape, generator=gen) for k, v in tree.items()}
    runs = []
    for elems in (adamw.UPDATE_ELEMS, 6):
        monkeypatch.setattr(adamw, "UPDATE_ELEMS", elems)
        opt = AdamW(lr=LR, warmup_steps=1)
        params = {k: v.clone() for k, v in tree.items()}
        state = opt.init(params)
        for _ in range(3):
            params, state = opt.update(grads, state, params)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for k in tree:
        for a, b in ((p1[k], p2[k]), (s1.mu[k], s2.mu[k]), (s1.nu[k], s2.nu[k])):
            assert a.dtype == b.dtype and torch.equal(a, b), k
