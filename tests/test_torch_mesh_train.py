"""The train CLI on a real 2-rank ``gloo`` group, elastic resume across world
sizes, and ``ckpt.restore_resharded``, against the plain run and the
reference.

One shared group of two rank processes (``file://`` store, loopback only)
runs the CLI on ``fit_mesh``'s (1, 2) mesh for olmoe's smoke config,
``--production-mesh`` on it, a resume from a 1-process checkpoint and
``restore_resharded`` onto (1, 2) and (2, 1) meshes; beside it the dense
smoke config trains through ``python -m repro_torch.launch.train`` under a
torchrun-style environment (the CLI makes and destroys its own group), and
one reference child trains both configs single-device from the same
weights (the port's seed-0 draw, handed over as a checkpoint). The cases
read those runs' results.

Run as a script, the file is one rank of the shared group:
``python tests/test_torch_mesh_train.py RANK INIT_FILE WORKDIR``.
"""

import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = {"dense": "smollm_360m", "moe": "olmoe_1b_7b"}
STEPS = 4
ARGV = ["--smoke", "--device", "cpu", "--batch", "4", "--seq", "32", "--lr", "3e-2",
        "--steps", str(STEPS)]
# the mesh against the plain run: the same f32 ops on each shard, sums split
# over the shards (the MoE's routed products, the row-parallel products'
# reduction) in another order: relative, per loss
MESH_RTOL = 1e-6
# against the reference's jitted step: test_torch_train's three-step tolerance
REF_RTOL = 1e-5
RESTORE_MESHES = {"1x2": (1, 2), "2x1": (2, 1)}


def _cli(argv) -> tuple[int, str]:
    """``launch/train.main(argv)``: its exit code and what it printed."""
    from repro_torch.launch import train as ttrain

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ttrain.main(argv)
    return rc, buf.getvalue()


def _metrics(text: str) -> dict:
    return json.loads(next(line for line in text.splitlines()
                           if line.startswith("[train/metrics] ")).split(" ", 1)[1])


def _rank_main(rank: int, init_file: str, work: str) -> None:
    """One rank of the shared group: the jobs the cases read; each rank
    writes what it printed and rank 0 what it measured."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.ckpt import CheckpointManager, restore_resharded
    from repro_torch.ckpt.manager import _flatten
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import specs
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    out = {}
    moe_ck = os.path.join(work, "moe_mesh")
    out["moe"] = _cli(ARGV + ["--arch", ARCHS["moe"], "--ckpt", moe_ck])
    out["production_mesh"] = _cli(ARGV + ["--production-mesh"])
    out["one_to_two"] = _cli(ARGV + ["--arch", ARCHS["dense"],
                                     "--ckpt", os.path.join(work, "one_to_two")])
    cfg = get_smoke_config(ARCHS["moe"])
    mgr = CheckpointManager(moe_ck)
    saved, _ = mgr.read()
    opt = AdamW()
    weights = lm.init_params(cfg, 1, device="cpu", trainable=True)
    for name, shape in RESTORE_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
        p_sh, o_sh = specs.param_shardings(cfg, mesh), specs.opt_shardings(cfg, mesh, opt)
        tree, extra = restore_resharded(
            mgr, (weights, opt.init(weights)),
            (specs.mesh_shardings(mesh, p_sh), specs.mesh_shardings(mesh, o_sh)))
        placements = _flatten((p_sh, o_sh), is_leaf=lambda n: isinstance(n, list))
        leaves = _flatten(tree)
        differ, sharded, split = [], 0, 0
        for key, want in saved.items():
            split += any(pl.is_shard() and n > 1 for pl, n in zip(placements[key], shape))
            got = leaves[key]
            local = distribute_tensor(want, mesh, placements[key], src_data_rank=None)
            if not (isinstance(got, DTensor) and torch.equal(got.full_tensor(), want)
                    and torch.equal(got.to_local(), local.to_local())):
                differ.append(key)
            sharded += got.to_local().numel() < want.numel()
        out[f"restore_{name}"] = {"differ": differ, "sharded": sharded, "split": split,
                                  "leaves": len(saved),
                                  "extra": extra,
                                  "trainable": all(p.requires_grad for p in tree[0].parameters()
                                                   if p.is_floating_point())}
    with open(os.path.join(work, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.destroy_process_group()


REF_TRAIN = """
    import json, sys
    import jax, jax.numpy as jnp
    from repro.ckpt import CheckpointManager
    from repro.configs import get_smoke_config
    from repro.data.pipeline import TokenPipeline
    from repro.models import lm
    from repro.optim.adamw import AdamW
    from repro.runtime.steps import make_train_step
    work, archs, steps = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
    out = {}
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
    print("LOSSES " + json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _child_env(**extra) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **extra)
    for key in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the cases read: the plain runs and step-0 checkpoints made
    here first, then the shared group, the torchrun-style CLI and the
    reference child together, then the resumes that need their
    checkpoints."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamW

    work = str(tmp_path_factory.mktemp("mesh_train"))
    res = {"plain": {}}
    for tag, arch in ARCHS.items():
        rc, text = _cli(ARGV + ["--arch", arch])
        assert rc == 0, text
        res["plain"][tag] = _metrics(text)
        # the weights every run draws (seed 0) and fresh AdamW state, for the reference
        cfg = get_smoke_config(arch)
        params = lm.init_params(cfg, 0, device="cpu", trainable=True)
        CheckpointManager(os.path.join(work, f"ref_{tag}")).save(
            0, (params, AdamW(lr=3e-2).init(params)), extra={"data_step": 0})
    # a 1-process checkpoint at step 2, which the group resumes on (1, 2)
    rc, text = _cli(ARGV[:-1] + ["2", "--arch", ARCHS["dense"],
                                 "--ckpt", os.path.join(work, "one_to_two")])
    assert rc == 0, text

    procs = {}
    init_file = os.path.join(work, "init")
    for r in range(WORLD):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), init_file, work],
            env=_child_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = str(_free_port())
    for r in range(WORLD):
        procs[f"cli{r}"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *ARGV, "--arch", ARCHS["dense"],
             "--ckpt", os.path.join(work, "dense_mesh"), "--ckpt-every", "2"],
            env=_child_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_TRAIN), work, json.dumps(ARCHS), str(STEPS)],
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
    res["cli_stdout"] = [outs[f"cli{r}"][0] for r in range(WORLD)]
    res["reference"] = json.loads(next(line for line in outs["reference"][0].splitlines()
                                       if line.startswith("LOSSES ")).split(" ", 1)[1])
    # 2 -> 1: the (1, 2) run's step-2 checkpoint resumed by one process
    two_to_one = os.path.join(work, "two_to_one")
    shutil.copytree(os.path.join(work, "dense_mesh", "step_00000002"),
                    os.path.join(two_to_one, "step_00000002"))
    res["two_to_one"] = _cli(ARGV + ["--arch", ARCHS["dense"], "--ckpt", two_to_one])
    res["work"] = work
    return res


def _mesh_metrics(runs, tag) -> dict:
    text = runs["cli_stdout"][0] if tag == "dense" else runs["ranks"][0]["moe"][1]
    return _metrics(text)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12, 16, 32, 256])
def test_fit_mesh_rule_is_the_reference_s(n, monkeypatch):
    """``fit_mesh_shape(n)`` is the shape the reference's ``fit_mesh``
    asks ``make_mesh`` for over n devices."""
    import jax

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    monkeypatch.setattr(jax, "devices", lambda: [None] * n)
    monkeypatch.setattr(jtrain, "make_mesh", lambda shape, axes: (tuple(shape), tuple(axes)))
    assert jtrain.fit_mesh() == (ttrain.fit_mesh_shape(n), ("data", "model"))


def test_make_real_mesh_never_makes_or_replaces_a_group():
    """``make_real_mesh`` (fit_mesh's, --production-mesh's) refuses where
    there is no group and where the group is the dry run's fake one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh, make_real_mesh

    with pytest.raises(RuntimeError, match="no real process group"):
        make_real_mesh((1, 2), ("data", "model"))
    make_mesh((1, 2), ("data", "model"))  # a fake group of 2
    try:
        with pytest.raises(RuntimeError, match="no real process group"):
            make_real_mesh((1, 2), ("data", "model"))
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.mark.parametrize("tag", list(ARCHS))
def test_mesh_cli_matches_the_plain_run(runs, tag):
    """The CLI on fit_mesh's (1, 2) mesh: the plain run's losses within
    MESH_RTOL, the mesh and world size in its metrics."""
    m, plain = _mesh_metrics(runs, tag), runs["plain"][tag]
    assert m["mesh"] == {"shape": [1, 2], "axes": ["data", "model"]} and m["world_size"] == 2
    assert plain["mesh"] is None and plain["world_size"] == 1
    assert len(m["losses"]) == STEPS and all(np.isfinite(m["losses"]))
    np.testing.assert_allclose(m["losses"], plain["losses"], rtol=MESH_RTOL, atol=0)


@pytest.mark.parametrize("tag", list(ARCHS))
def test_mesh_cli_matches_the_reference_train_step(runs, tag):
    """The same losses against the reference's jitted single-device train
    step on the same weights and batches, within REF_RTOL."""
    np.testing.assert_allclose(_mesh_metrics(runs, tag)["losses"], runs["reference"][tag],
                               rtol=REF_RTOL, atol=0)


def test_only_rank_0_prints_under_torchrun(runs):
    """``python -m repro_torch.launch.train`` under a torchrun-style
    environment joins a gloo group of 2 and trains on (1, 2): rank 0 prints
    the [train] lines with the mesh as the reference prints it, rank 1
    prints nothing; the MoE run on the shared group likewise."""
    out0, out1 = runs["cli_stdout"]
    assert "mesh {'data': 1, 'model': 2}" in out0.splitlines()[0]
    assert any(line.startswith("[train/kernels] ") for line in out0.splitlines())
    assert out1 == "" and runs["ranks"][1]["moe"] == [0, ""]


def test_production_mesh_refused(runs):
    """``--production-mesh`` needs a group of 256 ranks: with no group and
    on the 2-rank group the CLI exits 2 and names the size (rank 0
    printing)."""
    rc, text = _cli(ARGV + ["--production-mesh"])
    assert rc == 2 and "needs a process group of 256 ranks" in text and "there is none" in text
    rc, text = runs["ranks"][0]["production_mesh"]
    assert rc == 2 and "needs a process group of 256 ranks" in text and "this one has 2" in text
    assert runs["ranks"][1]["production_mesh"] == [2, ""]


@pytest.mark.parametrize("case", ["two_to_one", "one_to_two"])
def test_elastic_resume_across_world_sizes(runs, case):
    """A checkpoint at step 2 on (1, 2) resumed by one process, and one
    written by one process resumed on (1, 2): the resumed steps' losses are
    the uninterrupted plain run's, within MESH_RTOL."""
    rc, text = runs["two_to_one"] if case == "two_to_one" else runs["ranks"][0]["one_to_two"]
    assert rc == 0 and "[train] resumed from step 2" in text, text
    m = _metrics(text)
    assert m["world_size"] == (1 if case == "two_to_one" else 2)
    np.testing.assert_allclose(m["losses"], runs["plain"]["dense"]["losses"][2:],
                               rtol=MESH_RTOL, atol=0)


def test_the_reference_restores_a_checkpoint_written_on_a_mesh(runs):
    """The (1, 2) run's last checkpoint in the reference's format: the
    reference's ``CheckpointManager.restore`` reads every leaf, the same
    values as the port's reader (bitwise)."""
    import jax

    from repro.ckpt import CheckpointManager as JCkpt
    from repro.configs import get_smoke_config as j_smoke
    from repro.models import lm as jlm
    from repro.optim.adamw import AdamW as JAdamW
    from repro_torch.ckpt import CheckpointManager

    path = os.path.join(runs["work"], "dense_mesh")
    assert CheckpointManager(path).all_steps() == [2, 4]
    jc = j_smoke(ARCHS["dense"])
    params = jlm.init_params(jc, jax.random.key(0))
    (jp, js), extra = JCkpt(path).restore((params, JAdamW().init(params)))
    assert extra == {"data_step": STEPS}
    values, _ = CheckpointManager(path).read()
    got = {"0/" + "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path_): leaf
           for path_, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert got and set(got) <= set(values)
    for key, leaf in got.items():
        np.testing.assert_array_equal(np.asarray(leaf), values[key].numpy())
    np.testing.assert_array_equal(np.asarray(js.step), values["1/.step"].numpy())


@pytest.mark.parametrize("mesh", list(RESTORE_MESHES))
def test_restore_resharded_onto_another_mesh(runs, mesh):
    """The MoE run's checkpoint (written on (1, 2)) restored onto (1, 2)
    and (2, 1): every leaf a ``DTensor`` whose whole value is the saved
    leaf and whose local shard is the one ``distribute_tensor`` gives this
    rank (bitwise), the parameters trainable. A shard is smaller than its
    leaf exactly where the policy splits the leaf over an axis of 2: on
    (1, 2) the 'model' axis splits some; on (2, 1) the policy keeps every
    parameter and moment whole ('data' carries the batch)."""
    r = runs["ranks"][0][f"restore_{mesh}"]
    assert r["differ"] == [] and r["extra"] == {"data_step": STEPS} and r["trainable"]
    assert r["leaves"] > 0 and r["sharded"] == r["split"]
    assert (r["split"] > 0) == (mesh == "1x2")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
