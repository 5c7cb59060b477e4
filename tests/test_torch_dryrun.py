"""Port parity for the production dry run (``launch/{mesh,specs,dryrun}.py``),
the op walk over ``DTensor``s, the kernel wrappers on ``meta``, the four
mesh hooks and their two attention variants.

The stand-ins equal the reference's ``jax.eval_shape`` trees; every
``DTensor`` stand-in's local shard is the shard its reference spec gives;
the walk of a sharded step counts one device; on a 1 x 1 mesh a cell reads
what the walk of the same step on real CPU tensors reads; the reference's
own dry run, in a child process with 8 forced host devices, gives the same
per-device dot flops; the hooks fire under the reference's conditions and
their attention variants compute the dense attention. No test touches a
network or a GPU: meshes span fake process groups."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.dist.legalize import PartitionSpec, placements_of  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import mvau as tmvau  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import packed_matmul as tpm  # noqa: E402
from repro_torch.kernels import weight_stream as tws  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.optim.adamw import AdamW  # noqa: E402
from repro_torch.perf import op_analysis as oa  # noqa: E402
from repro_torch.runtime.steps import make_prefill_step, make_serve_step, make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_SHAPES = {"16x16": ((16, 16), ("data", "model")),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def fake_group():
    """Destroy the fake process group a test made (``launch.mesh``)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _flat(tree, path=()):
    """(path, leaf) of a nested dict / named tuple of leaves."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (str(k),))
    else:
        yield path, tree


def _sig(tree) -> dict:
    """path -> (shape, dtype name) of every leaf, jax or torch."""
    return {p: (tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
            for p, leaf in _flat(tree)}


# ---------------- the stand-ins ----------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_stand_ins_match_the_reference_eval_shape_trees(arch):
    """Every applicable shape of every arch at full size: batch, cache
    (the enc-dec's cross caches included), token and the AdamW state have
    the reference's shapes and dtypes, leaf for leaf."""
    tc, jc = t_full(arch), j_full(arch)
    assert _sig(tspecs.abstract_opt_state(tc)) == _sig(jspecs.abstract_opt_state(jc))
    for name in SHAPES:
        if not jconfig.shape_applicable(jc, jconfig.SHAPES[name])[0]:
            continue
        ts, js = SHAPES[name], jconfig.SHAPES[name]
        assert _sig(tspecs.abstract_batch(tc, ts)) == _sig(jspecs.abstract_batch(jc, js))
        assert _sig(tspecs.abstract_cache(tc, ts)) == _sig(jspecs.abstract_cache(jc, js))
        assert _sig({"t": tspecs.abstract_token(tc, ts)}) == _sig(
            {"t": jspecs.abstract_token(jc, js)})
        assert _sig(tspecs.input_specs(tc, ts)) == _sig(jspecs.input_specs(jc, js))


class _JMesh:
    def __init__(self, shape, names):
        self.axis_names, self.shape = names, dict(zip(names, shape))


def _shard_shape(shape, spec, sizes: dict) -> tuple:
    """Each dim divided by the product of the sizes of its spec's axes."""
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


@pytest.mark.parametrize("mesh_name", list(MESH_SHAPES))
def test_dtensor_stand_ins_hold_the_reference_shards(mesh_name, fake_group):
    """On rank 0 of a fake 256 / 512-rank group, every parameter, batch and
    cache stand-in's local shard has the shape its reference spec gives;
    every spec the policy emits lists its axes in the mesh's order."""
    shape, names = MESH_SHAPES[mesh_name]
    mesh, jmesh = make_mesh(shape, names), _JMesh(shape, names)
    sizes = dict(zip(names, shape))
    for arch in ARCH_IDS:
        tc, jc = t_full(arch), j_full(arch)
        jp = dict(_flat(jshd.param_specs(jc, jmesh)))
        params = tspecs.distribute_abstract(
            tspecs.abstract_params(tc).tree(), mesh, tspecs.param_shardings(tc, mesh))
        for path, leaf in _flat(params):
            assert tuple(leaf.to_local().shape) == _shard_shape(leaf.shape, jp[path], sizes)
        for name in ("train_4k", "decode_32k"):
            ts = SHAPES[name]
            if ts.kind == "train":
                tree, js = tspecs.abstract_batch(tc, ts), jshd.batch_specs(
                    jc, jmesh, ts.global_batch)
                pl = tspecs.batch_shardings(tc, ts, mesh)
            else:
                tree = tspecs.abstract_cache(tc, ts)
                js = jshd.cache_specs(jc, jmesh, ts.global_batch, ts.seq_len,
                                      cache=jspecs.abstract_cache(jc, jconfig.SHAPES[name]))
                pl = tspecs.cache_shardings(tc, ts, mesh)
            for key, leaf in tspecs.distribute_abstract(tree, mesh, pl).items():
                assert tuple(leaf.to_local().shape) == _shard_shape(leaf.shape, js[key], sizes)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements_of(PartitionSpec(("model", "data")), mesh)


def test_make_mesh_replaces_a_fake_group_and_never_a_real_one(fake_group):
    mesh = make_mesh((2, 4), ("data", "model"))
    assert dist.get_world_size() == 8 and mesh.size() == 8
    mesh = make_production_mesh(multi_pod=True)
    assert dist.get_world_size() == 512 and tuple(mesh.mesh_dim_names) == (
        "pod", "data", "model")
    dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    with pytest.raises(RuntimeError, match="only over a fake group"):
        make_mesh((1,), ("data",))


# ---------------- the walk counts one device ----------------


def _meta_dt(mesh, shape, placements, grad=False):
    return tspecs.distribute_abstract(torch.empty(shape, device="meta"), mesh, placements,
                                      trainable=grad)


def test_walk_of_a_sharded_mlp_counts_one_device(fake_group):
    """A column- then row-parallel MLP, forward and backward, on a fake 2 x
    4 mesh, its output and gradients redistributed to their placements:
    every product is one device's (the global dot flops / 8), the
    all-reduces are hand arithmetic (the output's Partial over 'model',
    each gradient's over 'data'), and no global-shape op is counted."""
    mesh = make_mesh((2, 4), ("data", "model"))
    x = _meta_dt(mesh, (8, 16), [Shard(0), Replicate()])
    w1 = _meta_dt(mesh, (16, 32), [Replicate(), Shard(1)], grad=True)
    w2 = _meta_dt(mesh, (32, 16), [Replicate(), Shard(0)], grad=True)

    def step(x, w1, w2):
        y = ((x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])
        g1, g2 = torch.autograd.grad(y.sum(), [w1, w2])
        return g1.redistribute(mesh, w1.placements), g2.redistribute(mesh, w2.placements)

    cost = oa.analyze(step, x, w1, w2)
    assert cost.dot_flops == 5 * (2 * 8 * 16 * 32) / 8  # two forward, three backward
    assert cost.collective_bytes == {"all-reduce": 4 * 16 * 4 + 2 * (16 * 8 * 4)}
    mm_shapes = {shapes for (op, shapes) in cost.rows if op == "mm"}
    assert mm_shapes == {"4x16 16x8", "4x8 8x16", "8x4 4x16", "16x4 4x8"}
    assert cost.argument_bytes == (4 * 16 + 16 * 8 + 8 * 16) * 4
    assert cost.output_bytes == (16 * 8 + 8 * 16) * 4
    assert not cost.implicit  # every collective here is one the step asked for


def test_collective_inside_an_op_s_dispatch_is_counted_by_kind(fake_group):
    """An op whose placements ``DTensor`` must change first: the all-gather
    it issues inside the op's dispatch counts with its kind and bytes, and
    is kept as an op run on replicated inputs."""
    mesh = make_mesh((2, 4), ("data", "model"))
    a = _meta_dt(mesh, (8, 32), [Replicate(), Shard(1)])
    cost = oa.analyze(lambda a: torch.cumsum(a, dim=1), a)  # along the sharded dim
    assert cost.collective_bytes == {"all-gather": 8 * 8 * 4}  # rank 0's (8, 8) f32 shard
    assert list(cost.implicit) == ["all-gather: aten.cumsum at "]


def test_the_torch_internals_the_dry_run_reads_are_there():
    """The dry run reads a few of torch's private names: the frames
    ``op_analysis._collective_origin`` keys on (``DTensor``'s dispatch
    module, ``shard_dim_alltoall``), the sharding caches
    ``dryrun._clear_sharding_caches`` empties, and the fake store
    ``launch.mesh`` builds its group on. A torch that renames one fails
    here, not in a silently different record."""
    import torch.distributed.tensor._dispatch as dispatch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _collective_utils
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401

    assert dispatch.__file__.endswith(os.path.join("distributed", "tensor", "_dispatch.py"))
    assert callable(_collective_utils.shard_dim_alltoall)
    prop = DTensor._op_dispatcher.sharding_propagator
    assert (hasattr(getattr(prop, "propagate_op_sharding", None), "cache_clear")
            or hasattr(torch._C, "_clear_DTensor_sharding_propagator_cache"))


def test_a_shard_to_shard_redistribute_counts_as_an_all_to_all(fake_group):
    """Moving a shard from one dim to another on a mesh dim is an
    all-to-all (a CPU mesh runs it as an all-gather and a chunk, inside
    ``shard_dim_alltoall``): it counts as one, with the shard's bytes,
    and as a collective the step asked for."""
    mesh = make_mesh((2, 4), ("data", "model"))
    a = _meta_dt(mesh, (8, 32), [Replicate(), Shard(0)])
    cost = oa.analyze(lambda a: a.redistribute(mesh, [Replicate(), Shard(1)]), a)
    assert cost.collective_bytes == {"all-to-all": 2 * 32 * 4}  # rank 0's (2, 32) f32 shard
    assert not cost.implicit


def test_peak_live_bytes_of_a_three_op_chain():
    """Keyed by storage: a view adds nothing, a freed temporary leaves."""
    def chain(a):
        b = torch.cat([a, a])  # 8000 B
        c = b * 2  # 8000 B: 4000 + 8000 + 8000 alive, the peak
        del b
        return c[:1000] + 1  # 4000 B; c[:1000] is a view

    a = torch.empty(1000, device="meta")
    cost = oa.analyze(chain, a)
    assert (cost.argument_bytes, cost.output_bytes, cost.peak_live_bytes) == (4000, 4000, 20000)


# ---------------- the kernel wrappers on meta and on DTensors ----------------


def _wrapper_case(name, device):
    """(wrapper, its arguments on ``device``), from a seed."""
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(device)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(device)

    q, k, out = r(6, 32, 64), r(2, 48, 64), r(6, 32, 64)
    return {
        "packed_matmul": (tpm.packed_matmul, (r(8, 64), u8(16, 24), r(24), 2, 64)),
        "stream_matmul": (tws.stream_matmul, (r(8, 64), u8(8, 24), r(24), 1, 64, 4)),
        "mvau": (tmvau.mvau, (r(8, 64), u8(16, 24), r(24, 3), r(24), 2, 64)),
        "flash_fwd": (tfa.flash_fwd, (q, k, k)),
        "flash_bwd_dq": (tfa.flash_bwd_dq, (q, k, k, out, r(6, 32), out)),
        "flash_bwd_dkv": (tfa.flash_bwd_dkv, (q, k, k, out, r(6, 32), r(6, 32))),
    }[name]


WRAPPERS = ["packed_matmul", "stream_matmul", "mvau", "flash_fwd", "flash_bwd_dq",
            "flash_bwd_dkv"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_each_wrapper_on_meta_returns_its_shapes_and_reports_the_same_work(name):
    """The six wrappers on ``meta`` return empty results of the kernel's
    shapes and dtypes (no arithmetic) and report what they report on CPU
    tensors of the same shapes."""
    on_cpu, on_meta = oa.OpCost(), oa.OpCost()
    for cost, device in ((on_cpu, "cpu"), (on_meta, "meta")):
        fn, args = _wrapper_case(name, device)
        with oa._Walk(cost):
            out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        if device == "cpu":
            want = [(t.shape, t.dtype) for t in outs]
        else:
            assert [(t.shape, t.dtype) for t in outs] == want
            assert all(t.device.type == "meta" for t in outs)
    assert on_meta.kernel_launches == on_cpu.kernel_launches == {name: 1}
    assert (on_meta.dot_flops, on_meta.traffic_bytes) == (on_cpu.dot_flops, on_cpu.traffic_bytes)
    assert set(on_meta.rows) == {(f"kernel:{name}", s) for _, s in on_cpu.rows}


def test_kernels_run_on_local_shards_of_dtensors(fake_group):
    """``ops.packed_matmul`` over DTensors: a column-sharded carrier gives a
    column-sharded output, a row-sharded one a ``Partial`` sum over x
    sharded on K, reduced at once; the kernel reports one device's product. Attention keeps
    the batch and the heads sharded where both head counts divide."""
    mesh = make_mesh((2, 4), ("data", "model"))
    x = _meta_dt(mesh, (8, 64), [Shard(0), Replicate()])
    col = tspecs.distribute_abstract(torch.empty((16, 32), dtype=torch.uint8, device="meta"),
                                     mesh, [Replicate(), Shard(1)])
    row = tspecs.distribute_abstract(torch.empty((8, 64), dtype=torch.uint8, device="meta"),
                                     mesh, [Replicate(), Shard(0)])
    cost = oa.OpCost()
    with oa._Walk(cost):
        y = tops.packed_matmul(x, col, _meta_dt(mesh, (32,), [Replicate()] * 2), bits=2, k=64)
        z = tops.packed_matmul(y, row, _meta_dt(mesh, (64,), [Replicate()] * 2), bits=2, k=32)
    assert (y.shape, y.placements) == ((8, 32), (Shard(0), Shard(1)))
    # the row-parallel product's Partial sum is reduced at once: one
    # all-reduce of rank 0's (4, 64) f32 rows
    assert (z.shape, z.placements) == ((8, 64), (Shard(0), Replicate()))
    assert cost.collective_bytes == {"all-reduce": 4 * 64 * 4}
    assert cost.kernel_launches == {"packed_matmul": 2}
    assert cost.dot_flops == 2 * (2 * 8 * 64 * 32) / 8
    # stream_matmul takes the same placements; mvau (no mesh path) refuses
    with oa._Walk(cost):
        s = tops.stream_matmul(x, col, _meta_dt(mesh, (32,), [Replicate()] * 2), bits=2, k=64)
    assert (s.placements, cost.kernel_launches["stream_matmul"]) == ((Shard(0), Shard(1)), 1)
    with pytest.raises(ValueError, match="no mesh"):
        tops.mvau(x, col, _meta_dt(mesh, (32, 3), [Replicate()] * 2),
                  _meta_dt(mesh, (32,), [Replicate()] * 2), bits=2, k=64)
    q = _meta_dt(mesh, (4, 16, 8, 32), [Shard(0), Shard(2)])
    kv = _meta_dt(mesh, (4, 16, 4, 32), [Shard(0), Shard(2)])
    o = tops.flash_attention(q, kv, kv)
    assert (o.shape, o.placements) == ((4, 16, 8, 32), (Shard(0), Shard(2)))
    # GQA, 2 KV heads on 4 head shards: K/V stay whole, rank 0 reads the one
    # KV head its 2 query heads share
    kv2 = _meta_dt(mesh, (4, 16, 2, 32), [Shard(0), Replicate()], grad=True)
    cost = oa.OpCost()
    with oa._Walk(cost):
        o = tops.flash_attention(q, kv2, kv2)
    assert o.placements == (Shard(0), Shard(2))
    assert [s for (op, s) in cost.rows if op == "kernel:flash_fwd"] == [
        "4x16x32 2x16x32 2x16x32"]


# ---------------- one device, two ways ----------------


TOY = {"train": ShapeConfig("toy_train", 64, 4, "train"),
       "prefill": ShapeConfig("toy_prefill", 64, 4, "prefill"),
       "decode": ShapeConfig("toy_decode", 64, 4, "decode")}


@pytest.fixture
def toy_shapes(monkeypatch):
    for shape in TOY.values():
        monkeypatch.setitem(SHAPES, shape.name, shape)


@pytest.mark.parametrize("arch,kind,bits", [
    ("smollm_360m", "prefill", 0), ("smollm_360m", "decode", 0), ("smollm_360m", "train", 0),
    ("smollm_360m", "prefill", 2), ("smollm_360m", "decode", 2),
    ("olmoe_1b_7b", "prefill", 0), ("olmoe_1b_7b", "decode", 0), ("olmoe_1b_7b", "train", 0),
])
def test_a_one_by_one_mesh_cell_reads_the_eager_walk(arch, kind, bits, toy_shapes, fake_group):
    """A smoke config's cell on a 1 x 1 fake mesh (``meta`` DTensors) gives
    the dot flops, bytes and peak live bytes of the walk of the same step
    on real CPU tensors."""
    cfg = dataclasses.replace(t_smoke(arch), w_bits=bits)
    lowered, meta = tdry.lower_cell(cfg, TOY[kind].name, make_mesh((1, 1), ("data", "model")),
                                    remat="none", ce_chunk=0)
    got = lowered.walk()
    tdry.reset_hooks()
    params = tlm.init_params(cfg, device="cpu", trainable=kind == "train")
    tokens = torch.zeros((4, 64), dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    if kind == "train":
        opt = AdamW()
        want = oa.analyze(make_train_step(cfg, opt, remat="none"), params, opt.init(params), batch)
    elif kind == "prefill":
        want = oa.analyze(make_prefill_step(cfg), params, batch)
    else:
        want = oa.analyze(make_serve_step(cfg), params, torch.zeros((4, 1), dtype=torch.int32),
                          tlm.init_cache(cfg, 4, 64, device="cpu"))
    for field in ("dot_flops", "traffic_bytes", "peak_live_bytes", "argument_bytes",
                  "output_bytes", "kernel_launches"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.collective_bytes == want.collective_bytes == {}
    # on a 1 x 1 mesh the experts divide the model axis: the EP hook is set
    assert meta == {"kind": kind, "hooks": ["moe_ep_axis"] if arch == "olmoe_1b_7b" else []}


# ---------------- against the reference's dry run ----------------


REF_CELLS = """
    import jax
    from repro.configs import get_smoke_config
    from repro.launch.dryrun import lower_cell
    from repro.models.config import SHAPES, ShapeConfig
    from repro.perf.roofline import roofline
    cfg = get_smoke_config("h2o_danube_1p8b")
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for kind in ("train", "prefill", "decode"):
        SHAPES["toy"] = ShapeConfig("toy", 64, 8, kind)
        lowered, _ = lower_cell(cfg, "toy", mesh, remat="none", ce_chunk=16,
                                constraints=kind != "decode")
        rl = roofline("toy", lowered.compile(), cfg, SHAPES["toy"], mesh.size)
        print("CELL", kind, rl.flops, rl.coll_bytes, repr(rl.coll_breakdown))
"""


def test_per_device_dot_flops_match_the_reference_dry_run(monkeypatch, fake_group):
    """h2o-danube's smoke config on a (2, 4) mesh, toy train / prefill /
    decode cells, against the reference's ``lower_cell`` compiled for 8
    forced host devices in a child process: the prefill's and the decode
    step's per-device dot flops are equal; training reads exactly the
    two-pass backward's recomputed products above it, L * (2*2*BH*S^2*D -
    2*BH*S*D) for rank 0's BH; both sides show collectives (their bytes
    differ: GSPMD and DTensor choose other strategies). The decode cell
    runs without the hooks on both sides: the reference's split-d decode
    does not lower under this JAX (a reshape of its head-dim-sharded
    output is refused)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_CELLS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = {line.split()[1]: (float(line.split()[2]), float(line.split()[3]))
           for line in run.stdout.splitlines() if line.startswith("CELL")}
    print(run.stdout)
    cfg = t_smoke("h2o_danube_1p8b")
    mesh = make_mesh((2, 4), ("data", "model"))
    for kind in ("train", "prefill", "decode"):
        monkeypatch.setitem(SHAPES, "toy", ShapeConfig("toy", 64, 8, kind))
        lowered, _ = tdry.lower_cell(cfg, "toy", mesh, remat="none", ce_chunk=16,
                                     constraints=kind != "decode")
        cost = lowered.walk()
        tdry.reset_hooks()
        flops, coll = ref[kind]
        assert cost.total_collective_bytes > 0 and coll > 0
        if kind == "train":
            # rank 0's (batch x heads) rows: 8 / 2 data shards x the heads' shards
            heads = cfg.n_heads // 4 if cfg.n_heads % 4 == 0 else cfg.n_heads
            bh, s, d = (8 // 2) * heads, 64, cfg.hd
            assert cost.dot_flops - flops == cfg.n_layers * (2 * 2 * bh * s * s * d
                                                             - 2 * bh * s * d)
        else:
            assert cost.dot_flops == flops, kind


# ---------------- the hooks ----------------


def test_hooks_fire_under_the_reference_s_conditions(fake_group):
    """Full-size smollm-360m on 16 x 16: the batch reshard for train_4k (15
    heads do not divide 16, the 256 batch divides the mesh), sequence
    sharding for prefill_32k, split-d for decode_32k (5 KV heads do not
    divide 16, head dim 64 does); olmoe's train_4k pins the EP axis; no
    constraints, no hooks."""
    mesh = make_production_mesh()
    smol, olmoe = t_full("smollm_360m"), t_full("olmoe_1b_7b")
    assert tdry.set_hooks(smol, SHAPES["train_4k"], mesh) == ["attn_batch_sharding"]
    assert tlm._ATTN_BATCH_SHARD["spec"] == PartitionSpec(("data", "model"))
    assert tdry.set_hooks(smol, SHAPES["prefill_32k"], mesh) == ["attn_seq_sharding"]
    assert tlm._ATTN_SEQ_SHARD["mesh"] is mesh
    assert tdry.set_hooks(smol, SHAPES["decode_32k"], mesh) == ["decode_split_d"]
    assert tdry.set_hooks(olmoe, SHAPES["train_4k"], mesh) == ["moe_ep_axis"]
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        assert tdry.set_hooks(smol, SHAPES[shape], mesh, constraints=False) == []
    tdry.reset_hooks()
    assert (tlm._ATTN_BATCH_SHARD["spec"], tlm._ATTN_SEQ_SHARD["mesh"],
            tlm._DECODE_SPLIT_D["mesh"]) == (None, None, None)


def _qkv(seed, b, s, hq, hkv, d, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk or s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk or s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [0, 24])
def test_seq_sharded_prefill_equals_dense_attention(window):
    """``flash_attention_seq_sharded``'s local function applied shard by
    shard (each shard's query slice at its ``q_offset``) equals the port's
    dense flash attention and the reference's ``flash_attention``."""
    q, k, v = _qkv(0, 2, 64, 6, 2, 32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tp, local = 4, 64 // 4
    got = torch.cat([tops.flash_attention(tq[:, c * local:(c + 1) * local], tk, tv,
                                          window=window, q_offset=c * local)
                     for c in range(tp)], dim=1)
    dense = tattn.flash_attention(tq, tk, tv, window=window)
    ref = np.asarray(jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=True, window=window))
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("window", [0, 16])
def test_split_d_decode_equals_dense_decode_attention(window):
    """``decode_attention_split_d``'s local function shard by shard:
    partial scores over each head-dim slice, summed by hand (the
    all-reduce), then each shard's softmax and P V, concatenated over the
    head dim, equal the port's and the reference's ``decode_attention``."""
    q, k, v = _qkv(1, 3, 1, 10, 5, 64, sk=40)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    cl = torch.tensor(33)
    tp, dl = 4, 64 // 4
    parts = [slice(c * dl, (c + 1) * dl) for c in range(tp)]
    scores = sum(tattn.split_d_scores(tq[..., p], tk[..., p]) for p in parts)
    got = torch.cat([tattn.split_d_finish(scores, tv[..., p], cl, 64, window=window)
                     for p in parts], dim=-1)
    dense = tattn.decode_attention(tq, tk, tv, cl, window=window)
    ref = np.asarray(jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(33), window=window))
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_split_d_and_seq_sharded_attention_over_dtensors(fake_group):
    """On a fake 2 x 4 mesh: split-d decode keeps the head dim sharded and
    issues one all-reduce of rank 0's partial scores; the sequence-sharded
    prefill runs rank 0's query slice through ``flash_fwd`` with its
    offset (rank 0: 0)."""
    mesh = make_mesh((2, 4), ("data", "model"))
    d_pl = [Shard(0), Shard(3)]
    q = _meta_dt(mesh, (4, 1, 10, 64), d_pl)
    k = _meta_dt(mesh, (4, 40, 5, 64), d_pl)
    cost = oa.OpCost()
    with oa._Walk(cost):
        o = tattn.decode_attention_split_d(q, k, k, torch.tensor(33), mesh=mesh)
    assert (o.shape, o.placements) == ((4, 1, 10, 64), (Shard(0), Shard(3)))
    assert cost.collective_bytes == {"all-reduce": 2 * 5 * 2 * 40 * 4}
    q = _meta_dt(mesh, (4, 64, 6, 32), [Shard(0), Replicate()])
    kv = _meta_dt(mesh, (4, 64, 2, 32), [Shard(0), Replicate()])
    cost = oa.OpCost()
    with oa._Walk(cost):
        o = tattn.flash_attention_seq_sharded(q, kv, kv, mesh=mesh)
    assert (o.shape, o.placements) == ((4, 64, 6, 32), (Shard(0), Shard(1)))
    assert cost.kernel_launches == {"flash_fwd": 1}
    assert ("kernel:flash_fwd", "12x16x32 4x64x32 4x64x32") in cost.rows


# ---------------- the CLI ----------------


# the reference's run_cell record (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "status", "kind", "quant", "remat", "t_lower_s",
            "t_compile_s", "memory", "flops_per_dev", "hbm_bytes_per_dev",
            "coll_bytes_per_dev", "coll_breakdown", "model_flops", "t_compute_ms",
            "t_memory_ms", "t_collective_ms", "bottleneck", "useful_flops_ratio",
            "roofline_fraction"}


def test_cli_walks_a_production_cell(capsys, tmp_path, fake_group):
    """smollm-360m's decode_32k on 16 x 16 exits 0 with the reference's line
    shape and summary; its JSON record has the reference's keys (one
    ``t_walk_s`` for the two timings, plus ``hooks`` and
    ``replicated_ops``) and memory keys."""
    out = tmp_path / "r.jsonl"
    assert tdry.main(["--arch", "smollm_360m", "--shape", "decode_32k", "--json",
                      str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[dryrun] smollm_360m") and " 16x16 " in lines[0]
    assert " OK  walk " in lines[0] and "-> memory" in lines[0] and "decode_split_d" in lines[0]
    assert lines[-1] == "[dryrun] 1 OK, 0 skipped, 0 failed"
    rec = json.loads(out.read_text())
    assert set(rec) == REF_KEYS - {"t_lower_s", "t_compile_s"} | {
        "t_walk_s", "hooks", "replicated_ops"}
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "temp_size_in_bytes"}
    assert rec["hooks"] == ["decode_split_d"]
    assert all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
        "t_memory_ms", "t_collective_ms", "flops_per_dev", "hbm_bytes_per_dev"))


def test_cli_refuses_a_torch_older_than_it_was_run_on(capsys, monkeypatch):
    """Below the oldest release in ``TESTED_TORCH`` the CLI exits 2 and
    says which releases it was run on."""
    monkeypatch.setattr(torch, "__version__", "2.10.0+cpu")
    assert tdry.torch_release() == (2, 10)
    assert tdry.main(["--arch", "smollm_360m", "--shape", "decode_32k"]) == 2
    assert "older than the releases the dry run was run on (2.11, 2.13)" in capsys.readouterr().out


def test_cli_refusals_and_skips(capsys, monkeypatch, fake_group):
    assert tdry.main(["--arch", "no_such_arch"]) == 2
    assert "unknown arch" in capsys.readouterr().out
    # --attn-impl scan walks its cells (attention.flash_attention_scan) and
    # puts the switch back as it found it
    monkeypatch.setitem(SHAPES, "toy_scan", ShapeConfig("toy_scan", 128, 32, "prefill"))
    assert tdry.main(["--arch", "smollm_360m", "--shape", "toy_scan", "--attn-impl", "scan"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "[dryrun] 1 OK, 0 skipped, 0 failed"
    assert tattn._ATTN_IMPL["name"] == "fa2"
    assert tdry.main(["--arch", "smollm_360m", "--shape", "long_500k"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "[dryrun] 0 OK, 1 skipped, 0 failed"
    rec = tdry.run_cell("smollm_360m", "long_500k")
    why = jconfig.shape_applicable(j_full("smollm_360m"), jconfig.SHAPES["long_500k"])[1]
    assert rec == {"arch": "smollm_360m", "shape": "long_500k", "mesh": "16x16", "status": why}
    assert "not measured" in " ".join(tdry.build_parser().format_help().split())
