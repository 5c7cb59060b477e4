"""Port parity for the mesh-sharding policy (``dist/*``), the fleet's
engine placement, the assigned input shapes and ``lm.abstract_params``:
every spec leaf for leaf against ``repro.dist`` on the meshes the
reference's policy tests use, all archs at full size, with no device
touched. Specs compare as tuples."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as j_full  # noqa: E402
from repro.dist import legalize as jlegal  # noqa: E402
from repro.dist import placement as jplace  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.dist.mesh_axes import MeshView as JView  # noqa: E402
from repro.launch import fleet as jfleet  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config as t_full  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.dist import legalize as tlegal  # noqa: E402
from repro_torch.dist import placement as tplace  # noqa: E402
from repro_torch.dist import sharding as tshd  # noqa: E402
from repro_torch.dist.legalize import PartitionSpec  # noqa: E402
from repro_torch.dist.mesh_axes import MeshView  # noqa: E402
from repro_torch.launch import fleet as tfleet  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402


class FakeMesh:
    """Only what the policy is allowed to read: axis_names + shape."""

    def __init__(self, **shape: int):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


# tests/test_sharding_policy.py's two production meshes, and two of
# tests/test_dist_policy_properties.py's
MESHES = {
    "16x16": FakeMesh(data=16, model=16),
    "2x16x16": FakeMesh(pod=2, data=16, model=16),
    "8x4": FakeMesh(data=8, model=4),
    "4x4x4": FakeMesh(pod=4, data=4, model=4),
}


def _j_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec) for path, spec in flat}


def _t_specs(tree) -> dict:
    return {path: tuple(spec) for path, spec in tshd.leaves_with_paths(tree)}


@pytest.mark.parametrize("mesh", list(MESHES), ids=list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_sharding_policy_matches_reference(arch, mesh):
    """param_specs leaf for leaf, sharded_byte_fraction, batch_specs,
    token_spec and cache_specs at the reference's shapes cells."""
    jc, tc, m = j_full(arch), t_full(arch), MESHES[mesh]
    got = _t_specs(tshd.param_specs(tc, m))
    assert got == _j_specs(jshd.param_specs(jc, m))
    assert tshd.sharded_byte_fraction(tc, m) == jshd.sharded_byte_fraction(jc, m)
    for shape in jconfig.SHAPES.values():
        b = shape.global_batch
        assert {k: tuple(v) for k, v in tshd.batch_specs(tc, m, b).items()} == {
            k: tuple(v) for k, v in jshd.batch_specs(jc, m, b).items()}
        assert tuple(tshd.token_spec(tc, m, b)) == tuple(jshd.token_spec(jc, m, b))
    for batch, seq in ((128, 32_768), (1, 4096), (24, 1000)):
        got = {k: tuple(v) for k, v in tshd.cache_specs(tc, m, batch, seq).items()}
        want = {k: tuple(v) for k, v in jshd.cache_specs(jc, m, batch, seq).items()}
        assert got == want


@pytest.mark.parametrize("arch", ["smollm_360m", "zamba2_2p7b", "whisper_tiny"])
def test_packed_leaves_take_their_parent_weight_s_spec(arch):
    """At w_bits 2 a carrier shards like the weight it encodes (a tensor
    axis of the packed dim when it divides) and its scale replicates, as
    in the reference."""
    jc = dataclasses.replace(j_full(arch), w_bits=2)
    tc = dataclasses.replace(t_full(arch), w_bits=2)
    m = MESHES["2x16x16"]
    got = _t_specs(tshd.param_specs(tc, m))
    assert got == _j_specs(jshd.param_specs(jc, m))
    packed = [p for p in got if p[-1] == "packed"]
    assert packed and all(got[p[:-1] + ("scale",)] == (None,) * len(got[p[:-1] + ("scale",)])
                          for p in packed)
    assert tshd.sharded_byte_fraction(tc, m) == jshd.sharded_byte_fraction(jc, m)


def test_every_full_size_spec_validates_on_the_production_meshes():
    """Legal, region-pure specs for every leaf, and >= 85% of the bytes
    tensor-sharded (the reference's effectiveness bound)."""
    for arch in ARCH_IDS:
        cfg = t_full(arch)
        for name in ("16x16", "2x16x16"):
            mv = MeshView.of(MESHES[name])
            abstract = dict(tshd.leaves_with_paths(tlm.abstract_params(cfg).tree()))
            for path, spec in tshd.leaves_with_paths(tshd.param_specs(cfg, mv)):
                tlegal.validate_spec(tuple(abstract[path].shape), spec, mv)
            assert tshd.sharded_byte_fraction(cfg, mv) > 0.85


def test_legalize_helpers_match_reference():
    mv, jv = MeshView.of(MESHES["2x16x16"]), JView.of(MESHES["2x16x16"])
    for size in (1, 16, 32, 48, 512):
        axes = ("pod", "data")
        assert tlegal.largest_dividing_suffix(mv, axes, size) == \
            jlegal.largest_dividing_suffix(jv, axes, size)
        assert tlegal.divides(size, mv, axes) == jlegal.divides(size, jv, axes)
    cands = [(-1, ("model",)), (0, ("model", "nope")), (5, ("model",))]
    for shape in ((48, 96), (49, 33), (3,)):
        assert tlegal.first_legal(shape, cands, mv) == jlegal.first_legal(shape, cands, jv)
        hit = tlegal.first_legal(shape, cands, mv)
        assert tuple(tlegal.spec_from_placements(shape, [hit] if hit else [])) == tuple(
            jlegal.spec_from_placements(shape, [hit] if hit else []))
    for bad in (PartitionSpec(("data", "model")), PartitionSpec("model", "model"),
                PartitionSpec("x"), PartitionSpec(None, "pod"), PartitionSpec(None, None, None)):
        with pytest.raises(ValueError):
            tlegal.validate_spec((32, 3), bad, mv)
        with pytest.raises(ValueError):
            jlegal.validate_spec((32, 3), JP(*bad), jv)
    spec = PartitionSpec(None, ("pod", "data"), "model")
    assert spec == (None, ("pod", "data"), "model") and tuple(JP(*spec)) == tuple(spec)
    assert repr(spec) == "PartitionSpec(None, ('pod', 'data'), 'model')"


def test_mesh_view_reads_a_device_mesh_on_a_fake_process_group():
    """A ``DeviceMesh`` over a fake 512-rank group (no device, no network):
    its names and sizes, and the policy run over it, equal the fake's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        mesh = init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
        mv = MeshView.of(mesh)
        assert mv == MeshView(("pod", "data", "model"), (2, 16, 16))
        assert (mv.tensor_axes, mv.batch_axes, mv.tp_size, mv.dp_size) == (
            ("model",), ("pod", "data"), 16, 32)
        cfg = t_full("llama3p2_1b")
        assert _t_specs(tshd.param_specs(cfg, mesh)) == _t_specs(
            tshd.param_specs(cfg, MESHES["2x16x16"]))
    finally:
        dist.destroy_process_group()


# ---------------- fleet placement ----------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "8x4"])
def test_plan_engine_placement_matches_reference(mesh, n):
    m = MESHES[mesh]
    try:
        want = [(p.engine_id, p.axis, p.lo, p.hi, p.view.axis_names, p.view.sizes, p.devices,
                 p.describe()) for p in jplace.plan_engine_placement(m, n)]
    except ValueError as e:
        with pytest.raises(ValueError, match="divide no batch axis") as got:
            tplace.plan_engine_placement(m, n)
        assert str(got.value) == str(e)
        return
    got = [(p.engine_id, p.axis, p.lo, p.hi, p.view.axis_names, p.view.sizes, p.devices,
            p.describe()) for p in tplace.plan_engine_placement(m, n)]
    assert got == want


def _placement_lines(text: str) -> list[str]:
    return [line for line in text.splitlines()
            if line.startswith(("[fleet] engine ", "[fleet] placement"))]


@pytest.mark.parametrize("mode,engines", [("single", 1), ("fleet", 2), ("fleet", 3),
                                          ("disagg", 4)])
def test_fleet_cli_prints_the_reference_placement_lines(mode, engines, capsys):
    """``launch.fleet`` prints each engine's placement over the 16x16 view
    as the reference's CLI does; 3 engines divide no axis: the reason."""
    argv = ["--smoke", "--mode", mode, "--engines", str(engines), "--requests", "2"]
    assert tfleet.main(argv + ["--device", "cpu"]) == 0
    got = _placement_lines(capsys.readouterr().out)
    assert jfleet.main(argv) == 0
    want = _placement_lines(capsys.readouterr().out)
    assert got == want and len(got) == (1 if engines == 3 else engines)
    if engines == 3:
        assert "divide no batch axis" in got[0]


# ---------------- shapes and abstract parameters ----------------


def test_shapes_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert [s.tokens for s in tconfig.SHAPES.values()] == [
        s.tokens for s in jconfig.SHAPES.values()]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_matches_reference(arch):
    jc, tc = j_full(arch), t_full(arch)
    assert tc.supports_long_context == jc.supports_long_context
    for name in jconfig.SHAPES:
        assert tconfig.shape_applicable(tc, tconfig.SHAPES[name]) == jconfig.shape_applicable(
            jc, jconfig.SHAPES[name])


@pytest.mark.parametrize("w_bits", [0, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match_reference(arch, w_bits):
    """Every leaf's shape and dtype equal the reference's ``jax.eval_shape``
    tree at full size, on ``meta`` (no storage, no draw)."""
    jc = dataclasses.replace(j_full(arch), w_bits=w_bits)
    tc = dataclasses.replace(t_full(arch), w_bits=w_bits)
    want = {
        tuple(str(getattr(k, "key", k)) for k in path): (tuple(leaf.shape), str(leaf.dtype))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jlm.abstract_params(jc))[0]
    }
    leaves = dict(tshd.leaves_with_paths(tlm.abstract_params(tc).tree()))
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for path, t in
           leaves.items()}
    assert got == want
    assert all(t.device.type == "meta" for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) == sum(
        int(np.prod(s)) for s, _ in want.values())


@pytest.mark.parametrize("w_bits", [0, 2])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_are_init_params_without_values(arch, w_bits):
    """``abstract_params`` is the port's own ``init_params`` tree, leaf for
    leaf in order, in shape and dtype: the smoke configs drawn on the CPU,
    the packed carriers included."""
    tc = dataclasses.replace(t_smoke(arch), w_bits=w_bits)
    drawn = tshd.leaves_with_paths(tlm.init_params(tc, device="cpu").tree())
    abstract = tshd.leaves_with_paths(tlm.abstract_params(tc).tree())
    assert [(p, tuple(t.shape), t.dtype) for p, t in abstract] == [
        (p, tuple(t.shape), t.dtype) for p, t in drawn]
