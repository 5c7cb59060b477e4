"""The port's import boundary: nothing under ``src/repro_torch`` and nothing
in ``chip_smoke.py`` imports ``jax`` or any module of ``repro``."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_port_file_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = [
        f"{path.name}:{line} imports {name}"
        for line, name in _imported_roots(ast.parse(path.read_text()))
        if name.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_boundary_check_catches_forbidden_imports():
    src = "import jax.numpy\nfrom repro.models import lm\nimport repro_torch\n"
    names = [n for _, n in _imported_roots(ast.parse(src))]
    assert [n.split(".")[0] in FORBIDDEN for n in names] == [True, True, False]


def test_boundary_covers_every_family_s_modules():
    """The walk takes the enc-dec module and the last two configs ported,
    beside the rest of the package."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("src/repro_torch/models/encdec.py",
                 "src/repro_torch/configs/internvl2_76b.py",
                 "src/repro_torch/configs/whisper_tiny.py",
                 "src/repro_torch/models/lm.py", "chip_smoke.py"):
        assert name in files, name


def test_boundary_covers_the_fleet_modules():
    """The walk takes the fleet's modules: the cluster package, its CLI
    and the H100 record its cost model reads."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("traffic", "engine", "router", "disagg", "__init__"):
        assert f"src/repro_torch/runtime/cluster/{name}.py" in files, name
    for name in ("src/repro_torch/launch/fleet.py", "src/repro_torch/perf/roofline.py"):
        assert name in files, name


def test_boundary_covers_the_analysis_modules():
    """The walk takes the port planner, the sharding policy and the op
    walk: the modules that plan where a model fits and what bounds it."""
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    for name in ("mesh_axes", "legalize", "rules", "sharding", "placement", "__init__"):
        assert f"src/repro_torch/dist/{name}.py" in files, name
    for name in ("launch/port.py", "perf/op_analysis.py", "perf/roofline.py"):
        assert f"src/repro_torch/{name}" in files, name


@pytest.mark.parametrize(
    "path", sorted((ROOT / "src" / "repro_torch" / "kernels").glob("*.py")),
    ids=lambda p: p.name,
)
def test_kernels_import_nothing_of_the_layers_above(path):
    """The kernels layer is the bottom of the port: the op walk reads the
    wrappers' reports through ``kernels._build``, and no kernel module
    imports ``perf`` (or anything else above it)."""
    above = ("repro_torch.perf", "repro_torch.runtime", "repro_torch.models",
             "repro_torch.launch", "repro_torch.dist")
    bad = [f"{path.name}:{line} imports {name}"
           for line, name in _imported_roots(ast.parse(path.read_text()))
           if name.startswith(above)]
    assert not bad, bad
