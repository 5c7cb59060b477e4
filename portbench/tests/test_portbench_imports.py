"""Nothing the benchmark runs loads JAX or the JAX package, by top-level
module name compared whole (``repro_torch`` begins with ``repro``), and the
reference loads nothing of the program."""

import ast
import subprocess
import sys

from conftest import HERE

from harness.cli import FORBIDDEN

RUN_TINY = """
import sys, json, torch
sys.path[:0] = [{here!r}, {src!r}, {tests!r}]
from conftest import tiny_cell
from harness.cli import run_cell, reader, load_cell
import tools.series, tools.control
cell = tiny_cell("smollm-360m-2bit.chat")
run_cell(cell, 3, 1.0, True, torch.device("cpu"), 0.0)
for m in cell.per_layer + cell.end_to_end:
    reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=600)
    return set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = top_level(RUN_TINY.format(here=str(HERE), src=str(HERE.parent / "src"),
                                      tests=str(HERE / "tests")))
    assert "repro_torch" in names  # the program is what runs
    assert not names & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys, json; sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent / 'src')!r}]\n"
            "import reference.lm, reference.quant, work.flops, work.peaks\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    names = top_level(code)
    assert not names & (set(FORBIDDEN) | {"repro_torch", "harness"})


def test_reference_sources_import_no_program():
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in set(FORBIDDEN) | {"repro_torch"}, (path, m)
