"""The port has every module of the reference, and every public top-level
name of each, but those it does not port for a stated reason.

Both packages are read as source (``ast``), so nothing is imported."""

import ast
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# module -> names it keeps to itself, or None for the whole module
NOT_PORTED = {
    "compat.py": None,  # jax and Pallas shims only
    "models/flash.py": None,  # the flash kernel's jnp twin; the port's is kernels/ref.py
    "perf/hlo_analysis.py": None,  # reads XLA's HLO; the port's walk is perf/op_analysis.py
    "testing/__init__.py": None,  # the tests' hypothesis stub, which the port's tests use
    "testing/hypothesis_stub.py": None,
    # the TPU records: GpuChip, H100_SXM and GPU_TIERS take their place
    "core/resource_model.py": {"TPU_V4", "TPU_V5E", "TPU_V5P", "TpuChip"},
    # the Pallas kernel's mask constant: the port's is kernels/ref.NEG_INF
    "kernels/flash_attention.py": {"NEG_INF"},
    # the dense-softmax oracle only the reference's kernel tests call
    "kernels/ref.py": {"flash_attention_ref"},
    # the port's Scheduler builds the budgeted step itself
    "runtime/residency/executor.py": {"cached_budgeted_step", "make_budgeted_paged_serve_step"},
}


def _public_names(root: str) -> dict[str, set[str]]:
    """{module path: its public top-level functions, classes and names}."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                body = ast.parse(fh.read()).body
            names = {n.name for n in body if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
            names |= {t.id for n in body if isinstance(n, ast.Assign) for t in n.targets
                      if isinstance(t, ast.Name)}
            out[os.path.relpath(path, root)] = {n for n in names if not n.startswith("_")}
    return out


def test_every_module_and_public_name_of_the_reference_has_a_counterpart():
    ref = _public_names(os.path.join(ROOT, "src", "repro"))
    port = _public_names(os.path.join(ROOT, "src", "repro_torch"))
    missing = {}
    for module, names in sorted(ref.items()):
        kept = NOT_PORTED.get(module, set())
        if kept is None:
            continue
        gap = names - port.get(module, set()) - kept
        if module not in port or gap:
            missing[module] = sorted(gap) if module in port else "no module"
    assert missing == {}
    # each exemption still names something the reference has
    for module, kept in NOT_PORTED.items():
        assert module in ref and (kept is None or kept <= ref[module]), module
