"""The benchmark's own tests: on the CPU, at tiny sizes, except those
marked ``card``, which run a cell on a CUDA device and skip without one.

    python -m pytest -q portbench/tests
"""

import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128, vocab_size=512)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: runs a cell on a CUDA device (skipped without one)")


@pytest.fixture
def card():
    """A CUDA device, or a skip: decided here, when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run these on the chip machine")
    return torch.device("cuda", 0)


def tiny_cell(name: str, lanes: int = 4, docs: int = 4):
    """A cell of the manifest at a size the CPU runs in seconds: the
    configuration's widths cut to ``TINY``, ``lanes`` lanes, and at most
    ``docs`` documents; every other setting as the cell has it."""
    from harness.cli import load_cell

    cell = copy.deepcopy(load_cell(name))
    cell.config.update(TINY)
    if cell.config.get("num_experts"):
        cell.config.update(num_experts=8, num_experts_per_tok=2)
    cell.config["engine"] = dict(cell.config["engine"], lanes=lanes)
    if cell.mix.get("documents"):
        cell.mix["documents"]["count"] = min(docs, cell.mix["documents"]["count"])
    return cell
