"""The check that decides ``correct``, driven through the rest of a run on
the CPU at a tiny size (the chip's look skipped): a sound run passes; a run
whose timed path is broken underneath fails, once for each fault a served
cell on one chip can have; the float8 control reads above the limit.

The limit here is the tiny size's own, between its sound reading and its
control's; the cells' limits are in ``portbench/cells/``, set from chip
runs at the cells' sizes.
"""

import numpy as np
import pytest
import torch
from conftest import tiny_cell

import repro_torch.runtime.scheduler as scheduler_mod
from harness.cli import run_cell, verdict

TINY_LIMIT = 0.03
SEED = 2**31 + 99
WINDOW_S = 5.0
# the chat cells, and the dense one under documents from the cache (the
# generator's shared-document path, which no cell sends yet)
CELLS = ["smollm-360m-2bit.chat", "olmoe-1b-7b.chat", "smollm-360m-2bit.chat+docs"]
DOCS = {"count": 4, "tokens": 96, "zipf": 1.0}


def run(name, control=False):
    cell = tiny_cell(name.split("+")[0])
    if cell.config.get("num_experts"):
        # in bfloat16, 2 of 8 tiny experts' near ties route apart from the
        # float32 reference: a float32 program leaves the check's own faults
        cell.config["torch_dtype"] = "float32"
    if name.endswith("+docs"):
        cell.mix = dict(cell.mix, documents=DOCS, prompt={"dist": "uniform", "min": 8, "max": 40},
                        output={"dist": "uniform", "min": 8, "max": 24})
    else:
        # prompts past one 512-token chunk now and then, outputs short: the
        # window completes enough requests for the check on a loaded CPU
        cell.mix = dict(cell.mix, prompt={"dist": "uniform", "min": 16, "max": 640},
                        output={"dist": "uniform", "min": 8, "max": 40})
    cell.limits = {"max_logit_gap": {"limit": TINY_LIMIT}, "tokens_compared": {"min": 64}}
    out = run_cell(cell, SEED, WINDOW_S, False, torch.device("cpu"), 0.0, control=control)
    return verdict(cell, out["gaps"])[0], out["gaps"]


def state_unchanged(real):
    """The decode step runs on copies of the pool: the state it should
    write is left as it was."""
    def make(cfg):
        step = real(cfg)
        return lambda params, token, pk, pv, *rest: step(params, token, pk.clone(), pv.clone(), *rest)
    return make


def half_batch(real):
    """The decode step computes the first half of its lanes and hands
    their logits to the other half too."""
    def make(cfg):
        step = real(cfg)

        def half(params, token, pk, pv, table, lengths, *rest):
            h = token.shape[0] // 2
            logits, *more = step(params, token[:h], pk, pv, table[:h], lengths[:h], *rest)
            return (torch.cat([logits, logits]), *more)
        return half
    return make


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_control_is_not(name):
    ok, gaps = run(name, control=True)
    assert ok, gaps
    assert gaps["max_logit_gap"] <= TINY_LIMIT < gaps["control_max_logit_gap"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
def test_fault_is_caught(name, fault, monkeypatch):
    if fault == "token_altered":
        real = scheduler_mod.sample_logits
        calls = [0]

        def altered(row, sp, rng=None):
            calls[0] += 1
            tok = real(row, sp, rng)
            return (tok + 1) % len(row) if calls[0] % 5 == 0 else tok
        monkeypatch.setattr(scheduler_mod, "sample_logits", altered)
    else:
        wrap = {"state_unchanged": state_unchanged, "half_batch": half_batch}[fault]
        monkeypatch.setattr(scheduler_mod, "make_paged_serve_step",
                            wrap(scheduler_mod.make_paged_serve_step))
    ok, gaps = run(name)
    assert not ok, gaps
    # caught by the gap itself, not only by too few tokens compared
    assert np.isfinite(gaps["max_logit_gap"]) and gaps["max_logit_gap"] > TINY_LIMIT, gaps
