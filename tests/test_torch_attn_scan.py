"""Port parity for the attention A/B switch: ``attention.flash_attention_scan``
(the reference's scan-of-scans online softmax, in plain torch),
``set_attn_impl`` and the dry run's ``--attn-impl scan``.

The scan against the reference's over causal, window, GQA, not-causal,
ragged-divisor, device ``q_offset``, fully masked block and bf16 cases, and
its gradient against ``jax.grad`` of the reference's; the switch through
``lm.prefill`` and ``lm.loss_fn`` against the reference under the same
switch, read only where the reference reads it (the paged chunk paths stay
on the kernel); and a toy scan cell's per-device dot flops against the
reference's own dry run at ``--attn-impl scan``, in a child process with 8
forced host devices. No test touches a network or a GPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 on both sides: only the einsums' summation order differs, on O(1) values
SCAN_ATOL = 2e-6
# bf16 inputs: both round P to bf16 before PV and the output to bf16 once;
# a last-place flip of the output is 2^-8 of it, at |out| < 4: 2 steps
SCAN_BF16_ATOL = 3e-2
GRAD_ATOL = 1e-5  # f32 gradients of O(1) values, summation order only
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5  # tests/test_torch_lm.py's, f32 smoke configs

# (b, sq, sk, hq, hkv, d, causal, window, q_block, kv_block, q_offset)
SCAN_CASES = {
    "causal": (2, 24, 24, 4, 2, 8, True, 0, 8, 16, 0),
    "window": (1, 30, 30, 6, 2, 8, True, 7, 6, 10, 0),
    "gqa_not_causal": (1, 16, 20, 8, 2, 8, False, 0, 8, 8, 0),
    # 21 and 35 have no divisor near 8 / 16: blocks of 7
    "ragged_divisor": (2, 21, 35, 4, 1, 8, True, 0, 8, 16, 14),
    "device_q_offset": (2, 12, 36, 4, 4, 8, True, 0, 4, 12, 24),
    # a 4-wide window over 8-key blocks: whole (q block, kv block) pairs masked
    "fully_masked_block": (1, 32, 32, 2, 1, 8, True, 4, 8, 8, 0),
}


def _qkv(case, dtype=np.float32, seed=0):
    b, sq, sk, hq, hkv, d = SCAN_CASES[case][:6]
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d)))


def _kw(case):
    causal, window, q_block, kv_block, q_offset = SCAN_CASES[case][6:]
    return dict(causal=causal, window=window, q_block=q_block, kv_block=kv_block), q_offset


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_scan_matches_the_reference_scan(case):
    """f32 within SCAN_ATOL; the device q_offset case passes the offset as
    a one-element int32 tensor (the others as ints)."""
    q, k, v = _qkv(case)
    kw, off = _kw(case)
    want = jattn.flash_attention_scan(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      q_offset=off, **kw)
    t_off = torch.tensor([off], dtype=torch.int32) if case == "device_q_offset" else off
    got = tattn.flash_attention_scan(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), q_offset=t_off, **kw)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=SCAN_ATOL)


def test_scan_in_bf16_matches_the_reference_scan():
    """bf16 q/k/v (the model's dtype): P rounded to bf16 before PV as the
    reference rounds it; within SCAN_BF16_ATOL."""
    q, k, v = _qkv("window")
    kw, _ = _kw("window")
    want = jattn.flash_attention_scan(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), **kw)
    got = tattn.flash_attention_scan(*(torch.from_numpy(a).to(torch.bfloat16)
                                       for a in (q, k, v)), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0,
                               atol=SCAN_BF16_ATOL)


@pytest.mark.parametrize("case", ["causal", "window", "gqa_not_causal", "fully_masked_block"])
def test_scan_gradient_matches_jax_grad(case):
    """d/d(q, k, v) of sum(scan(q, k, v) * w) by autograd against
    ``jax.grad`` of the reference's scan, within GRAD_ATOL."""
    q, k, v = _qkv(case)
    kw, off = _kw(case)
    w = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def j_loss(q, k, v):
        return jnp.sum(jattn.flash_attention_scan(q, k, v, q_offset=off, **kw) * w)

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tattn.flash_attention_scan(*ts, q_offset=off, **kw) * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0, atol=GRAD_ATOL)


def test_set_attn_impl_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="'fa2' or 'scan'"):
        tattn.set_attn_impl("flash3")
    assert tattn._ATTN_IMPL["name"] == "fa2"


# ---------------- the switch through the model ----------------


@pytest.fixture
def scan_on_both_sides():
    """``set_attn_impl("scan")`` in both packages, put back after."""
    jattn.set_attn_impl("scan")
    tattn.set_attn_impl("scan")
    yield
    jattn.set_attn_impl("fa2")
    tattn.set_attn_impl("fa2")


@pytest.fixture
def scan_calls(monkeypatch):
    """Counts the port's calls of ``flash_attention_scan``."""
    calls = []
    real = tattn.flash_attention_scan

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tattn, "flash_attention_scan", counted)
    return calls


def _weights(arch):
    jc, tc = j_smoke(arch), t_smoke(arch)
    jp = jlm.init_params(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jc, tc, jp, params_from_reference(tree, tc, device="cpu", trainable=True)


def _tokens(vocab, b=2, s=16, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", ["smollm_360m", "h2o_danube_1p8b"])
def test_prefill_under_scan_matches_the_reference_under_scan(arch, scan_on_both_sides,
                                                             scan_calls):
    """``lm.prefill``'s logits under ``set_attn_impl("scan")`` on both sides
    (h2o-danube: its sliding window), within test_torch_lm's tolerances;
    the port took the scan once a layer."""
    jc, tc, jp, params = _weights(arch)
    tokens = _tokens(jc.vocab)
    want = jlm.prefill(jp, jc, jnp.asarray(tokens))
    with torch.no_grad():
        got = tlm.prefill(params, tc, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert len(scan_calls) == tc.n_layers


def test_loss_and_gradients_under_scan_match_the_reference(scan_on_both_sides, scan_calls):
    """``lm.loss_fn`` and its gradients under the scan on both sides,
    within test_torch_lm's tolerances (gradients: atol 1e-5 of O(1e-2)
    leaves, summation order only)."""
    jc, tc, jp, params = _weights("smollm_360m")
    tokens, labels = _tokens(jc.vocab), _tokens(jc.vocab, seed=4)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jc, jnp.asarray(tokens), jnp.asarray(labels)),
        has_aux=True)(jp)
    loss, _ = tlm.loss_fn(params, tc, torch.from_numpy(tokens), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=MODEL_RTOL)
    assert len(scan_calls) == tc.n_layers
    tree = params.tree()
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_allclose(tree["layers"][name].grad.numpy(),
                                   np.asarray(jg["layers"][name]), rtol=MODEL_RTOL,
                                   atol=GRAD_ATOL)


def _chunk_inputs(tc, seed=5):
    rng = np.random.default_rng(seed)
    rows = 40
    pk, pv = (torch.from_numpy((0.5 * rng.standard_normal(
        (tc.n_layers, rows, tc.n_kv, tc.hd))).astype(np.float32)) for _ in range(2))
    table = torch.arange(4, 4 + 32, dtype=torch.int32)[None]
    tokens = torch.from_numpy(_tokens(tc.vocab, b=1, s=8, seed=seed))
    return tokens, pk, pv, table, table[:, 6:14]


def test_the_chunk_paths_stay_on_the_kernel_under_scan(scan_calls):
    """The paged chunk paths (``prefill_chunk_paged``, the hybrid's
    ``prefill_suffix_paged_hybrid``) run the kernel's path under either
    switch, the same bits, and never the scan: the reference's counterparts
    attend with their own dense ``chunk_attention``."""
    _, tc, _, params = _weights("smollm_360m")
    _, hc, _, hparams = _weights("zamba2_2p7b")
    runs = {}
    for impl in ("fa2", "scan"):
        tattn.set_attn_impl(impl)
        try:
            with torch.no_grad():
                tokens, pk, pv, table, wr = _chunk_inputs(tc)
                lg, _, _ = tlm.prefill_chunk_paged(params, tc, tokens, pk, pv, table, wr,
                                                   torch.tensor([6]), 7)
                htok, hk, hv, htab, hwr = _chunk_inputs(hc)
                hk, hv = hk[: hc.n_kv_cache_layers], hv[: hc.n_kv_cache_layers]
                lane = {k: torch.zeros_like(v) for k, v in
                        tlm.init_ssm_lane_state(hc, 1, device="cpu").items()}
                hlg, _, _, _ = tlm.prefill_suffix_paged_hybrid(
                    hparams, hc, htok, hk, hv, htab, hwr, torch.tensor([6]), 7, lane)
        finally:
            tattn.set_attn_impl("fa2")
        runs[impl] = (lg, pk, hlg, hk)
    assert not scan_calls
    for a, b in zip(runs["fa2"], runs["scan"]):
        assert torch.equal(a, b)


def test_cross_attention_takes_the_switch(scan_calls):
    """The enc-dec's cross-attention reads the switch, as the reference's
    ``encdec.py`` does: whisper-tiny's smoke trunk under scan calls it once
    a decoder layer (the encoder's self-attention too, through lm's block)."""
    from repro_torch.models import encdec

    tc = t_smoke("whisper_tiny")
    params = tlm.init_params(tc, 0, device="cpu")
    frames = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, tc.frontend_len, tc.d_model)).astype(np.float32))
    tokens = torch.from_numpy(_tokens(tc.vocab, b=1, s=8))
    tattn.set_attn_impl("scan")
    try:
        with torch.no_grad():
            scan, _ = encdec.forward(params, tc, tokens, frames)
    finally:
        tattn.set_attn_impl("fa2")
    with torch.no_grad():
        fa2, _ = encdec.forward(params, tc, tokens, frames)
    assert len(scan_calls) == tc.n_enc_layers + 2 * tc.n_layers
    np.testing.assert_allclose(scan.numpy(), fa2.numpy(), rtol=MODEL_RTOL, atol=MODEL_ATOL)


# ---------------- the dry run at --attn-impl scan ----------------


REF_SCAN_CELLS = """
    import jax
    from repro.configs import get_smoke_config
    from repro.launch.dryrun import lower_cell
    from repro.models.attention import set_attn_impl
    from repro.models.config import SHAPES, ShapeConfig
    from repro.perf.roofline import roofline
    set_attn_impl("scan")
    cfg = get_smoke_config("h2o_danube_1p8b")
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    for kind in ("train", "prefill"):
        SHAPES["toy"] = ShapeConfig("toy", 64, 8, kind)
        lowered, _ = lower_cell(cfg, "toy", mesh, remat="none", ce_chunk=16)
        rl = roofline("toy", lowered.compile(), cfg, SHAPES["toy"], mesh.size)
        print("CELL", kind, rl.flops)
"""


@pytest.fixture(scope="module")
def reference_scan_cells():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SCAN_CELLS)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return {line.split()[1]: float(line.split()[2])
            for line in run.stdout.splitlines() if line.startswith("CELL")}


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_scan_cell_dot_flops_equal_the_reference_dry_run(kind, reference_scan_cells,
                                                         monkeypatch):
    """h2o-danube's smoke config (a sliding window) on a fake (2, 4) mesh,
    toy train and prefill cells under the scan on both sides: the
    per-device dot flops are equal. (Under fa2 the port's train cell reads
    the two-pass backward's recomputed products above the reference's;
    the scan's backward is autograd's of the same products on both sides.)"""
    cfg = t_smoke("h2o_danube_1p8b")
    monkeypatch.setitem(SHAPES, "toy", ShapeConfig("toy", 64, 8, kind))
    tattn.set_attn_impl("scan")
    try:
        lowered, _ = tdry.lower_cell(cfg, "toy", make_mesh((2, 4), ("data", "model")),
                                     remat="none", ce_chunk=16)
        cost = lowered.walk()
    finally:
        tdry.reset_hooks()
        tattn.set_attn_impl("fa2")
        if dist.is_initialized():
            dist.destroy_process_group()
    assert cost.dot_flops == reference_scan_cells[kind]
