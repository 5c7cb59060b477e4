"""Port parity for the paper's CNN path: quantizers, streamlining, im2col,
``conv_as_mvau`` and the full CNV forward against ``repro.models.cnn`` and
``repro.quant`` on the CPU, with the reference's weights carried over by
``interop.cnn_params_from_reference`` and inputs made with numpy."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import cnn as jcnn  # noqa: E402
from repro.quant import quantizers as jq  # noqa: E402
from repro.quant import streamline as jst  # noqa: E402
from repro_torch.interop import cnn_params_from_reference  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.quant import quantizers as tq  # noqa: E402
from repro_torch.quant import streamline as tst  # noqa: E402


def _np(a):
    return np.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_params(specs, seed=0, bn_seed=1):
    """The reference's CNN parameters with randomised BN statistics (as
    ``tests/test_system.py`` does) and some negative gammas, as numpy."""
    params = jax.tree.map(np.asarray, jcnn.init_cnn_params(specs, jax.random.key(seed)))
    rng = np.random.default_rng(bn_seed)
    for sp in specs:
        p = params[sp.name]
        p["bn_mu"] = (rng.normal(size=sp.c_out) * 0.2).astype(np.float32)
        p["bn_var"] = (rng.uniform(size=sp.c_out) * 2.0 + 0.1).astype(np.float32)
        p["bn_gamma"] = rng.choice([-1.0, 1.0], size=sp.c_out, p=[0.25, 0.75]).astype(
            np.float32) * rng.uniform(0.5, 1.5, size=sp.c_out).astype(np.float32)
        p["bn_beta"] = (rng.normal(size=sp.c_out) * 0.1).astype(np.float32)
    return params


def _jspec_to_np(spec):
    return dict(thresholds=_np(spec.thresholds), signs=_np(spec.signs),
                offset=spec.offset, scale=_np(spec.scale))


def _tspec_from_j(spec):
    return tst.ThresholdSpec(_t(spec.thresholds), _t(spec.signs), spec.offset, _t(spec.scale))


@pytest.mark.parametrize("kind", ["binary", "ternary", "int8", "int4"])
def test_weight_quantizers_match_reference(kind):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    w[0, 0, 0, :4] = 0.0  # binary maps 0 to +1
    fj, ft = {
        "binary": (jq.binary_weight, tq.binary_weight),
        "ternary": (jq.ternary_weight, tq.ternary_weight),
        "int8": (lambda a: jq.int_weight(a, 8), lambda a: tq.int_weight(a, 8)),
        "int4": (lambda a: jq.quantize_weight(a, 4), lambda a: tq.quantize_weight(a, 4)),
    }[kind]
    want, got = _np(fj(jnp.asarray(w))), ft(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    if kind == "binary":
        assert (got[0, 0, 0, :4] > 0).all()


@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (2, False)])
def test_int_act_matches_reference(bits, signed):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(4, 64)) * 2).astype(np.float32)
    x[0, :6] = [0.5, 1.5, -0.5, -1.5, 2.5, -2.5]  # halves: both round to even
    scale = float(_np(jq.init_act_scale(bits)))
    want = _np(jq.int_act(jnp.asarray(x), jnp.float32(scale), bits, signed))
    got = tq.int_act(torch.from_numpy(x), tq.init_act_scale(bits), bits, signed)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    halves = tq.int_act(torch.tensor([0.5, 1.5, -0.5, 2.5]), torch.tensor(1.0), 4)
    assert halves.tolist() == [0.0, 2.0, -0.0, 2.0]


def test_lsq_gradient_is_the_reference_custom_vjp():
    """The Esser et al. backward of the reference's ``custom_vjp`` (2-bit
    signed: qn 2, qp 1): dx passes only inside [-2, 1], ds sums
    g * (inside ? q - v : q) / sqrt(n * qp). Plain autograd through
    ``round`` gave dx 0 and ds 11 here."""
    x = np.linspace(-3.0, 3.0, 7).astype(np.float32)
    g = np.arange(7.0, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.tensor(1.0, requires_grad=True)
    tq.int_act(xt, st, 2).backward(torch.from_numpy(g))
    assert xt.grad.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 0.0, 0.0]
    np.testing.assert_allclose(st.grad.item(), 4.1576, atol=1e-4)
    assert st.grad.shape == st.shape


@pytest.mark.parametrize("bits,signed", [(2, True), (4, True), (2, False)])
def test_int_act_gradients_match_reference(bits, signed):
    """dx and ds of ``int_act`` against jax.grad of the reference's, on
    inputs that fall inside and outside the clip range; f32, 1e-6 (the
    same elementwise terms, ds a sum of 256 in another order)."""
    rng = np.random.default_rng(10 + bits + signed)
    x = (rng.normal(size=(4, 64)) * 2).astype(np.float32)
    up = rng.normal(size=(4, 64)).astype(np.float32)
    scale = np.float32(_np(jq.init_act_scale(bits)))

    def f(x, s):
        return jnp.sum(jq.int_act(x, s, bits, signed) * jnp.asarray(up))

    want_dx, want_ds = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.float32(scale))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.tensor(scale, requires_grad=True)
    torch.sum(tq.int_act(xt, st, bits, signed) * torch.from_numpy(up)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_dx), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(st.grad.item(), float(want_ds), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["binary", "ternary", "int8"])
def test_weight_quantizer_backward_is_straight_through(kind):
    """``_ste`` passes the upstream gradient through unchanged (the scale
    and the codes are outside the gradient), as the reference's does."""
    rng = np.random.default_rng(6)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    up = rng.normal(size=w.shape).astype(np.float32)
    fj, ft = {
        "binary": (jq.binary_weight, tq.binary_weight),
        "ternary": (jq.ternary_weight, tq.ternary_weight),
        "int8": (lambda a: jq.int_weight(a, 8), lambda a: tq.int_weight(a, 8)),
    }[kind]
    want = jax.grad(lambda a: jnp.sum(fj(a) * jnp.asarray(up)))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_()
    torch.sum(ft(wt) * torch.from_numpy(up)).backward()
    assert torch.equal(wt.grad, torch.from_numpy(up))
    np.testing.assert_array_equal(wt.grad.numpy(), _np(want))


def test_code_helpers_round_trip():
    s = torch.tensor([-1.0, 1.0, 1.0, -1.0])
    t = torch.tensor([-1.0, 0.0, 1.0, 0.0])
    assert torch.equal(tq.binary_from_codes(tq.codes_from_binary(s)), s)
    assert torch.equal(tq.ternary_from_codes(tq.codes_from_ternary(t)), t)
    assert tq.codes_from_ternary(t).tolist() == _np(jq.codes_from_ternary(jnp.asarray(t.numpy()))).tolist()


@pytest.mark.parametrize("bits", [2, 4])
def test_bn_act_to_thresholds_matches_reference(bits):
    rng = np.random.default_rng(bits)
    c = 32
    gamma = (rng.choice([-1.0, 1.0], size=c) * rng.uniform(0.2, 2.0, size=c)).astype(np.float32)
    gamma[:2] = [0.0, -1e-13]  # safe_gamma and the sign of a vanishing gamma
    beta = rng.normal(size=c).astype(np.float32)
    mu = rng.normal(size=c).astype(np.float32)
    var = rng.uniform(0.1, 2.0, size=c).astype(np.float32)
    scale = np.float32(0.7)
    want = jst.bn_act_to_thresholds(*(jnp.asarray(a) for a in (gamma, beta, mu, var, scale)), bits)
    got = tst.bn_act_to_thresholds(*(torch.from_numpy(np.array(a)) for a in (gamma, beta, mu, var, scale)), bits)
    np.testing.assert_allclose(got.thresholds.numpy(), _np(want.thresholds), rtol=1e-5)
    np.testing.assert_array_equal(got.signs.numpy(), _np(want.signs))
    assert got.offset == want.offset and got.thresholds.shape == (c, 2**bits - 1)
    assert (got.signs.numpy() < 0).any() and (got.signs.numpy() > 0).any()


def test_thresholding_exact_on_the_same_input():
    rng = np.random.default_rng(5)
    c, bits = 24, 2
    spec_j = jst.bn_act_to_thresholds(
        jnp.asarray(rng.choice([-1.0, 1.0], size=c).astype(np.float32)),
        jnp.asarray(rng.normal(size=c).astype(np.float32)),
        jnp.asarray(rng.normal(size=c).astype(np.float32)),
        jnp.asarray(rng.uniform(0.5, 2.0, size=c).astype(np.float32)),
        jnp.float32(0.9), bits,
    )
    spec_t = _tspec_from_j(spec_j)
    acc = (rng.normal(size=(3, 5, c)) * 3).astype(np.float32)
    acc[0, 0] = _np(spec_j.thresholds)[:, 0] * _np(spec_j.signs)  # exactly on a threshold
    np.testing.assert_array_equal(
        tst.thresholding_int(torch.from_numpy(acc), spec_t).numpy(),
        _np(jst.thresholding_int(jnp.asarray(acc), spec_j)))
    np.testing.assert_array_equal(
        tst.thresholding(torch.from_numpy(acc), spec_t).numpy(),
        _np(jst.thresholding(jnp.asarray(acc), spec_j)))
    z = jnp.asarray(acc)
    args = [rng.uniform(0.5, 1.5, size=c).astype(np.float32) for _ in range(4)]
    np.testing.assert_allclose(
        tst.reference_bn_act(torch.from_numpy(acc), *map(torch.from_numpy, args), 0.9, bits).numpy(),
        _np(jst.reference_bn_act(z, *map(jnp.asarray, args), 0.9, bits)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 0), (3, 2, 1), (1, 1, 0), (5, 2, 2)])
def test_im2col_matches_reference(k, stride, pad):
    x = np.random.default_rng(k + stride).normal(size=(2, 9, 7, 5)).astype(np.float32)
    want, wdims = jcnn.im2col(jnp.asarray(x), k, stride, pad)
    got, gdims = tcnn.im2col(torch.from_numpy(x), k, stride, pad)
    assert gdims == tuple(int(d) for d in wdims)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("w_bits", [1, 2])
def test_conv_as_mvau_kernel_route_matches_pallas(w_bits):
    """The narrow conv1 template of ``tests/test_system.py`` through the
    kernel route: the port's plain MVAU against the reference's Pallas
    ``mvau`` in interpret mode; the levels are equal."""
    sp = dataclasses.replace(jcnn.cnv_topology(w_bits=w_bits, a_bits=2)[1],
                             c_in=8, c_out=16, pool=False)
    params = _ref_params([sp], seed=w_bits)
    sj = jcnn.streamline_params(jax.tree.map(jnp.asarray, params), [sp])[sp.name]
    st = tcnn.streamline_params(cnn_params_from_reference(params, "cpu"),
                                [tcnn.ConvSpec(**dataclasses.asdict(sp))])[sp.name]
    np.testing.assert_allclose(st["w"].numpy(), _np(sj["w"]), rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(9).normal(size=(1, 8, 8, 8)).astype(np.float32)
    want = jcnn.conv_as_mvau(jnp.asarray(x), sj["w"], sj["thresholds"], w_bits)
    got = tcnn.conv_as_mvau(torch.from_numpy(x), st["w"], st["thresholds"], w_bits)
    scale = float(_np(sj["thresholds"].scale))
    np.testing.assert_array_equal(
        np.rint(got.numpy() / scale).astype(np.int32), np.rint(_np(want) / scale).astype(np.int32))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("w_bits", [1, 2])
def test_cnv_forward_matches_reference(w_bits):
    """Full-width CNV (batch 2): the port's streamlined path (im2col +
    MVAU) and its eval-mode QAT path against the reference's, 1e-4 as in
    ``tests/test_system.py``."""
    specs_j = jcnn.cnv_topology(w_bits=w_bits, a_bits=2)
    specs_t = tcnn.cnv_topology(w_bits=w_bits, a_bits=2)
    assert [dataclasses.asdict(s) for s in specs_t] == [dataclasses.asdict(s) for s in specs_j]
    params = _ref_params(specs_j, seed=w_bits)
    pj = jax.tree.map(jnp.asarray, params)
    pt = cnn_params_from_reference(params, "cpu")
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    want_float = _np(jcnn.cnn_forward(pj, specs_j, xj, train=False))
    want_stream = _np(jcnn.cnn_forward_streamlined(jcnn.streamline_params(pj, specs_j), specs_j, xj))
    got_float = tcnn.cnn_forward(pt, specs_t, xt, train=False).numpy()
    trace = []
    got_stream = tcnn.cnn_forward_streamlined(
        tcnn.streamline_params(pt, specs_t), specs_t, xt, trace=trace).numpy()
    assert got_stream.shape == (2, 10) and np.isfinite(got_stream).all()
    assert [name for name, _, _ in trace] == [s.name for s in specs_t]
    np.testing.assert_allclose(got_stream, want_stream, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_float, want_float, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_stream, want_float, rtol=1e-4, atol=1e-4)


def test_cnv_train_forward_matches_reference():
    """The train-mode forward (batch BN statistics, population variance)."""
    specs_j = jcnn.cnv_topology(w_bits=1, a_bits=2)
    specs_t = tcnn.cnv_topology(w_bits=1, a_bits=2)
    params = _ref_params(specs_j, seed=5)
    x = np.random.default_rng(4).normal(size=(4, 32, 32, 3)).astype(np.float32)
    want = _np(jcnn.cnn_forward(jax.tree.map(jnp.asarray, params), specs_j, jnp.asarray(x), train=True))
    got = tcnn.cnn_forward(cnn_params_from_reference(params, "cpu"), specs_t,
                           torch.from_numpy(x), train=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _narrow(specs):
    """CNV at an eighth of its widths (the input's 3 channels and the 10
    logits kept)."""
    return [
        dataclasses.replace(
            sp,
            c_in=sp.c_in if sp.name == "conv0" else sp.c_in // 8,
            c_out=sp.c_out if sp.name == "fc2" else sp.c_out // 8,
        )
        for sp in specs
    ]


@pytest.mark.parametrize("w_bits", [1, 2])
def test_cnv_train_gradients_match_reference(w_bits):
    """QAT through the port: gradients of ``cnn_forward(train=True)`` (STE
    weights, batch BN, LSQ activations) on a narrow CNV against jax.grad
    of the reference's, for every weight, BN gain and bias and LSQ scale,
    and the input; f32, 1e-4 as the forward checks."""
    specs_j = _narrow(jcnn.cnv_topology(w_bits=w_bits, a_bits=2))
    specs_t = _narrow(tcnn.cnv_topology(w_bits=w_bits, a_bits=2))
    params = _ref_params(specs_j, seed=7 + w_bits)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    up = rng.normal(size=(4, 10)).astype(np.float32)

    def loss_j(p, xx):
        return jnp.sum(jcnn.cnn_forward(p, specs_j, xx, train=True) * jnp.asarray(up))

    want_p, want_x = jax.grad(loss_j, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    pt = cnn_params_from_reference(params, "cpu")
    for leaves in pt.values():
        for t in leaves.values():
            t.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(tcnn.cnn_forward(pt, specs_t, xt, train=True) * torch.from_numpy(up)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), _np(want_x), rtol=1e-4, atol=1e-4)
    moved = 0
    for sp in specs_t:
        for name, t in pt[sp.name].items():
            want = _np(want_p[sp.name][name])
            got = np.zeros_like(want) if t.grad is None else t.grad.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                       err_msg=f"{sp.name}/{name}")
            moved += name == "act_scale" and bool(np.abs(want) > 0)
    assert moved >= 7  # the LSQ scales learn (they did not before the fix)


def test_init_cnn_params_shapes_and_distribution():
    specs = tcnn.cnv_topology()
    p = tcnn.init_cnn_params(specs, 0)
    ref = jax.tree.map(np.asarray, jcnn.init_cnn_params(jcnn.cnv_topology(), jax.random.key(0)))
    for sp in specs:
        for name, leaf in p[sp.name].items():
            assert tuple(leaf.shape) == ref[sp.name][name].shape, (sp.name, name)
            assert leaf.dtype == torch.float32
        w = p[sp.name]["w"].numpy()
        assert abs(w.std() * np.sqrt(sp.k * sp.k * sp.c_in) - 1.0) < 0.2
    np.testing.assert_allclose(p["conv0"]["act_scale"].numpy(), ref["conv0"]["act_scale"])
    assert torch.equal(p["conv1"]["w"], tcnn.init_cnn_params(specs, 0)["conv1"]["w"])


def test_cnn_params_from_reference_is_byte_exact_and_checks_leaves():
    specs = jcnn.cnv_topology()
    params = _ref_params(specs)
    pt = cnn_params_from_reference(params, "cpu")
    for name, leaves in params.items():
        for leaf, a in leaves.items():
            assert pt[name][leaf].numpy().tobytes() == np.asarray(a).tobytes()
    bad = {"conv0": {k: v for k, v in params["conv0"].items() if k != "bn_var"}}
    with pytest.raises(ValueError):
        cnn_params_from_reference(bad, "cpu")
