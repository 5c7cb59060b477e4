"""The reference's 2-bit quantizer, derived from the dense weights alone,
against the port's packer on the same weights."""

import pytest
import torch

from reference.quant import fp8_matmul, ternary_2bit


@pytest.mark.parametrize("k,n,std", [(960, 2560, 960 ** -0.5), (2560, 960, 0.5 * 960 ** -0.5)])
def test_ternary_matches_port_packer(k, n, std):
    from repro_torch.models.lm import _unpack_codes, make_packed

    g = torch.Generator().manual_seed(k)
    w = (torch.randn(k, n, generator=g) * std).to(torch.bfloat16)
    packed = make_packed(w, 2)
    codes = _unpack_codes(packed["packed"], 2).to(torch.float32) - 1.0
    port = codes * packed["scale"]
    assert torch.equal(ternary_2bit(w), port)


def test_fp8_matmul_is_coarser():
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(16, 256, generator=g), torch.randn(256, 64, generator=g)
    exact = x @ w
    rel = ((fp8_matmul(x, w) - exact).norm() / exact.norm()).item()
    assert 1e-3 < rel < 0.1
