"""The work counts against hand arithmetic, for both configurations."""

import json

import pytest
from conftest import HERE

from work.flops import (
    least_seconds,
    matmul_params,
    packed_ffn_products,
    span_attention_flops,
    token_flops,
)


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_smollm_matmul_params():
    # attention 960*960 + 2*960*320 + 960*960, FFN 3*960*2560, 32 layers,
    # and the tied unembedding over 49152 rows of 960
    per_layer = 960 * 960 * 2 + 2 * 960 * 320 + 3 * 960 * 2560
    assert per_layer == 9_830_400
    assert matmul_params(config("smollm-360m-2bit")) == 32 * 9_830_400 + 49152 * 960 == 361_758_720


def test_olmoe_matmul_params():
    # attention 4 * 2048^2, router 2048*64, 8 of 64 experts of 3*2048*1024,
    # 16 layers, the unembedding over 50304 rows of 2048
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert per_layer == 67_239_936
    assert matmul_params(config("olmoe-1b-7b")) == 16 * per_layer + 50304 * 2048 == 1_178_861_568


@pytest.mark.parametrize("name,heads_x_dim,layers", [
    ("smollm-360m-2bit", 15 * 64, 32), ("olmoe-1b-7b", 16 * 128, 16)])
def test_attention_flops(name, heads_x_dim, layers):
    c = config(name)
    # QK and PV: 2 FLOPs a multiply-add each, per key, head and dim, per layer
    assert token_flops(c, 100) - token_flops(c, 0) == 4 * layers * heads_x_dim * 100
    # positions 0..9 read 1..10 keys: 55 keys in all
    assert span_attention_flops(c, 0, 10) == 4 * layers * heads_x_dim * 55
    assert span_attention_flops(c, 5, 5) == 0


def test_packed_products_bytes():
    c = config("smollm-360m-2bit")
    p = packed_ffn_products(c, 16)
    assert len(p) == 96  # w1, w3, w2 of 32 layers
    # w1: 2-bit codes of 960x2560, f32 scales of 2560, bf16 x 16x960, f32 y 16x2560
    assert p[0]["bytes"] == 960 * 2560 // 4 + 4 * 2560 + 2 * 16 * 960 + 4 * 16 * 2560 == 819_200
    assert p[2]["bytes"] == 2560 * 960 // 4 + 4 * 960 + 2 * 16 * 2560 + 4 * 16 * 960 == 761_600
    assert p[0]["flops"] == 2 * 16 * 960 * 2560
    # bytes bound at 3.35 TB/s: 0.2445 us
    assert least_seconds(p[0]["bytes"], p[0]["flops"]) == pytest.approx(819_200 / 3.35e12)
