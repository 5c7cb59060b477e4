"""Layer descriptions of the paper's accelerators: CNV (BNN-Pynq) and
quantized ResNet-50 v1.5 — expressed as FINN MVAU layer sets for the
resource/packing/performance models.

CNV (FINN / BNN-Pynq): 6 valid 3x3 convs (64,64,128,128,256,256) with two
2x2 maxpools, then FC 256->512->512->10. Input 32x32 CIFAR-10.
Spatial trace: 32-30-28 |pool| 14-12-10 |pool| 5-3-1.

ResNet-50 v1.5: 7x7/64 stem; 4 stages of [3,4,6,3] bottleneck ResBlocks
(1x1 -> 3x3 -> 1x1 with 4x expansion; 1x1 downsample on the first block of
each stage); 16 ResBlocks total, matching the paper's description (§III).
Weights inside ResBlocks are W (1 or 2) bits; first/last layers 8 bit.

The port's copy of ``repro.core.topologies``.
"""

from __future__ import annotations

from repro_torch.core.buffers import LayerSpec


def cnv_layers(w_bits: int = 1) -> list[LayerSpec]:
    spec = [
        # name,            c_in, c_out, k, out_hw
        ("conv0", 3, 64, 3, 30),
        ("conv1", 64, 64, 3, 28),
        ("conv2", 64, 128, 3, 12),
        ("conv3", 128, 128, 3, 10),
        ("conv4", 128, 256, 3, 3),
        ("conv5", 256, 256, 3, 1),
        ("fc0", 256, 512, 1, 1),
        ("fc1", 512, 512, 1, 1),
        ("fc2", 512, 10, 1, 1),
    ]
    # first layer inputs are 8-bit images but weights follow the W1/W2 scheme
    # in BNN-Pynq (all layers binarized/ternarized).
    return [
        LayerSpec(n, ci, co, k, hw * hw, w_bits) for n, ci, co, k, hw in spec
    ]


def resnet50_layers(w_bits: int = 1, include_top_bottom: bool = False) -> list[LayerSpec]:
    """ResBlock convolutions of ResNet-50 v1.5 (paper packs only these;
    stem + final FC are excluded from packing, §V)."""
    layers: list[LayerSpec] = []
    if include_top_bottom:
        layers.append(LayerSpec("stem_conv7x7", 3, 64, 7, 112 * 112, 8))
    stages = [
        # (n_blocks, c_mid, c_out, spatial_out)
        (3, 64, 256, 56),
        (4, 128, 512, 28),
        (6, 256, 1024, 14),
        (3, 512, 2048, 7),
    ]
    c_in = 64
    for s, (n_blocks, c_mid, c_out, hw) in enumerate(stages):
        for b in range(n_blocks):
            px = hw * hw
            pfx = f"s{s}b{b}"
            layers.append(LayerSpec(f"{pfx}_c1x1a", c_in, c_mid, 1, px, w_bits))
            layers.append(LayerSpec(f"{pfx}_c3x3", c_mid, c_mid, 3, px, w_bits))
            layers.append(LayerSpec(f"{pfx}_c1x1b", c_mid, c_out, 1, px, w_bits))
            if b == 0:
                layers.append(
                    LayerSpec(f"{pfx}_c1x1ds", c_in, c_out, 1, px, w_bits)
                )
            c_in = c_out
    if include_top_bottom:
        layers.append(LayerSpec("fc", 2048, 1000, 1, 1, 8))
    return layers


def resblock_slr_map(layers: list[LayerSpec], n_slr: int) -> list[str]:
    """Assign ResBlock layers to SLRs by contiguous pipeline order with
    per-SLR parameter-bit balancing — mirrors the paper's Alveo floorplan
    (Fig. 5), where packing may only group buffers within one SLR."""
    total_bits = sum(l.param_bits for l in layers)
    target = total_bits / n_slr
    regions, acc, slr = [], 0, 0
    for l in layers:
        regions.append(f"slr{slr}")
        acc += l.param_bits
        if acc > target * (slr + 1) and slr < n_slr - 1:
            slr += 1
    return regions
