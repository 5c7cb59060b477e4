"""The paper's own CNN, CNV (BNN-Pynq), in PyTorch: the port of
``repro.models.cnn``.

Two paths, as in the reference (paper §III), both in NHWC activations and
HWIO weights, the reference's layout:

* **QAT float path** (``cnn_forward``): convolution with STE-quantized
  weights (binary/ternary inside, 8-bit first and last), BN, then an LSQ
  activation.
* **Streamlined dataflow path** (``cnn_forward_streamlined``): BN and the
  activation folded into integer thresholds (``quant.streamline``), and
  every quantized layer lowered to im2col + the fused packed ``mvau``
  kernel through ``conv_as_mvau``; the 8-bit first layer takes
  ``conv_as_mvau``'s own matmul + thresholding branch, the logits layer a
  plain convolution. It equals the reference's ``cnn_forward_streamlined``
  (convolution + thresholding) and ``cnn_forward(train=False)`` up to
  accumulators that land on a threshold within rounding.

A float32 convolution on the card goes through cuDNN, in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off; callers that compare with the
reference turn it off. Each layer is a ``torch.profiler`` range
(``cnn.<layer>``, and ``im2col`` inside ``conv_as_mvau``) so a profile
splits the card's time by layer and stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels import ops
from repro_torch.quant.quantizers import init_act_scale, int_act, quantize_weight
from repro_torch.quant.streamline import ThresholdSpec, bn_act_to_thresholds


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str
    c_in: int
    c_out: int
    k: int
    stride: int = 1
    pad: int = 0
    w_bits: int = 1
    a_bits: int = 2
    pool: bool = False  # 2x2 maxpool after activation


def cnv_topology(w_bits: int = 1, a_bits: int = 2) -> list[ConvSpec]:
    """BNN-Pynq CNV: 6 valid convs + 2 maxpools + 3 FC (paper §V)."""
    return [
        ConvSpec("conv0", 3, 64, 3, w_bits=8, a_bits=a_bits),
        ConvSpec("conv1", 64, 64, 3, w_bits=w_bits, a_bits=a_bits, pool=True),
        ConvSpec("conv2", 64, 128, 3, w_bits=w_bits, a_bits=a_bits),
        ConvSpec("conv3", 128, 128, 3, w_bits=w_bits, a_bits=a_bits, pool=True),
        ConvSpec("conv4", 128, 256, 3, w_bits=w_bits, a_bits=a_bits),
        ConvSpec("conv5", 256, 256, 3, w_bits=w_bits, a_bits=a_bits),
        ConvSpec("fc0", 256, 512, 1, w_bits=w_bits, a_bits=a_bits),
        ConvSpec("fc1", 512, 512, 1, w_bits=w_bits, a_bits=a_bits),
        ConvSpec("fc2", 512, 10, 1, w_bits=8, a_bits=0),  # logits
    ]


def init_cnn_params(
    specs: list[ConvSpec], seed: int | torch.Generator, device="cpu"
) -> dict:
    """Random weights (HWIO, N(0, 1/fan_in)) and identity BN, the
    reference's distributions drawn from a ``torch.Generator`` (its
    ``jax.random`` draws cannot be reproduced; parity tests carry the
    reference's weights over with ``interop.cnn_params_from_reference``)."""
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    params: dict[str, Any] = {}
    for sp in specs:
        fan_in = sp.k * sp.k * sp.c_in
        w = torch.randn((sp.k, sp.k, sp.c_in, sp.c_out), generator=gen) * fan_in**-0.5
        params[sp.name] = {
            "w": w.to(device),
            "bn_gamma": torch.ones(sp.c_out, device=device),
            "bn_beta": torch.zeros(sp.c_out, device=device),
            "bn_mu": torch.zeros(sp.c_out, device=device),
            "bn_var": torch.ones(sp.c_out, device=device),
            "act_scale": init_act_scale(max(sp.a_bits, 2), device=device),
        }
    return params


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """NHWC x HWIO convolution (the reference's ``lax.conv``), NHWC out."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, VALID (an odd edge row/column is dropped).
    Its gradient goes to one element of a window, the first maximum, as
    the reference's ``reduce_window`` max sends it; quantized activations
    tie often, and a max over the window would split it among the ties."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _flatten_for_fc(x: torch.Tensor, sp: ConvSpec, i: int) -> torch.Tensor:
    """The first FC flattens a spatial map, in NHWC order (CNV pools to 1x1
    before fc0, so there it keeps the map as it is)."""
    if sp.k == 1 and x.dim() == 4 and x.shape[1] * x.shape[2] > 1 and i > 0:
        return x.reshape(x.shape[0], 1, 1, -1)
    return x


def cnn_forward(
    params: dict, specs: list[ConvSpec], x: torch.Tensor, train: bool = True
) -> torch.Tensor:
    """QAT float path. x: (B, H, W, C). Returns logits (B, n_classes).
    ``train`` uses the batch's BN statistics (population variance)."""
    for i, sp in enumerate(specs):
        p = params[sp.name]
        x = _flatten_for_fc(x, sp, i)
        x = _conv(x, quantize_weight(p["w"], sp.w_bits), sp.stride, sp.pad)
        if sp.a_bits > 0:
            mu, var = p["bn_mu"], p["bn_var"]
            if train:
                mu = torch.mean(x, dim=(0, 1, 2))
                var = torch.var(x, dim=(0, 1, 2), correction=0)
            z = p["bn_gamma"] * (x - mu) / torch.sqrt(var + 1e-5) + p["bn_beta"]
            x = int_act(z, p["act_scale"], sp.a_bits)
        if sp.pool:
            x = _maxpool2(x)
    return x.reshape(x.shape[0], -1)


def streamline_params(params: dict, specs: list[ConvSpec]) -> dict:
    """Fold BN + act into thresholds per layer (paper §III-B)."""
    out = {}
    for sp in specs:
        p = params[sp.name]
        entry: dict[str, Any] = {"w": quantize_weight(p["w"], sp.w_bits)}
        if sp.a_bits > 0:
            entry["thresholds"] = bn_act_to_thresholds(
                p["bn_gamma"], p["bn_beta"], p["bn_mu"], p["bn_var"],
                p["act_scale"], sp.a_bits,
            )
        out[sp.name] = entry
    return out


def streamlined_layer(p: dict, sp: ConvSpec, x: torch.Tensor) -> torch.Tensor:
    """One layer of the streamlined path before its pooling: im2col + MVAU
    for a quantized activation, a plain convolution for the logits."""
    if sp.a_bits > 0:
        return conv_as_mvau(x, p["w"], p["thresholds"], sp.w_bits, sp.stride, sp.pad)
    return _conv(x, p["w"], sp.stride, sp.pad)


def cnn_forward_streamlined(
    sparams: dict, specs: list[ConvSpec], x: torch.Tensor, trace: list | None = None
) -> torch.Tensor:
    """Dataflow path: im2col + fused MVAU per quantized layer (no BN, no
    float activation). x: (B, H, W, C); returns logits (B, n_classes).
    ``trace``, when given, receives ``(name, layer input, output before
    pooling)`` for each layer."""
    for i, sp in enumerate(specs):
        x = _flatten_for_fc(x, sp, i)
        with record_function(f"cnn.{sp.name}"):
            y = streamlined_layer(sparams[sp.name], sp, x)
            if trace is not None:
                trace.append((sp.name, x, y))
            x = _maxpool2(y) if sp.pool else y
    return x.reshape(x.shape[0], -1)


def im2col(x: torch.Tensor, k: int, stride: int = 1, pad: int = 0):
    """(B, H, W, C) -> (B*Ho*Wo, k*k*C) patches, columns in (di, dj, c)
    order so they meet ``w.reshape(k*k*C, C_out)`` of an HWIO weight: the
    MVAU input stream."""
    b, h, w, c = x.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    # unfold appends each window axis: (B, Ho, Wo, C, di, dj)
    patches = x.unfold(1, k, stride).unfold(2, k, stride)
    cols = patches.permute(0, 1, 2, 4, 5, 3).reshape(b * ho * wo, k * k * c)
    return cols, (b, ho, wo)


def mvau_weights(wm: torch.Tensor, spec: ThresholdSpec, w_bits: int):
    """A (K, N) binary/ternary weight matrix as the kernel takes it: the
    per-channel magnitude ``alpha = max|w|`` (1 where a column is all
    zero) folds into the thresholds, T' = T / alpha, and the +-1/0 signs
    are packed. Returns (carrier, T')."""
    alpha = torch.amax(torch.abs(wm), dim=0)
    alpha = torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    carrier = ops.pack_weights(wm / alpha[None, :], w_bits)
    return carrier, spec.thresholds / alpha[:, None]


def conv_as_mvau(
    x: torch.Tensor, w: torch.Tensor, spec: ThresholdSpec, w_bits: int,
    stride: int = 1, pad: int = 0,
) -> torch.Tensor:
    """Convolution on the streamlined datapath: im2col + the fused MVAU
    kernel (packed weights + thresholding), the FINN execution model, for
    1/2-bit weights; wider weights (CNV's 8-bit conv0) take a matmul and
    thresholding. Returns the activation values (levels * scale),
    (B, Ho, Wo, C_out)."""
    k, _, c_in, c_out = w.shape
    with record_function("im2col"):
        cols, (b, ho, wo) = im2col(x, k, stride, pad)
    wm = w.reshape(k * k * c_in, c_out)
    if w_bits in (1, 2):
        carrier, thr = mvau_weights(wm, spec, w_bits)
        levels = ops.mvau(cols, carrier, thr, spec.signs, bits=w_bits,
                          k=k * k * c_in, offset=int(spec.offset))
    else:
        acc = cols @ wm
        levels = ((acc * spec.signs[None])[..., None] >= spec.thresholds[None]).sum(
            dim=-1, dtype=torch.int32) + int(spec.offset)
    vals = levels.to(torch.float32) * spec.scale
    return vals.reshape(b, ho, wo, c_out)
