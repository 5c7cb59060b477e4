"""The plain reference of the benchmark's language models, in float32.

It follows the published description of the configurations (a pre-norm
decoder: RMSNorm, rotary positions on the first and second halves of each
head, causal grouped-query attention, a SwiGLU FFN, or top-k experts
behind a softmax router, renormalised over the k chosen where the file's
``norm_topk_prob`` says so), computed one layer at a time on one sequence, with no cache,
no batching and no kernel. It takes the dense weights the benchmark made
(a dict of tensors) and derives everything else itself: the 2-bit FFN
weights through ``quant.ternary_2bit``. It imports nothing of the program.

``mode="f32"`` is the reference; ``mode="fp8"`` is the control: every
product with a weight (the projections, the FFN, the experts and the
unembedding) takes its operands rounded to float8 (``quant.fp8_matmul``);
attention's own products and the router stay float32.

The caller turns TF32 off (``no_tf32``): the reference is float32.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from reference.quant import fp8_matmul, ternary_2bit


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matmuls and convolutions inside, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * g.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D): positions 0..S-1, the first and second halves rotated."""
    s, _, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2 :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal attention; q (S, H, D), k / v (S, Hkv, D); query head h reads
    key head h // (H / Hkv)."""
    s, h, d = q.shape
    g = h // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)


class Model:
    """The reference over one configuration's sizes (a dict with the
    configuration file's keys) and the benchmark's dense weights."""

    def __init__(self, config: dict, weights: dict, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"mode is f32 or fp8, got {mode!r}")
        self.c = config
        self.w = weights
        self.mode = mode
        self.heads = int(config["num_attention_heads"])
        self.kv_heads = int(config["num_key_value_heads"])
        self.head_dim = int(config["head_dim"])
        self.eps = float(config["rms_norm_eps"])
        self.theta = float(config["rope_theta"])
        self.vocab = int(config["vocab_size"])
        self.w_bits = int(config.get("w_bits", 0))
        self.moe = int(config.get("num_experts", 0)) > 0
        self.renorm = bool(config.get("norm_topk_prob", False))
        if config.get("qk_norm", False):
            raise NotImplementedError("QK-norm: the benchmark's weights hold no q / k norm gains")

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return fp8_matmul(x, w) if self.mode == "fp8" else x @ w

    def _ffn_weight(self, w: torch.Tensor) -> torch.Tensor:
        return ternary_2bit(w) if self.w_bits == 2 else w.float()

    def _swiglu(self, h, w1, w3, w2) -> torch.Tensor:
        return self._mm(F.silu(self._mm(h, w1)) * self._mm(h, w3), w2)

    def _experts(self, h: torch.Tensor, lw: dict) -> torch.Tensor:
        k = int(self.c["num_experts_per_tok"])
        probs = torch.softmax(h @ lw["router"].float(), dim=-1)
        top_g, top_i = torch.topk(probs, k, dim=-1)
        if self.renorm:
            top_g = top_g / top_g.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in torch.unique(top_i).tolist():
            rows, slot = (top_i == e).nonzero(as_tuple=True)
            y = self._swiglu(h[rows], lw["w1"][e], lw["w3"][e], lw["w2"][e])
            out.index_add_(0, rows, top_g[rows, slot, None] * y)
        return out

    def _layer(self, x: torch.Tensor, lw: dict) -> torch.Tensor:
        s = x.shape[0]
        h = _rms(x, lw["ln1"], self.eps)
        q = self._mm(h, lw["wq"]).reshape(s, self.heads, self.head_dim)
        k = self._mm(h, lw["wk"]).reshape(s, self.kv_heads, self.head_dim)
        v = self._mm(h, lw["wv"]).reshape(s, self.kv_heads, self.head_dim)
        o = _attention(_rope(q, self.theta), _rope(k, self.theta), v)
        x = x + self._mm(o.reshape(s, -1), lw["wo"])
        h = _rms(x, lw["ln2"], self.eps)
        if self.moe:
            return x + self._experts(h, lw)
        w1, w3, w2 = (self._ffn_weight(lw[n]) for n in ("w1", "w3", "w2"))
        return x + self._swiglu(h, w1, w3, w2)

    def logits(self, tokens: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """float32 logits (len(rows), vocab) of the sequence ``tokens`` (S,)
        at positions ``rows``: the next-token scores after each."""
        layers = self.w["layers"]
        n_layers = int(self.c["num_hidden_layers"])
        x = self.w["embed"][tokens].float()
        for i in range(n_layers):
            x = self._layer(x, {name: leaf[i] for name, leaf in layers.items()})
        x = _rms(x[rows], self.w["final_norm"], self.eps)
        table = self.w["embed"] if self.c.get("tie_word_embeddings") else self.w["unembed"]
        return self._mm(x, table[: self.vocab].t())
