"""Synthetic data pipelines with checkpointable, deterministic state.

The port's copy of ``repro.data.pipeline`` (numpy only), so its batches
equal the reference's bit for bit. Every batch is a pure function of
``(seed, step)``: the pipeline "state" is just the step counter, so
capturing it in the checkpoint gives exact resume after preemption. No
dataset files ship with the repo; token streams are Zipf-distributed
(vocab-shaped) and image batches are CIFAR-shaped Gaussians with
class-conditional means so a small CNN can actually descend on them.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(step=int(d["step"]))


@dataclasses.dataclass
class TokenPipeline:
    """Next-token LM batches: {tokens (B, S), labels (B, S)} int32."""

    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    state: PipelineState = dataclasses.field(default_factory=PipelineState)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        # Zipf-ish marginal over the vocab (realistic embedding traffic)
        z = rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = np.minimum(z - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __next__(self) -> dict[str, np.ndarray]:
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        return self


@dataclasses.dataclass
class CifarPipeline:
    """CIFAR-10-shaped synthetic classification batches (paper's CNV)."""

    batch: int
    n_classes: int = 10
    hw: int = 32
    seed: int = 0
    state: PipelineState = dataclasses.field(default_factory=PipelineState)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step])
        )
        labels = rng.integers(0, self.n_classes, size=(self.batch,))
        # class-conditional channel means make the task learnable
        means = np.linspace(-1.0, 1.0, self.n_classes)[labels]
        x = rng.normal(
            means[:, None, None, None], 1.0, (self.batch, self.hw, self.hw, 3)
        )
        return {
            "images": x.astype(np.float32),
            "labels": labels.astype(np.int32),
        }

    def __next__(self):
        b = self.batch_at(self.state.step)
        self.state.step += 1
        return b

    def __iter__(self):
        return self
