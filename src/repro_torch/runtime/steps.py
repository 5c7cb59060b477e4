"""Step builders: the train step and the pool steps of the
continuous-batching scheduler.

Port of ``repro.runtime.steps`` for the dense family. PyTorch runs
eagerly, so a step is the model function closed over the config (no jit,
no buffer donation: the train step updates the parameters and the
optimizer state in place, the pool steps the pool tensors).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamW, param_tree


def make_loss_fn(cfg: ModelConfig, *, remat: str = "full", ce_chunk: int = 0) -> Callable:
    """(params, batch {tokens, labels}) -> scalar loss."""

    def loss(params, batch):
        value, _ = lm.loss_fn(
            params, cfg, batch["tokens"], batch["labels"], remat=remat, ce_chunk=ce_chunk
        )
        return value

    return loss


def _grads(loss: torch.Tensor, tree):
    """d loss / d every leaf that requires a gradient, as a tree like the
    parameters' with None elsewhere (the reference's float0 tangents)."""
    flat: list[tuple[tuple[str, ...], torch.Tensor]] = []

    def walk(node, path):
        for k in sorted(node):
            if isinstance(node[k], dict):
                walk(node[k], path + (k,))
            elif node[k].requires_grad:
                flat.append((path + (k,), node[k]))

    walk(tree, ())
    got = torch.autograd.grad(loss, [t for _, t in flat])
    by_path = {path: g for (path, _), g in zip(flat, got)}

    def build(node, path):
        return {
            k: build(v, path + (k,)) if isinstance(v, dict) else by_path.get(path + (k,))
            for k, v in node.items()
        }

    return build(tree, ())


def make_train_step(
    cfg: ModelConfig, opt: AdamW | None = None, *, remat: str = "full", ce_chunk: int = 0
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, {"loss": ...}).

    ``params`` must be trainable (``init_params(..., trainable=True)``);
    the step updates it and the optimizer state in place."""
    opt = opt or AdamW()
    loss_fn = make_loss_fn(cfg, remat=remat, ce_chunk=ce_chunk)

    def step(params, opt_state, batch):
        loss = loss_fn(params, batch)
        grads = _grads(loss, param_tree(params))
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return step


def make_paged_serve_step(cfg: ModelConfig) -> Callable:
    """(params, token (B,1), pool_k, pool_v, row_table (B,S_max), lengths
    (B,)) -> (logits (B,1,V), pool_k, pool_v). Each decode lane gathers its
    KV rows from the shared pool through ``row_table`` and writes the new
    token's row back in place."""

    def step(params, token, pool_k, pool_v, row_table, lengths):
        return lm.decode_step_paged(
            params, cfg, token, pool_k, pool_v, row_table, lengths
        )

    return step


def make_pool_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, S), last_idx) -> (next-token logits (B, 1, V),
    ks, vs stacked (L, B, S, n_kv, hd)). One call fills a whole prompt."""

    def step(params, tokens, last_idx):
        return lm.prefill_with_cache(params, cfg, tokens, last_idx)

    return step


def make_chunk_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, C), pool_k, pool_v, row_table (B, S_max),
    write_rows (B, C), start, last_idx) -> (logits at last_idx (B, 1, V),
    pool_k, pool_v). One prompt chunk against the pool, written in place."""

    def step(params, tokens, pool_k, pool_v, row_table, write_rows, start,
             last_idx):
        return lm.prefill_chunk_paged(
            params, cfg, tokens, pool_k, pool_v, row_table, write_rows,
            start, last_idx,
        )

    return step


def make_budgeted_paged_serve_step(
    cfg: ModelConfig, stream_mask: tuple[bool, ...], stream_depth: int
) -> Callable:
    """The paged serve step under a ``runtime.residency`` plan: layers
    flagged in ``stream_mask`` ((L,) bools) stream their FFN weights
    through ``stream_matmul``'s ring (depth = the plan's R_F analogue),
    the others run the resident path. Same signature as
    ``make_paged_serve_step``."""
    mask = tuple(bool(f) for f in stream_mask)

    def step(params, token, pool_k, pool_v, row_table, lengths):
        return lm.decode_step_paged(
            params, cfg, token, pool_k, pool_v, row_table, lengths,
            stream_mask=mask, stream_depth=stream_depth,
        )

    return step
