"""Pool step builders for the continuous-batching scheduler.

Port of the pool steps of ``repro.runtime.steps``. PyTorch runs eagerly,
so a step is the model function closed over the config (no jit, no buffer
donation: the pool steps update the pool tensors in place).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


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
