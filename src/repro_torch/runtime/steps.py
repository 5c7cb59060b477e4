"""Step builders: the train step, the fixed-batch engine's prefill and
serve steps, the pool steps of the continuous-batching scheduler, and
``CapturedStep``, which compiles a serve step into a CUDA graph.

Port of ``repro.runtime.steps`` (the loss and the train step: every
family, the vlm's with its patch embeddings and the enc-dec's with its
audio frames; the fixed-batch serve step: every family; the prefill step:
every family; the pool steps: dense, vlm, MoE and hybrid). A step is the model
function closed over the config; the MoE family's pool steps return the
(L, E) expert-load tally as one more output, which a ``CapturedStep``
binds like the others; the hybrid's decode step takes and returns the
per-lane SSM state, its whole-prompt prefill returns the prompt's lane
state, and its chunks run ``make_hybrid_suffix_prefill_step``, which
resumes from a carried state. There is no buffer donation: the train step
updates the parameters and the optimizer state in place, the serve steps
the pool tensors or the fixed engine's cache. The reference jits its
serve steps; the port's counterpart is ``CapturedStep``, which the
scheduler wraps around every pool step on a CUDA pool: the decode step,
the prefill chunk, the whole-prompt prefill of each bucket and, when it
speculates, the verify step of each chain length and its model drafter's
decode and prefill steps; the fixed-batch engine
(``launch.serve.run_fixed_engine``) wraps its serve step the same way.
The train step runs eagerly.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import logits as unembed_logits
from repro_torch.optim.adamw import AdamW, param_tree
from repro_torch.runtime.residency.executor import BUDGET_REFUSAL, supports_budgeted_decode


def _split_batch(cfg: ModelConfig, batch: dict):
    """(tokens, labels, model kwargs) of a batch: the vlm family's patch
    embeddings go to the model as ``prefix_embeds``."""
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["prefix_embeds"] = batch["prefix_embeds"]
    return batch["tokens"], batch["labels"], kwargs


def _loss_and_aux(cfg: ModelConfig, remat: str, ce_chunk: int) -> Callable:
    """(params, batch) -> (loss, aux): the reference's ``make_loss_fn``
    body, keeping the aux loss (the MoE's Switch loss; 0 elsewhere). The
    enc-dec family takes the batch's ``frames`` and, as in the reference,
    neither ``remat`` nor ``ce_chunk``."""

    def loss(params, batch):
        if cfg.family == "encdec":
            value, (aux,) = encdec_lib.loss_fn(
                params, cfg, batch["tokens"], batch["labels"], batch["frames"])
            return value, aux
        tokens, labels, kw = _split_batch(cfg, batch)
        value, (_, aux) = lm.loss_fn(
            params, cfg, tokens, labels, remat=remat, ce_chunk=ce_chunk, **kw)
        return value, aux

    return loss


def make_loss_fn(cfg: ModelConfig, *, remat: str = "full", ce_chunk: int = 0) -> Callable:
    """(params, batch {tokens, labels[, prefix_embeds | frames]}) ->
    scalar loss, for every family: ``lm.loss_fn`` (the vlm's with the
    batch's ``prefix_embeds``), or ``encdec.loss_fn`` over the batch's
    ``frames``."""
    loss_and_aux = _loss_and_aux(cfg, remat, ce_chunk)

    def loss(params, batch):
        return loss_and_aux(params, batch)[0]

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
    """(params, opt_state, batch) -> (params, opt_state, {"loss": ...}),
    for every family (the batch as ``make_loss_fn`` takes it); the MoE
    family's metrics add "aux", the step's Switch loss.

    ``params`` must be trainable (``init_params(..., trainable=True)``);
    the step updates it and the optimizer state in place."""
    opt = opt or AdamW()
    loss_and_aux = _loss_and_aux(cfg, remat, ce_chunk)

    def step(params, opt_state, batch):
        loss, aux = loss_and_aux(params, batch)
        grads = _grads(loss, param_tree(params))
        params, opt_state = opt.update(grads, opt_state, params)
        metrics = {"loss": loss.detach()}
        if cfg.family == "moe":
            metrics["aux"] = aux.detach()
        return params, opt_state, metrics

    return step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, batch {tokens, labels[, prefix_embeds | frames]}) ->
    next-token logits (B, 1, V): the full-sequence trunk, with the hidden
    states sliced to the last position before the unembedding, so the (B,
    S, V) logits are never built (the reference's steps.py:72). The
    families ``lm.trunk`` takes (vlm with the batch's ``prefix_embeds``),
    and enc-dec through ``encdec.trunk`` over the batch's ``frames``."""

    @torch.no_grad()
    def step(params, batch):
        if cfg.family == "encdec":
            x, _ = encdec_lib.trunk(params, cfg, batch["tokens"], batch["frames"])
        else:
            tokens, _, kw = _split_batch(cfg, batch)
            x, _ = lm.trunk(params, cfg, tokens, **kw)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        return unembed_logits(x[:, -1:, :], table, cfg.vocab)

    return step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """(params, token (B, 1), cache) -> (logits (B, 1, V), cache): the
    fixed-batch engine's decode step (``lm.decode_step``; enc-dec:
    ``encdec.decode_step`` over the cache of ``encdec.init_decode_state``)
    over the static per-slot cache of ``lm.init_cache``, updated in place,
    so a ``CapturedStep`` over it binds the cache and takes only the
    token."""
    if cfg.family == "encdec":
        def encdec_step(params, token, cache):
            return encdec_lib.decode_step(params, cfg, token, cache)

        return encdec_step

    def step(params, token, cache):
        return lm.decode_step(params, cfg, token, cache)

    return step


def make_paged_serve_step(cfg: ModelConfig) -> Callable:
    """(params, token (B,1), pool_k, pool_v, row_table (B,S_max), lengths
    (B,)) -> (logits (B,1,V), pool_k, pool_v[, tally (L, E) for MoE]).
    Each decode lane gathers its KV rows from the shared pool through
    ``row_table`` and writes the new token's row back in place. The
    hybrid step takes the per-lane SSM state as a seventh argument and
    returns it, advanced in place, as a fourth output."""
    if cfg.family == "hybrid":
        def hybrid_step(params, token, pool_k, pool_v, row_table, lengths, lane_state):
            return lm.decode_step_paged_hybrid(
                params, cfg, token, pool_k, pool_v, row_table, lengths, lane_state
            )

        return hybrid_step

    def step(params, token, pool_k, pool_v, row_table, lengths):
        return lm.decode_step_paged(
            params, cfg, token, pool_k, pool_v, row_table, lengths
        )

    return step


def make_pool_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, S), last_idx) -> (next-token logits (B, 1, V),
    ks, vs stacked (L, B, S, n_kv, hd)). One call fills a whole prompt;
    ``last_idx`` is an int or a one-element tensor on the tokens' device.
    The hybrid step (unpadded prompts) returns the prompt's lane state as
    a fourth output, its ks/vs stacked over the shared block's
    applications."""
    if cfg.family == "hybrid":
        def hybrid_step(params, tokens, last_idx):
            return lm.prefill_with_cache_hybrid(params, cfg, tokens, last_idx)

        return hybrid_step

    def step(params, tokens, last_idx):
        return lm.prefill_with_cache(params, cfg, tokens, last_idx)

    return step


def make_chunk_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, C), pool_k, pool_v, row_table (B, S_max),
    write_rows (B, C), start, last_idx) -> (logits at last_idx (B, 1, V),
    pool_k, pool_v). One prompt chunk against the pool, written in place;
    ``start`` and ``last_idx`` are ints or one-element tensors on the
    pool's device."""

    def step(params, tokens, pool_k, pool_v, row_table, write_rows, start,
             last_idx):
        return lm.prefill_chunk_paged(
            params, cfg, tokens, pool_k, pool_v, row_table, write_rows,
            start, last_idx,
        )

    return step


def make_hybrid_suffix_prefill_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, C) unpadded suffix, pool_k, pool_v, row_table
    (B, S_max), write_rows (B, C), start, last_idx, lane_state) ->
    (logits at last_idx (B, 1, V), pool_k, pool_v, lane_state). A hybrid
    prompt's chunk, or the unmatched suffix of a prefix-cache hit,
    resumed from the carried lane state (the previous chunk's, or the
    anchor's snapshot); the pools and the lane state are updated in
    place."""

    def step(params, tokens, pool_k, pool_v, row_table, write_rows, start, last_idx,
             lane_state):
        return lm.prefill_suffix_paged_hybrid(
            params, cfg, tokens, pool_k, pool_v, row_table, write_rows, start,
            last_idx, lane_state,
        )

    return step


def make_verify_step(cfg: ModelConfig) -> Callable:
    """(params, tokens (B, C), pool_k, pool_v, row_table (B, S_max),
    write_rows (B, C), starts (B,)) -> (logits (B, C, V), pool_k, pool_v).
    One batched call scores every lane's pending token plus its drafter
    proposals at per-lane offsets, writing their K/V rows in place;
    ``runtime.speculative`` turns the distributions into a
    longest-accepted prefix."""

    def step(params, tokens, pool_k, pool_v, row_table, write_rows, starts):
        return lm.verify_chunk_paged(
            params, cfg, tokens, pool_k, pool_v, row_table, write_rows, starts
        )

    return step


def make_budgeted_paged_serve_step(
    cfg: ModelConfig, stream_mask: tuple[bool, ...], stream_depth: int
) -> Callable:
    """The paged serve step under a ``runtime.residency`` plan: layers
    flagged in ``stream_mask`` ((L,) bools; for MoE (L, E): experts) stream
    their FFN weights through ``stream_matmul``'s ring (depth = the plan's
    R_F analogue), the others run the resident path. Same signature as
    ``make_paged_serve_step``. Other families raise the reference's
    ``ValueError`` (hybrid: its SSM state is out of the executor's
    scope)."""
    if not supports_budgeted_decode(cfg):
        raise ValueError(BUDGET_REFUSAL.format(family=cfg.family))
    if cfg.family == "moe":
        mask = tuple(tuple(bool(f) for f in row) for row in stream_mask)
    else:
        mask = tuple(bool(f) for f in stream_mask)

    def step(params, token, pool_k, pool_v, row_table, lengths):
        return lm.decode_step_paged(
            params, cfg, token, pool_k, pool_v, row_table, lengths,
            stream_mask=mask, stream_depth=stream_depth,
        )

    return step


class CapturedStep:
    """A pool step compiled into a CUDA graph: the port's counterpart of
    the reference's jitted steps.

    ``fn(*inputs)`` takes the tensors that change from call to call (token
    ids, row tables, lengths, an index) and closes over the rest:
    parameters and the KV pool, whose addresses the graph binds, so they
    must be updated in place and never reallocated. Every call copies the
    inputs (on any device) into static buffers on ``device``.

    The first call runs ``fn`` eagerly on the buffers: that is the step's
    real result, and it builds and loads every kernel the step launches.
    It then captures ``fn`` once on a side stream into ``mempool`` (one
    scheduler's graphs share one pool), reading the same buffers. A
    capture launches nothing and writes nothing, so the pool rows the
    eager call wrote are not written twice; the kernel launches it meets
    are recorded (``_build.recording_launches``), not counted. Every later
    call copies its inputs in, replays the graph and counts the recorded
    launches once, so the launch counters read what the eager path reads.
    The outputs of a replay are the graph's static tensors, which the next
    replay overwrites: read them before the next call. ``pool_bytes`` is
    what the capture added to the card's reserved memory: the segments
    ``mempool`` took for it. ``first_call_s`` and ``capture_s`` are the
    host seconds of the eager first call (to the card's finish) and of the
    capture: what the first call costs beyond a replay.

    There is no fallback: a capture or replay that fails raises, and the
    step is not run eagerly in its place. No garbage collection runs
    during a capture: a graph freed there (say, an earlier scheduler's, in
    a reference cycle) frees device memory, which a capture forbids, and
    that invalidates the capture.
    """

    def __init__(self, fn: Callable, *, device: torch.device, mempool):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(
                f"CapturedStep compiles a step into a CUDA graph; {device} has none"
            )
        self.fn = fn
        self.device = device
        self.mempool = mempool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.replays = 0
        self.pool_bytes = 0
        self.first_call_s = 0.0
        self.capture_s = 0.0
        self._inputs: tuple[torch.Tensor, ...] = ()
        self._outputs = None
        self._launches: _build.LaunchRecord | None = None

    def __call__(self, *inputs: torch.Tensor):
        if self.graph is None:
            t0 = time.monotonic()
            self._inputs = tuple(
                torch.empty(x.shape, dtype=x.dtype, device=self.device).copy_(x)
                for x in inputs
            )
            out = self.fn(*self._inputs)
            torch.cuda.synchronize(self.device)
            t1 = time.monotonic()
            self._capture()
            self.first_call_s, self.capture_s = t1 - t0, time.monotonic() - t1
            return out
        if len(inputs) != len(self._inputs):
            raise ValueError(
                f"captured step takes {len(self._inputs)} inputs, got {len(inputs)}"
            )
        for buf, x in zip(self._inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        self._launches.replay()
        self.replays += 1
        return self._outputs

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        # free what is garbage now, before the capture; torch.cuda.graph
        # empties the cache before it captures: do it here too, so the
        # reserved bytes before and after differ by the pool's growth
        gc.collect()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _build.recording_launches() as launches:
                with torch.cuda.graph(graph, pool=self.mempool):
                    outputs = self.fn(*self._inputs)
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self._outputs, self._launches = graph, outputs, launches
