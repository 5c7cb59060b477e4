"""The system under test, built as the port's serving entry point builds
it: the port's model configuration from a configuration file, weights made
on the device from the seed, and the pool engine of
``repro_torch.launch.serve.build_pool_engine`` (a ``KVPool``, a
``PrefixCache``, the memory ledger and its pressure monitor, and a
``Scheduler`` whose steps are CUDA graphs on the card).

Warm-up drives the engine through its public calls (``submit`` and
``round``) with requests of every prompt shape the mix sends, so that every
graph the window replays is captured before the window opens.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.kv_pool import KVPool, blocks_for_tokens
from repro_torch.runtime.memledger import MemLedger, MemPressureMonitor
from repro_torch.runtime.prefix_cache import PrefixCache
from repro_torch.runtime.scheduler import RequestState, Scheduler

from harness.traffic import SEED_MASK, Mix, seed_words

# weight scales by leaf name (the port's init_params scales); every other
# leaf is a projection, N(0, 1 / hidden_size)
FIXED_STD = {"embed": 0.02, "unembed": 0.02, "router": 0.02}


def port_config(c: dict, w_bits: int | None = None) -> ModelConfig:
    """The port's ``ModelConfig`` of a configuration file's sizes."""
    return ModelConfig(
        name=c["name"],
        family=c["family"],
        n_layers=int(c["num_hidden_layers"]),
        d_model=int(c["hidden_size"]),
        n_heads=int(c["num_attention_heads"]),
        n_kv=int(c["num_key_value_heads"]),
        d_ff=int(c["intermediate_size"]),
        vocab=int(c["vocab_size"]),
        head_dim=int(c["head_dim"]),
        n_experts=int(c.get("num_experts", 0)),
        experts_per_token=int(c.get("num_experts_per_tok", 0)),
        rope_theta=float(c["rope_theta"]),
        norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=bool(c["tie_word_embeddings"]),
        w_bits=int(c.get("w_bits", 0)) if w_bits is None else w_bits,
        dtype=c["torch_dtype"],
    )


def _std(name: str, d: int) -> float | None:
    """A leaf's scale; None for a norm's gain (ones)."""
    if name.startswith("ln") or name.endswith("norm"):
        return None
    if name in FIXED_STD:
        return FIXED_STD[name]
    return (0.5 if name == "w2" else 1.0) / math.sqrt(d)


def make_weights(c: dict, seed: int, device: torch.device) -> dict:
    """The dense weights of a configuration, drawn on ``device`` from the
    seed: one ``randn`` a leaf, in the leaf's dtype, in the tree and
    order of ``lm.abstract_params``. A nested dict of plain tensors."""
    tree = lm.abstract_params(port_config(c, w_bits=0)).tree()
    gen = torch.Generator(device=device).manual_seed(seed & SEED_MASK)
    d = int(c["hidden_size"])

    def fill(name: str, meta: torch.Tensor) -> torch.Tensor:
        std = _std(name, d)
        if std is None:
            return torch.ones(meta.shape, dtype=meta.dtype, device=device)
        t = torch.randn(meta.shape, generator=gen, dtype=meta.dtype, device=device)
        return t.mul_(std)

    out: dict = {}
    for name, leaf in tree.items():
        out[name] = ({k: fill(k, v) for k, v in leaf.items()} if isinstance(leaf, dict)
                     else fill(name, leaf))
    return out


def program_params(c: dict, weights: dict) -> lm.LMParams:
    """The program's parameters: the dense weights as ``LMParams``, their
    FFN packed by the port's ``lm.pack_ffn_params`` when the configuration
    sets ``w_bits``."""
    params = lm.LMParams(weights)
    bits = int(c.get("w_bits", 0))
    return lm.pack_ffn_params(params, bits) if bits else params


def extra_blocks(mix: Mix, block_tokens: int) -> int:
    """Pool blocks beyond the lanes' own: room for every document a mix
    shares, so that the cache can hold them all beside the lanes."""
    if not mix.docs:
        return 0
    return int(mix.docs["count"]) * blocks_for_tokens(int(mix.docs["tokens"]), block_tokens)


def build_engine(c: dict, params: lm.LMParams, mix: Mix, device: torch.device) -> Scheduler:
    """The pool engine of ``launch.serve.build_pool_engine`` for the
    configuration's engine settings, its pool enlarged by
    ``extra_blocks``."""
    e = c["engine"]
    cfg = port_config(c)
    bt, lanes, max_len = int(e["block_tokens"]), int(e["lanes"]), int(e["max_len"])
    n_blocks = 1 + lanes * blocks_for_tokens(max_len, bt) + extra_blocks(mix, bt)
    pool = KVPool(cfg, n_blocks=n_blocks, block_tokens=bt, device=device)
    return Scheduler(
        cfg,
        params,
        pool,
        slots=lanes,
        max_len=max_len,
        decode_per_round=e.get("decode_per_round") or None,
        sampling=lm.SamplingParams(temperature=0.0),
        prefill_chunk=int(e["prefill_chunk"]),
        compiled=device.type == "cuda",
        prefix_cache=PrefixCache(pool) if e["prefix_cache"] else None,
        ledger=MemLedger(time.monotonic),
        mem_monitor=MemPressureMonitor(),
    )


def drain(sched: Scheduler, rids: list[int], until=RequestState.DONE, max_rounds: int = 100_000) -> None:
    """Run rounds until every one of ``rids`` has reached ``until`` (DONE,
    or DECODE: its first token made)."""
    order = [RequestState.QUEUED, RequestState.PREFILL, RequestState.DECODE, RequestState.DONE]
    want = order.index(until)
    for _ in range(max_rounds):
        if all(order.index(sched.requests[r].state) >= want for r in rids):
            return
        sched.round()
    raise RuntimeError(f"warm-up did not finish in {max_rounds} rounds")


def warm_up(sched: Scheduler, mix: Mix, documents: list[np.ndarray], seed: int, vocab: int) -> dict:
    """Capture every graph the mix's shapes can use, through ``submit``
    and ``round``: a whole-prompt prefill of every bucket a prompt of the
    mix's range can fall into (each multiple of the block up to the
    chunk), the chunk step (a prompt longer than a chunk, or a shared
    document), and the decode step. Each document is sent once, so the
    cache holds it before the window, as that traffic needs. The warm-up
    prompts start with tokens no other prompt starts with, so that none
    takes a cached prefix (and the chunk step) in place of its bucket; a
    bucket left without its graph is sent again. Returns the buckets and
    the graphs captured."""
    bt, chunk = sched.pool.block_tokens, sched.prefill_chunk
    rng = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 3)))
    shortest, longest = mix.prompt_range()
    first, last = (max(bt, -(-n // bt) * bt) for n in (shortest, min(chunk, longest)))
    buckets = [] if documents else list(range(first, last + 1, bt))
    taken = {int(d[0]) for d in documents}
    firsts = iter(t for t in rng.permutation(vocab).tolist() if t not in taken)

    def prompt(n: int) -> np.ndarray:
        p = rng.integers(0, vocab, n, dtype=np.int64).astype(np.int32)
        p[0] = next(firsts)
        return p

    todo = [prompt(b) for b in buckets]
    if not documents and longest > chunk:
        todo.append(prompt(chunk + 1))
    todo.extend(documents)
    sent = 0
    for _ in range(3):
        drain(sched, [sched.submit(p, 2) for p in todo])
        sent += len(todo)
        todo = ([prompt(b) for b in buckets if b not in sched.prefill_buckets]
                if sched.compiled else [])
        if not todo:
            break
    if todo or (sched.compiled and sched.decode_graph is None):
        raise RuntimeError(f"warm-up left buckets {[len(p) for p in todo]} without a graph")
    return {"buckets": buckets, "graphs": len(sched.graphs), "warm_requests": sent}
