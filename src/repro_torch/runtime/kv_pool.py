"""Shared physical KV pool for continuous-batching decode.

Port of ``repro.runtime.kv_pool`` without refcounted sharing, prefix
adoption and draft brackets (later slices); a memory ledger
(``runtime.memledger``) attached as ``ledger`` hears every admit, block
growth and release, as in the reference. Device side:
``k``/``v`` are (n_kv_cache_layers, n_blocks * block_tokens, n_kv, hd)
row-addressed tensors (the block is an allocator concept only), updated
in place with indexed writes where the reference rebuilt its arrays. Host
side: a free-block list and per-request block tables. Block 0 is the
scratch block idle lanes and padding write to and read from.

Admission reserves a request's full block commitment (``blocks_for``)
but hands out blocks lazily as tokens arrive:

    invariant:  sum(committed - held) over live requests <= free blocks
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.buffers import WeightBuffer
from repro_torch.core.packing import PackItem, baseline_packing, pack_ffd
from repro_torch.core.resource_model import RamPrimitive
from repro_torch.models.config import PORTED_FAMILIES, ModelConfig, torch_dtype

SCRATCH_BLOCK = 0  # block 0 is never allocated; idle slots write/read it


def kv_block_ram(block_tokens: int) -> RamPrimitive:
    """A pool block as a RAM primitive: one legal shape, 1 x block_tokens."""
    return RamPrimitive(
        name="KVBLOCK",
        capacity_bits=block_tokens,
        n_ports=2,
        configs=((1, block_tokens),),
    )


def request_buffer(rid: int, n_tokens: int) -> WeightBuffer:
    """A request's KV footprint as a logical buffer (1 lane x tokens)."""
    return WeightBuffer(f"req{rid}", width_bits=1, depth_words=n_tokens, w_bits=1)


def blocks_for_tokens(n_tokens: int, block_tokens: int) -> int:
    """Blocks a request of ``n_tokens`` rows needs: the reference's
    ``WeightBuffer.blocks`` over a (1, block_tokens) RAM, whose single
    legal shape makes it ceil(n / t)."""
    return -(-n_tokens // block_tokens) if n_tokens > 0 else 0


def choose_block_tokens(
    lengths: list[int],
    candidates: tuple[int, ...] = (4, 8, 16, 32, 64),
    overhead_rows: float = 0.5,
) -> int:
    """Pick the block size minimising lifetime pool waste for a length mix.

    A decode cache grows 1 -> L tokens, so the cost of a block size is the
    request-lifetime average of (allocated rows - held tokens) plus a
    per-block bookkeeping overhead.
    """
    if not lengths:
        return candidates[0]
    counts = Counter(lengths)
    best_t, best_cost = candidates[0], None
    for t in candidates:
        cost = 0.0
        for length, n in counts.items():
            blocks = [
                blocks_for_tokens(l, t) for l in range(1, max(2, length + 1))
            ]
            waste = sum(b * t - l for l, b in enumerate(blocks, start=1))
            cost += n * (waste + overhead_rows * sum(blocks)) / len(blocks)
        if best_cost is None or cost < best_cost:
            best_t, best_cost = t, cost
    return best_t


@dataclasses.dataclass
class PoolStats:
    n_blocks: int
    block_tokens: int
    held_blocks: int
    held_tokens: int
    free_blocks: int
    committed_blocks: int
    # the reference's sharing and prefix-cache gauges: 0 on a pool whose
    # blocks are all private and uncached, as the reference reports them
    shared_blocks: int = 0
    cached_blocks: int = 0
    evictable_blocks: int = 0

    @property
    def utilization(self) -> float:
        """Useful KV rows / physical rows held."""
        if self.held_blocks == 0:
            return 1.0
        return self.held_tokens / (self.held_blocks * self.block_tokens)

    @property
    def occupancy(self) -> float:
        return self.held_blocks / max(1, self.n_blocks)


class KVPool:
    """One contiguous physical KV cache carved into fixed-size blocks."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        n_blocks: int,
        block_tokens: int,
        dtype: torch.dtype | None = None,
        device=None,
    ):
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(
                f"KVPool serves the ported families {PORTED_FAMILIES}; got "
                f"{cfg.family!r}"
            )
        if n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the scratch block)")
        self.cfg = cfg
        self.n_blocks = n_blocks
        self.block_tokens = block_tokens
        self.ram = kv_block_ram(block_tokens)
        self.device = resolve_device(device)
        shape = (cfg.n_kv_cache_layers, n_blocks * block_tokens, cfg.n_kv, cfg.hd)
        dt = dtype or torch_dtype(cfg)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self._free: list[int] = list(range(n_blocks - 1, SCRATCH_BLOCK, -1))
        self._held: dict[int, list[int]] = {}
        self._tokens: dict[int, int] = {}
        self._committed: dict[int, int] = {}
        self._used_total = 0  # rows in use over all held blocks
        # lifetime counters: alloc - freed always equals the held-block count
        self.alloc_blocks = 0
        self.freed_blocks = 0
        self.cow_copies = 0  # no copy-on-write without prefix adoption
        # the attached memory ledger (runtime.memledger.MemLedger.attach);
        # every mutation below notifies it
        self.ledger = None

    @classmethod
    def for_slots(
        cls,
        cfg: ModelConfig,
        *,
        slots: int,
        max_len: int,
        block_tokens: int,
        dtype: torch.dtype | None = None,
        device=None,
    ) -> "KVPool":
        """A pool sized so ``slots`` concurrent max_len requests always fit
        (their full block commitments, plus the scratch block)."""
        per_slot = blocks_for_tokens(max_len, block_tokens)
        return cls(
            cfg, n_blocks=1 + slots * per_slot, block_tokens=block_tokens,
            dtype=dtype, device=device,
        )

    # ---------------- geometry ----------------

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for_tokens(n_tokens, self.block_tokens)

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def outstanding_commitment(self) -> int:
        return sum(
            max(0, self._committed[r] - len(self._held[r])) for r in self._held
        )

    def max_rows(self, max_tokens: int) -> int:
        """Fixed gather width for a serve step admitting <= max_tokens."""
        return self.blocks_for(max_tokens) * self.block_tokens

    # ---------------- lifecycle ----------------

    def can_admit(self, total_tokens: int) -> bool:
        need = self.blocks_for(total_tokens)
        return self.free_blocks - self.outstanding_commitment >= need

    def admit(self, rid: int, total_tokens: int) -> None:
        if rid in self._held:
            raise ValueError(f"request {rid} already admitted")
        if not self.can_admit(total_tokens):
            raise RuntimeError(
                f"pool cannot admit request {rid} "
                f"({self.blocks_for(total_tokens)} blocks needed, "
                f"{self.free_blocks - self.outstanding_commitment} uncommitted)"
            )
        self._committed[rid] = self.blocks_for(total_tokens)
        self._held[rid] = []
        self._tokens[rid] = 0
        if self.ledger is not None:
            self.ledger.record(
                "admit", owner="request", rid=rid, committed=self._committed[rid]
            )

    def ensure_rows(self, rid: int, n_tokens: int) -> None:
        """Grow the request's block list to hold ``n_tokens`` rows."""
        held = self._held[rid]
        before = len(held)
        while len(held) * self.block_tokens < n_tokens:
            if len(held) >= self._committed[rid]:
                raise RuntimeError(
                    f"request {rid} exceeds its {self._committed[rid]}-block "
                    "commitment"
                )
            held.append(self._free.pop())
            self.alloc_blocks += 1
        # note_tokens-driven row-coverage drift does not emit (one record a
        # decode token); the ledger's round sync() folds it in
        if self.ledger is not None and len(held) > before:
            self.ledger.record(
                "grow", owner="request", rid=rid, grown=len(held) - before
            )

    def note_tokens(self, rid: int, n_tokens: int) -> None:
        """Record the request's token count (monotone while held)."""
        self.ensure_rows(rid, n_tokens)
        old = self._tokens[rid]
        if n_tokens > old:
            self._tokens[rid] = n_tokens
            self._used_total += n_tokens - old

    def release(self, rid: int) -> None:
        if rid not in self._held:
            raise ValueError(
                f"release of unknown request {rid}: it was never admitted "
                "or was already released (double free)"
            )
        blocks = self._held.pop(rid)
        self._free.extend(blocks)
        self.freed_blocks += len(blocks)
        self._used_total -= self._tokens.pop(rid)
        del self._committed[rid]
        if self.ledger is not None:
            self.ledger.record("release", owner="request", rid=rid)

    # ---------------- introspection ----------------

    def live_requests(self) -> list[int]:
        return list(self._held)

    def blocks_held(self, rid: int) -> int:
        return len(self._held[rid])

    def tokens_held(self, rid: int) -> int:
        return self._tokens[rid]

    # ---------------- device-side addressing ----------------

    def rows_of(self, rid: int, pad_to: int | None = None) -> np.ndarray:
        """Physical row indices of the request's tokens, scratch-padded."""
        t = self.block_tokens
        blocks = np.asarray(self._held[rid], np.int64)
        rows = (blocks[:, None] * t + np.arange(t)[None, :]).reshape(-1)
        if pad_to is not None:
            pad = np.full((pad_to - len(rows),), SCRATCH_BLOCK * t, np.int64)
            rows = np.concatenate([rows, pad])
        return rows.astype(np.int32)

    def scratch_rows(self, pad_to: int) -> np.ndarray:
        return np.full((pad_to,), SCRATCH_BLOCK * self.block_tokens, np.int32)

    def write_prefill(
        self,
        rid: int,
        ks: torch.Tensor,
        vs: torch.Tensor,
        n_tokens: int | None = None,
    ) -> None:
        """Write a prefilled (L, P, n_kv, hd) KV prefix into the pool, in
        place. ``ks``/``vs`` may be right-padded past ``n_tokens`` (the
        prefill bucket); padded rows land in the scratch block."""
        p = n_tokens if n_tokens is not None else ks.shape[1]
        self.note_tokens(rid, p)
        rows = self.rows_of(rid)[:p]
        if ks.shape[1] > p:
            rows = np.concatenate([rows, self.scratch_rows(ks.shape[1] - p)])
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self.k.index_copy_(1, idx, ks.to(self.k.dtype))
        self.v.index_copy_(1, idx, vs.to(self.v.dtype))

    # ---------------- accounting ----------------

    def stats(self) -> PoolStats:
        return PoolStats(
            n_blocks=self.usable_blocks,
            block_tokens=self.block_tokens,
            held_blocks=sum(len(b) for b in self._held.values()),
            held_tokens=self._used_total,
            free_blocks=self.free_blocks,
            committed_blocks=self.outstanding_commitment,
        )

    def validate(self) -> None:
        """Allocator invariants: no free+held overlap, free-list
        uniqueness, full accounting, block conservation."""
        if len(self._free) != len(set(self._free)):
            raise AssertionError("free list holds duplicate blocks")
        held = [b for bs in self._held.values() for b in bs]
        if len(held) != len(set(held)):
            raise AssertionError("a block is held twice")
        if SCRATCH_BLOCK in held or SCRATCH_BLOCK in self._free:
            raise AssertionError("scratch block entered circulation")
        if set(held) & set(self._free):
            raise AssertionError("block simultaneously held and free")
        if len(held) + len(self._free) != self.usable_blocks:
            raise AssertionError("blocks leaked")
        for rid, bs in self._held.items():
            if self._tokens[rid] > len(bs) * self.block_tokens:
                raise AssertionError(f"request {rid} overflows its blocks")
        if self._used_total != sum(self._tokens.values()):
            raise AssertionError("row-coverage tally drifted")
        if self.alloc_blocks - self.freed_blocks != len(held):
            raise AssertionError(
                f"block conservation violated: {self.alloc_blocks} allocated"
                f" - {self.freed_blocks} freed != {len(held)} held"
            )

    def fragmentation_report(self) -> dict:
        """Baseline (private blocks) vs the ``pack_ffd`` tail-sharing bound.

        Each request's footprint is its own buffer (``baseline_packing``);
        FFD with height H_B=4 quotes what packing request tails into shared
        blocks would save: the serving analogue of the paper's baseline vs
        FCMP BRAM comparison."""
        items = [
            PackItem(request_buffer(rid, self._tokens[rid]))
            for rid in sorted(self._held)
            if self._tokens[rid] > 0
        ]
        base = baseline_packing(items, self.ram)
        packed = pack_ffd(items, max_height=4, ram=self.ram)
        return {
            "baseline_blocks": base.total_blocks,
            "ffd_blocks": packed.total_blocks,
            "baseline_efficiency": base.efficiency,
            "ffd_efficiency": packed.efficiency,
        }
