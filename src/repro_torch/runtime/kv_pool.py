"""Shared physical KV pool for continuous-batching decode.

Port of ``repro.runtime.kv_pool``. Blocks are **refcounted**: a request's block
table may alias blocks held by other requests or pinned by the radix
prefix cache (``runtime.prefix_cache``), and a block returns to the free
list only when its last holder lets go. Shared blocks are read-only; a
request that must write into a *partially* matched block first takes a
private copy (``adopt_prefix``'s copy-on-write of the tail block). Cached
blocks no live request holds are reclaimable: under admission pressure the
pool asks its attached cache (the ``evictor`` hook) to evict LRU entries.
A memory ledger (``runtime.memledger``) attached as ``ledger`` hears every
mutation, as in the reference. Speculative decoding brackets each verify
cycle with ``begin_draft`` / ``end_draft``: the chain's rows land in blocks
charged to the ``draft`` owner, and a rejected suffix gives them back.

Device side: ``k``/``v`` are (n_kv_cache_layers, n_blocks * block_tokens,
n_kv, hd) row-addressed tensors (n_kv_cache_layers: every layer for the
dense and MoE families, one per shared-block application for hybrid, whose
SSM state the scheduler keeps per lane beside the pool) (the block is an allocator concept only),
updated in place where the reference rebuilt its arrays. They are never
rebound: a captured CUDA graph binds their addresses, so the
copy-on-write copy is an in-place copy between two row ranges. Host side:
a free-block list, per-request block tables, a per-block refcount and the
set of blocks the cache pins. Block 0 is the scratch block idle lanes and
padding write to and read from.

Admission reserves a request's full block commitment (``blocks_for``)
but hands out blocks lazily as tokens arrive:

    invariant:  sum(committed - held) over live requests
                <= free blocks + evictable cached blocks
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.buffers import WeightBuffer
from repro_torch.core.packing import PackItem, baseline_packing, pack_ffd
from repro_torch.core.resource_model import RamPrimitive
from repro_torch.models.config import (
    PAGED_FAMILIES,
    POOL_FAMILIES,
    ModelConfig,
    torch_dtype,
)

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
    held_blocks: int  # unique physical blocks held by live requests
    held_tokens: int  # useful rows in them, each physical row counted once
    free_blocks: int
    committed_blocks: int
    shared_blocks: int = 0  # request-held blocks with > 1 request holder
    cached_blocks: int = 0  # blocks pinned by the prefix cache
    evictable_blocks: int = 0  # cached blocks no live request holds

    @property
    def utilization(self) -> float:
        """Useful KV rows / physical rows held; a block shared by N
        requests counts its rows once."""
        if self.held_blocks == 0:
            return 1.0
        return self.held_tokens / (self.held_blocks * self.block_tokens)

    @property
    def occupancy(self) -> float:
        return self.held_blocks / max(1, self.n_blocks)


class KVPool:
    """One contiguous physical KV cache with refcounted block sharing."""

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        n_blocks: int,
        block_tokens: int,
        dtype: torch.dtype | None = None,
        device=None,
    ):
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"KVPool serves the paged families {PAGED_FAMILIES}; got "
                f"{cfg.family!r} (pure-ssm decode state is fixed-size per "
                "slot and holds no KV rows)"
            )
        if cfg.family not in POOL_FAMILIES:
            raise ValueError(
                f"KVPool serves the ported families {POOL_FAMILIES}; got "
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
        self._cached: set[int] = set()  # blocks pinned by the prefix cache
        self._draft: dict[int, int] = {}  # rid -> blocks grown by an open draft
        # incremental aggregates, so the stats() read of every decode step
        # never rescans the block tables (validate() recounts them)
        self._users: Counter = Counter()  # block -> live request holders
        self._used: dict[int, int] = {}  # block -> deepest row any holder uses
        self._used_total = 0
        self._shared = 0  # blocks with > 1 request holder
        self._evictable = 0  # cached blocks with no request holder
        # the attached prefix cache's eviction hook: (blocks needed) ->
        # blocks actually returned to the free list
        self.evictor: Callable[[int], int] | None = None
        # lifetime counters: alloc - freed always equals the referenced blocks
        self.alloc_blocks = 0
        self.freed_blocks = 0
        self.cow_copies = 0
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
    def cached_blocks(self) -> int:
        return len(self._cached)

    @property
    def evictable_blocks(self) -> int:
        """Cached blocks no live request holds: reclaimable on demand."""
        return self._evictable

    # ---------------- incremental accounting ----------------

    def _add_user(self, block: int) -> None:
        self._users[block] += 1
        if self._users[block] == 2:
            self._shared += 1
        if self._users[block] == 1 and block in self._cached:
            self._evictable -= 1

    def _drop_user(self, block: int) -> None:
        c = self._users[block] - 1
        if c == 0:
            del self._users[block]
            self._used_total -= self._used.pop(block, 0)
            if block in self._cached:
                self._evictable += 1
        else:
            self._users[block] = c
            if c == 1:
                self._shared -= 1

    def _count_use(self, block: int, rows: int) -> None:
        old = self._used.get(block, 0)
        if rows > old:
            self._used[block] = rows
            self._used_total += rows - old

    @property
    def outstanding_commitment(self) -> int:
        return sum(
            max(0, self._committed[r] - len(self._held[r])) for r in self._held
        )

    def ref_count(self, block: int) -> int:
        """Live request holders, plus one while the prefix cache pins it."""
        return self._users.get(block, 0) + (block in self._cached)

    def max_rows(self, max_tokens: int) -> int:
        """Fixed gather width for a serve step admitting <= max_tokens."""
        return self.blocks_for(max_tokens) * self.block_tokens

    # ---------------- lifecycle ----------------

    def can_admit(self, total_tokens: int) -> bool:
        need = self.blocks_for(total_tokens)
        avail = self.free_blocks + self.evictable_blocks
        return avail - self.outstanding_commitment >= need

    def admit(self, rid: int, total_tokens: int) -> None:
        if rid in self._held:
            raise ValueError(f"request {rid} already admitted")
        if not self.can_admit(total_tokens):
            raise RuntimeError(
                f"pool cannot admit request {rid} "
                f"({self.blocks_for(total_tokens)} blocks needed, "
                f"{self.free_blocks + self.evictable_blocks - self.outstanding_commitment}"
                " uncommitted)"
            )
        self._committed[rid] = self.blocks_for(total_tokens)
        self._held[rid] = []
        self._tokens[rid] = 0
        if self.ledger is not None:
            self.ledger.record(
                "admit", owner="request", rid=rid, committed=self._committed[rid]
            )

    def _pop_free(self) -> int:
        """Take a block off the free list, evicting cached blocks first
        when it is empty. Commitment accounting guarantees this succeeds
        for any in-commitment growth."""
        if not self._free and self.evictor is not None:
            self.evictor(1)
        if not self._free:
            raise RuntimeError("pool free list empty and nothing evictable")
        b = self._free.pop()
        self.alloc_blocks += 1
        return b

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
            b = self._pop_free()
            self._add_user(b)
            held.append(b)
        # note_tokens-driven row-coverage drift does not emit (one record a
        # decode token); the ledger's round sync() folds it in
        if self.ledger is not None and len(held) > before:
            self.ledger.record(
                "grow", owner="request", rid=rid, grown=len(held) - before
            )

    def note_tokens(self, rid: int, n_tokens: int) -> None:
        """Record the request's token count (monotone while held: a
        smaller count than already noted keeps the deeper coverage)."""
        self.ensure_rows(rid, n_tokens)
        old = self._tokens[rid]
        if n_tokens <= old:
            return
        self._tokens[rid] = n_tokens
        held, t = self._held[rid], self.block_tokens
        for idx in range(0 if old == 0 else (old - 1) // t, (n_tokens - 1) // t + 1):
            self._count_use(held[idx], min(t, n_tokens - idx * t))

    def begin_draft(self, rid: int, n_tokens: int) -> None:
        """Grow the request's block list to cover a speculative draft
        chain ending at row ``n_tokens``, without advancing the token
        count. Draft rows land in the request's own (private) blocks, so a
        rejected suffix needs no data movement to undo: ``end_draft``
        returns the surplus blocks and the stale rows are overwritten by
        the next chain. Blocks grown here are charged to the ``draft``
        owner in the ledger, apart from committed request growth."""
        held = self._held[rid]
        before = len(held)
        while len(held) * self.block_tokens < n_tokens:
            if len(held) >= self._committed[rid]:
                raise RuntimeError(
                    f"draft for request {rid} exceeds its "
                    f"{self._committed[rid]}-block commitment"
                )
            b = self._pop_free()
            self._add_user(b)
            held.append(b)
        grown = len(held) - before
        if grown:
            self._draft[rid] = self._draft.get(rid, 0) + grown
            if self.ledger is not None:
                self.ledger.record("draft_grow", owner="draft", rid=rid, grown=grown)

    def end_draft(self, rid: int, n_tokens: int) -> None:
        """Settle a draft chain at its accepted length: rows through
        ``n_tokens`` become committed coverage (``note_tokens``); draft
        blocks past the accepted prefix go back to the free list. Exactly
        inverts ``begin_draft`` when nothing is accepted into the drafted
        blocks, so the ledger integrates to zero across a rejected chain."""
        draft = self._draft.pop(rid, 0)
        held = self._held[rid]
        keep = max(self.blocks_for(n_tokens), len(held) - draft)
        freed = 0
        while len(held) > keep:
            b = held.pop()
            self._drop_user(b)
            if not self.ref_count(b):
                self._free.append(b)
                self.freed_blocks += 1
            freed += 1
        self.note_tokens(rid, n_tokens)
        if self.ledger is not None and (draft or freed):
            self.ledger.record(
                "draft_end", owner="draft", rid=rid, kept=draft - freed, freed=freed
            )

    def draft_rids(self) -> tuple[int, ...]:
        """Requests holding draft-class blocks (empty outside a
        ``begin_draft`` / ``end_draft`` bracket)."""
        return tuple(self._draft)

    def adopt_prefix(
        self,
        rid: int,
        shared: tuple[int, ...],
        tail_block: int | None,
        n_tokens: int,
    ) -> None:
        """Alias a matched prefix's blocks into a fresh request's table.

        ``shared`` are the cache's full blocks covering rows
        ``[0, len(shared) * block_tokens)``, adopted read-only (refcount
        bumped). ``tail_block`` (required iff ``n_tokens`` is not
        block-aligned) holds the partially matched block: the request will
        write rows ``n_tokens..`` of that block span, so it gets a private
        copy-on-write duplicate, copied in place inside ``k`` and ``v``.
        Must run right after ``admit``, before any rows are held.
        """
        held = self._held[rid]
        if held or self._tokens[rid]:
            raise RuntimeError(f"request {rid} must adopt a prefix before holding rows")
        t = self.block_tokens
        if len(shared) != n_tokens // t:
            raise ValueError(
                f"{len(shared)} shared blocks cannot cover "
                f"{n_tokens // t} full blocks of {n_tokens} tokens"
            )
        if (tail_block is None) != (n_tokens % t == 0):
            raise ValueError(
                f"tail block required iff the matched prefix ({n_tokens} "
                f"tokens) ends mid-block (block_tokens={t})"
            )
        if len(shared) + (tail_block is not None) > self._committed[rid]:
            raise RuntimeError(f"adopted prefix exceeds request {rid}'s commitment")
        for b in shared:
            if b == SCRATCH_BLOCK or not self.ref_count(b):
                raise ValueError(f"cannot adopt unallocated block {b}")
            self._add_user(b)
            held.append(b)
        if tail_block is not None:
            if tail_block == SCRATCH_BLOCK or not self.ref_count(tail_block):
                raise ValueError(f"cannot adopt unallocated block {tail_block}")
            new = self._pop_free()
            # in place: the captured steps hold these tensors' addresses
            for pool in (self.k, self.v):
                pool[:, new * t : (new + 1) * t].copy_(
                    pool[:, tail_block * t : (tail_block + 1) * t]
                )
            self._add_user(new)
            held.append(new)
            self.cow_copies += 1
        self.note_tokens(rid, n_tokens)
        if self.ledger is not None:
            self.ledger.record(
                "adopt_prefix", owner="request", rid=rid, shared=len(shared),
                cow=int(tail_block is not None),
            )

    def release(self, rid: int) -> None:
        if rid not in self._held:
            raise ValueError(
                f"release of unknown request {rid}: it was never admitted "
                "or was already released (double free)"
            )
        for b in self._held.pop(rid):
            self._drop_user(b)
            if not self.ref_count(b):
                self._free.append(b)
                self.freed_blocks += 1
        del self._tokens[rid], self._committed[rid]
        self._draft.pop(rid, None)
        if self.ledger is not None:
            self.ledger.record("release", owner="request", rid=rid)

    # ---------------- prefix-cache pinning ----------------

    def retain_cached(self, block: int) -> None:
        """Pin a block on behalf of the prefix cache (one pin per block)."""
        if block == SCRATCH_BLOCK or not self.ref_count(block):
            raise ValueError(f"cannot cache unallocated block {block}")
        if block in self._cached:
            raise ValueError(f"block {block} already cached")
        self._cached.add(block)
        if self.ledger is not None:
            self.ledger.record("retain_cached", owner="prefix-cache", block=block)

    def uncache(self, block: int) -> int:
        """Drop the cache's pin; returns 1 if the block went free, else 0.
        A block a live request holds never goes free here."""
        if block not in self._cached:
            raise ValueError(f"block {block} is not cached")
        self._cached.remove(block)
        freed = 0
        if not self.ref_count(block):
            self._free.append(block)
            self._evictable -= 1  # it was cache-only; now it is free
            self.freed_blocks += 1
            freed = 1
        if self.ledger is not None:
            self.ledger.record("uncache", owner="prefix-cache", block=block)
        return freed

    # ---------------- introspection ----------------

    def live_requests(self) -> list[int]:
        return list(self._held)

    def blocks_of(self, rid: int) -> tuple[int, ...]:
        return tuple(self._held[rid])

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
        place. Cold path only: the request's blocks must be private (a warm
        admission writes its suffix through the chunk step, which never
        touches adopted rows). ``ks``/``vs`` may be right-padded past
        ``n_tokens`` (the prefill bucket); padded rows land in the scratch
        block."""
        p = n_tokens if n_tokens is not None else ks.shape[1]
        self.note_tokens(rid, p)
        rows = self.rows_of(rid)[:p]
        if ks.shape[1] > p:
            rows = np.concatenate([rows, self.scratch_rows(ks.shape[1] - p)])
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self.k.index_copy_(1, idx, ks.to(self.k.dtype))
        self.v.index_copy_(1, idx, vs.to(self.v.dtype))

    def export_blocks(
        self, rid: int, n_tokens: int | None = None
    ) -> tuple[tuple[int, ...], torch.Tensor, torch.Tensor]:
        """A request's K/V for a handoff, in block-id order: (block ids, K
        rows, V rows), the rows shaped (L, n_tokens, n_kv, hd). ``rows_of``
        gathers rows in the order the blocks were allocated, so the ids
        describe the payload's layout. The rows are copies on the pool's
        device (``index_select``): the importing pool may share the card,
        and the payload must not follow this pool's later writes. Shared
        (prefix-cache) blocks export by value like any other; the importing
        pool writes them into blocks of its own (``write_prefill``)."""
        ids = tuple(self._held[rid])
        n = n_tokens if n_tokens is not None else self._tokens[rid]
        idx = torch.from_numpy(self.rows_of(rid)[:n].astype(np.int64)).to(self.device)
        return ids, self.k.index_select(1, idx), self.v.index_select(1, idx)

    # ---------------- accounting ----------------

    def stats(self) -> PoolStats:
        return PoolStats(
            n_blocks=self.usable_blocks,
            block_tokens=self.block_tokens,
            held_blocks=len(self._users),
            held_tokens=self._used_total,
            free_blocks=self.free_blocks,
            committed_blocks=self.outstanding_commitment,
            shared_blocks=self._shared,
            cached_blocks=len(self._cached),
            evictable_blocks=self._evictable,
        )

    def validate(self) -> None:
        """Allocator invariants: no free+referenced overlap, free-list
        uniqueness, full accounting, every open draft bracket within its
        request's blocks, the incremental aggregates equal to a recount,
        block conservation."""
        if len(self._free) != len(set(self._free)):
            raise AssertionError("free list holds duplicate blocks")
        holders: Counter = Counter()
        for bs in self._held.values():
            holders.update(bs)
        referenced = set(holders) | self._cached
        if SCRATCH_BLOCK in referenced or SCRATCH_BLOCK in self._free:
            raise AssertionError("scratch block entered circulation")
        if referenced & set(self._free):
            raise AssertionError("block simultaneously referenced and free")
        if len(referenced) + len(self._free) != self.usable_blocks:
            raise AssertionError("blocks leaked")
        for rid, bs in self._held.items():
            if len(bs) != len(set(bs)):
                raise AssertionError(f"request {rid} holds a block twice")
            if self._tokens[rid] > len(bs) * self.block_tokens:
                raise AssertionError(f"request {rid} overflows its blocks")
        for rid, n in self._draft.items():
            if rid not in self._held or n > len(self._held[rid]):
                raise AssertionError(f"draft bracket for request {rid} out of sync")
        used: dict[int, int] = {}
        t = self.block_tokens
        for rid, bs in self._held.items():
            for i, b in enumerate(bs):
                r = min(t, max(0, self._tokens[rid] - i * t))
                if r:  # draft-grown blocks carry no committed rows yet
                    used[b] = max(used.get(b, 0), r)
        if holders != self._users:
            raise AssertionError("per-block holder counts drifted")
        if used != self._used or sum(used.values()) != self._used_total:
            raise AssertionError("per-block row-coverage drifted")
        if self._shared != sum(1 for n in holders.values() if n > 1):
            raise AssertionError("shared-block tally drifted")
        if self._evictable != sum(1 for b in self._cached if b not in holders):
            raise AssertionError("evictable-block tally drifted")
        if self.alloc_blocks - self.freed_blocks != len(referenced):
            raise AssertionError(
                f"block conservation violated: {self.alloc_blocks} allocated"
                f" - {self.freed_blocks} freed != {len(referenced)} live"
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
