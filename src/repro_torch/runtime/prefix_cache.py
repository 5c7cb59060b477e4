"""Radix-tree prefix index over committed token-id sequences.

Port of ``repro.runtime.prefix_cache`` (numpy only, copied; it indexes
the port's ``KVPool``). The port serves the dense, MoE and hybrid families
with it; the hybrid scheduler commits and looks up the anchors below.

The serving analog of the paper's FCMP cascade one level up: the KV pool
already packs many requests into one physical memory; the prefix cache
makes *identical logical content* share the same physical blocks. A
committed prompt's KV blocks stay pinned after the request releases
them; a new request walks the tree, adopts the blocks of its longest
cached prefix (refcount bump in ``KVPool``), and prefills only the
unmatched suffix — identical prefixes are prefilled and stored once, not
N times.

Structure: one node per **full** pool block, keyed by the block's
``block_tokens`` token ids; children hang off their parent's exact token
path, so a root-to-node walk spells out a committed prefix and the
blocks along it are exactly the rows a matching request can alias.
Matching may also stop *inside* a block (a divergence mid-block, or the
always-prefill-the-last-token cap): the partially-matched block is
returned separately and the pool duplicates it copy-on-write, because
the adopter will write its own rows into that block span.

Hybrid (zamba2) requests need more than KV rows to skip prefill — the
SSM recurrence must resume from the matched position. Nodes therefore
carry **anchors**: a committed prompt's exact end position, its partial
tail block (if unaligned), and a host-side snapshot of the per-request
SSM lane state at that position. A hybrid lookup returns the deepest
anchor whose token path prefixes the new prompt; the scheduler seeds
``lm.prefill_suffix_paged_hybrid`` with the snapshot.

Eviction is LRU over leaves (childless, anchor-free nodes) and anchors
whose blocks no live request shares; it runs on demand through the
pool's ``evictor`` hook when admission needs blocks, so cached blocks
cost nothing until memory pressure exists. Eviction can never free a
block a live request holds — ``KVPool.uncache`` only releases blocks at
refcount zero.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.runtime.kv_pool import KVPool


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """One lookup result: alias ``shared``, COW ``tail_block``, start
    the suffix prefill at token ``matched``."""

    matched: int  # usable matched tokens (the suffix prefill offset)
    shared: tuple[int, ...]  # full blocks to alias (refcount bump)
    tail_block: int | None  # partially-matched block to copy-on-write
    lane_state: Any = None  # hybrid anchor's SSM snapshot (host pytree)


class _Anchor:
    """A hybrid resume point: prompt end + SSM state at that position."""

    __slots__ = ("tail", "tail_block", "n_tokens", "lane_state", "stamp")

    def __init__(self, tail, tail_block, n_tokens, lane_state, stamp):
        self.tail = tail  # tokens past the node's block path (< block)
        self.tail_block = tail_block  # their partial block, or None
        self.n_tokens = n_tokens  # == node depth * block_tokens + len(tail)
        self.lane_state = lane_state  # np leaves (L, 1, ...) at n_tokens
        self.stamp = stamp


class _Node:
    __slots__ = ("key", "block", "children", "anchors", "parent", "stamp")

    def __init__(self, key, block, parent, stamp):
        self.key = key  # tuple of block_tokens token ids
        self.block = block  # the physical pool block holding their KV
        self.children: dict[tuple, _Node] = {}
        self.anchors: list[_Anchor] = []
        self.parent = parent
        self.stamp = stamp


class PrefixCache:
    """Block-granular radix index over a ``KVPool``'s committed prompts."""

    def __init__(self, pool: KVPool):
        self.pool = pool
        self.bt = pool.block_tokens
        self.root = _Node((), None, None, 0)
        self._nodes: set[_Node] = set()  # flat registry for eviction scans
        # pin multiset: the pool holds ONE pin per cached block; a block
        # can be pinned here by several units (an anchor's partial tail
        # block becomes a full node when the finished conversation is
        # re-committed with its generated tokens), so the pool pin is
        # taken on the first retain and dropped on the last release
        self._pins: dict[int, int] = {}
        self._clock = 0
        self.hits = 0
        self.lookups = 0
        self.evicted_blocks = 0
        pool.evictor = self.evict

    def _retain(self, block: int) -> None:
        n = self._pins.get(block, 0)
        if n == 0:
            self.pool.retain_cached(block)
        self._pins[block] = n + 1

    def _release_pin(self, block: int) -> int:
        """Drop one cache-unit pin; returns blocks actually freed."""
        n = self._pins[block] - 1
        if n > 0:
            self._pins[block] = n
            return 0
        del self._pins[block]
        return self.pool.uncache(block)

    # ---------------- internals ----------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _tokens(prompt) -> tuple[int, ...]:
        return tuple(int(t) for t in np.asarray(prompt).tolist())

    def _walk(self, toks: tuple[int, ...], touch: bool):
        """Descend full-block matches. Returns (chain of (node, block),
        final node, tokens matched in full blocks, partial-child info)."""
        node, depth, chain = self.root, 0, []
        while depth + self.bt <= len(toks):
            key = toks[depth : depth + self.bt]
            child = node.children.get(key)
            if child is None:
                break
            if touch:
                child.stamp = self._tick()
            chain.append(child.block)
            node, depth = child, depth + self.bt
        # longest partial match among the divergent children
        partial_len, partial_block = 0, None
        rest = toks[depth:]
        for key, child in node.children.items():
            n = 0
            for a, b in zip(key, rest):
                if a != b:
                    break
                n += 1
            if n > partial_len:
                partial_len, partial_block = n, child.block
        return chain, node, depth, partial_len, partial_block

    # ---------------- lookup ----------------

    def lookup(self, prompt, *, anchor: bool = False, peek: bool = False):
        """Longest-cached-prefix match for a prompt.

        ``anchor=True`` (hybrid) returns only anchor-bearing prefixes —
        positions where an SSM snapshot exists. The match is always
        capped at ``len(prompt) - 1``: at least one real token must
        prefill so the request has logits to sample its first output
        from. Returns a ``PrefixMatch`` or None; ``peek`` skips LRU
        stamps and hit accounting (router scoring).
        """
        toks = self._tokens(prompt)
        cap = len(toks) - 1
        if not peek:
            self.lookups += 1
        if cap <= 0:
            return None
        chain, node, depth, partial_len, partial_block = self._walk(
            toks, touch=not peek
        )
        if anchor:
            best = None
            n, d = node, depth
            while n is not None:  # deepest-first up the matched path
                for a in n.anchors:
                    if a.n_tokens > cap or a.n_tokens <= 0:
                        continue
                    if toks[d : d + len(a.tail)] != a.tail:
                        continue
                    if best is None or a.n_tokens > best[0].n_tokens:
                        best = (a, d)
                if best is not None:
                    break
                n, d = n.parent, d - self.bt
            if best is None:
                return None
            a, d = best
            if not peek:
                a.stamp = self._tick()
                self.hits += 1
            return PrefixMatch(
                matched=a.n_tokens,
                shared=tuple(chain[: d // self.bt]),
                tail_block=a.tail_block,
                lane_state=a.lane_state,
            )
        m = min(depth + partial_len, cap)
        if m <= 0:
            return None
        shared = tuple(chain[: m // self.bt])
        tail = None
        if m % self.bt:
            tail = chain[m // self.bt] if m // self.bt < len(chain) else (
                partial_block
            )
        if not peek:
            self.hits += 1
        return PrefixMatch(matched=m, shared=shared, tail_block=tail)

    def match_tokens(self, prompt, *, anchor: bool = False) -> int:
        """Router scoring: matched tokens without touching LRU state."""
        m = self.lookup(prompt, anchor=anchor, peek=True)
        return 0 if m is None else m.matched

    # ---------------- commit ----------------

    def commit(self, prompt, blocks, lane_state=None) -> None:
        """Index a prefilled prompt's blocks.

        Every *full* block becomes (or refreshes) a radix node, pinned in
        the pool; the request keeps using the blocks — the pin just keeps
        them alive past release. ``lane_state`` (hybrid) additionally
        records an anchor at the exact prompt end, pinning the partial
        tail block when the prompt is not block-aligned. When a node for
        a block's token key already exists (another request committed the
        same prefix first), the existing physical block wins and the new
        one stays private to its request.
        """
        toks = self._tokens(prompt)
        node, depth = self.root, 0
        i = 0
        while depth + self.bt <= len(toks):
            key = toks[depth : depth + self.bt]
            child = node.children.get(key)
            if child is None:
                child = _Node(key, blocks[i], node, self._tick())
                self._retain(blocks[i])
                node.children[key] = child
                self._nodes.add(child)
            else:
                child.stamp = self._tick()
            node, depth, i = child, depth + self.bt, i + 1
        if lane_state is not None:
            tail = toks[depth:]
            tail_block = blocks[i] if tail else None
            for a in node.anchors:
                if a.tail == tail:  # refresh, keep the older snapshot
                    a.stamp = self._tick()
                    return
            if tail_block is not None:
                self._retain(tail_block)
            node.anchors.append(
                _Anchor(tail, tail_block, len(toks), lane_state, self._tick())
            )

    # ---------------- eviction (the pool's evictor hook) ----------------

    def evict(self, n_blocks: int) -> int:
        """Free at least ``n_blocks`` cached blocks if possible, LRU
        first. Only units whose blocks no live request shares are
        victims (evicting a shared block would free nothing and lose a
        hot prefix); anchors go before their node, leaves before their
        parents — the prefix-chain refcount structure guarantees a
        refcount-1 subtree is reclaimable bottom-up.

        One registry scan seeds a stamp-ordered heap of current victims;
        as victims drain, parents (or anchor-stripped nodes) that become
        reclaimable are pushed with *their* stamps — exact LRU across
        chains, at one scan per evict() call instead of one per freed
        block."""
        import heapq

        def reclaimable(node: _Node) -> bool:
            return (
                node.parent is not None
                and not node.children
                and self.pool.ref_count(node.block) == 1
            )

        heap = []  # (stamp, seq, node, anchor | None)
        seq = 0
        for node in (self.root, *self._nodes):
            rec = reclaimable(node)
            for a in node.anchors:
                # an anchor is a victim only when evicting it gains
                # something: its tail block frees, or it is the last
                # thing keeping a reclaimable node alive (evicting a
                # zero-gain anchor would just burn hybrid resume points
                # without reclaiming a block)
                frees_tail = a.tail_block is not None and (
                    self.pool.ref_count(a.tail_block) == 1
                    and self._pins.get(a.tail_block, 0) == 1
                )
                if frees_tail or rec:
                    heap.append((a.stamp, seq := seq + 1, node, a))
            if rec and not node.anchors:
                heap.append((node.stamp, seq := seq + 1, node, None))
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_blocks:
            _, _, node, anchor = heapq.heappop(heap)
            if anchor is not None:
                if anchor not in node.anchors:
                    continue  # already drained
                node.anchors.remove(anchor)
                if anchor.tail_block is not None:
                    freed += self._release_pin(anchor.tail_block)
                exposed = node if reclaimable(node) else None
            else:
                if node.children or node.anchors or node not in self._nodes:
                    continue  # condition changed since seeding
                node.parent.children.pop(node.key)
                self._nodes.discard(node)
                freed += self._release_pin(node.block)
                exposed = (
                    node.parent if reclaimable(node.parent) else None
                )
                # a parent anchor sharing this block (pin multiset) may
                # just have become the block's last pin — now a victim
                for a in node.parent.anchors:
                    if (
                        a.tail_block is not None
                        and self.pool.ref_count(a.tail_block) == 1
                        and self._pins.get(a.tail_block, 0) == 1
                    ):
                        heapq.heappush(
                            heap, (a.stamp, seq := seq + 1, node.parent, a)
                        )
            if exposed is not None:
                if not exposed.anchors:
                    heapq.heappush(
                        heap, (exposed.stamp, seq := seq + 1, exposed, None)
                    )
                else:
                    # the anchors are now the last thing keeping a
                    # reclaimable node alive — victims they weren't at
                    # seed time (re-pushes are deduped at pop)
                    for a in exposed.anchors:
                        heapq.heappush(
                            heap, (a.stamp, seq := seq + 1, exposed, a)
                        )
        self.evicted_blocks += freed
        # the per-block frees already emitted through pool.uncache; this
        # zero-delta summary attributes the storm (requested vs freed) so
        # report.py/mem and the pressure monitor can count churn episodes
        if self.pool.ledger is not None and freed:
            self.pool.ledger.record(
                "evict", owner="prefix-cache", requested=n_blocks, freed=freed
            )
        return freed

    # ---------------- reporting ----------------

    def stats(self) -> dict:
        return {
            "nodes": len(self._nodes),
            "anchors": sum(len(n.anchors) for n in self._nodes)
            + len(self.root.anchors),
            "cached_blocks": self.pool.cached_blocks,
            "evictable_blocks": self.pool.evictable_blocks,
            "lookups": self.lookups,
            "hits": self.hits,
            "evicted_blocks": self.evicted_blocks,
        }
