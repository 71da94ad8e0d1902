"""Host-side bookkeeping for the block-paged KV cache pool.

The device holds one pool of fixed-size cache blocks
(``kvcache.paged_gather`` / ``paged_scatter``); this module owns which block
belongs to whom:

  * :class:`BlockAllocator` — a refcounted free list over block ids
    ``1..num_blocks-1``. Block 0 is the reserved NULL block: idle and
    retired slots point their whole page-table row at it so their
    masked-out decode writes land somewhere harmless, and it is never
    handed out. Each slot referencing a block holds one ref, the prefix
    cache holds one more, and the block returns to the free list when the
    last ref drops.

  * :class:`PrefixCache` — hash-chain shared-prefix index. The key of block
    ``j`` of a prompt is a digest of ``tokens[:(j+1)*bs]``: causal attention
    makes a block's K/V a pure function of every token up to its end, so
    equal chain keys mean equal block contents. Entries hold one allocator
    ref and are LRU-evicted when the free list runs dry.

Sharing discipline (enforced by the engine): decode writes start at
position ``plen - 1``, so a block is shared read-only only when it lies
entirely below that, ``(j+1)*bs <= plen-1``. The block that ends exactly at
``plen`` is copy-on-write instead: its cached content is copied into a
private block, and the first decode step overwrites position ``plen-1`` in
the copy.

A copy of the reference's ``repro/serving/blockpool.py`` (pure Python and
numpy), with the same refcount, LRU and chain-key semantics. The
``hits`` / ``misses`` / ``evictions`` counters are plain attributes; given a
``repro_torch.obs.metrics.MetricsRegistry``, grants, denials, frees and
the prefix cache's lookups also flow into ``blockpool_*`` and
``prefix_cache_*`` series, scrapeable mid-run.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["BlockAllocator", "PrefixCache", "chain_key", "NULL_BLOCK"]

NULL_BLOCK = 0


def chain_key(tokens) -> bytes:
    """Digest of a token prefix: the chain hash of the block ending at
    ``len(tokens)``. Equal keys imply equal block K/V (causality)."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    return hashlib.sha256(t.tobytes()).digest()


class BlockAllocator:
    """Refcounted free-list allocator over pool block ids (block 0 is the
    null block and never allocated). With ``metrics``, grants / denials /
    frees count into ``blockpool_*`` counters and the in-use gauge follows
    the free list."""

    def __init__(self, num_blocks: int, metrics=None):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 null + 1 usable), "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        # pop() hands out ascending ids, which keeps traces readable
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.refs: Dict[int, int] = {}
        self._m_granted = self._m_denied = self._m_freed = None
        self._m_in_use = None
        if metrics is not None:
            self._m_granted = metrics.counter(
                "blockpool_blocks_granted_total",
                help="cache blocks handed out by alloc()")
            self._m_denied = metrics.counter(
                "blockpool_alloc_denied_total",
                help="all-or-nothing alloc() calls denied for lack of blocks")
            self._m_freed = metrics.counter(
                "blockpool_blocks_freed_total",
                help="blocks returned to the free list (last ref dropped)")
            self._m_in_use = metrics.gauge(
                "blockpool_blocks_in_use", help="pool blocks currently held")

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh blocks at refcount 1, or None if the free list is short
        (all-or-nothing: a partial grant could deadlock admission)."""
        if n > len(self._free):
            if self._m_denied is not None:
                self._m_denied.inc()
            return None
        blocks = [self._free.pop() for _ in range(n)]
        for b in blocks:
            self.refs[b] = 1
        if self._m_granted is not None:
            self._m_granted.inc(n)
            self._m_in_use.set(self.num_used)
        return blocks

    def incref(self, block: int) -> None:
        if block != NULL_BLOCK:
            self.refs[block] += 1

    def decref(self, block: int) -> None:
        if block == NULL_BLOCK:
            return
        r = self.refs[block] - 1
        if r < 0:
            raise RuntimeError(f"double free of block {block}")
        if r == 0:
            del self.refs[block]
            self._free.append(block)
            if self._m_freed is not None:
                self._m_freed.inc()
                self._m_in_use.set(self.num_used)
        else:
            self.refs[block] = r


class PrefixCache:
    """LRU chain-hash index ``chain_key -> block id``. Each entry holds one
    allocator ref, so a cached block survives its origin slot's retirement
    and is reclaimed only by eviction. With ``metrics``, the counters also
    go to ``prefix_cache_*_total`` series."""

    def __init__(self, allocator: BlockAllocator, metrics=None):
        self._alloc = allocator
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._m_hits = self._m_misses = self._m_evictions = None
        if metrics is not None:
            self._m_hits = metrics.counter(
                "prefix_cache_hits_total",
                help="prefix-block lookups served from the chain-hash index")
            self._m_misses = metrics.counter("prefix_cache_misses_total")
            self._m_evictions = metrics.counter(
                "prefix_cache_evictions_total",
                help="LRU entries dropped to refill the free list")

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: bytes) -> Optional[int]:
        """Block id for ``key`` or None. A hit refreshes LRU recency; the
        caller increfs for its own use."""
        bid = self._entries.get(key)
        if bid is None:
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        if self._m_hits is not None:
            self._m_hits.inc()
        return bid

    def put(self, key: bytes, block: int) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._alloc.incref(block)
        self._entries[key] = block

    def evict_until(self, n_free: int) -> int:
        """Drop LRU entries until the allocator has ``n_free`` free blocks
        or the cache is empty. An entry whose block live slots still share
        loses shareability but frees nothing until those slots retire."""
        dropped = 0
        while self._alloc.num_free < n_free and self._entries:
            _, bid = self._entries.popitem(last=False)
            self._alloc.decref(bid)
            self.evictions += 1
            if self._m_evictions is not None:
                self._m_evictions.inc()
            dropped += 1
        return dropped
