"""KV-cache block accounting (vLLM-style paged bookkeeping, TPU-adapted).

vLLM's PagedAttention maps logical KV blocks to scattered physical blocks in
GPU memory. On TPU, static shapes win: the engine keeps one contiguous
fixed-length cache lane per running slot, and this allocator reproduces the
*accounting* semantics (admission control, capacity back-pressure, free-list
reuse) over those lanes' block budgets (DESIGN.md §4). The scheduler consults
``can_allocate`` before admitting — a request that would exceed the cache
budget stays in W, exactly like vLLM deferring on OOM.

**Refcounted prefix caching.** Blocks are identity-bearing and refcounted:
a request's reservation is a list of block ids, and the leading blocks of a
prompt can be *content-named* by a chained chunk hash
(:func:`prefix_chunk_hashes`). Two requests whose prompts share a token
prefix share the prefix's blocks — each holder increments the refcount, so
the shared blocks are counted once against the budget. When the last holder
frees, a content-named block is not returned to the free pool: it parks in
an LRU list of *cached* blocks, still indexed by its hash, and a later
request with the same prefix re-acquires it (a **prefix hit** — the serving
core then starts prefill at the cached offset instead of token 0). Cached
blocks count as free capacity: allocation under pressure reclaims them
oldest-first, unregistering the hash and notifying ``evict listeners`` (the
real engine drops its stored KV fragment in lockstep).

A freshly registered hash is not hitable until the owner *commits* it
(:meth:`BlockAllocator.commit`) — the serving core commits a request's
prompt blocks when its prefill completes, so a hit always refers to KV that
is actually resident somewhere, never to a prompt still streaming in.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Set


# Sentinel capacity for accounting-only allocators that never back-pressure
# (the simulator's default: memory-unbounded unless a budget is requested).
UNBOUNDED_BLOCKS = 1 << 60


def prefix_chunk_hashes(token_ids: Sequence[int], block_size: int) -> List[int]:
    """Chained content hashes of the *full* ``block_size``-token chunks.

    ``out[i]`` names the entire prefix ``token_ids[: (i+1) * block_size]``
    (each link hashes the previous link plus the chunk's tokens, vLLM's
    prefix-hash scheme), so equal hashes at index i mean the whole prefix up
    to that block boundary is identical — a chain match is a prefix match.
    The trailing partial chunk is never hashed: only whole blocks are
    shareable. Deterministic across processes (pure int tuple hashing).
    """
    out: List[int] = []
    h = 0
    for i in range(0, len(token_ids) - block_size + 1, block_size):
        h = hash((h,) + tuple(token_ids[i:i + block_size]))
        out.append(h)
    return out


@dataclass
class BlockAllocator:
    total_blocks: int
    block_size: int = 16
    # req_id -> owned block ids, in prompt order (leading ids may be shared)
    _req_blocks: Dict[int, List[int]] = field(default_factory=dict)
    _refcount: Dict[int, int] = field(default_factory=dict)   # only rc >= 1
    _hash_block: Dict[int, int] = field(default_factory=dict)  # hash -> block
    _block_hash: Dict[int, int] = field(default_factory=dict)  # block -> hash
    _committed: Set[int] = field(default_factory=set)          # hitable blocks
    _lru: "OrderedDict[int, None]" = field(default_factory=OrderedDict)
    _free_pool: List[int] = field(default_factory=list)        # recycled ids
    _minted: int = 0                                           # ids ever made
    _evict_listeners: List[Callable[[int], None]] = field(default_factory=list)

    @classmethod
    def unbounded(cls, block_size: int = 16) -> "BlockAllocator":
        return cls(total_blocks=UNBOUNDED_BLOCKS, block_size=block_size)

    def blocks_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.block_size)

    # ------------------------------------------------------------ accounting
    @property
    def used_blocks(self) -> int:
        """Distinct blocks referenced by at least one request (shared prefix
        blocks are counted once — that is the point of sharing)."""
        return len(self._refcount)

    @property
    def cached_blocks(self) -> int:
        """Unreferenced content-named blocks parked in the LRU list. They
        count as *free* capacity (allocation reclaims them on demand)."""
        return len(self._lru)

    @property
    def free_blocks(self) -> int:
        return self.total_blocks - self.used_blocks

    def reserved(self, req_id: int) -> int:
        """Blocks currently held by ``req_id`` (0 if none)."""
        return len(self._req_blocks.get(req_id, ()))

    def block_table(self, req_id: int) -> List[int]:
        """The request's physical block ids in logical (prompt) order — the
        per-sequence block table a paged backend indexes its KV pool with.
        Leading entries may alias another request's blocks (shared prefix);
        a copy, so callers can pad/truncate freely."""
        return list(self._req_blocks.get(req_id, ()))

    def add_evict_listener(self, fn: Callable[[int], None]) -> None:
        """``fn(hash)`` fires when a cached block's content is dropped (LRU
        reclaim or release of an uncommitted owner) — backends keep their
        hash-keyed KV stores in lockstep with the accounting."""
        self._evict_listeners.append(fn)

    # --------------------------------------------------------- prefix lookup
    def _match(self, hashes: Sequence[int]) -> List[int]:
        """Longest committed chain prefix present in the index, as block ids
        (stops at the first missing or uncommitted link)."""
        out: List[int] = []
        for h in hashes:
            b = self._hash_block.get(h)
            if b is None or b not in self._committed:
                break
            out.append(b)
        return out

    def cached_prefix_blocks(self, hashes: Sequence[int]) -> int:
        """How many leading blocks of this hash chain a request could share
        right now (hitable = registered *and* committed)."""
        return len(self._match(hashes))

    def tracked(self, h: int) -> bool:
        """Whether a block is content-named by ``h`` (committed or not) —
        backends store KV fragments only for tracked hashes, so the eviction
        listener is guaranteed to fire for everything they hold."""
        return h in self._hash_block

    def can_allocate(self, tokens: int, hashes: Sequence[int] = ()) -> bool:
        need = self.blocks_for(tokens)
        shared = self._match(hashes[:need])
        from_lru = sum(1 for b in shared if b in self._lru)
        return need - len(shared) <= self.free_blocks - from_lru

    # ----------------------------------------------------------- allocation
    def _take_block(self) -> int:
        """A fresh unreferenced block id: recycled, newly minted, or an LRU
        cached block reclaimed (its hash is dropped + listeners notified)."""
        if self._free_pool:
            return self._free_pool.pop()
        if self._minted < self.total_blocks:
            self._minted += 1
            return self._minted - 1
        b, _ = self._lru.popitem(last=False)     # least recently used
        self._release(b)
        return self._free_pool.pop()

    def _release(self, b: int) -> None:
        """Drop a block's content identity and recycle its id."""
        h = self._block_hash.pop(b, None)
        if h is not None and self._hash_block.get(h) == b:
            del self._hash_block[h]
            for fn in self._evict_listeners:
                fn(h)
        self._committed.discard(b)
        self._free_pool.append(b)

    def _decref(self, b: int) -> None:
        self._refcount[b] -= 1
        if self._refcount[b]:
            return
        del self._refcount[b]
        if b in self._committed and self._block_hash.get(b) is not None:
            self._lru[b] = None                  # park, most-recently-used end
        else:
            self._release(b)                     # anonymous / never committed

    def allocate(self, req_id: int, tokens: int,
                 hashes: Sequence[int] = ()) -> int:
        """Reserve ``blocks_for(tokens)`` blocks for ``req_id``; the leading
        ``len(hashes)`` blocks are content-named by the prompt's chunk-hash
        chain. Committed chain links already in the index are *shared*
        (refcount bump, no new capacity) instead of newly claimed; returns
        how many blocks were shared — the caller's prefix hit, in blocks.
        Re-allocating for a held ``req_id`` replaces its reservation.
        """
        if req_id in self._req_blocks:
            self.free(req_id)
        need = self.blocks_for(tokens)
        shared = self._match(hashes[:need])
        from_lru = sum(1 for b in shared if b in self._lru)
        if need - len(shared) > self.free_blocks - from_lru:
            raise MemoryError(f"KV cache exhausted: need {need - len(shared)}, "
                              f"free {self.free_blocks - from_lru}")
        blocks: List[int] = []
        for b in shared:                          # prefix hit: share, pin
            self._lru.pop(b, None)
            self._refcount[b] = self._refcount.get(b, 0) + 1
            blocks.append(b)
        for i in range(len(shared), need):        # miss / tail: claim fresh
            b = self._take_block()
            self._refcount[b] = 1
            if i < len(hashes) and hashes[i] not in self._hash_block:
                # first writer wins: a concurrent identical prompt keeps its
                # duplicate blocks anonymous (they recycle on free)
                self._hash_block[hashes[i]] = b
                self._block_hash[b] = hashes[i]
            blocks.append(b)
        self._req_blocks[req_id] = blocks
        return len(shared)

    def commit(self, req_id: int) -> None:
        """Make ``req_id``'s content-named blocks hitable. Called by the
        serving core once the request's prompt is fully KV-resident — a
        prefix hit must never point at KV still streaming in."""
        for b in self._req_blocks.get(req_id, ()):
            h = self._block_hash.get(b)
            if h is not None and self._hash_block.get(h) == b:
                self._committed.add(b)

    def grow(self, req_id: int, n: int) -> bool:
        """Append ``n`` fresh anonymous blocks to a reservation (the
        incremental decode-phase allocation unit: one table entry per call
        site, never content-shared). False — with the reservation intact —
        when ``n`` exceeds free capacity; LRU-parked cached blocks count as
        free and are reclaimed on demand, exactly like :meth:`allocate`."""
        if n <= 0:
            return True
        if n > self.free_blocks:
            return False
        cur = self._req_blocks.setdefault(req_id, [])
        for _ in range(n):
            b = self._take_block()
            self._refcount[b] = 1
            cur.append(b)
        return True

    def extend(self, req_id: int, total_tokens: int) -> bool:
        """Grow (or shrink) a request's reservation to ``total_tokens``;
        False if growth exceeds capacity. Growth appends anonymous blocks
        (via :meth:`grow`) — decode-phase KV is per-request, never
        content-shared."""
        need = self.blocks_for(total_tokens)
        cur = self._req_blocks.setdefault(req_id, [])
        delta = need - len(cur)
        if delta > 0:
            return self.grow(req_id, delta)
        for _ in range(-delta):
            self._decref(cur.pop())
        return True

    def free(self, req_id: int) -> None:
        """Release a reservation: every block drops one reference. Committed
        content-named blocks whose refcount reaches zero park in the LRU
        cache (a later identical prefix re-acquires them); the rest recycle
        into the free pool immediately."""
        for b in self._req_blocks.pop(req_id, ()):
            self._decref(b)

    def clear_cache(self) -> int:
        """Drop every LRU-parked cached block (crash/cold-restart semantics:
        the replica's KV memory is gone, so its warm prefixes must stop
        being hitable). Fires the evict listeners for each dropped hash so
        backends discard their fragments in lockstep; live reservations are
        untouched — callers free those per request first. Returns the number
        of blocks dropped."""
        n = 0
        while self._lru:
            b, _ = self._lru.popitem(last=False)
            self._release(b)
            n += 1
        return n
