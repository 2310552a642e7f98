"""Host-side block allocator for the paged state pool, with the prefix
cache's content index.

Counterpart of ``repro/serve/pool/blocks.py``. Pure Python bookkeeping: the
device owns the block *storage* (``paged_cache``), this module owns *which
physical block holds which request's tokens*:

  - **Free list**: physical block ids; the lowest free id is always handed
    out next, so allocation is deterministic.
  - **Leases**: admission *stakes* a request's worst-case page count
    (``reserve``) before any block is touched; pages are *mapped* lazily:
    the prompt bucket's pages at admission, one more each time decode
    crosses a block boundary (``append``). The reservation covers the whole
    horizon, so an append never fails mid-decode: backpressure happens only
    at admission.
  - **Refcounts and the content index**: every mapped block carries a
    refcount; a prompt's full blocks register under a *chain hash* of
    their token ids (:func:`chain_hashes`), so a later prompt that shares
    the prefix can ``acquire`` the same physical block instead of
    prefilling it again. Hashing token ids, not stored bytes, makes sharing
    independent of the pool's quantization; chaining makes a block's
    identity include everything before it, so a hit is a true prefix match.
  - **Cached-free blocks**: a block whose refcount reaches zero returns to
    the free list but keeps its hash: nothing writes a freed block, so its
    rows stay valid and ``acquire`` can bring it back. ``map`` handing it
    to fresh content is the eviction point, where the stale hash goes.
  - **Double / foreign free and underflow detection**: releasing a block
    that is not mapped raises, and so does a refcount that would go
    negative.

The per-slot page table lives with the engine as a host numpy array,
mirrored to the device when it changes; unmapped entries point at the
trash block (id ``num_blocks``), so idle lanes' writes land in a sink no
live request reads.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry


def chain_hashes(tokens, block: int) -> List[bytes]:
    """The chain hash of each FULL block of a token-id sequence:
    ``h_i = blake2b(h_{i-1} || tokens[i*block:(i+1)*block])`` over the int32
    bytes, 16-byte digests from ``h_-1 = 0``: byte-equal to the JAX
    package's. A partial trailing block gets no hash (its rows still grow)."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    out: List[bytes] = []
    h = b"\x00" * 16
    for i in range(tokens.size // block):
        h = hashlib.blake2b(h + tokens[i * block:(i + 1) * block].tobytes(),
                            digest_size=16).digest()
        out.append(h)
    return out


@dataclasses.dataclass
class PageLease:
    """One admitted request's hold on the pool: ``reserved`` pages not yet
    mapped, and the physical ids ``mapped`` (in logical-page order). A
    mapped id may be a shared prefix block (refcount > 1) adopted at
    admission: release decrements it, and it frees only at zero."""

    reserved: int
    mapped: List[int] = dataclasses.field(default_factory=list)


class BlockAllocator:
    def __init__(self, num_blocks: int, block: int):
        if num_blocks < 1 or block < 1:
            raise ValueError("need at least one block of at least one token")
        self.num_blocks = num_blocks
        self.block = block
        self.trash = num_blocks      # the sink's id; storage allocates one more row
        self._free: List[int] = list(range(num_blocks))
        self._mapped: set = set()    # blocks held by at least one reference
        self._reserved = 0
        self._ref: Dict[int, int] = {}          # mapped block -> refcount
        self._hash_of: Dict[int, bytes] = {}    # block -> its registered chain hash
        self._by_hash: Dict[bytes, int] = {}    # chain hash -> physical block
        self.pages_appended = 0      # block-boundary maps mid-decode
        self.peak_mapped = 0         # high-water mark of mapped blocks
        self.prefix_hits = 0         # acquire() calls that took a reference
        self.hash_evictions = 0      # cached-free blocks recycled to fresh content
        self.bind_metrics(NULL_REGISTRY)

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Mirror the allocator's event counts into ``registry``."""
        self._m_mapped = registry.counter("pool.pages_mapped",
                                          "pages handed to leases (incl. appends)")
        self._m_appended = registry.counter("pool.pages_appended",
                                            "block-boundary appends mid-decode")
        self._m_prefix_hits = registry.counter("pool.prefix_hits",
                                               "content-index references taken")
        self._m_hash_evictions = registry.counter("pool.hash_evictions",
                                                  "cached-free blocks recycled")
        self._m_cached_free = registry.counter("pool.cached_free_returns",
                                               "blocks freed with their hash kept")

    # -- admission ---------------------------------------------------------
    def available(self) -> int:
        """Blocks neither mapped nor promised to an admitted request."""
        return len(self._free) - self._reserved

    def can_reserve(self, pages: int) -> bool:
        return self.available() >= pages

    def reserve(self, pages: int) -> PageLease:
        if not self.can_reserve(pages):
            raise RuntimeError(f"pool exhausted: {pages} pages requested, "
                               f"{self.available()} available (of {self.num_blocks})")
        self._reserved += pages
        return PageLease(reserved=pages)

    # -- mapping -----------------------------------------------------------
    def map(self, lease: PageLease, pages: int = 1) -> List[int]:
        """Turn ``pages`` of the lease's reservation into physical ids,
        lowest free ids first. A recycled cached-free block loses its stale
        hash here: fresh content is about to overwrite it."""
        if pages > lease.reserved:
            raise RuntimeError(f"lease holds {lease.reserved} reserved pages, asked for {pages}")
        ids = self._free[:pages]
        del self._free[:pages]
        for b in ids:
            self._evict_hash(b)
            self._ref[b] = 1
        self._mapped.update(ids)
        self._reserved -= pages
        lease.reserved -= pages
        lease.mapped.extend(ids)
        self.peak_mapped = max(self.peak_mapped, self.mapped_blocks())
        self._m_mapped.inc(len(ids))
        return ids

    def append(self, lease: PageLease) -> int:
        """Map one more page (a decode step crossed a block boundary)."""
        (page,) = self.map(lease, 1)
        self.pages_appended += 1
        self._m_appended.inc()
        return page

    # -- the content index -------------------------------------------------
    def register(self, block: int, h: bytes) -> None:
        """Index ``block`` under chain hash ``h``. Keep-first: a hash that
        already names a live or cached block keeps it, so concurrent
        prefills of one prompt converge on the first one's blocks."""
        if h in self._by_hash:
            return
        old = self._hash_of.get(block)
        if old is not None:     # the block is bound to another content's hash
            self._by_hash.pop(old, None)
        self._hash_of[block] = h
        self._by_hash[h] = block

    def lookup(self, h: bytes) -> Optional[int]:
        """The physical block registered under chain hash ``h``, or None."""
        return self._by_hash.get(h)

    def acquire(self, block: int, margin: int = 0) -> bool:
        """Take one reference on an indexed block (a prefix hit). A live
        block just counts one more; a cached-free block comes back off the
        free list, but only while every outstanding reservation plus
        ``margin`` pages (the stakes earlier admissions of this cycle
        committed) stay coverable. False when it cannot."""
        if block in self._mapped:
            self._ref[block] += 1
        else:
            if block not in self._hash_of:
                raise RuntimeError(f"acquire of unindexed block {block}")
            if len(self._free) - self._reserved - margin < 1:
                return False
            self._free.remove(block)
            self._mapped.add(block)
            self._ref[block] = 1
            self.peak_mapped = max(self.peak_mapped, self.mapped_blocks())
        self.prefix_hits += 1
        self._m_prefix_hits.inc()
        return True

    def adopt(self, lease: PageLease, blocks: Sequence[int]) -> None:
        """Attach acquired shared blocks to a lease (in logical-page order,
        ahead of its private pages). The lease now owns the references."""
        lease.mapped.extend(blocks)

    def _evict_hash(self, block: int) -> None:
        h = self._hash_of.pop(block, None)
        if h is not None:
            self._by_hash.pop(h, None)
            self.hash_evictions += 1
            self._m_hash_evictions.inc()

    # -- retirement --------------------------------------------------------
    def release_ref(self, block: int) -> None:
        """Drop one reference. At zero the block returns to the free list and
        keeps its hash (cached-free, until ``map`` recycles it). A block that
        is not mapped (double or foreign free) and a refcount that would
        underflow raise."""
        if block not in self._mapped:
            raise RuntimeError(f"double/foreign free of block {block}")
        r = self._ref.get(block, 0)
        if r <= 0:
            raise RuntimeError(f"refcount underflow on block {block}")
        if r > 1:
            self._ref[block] = r - 1
            return
        del self._ref[block]
        self._mapped.discard(block)
        bisect.insort(self._free, block)
        if block in self._hash_of:
            self._m_cached_free.inc()

    def release(self, lease: PageLease) -> None:
        """Return a lease's references and its unused reservation: private
        blocks free at once, shared ones count one less."""
        for b in lease.mapped:   # one at a time: catches duplicates in the lease
            self.release_ref(b)
        self._reserved -= lease.reserved
        if self._reserved < 0:
            raise RuntimeError("reservation accounting went negative")
        lease.mapped.clear()
        lease.reserved = 0

    # -- sanitizer ---------------------------------------------------------
    def check_invariants(self, external_refs: Optional[Dict[int, int]] = None) -> None:
        """Cross-check the allocator's state; raises on the first
        inconsistency. ``external_refs`` (block -> expected refcount): the
        references the caller's holders (leases, pins, queued requests)
        account for, which must be exactly the allocator's refcounts (a
        leak or a stolen reference shows)."""
        free = self._free
        if free != sorted(set(free)):
            raise RuntimeError("sanitizer: free list not sorted/unique")
        if any(not 0 <= b < self.num_blocks for b in free):
            raise RuntimeError("sanitizer: free id out of range")
        if self._mapped.intersection(free):
            raise RuntimeError(f"sanitizer: blocks both free and mapped: "
                               f"{sorted(self._mapped.intersection(free))}")
        if len(free) + len(self._mapped) != self.num_blocks:
            raise RuntimeError(f"sanitizer: {len(free)} free + {len(self._mapped)} mapped != "
                               f"{self.num_blocks} total (a block leaked)")
        if set(self._ref) != self._mapped:
            raise RuntimeError(f"sanitizer: refcount keys {sorted(self._ref)} disagree with "
                               f"the mapped set {sorted(self._mapped)}")
        if any(r < 1 for r in self._ref.values()):
            raise RuntimeError(f"sanitizer: a mapped block has refcount < 1: {self._ref}")
        if not 0 <= self._reserved <= len(free):
            raise RuntimeError(f"sanitizer: {self._reserved} reserved pages vs {len(free)} free "
                               "blocks (over-promised)")
        for b, h in self._hash_of.items():
            if self._by_hash.get(h) != b:
                raise RuntimeError(f"sanitizer: hash index asymmetry on block {b}")
        for h, b in self._by_hash.items():
            if self._hash_of.get(b) != h:
                raise RuntimeError(f"sanitizer: hash index asymmetry on hash {h.hex()}")
        for coll, what in ((free, "free"), (self._mapped, "mapped"), (self._hash_of, "indexed")):
            if self.trash in coll:
                raise RuntimeError(f"sanitizer: the trash block is {what}")
        if external_refs is not None and dict(external_refs) != self._ref:
            missing = {b: r for b, r in self._ref.items() if external_refs.get(b, 0) != r}
            extra = {b: r for b, r in external_refs.items() if self._ref.get(b, 0) != r}
            raise RuntimeError("sanitizer: refcounts not accounted for by known holders: "
                               f"allocator-side {missing}, holder-side {extra}")

    # -- stats -------------------------------------------------------------
    def mapped_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def ref(self, block: int) -> int:
        return self._ref.get(block, 0)

    def shared_blocks(self) -> int:
        """Mapped blocks held by more than one lease or pin."""
        return sum(1 for r in self._ref.values() if r > 1)

    def stats(self) -> dict:
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": len(self._free),
            "blocks_mapped": self.mapped_blocks(),
            "blocks_reserved": self._reserved,
            "blocks_peak_mapped": self.peak_mapped,
            "blocks_shared": self.shared_blocks(),
            "blocks_indexed": len(self._by_hash),
            "pages_appended": self.pages_appended,
            "prefix_hits": self.prefix_hits,
            "hash_evictions": self.hash_evictions,
        }
