"""Host-side block allocator for the paged state pool.

Counterpart of ``repro/serve/pool/blocks.py`` without the prefix cache's
content index, refcounts and chain hashes (not ported yet). Pure Python
bookkeeping: the device owns the block *storage* (``paged_cache``), this
module owns *which physical block holds which request's tokens*:

  - **Free list**: physical block ids; the lowest free id is always handed
    out next, so allocation is deterministic.
  - **Leases**: admission *stakes* a request's worst-case page count
    (``reserve``) before any block is touched; pages are *mapped* lazily:
    the prompt bucket's pages at admission, one more each time decode
    crosses a block boundary (``append``). The reservation covers the whole
    horizon, so an append never fails mid-decode: backpressure happens only
    at admission.
  - **Double / foreign free detection**: releasing a block that is not
    mapped raises.

The per-slot page table lives with the engine as a host numpy array,
mirrored to the device when it changes; unmapped entries point at the
trash block (id ``num_blocks``), so idle lanes' writes land in a sink no
live request reads.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Iterable, List, Optional

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry


@dataclasses.dataclass
class PageLease:
    """One admitted request's hold on the pool: ``reserved`` pages not yet
    mapped, and the physical ids ``mapped`` (in logical-page order)."""

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
        self._mapped: set = set()
        self._reserved = 0
        self.pages_appended = 0      # block-boundary maps mid-decode
        self.peak_mapped = 0         # high-water mark of mapped blocks
        self.bind_metrics(NULL_REGISTRY)

    def bind_metrics(self, registry: MetricsRegistry) -> None:
        """Mirror the allocator's event counts into ``registry``."""
        self._m_mapped = registry.counter("pool.pages_mapped",
                                          "pages handed to leases (incl. appends)")
        self._m_appended = registry.counter("pool.pages_appended",
                                            "block-boundary appends mid-decode")

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
        lowest free ids first."""
        if pages > lease.reserved:
            raise RuntimeError(f"lease holds {lease.reserved} reserved pages, asked for {pages}")
        ids = self._free[:pages]
        del self._free[:pages]
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

    # -- retirement --------------------------------------------------------
    def release(self, lease: PageLease) -> None:
        """Return a lease's blocks and its unused reservation. A block that
        is not mapped (a double or foreign free) raises."""
        for b in lease.mapped:   # one at a time: catches duplicates in the lease
            if b not in self._mapped:
                raise RuntimeError(f"double/foreign free of block {b}")
            self._mapped.discard(b)
            bisect.insort(self._free, b)
        self._reserved -= lease.reserved
        if self._reserved < 0:
            raise RuntimeError("reservation accounting went negative")
        lease.mapped.clear()
        lease.reserved = 0

    # -- sanitizer ---------------------------------------------------------
    def check_invariants(self, held: Optional[Iterable[int]] = None) -> None:
        """Cross-check the allocator's state; raises on the first
        inconsistency. ``held``: the blocks the caller's leases map, which
        must be exactly the mapped set (a leak or a stolen block shows)."""
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
        if not 0 <= self._reserved <= len(free):
            raise RuntimeError(f"sanitizer: {self._reserved} reserved pages vs {len(free)} free "
                               "blocks (over-promised)")
        if self.trash in free or self.trash in self._mapped:
            raise RuntimeError("sanitizer: the trash block is free or mapped")
        if held is not None:
            held = list(held)
            if len(held) != len(set(held)) or set(held) != self._mapped:
                raise RuntimeError(f"sanitizer: leases map {sorted(held)}, the allocator "
                                   f"{sorted(self._mapped)}")

    # -- stats -------------------------------------------------------------
    def mapped_blocks(self) -> int:
        return self.num_blocks - len(self._free)

    def stats(self) -> dict:
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": len(self._free),
            "blocks_mapped": self.mapped_blocks(),
            "blocks_reserved": self._reserved,
            "blocks_peak_mapped": self.peak_mapped,
            "pages_appended": self.pages_appended,
        }
