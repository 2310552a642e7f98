"""The paged state pool: KV caches sized in tokens, not slots.

Counterpart of ``repro/serve/pool``. The dense pool allocates every slot's
KV cache at the engine's full capacity, so pool memory, not compute, caps
concurrency for the gqa and mla families. Here:

  - :mod:`blocks`      the host-side block allocator: free list, per-request
                       page leases, refcounts and the prefix cache's
                       content index (``chain_hashes``);
  - :mod:`quant`       int8 / fp8 block storage with per-row scales;
  - :mod:`views`       gather/scatter between block storage and the dense
                       cache layout, and ``PagedCacheView``, the decode
                       step's view of the pool (gather or kernel route);
  - :mod:`paged_cache` ``PagedModelCache``, the pool the engine drives (the
                       insertion prefill, the suffix prefill of a prefix
                       hit, the copy-on-write block copy).

The decode read's kernel is ``kernels/paged_attention.py``, registered as
the ``paged`` backend.
"""
from repro_torch.serve.pool.blocks import BlockAllocator, PageLease
from repro_torch.serve.pool.paged_cache import PagedModelCache
from repro_torch.serve.pool.quant import get_quant
from repro_torch.serve.pool.views import PagedCacheView, resolve_cache_view

__all__ = ["BlockAllocator", "PageLease", "PagedModelCache", "get_quant", "PagedCacheView",
           "resolve_cache_view"]
