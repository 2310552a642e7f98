"""``PagedModelCache``: the paged counterpart of ``serve.cache.ModelSlotCache``.

Counterpart of ``repro/serve/pool/paged_cache.py`` on one device (the
slot-sharded layout waits for the multi-device port). Discovery is
family-agnostic and allocates nothing: ``init_caches`` is built on the meta
device at batch 1 and 2 (the slot axis of every leaf, as
``serve.cache.slot_axes``) and at capacity C and 2C (the token axis: the
axis whose extent tracks capacity is the one worth paging). Leaves with no
such axis (FLARE stream state, positions, lengths, window-bounded ring
buffers) stay in a dense per-slot part: they are O(1) in capacity, which is
FLARE's serving pitch; its whole state is dense here.

Token-axis leaves are stored block-granular in ``[num_blocks + 1, block,
*rest]`` (``views.py``; the ``+1`` is the trash sink) and share one page
table per slot across every leaf and layer: a logical block maps to the
same physical id in each leaf's storage. Pool capacity is sized in tokens
(``pool_tokens``); admission stakes pages through ``blocks.BlockAllocator``
and the engine appends pages as decode crosses block boundaries.

Unlike the JAX package, prefill insertion (full and suffix), the
copy-on-write block copy and reset update the pool's tensors in place and
return the same pool dict.
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.serve.cache import _slot_axis, meta_leaves
from repro_torch.serve.pool.blocks import BlockAllocator
from repro_torch.serve.pool.quant import get_quant
from repro_torch.serve.pool.views import (
    PagedLeaf,
    PoolSpec,
    gather_leaf,
    scatter_blocks,
    scatter_rows,
)


def _axis_or_none(small, big) -> Optional[int]:
    try:
        return _slot_axis(small, big)
    except ValueError:   # several axes moved: leave the leaf dense
        return None


class PagedModelCache:
    """Block-granular, optionally quantized pool over any family's
    ``init_caches(batch, capacity, device=None)`` pytree."""

    def __init__(self, init_fn: Callable[..., Any], capacity: int, *, pool_tokens: int,
                 block: int = 16, quant: str = "none"):
        if pool_tokens < block:
            raise ValueError(f"pool_tokens={pool_tokens} < block={block}")
        self.init_fn = init_fn
        self.capacity = capacity
        self.block = block
        self.num_blocks = pool_tokens // block
        self.quant = get_quant(quant)
        self.max_pages = -(-capacity // block)

        leaves_c, treedef = meta_leaves(init_fn, 2, capacity)
        leaves_b1, _ = meta_leaves(init_fn, 1, capacity)
        leaves_2c, _ = meta_leaves(init_fn, 2, 2 * capacity)
        roles: List = []
        paged: List[PagedLeaf] = []
        dense_axes: List[Optional[int]] = []
        self._rest_shapes: List[tuple] = []
        self._dense_shapes: List[torch.Tensor] = []
        for s1, sc, s2c in zip(leaves_b1, leaves_c, leaves_2c):
            sax, tax = _axis_or_none(s1, sc), _axis_or_none(sc, s2c)
            # page what is capacity-extent on an axis of its own of a per-slot leaf
            if sax is None or tax is None or tax == sax or sc.shape[tax] != capacity:
                roles.append(("dense", len(dense_axes)))
                dense_axes.append(sax)
                self._dense_shapes.append(sc)
            else:
                roles.append(("paged", len(paged)))
                paged.append(PagedLeaf(slot_axis=sax, token_axis=tax, view=capacity,
                                       dtype=sc.dtype))
                self._rest_shapes.append(tuple(sc.shape[i] for i in range(sc.dim())
                                               if i not in (sax, tax)))
        self.spec = PoolSpec(treedef=treedef, roles=tuple(roles), paged=tuple(paged),
                             dense_slot_axes=tuple(dense_axes), block=block,
                             max_pages=self.max_pages, quant=self.quant)
        self._fresh = None   # one slot's dense part at its init values, kept for resets

    @property
    def trash(self) -> int:
        """The storage row idle and unmapped entries point at."""
        return self.num_blocks

    def allocator(self) -> BlockAllocator:
        return BlockAllocator(self.num_blocks, self.block)

    def _dense_leaves(self, slots: int) -> tuple:
        """The dense part of ``init_fn(slots, capacity)`` (its token leaves,
        built with it, are dropped at once)."""
        leaves = pytree.tree_leaves(self.init_fn(slots, self.capacity))
        return tuple(leaf for leaf, (role, _) in zip(leaves, self.spec.roles) if role == "dense")

    def init(self, slots: int) -> dict:
        dense = self._dense_leaves(slots)
        device = dense[0].device if dense else None
        data, scale = [], []
        rows = self.num_blocks + 1
        for meta, rest in zip(self.spec.paged, self._rest_shapes):
            data.append(torch.zeros((rows, self.block) + rest,
                                    dtype=self.quant.storage_dtype(meta.dtype), device=device))
            scale.append(torch.ones((rows, self.block) + rest[:-1], device=device)
                         if self.quant.scaled else None)
        return {"dense": dense, "data": tuple(data), "scale": tuple(scale)}

    def _scatter_dense(self, dense: tuple, parts: tuple, slots: torch.Tensor) -> None:
        for p, q, ax in zip(dense, parts, self.spec.dense_slot_axes):
            if ax is not None:
                p.index_copy_(ax, slots.to(device=p.device, dtype=torch.long), q.to(p.dtype))

    def make_prefill_into(self, prefill_fn: Callable[..., Any]):
        """Paged insertion prefill: run the family prefill on the request
        bucket, write its dense leaves into the slots' lanes and block-split
        its token leaves into the mapped pages ``block_ids`` [G, P]."""

        def prefill_into(net, batch, pool, slots, block_ids):
            logits, part = prefill_fn(net, batch, self.capacity)
            dense_parts = []
            for leaf, (role, j) in zip(pytree.tree_leaves(part), self.spec.roles):
                if role == "dense":
                    dense_parts.append(leaf)
                else:
                    scatter_blocks(pool["data"][j], pool["scale"][j], leaf, block_ids,
                                   self.spec.paged[j], self.spec)
            self._scatter_dense(pool["dense"], tuple(dense_parts), slots)
            return logits, pool

        return prefill_into

    def make_prefill_suffix(self, suffix_fn: Callable[..., Any]):
        """Suffix insertion prefill for prefix-cache hits: rebuild each
        lane's cache context from the pages its page-table row ``pt`` [G, P]
        maps (valid for the first ``batch["offsets"]`` tokens; the dense
        length leaves set to the offsets), run the model's cache-extend
        prefill on the suffix, then scatter only the suffix rows ``[offset,
        offset + length)`` back. Shared prefix blocks are read, never
        written: every position at or past the offset lies in a private
        (or copy-on-write) page of the lane."""

        def prefill_suffix_into(net, batch, pool, slots, pt):
            offsets = batch["offsets"]
            g = offsets.shape[0]
            leaves = []
            for role, j in self.spec.roles:
                if role == "paged":
                    leaves.append(gather_leaf(pool["data"][j], pool["scale"][j], pt,
                                              self.spec.paged[j], self.spec))
                    continue
                ref, ax = self._dense_shapes[j], self.spec.dense_slot_axes[j]
                if ax is None:   # a slot-independent leaf passes through
                    leaves.append(pool["dense"][j])
                    continue
                shape = tuple(g if i == ax else n for i, n in enumerate(ref.shape))
                view = tuple(g if i == ax else 1 for i in range(len(shape)))
                leaves.append(offsets.to(ref.dtype).reshape(view).expand(shape))
            logits, part = suffix_fn(net, batch, pytree.tree_unflatten(leaves, self.spec.treedef))
            dense_parts = []
            for leaf, (role, j) in zip(pytree.tree_leaves(part), self.spec.roles):
                if role == "dense":
                    dense_parts.append(leaf)
                else:
                    scatter_rows(pool["data"][j], pool["scale"][j], leaf, pt, offsets,
                                 batch["lengths"], batch["tokens"].shape[1],
                                 self.spec.paged[j], self.spec)
            self._scatter_dense(pool["dense"], tuple(dense_parts), slots)
            return logits, pool

        return prefill_suffix_into

    def copy_block(self, pool: dict, src: int, dst: int) -> dict:
        """Copy one physical block, in place, in every paged leaf (payload
        and scales): the copy-on-write of a shared block into a private page."""
        for leaf in (*pool["data"], *(s for s in pool["scale"] if s is not None)):
            leaf[dst] = leaf[src]
        return pool

    def reset(self, pool: dict, slots: torch.Tensor) -> dict:
        """Retirement: the slots' dense leaves back to their init values (the
        fresh-part insertion of the dense pool). Block storage needs no wipe:
        a freed page is mapped and written (prefill insert, decode append)
        before any read can reach it."""
        if self._fresh is None:
            self._fresh = self._dense_leaves(1)
        for s in slots.tolist():
            self._scatter_dense(pool["dense"], self._fresh, torch.tensor([s]))
        return pool

    # -- accounting --------------------------------------------------------
    def token_bytes_paged(self) -> float:
        """Stored bytes per pooled token (payload and per-row scales), summed
        over every paged leaf (every layer's K and V row)."""
        total = 0.0
        for meta, rest in zip(self.spec.paged, self._rest_shapes):
            total += math.prod(rest) * self.quant.storage_dtype(meta.dtype).itemsize
            if self.quant.scaled:
                total += math.prod(rest[:-1]) * 4
        return total

    def token_bytes_dense(self) -> float:
        """Bytes per token of an unquantized pool."""
        return float(sum(math.prod(rest) * meta.dtype.itemsize
                         for meta, rest in zip(self.spec.paged, self._rest_shapes)))

    def slot_bytes_dense_leaves(self) -> float:
        """Per-slot bytes of the dense part (FLARE's stream state, lengths)."""
        return float(sum(t.numel() // t.shape[ax] * t.element_size()
                         for t, ax in zip(self._dense_shapes, self.spec.dense_slot_axes)
                         if ax is not None))

    def pool_bytes(self) -> float:
        """Bytes of block storage, the trash row excluded."""
        return self.num_blocks * self.block * self.token_bytes_paged()

    def describe(self) -> str:
        return (f"paged-pool[{len(self.spec.paged)} paged + {len(self.spec.dense_slot_axes)} "
                f"dense leaves, {self.num_blocks}x{self.block}-token blocks (+trash), "
                f"quant={self.quant.name}, {self.pool_bytes() / 1e6:.2f} MB storage, "
                f"{self.token_bytes_paged():.0f} B/token vs {self.token_bytes_dense():.0f} "
                f"dense, {self.slot_bytes_dense_leaves() / 1e6:.3f} MB/slot dense part]")
