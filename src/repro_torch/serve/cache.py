"""Slot-indexed state caches for continuous batching: the dense pool.

Counterpart of ``repro/serve/cache.py``. A serving **slot** is one batch
lane of the engine's persistent cache pool: the pool is allocated once
(``init_caches(slots, capacity)``); requests are *inserted* into free slots
at admission and slots are *reset* at retirement.

Every cache family of the port (gqa :class:`KVCache` layers, FLARE
:class:`FlareState` layers, the position vector) is a pytree whose leaves
carry the batch on some axis. :func:`slot_axes` *discovers* that axis per
leaf by building ``init_caches`` at batch 1 and 2 on the ``meta`` device
(the counterpart of ``jax.eval_shape``: shapes only, nothing allocated);
leaves with no such axis are slot-shared and left alone. Reset inserts a
freshly initialised single-slot part, which is what makes it exact for
leaves whose init value is not zero (``FlareState.m_max`` returns to -inf),
so ``flare_lm`` serves through this pool with no FLARE-specific slot code.

Unlike the JAX package, which returns new arrays, ``insert`` and ``reset``
write the pool's tensors in place (``index_copy_``) and return the pool.
The paged counterpart is :mod:`repro_torch.serve.pool`.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.utils import _pytree as pytree


def _slot_axis(small: torch.Tensor, big: torch.Tensor) -> Optional[int]:
    if small.shape == big.shape:
        return None
    diffs = [i for i, (a, b) in enumerate(zip(small.shape, big.shape)) if a != b]
    if small.dim() != big.dim() or len(diffs) != 1:
        raise ValueError(f"cannot identify a unique slot axis: {tuple(small.shape)} vs "
                         f"{tuple(big.shape)}")
    return diffs[0]


def meta_leaves(init_fn: Callable[..., Any], batch: int, capacity: int):
    """``(leaves, treespec)`` of ``init_fn(batch, capacity)`` built on the
    meta device: shapes and dtypes, no storage."""
    return pytree.tree_flatten(init_fn(batch, capacity, device="meta"))


def slot_axes(init_fn: Callable[..., Any], capacity: int) -> List[Optional[int]]:
    """Per-leaf slot (batch) axes of ``init_fn(batch, capacity)``'s pytree,
    in flatten order; ``None`` marks a slot-shared leaf."""
    small, _ = meta_leaves(init_fn, 1, capacity)
    big, _ = meta_leaves(init_fn, 2, capacity)
    return [_slot_axis(a, b) for a, b in zip(small, big)]


def insert_slots(pool: Any, part: Any, slots: torch.Tensor,
                 axes: List[Optional[int]]) -> Any:
    """Write ``part``'s lanes (a cache pytree of the same structure with
    ``len(slots)`` lanes) into ``pool`` at ``slots``, in place along each
    leaf's slot axis; slot-shared leaves keep the pool's value."""
    pool_leaves, spec = pytree.tree_flatten(pool)
    part_leaves, part_spec = pytree.tree_flatten(part)
    if spec != part_spec:
        raise ValueError(f"cache structure mismatch: {spec} vs {part_spec}")
    idx = slots.to(device=pool_leaves[0].device, dtype=torch.long)
    for p, q, ax in zip(pool_leaves, part_leaves, axes):
        if ax is not None:
            p.index_copy_(ax, idx, q.to(p.dtype))
    return pool


class ModelSlotCache:
    """The dense slot pool over any model family's ``init_caches(batch,
    capacity, device=None)`` pytree."""

    def __init__(self, init_fn: Callable[..., Any], capacity: int):
        self.init_fn = init_fn
        self.capacity = capacity
        self.axes = slot_axes(init_fn, capacity)
        self._fresh = None     # one slot's init values, kept for resets

    def init(self, slots: int) -> Any:
        return self.init_fn(slots, self.capacity)

    def insert(self, pool: Any, part: Any, slots: torch.Tensor) -> Any:
        return insert_slots(pool, part, slots, self.axes)

    def reset(self, pool: Any, slots: torch.Tensor) -> Any:
        """Retirement: a reused slot carries no trace of the previous
        request (one fresh slot, built once, inserted at each of ``slots``)."""
        if self._fresh is None:
            self._fresh = self.init(1)
        for s in slots.tolist():
            insert_slots(pool, self._fresh, torch.tensor([s]), self.axes)
        return pool

    def describe(self) -> str:
        leaves, _ = meta_leaves(self.init_fn, 1, self.capacity)
        per_slot = sum(t.numel() * t.element_size() for t in leaves)
        return (f"slot-pool[{len(leaves)} leaves, {per_slot / 1e6:.2f} MB/slot @ "
                f"capacity={self.capacity}]")
