"""Gather/scatter between block storage and the dense cache layout, and the
view the decode step reads the paged pool through.

Counterpart of ``repro/serve/pool/views.py``. A paged leaf lives in
**storage layout** ``[num_blocks + 1, block, *rest]`` (the ``+1`` is the
trash sink; ``rest`` = the leaf's shape without its slot and token axes).
For a gqa layer's ``[B, Hkv, cap, D]`` K or V leaf that is ``[NB + 1,
block, Hkv, D]``, the paged-attention kernel's own page layout (the port
keeps one leaf per layer, so no stacked-layer axis needs moving); an mla
layer's ``[B, cap, r]`` latent leaf is ``[NB + 1, block, r]``, which the
kernel reads with a singleton head axis:

  - :func:`gather_leaf`    page table -> dense leaf (dequantized);
  - :func:`scatter_blocks` prefill insert: a request's bucket, block-split
                           and quantized, into its mapped pages;
  - :func:`scatter_rows`   suffix-prefill insert (the prefix cache's hit
                           path): only a lane's true suffix rows, into the
                           pages its page-table row names;
  - :func:`scatter_token_at` decode write-back: the one column decode wrote,
                           quantized, into (page, offset).

:class:`PagedCacheView` (pool, device page table, per-slot write positions)
stands in for the caches of ``model.decode_step``, which resolves it with
:func:`resolve_cache_view` at its top. Two routes, picked by
``PoolSpec.kernel`` (the engine sets it when its decode-plan resolution
picks the ``paged`` backend):

  - gather: a dense caches pytree is gathered from storage on entry, and
    on exit only the written column goes back (one scatter a leaf, at the
    (page, offset) computed once for all leaves);
  - kernel: paged leaves resolve to :class:`PagedTokenView` handles (block
    storage, the shared page table, the write target); attention appends
    the new row into storage and hands the pages to the paged-attention
    kernel, so no dense view is ever gathered.

Unlike the JAX package, which returns new arrays, every write here updates
the pool's storage in place (``index_put_``); the views returned carry the
same tensors. Garbage gathered from unmapped pages sits behind the decode
validity masks (index < length).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.serve.pool.quant import QuantSpec, dequantize, quantize


@dataclasses.dataclass(frozen=True)
class PagedLeaf:
    """Static facts about one token-axis leaf."""

    slot_axis: int
    token_axis: int
    view: int              # dense token extent the model expects (== capacity)
    dtype: torch.dtype     # dense-leaf dtype (the dequantization target)


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """Which leaf (in flatten order) is dense and which paged, the block
    geometry and the quantization."""

    treedef: Any                        # the caches pytree's TreeSpec
    roles: Tuple[Tuple[str, int], ...]  # per leaf: ("dense", i) | ("paged", j)
    paged: Tuple[PagedLeaf, ...]        # per paged leaf j
    dense_slot_axes: Tuple[Optional[int], ...]   # per dense leaf i
    block: int
    max_pages: int
    quant: QuantSpec
    kernel: bool = False   # resolve to PagedTokenView handles (the kernel route)


# ---------------------------------------------------------------------------
# layout and indexing
# ---------------------------------------------------------------------------


def _perm(ndim: int, sax: int, tax: int):
    return [sax, tax] + [i for i in range(ndim) if i not in (sax, tax)]


def to_pool_layout(leaf: torch.Tensor, sax: int, tax: int) -> torch.Tensor:
    """[..., S@sax, ..., T@tax, ...] -> [S, T, *rest] (a view)."""
    return leaf.permute(_perm(leaf.dim(), sax, tax))


def from_pool_layout(x: torch.Tensor, sax: int, tax: int) -> torch.Tensor:
    """Inverse of :func:`to_pool_layout`."""
    perm = _perm(x.dim(), sax, tax)
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return x.permute(inv)


def _raw(t: torch.Tensor) -> torch.Tensor:
    """fp8 payloads are indexed through a uint8 view, which every torch
    version gathers and scatters."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def take(data: torch.Tensor, idx) -> torch.Tensor:
    """``data[idx]`` for any payload dtype."""
    return _raw(data)[idx].view(data.dtype)


def put_(data: torch.Tensor, idx, value: torch.Tensor) -> None:
    """``data[idx] = value`` in place, for any payload dtype."""
    _raw(data)[idx] = _raw(value.to(data.dtype))


# ---------------------------------------------------------------------------
# leaf ops
# ---------------------------------------------------------------------------


def gather_leaf(data: torch.Tensor, scale: Optional[torch.Tensor], pt: torch.Tensor,
                meta: PagedLeaf, spec: PoolSpec) -> torch.Tensor:
    """The dense leaf of every slot, from block storage: pt [S, P] (trash
    for unmapped pages, whose garbage is behind the decode mask)."""
    idx = pt.long()
    x = dequantize(spec.quant, take(data, idx), None if scale is None else scale[idx],
                   meta.dtype)                                   # [S, P, block, *rest]
    s, p, blk = x.shape[:3]
    x = x.reshape(s, p * blk, *x.shape[3:])[:, :meta.view]
    return from_pool_layout(x, meta.slot_axis, meta.token_axis)


def scatter_blocks(data: torch.Tensor, scale: Optional[torch.Tensor], part_leaf: torch.Tensor,
                   block_ids: torch.Tensor, meta: PagedLeaf, spec: PoolSpec) -> None:
    """Prefill insert, in place: ``part_leaf``'s first P*block tokens (the
    request's bucket) into physical pages ``block_ids`` [G, P]."""
    g, npages = block_ids.shape
    y = to_pool_layout(part_leaf, meta.slot_axis, meta.token_axis)   # [G, view, *rest]
    n = npages * spec.block
    if y.shape[1] < n:
        y = torch.nn.functional.pad(y.movedim(1, -1), (0, n - y.shape[1])).movedim(-1, 1)
    y = y[:, :n].reshape(g, npages, spec.block, *y.shape[2:])
    q, sc = quantize(spec.quant, y)
    idx = block_ids.long()
    put_(data, idx, q)
    if scale is not None:
        scale[idx] = sc


def scatter_rows(data: torch.Tensor, scale: Optional[torch.Tensor], part_leaf: torch.Tensor,
                 pt: torch.Tensor, offsets: torch.Tensor, lengths: torch.Tensor, width: int,
                 meta: PagedLeaf, spec: PoolSpec) -> None:
    """Suffix-prefill insert, in place. ``part_leaf`` is a full-capacity
    cache leaf (the extend path returns the whole updated cache); lane g's
    rows ``[offsets[g], offsets[g] + width)`` go to the (page, in-page
    offset) its page-table row ``pt`` [G, P] names, and of those only the
    first ``lengths[g]`` land: bucket padding goes to the trash block. So a
    suffix may begin mid-block (the copy-on-write target) while the lane's
    earlier pages stay shared and read-only."""
    y = to_pool_layout(part_leaf, meta.slot_axis, meta.token_axis)   # [G, T, *rest]
    g = y.shape[0]
    pos = offsets.long()[:, None] + torch.arange(width, device=y.device)[None, :]   # [G, S]
    rows = y[torch.arange(g, device=y.device)[:, None], pos.clamp_max(y.shape[1] - 1)]
    q, sc = quantize(spec.quant, rows)                                  # [G, S, *rest]
    page = pt.long().gather(1, (pos // spec.block).clamp_max(spec.max_pages - 1))
    valid = torch.arange(width, device=y.device)[None, :] < lengths.long()[:, None]
    page = torch.where(valid, page, torch.full_like(page, data.shape[0] - 1))
    off = pos % spec.block
    put_(data, (page, off), q)
    if scale is not None:
        scale[page, off] = sc


def token_page_off(pt: torch.Tensor, write_pos: torch.Tensor, block: int):
    """(physical page, in-page offset) of each slot's write position. One
    page table serves every leaf and layer, so the decode write-back
    computes the pair once."""
    pos = write_pos.long()
    page = pt.long().gather(1, (pos // block)[:, None])[:, 0]
    return page, pos % block


def scatter_token_at(data: torch.Tensor, scale: Optional[torch.Tensor], new_leaf: torch.Tensor,
                     page: torch.Tensor, off: torch.Tensor, write_pos: torch.Tensor,
                     meta: PagedLeaf, spec: PoolSpec) -> None:
    """Decode write-back, in place: the column decode wrote (position
    ``write_pos[s]`` of each slot) into (page, offset). Idle slots' page
    rows are all trash, so their writes land in the sink."""
    y = to_pool_layout(new_leaf, meta.slot_axis, meta.token_axis)    # [S, view, *rest]
    col = y[torch.arange(y.shape[0], device=y.device), write_pos.long()]   # [S, *rest]
    q, sc = quantize(spec.quant, col)
    put_(data, (page, off), q)
    if scale is not None:
        scale[page, off] = sc


# ---------------------------------------------------------------------------
# the kernel route's leaf handle
# ---------------------------------------------------------------------------


class PagedTokenView:
    """A paged cache leaf in kernel page layout, standing in for the dense
    leaf inside the caches when ``PoolSpec.kernel``: storage ``data``
    ``[NB + 1, block, *tail]``, optional per-row ``scale``, the shared page
    table ``pt`` [S, P] and the write target ``(page, off)`` [S]. Attention
    calls :meth:`append` for the new token's row and hands :meth:`pages`
    with ``pt`` to the paged-attention kernel."""

    def __init__(self, data, scale, pt, page, off, meta: PagedLeaf, block: int,
                 quant: QuantSpec):
        self.data, self.scale, self.pt, self.page, self.off = data, scale, pt, page, off
        self.meta, self.block, self.quant = meta, block, quant

    def append(self, col: torch.Tensor) -> "PagedTokenView":
        """Write the new row ``col`` [S, *tail] (quantized) at each slot's
        (page, offset), in place; idle slots hit the trash sink."""
        q, sc = quantize(self.quant, col)
        put_(self.data, (self.page, self.off), q)
        if self.scale is not None:
            self.scale[self.page, self.off] = sc
        return self

    def pages(self):
        """(data [NB, block, H, D], scale [NB, block, H] or None) for the
        kernel: a featureless leaf (an mla latent row, tail ``(D,)``) gets a
        singleton head axis (views of the same storage)."""
        data, scale = self.data, self.scale
        if data.dim() == 3:
            data = data.unsqueeze(2)
            if scale is not None:
                scale = scale.unsqueeze(2)
        return data, scale


# ---------------------------------------------------------------------------
# the decode step's view of the pool
# ---------------------------------------------------------------------------


class PagedCacheView:
    """Stands in for the caches of ``model.decode_step``: the pool (dense
    leaves, block storage, scales), the device page table [S, P] and the
    per-slot write positions [S], with the static :class:`PoolSpec`."""

    def __init__(self, pool: dict, pt: torch.Tensor, write_pos: torch.Tensor, spec: PoolSpec):
        self.pool, self.pt, self.write_pos, self.spec = pool, pt, write_pos, spec

    def _with_dense(self, new_caches) -> "PagedCacheView":
        """The view with the decode step's dense leaves replacing the pool's
        (paged leaves are written in place, by the caller)."""
        dense = list(self.pool["dense"])
        leaves = pytree.tree_leaves(new_caches)
        for leaf, (role, j) in zip(leaves, self.spec.roles):
            if role == "dense":
                dense[j] = leaf
        return PagedCacheView({**self.pool, "dense": tuple(dense)}, self.pt, self.write_pos,
                              self.spec)

    def gather(self):
        """The dense caches pytree, gathered from the pool."""
        spec = self.spec
        leaves = [self.pool["dense"][j] if role == "dense" else
                  gather_leaf(self.pool["data"][j], self.pool["scale"][j], self.pt,
                              spec.paged[j], spec)
                  for role, j in spec.roles]
        return pytree.tree_unflatten(leaves, spec.treedef)

    def writeback(self, new_caches) -> "PagedCacheView":
        """Fold the decode-updated dense caches back: dense leaves replaced,
        paged leaves given only the written column."""
        spec = self.spec
        page, off = token_page_off(self.pt, self.write_pos, spec.block)
        for leaf, (role, j) in zip(pytree.tree_leaves(new_caches), spec.roles):
            if role == "paged":
                scatter_token_at(self.pool["data"][j], self.pool["scale"][j], leaf, page, off,
                                 self.write_pos, spec.paged[j], spec)
        return self._with_dense(new_caches)

    def kernel_caches(self):
        """The caches with :class:`PagedTokenView` handles at the paged
        leaves' places."""
        spec = self.spec
        page, off = token_page_off(self.pt, self.write_pos, spec.block)
        leaves = [self.pool["dense"][j] if role == "dense" else
                  PagedTokenView(self.pool["data"][j], self.pool["scale"][j], self.pt, page,
                                 off, spec.paged[j], spec.block, spec.quant)
                  for role, j in spec.roles]
        return pytree.tree_unflatten(leaves, spec.treedef)

    def kernel_writeback(self, new_caches) -> "PagedCacheView":
        """The paged leaves' storage already holds the appended rows; only
        the dense leaves are replaced."""
        return self._with_dense(new_caches)


def resolve_cache_view(caches):
    """The decode step's entry hook: a :class:`PagedCacheView` resolves to
    (caches, write-back) on the route its spec picks; anything else passes
    through with an identity write-back."""
    if isinstance(caches, PagedCacheView):
        if caches.spec.kernel:
            return caches.kernel_caches(), caches.kernel_writeback
        return caches.gather(), caches.writeback
    return caches, lambda c: c
