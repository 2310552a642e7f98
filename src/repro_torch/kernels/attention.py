"""Flash attention: a CUDA kernel for Hopper with its plain version.

Counterpart of ``repro/kernels/attention.py``: :func:`flash_attention`
replaces ``_flash_kernel`` / ``flash_attention_pallas``, softmax attention
with causal (top-left aligned) and sliding-window masks, fully masked tiles
skipped and fully masked rows returning 0. It is the ``impl="pallas"`` route
of ``models/attention.py::attn_sdpa``, through ``kernels/ops.py``.

The kernel is in ``csrc/flash_attention.cu``, whose head comment says what
bounds it on an H100 and what its design does about it. Its tiles (64 query
rows a block, 64 keys a tile) are its own: the TPU wrapper's ``block_q`` /
``block_kv`` and its padding are not needed, since ragged Sq and Skv are loop
bounds and D up to 128 is a run-time value. The wrapper takes q, k, v as
``[G, S, D]`` (as the TPU kernel) or ``[B, H, S, D]`` in any strides with a
unit D stride (the model's split-head views go in without a copy) and
returns o of q's shape in v's dtype, the 4-D output as a view of
``[B, S, H, D]`` memory, so merging heads is free. On a CPU tensor it runs
the plain version (``kernels/ref.py::flash_attention_ref``); on a CUDA tensor
it launches the kernel or raises. It counts its launches in
``flash_attention.launches``. Forward-only, as the TPU kernel.

One deliberate difference: the TPU kernel rounds the softmax weights to v's
dtype before the value product; the CUDA kernel keeps them in fp32 (bf16 is
held at its tolerance).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flare import DTYPE_CODES, forbid_grad, heads_out, on_cuda, ptr
from repro_torch.kernels.ref import flash_attention_ref

KV_TILE = 64          # keys a tile of csrc/flash_attention.cu
MAX_HEAD_DIM = 128
MAX_GROUPS = 65535    # B*H rides on gridDim.y
_INT_MAX = 2**31 - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    """Shapes the kernel and its plain version both take; raises otherwise."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [G, Sq, D] (or [B, H, Sq, D]) and k, v of one "
                         f"shape [G, Skv, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:-2] != k.shape[:-2] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in their groups or head dim")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         "differ")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention: empty problem {tuple(q.shape)} / {tuple(k.shape)}")
    if window is not None and not 0 <= window <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} must be None or in [0, 2**31)")


def _aligned(t: torch.Tensor) -> bool:
    """Rows of t load as 4-element vectors: the base and every stride of a
    dim longer than 1 are multiples of 4 elements."""
    return (t.data_ptr() % (4 * t.element_size()) == 0
            and all(st % 4 == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """softmax(mask(q k^T * scale)) v: q [G, Sq, D] or [B, H, Sq, D], k/v of
    the same leading dims and D with Skv rows -> o of q's shape in v's dtype.
    ``causal`` keeps key j <= query i, ``window`` keeps j > i - window; a row
    with no key left returns 0."""
    forbid_grad("flash_attention", q, k, v,
                grads_via="attn_sdpa's 'xla' or 'chunked' route (the flash kernel is "
                          "forward-only, as on the TPU)")
    _check(q, k, v, window)
    if not on_cuda("flash_attention", q, k, v):
        return flash_attention_ref(q, k, v, scale=scale, causal=causal, window=window)
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(DTYPE_CODES)}")
    d = q.shape[-1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} above {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: operands need a unit D stride")
    squeeze = q.dim() == 3
    q4, k4, v4 = (t.unsqueeze(0) if squeeze else t for t in (q, k, v))
    b, h, sq, _ = q4.shape
    skv = k4.shape[2]
    if b * h > MAX_GROUPS or max(sq, skv) > _INT_MAX:
        raise ValueError(f"flash_attention: B*H {b * h} (<= {MAX_GROUPS}), Sq {sq}, Skv {skv}")
    dev = q.device
    o = heads_out(b, h, sq, d, v.dtype, dev)
    vec = d % 4 == 0 and all(_aligned(t) for t in (q4, k4, v4))
    lib = _build.lib()
    err = lib.flash_attention(
        ptr(q4), ptr(k4), ptr(v4), ptr(o), b, h, sq, skv, d, *q4.stride()[:3],
        *k4.stride()[:3], *v4.stride()[:3], *o.stride()[:3], float(scale), int(causal),
        -1 if window is None else int(window), int(vec), DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o[0] if squeeze else o


flash_attention.launches = 0
