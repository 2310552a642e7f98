"""Paged attention: a CUDA kernel for Hopper with its plain version.

Counterpart of ``repro/kernels/paged_attention.py``: :func:`paged_attention`
replaces ``_paged_kernel`` / ``paged_attention_pallas``. It reads K/V
straight from the serving pool's block storage ``[NB, block, H, D]``
through a per-lane page table, masks rows past each lane's length, and
dequantizes int8 / fp8 rows with per-row scales in registers. The query
axis G is the consumer: G = query heads per KV head for the gqa decode read
(``models/attention.py::gqa_cache_attend``), G = the heads over one page
head of compressed latents for MLA's absorbed decode (``mla_decode``: D =
kv_lora_rank, the latents both K and V, q2 over the rotary key), G = M
latents for FLARE's encode off pages (the ``paged`` backend).

The kernel is in ``csrc/paged_attention.cu``, whose head comment says what
bounds it on an H100 and what its design does about it: the decode read's
instance (a block takes up to 8 query rows of one lane and KV head), MLA's
(D > 128: a block stages each token row once and all its query rows read
it, both products on the tensor cores: bf16 MMAs over bf16, int8 and fp8
pages, TF32 MMAs with every operand in two parts over fp32 pages) and the
FLARE encode's (a thread a latent), which the C entry point picks from G,
D, q2 and the page dtype. The page slices a call splits each lane into
come from the shapes and the card (``paged_attention_splits``). On a CPU
tensor the wrapper runs the plain version
(``kernels/ref.py::paged_attention_ref``); on a CUDA tensor it launches the
kernel or raises (the instance :func:`paged_route` names), inside
``obs.scope("kernels.paged_attention")``. The page table and lengths
stay on the device: nothing is read back to the host, so a decode step that
calls it once a layer keeps its one device-to-host copy. It counts its
launches in ``paged_attention.launches`` and, by the instance the entry
point reports it launched, in ``paged_attention.launches_by_route``. Forward-only, as the TPU kernel.
The TPU wrapper's padding of D to 128 lanes and of G to 8 sublanes is not
needed: the kernel takes D and G as they are.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flare import forbid_grad, ptr
from repro_torch.kernels.ref import paged_attention_ref, paged_out_dtype
from repro_torch.obs import scope

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float8_e4m3fn: 3}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = range(1, 513)   # D it takes (to 128 tiled at the next power of two from 8;
                            # above, the MLA instance at 256 or 512)
MAX_BLOCK = 128                    # tokens a page (a multiple of 4)
ROUTES = ("decode", "encode", "mla_tc", "mla_tf32")


def paged_route(q: torch.Tensor, k_pages: torch.Tensor, q2: Optional[torch.Tensor] = None) -> str:
    """The instance a call on the card runs, from G, D, q2 and the page dtype
    alone, as ``csrc/paged_attention.cu``'s entry point picks it: "mla_tc"
    (``paged_mla_tc_kernel``) for D > 128 over bf16, int8 or fp8 pages,
    "mla_tf32" (``paged_mla_tf32_kernel``, the TF32 tensor cores) for D >
    128 over fp32 pages, "encode" for G > 32 at D <= 32 without q2, else
    "decode". The
    entry point reports the instance it launched, and the wrapper raises
    where that is not this one."""
    g, d = q.shape[-2:]
    if d > 128:
        return "mla_tf32" if k_pages.dtype == torch.float32 else "mla_tc"
    return "encode" if q2 is None and d <= 32 and g > 32 else "decode"


def _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale, q2, k2_pages, k2_scale):
    """Shapes the kernel and its plain version both take; raises otherwise."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError(f"paged_attention: q [B, H, G, D] and pages [NB, block, H, D], got "
                         f"{tuple(q.shape)} and {tuple(k_pages.shape)}")
    b, h, g, d = q.shape
    nb, blk = k_pages.shape[:2]
    if tuple(k_pages.shape) != (nb, blk, h, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged_attention: pages must be [NB, block, {h}, {d}], got "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    if v_pages.dtype != k_pages.dtype:
        raise ValueError(f"paged_attention: k pages {k_pages.dtype}, v pages {v_pages.dtype}")
    if page_table.dim() != 2 or page_table.shape[0] != b or tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention: page table [{b}, P] and lengths [{b}], got "
                         f"{tuple(page_table.shape)} and {tuple(lengths.shape)}")
    for name, sc in (("k_scale", k_scale), ("v_scale", v_scale), ("k2_scale", k2_scale)):
        if sc is not None and (tuple(sc.shape) != (nb, blk, h) or sc.dtype != torch.float32):
            raise ValueError(f"paged_attention: {name} must be [{nb}, {blk}, {h}] fp32, got "
                             f"{tuple(sc.shape)} {sc.dtype}")
    if (q2 is None) != (k2_pages is None) or (k2_scale is not None and q2 is None):
        raise ValueError("paged_attention: q2 and k2_pages come together (k2_scale with them)")
    if q2 is not None:
        d2 = q2.shape[-1]
        if tuple(q2.shape) != (b, h, g, d2) or q2.dtype != q.dtype:
            raise ValueError(f"paged_attention: q2 must be [{b}, {h}, {g}, D2] of q's dtype, "
                             f"got {tuple(q2.shape)} {q2.dtype}")
        if tuple(k2_pages.shape) != (nb, blk, h, d2) or k2_pages.dtype != k_pages.dtype:
            raise ValueError(f"paged_attention: k2 pages must be [{nb}, {blk}, {h}, {d2}] of "
                             f"the pages' dtype, got {tuple(k2_pages.shape)} {k2_pages.dtype}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *, scale: float = 1.0,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    q2: Optional[torch.Tensor] = None,
                    k2_pages: Optional[torch.Tensor] = None,
                    k2_scale: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Softmax(scale * (q k^T [+ q2 k2^T]) over each lane's valid tokens) @ v,
    reading the pages ``page_table[b, :]`` ([B, P] int32) of block storage
    and the first ``lengths[b]`` ([B] int32) tokens of them: q [B, H, G, D],
    pages [NB, block, H, D] -> [B, H, G, D] in ``out_dtype`` (default: the
    pages' dtype where that is fp32 or bf16, else q's). Lanes of length 0
    return 0. Each call runs inside ``obs.scope("kernels.paged_attention")``,
    so a ``torch.profiler`` trace names every launch, whoever the caller."""
    with scope("kernels.paged_attention"):
        return _paged_attention(q, k_pages, v_pages, page_table, lengths, scale=scale,
                                k_scale=k_scale, v_scale=v_scale, q2=q2, k2_pages=k2_pages,
                                k2_scale=k2_scale, out_dtype=out_dtype)


def _paged_attention(q, k_pages, v_pages, page_table, lengths, *, scale, k_scale, v_scale, q2,
                     k2_pages, k2_scale, out_dtype):
    opt = [t for t in (k_scale, v_scale, q2, k2_pages, k2_scale) if t is not None]
    forbid_grad("paged_attention", q, k_pages, v_pages, *opt,
                grads_via="no kernel: the paged read is forward-only, as on the TPU")
    _check(q, k_pages, v_pages, page_table, lengths, k_scale, v_scale, q2, k2_pages, k2_scale)
    tensors = (q, k_pages, v_pages, page_table, lengths, *opt)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"paged_attention: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    kind = q.device.type
    if kind == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, page_table, lengths, scale=scale,
                                   k_scale=k_scale, v_scale=v_scale, q2=q2, k2_pages=k2_pages,
                                   k2_scale=k2_scale, out_dtype=out_dtype)
    if kind != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {kind!r}")
    out_dtype = paged_out_dtype(q, v_pages, out_dtype)
    b, h, g, d = q.shape
    blk, p = k_pages.shape[1], page_table.shape[1]
    d2 = 0 if q2 is None else q2.shape[-1]
    if q.dtype not in Q_DTYPES or k_pages.dtype not in PAGE_DTYPES or out_dtype not in OUT_DTYPES:
        raise ValueError(f"paged_attention: q {q.dtype}, pages {k_pages.dtype}, out {out_dtype}; "
                         f"the kernel takes q in {list(Q_DTYPES)}, pages in {list(PAGE_DTYPES)}, "
                         f"out in {list(OUT_DTYPES)}")
    d2_max = 64 if d > 128 else 128   # the MLA instance's k2 rows
    if d not in HEAD_DIMS or (d2 and (d2 % 8 or d2 > d2_max)):
        raise ValueError(f"paged_attention: head dim {d} not in {HEAD_DIMS}, or D2 {d2} not a "
                         f"multiple of 8 up to {d2_max}")
    if not 4 <= blk <= MAX_BLOCK or blk % 4 or b * h > 65535 or p < 1:
        raise ValueError(f"paged_attention: block {blk} (a multiple of 4 up to {MAX_BLOCK}), "
                         f"B*H {b * h} (<= 65535), P {p} (>= 1)")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: page table and lengths must be int32")
    if not all(t.is_contiguous() for t in tensors) or any(
            t.data_ptr() % 16 for t in (k_pages, v_pages, k2_pages) if t is not None):
        raise ValueError("paged_attention: operands must be contiguous, pages 16-byte aligned")
    fused = bool(opt) or q.dtype != k_pages.dtype
    lib = _build.lib()
    splits = lib.paged_attention_splits(b, h, g, d, d2, blk, p, PAGE_DTYPES[k_pages.dtype])
    dev = q.device
    part_acc = torch.empty(splits * b * h * g * d if splits > 1 else 0, dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty(splits * b * h * g * 2 if splits > 1 else 0, dtype=torch.float32,
                          device=dev)
    out = torch.empty(b, h, g, d, dtype=out_dtype, device=dev)
    ran = ctypes.c_int(-1)
    err = lib.paged_attention(
        ptr(q), ptr(q2), ptr(k_pages), ptr(v_pages), ptr(k2_pages), ptr(page_table),
        ptr(lengths), ptr(k_scale), ptr(v_scale), ptr(k2_scale), ptr(out),
        ptr(part_acc), ptr(part_ml), b, h, g, d, d2, blk, p, splits, float(scale),
        Q_DTYPES[q.dtype], PAGE_DTYPES[k_pages.dtype], OUT_DTYPES[out_dtype], int(fused),
        torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(ran))
    _build.check(err, "paged_attention")
    route = ROUTES[ran.value]
    if route != paged_route(q, k_pages, q2):
        raise RuntimeError(f"paged_attention: the entry point launched the {route!r} instance, "
                           f"paged_route names {paged_route(q, k_pages, q2)!r}")
    paged_attention.launches += 1
    paged_attention.launches_by_route[route] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
