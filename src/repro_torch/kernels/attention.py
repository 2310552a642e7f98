"""Flash attention: three CUDA kernels for Hopper with their plain version.

Counterpart of ``repro/kernels/attention.py``: :func:`flash_attention`
replaces ``_flash_kernel`` / ``flash_attention_pallas``, softmax attention
with causal (top-left aligned) and sliding-window masks, fully masked tiles
skipped and fully masked rows returning 0. It is the ``impl="pallas"`` route
of ``models/attention.py::attn_sdpa``, through ``kernels/ops.py``.

On the card a call takes one of three routes, which :func:`flash_route`
picks from dtype, D and strides alone:

* ``"tensor_core"``: bf16 with D a multiple of 8 and tensors TMA can
  address, ``csrc/flash_attention_sm90.cu`` (wgmma, TMA loads, a split
  P that keeps the value product to ~2^-18 of p);
* ``"bf16_mma"``: any other bf16 call (D % 8 != 0, or strides or bases TMA
  cannot address), ``csrc/flash_attention.cu``'s ``flash_bf16_kernel``
  (``mma.sync`` m16n8k16 on the tensor cores, the same split P; rows come
  in by ``cp.async`` in the widest pieces of 16, 8 or 4 bytes their D,
  strides and bases allow, else two bytes at a time through registers);
* ``"fp32"``: fp32 operands, ``csrc/flash_attention.cu``'s
  ``flash_tf32_kernel`` on the TF32 tensor cores, every operand split in
  two TF32 parts and each product three MMAs (its fp64 check at 1e-5 of
  max |o| is beyond one TF32 rounding; ``kernels/ref.py::
  flash_attention_tf32_ref`` emulates its products).

The head comments say what bounds each on an H100 and what their designs do
about it. The kernels' tiles are their own: the TPU wrapper's ``block_q`` /
``block_kv`` and its padding are not needed, since ragged Sq and Skv are loop
bounds (or TMA's zero fill) and D up to 128 is a run-time value. The wrapper
takes q as ``[G, Sq, D]`` (as the TPU kernel) or ``[B, H, Sq, D]`` in any
strides with a unit D stride (the model's split-head views go in without a
copy), k and v with Hkv | H heads (GQA: query head h reads KV head
h // (H / Hkv), so the model's K and V go in unexpanded), and returns o of
q's shape in v's dtype, the 4-D output as a view of ``[B, S, H, D]`` memory,
so merging heads is free. On a CPU tensor it runs the plain version
(``kernels/ref.py::flash_attention_ref``); on a CUDA tensor it launches a
kernel or raises. It counts its launches in ``flash_attention.launches`` and,
by route, in ``flash_attention.launches_by_route``. Forward-only, as the TPU
kernel.

One deliberate difference: the TPU kernel rounds the softmax weights to v's
dtype before the value product; both bf16 kernels split them into two bf16
parts (``kernels/ref.py::flash_attention_bf16_split_ref`` emulates them) and
the TF32 kernel into two TF32 parts (bf16 is held at its tolerance and, on
the card, beyond its output rounding against fp64).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flare import DTYPE_CODES, forbid_grad, heads_out, on_cuda, ptr
from repro_torch.kernels.ref import flash_attention_ref

KV_TILE = 64          # keys a tile of the bf16 kernels (the TF32 kernel's is 32)
MAX_HEAD_DIM = 128
QUERY_TILE = 128      # query rows a block of every kernel (gridDim.y; B*H on gridDim.x)
ROUTES = ("tensor_core", "bf16_mma", "fp32")
_INT_MAX = 2**31 - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    """Shapes the kernels and their plain version all take; raises otherwise."""
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.shape != k.shape:
        raise ValueError(f"flash_attention: q [G, Sq, D] (or [B, H, Sq, D]) and k, v of one "
                         f"shape [G, Skv, D], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[:-3] != k.shape[:-3] or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in their batch or head dim")
    if q.shape[-3] % k.shape[-3]:
        raise ValueError(f"flash_attention: {q.shape[-3]} query heads are not a multiple of "
                         f"{k.shape[-3]} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} "
                         "differ")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention: empty problem {tuple(q.shape)} / {tuple(k.shape)}")
    if window is not None and not 0 <= window <= _INT_MAX:
        raise ValueError(f"flash_attention: window {window} must be None or in [0, 2**31)")


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """The base and every stride of a dim longer than 1 are multiples of
    ``elems`` elements."""
    return (t.data_ptr() % (elems * t.element_size()) == 0
            and all(st % elems == 0 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1))


def copy_unit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The bytes of one copy of a q, k or v row's piece in the ``bf16_mma``
    and ``fp32`` kernels: the widest of 16, 8 and 4 that divides a row (D
    elements), every stride and every base; else the element (bf16: 2 bytes,
    through registers; fp32: 4, by ``cp.async``). The TF32 kernel copies 16
    bytes or 4."""
    size, d = q.element_size(), q.shape[-1]
    units = (16, 8, 4) if size == 2 else (16,)
    for unit in units:
        elems = unit // size
        if d % elems == 0 and all(_aligned(t, elems) for t in (q, k, v)):
            return unit
    return size


def flash_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel a call on the card runs, from dtype, D and strides alone
    (never from a failure): "tensor_core" for bf16 with D % 8 == 0 (D <= 128)
    whose q, k and v TMA can address (a unit D stride, 16-byte bases and
    every other stride a multiple of 16 bytes); "bf16_mma" for any other
    bf16 call; "fp32" for fp32."""
    if q.dtype == torch.float32:
        return "fp32"
    if q.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in {list(DTYPE_CODES)}")
    d = q.shape[-1]
    tma = all(t.stride(-1) == 1 and _aligned(t, 8) for t in (q, k, v))
    return "tensor_core" if d % 8 == 0 and d <= MAX_HEAD_DIM and tma else "bf16_mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    causal: bool = True, window: Optional[int] = None,
                    route: Optional[str] = None) -> torch.Tensor:
    """softmax(mask(q k^T * scale)) v: q [G, Sq, D] or [B, H, Sq, D], k/v of
    the same batch and D with Skv rows and Hkv | H heads -> o of q's shape
    in v's dtype. ``causal`` keeps key j <= query i, ``window`` keeps
    j > i - window; a row with no key left returns 0. ``route``: the kernel
    to run on the card (default :func:`flash_route`'s pick); "bf16_mma" runs
    any bf16 call, "tensor_core" only the calls :func:`flash_route` gives it."""
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
    picked = flash_route(q, k, v)
    route = route or picked
    if route not in ROUTES or (route == "fp32") != (q.dtype == torch.float32) or (
            route == "tensor_core" and picked != "tensor_core"):
        raise ValueError(f"flash_attention: route {route!r} does not take {q.dtype} operands "
                         f"of D={d} and strides {q.stride()}/{k.stride()} (flash_route: "
                         f"{picked!r})")
    squeeze = q.dim() == 3
    q4, k4, v4 = (t.unsqueeze(0) if squeeze else t for t in (q, k, v))
    b, h, sq, _ = q4.shape
    hkv, skv = k4.shape[1], k4.shape[2]
    if b * h > _INT_MAX or max(sq, skv) > _INT_MAX or -(-sq // QUERY_TILE) > 65535:
        raise ValueError(f"flash_attention: B*H {b * h} (< 2**31), Sq {sq} "
                         f"(<= {65535 * QUERY_TILE}), Skv {skv}")
    dev = q.device
    o = heads_out(b, h, sq, d, v.dtype, dev)
    strides = (*q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3], *o.stride()[:3])
    window = -1 if window is None else int(window)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    if route == "tensor_core":
        err = lib.flash_attention_tc(ptr(q4), ptr(k4), ptr(v4), ptr(o), b, h, hkv, sq, skv, d,
                                     *strides, float(scale), int(causal), window, stream)
    else:
        entry = lib.flash_attention_tf32 if route == "fp32" else lib.flash_attention_bf16
        err = entry(ptr(q4), ptr(k4), ptr(v4), ptr(o), b, h, hkv, sq, skv, d, *strides,
                    float(scale), int(causal), window, copy_unit(q4, k4, v4), stream)
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return o[0] if squeeze else o


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
