"""Causal FLARE: a CUDA kernel for Hopper with its plain version.

Counterpart of ``repro/kernels/flare_causal.py``:
:func:`flare_causal_chunk` replaces ``_causal_chunk_kernel`` /
``flare_causal_chunk_pallas``. Token t decodes against the latent state
(max, num, den) of tokens <= t, the ``flare_lm`` mixer of every layer's
``Model.forward``.

The kernel is in ``csrc/flare_causal.cu``, whose head comment says what
bounds it on an H100 and what its design does about it: both routes run on
the tensor cores, bf16 ``causal_tc_kernel`` (``mma.sync`` bf16) and fp32
``causal_tf32_kernel`` (``mma.sync`` TF32, every operand split in two TF32
parts; ``kernels/ref.py::flare_causal_split_ref(split="tf32")`` emulates
its products). Its token tile (``TILE``, the bf16 route's; the fp32 route
takes half of it) is its own constant: the
result depends on the tile only through rounding and the bounded-score
contract of ``core/flare_stream.py``, so the plan carries no tile (the TPU
kernel takes the plan's ``chunk_size``). The wrapper
takes q ``[H, M, D]`` with k/v ``[B, H, T, D]`` in any strides with a unit D
stride, T any length (nothing is padded), and returns y as a ``[B, H, T, D]``
view of ``[B, T, H, D]`` memory, so merging heads is free. On a CPU tensor it
runs the plain version (``kernels/ref.py::flare_causal_chunk_ref`` at the
kernel's tile); on a CUDA tensor it launches the kernel or raises. It counts
its launches in ``flare_causal_chunk.launches``. Forward-only, as the TPU
kernel: a call that autograd would record raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flare import (
    DTYPE_CODES,
    check_kernel_operands,
    check_operands,
    forbid_grad,
    heads_out,
    on_cuda,
    ptr,
)
from repro_torch.kernels.ref import flare_causal_chunk_ref

TILE = 64                            # tokens per tile of csrc/flare_causal.cu's bf16 route
HEAD_DIMS = range(1, 129)   # D it takes (padded to 32, 64 or 128)


def flare_causal_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal FLARE, scale 1: q [H, M, D], k/v [B, H, T, D] -> y [B, H, T, D]
    in v's dtype."""
    forbid_grad("flare_causal_chunk", q, k, v, grads_via="the plain 'causal_stream' backend")
    check_operands("flare_causal_chunk", q, k, v)
    if not on_cuda("flare_causal_chunk", q, k, v):
        return flare_causal_chunk_ref(q, k, v, tile=TILE)
    check_kernel_operands("flare_causal_chunk", q, k, v, head_dims=HEAD_DIMS)
    b, h, n, d = k.shape
    m = q.shape[1]
    dev = k.device
    lib = _build.lib()
    splits = lib.flare_causal_splits(m)
    part = torch.empty(splits * b * h * n * d, dtype=torch.float32, device=dev)
    stat = torch.empty(splits * b * h * n * 2, dtype=torch.float32, device=dev)
    y = heads_out(b, h, n, d, v.dtype, dev)
    err = lib.flare_causal(
        ptr(q), ptr(k), ptr(v), ptr(y), ptr(part), ptr(stat), b, h, m, n, d,
        *k.stride()[:3], *v.stride()[:3], *y.stride()[:3], DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flare_causal_chunk")
    flare_causal_chunk.launches += 1
    return y


flare_causal_chunk.launches = 0
