"""The fused FLARE forward: CUDA kernels for Hopper with the plain version.

Counterpart of ``repro/kernels/flare_packed.py``: :func:`flare_fused_fwd`
replaces ``_fwd_launch`` / ``_fused_fwd_kernel``. It returns y with the
residuals the backward pass reads, in the port's own layout: Z
``[B, H, M, D]`` fp32 and the per-latent max and den ``[B, H, M]`` fp32.

The TPU kernel packs heads block-diagonally into the 128 lanes and keeps Z
in VMEM across an encode->decode phase switch of one grid. Neither carries
to Hopper: lane packing is an MXU artefact, and blocks cannot hand Z over
without a grid-wide barrier. So the entry point is the encode kernel with
statistics followed by the decode kernel over fp32 Z in device memory, the
same two C entry points and ``__global__`` kernels the encode and decode
wrappers launch (only Z's dtype and the statistics differ); Z is 512 KB per
batch element at M=2048, D=8 and is read from L2. It counts its own
launches. Forward-only until the backward kernel is ported: a call that
autograd would record raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flare import (
    check_kernel_operands,
    check_operands,
    decode_into,
    encode_into,
    forbid_grad,
    heads_out,
    on_cuda,
)
from repro_torch.kernels.ref import flare_fused_fwd_ref


def flare_fused_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q [H, M, D], k/v [B, H, N, D] (any strides) -> (y [B, H, N, D] in v's
    dtype, Z [B, H, M, D] fp32, max [B, H, M] fp32, den [B, H, M] fp32)."""
    forbid_grad("flare_fused_fwd", q, k, v)
    check_operands("flare_fused_fwd", q, k, v)
    if not on_cuda("flare_fused_fwd", q, k, v):
        return flare_fused_fwd_ref(q, k, v)
    check_kernel_operands("flare_fused_fwd", q, k, v)
    b, h, n, d = k.shape
    m = q.shape[1]
    dev = k.device
    y = heads_out(b, h, n, d, v.dtype, dev)
    z = torch.empty((b, h, m, d), dtype=torch.float32, device=dev)
    mx = torch.empty((b, h, m), dtype=torch.float32, device=dev)
    den = torch.empty((b, h, m), dtype=torch.float32, device=dev)
    encode_into(q, k, v, z, mx, den)
    decode_into(q, k, z, y)
    flare_fused_fwd.launches += 1
    return y, z, mx, den


flare_fused_fwd.launches = 0
