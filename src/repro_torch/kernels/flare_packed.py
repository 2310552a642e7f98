"""The fused FLARE forward and backward: CUDA kernels for Hopper with their
plain versions, and the autograd function that joins them.

Counterpart of ``repro/kernels/flare_packed.py``:

* :func:`flare_fused_fwd` replaces ``_fwd_launch`` / ``_fused_fwd_kernel``.
  It returns y with the residuals the backward reads, in the port's own
  layout: Z ``[B, H, M, D]``, the encode's per-latent max and den
  ``[B, H, M]``, and the decode's per-token log-sum-exp ``[B, H, N]``, all
  fp32.
* :func:`flare_fused_bwd` replaces ``_bwd_launch`` / ``_fused_bwd_kernel``
  and the batch sum of dq in ``_packed_core_bwd``.
* :class:`FlareFused` is the counterpart of ``_packed_core`` with its
  ``defvjp``: forward through :func:`flare_fused_fwd`, backward through
  :func:`flare_fused_bwd`. The ``packed`` backend runs through it.

The TPU kernels pack heads block-diagonally into the 128 lanes and keep Z
(forward) or dZ (backward) in VMEM across a phase switch of one sequential
grid. Neither carries to Hopper: lane packing is an MXU artefact, and blocks
cannot hand a sum over tokens on without a grid-wide barrier. So the forward
is the encode kernel with statistics followed by the decode kernel over fp32
Z in device memory (the same two C entry points and ``__global__`` kernels
the encode and decode wrappers launch, with Z fp32 and the statistics
written); Z is 512 KB per batch element at M=2048, D=8 and is read from L2.
The backward is one C entry point of three passes (``csrc/flare_bwd.cu``,
whose head comment has the design). The decode's log-sum-exp is the one
residual the TPU kernel does without: it recomputes the decode weights from
all M scores of a token tile in VMEM, which a thread per latent cannot see.
Each wrapper counts its own launches. The raw wrappers are forward-only: a
call that autograd would record raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flare import (
    DTYPE_CODES,
    check_kernel_operands,
    check_operands,
    check_tiles,
    decode_into,
    encode_into,
    encode_splits,
    forbid_grad,
    heads_out,
    on_cuda,
    ptr,
)
from repro_torch.kernels.ref import flare_fused_bwd_ref, flare_fused_fwd_ref


def flare_fused_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_m: Optional[int] = None, block_n: Optional[int] = None):
    """q [H, M, D], k/v [B, H, N, D] (any strides) -> (y [B, H, N, D] in v's
    dtype, Z [B, H, M, D], max [B, H, M], den [B, H, M], lse [B, H, N]; the
    residuals fp32). ``block_m``: both kernels' rows a block; ``block_n``:
    the encode's tokens a split (``kernels/flare.py``; None: the default)."""
    forbid_grad("flare_fused_fwd", q, k, v)
    check_operands("flare_fused_fwd", q, k, v)
    check_tiles("flare_fused_fwd", k.shape[3], k.shape[2], block_m, block_n)
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
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    encode_into(q, k, v, z, mx, den, block_m=block_m, block_n=block_n)
    decode_into(q, k, z, y, lse, block_m=block_m)
    flare_fused_fwd.launches += 1
    return y, z, mx, den, lse


flare_fused_fwd.launches = 0


def _check_residuals(name, q, k, z, mx, den, lse) -> None:
    b, h, n, d = k.shape
    m = q.shape[1]
    want = {"z": (b, h, m, d), "mx": (b, h, m), "den": (b, h, m), "lse": (b, h, n)}
    for key, t in zip(want, (z, mx, den, lse)):
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} must be {list(want[key])}, got {tuple(t.shape)}")


def bwd_strides(*ts: torch.Tensor):
    """The (b, h, n) strides of k, v, y, dy, dk and dv, in that order, as the
    backward's C entry points take them (any of the six may be None)."""
    return (ctypes.c_longlong * 18)(*(s for t in ts for s in (t.stride()[:3] if t is not None
                                                              else (0, 0, 0))))


def flare_fused_bwd(q, k, v, z, mx, den, lse, y, dy, *, block_n: Optional[int] = None):
    """The backward of :func:`flare_fused_fwd` from its residuals: q [H, M, D];
    k, v, y, dy [B, H, N, D] (any strides); z, mx, den, lse as the forward
    returns them -> (dq [H, M, D] summed over the batch, dk, dv [B, H, N, D])
    in the operands' dtype. ``block_n``: the tokens a split of passes (a)
    and (c), the forward's (None: the default); their row tiles are fixed."""
    forbid_grad("flare_fused_bwd", q, k, v, y, dy)
    check_operands("flare_fused_bwd", q, k, v, y, dy)
    _check_residuals("flare_fused_bwd", q, k, z, mx, den, lse)
    check_tiles("flare_fused_bwd", k.shape[3], k.shape[2], block_n=block_n)
    if not on_cuda("flare_fused_bwd", q, k, v, z, mx, den, lse, y, dy):
        return flare_fused_bwd_ref(q, k, v, z, mx, den, lse, y, dy)
    check_kernel_operands("flare_fused_bwd", q, k, v, y, dy)
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (z, mx, den, lse)):
        raise ValueError("flare_fused_bwd: the residuals must be contiguous float32")
    b, h, n, d = k.shape
    m = q.shape[1]
    dev = k.device
    splits = encode_splits(k, m, block_n)
    dq = torch.empty((h, m, d), dtype=q.dtype, device=dev)
    dk = heads_out(b, h, n, d, k.dtype, dev)
    dv = heads_out(b, h, n, d, v.dtype, dev)
    dz = torch.empty((b, h, m, d), dtype=torch.float32, device=dev)
    part = torch.empty(splits * b * h * m * d, dtype=torch.float32, device=dev)
    err = _build.lib().flare_fused_bwd(
        ptr(q), ptr(k), ptr(v), ptr(z), ptr(mx), ptr(den), ptr(lse), ptr(y), ptr(dy),
        ptr(dq), ptr(dk), ptr(dv), ptr(dz), ptr(part), b, h, m, n, d,
        bwd_strides(k, v, y, dy, dk, dv), splits, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flare_fused_bwd")
    flare_fused_bwd.launches += 1
    return dq, dk, dv


flare_fused_bwd.launches = 0


class FlareFused(torch.autograd.Function):
    """y = FLARE(q, k, v) with the fused kernels both ways: q [H, M, D],
    k/v [B, H, N, D] -> y [B, H, N, D]. Saves q, k, v, y and the forward's
    O(M*D + N) residuals; no [M, N] matrix is kept for the backward.
    ``apply(q, k, v, block_m=None, block_n=None)``: the forward's launch
    parameters; its ``block_n`` is the backward's split too."""

    @staticmethod
    def forward(ctx, q, k, v, block_m=None, block_n=None):
        y, z, mx, den, lse = flare_fused_fwd(q, k, v, block_m=block_m, block_n=block_n)
        ctx.save_for_backward(q, k, v, z, mx, den, lse, y)
        ctx.block_n = block_n
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        q, k, v, z, mx, den, lse, y = ctx.saved_tensors
        if dy.stride(3) != 1:
            dy = dy.contiguous()
        return (*flare_fused_bwd(q, k, v, z, mx, den, lse, y, dy, block_n=ctx.block_n),
                None, None)
