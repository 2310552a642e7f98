"""The sharded FLARE mixer: the fused kernels split at the one point where
ranks holding different tokens must exchange what they know.

Counterpart of ``repro/kernels/flare_packed_shard.py``. Each rank holds a
slice of every example's tokens. A rank's encode is only part of the sum
over N, so the fused forward splits where it needs the global Z, and pays
with collectives of O(B*H*M*D), never O(N):

  forward   flare_enc_stats      -> (num, mx, den)   this rank's flash statistics
            combine_stats         gmax = MAX(mx), s = exp(mx - gmax),
                                  Z = SUM(num s) / SUM(den s)
            flare_shard_decode   -> y, lse            this rank's tokens vs the global Z
  backward  flare_shard_dz       -> dZ_rank           decode-weight sweep
            dZ = SUM(dZ_rank)                          latent grads are global
            flare_shard_grads    -> dq_rank, dk, dv   from the global mx, den, Z, dZ

The four wrappers replace the TPU kernels ``_enc_stats_kernel``,
``_decode_kernel``, ``_dz_kernel`` and ``_grads_kernel``. They launch the
port's own ``__global__`` kernels of ``csrc/flare.cu`` and
``csrc/flare_bwd.cu`` through the C entry points ``flare_enc_stats``,
``flare_decode``, ``flare_bwd_dz`` and ``flare_bwd_grads``, as the TPU bodies
reuse ``flare_packed``'s in-kernel helpers; ``flare_fused_bwd`` runs the
last two in the same order. So on a group of one every step is the fused
kernels' own arithmetic (the merge scales by exp(0) = 1 and Z is formed as
num * (1 / den), as the encode does), and the result is bit-identical to
``FlareFused``'s.

:class:`FlareFusedShard` is the counterpart of ``_shard_core`` and its
custom VJP. ``dq`` comes back summed over the local batch only: the
latent queries are replicated, and the trainer's all-reduce of the
gradients adds the ranks' parts, once (the JAX package leaves that sum to
``shard_map``'s transpose of the replicated input).

Each wrapper takes CPU tensors to its plain version (``kernels/ref.py``),
and on CUDA tensors launches its kernel or raises; each counts its launches
in ``<wrapper>.launches``. The raw wrappers are forward-only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from repro_torch.distributed.compat import all_max, all_reduce_sum_, axes_tuple, axis_group
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
from repro_torch.kernels.flare_packed import bwd_strides
from repro_torch.kernels.ref import (
    flare_bwd_dz_ref,
    flare_bwd_grads_ref,
    flare_decode_stats_ref,
    flare_enc_stats_ref,
)

__all__ = ["FlareFusedShard", "combine_stats", "flare_enc_stats", "flare_mixer_packed_shard",
           "flare_shard_decode", "flare_shard_dz", "flare_shard_grads"]


def _stats_shapes(name, q, k, **ts) -> None:
    b, h, n, d = k.shape
    m = q.shape[1]
    want = {"z": (b, h, m, d), "dz": (b, h, m, d), "mx": (b, h, m), "den": (b, h, m),
            "lse": (b, h, n)}
    for key, t in ts.items():
        if tuple(t.shape) != want[key]:
            raise ValueError(f"{name}: {key} must be {list(want[key])}, got {tuple(t.shape)}")


def _fp32(name, *ts) -> None:
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: the statistics must be contiguous float32")


def flare_enc_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    block_m: Optional[int] = None, block_n: Optional[int] = None):
    """This rank's encode statistics: q [H, M, D], k/v [B, H, N, D] (any
    strides) -> (num [B, H, M, D], mx [B, H, M], den [B, H, M], fp32), num
    the numerator sum_n exp(s - mx) v_n before the normalisation.
    ``block_m``, ``block_n``: the encode's (``kernels/flare.py``)."""
    forbid_grad("flare_enc_stats", q, k, v)
    check_operands("flare_enc_stats", q, k, v)
    check_tiles("flare_enc_stats", k.shape[3], k.shape[2], block_m, block_n)
    if not on_cuda("flare_enc_stats", q, k, v):
        return flare_enc_stats_ref(q, k, v)
    check_kernel_operands("flare_enc_stats", q, k, v)
    b, h, _, d = k.shape
    m = q.shape[1]
    num = torch.empty((b, h, m, d), dtype=torch.float32, device=k.device)
    mx = torch.empty((b, h, m), dtype=torch.float32, device=k.device)
    den = torch.empty((b, h, m), dtype=torch.float32, device=k.device)
    encode_into(q, k, v, num, mx, den, raw=True, block_m=block_m, block_n=block_n)
    flare_enc_stats.launches += 1
    return num, mx, den


flare_enc_stats.launches = 0


def flare_shard_decode(q: torch.Tensor, k: torch.Tensor, z: torch.Tensor, *,
                       block_m: Optional[int] = None):
    """This rank's tokens against the merged z (fp32 [B, H, M, D]):
    -> (y [B, H, N, D] in k's dtype, lse [B, H, N] fp32, each token's
    log-sum-exp over the latents: a per-token statistic, no collective)."""
    forbid_grad("flare_shard_decode", q, k, z)
    check_operands("flare_shard_decode", q, k)
    _stats_shapes("flare_shard_decode", q, k, z=z)
    check_tiles("flare_shard_decode", k.shape[3], k.shape[2], block_m)
    if not on_cuda("flare_shard_decode", q, k, z):
        return flare_decode_stats_ref(q, k, z)
    check_kernel_operands("flare_shard_decode", q, k)
    _fp32("flare_shard_decode", z)
    b, h, n, d = k.shape
    y = heads_out(b, h, n, d, k.dtype, k.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=k.device)
    decode_into(q, k, z, y, lse, block_m=block_m)
    flare_shard_decode.launches += 1
    return y, lse


flare_shard_decode.launches = 0


def flare_shard_dz(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor,
                   dy: torch.Tensor, *, block_n: Optional[int] = None) -> torch.Tensor:
    """This rank's part of dZ = W dy over its tokens (the backward's pass a):
    q [H, M, D]; k, dy [B, H, N, D] (any strides); lse [B, H, N] fp32
    -> [B, H, M, D] fp32. The ranks' parts sum to dZ. ``block_n``: the
    tokens a split, as the forward's encode."""
    forbid_grad("flare_shard_dz", q, k, dy)
    check_operands("flare_shard_dz", q, k, dy)
    _stats_shapes("flare_shard_dz", q, k, lse=lse)
    check_tiles("flare_shard_dz", k.shape[3], k.shape[2], block_n=block_n)
    if not on_cuda("flare_shard_dz", q, k, lse, dy):
        return flare_bwd_dz_ref(q, k, lse, dy)
    check_kernel_operands("flare_shard_dz", q, k, dy)
    _fp32("flare_shard_dz", lse)
    b, h, n, d = k.shape
    m = q.shape[1]
    splits = encode_splits(k, m, block_n)
    dz = torch.empty((b, h, m, d), dtype=torch.float32, device=k.device)
    part = torch.empty(splits * b * h * m * d if splits > 1 else 1, dtype=torch.float32,
                       device=k.device)
    err = _build.lib().flare_bwd_dz(
        ptr(q), ptr(k), ptr(dy), ptr(lse), ptr(dz), ptr(part), b, h, m, n, d,
        bwd_strides(k, None, None, dy, None, None), splits, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(k.device).cuda_stream)
    _build.check(err, "flare_bwd_dz")
    flare_shard_dz.launches += 1
    return dz


flare_shard_dz.launches = 0


def flare_shard_grads(q, k, v, z, mx, den, lse, y, dy, dz, *, block_n: Optional[int] = None):
    """The backward's passes b and c on this rank's tokens, from the merged
    z, mx, den, the summed dz (all fp32) and this rank's lse: q [H, M, D];
    k, v, y, dy [B, H, N, D] (any strides) -> (dq [H, M, D] summed over the
    batch, dk, dv [B, H, N, D]) in the operands' dtype. ``block_n``: pass
    (c)'s tokens a split, as the forward's encode."""
    forbid_grad("flare_shard_grads", q, k, v, y, dy)
    check_operands("flare_shard_grads", q, k, v, y, dy)
    _stats_shapes("flare_shard_grads", q, k, z=z, mx=mx, den=den, lse=lse, dz=dz)
    check_tiles("flare_shard_grads", k.shape[3], k.shape[2], block_n=block_n)
    if not on_cuda("flare_shard_grads", q, k, v, z, mx, den, lse, y, dy, dz):
        return flare_bwd_grads_ref(q, k, v, z, mx, den, lse, y, dy, dz)
    check_kernel_operands("flare_shard_grads", q, k, v, y, dy)
    _fp32("flare_shard_grads", z, mx, den, lse, dz)
    b, h, n, d = k.shape
    m = q.shape[1]
    dev = k.device
    splits = encode_splits(k, m, block_n)
    dq = torch.empty((h, m, d), dtype=q.dtype, device=dev)
    dk = heads_out(b, h, n, d, k.dtype, dev)
    dv = heads_out(b, h, n, d, v.dtype, dev)
    part = torch.empty(splits * b * h * m * d, dtype=torch.float32, device=dev)
    err = _build.lib().flare_bwd_grads(
        ptr(q), ptr(k), ptr(v), ptr(z), ptr(mx), ptr(den), ptr(lse), ptr(y), ptr(dy), ptr(dz),
        ptr(dq), ptr(dk), ptr(dv), ptr(part), b, h, m, n, d,
        bwd_strides(k, v, y, dy, dk, dv), splits, DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "flare_bwd_grads")
    flare_shard_grads.launches += 1
    return dq, dk, dv


flare_shard_grads.launches = 0


def combine_stats(num: torch.Tensor, mx: torch.Tensor, den: torch.Tensor, group):
    """Merge the ranks' encode statistics into the global (Z, max, den):
    one MAX of mx, then one SUM of num and den rescaled to the global max,
    in one buffer. ``group=None`` is a group of one."""
    gmax = all_max(mx, group)
    scale = torch.exp(mx - gmax)
    buf = torch.cat([(num * scale[..., None]).reshape(-1), (den * scale).reshape(-1)])
    all_reduce_sum_(buf, group)
    num_g, den_g = buf[:num.numel()].view_as(num), buf[num.numel():].view_as(den)
    # num * (1 / den), as the encode kernel normalises: bit-identical on one rank
    return num_g * den_g.reciprocal()[..., None], gmax, den_g


class FlareFusedShard(torch.autograd.Function):
    """y = FLARE(q, k, v) over tokens split across ``group``: q [H, M, D]
    replicated, k/v [B, H, N_rank, D] this rank's tokens -> y
    [B, H, N_rank, D]. Saves the merged O(M*D) statistics and this rank's
    O(N_rank) log-sum-exp; the backward sums dZ over the group before the
    gradients pass. dq is this rank's part. ``apply(q, k, v, group,
    block_m=None, block_n=None)``: the launch parameters of the per-shard
    kernels; the forward's ``block_n`` is the backward's split too."""

    @staticmethod
    def forward(ctx, q, k, v, group, block_m=None, block_n=None):
        num, mx, den = flare_enc_stats(q, k, v, block_m=block_m, block_n=block_n)
        z, gmax, gden = combine_stats(num, mx, den, group)
        y, lse = flare_shard_decode(q, k, z, block_m=block_m)
        ctx.group, ctx.block_n = group, block_n
        ctx.save_for_backward(q, k, v, z, gmax, gden, lse, y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        q, k, v, z, mx, den, lse, y = ctx.saved_tensors
        if dy.stride(3) != 1:
            dy = dy.contiguous()
        dz = all_reduce_sum_(flare_shard_dz(q, k, lse, dy, block_n=ctx.block_n), ctx.group)
        dq, dk, dv = flare_shard_grads(q, k, v, z, mx, den, lse, y, dy, dz,
                                       block_n=ctx.block_n)
        return dq, dk, dv, None, None, None


Axes = Union[str, Sequence[str], None]


def flare_mixer_packed_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                             seq_axes: Axes = ("data",), lat_axes: Axes = ("model",),
                             block_m: Optional[int] = None, block_n: Optional[int] = None):
    """The mesh-parallel FLARE mixer on this rank's LOCAL shards: q
    [H_rank, M, D], k/v [B, H_rank, N_rank, D] -> y [B, H_rank, N_rank, D],
    differentiable through :class:`FlareFusedShard`.

    Tokens are split over ``seq_axes``, whole heads over ``lat_axes`` (heads
    are independent, so that axis needs no collective). The JAX function
    takes global arrays and ``shard_map``s them; torch runs one process per
    rank, so each rank passes its own slices, and the caller splits (the
    trainer's :func:`repro_torch.distributed.sharding.shard_tokens`) and gathers.
    ``block_m``, ``block_n``: the per-shard kernels' launch parameters."""
    seq, lat = axes_tuple(seq_axes), axes_tuple(lat_axes)
    for a in seq + lat:
        if a not in mesh.mesh_dim_names:
            raise ValueError(f"axis {a!r} not in mesh axes {mesh.mesh_dim_names}")
    if set(seq) & set(lat):
        raise ValueError(f"seq_axes {seq} and lat_axes {lat} must be disjoint")
    return FlareFusedShard.apply(q, k, v, axis_group(mesh, seq), block_m, block_n)
