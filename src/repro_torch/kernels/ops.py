"""Dispatch wrappers around the kernels (FLARE and flash attention).

Counterpart of ``repro/kernels/ops.py``. The kernels index the groups
G = B*H batch-major, with the latents kept at [H, M, D] and read as group
``g % H``, never broadcast. They take the [B, H, N, D] operands by their
strides, so the flattening costs no copy, and they handle
ragged N and M in the loops, so nothing is padded: the 128-lane padding of
the Pallas wrappers was for the TPU's matrix unit. The same holds for
:func:`flash_attention`, whose TPU wrapper also padded Sq and Skv to its
tiles and masked the padded keys (``kv_valid``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.attention import flash_attention as flash_kernel
from repro_torch.kernels.flare import flare_decode, flare_encode
from repro_torch.kernels.flare_causal import flare_causal_chunk
from repro_torch.kernels.flare_packed import flare_fused_bwd, flare_fused_fwd
from repro_torch.kernels.flare_packed_shard import (
    flare_enc_stats,
    flare_shard_decode,
    flare_shard_dz,
    flare_shard_grads,
)
from repro_torch.kernels.paged_attention import paged_attention

KERNELS = (flare_encode, flare_decode, flare_fused_fwd, flare_fused_bwd, flare_causal_chunk,
           paged_attention, flash_kernel, flare_enc_stats, flare_shard_decode, flare_shard_dz,
           flare_shard_grads)


def flare_mixer_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      block_m: Optional[int] = None,
                      block_n: Optional[int] = None) -> torch.Tensor:
    """The FLARE mixer through the encode and decode kernels (two launches).
    q [H, M, D], k/v [B, H, N, D] -> y [B, H, N, D]; ``block_m`` and
    ``block_n`` as the kernels take them (None: their defaults)."""
    q = q.to(k.dtype)
    return flare_decode(q, k, flare_encode(q, k, v, block_m=block_m, block_n=block_n),
                        block_m=block_m)


def flare_causal_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal FLARE (the flare_lm mixer) through the causal kernel:
    q [H, M, D], k/v [B, H, N, D] -> y [B, H, N, D]; the semantics of
    ``core.flare_stream.flare_causal``. The TPU wrapper's tile argument and
    its padding of N are not needed: the kernel's tile is its own, and
    ragged N is a loop bound."""
    return flare_causal_chunk(q.to(k.dtype), k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Flash attention on q [B, H, Sq, D], k/v [B, Hkv, Skv, D] (Hkv | H: GQA's
    KV heads unexpanded) -> [B, H, Sq, D] in v's dtype through a flash kernel
    (one launch, on the route ``kernels/attention.py::flash_route`` picks),
    the counterpart of ``repro/kernels/ops.py::flash_attention``, which takes
    K and V expanded to H heads. The strided split-head views go in as they
    are; ragged Sq and Skv are the kernels' loop bounds."""
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q must be [B, H, Sq, D], got {tuple(q.shape)}")
    return flash_kernel(q, k, v, scale=scale, causal=causal, window=window)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    flash_kernel.launches_by_route.update(dict.fromkeys(flash_kernel.launches_by_route, 0))
    paged_attention.launches_by_route.update(dict.fromkeys(paged_attention.launches_by_route, 0))


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def count_snapshot() -> dict:
    """Every launch counter: {(wrapper, route or None for its total): count}."""
    snap = {(fn, None): fn.launches for fn in KERNELS}
    for fn in (flash_kernel, paged_attention):
        snap.update({(fn, route): n for route, n in fn.launches_by_route.items()})
    return snap


def count_delta(before: dict, after: dict) -> dict:
    """The counters that moved between two :func:`count_snapshot` readings."""
    return {key: after[key] - before[key] for key in after if after[key] != before[key]}


def add_launches(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (a :func:`count_delta`) to the counters. A
    CUDA graph's replay runs no wrapper, so the engine adds the launches its
    capture recorded on each replay (and takes them back from the capture
    itself, which launches nothing)."""
    for (fn, route), n in delta.items():
        if route is None:
            fn.launches += n * times
        else:
            fn.launches_by_route[route] += n * times
