"""Sequence-parallel FLARE in plain torch: O(M*D) collectives per layer.

Counterpart of ``repro/core/flare_sp.py``. Under sequence parallelism
(tokens split over ranks) the encode softmax

    z_m = (sum_n e^{s_mn} v_n) / (sum_n e^{s_mn})

is a sum over the split axis. Each rank takes its partial (max, numerator,
denominator); one MAX of [M] and one SUM of [M, D] + [M] per head give the
exact global encode. The decode is pointwise over tokens: no communication.
The volume, H (M D + 2 M) words a layer, does not grow with N.

Each function runs on this rank's shards (torch is one process per rank)
and takes process groups where the JAX functions take axis names; the sums
go through the differentiable :func:`repro_torch.distributed.all_sum`, so
autograd gives each rank its part of every gradient, and the ranks' parts
of a replicated input's gradient add up to the whole.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.compat import all_max, all_sum


def flare_mixer_seqparallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            group) -> torch.Tensor:
    """Exact FLARE with the tokens split over ``group``: q [H, M, D]
    (replicated), k/v [B, H, N_rank, D] -> this rank's y [B, H, N_rank, D]."""
    s = torch.einsum("hmd,bhnd->bhmn", q.float(), k.float())   # local scores
    # the stabilizer is a constant shift that cancels in the softmax: no gradient
    gmax = all_max(s.amax(dim=-1), group)
    e = torch.exp(s - gmax[..., None])                          # [B, H, M, N_rank]
    num = all_sum(torch.einsum("bhmn,bhnd->bhmd", e, v.float()), group)
    den = all_sum(e.sum(dim=-1), group)
    z = num / den.clamp_min(1e-30)[..., None]
    w = torch.softmax(s, dim=-2)                                # over M, per local token
    return torch.einsum("bhmn,bhmd->bhnd", w, z).to(v.dtype)


def flare_mixer_seqlat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, seq_group,
                       lat_group) -> torch.Tensor:
    """Tokens split over ``seq_group``, latents over ``lat_group``: q
    [H, M_rank, D] this rank's latents, k/v [B, H, N_rank, D] -> y
    [B, H, N_rank, D], the same on every rank of ``lat_group``. The encode's
    statistics are summed over ``seq_group``, the decode's over
    ``lat_group`` (one activation-sized sum)."""
    s = torch.einsum("hmd,bhnd->bhmn", q.float(), k.float())   # [B, H, M_rank, N_rank]
    # encode: softmax over the split N axis, per local latent
    gmax = all_max(s.amax(dim=-1), seq_group)
    e = torch.exp(s - gmax[..., None])
    num = all_sum(torch.einsum("bhmn,bhnd->bhmd", e, v.float()), seq_group)
    den = all_sum(e.sum(dim=-1), seq_group)
    z = num / den.clamp_min(1e-30)[..., None]                   # [B, H, M_rank, D]
    # decode: softmax over the split M axis, per local token
    dmax = all_max(s.amax(dim=-2), lat_group)                  # [B, H, N_rank]
    ed = torch.exp(s - dmax[:, :, None])
    dnum = all_sum(torch.einsum("bhmn,bhmd->bhnd", ed, z), lat_group)
    dden = all_sum(ed.sum(dim=-2), lat_group)
    return (dnum / dden.clamp_min(1e-30)[..., None]).to(v.dtype)


def flare_encode_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """This rank's encode statistics (scores, max, num, den): the building
    block for other collective schedules."""
    s = torch.einsum("hmd,bhnd->bhmn", q.float(), k.float())
    m = s.amax(dim=-1)
    e = torch.exp(s - m[..., None])
    return s, m, torch.einsum("bhmn,bhnd->bhmd", e, v.float()), e.sum(dim=-1)
