"""The FLARE PDE surrogate (the paper's model).

Counterpart of ``repro/models/pde.py`` for ``mixer="flare"``; the Table-1
baselines are not ported yet. Input and output projections are those the
paper holds fixed across mixers (App. D.3):

    in:  ResMLP(L=2, C_in -> C)          out: LN + ResMLP(L=2, C -> C_out)
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.flare import flare_block, init_flare_block
from repro_torch.nn.modules import LayerNorm, ResMLP, init_resmlp, layernorm, resmlp


class Surrogate(nn.Module):
    def __init__(self, in_proj: ResMLP, blocks: list, out_norm: LayerNorm, out_proj: ResMLP):
        super().__init__()
        self.in_proj = in_proj
        self.blocks = nn.ModuleList(blocks)
        self.out_norm = out_norm
        self.out_proj = out_proj

    def forward(self, x: torch.Tensor, *, policy=None) -> torch.Tensor:
        return surrogate_forward(self, x, policy=policy)


def init_surrogate(*, in_dim: int, out_dim: int, dim: int, num_blocks: int, num_heads: int,
                   num_latents: int, generator: torch.Generator, device=None,
                   dtype=torch.float32) -> Surrogate:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return Surrogate(
        init_resmlp(in_dim, dim, dim, 2, **kw),
        [init_flare_block(dim, num_heads, num_latents, **kw) for _ in range(num_blocks)],
        LayerNorm(dim, device=device, dtype=dtype),
        init_resmlp(dim, dim, out_dim, 2, **kw),
    )


def surrogate_forward(model: Surrogate, x: torch.Tensor, *, policy=None) -> torch.Tensor:
    """x: [B, N, F_in] point features -> [B, N, F_out]. ``policy`` is a
    MixerPolicy, the MixerPlan resolved at model build, or None (ambient)."""
    h = resmlp(model.in_proj, x)
    for block in model.blocks:
        h = flare_block(block, h, policy=policy)
    return resmlp(model.out_proj, layernorm(model.out_norm, h))


def relative_l2(pred: torch.Tensor, target: torch.Tensor, *, group=None) -> torch.Tensor:
    """Paper Eq. 21/22, averaged over the batch. ``group``: the ranks that
    hold the other tokens of each example (``pred`` and ``target`` are this
    rank's slice). The norms need the squares summed over every token before
    the square root, so the other ranks' sums come in by a collective; they
    come in detached, so that each rank's loss carries the gradient of its
    own tokens only and the ranks' gradients sum to the global one (a
    differentiable sum would give each rank the whole gradient)."""
    sq = (pred - target).square().sum(dim=(-2, -1))
    ysq = target.square().sum(dim=(-2, -1))
    if group is not None:
        from repro_torch.distributed.compat import all_reduce_sum_

        both = all_reduce_sum_(torch.stack([sq.detach(), ysq.detach()]), group)
        sq = sq + (both[0] - sq.detach())
        ysq = both[1]
    return (sq.sqrt() / ysq.sqrt().clamp_min(1e-12)).mean()
