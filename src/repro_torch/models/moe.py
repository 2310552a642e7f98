"""Mixture-of-Experts FFN: top-k routing with GShard-style dense dispatch.

Counterpart of ``repro/models/moe.py``, op for op. Tokens are cut into
groups of ``GROUP_SIZE`` (one group when their count is not a multiple of
it); each group builds a ``[group, experts, capacity]`` one-hot dispatch
tensor, and the experts' SwiGLU products run as batched einsums over the
stacked expert weights ``[E, C, F]`` / ``[E, F, C]`` (parameters in the JAX
layout, not ``nn.Linear``s). An assignment past its expert's capacity is
dropped and falls through the residual (Switch); the priority is a
cumulative sum over the flattened ``[group * k]`` axis, earlier tokens and
higher-ranked slots first. So a token's output depends on the other tokens
of its group: at decode the group is the engine's slots, and in prefill the
bucket's right-padding takes capacity too. The Switch load-balancing loss
is returned beside the output; shared experts are a SwiGLU over every token.

Routing (``_router_probs``): ``norm_topk_prob`` takes the softmax over all
experts, then the top k, renormalised (DeepSeek / Qwen); otherwise the top
k of the logits and a softmax over them (Mixtral). The router runs in the
compute dtype, so in bf16 its logits tie often; ``jax.lax.top_k`` puts the
lower index first on ties and so does :func:`top_k` (a stable descending
sort), where ``torch.topk`` promises no order. Every call casts the stacked
expert weights to the compute dtype, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import MoEConfig
from repro_torch.nn.modules import SwiGLU, _param, dense, init_dense, init_swiglu, swiglu

# tokens a dispatch group
GROUP_SIZE = 1024


class MoE(nn.Module):
    """Parameters ``router`` (a dense layer to E logits), the stacked
    experts ``w_gate`` / ``w_up`` [E, C, F] and ``w_down`` [E, F, C], and
    the optional ``shared`` SwiGLU, as the JAX tree's ``mlp``."""

    def __init__(self, router: nn.Linear, w_gate: nn.Parameter, w_up: nn.Parameter,
                 w_down: nn.Parameter, shared: Optional[SwiGLU]):
        super().__init__()
        self.router = router
        self.w_gate, self.w_up, self.w_down = w_gate, w_up, w_down
        if shared is not None:
            self.shared = shared


def init_moe(cfg: MoEConfig, d_model: int, *, generator: torch.Generator, device=None,
             dtype=torch.float32) -> MoE:
    """Truncated normals: the experts' in-projections at stddev
    1/sqrt(d_model), their out-projection at 1/sqrt(F)."""
    e, f = cfg.num_experts, cfg.expert_ffn
    router = init_dense(d_model, e, generator=generator, device=device, dtype=dtype)
    std = 1.0 / math.sqrt(d_model)
    w_gate = _param((e, d_model, f), std, generator, device, dtype)
    w_up = _param((e, d_model, f), std, generator, device, dtype)
    w_down = _param((e, f, d_model), 1.0 / math.sqrt(f), generator, device, dtype)
    shared = None
    if cfg.num_shared:
        sf = cfg.shared_ffn or cfg.expert_ffn * cfg.num_shared
        shared = init_swiglu(d_model, sf, generator=generator, device=device, dtype=dtype)
    return MoE(router, w_gate, w_up, w_down, shared)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, in descending
    order, the lower index first among equals (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _router_probs(logits: torch.Tensor, cfg: MoEConfig):
    """(combine weights over the top k, expert indices), both [..., k]."""
    if cfg.norm_topk_prob:
        gate, idx = top_k(torch.softmax(logits.float(), dim=-1), cfg.top_k)
        gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        val, idx = top_k(logits.float(), cfg.top_k)
        gate = torch.softmax(val, dim=-1)
    return gate * cfg.routed_scale, idx


def moe_ffn(moe: MoE, x: torch.Tensor, cfg: MoEConfig, *, group_size: int = GROUP_SIZE):
    """x [B, S, C] -> (y [B, S, C], the aux loss fp32 []): the routed experts
    plus the shared ones."""
    b, s, c = x.shape
    t = b * s
    gs = min(group_size, t)
    if t % gs:
        gs = t   # small inputs: a single group
    g = t // gs
    xg = x.reshape(g, gs, c)
    logits = dense(moe.router, xg)                             # [G, gs, E]
    gate, idx = _router_probs(logits, cfg)                     # [G, gs, k]
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(gs * cfg.capacity_factor * k / e))
    # each assignment's position in its expert's queue: earlier tokens and
    # higher-ranked slots first
    flat = F.one_hot(idx, e).reshape(g, gs * k, e)             # int64
    pos = ((flat.cumsum(dim=1) - flat) * flat).sum(-1).reshape(g, gs, k)
    pos = torch.where(pos < cap, pos, torch.full_like(pos, cap))   # dropped -> the cut column
    pos_oh = F.one_hot(pos, cap + 1)[..., :cap].to(x.dtype)    # [G, gs, k, cap]
    exp_oh = F.one_hot(idx, e).to(x.dtype)                     # [G, gs, k, E]
    dispatch = torch.einsum("gske,gskp->gsep", exp_oh, pos_oh)
    combine = torch.einsum("gsk,gske,gskp->gsep", gate.to(x.dtype), exp_oh, pos_oh)
    xin = torch.einsum("gsep,gsc->gepc", dispatch, xg)         # [G, E, cap, C]
    wg, wu, wd = (w.to(x.dtype) for w in (moe.w_gate, moe.w_up, moe.w_down))
    h = F.silu(torch.einsum("gepc,ecf->gepf", xin, wg)) * torch.einsum("gepc,ecf->gepf", xin, wu)
    xout = torch.einsum("gepf,efc->gepc", h, wd)
    y = torch.einsum("gsep,gepc->gsc", combine, xout).reshape(b, s, c)
    # Switch load balance: E * sum_e (top-1 share of e) * (mean router prob of e)
    frac_tokens = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    frac_probs = torch.softmax(logits.float(), dim=-1).mean(dim=(0, 1))
    aux = e * (frac_tokens * frac_probs).sum()
    if hasattr(moe, "shared"):
        y = y + swiglu(moe.shared, x)
    return y, aux
