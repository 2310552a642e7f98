"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro/optim/adamw.py`` over a dict of parameters (a
module's ``named_parameters``). Moments are fp32 whatever the parameter
dtype. Where the JAX update returns new arrays, this one updates the
parameters and moments in place (under ``torch.no_grad``), which keeps one
copy of each in device memory; it returns the same objects so a caller reads
it like the functional version. Each step of the update is one
``torch._foreach_*`` call over all tensors, so the update costs a few dozen
launches, not a dozen per parameter. The gradient norm stays a device
tensor: no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class AdamWState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: int


def init_adamw(params: Dict[str, torch.Tensor]) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(m=zeros, v={k: t.clone() for k, t in zeros.items()}, step=0)


def global_norm(tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
    norms = torch._foreach_norm([g.float() for g in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled so their global norm is at most ``max_norm``, the norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return dict(zip(grads, torch._foreach_mul(list(grads.values()), scale))), norm


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                 state: AdamWState, *, lr: float, weight_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 0.0):
    """Returns (params, state, grad_norm); params and state updated in place."""
    if grad_clip:
        grads, norm = clip_by_global_norm(grads, grad_clip)
    else:
        norm = global_norm(grads)
    state.step += 1
    bc1 = 1.0 - beta1 ** state.step
    bc2 = 1.0 - beta2 ** state.step
    names = list(params)
    p32 = [params[k].float() for k in names]
    g32 = [grads[k].float() for k in names]
    m = [state.m[k] for k in names]
    v = [state.v[k] for k in names]
    torch._foreach_mul_(m, beta1)
    torch._foreach_add_(m, g32, alpha=1.0 - beta1)
    torch._foreach_mul_(v, beta2)
    torch._foreach_addcmul_(v, g32, g32, value=1.0 - beta2)
    denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
    torch._foreach_add_(denom, eps)
    delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
    if weight_decay:
        torch._foreach_add_(delta, p32, alpha=weight_decay)
    torch._foreach_add_(p32, delta, alpha=-lr)
    for k, new in zip(names, p32):
        if new is not params[k]:
            params[k].copy_(new)
    return params, state, norm
