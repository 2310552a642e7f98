"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of ``repro/optim/adamw.py`` over a dict of parameters (a
module's ``named_parameters``). Moments are fp32 whatever the parameter
dtype. Where the JAX update returns new arrays, this one updates the
parameters and moments in place (under ``torch.no_grad``), which keeps one
copy of each in device memory; it returns the same objects so a caller reads
it like the functional version. Each step of the update is one
``torch._foreach_*`` call over a group of tensors of at most ``GROUP``
elements, so the update costs a few dozen launches a group, not a dozen per
parameter, and its temporaries (four of the group's size) stay small beside
the state: at the LMs' 1.5-2.6 B parameters, temporaries of the whole model
would not fit one card beside its fp32 parameters, gradients and moments.
The gradient norm stays a device tensor: no host sync.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

GROUP = 1 << 28   # elements a group of the update: temporaries of 1 GiB each in fp32


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


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm ``norm`` to at most ``max_norm``."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before), as new tensors in the gradients' dtypes. :func:`adamw_update`
    applies the same factor group by group instead, so that no scaled copy
    of every gradient is held at once (the same fp32 values)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _groups(names: list, params: Dict[str, torch.Tensor]):
    """``names`` in order, cut into runs of at most GROUP elements (a larger
    tensor alone)."""
    group, size = [], 0
    for k in names:
        n = params[k].numel()
        if group and size + n > GROUP:
            yield group
            group, size = [], 0
        group.append(k)
        size += n
    if group:
        yield group


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                 state: AdamWState, *, lr: float, weight_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float = 0.0):
    """Returns (params, state, grad_norm); params and state updated in place."""
    norm = global_norm(grads)
    # global-norm clipping (clip_by_global_norm's factor, applied a group at a time)
    scale = _clip_scale(norm, grad_clip) if grad_clip else None
    state.step += 1
    bc1 = 1.0 - beta1 ** state.step
    bc2 = 1.0 - beta2 ** state.step
    for names in _groups(list(params), params):
        p32 = [params[k].float() for k in names]
        g32 = [grads[k].float() for k in names]
        if scale is not None:
            g32 = torch._foreach_mul(g32, scale)
        m = [state.m[k] for k in names]
        v = [state.v[k] for k in names]
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g32, alpha=1.0 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g32, g32, value=1.0 - beta2)
        del g32
        denom = torch._foreach_sqrt(torch._foreach_div(v, bc2))
        torch._foreach_add_(denom, eps)
        delta = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        del denom
        if weight_decay:
            torch._foreach_add_(delta, p32, alpha=weight_decay)
        torch._foreach_add_(p32, delta, alpha=-lr)
        for k, new in zip(names, p32):
            if new is not params[k]:
                params[k].copy_(new)
    return params, state, norm
