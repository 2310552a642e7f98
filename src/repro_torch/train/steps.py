"""Train and eval steps: microbatched gradient accumulation + AdamW.

Counterpart of ``repro/train/steps.py``. The microbatch loop is a Python
loop that runs backward per microbatch, so only one microbatch of
activations is alive at a time (the counterpart of the JAX ``lax.scan``).
Gradients accumulate in each parameter's ``.grad`` and are averaged before
the update, as the JAX step sums and then scales; a parameter that no path
reads gets a zero gradient, as ``jax.grad`` gives it. Under sequence
parallelism (``grad_group``) each rank's gradients are its tokens' part,
and they are summed over the group, in one flat buffer, before the update,
so that the clip sees the global norm.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.config import TrainConfig
from repro_torch.distributed.compat import all_reduce_sum_
from repro_torch.optim.adamw import AdamWState, adamw_update
from repro_torch.optim.schedule import onecycle_schedule


def sum_grads_(grads: list, group) -> None:
    """Sum the gradient tensors over ``group`` in place, through one flat
    buffer (one collective a step)."""
    flat = all_reduce_sum_(torch.cat([g.reshape(-1) for g in grads]), group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def make_train_step(loss_fn: Callable, tcfg: TrainConfig, *, num_microbatches: int = 1,
                    grad_group=None):
    """loss_fn(net, microbatch) -> scalar. Returns
    train_step(net, opt_state, batch) -> (net, opt_state, metrics), with the
    metrics ``loss`` and ``grad_norm`` as device scalars and ``lr`` a float.
    The net's parameters and the state are updated in place. ``grad_group``:
    the ranks whose gradients are summed before the update."""

    def train_step(net: torch.nn.Module, opt_state: AdamWState, batch):
        params = dict(net.named_parameters())
        for p in params.values():
            p.grad = None
        size = len(next(iter(batch.values())))
        if size % num_microbatches:
            raise ValueError(f"global batch {size} does not split into "
                             f"{num_microbatches} microbatches")
        s = size // num_microbatches
        mbs = [{k: v[i * s:(i + 1) * s] for k, v in batch.items()}
               for i in range(num_microbatches)]
        loss = 0.0
        for mb in mbs:
            mb_loss = loss_fn(net, mb)
            mb_loss.backward()
            loss = loss + mb_loss.detach()
        for p in params.values():
            if p.grad is None:   # no path reads it (the Perceiver's enc/dec ln2 and mlp):
                p.grad = torch.zeros_like(p)   # JAX's gradient there, so weight decay still applies
        if num_microbatches > 1:
            inv = 1.0 / num_microbatches
            for p in params.values():
                p.grad.mul_(inv)
            loss = loss * inv
        lr = onecycle_schedule(opt_state.step, total_steps=tcfg.steps,
                               peak_lr=tcfg.learning_rate, warmup_frac=tcfg.warmup_frac)
        grads = {k: p.grad for k, p in params.items()}
        if grad_group is not None:
            sum_grads_(list(grads.values()), grad_group)
        _, opt_state, gnorm = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=tcfg.weight_decay,
            beta1=tcfg.beta1, beta2=tcfg.beta2, eps=tcfg.eps, grad_clip=tcfg.grad_clip)
        for p in params.values():
            p.grad = None
        return net, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_eval_step(loss_fn: Callable):
    def eval_step(net: torch.nn.Module, batch):
        with torch.no_grad():
            return loss_fn(net, batch)

    return eval_step
