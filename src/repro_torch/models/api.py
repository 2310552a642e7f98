"""Model API of the port: ``get_model(cfg)`` -> init / forward / loss / plans.

Counterpart of ``repro/models/api.py`` for the PDE family:

    m = get_model(cfg, device="cuda")   # plans resolved here, once, for the device
    net = m.init(seed)                  # a Surrogate module on that device
    pred = m.forward(net, batch)        # inference under m.plans["infer"]
    loss = m.loss(net, batch)           # differentiable, under m.plans["train"]

The train plan is always resolved with ``requires_grad=True``, so training
never lands on a forward-only kernel. On the card both plans resolve to
``packed``: the fused forward kernel, and under ``loss`` its fused backward
kernel through autograd. On the CPU both resolve to the plain ``sdpa``. A
policy that can only serve inference (``pallas``) still builds, and
``loss`` raises its resolve error.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.config import ModelConfig

# nominal token count for plan resolution when no hint is given (plan
# validity never depends on it)
DEFAULT_TOKENS_HINT = 4096


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss: Callable[..., torch.Tensor]
    # resolved mixer plans: {"infer": ...[, "train": ...]}
    plans: Mapping[str, Any] = field(default_factory=dict)


def _resolve_plans(cfg: ModelConfig, policy, device: torch.device,
                   seq_len_hint: Optional[int]):
    from repro_torch.core.dispatch import MixerShape
    from repro_torch.core.policy import resolve_policy

    shape = MixerShape(batch=1, heads=cfg.flare_heads, tokens=seq_len_hint or DEFAULT_TOKENS_HINT,
                       latents=cfg.flare_latents, head_dim=cfg.d_model // cfg.flare_heads)
    kind = device.type
    plans = {"infer": resolve_policy(policy, shape, torch.float32, device=kind)}
    try:
        plans["train"] = resolve_policy(policy, shape, torch.float32, device=kind,
                                        requires_grad=True)
        train_error = None
    except ValueError as e:
        train_error = e
    return plans, train_error


def get_model(cfg: ModelConfig, *, policy=None, device=None,
              seq_len_hint: Optional[int] = None) -> Model:
    """``policy``: a MixerPolicy, a MixerPlan, or None (the ambient policy),
    resolved here once for ``device`` (default ``"cuda"``)."""
    if cfg.family != "pde":
        raise ValueError(f"family {cfg.family!r} is not ported; the port has 'pde'")
    from repro_torch.models import pde

    dev = torch.device("cuda" if device is None else device)
    plans, train_error = _resolve_plans(cfg, policy, dev, seq_len_hint)

    def init(seed: int) -> pde.Surrogate:
        gen = torch.Generator().manual_seed(seed)
        return pde.init_surrogate(in_dim=3, out_dim=1, dim=cfg.d_model,
                                  num_blocks=cfg.num_layers, num_heads=cfg.flare_heads,
                                  num_latents=cfg.flare_latents, generator=gen, device=dev)

    def forward(net: pde.Surrogate, batch) -> torch.Tensor:
        with torch.no_grad():
            return pde.surrogate_forward(net, batch["x"], policy=plans["infer"])

    def loss(net: pde.Surrogate, batch) -> torch.Tensor:
        if train_error is not None:
            raise ValueError("this model was built with an inference-only mixer policy "
                             f"and cannot train: {train_error}")
        pred = pde.surrogate_forward(net, batch["x"], policy=plans["train"])
        return pde.relative_l2(pred, batch["y"])

    return Model(cfg=cfg, init=init, forward=forward, loss=loss, plans=plans)
