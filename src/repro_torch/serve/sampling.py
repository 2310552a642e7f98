"""On-device token sampling for the fused decode step.

Counterpart of ``repro/serve/sampling.py``. The samplers run on the logits'
device, so the only thing a decode step copies to the host is the int32
token ids. Contract: ``fn(logits [S, V], generator) -> int32 [S]``, the
generator a ``torch.Generator`` on the logits' device (the engine's, seeded
once); greedy ignores it (``needs_generator=False``):

  - greedy:       argmax over the vocab (temperature <= 0);
  - temperature:  a categorical draw from ``logits / T`` by the Gumbel-max
                  trick, argmax(logits / T + Gumbel noise), as
                  ``jax.random.categorical`` draws it; the noise comes from
                  the generator, so the bits differ from ``jax.random``'s
                  but a seed gives the same tokens twice;
  - topk:         logits below the k-th largest masked to -inf, then the
                  temperature sampler.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def _categorical(logits: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def make_sampler(temperature: float, sample: str = "greedy",
                 top_k: int = 0) -> Tuple[Callable, bool]:
    """The device sampler for the engine's (sample, temperature, top_k)
    knobs. Returns ``(fn, needs_generator)``."""
    if sample not in ("greedy", "topk"):
        raise ValueError(f"unknown sample mode {sample!r}")
    if sample == "topk":
        if top_k < 1:
            raise ValueError("sample='topk' needs top_k >= 1")
        t = temperature if temperature > 0 else 1.0

        def _topk(logits, gen):
            kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
            return _categorical(logits.masked_fill(logits < kth, -torch.inf) / t, gen)

        return _topk, True
    if temperature > 0:
        return (lambda logits, gen: _categorical(logits / temperature, gen)), True
    return (lambda logits, gen: torch.argmax(logits, dim=-1).to(torch.int32)), False
