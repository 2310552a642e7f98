"""Reference backend: the paper's two SDPA calls (Fig. 3) in plain torch math.

It is the "auto" pick on the CPU, for inference and training, and the
tolerance reference of every other backend.
It does not call ``F.scaled_dot_product_attention``.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.core.flare import sdpa

    z = sdpa(q[None], k, v, scale=1.0)     # encode: latents gather tokens
    return sdpa(k, q[None], z, scale=1.0)  # decode: tokens scatter from latents


register(MixerBackend(
    name="sdpa",
    caps=Capabilities(device_kinds=("cpu", "cuda")),
    plan=lambda shape, mesh, dtype, device: MixerPlan("sdpa"),
    run=_run,
    score=lambda shape, device: 10.0,
    doc="two plain-torch SDPA calls (paper Fig. 3), the correctness reference",
))
