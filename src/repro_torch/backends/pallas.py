"""Two-launch kernel backend: the CUDA encode and decode kernels
(``kernels/flare.py``), counterparts of the JAX ``pallas`` backend's kernels.

The name stays ``pallas`` so that a policy spelled for the JAX package
resolves to its counterpart. Tiles are fixed in ``csrc/flare.cu`` (the
autotuner is not ported). Forward-only; head dims 1 to 64 on the card. On
CPU tensors the wrappers run the plain versions.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register
from repro_torch.kernels.flare import HEAD_DIMS


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.ops import flare_mixer_fused

    return flare_mixer_fused(q, k, v)


register(MixerBackend(
    name="pallas",
    caps=Capabilities(device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=False, head_dims=HEAD_DIMS),
    plan=lambda shape, mesh, dtype: MixerPlan("pallas"),
    run=_run,
    # outranked by the fused entry point on the card; named-only on CPU
    score=lambda shape, device: 20.0 if device == "cuda" else 1.0,
    doc="CUDA kernels: encode + decode, two entry points (forward-only)",
))
