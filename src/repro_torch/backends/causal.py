"""Causal backends: the chunked-scan streaming form (plain torch) and the
causal CUDA kernel. Both meet the LM-mixer contract (token t mixes only the
prefix <= t); neither serves the bidirectional contract.

The kernel route keeps the JAX name ``causal_pallas``, as ``pallas`` and
``packed`` do, so that a policy spelled for the JAX package resolves to its
counterpart. It is forward-only, as the TPU kernel is, and the "auto" pick
for inference on the card; training resolves to ``causal_stream``.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register
from repro_torch.kernels.flare_causal import HEAD_DIMS

DEFAULT_CHUNK = 256


def _plan_stream(shape, mesh, dtype, device) -> MixerPlan:
    return MixerPlan("causal_stream",
                     {"chunk_size": min(DEFAULT_CHUNK, shape.tokens), "mode": "factored"})


def _run_stream(plan: MixerPlan, q, k, v):
    from repro_torch.core.flare_stream import flare_causal

    return flare_causal(q, k, v, chunk_size=plan.params.get("chunk_size", DEFAULT_CHUNK),
                        mode=plan.params.get("mode", "factored"))


def _plan_kernel(shape, mesh, dtype, device) -> MixerPlan:
    # no params: the kernel's token tile is its own (csrc/flare_causal.cu)
    return MixerPlan("causal_pallas")


def _run_kernel(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.ops import flare_causal_fused

    return flare_causal_fused(q, k, v)


register(MixerBackend(
    name="causal_stream",
    caps=Capabilities(causal=True, bidirectional=False),
    plan=_plan_stream,
    run=_run_stream,
    score=lambda shape, device: 10.0,
    doc="chunked-scan causal FLARE in plain torch (constant-memory LM mixer)",
))

register(MixerBackend(
    name="causal_pallas",
    caps=Capabilities(causal=True, bidirectional=False, device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=False, head_dims=HEAD_DIMS),
    plan=_plan_kernel,
    run=_run_kernel,
    score=lambda shape, device: 20.0 if device == "cuda" else 1.0,
    doc="CUDA kernel: causal FLARE over token tiles (forward-only)",
))
