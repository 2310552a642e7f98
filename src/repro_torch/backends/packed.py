"""Fused-forward kernel backend: ``kernels/flare_packed.py::flare_fused_fwd``,
the counterpart of the JAX ``packed`` backend's ``_fused_fwd_kernel``.

The name stays ``packed`` so that a policy spelled for the JAX package
resolves to its counterpart; on Hopper nothing is lane-packed. It is the
"auto" pick for inference on the card. It registers ``grads=False`` until
the backward kernel is ported, so a differentiated plan resolves elsewhere.
Tiles are fixed in ``csrc/flare.cu`` (the autotuner is not ported). On
CPU tensors the wrapper runs the plain version.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.flare_packed import flare_fused_fwd

    y, _, _, _ = flare_fused_fwd(q, k, v)
    return y


register(MixerBackend(
    name="packed",
    caps=Capabilities(device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=False),
    plan=lambda shape, dtype: MixerPlan("packed"),
    run=_run,
    score=lambda shape, device: 30.0 if device == "cuda" else 1.5,
    doc="CUDA kernels: fused forward with residuals, one entry point (forward-only)",
))
