"""Fused kernel backend: ``kernels/flare_packed.py::FlareFused``, the fused
forward with the fused backward kernel as its gradient, the counterpart of
the JAX ``packed`` backend's ``_packed_core`` custom VJP.

The name stays ``packed`` so that a policy spelled for the JAX package
resolves to its counterpart; on Hopper nothing is lane-packed. It is the
"auto" pick on the card, for inference and, since it registers
``grads=True``, for training. On the CPU, where its wrappers run the plain
versions, "auto" keeps ``sdpa``. Tiles are fixed in ``csrc/`` (the
autotuner is not ported). Its kernels take head dims 1 to 64 on the card.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register
from repro_torch.kernels.flare import HEAD_DIMS


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.flare_packed import FlareFused
    from repro_torch.obs import scope

    # names the fused launches in a torch.profiler trace
    with scope("kernels.flare_packed"):
        return FlareFused.apply(q, k, v)


register(MixerBackend(
    name="packed",
    caps=Capabilities(device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=True, head_dims=HEAD_DIMS),
    plan=lambda shape, mesh, dtype: MixerPlan("packed"),
    run=_run,
    score=lambda shape, device: 30.0 if device == "cuda" else 1.5,
    doc="CUDA kernels: fused forward with residuals and fused backward (autograd)",
))
