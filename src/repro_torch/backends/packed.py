"""Fused kernel backend: ``kernels/flare_packed.py::FlareFused``, the fused
forward with the fused backward kernel as its gradient, the counterpart of
the JAX ``packed`` backend's ``_packed_core`` custom VJP.

The name stays ``packed`` so that a policy spelled for the JAX package
resolves to its counterpart; on Hopper nothing is lane-packed, so the
reference's head-pack factor has no counterpart. It is the "auto" pick on
the card, for inference and, since it registers ``grads=True``, for
training. On the CPU, where its wrappers run the plain versions, "auto"
keeps ``sdpa``. The plan consults the autotuner's ``"packed"`` kind
(:mod:`repro_torch.backends.autotune`): ``block_n``, the split the
forward's encode and the backward's passes (a) and (c) share, and
``block_m``, the forward kernels' rows a block. Its runner times the
forward and the backward, since ``block_n`` sets the backward's split. The
kernels take head dims 1 to 64 on the card.
"""
from __future__ import annotations

from repro_torch.backends import autotune
from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, MixerShape, register
from repro_torch.kernels.flare import HEAD_DIMS


def _fused(q, k, v, block_m=None, block_n=None):
    from repro_torch.kernels.flare_packed import FlareFused

    return FlareFused.apply(q, k, v, block_m, block_n)


def _plan(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    return MixerPlan("packed", autotune.plan_params("packed", shape, dtype, device, _fused,
                                                    backward=True))


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.obs import scope

    # names the fused launches in a torch.profiler trace
    with scope("kernels.flare_packed"):
        return _fused(q, k, v, **autotune.launch_params(plan, q, k, "packed"))


register(MixerBackend(
    name="packed",
    caps=Capabilities(device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=True, head_dims=HEAD_DIMS),
    plan=_plan,
    run=_run,
    score=lambda shape, device: 30.0 if device == "cuda" else 1.5,
    doc="CUDA kernels: fused forward with residuals and fused backward (autograd), "
        "autotuned tiles",
))
