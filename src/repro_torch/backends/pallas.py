"""Two-launch kernel backend: the CUDA encode and decode kernels
(``kernels/flare.py``), counterparts of the JAX ``pallas`` backend's kernels.

The name stays ``pallas`` so that a policy spelled for the JAX package
resolves to its counterpart. The plan consults the autotuner's ``"tiles"``
kind (:mod:`repro_torch.backends.autotune`): ``block_m``, the rows a block of
both kernels, and ``block_n``, the encode's tokens a split, follow the shape,
dtype and card instead of being fixed. Its runner times the forward, as the
reference's does. Forward-only; head dims 1 to 64 on the card. On CPU
tensors the wrappers run the plain versions.
"""
from __future__ import annotations

from repro_torch.backends import autotune
from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, MixerShape, register
from repro_torch.kernels.flare import HEAD_DIMS


def _mixer(q, k, v, block_m=None, block_n=None):
    from repro_torch.kernels.ops import flare_mixer_fused

    return flare_mixer_fused(q, k, v, block_m=block_m, block_n=block_n)


def _plan(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    return MixerPlan("pallas", autotune.plan_params("tiles", shape, dtype, device, _mixer,
                                                    backward=False))


def _run(plan: MixerPlan, q, k, v):
    return _mixer(q, k, v, **autotune.launch_params(plan, q, k, "tiles"))


register(MixerBackend(
    name="pallas",
    caps=Capabilities(device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=False, head_dims=HEAD_DIMS),
    plan=_plan,
    run=_run,
    # outranked by the fused entry point on the card; named-only on CPU
    score=lambda shape, device: 20.0 if device == "cuda" else 1.0,
    doc="CUDA kernels: encode + decode, two entry points, autotuned tiles (forward-only)",
))
