"""Materialized backend: paper Fig. 7, explicit [M, N] encode and [N, M]
decode weights. O(M*N) memory; a second independent reference, never the
"auto" pick."""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, register


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.core.flare import _flare_mixer_materialized

    return _flare_mixer_materialized(q, k, v)


register(MixerBackend(
    name="materialized",
    caps=Capabilities(device_kinds=("cpu", "cuda")),
    plan=lambda shape, mesh, dtype, device: MixerPlan("materialized"),
    run=_run,
    score=lambda shape, device: 0.0,
    doc="explicit [M,N] weights (paper Fig. 7), analysis fallback",
))
