"""Sharded backends in plain torch: sequence-parallel (1D) and seq x latent
(2D) FLARE (``core/flare_sp.py``).

Counterpart of ``repro/backends/seqparallel.py``. Both need a mesh, so
"auto" without one never selects them; a plan for chosen axes comes from
:func:`repro_torch.core.dispatch.sharded_plan`. They run on this rank's
shards: ``seqparallel`` on its tokens with the whole q, ``seqlat`` on its
tokens and its slice of the latents, cut here from the replicated q (the
JAX backend's ``shard_map`` cuts it). The legacy ``("sp", ...)`` tuples are
not ported.
"""
from __future__ import annotations

from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, MixerShape, register
from repro_torch.distributed.compat import axis_group, group_rank, group_size


def _plan_sp(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    if mesh is None:
        raise ValueError("backend 'seqparallel' needs a mesh: pass one to resolve() or build "
                         "a plan with dispatch.sharded_plan(mesh, seq_axes)")
    # default: the tokens split over every mesh axis
    return MixerPlan("seqparallel", {"mesh": mesh, "seq_axes": tuple(mesh.mesh_dim_names)})


def _plan_sp2d(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    # the seq/lat split is a modelling decision a bare mesh does not make
    raise ValueError("backend 'seqlat' needs explicit seq/lat axes: build a plan with "
                     "repro_torch.core.dispatch.sharded_plan(mesh, seq_axes, lat_axes=...)")


def _run_sp(plan: MixerPlan, q, k, v):
    from repro_torch.core.flare_sp import flare_mixer_seqparallel

    return flare_mixer_seqparallel(q, k, v,
                                   group=axis_group(plan.params["mesh"], plan.params["seq_axes"]))


def _run_sp2d(plan: MixerPlan, q, k, v):
    from repro_torch.core.flare_sp import flare_mixer_seqlat

    mesh = plan.params["mesh"]
    lat = axis_group(mesh, plan.params["lat_axes"])
    size, m = group_size(lat), q.shape[1]
    if m % size:
        raise ValueError(f"seqlat: M={m} latents do not split over lat_axes (size {size})")
    per = m // size
    r = group_rank(lat)
    return flare_mixer_seqlat(q[:, r * per:(r + 1) * per], k, v,
                              seq_group=axis_group(mesh, plan.params["seq_axes"]),
                              lat_group=lat)


register(MixerBackend(
    name="seqparallel",
    caps=Capabilities(bidirectional=True, sharded=True),
    plan=_plan_sp,
    run=_run_sp,
    # the "auto" pick with a mesh where the kernel form is not: its plan
    # needs no seq/lat split decision
    score=lambda shape, device: 5.0,
    doc="tokens split over mesh axes; O(M*D) collectives a layer (plain torch)",
))

register(MixerBackend(
    name="seqlat",
    caps=Capabilities(bidirectional=True, sharded=True),
    plan=_plan_sp2d,
    run=_run_sp2d,
    doc="2D: tokens over seq axes, latent slices over lat axes (plain torch)",
))
