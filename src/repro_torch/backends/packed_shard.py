"""``packed_shard`` backend: the fused kernels split across the ranks that
hold an example's tokens (``kernels/flare_packed_shard.py``).

Counterpart of ``repro/backends/packed_shard.py``. The mesh-parallel
training fast path: tokens split over the sequence axes (``"data"``),
whole heads over the latent axes (``"model"``: heads are independent, so
that axis needs no collective), the latent statistics and dZ summed over
the sequence ranks. Eligible only with a mesh (``Capabilities.sharded``),
so "auto" never routes a single-device call here; with a mesh it outranks
the plain ``seqparallel`` form on the card wherever the latent axes divide
the heads. The plan carries the mesh and its axes, and the ``"packed"``
kind's launch parameters (:mod:`repro_torch.backends.autotune`) looked up
with the PER-SHARD problem shape and a mesh component in the key, so a
``packed_shard`` winner never collides with a one-device ``packed`` entry
for the same shape. Its runner times the per-shard kernels, forward and
backward, on a group of one: no collective runs while a rank searches, so
ranks never wait on each other's search.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.backends import autotune
from repro_torch.core.dispatch import Capabilities, MixerBackend, MixerPlan, MixerShape, register
from repro_torch.distributed.compat import axis_size
from repro_torch.kernels.flare import HEAD_DIMS


def default_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """A bare mesh's axis split: heads over ``"model"`` when the mesh has
    one, tokens over every other axis."""
    names = tuple(mesh.mesh_dim_names)
    lat = ("model",) if "model" in names else ()
    return tuple(a for a in names if a not in lat), lat


def mesh_shape_tag(mesh) -> str:
    """Comma-free ``axis<size>`` string recorded in plan params, e.g. ``data4xmodel1``."""
    return "x".join(f"{a}{mesh.size(i)}" for i, a in enumerate(mesh.mesh_dim_names))


def mesh_key(mesh) -> tuple:
    """The mesh component of the autotuner's key: the axis sizes."""
    return tuple(mesh.size(i) for i in range(len(mesh.mesh_dim_names)))


def _shard_fused(q, k, v, block_m=None, block_n=None):
    """The runner's call: the per-shard kernels on a group of one."""
    from repro_torch.kernels.flare_packed_shard import FlareFusedShard

    return FlareFusedShard.apply(q, k, v, None, block_m, block_n)


def build_shard_plan(shape: MixerShape, mesh, seq_axes, lat_axes, dtype,
                     device: str = "cuda") -> MixerPlan:
    """Check the shape against the axis split and freeze a plan. Raises
    ValueError where the latent axes do not divide H, so that "auto" and
    :func:`repro_torch.core.dispatch.sharded_plan` can fall back. N is not
    checked: the mixer runs on this rank's tokens, every sharded form needs
    the batch's tokens to split over the sequence axes alike, and
    ``distributed.sharding.token_slice`` checks the batch's real N when it
    takes the rank's slice (the shape's N is only a hint at plan time, and
    the per-shard N the launch parameters are looked up for is its share)."""
    seq, lat = tuple(seq_axes), tuple(lat_axes)
    lat_size = axis_size(mesh, lat)
    if shape.heads % lat_size:
        raise ValueError(f"packed_shard: H={shape.heads} not divisible by lat_axes {lat} "
                         f"(size {lat_size})")
    local = MixerShape(batch=shape.batch, heads=shape.heads // lat_size,
                       tokens=max(1, shape.tokens // axis_size(mesh, seq)),
                       latents=shape.latents, head_dim=shape.head_dim)
    tiles = autotune.plan_params("packed", local, dtype, device, _shard_fused, backward=True,
                                 mesh=mesh_key(mesh))
    return MixerPlan("packed_shard", {"mesh": mesh, "seq_axes": seq, "lat_axes": lat, **tiles,
                                      "mesh_shape": mesh_shape_tag(mesh)})


def _plan(shape: MixerShape, mesh, dtype, device) -> MixerPlan:
    if mesh is None:
        raise ValueError("backend 'packed_shard' needs a mesh: pass one to resolve() or build "
                         "a plan with dispatch.sharded_plan(mesh, seq_axes, lat_axes, shape=...)")
    return build_shard_plan(shape, mesh, *default_axes(mesh), dtype, device)


def _run(plan: MixerPlan, q, k, v):
    from repro_torch.kernels.flare_packed_shard import flare_mixer_packed_shard

    mesh = plan.params["mesh"]
    return flare_mixer_packed_shard(q, k, v, mesh=mesh, seq_axes=plan.params["seq_axes"],
                                    lat_axes=plan.params["lat_axes"],
                                    **autotune.launch_params(plan, q, k, "packed",
                                                             mesh=mesh_key(mesh)))


register(MixerBackend(
    name="packed_shard",
    caps=Capabilities(bidirectional=True, sharded=True, device_kinds=("cpu", "cuda"),
                      dtypes=("float32", "bfloat16"), grads=True, head_dims=HEAD_DIMS),
    plan=_plan,
    run=_run,
    # with a mesh on the card this is the training fast path; on the CPU its
    # wrappers run the plain versions, so the plain seqparallel (5) wins there
    score=lambda shape, device: 40.0 if device == "cuda" else 2.0,
    doc="mesh-parallel fused kernels: tokens over data, heads over model, summed latent "
        "statistics and dZ",
))
