"""Process groups, device meshes and the collectives of the port.

Counterpart of ``repro/distributed/compat.py`` and of the ``lax`` collectives
the JAX package uses inside ``shard_map``. PyTorch runs one process per rank
(SPMD by hand), so there is no global array to map over: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, a mesh axis is
the process group of that dim, and every rank calls the same collectives in
the same order on its own tensors.

* :func:`init` starts the default process group: NCCL for CUDA, gloo for the
  CPU, chosen from the device the caller asks for, never from what happens
  to be present. ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``/``MASTER_PORT``
  come from the environment as ``torchrun`` sets them; a single process
  without them gets a group of one on a free local port.
* :func:`make_mesh` builds the mesh over the current world;
  :func:`axis_group` gives the group of one or more named axes.
* :func:`all_max` and :func:`all_reduce_sum_` are plain collectives (no
  gradient); :func:`all_sum` and :func:`all_gather` are differentiable: the
  backward of a SUM is a SUM of the gradients, and that of a gather the
  sum of the gradients of this rank's slot.

``group=None`` means no group at all: every collective is then a no-op, so
a path written for a mesh runs unchanged without one. The calls and bytes of
every collective are counted in :data:`COUNTS` (the chip smoke reads them).
"""
from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str], None]

# collectives issued by this process: calls and payload bytes
COUNTS = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    COUNTS.update(calls=0, bytes=0)


def backend_for(device_kind: str) -> str:
    """The process-group backend for a device kind: NCCL on CUDA, gloo on the CPU."""
    if device_kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device_kind!r}")
    return "nccl" if device_kind == "cuda" else "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(device_kind: str, *, rank: Optional[int] = None, world_size: Optional[int] = None,
         init_method: Optional[str] = None) -> None:
    """Start the default process group for ``device_kind`` ("cuda" or "cpu")
    unless one is running. Rank and world size default to ``RANK`` and
    ``WORLD_SIZE`` (0 and 1 without them); the rendezvous to ``env://`` when
    ``MASTER_ADDR`` is set, else, for a world of one, a free local port.
    On CUDA the rank's card is ``LOCAL_RANK`` (default 0)."""
    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{_free_port()}"
        else:
            raise ValueError("a world of several ranks needs MASTER_ADDR/MASTER_PORT "
                             "(torchrun sets them) or an init_method")
    if device_kind == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(device_kind), init_method=init_method, rank=rank,
                            world_size=world_size)


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              device_type: str = "cuda"):
    """A DeviceMesh of ``axis_shapes`` named ``axis_names`` over the current
    world (the process group must be running: :func:`init`)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call repro_torch.distributed.init first")
    if math.prod(axis_shapes) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(axis_shapes)} does not cover the world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, tuple(axis_shapes), mesh_dim_names=tuple(axis_names))


def axes_tuple(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks along ``axes`` (1 for none)."""
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in axes_tuple(axes))


def axis_group(mesh, axes: Axes):
    """The process group along the named ``axes`` of ``mesh`` (None for no
    axes). A mesh axis is a real group even of one rank, so a world of one
    issues the collectives of any other. Of several axes those of one rank
    are dropped, and those left are flattened into one group."""
    names = mesh.mesh_dim_names
    axes = axes_tuple(axes)
    for a in axes:
        if a not in names:
            raise ValueError(f"axis {a!r} not in mesh axes {names}")
    if not axes:
        return None
    live = tuple(a for a in axes if mesh.size(names.index(a)) > 1) or axes[:1]
    if len(live) == 1:
        return mesh.get_group(live[0])
    return mesh[live]._flatten().get_group()


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(t: torch.Tensor) -> None:
    COUNTS["calls"] += 1
    COUNTS["bytes"] += t.numel() * t.element_size()


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """Sum ``x`` (contiguous) over the group, in place; returns it."""
    if group is not None:
        _count(x)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group, a new tensor (no gradient:
    the callers use it as a softmax shift, which cancels)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        _count(out)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def barrier(group, device) -> None:
    """Wait for every rank of the group (a one-element reduction on
    ``device``, so NCCL groups need no device hint); not counted."""
    if group is not None:
        dist.all_reduce(torch.zeros(1, device=device), group=group)


class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(grad.contiguous().clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        if group is None:
            return x[None].clone()
        _count(x)
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        # every rank's output holds this rank's x in its slot: sum those
        total = all_reduce_sum_(grad.contiguous().clone(), ctx.group)
        return total[group_rank(ctx.group)], None


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group (``lax.psum``): each rank's gradient
    is the sum of every rank's gradient of the result."""
    return _AllSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable gather over the group (``lax.all_gather``): [W, *x.shape],
    slot r holding rank r's x."""
    return _AllGather.apply(x, group)
