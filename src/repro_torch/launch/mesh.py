"""Mesh construction over the running process group.

Counterpart of ``repro/launch/mesh.py``. Functions, not module state, so an
import starts no process group. The production meshes are those of the JAX
package (a pod of 16 x 16, two pods of 2 x 16 x 16) and need that many
ranks. The host mesh spans the current world with every rank on the token
axis ``"data"`` and a ``"model"`` axis of 1: the port's models keep their
heads whole (the reference's host mesh splits heads where it can).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.distributed.compat import make_mesh


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call repro_torch.distributed.init first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    cfg = (MeshConfig((2, 16, 16), ("pod", "data", "model")) if multi_pod else MeshConfig())
    if _world() != cfg.num_devices:
        raise ValueError(f"the production mesh {cfg.shape} needs {cfg.num_devices} ranks, "
                         f"the world has {_world()}")
    return make_mesh(cfg.shape, cfg.axes, device_type=device_type)


def make_host_mesh(*, device_type: str = "cuda"):
    """A mesh over the current world: (world, 1) over ("data", "model")."""
    return make_mesh((_world(), 1), ("data", "model"), device_type=device_type)
