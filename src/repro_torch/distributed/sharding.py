"""The port's sequence layout: which ranks hold which tokens.

Counterpart of ``repro/distributed/sharding.py`` for what the sharded FLARE
path needs. The JAX trainer shards parameters FSDP-style and the batch over
``"data"``, and GSPMD reshards into ``shard_map``'s token split. PyTorch has
no GSPMD, so the port is explicitly sequence-parallel: parameters stay
replicated, each rank holds its slice of every example's tokens (the
counterpart of ``batch_spec``), and the gradients are summed over the ranks.
``param_shardings`` and ``cache_shardings`` are not ported.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.distributed.compat import axis_group, axis_size, group_rank


def fsdp_axes(mesh) -> tuple:
    """The composed batch/FSDP axes of this mesh, which split the tokens here
    (every axis but ``"model"``, whose ranks would split heads instead)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def token_slice(n: int, mesh) -> slice:
    """This rank's tokens of a sequence of ``n``; raises unless the token
    axes divide ``n``. The sharded path's one check of N: a plan sees only a
    hint of it (``backends/packed_shard.py::build_shard_plan``)."""
    size = axis_size(mesh, fsdp_axes(mesh))
    if n % size:
        raise ValueError(f"N={n} tokens do not split over the token axes "
                         f"{fsdp_axes(mesh)} (size {size})")
    per = n // size
    r = group_rank(axis_group(mesh, fsdp_axes(mesh)))
    return slice(r * per, (r + 1) * per)


def shard_tokens(batch: Mapping[str, torch.Tensor], mesh) -> dict:
    """Each [B, N, ...] tensor of a global batch cut to this rank's tokens
    (a view); tensors of rank below 2 pass whole."""
    return {key: t[:, token_slice(t.shape[1], mesh)] if t.dim() >= 2 else t
            for key, t in batch.items()}
