"""Model and shape configuration for the port.

The port's own copy of the fields of ``repro.config.ModelConfig`` that the
PDE family reads, and of the paper-native PDE shapes. The family computes
in fp32 whatever the JAX config's ``compute_dtype`` says (``models/api.py``
of the JAX package forces it), so the port has no dtype fields.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "pde"
    num_layers: int = 4             # FLARE blocks
    d_model: int = 256              # C
    flare_latents: int = 0          # M
    flare_heads: int = 0            # H; head dim D = d_model // H


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int                    # points per example (N)
    global_batch: int               # examples per step (B)
    step: str = "train"


SHAPES = {
    "pde_40k": ShapeConfig("pde_40k", 40000, 8, "train"),
    "pde_1m": ShapeConfig("pde_1m", 1048576, 1, "train"),
}


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
