"""Model, shape and training configuration for the port.

The port's own copy of the fields of ``repro.config.ModelConfig`` that the
PDE family reads, of the paper-native PDE shapes, and of the
``TrainConfig`` fields the trainer reads (the mesh's gradient compression is
not ported). The family computes in fp32 whatever the JAX config's
``compute_dtype`` says (``models/api.py`` of the JAX package forces it), so
the port has no dtype fields.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field


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


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    learning_rate: float = 1e-3
    warmup_frac: float = 0.1
    weight_decay: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    keep_checkpoints: int = 3
    log_every: int = 10


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
