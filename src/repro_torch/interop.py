"""Carry a JAX parameter pytree into the port's modules.

The tree arrives as nested dicts and lists of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX. Paths become
``state_dict`` keys (``blocks.0.mixer.k_proj.res.1.weight``); a dense
``kernel`` ``[in, out]`` becomes the ``weight`` ``[out, in]`` of an
``nn.Linear``. Every parity test loads its weights through here: the two
frameworks' random generators differ, so weights are never re-initialised.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays -> a flat ``state_dict`` of CPU tensors."""
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        raise TypeError(f"unexpected leaf container {type(tree)!r} at {prefix!r}")
    for key, sub in items:
        path = f"{prefix}{key}"
        if isinstance(sub, (dict, list, tuple)):
            out.update(params_from_jax(sub, path + "."))
        elif key == "kernel":
            out[f"{prefix}weight"] = torch.from_numpy(np.array(sub).T.copy())
        else:
            out[path] = torch.from_numpy(np.array(sub))
    return out


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (strict: every key must match)."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module
