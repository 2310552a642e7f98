"""Carry parameters between a JAX parameter pytree and the port's modules.

The tree arrives as nested dicts and lists of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX. Paths become
``state_dict`` keys (``blocks.0.mixer.k_proj.res.1.weight``); a dense
``kernel`` ``[in, out]`` becomes the ``weight`` ``[out, in]`` of an
``nn.Linear``. Every parity test loads its weights through here: the two
frameworks' random generators differ, so weights are never re-initialised.

The JAX LM stacks its layers (every leaf of ``layers``, and of an MoE
model's ``dense_layers``, has a leading [L] axis, for ``jax.lax.scan``);
:func:`unstack_layers` splits them into the lists of per-layer trees that
the port's ``nn.ModuleList``s read (``layers.3.mlp.w_gate.weight``). Leaves
that are not dense kernels pass as they are: the MoE's stacked expert
weights ``[E, C, F]`` (``layers.3.mlp.w_gate``) keep the JAX layout.

The other direction, :func:`to_jax_flat`, gives the flat form the
checkpoints hold: the JAX leaf paths joined by ``/``
(``blocks/0/mixer/k_proj/res/1/kernel``) with dense kernels ``[in, out]``.
The LM's per-layer keys ``layers.{i}.…`` (and ``dense_layers.{i}.…``)
become the JAX LM's stacked leaves ``layers/…`` with a leading [L] axis;
the PDE family keeps its per-block keys, as the JAX package writes them.
:func:`from_jax_flat` inverts it (per-layer ``layers/{i}/…`` paths pass
through), so a checkpoint written by either package restores in the other.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def params_from_jax(tree) -> dict:
    """Nested dicts/lists of arrays -> a flat ``state_dict`` of CPU tensors."""
    return from_jax_flat(_jax_leaves(tree))


def _jax_leaves(tree, prefix: str = "") -> dict:
    """Nested dicts/lists of arrays -> ``{jax/leaf/path: array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        raise TypeError(f"unexpected leaf container {type(tree)!r} at {prefix!r}")
    out = {}
    for key, sub in items:
        path = f"{prefix}{key}"
        if isinstance(sub, (dict, list, tuple)):
            out.update(_jax_leaves(sub, path + "/"))
        else:
            out[path] = sub
    return out


def unstack_layers(tree: dict, key=None) -> dict:
    """A copy of ``tree`` with ``tree[key]``, whose leaves carry a leading
    [L] axis, split into a list of L per-layer trees; ``key=None`` splits
    every stack of :data:`STACKS` the tree holds."""
    if key is None:
        for name in STACKS:
            if name in tree:
                tree = unstack_layers(tree, name)
        return tree

    def take(sub, i):
        if isinstance(sub, dict):
            return {k: take(x, i) for k, x in sub.items()}
        if isinstance(sub, (list, tuple)):
            return [take(x, i) for x in sub]
        return sub[i]

    def depth(sub):
        while isinstance(sub, (dict, list, tuple)):
            sub = next(iter(sub.values())) if isinstance(sub, dict) else sub[0]
        return sub.shape[0]

    stacked = tree[key]
    return {**tree, key: [take(stacked, i) for i in range(depth(stacked))]}


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (strict: every key must match)."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module


STACKED = "layers"   # the JAX LM's layer stack: every leaf has a leading [L] axis
# every stack of the JAX LM: ``layers`` and an MoE model's leading ``dense_layers``
STACKS = (STACKED, "dense_layers")


def jax_leaf(name: str) -> tuple:
    """(the checkpoint path of ``state_dict`` key ``name``, its index along
    the stacked [L] axis, or None): ``layers.3.mlp.w_up.weight`` ->
    (``layers/mlp/w_up/kernel``, 3)."""
    head, _, rest = name.partition(".")
    i, _, rest = rest.partition(".")
    if head in STACKS and i.isdigit():
        return f"{head}/{jax_key(rest)}", int(i)
    return jax_key(name), None


def to_jax_flat(tensors) -> dict:
    """``state_dict``-keyed tensors (parameters, or per-parameter optimizer
    moments) -> ``{jax/leaf/path: numpy array}``, dense weights as ``[in, out]``
    kernels, the LM's layers stacked along a leading [L] axis. Copies to the
    host, each weight transposed where it lies (on the card, a fraction of
    a transpose on the host's cores); bf16, which numpy lacks, widens to
    fp32."""
    out, layers = {}, {}
    for name, t in tensors.items():
        t = t.detach()
        t = (t.T if name.endswith(".weight") else t).contiguous().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        key, i = jax_leaf(name)
        if i is None:
            out[key] = np.ascontiguousarray(arr)
        else:
            layers.setdefault(key, {})[i] = arr
    for key, per_layer in layers.items():
        out[key] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return out


def jax_key(name: str) -> str:
    """``blocks.0.mixer.k_proj.res.1.weight`` -> ``blocks/0/mixer/k_proj/res/1/kernel``."""
    *path, leaf = name.split(".")
    return "/".join([*path, "kernel" if leaf == "weight" else leaf])


def jax_keys(names) -> list:
    """The checkpoint paths :func:`to_jax_flat` writes for ``state_dict``
    keys ``names``."""
    return list(dict.fromkeys(jax_leaf(name)[0] for name in names))


def from_jax_flat(flat) -> dict:
    """The inverse of :func:`to_jax_flat`: ``{jax/leaf/path: array}`` -> a
    flat ``state_dict`` of CPU tensors, a stacked ``layers/…`` leaf split
    into its layers' keys."""
    out = {}
    for key, arr in flat.items():
        *path, leaf = key.split("/")
        arr = np.array(arr)
        if leaf == "kernel":
            leaf, arr = "weight", np.swapaxes(arr, -1, -2)
        name = ".".join([*path, leaf])
        if path[:1] and path[0] in STACKS and not (len(path) > 1 and path[1].isdigit()):
            out.update({f"{path[0]}.{i}.{name.partition('.')[2]}":
                        torch.from_numpy(np.ascontiguousarray(a)) for i, a in enumerate(arr)})
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
