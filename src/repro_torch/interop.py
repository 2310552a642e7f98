"""Carry parameters between a JAX parameter pytree and the port's modules.

The tree arrives as nested dicts and lists of numpy arrays (``jax.tree.map(
np.asarray, params)``), so this module needs no JAX. Paths become
``state_dict`` keys (``blocks.0.mixer.k_proj.res.1.weight``); a dense
``kernel`` ``[in, out]`` becomes the ``weight`` ``[out, in]`` of an
``nn.Linear``. Every parity test loads its weights through here: the two
frameworks' random generators differ, so weights are never re-initialised.

The JAX LMs stack their layers for ``jax.lax.scan``: every leaf of
``layers`` (the decoders' and RWKV-6's), of an MoE model's
``dense_layers``, of the hybrid's ``mamba_tail`` and of the
encoder-decoder's ``encoder`` and ``decoder`` has a leading [L] axis, and
every leaf of the hybrid's ``mamba_groups`` two, [G, per_group]
(:data:`STACKS`). :func:`unstack_layers` splits them into the (nested)
lists of per-layer trees that the port's ``nn.ModuleList``s read
(``layers.3.mlp.w_gate.weight``, ``mamba_groups.2.4.in_proj.weight``,
``encoder.5.attn.k_proj.res.1.weight``, ``decoder.0.cross_attn.wq.bias``).
Leaves that are not dense kernels pass as they are: the MoE's stacked
expert weights ``[E, C, F]`` (``layers.3.mlp.w_gate``), RWKV-6's raw
matrices (``layers.3.lora_a`` [C, 5 r]) and the hybrid's per-invocation
LoRA stacks (``shared.lora_q.a`` [G, C, r], kept stacked: they are one
module's tensors, not layers) keep the JAX layout. A None subtree (the
hybrid's ``mamba_tail`` when the layers divide into groups) has no leaves.

The other direction, :func:`to_jax_flat`, gives the flat form the
checkpoints hold: the JAX leaf paths joined by ``/``
(``blocks/0/mixer/k_proj/res/1/kernel``) with dense kernels ``[in, out]``.
The LM's per-layer keys ``layers.{i}.…`` (``dense_layers.{i}.…``,
``mamba_tail.{i}.…``, ``mamba_groups.{g}.{j}.…``, ``encoder.{i}.…``,
``decoder.{i}.…``) become the JAX LM's stacked leaves ``layers/…`` with
their leading axes;
the PDE family keeps its per-block keys, as the JAX package writes them.
:func:`from_jax_flat` inverts it (per-layer ``layers/{i}/…`` paths pass
through), so a checkpoint written by either package restores in the other.
:func:`encdec_caches_from_jax` carries the JAX encoder-decoder's decode
caches (``EncDecCaches``, its self-attention caches stacked) into the
port's.
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
        if sub is None:
            continue
        if isinstance(sub, (dict, list, tuple)):
            out.update(_jax_leaves(sub, path + "/"))
        else:
            out[path] = sub
    return out


def unstack_layers(tree: dict, key=None) -> dict:
    """A copy of ``tree`` with ``tree[key]``, whose leaves carry
    ``STACKS[key]`` leading axes, split into (nested) lists of per-layer
    trees; ``key=None`` splits every stack of :data:`STACKS` the tree holds
    (a None stack is left as it is)."""
    if key is None:
        for name in STACKS:
            if tree.get(name) is not None:
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

    def split(sub, axes):
        parts = [take(sub, i) for i in range(depth(sub))]
        return parts if axes == 1 else [split(part, axes - 1) for part in parts]

    return {**tree, key: split(tree[key], STACKS.get(key, 1))}


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Load a JAX parameter tree into ``module`` (strict: every key must match)."""
    module.load_state_dict(params_from_jax(tree), strict=True)
    return module


STACKED = "layers"   # the JAX LM's layer stack: every leaf has a leading [L] axis
# every stack of the JAX LMs and its number of leading (layer) axes:
# ``layers``, an MoE model's leading ``dense_layers``, the hybrid's
# ``mamba_groups`` [G, per_group] and ``mamba_tail`` [r], and the
# encoder-decoder's ``encoder`` and ``decoder``
STACKS = {STACKED: 1, "dense_layers": 1, "mamba_groups": 2, "mamba_tail": 1, "encoder": 1,
          "decoder": 1}


def jax_leaf(name: str) -> tuple:
    """(the checkpoint path of ``state_dict`` key ``name``, its index along
    the stack's leading axes as a tuple, or None):
    ``layers.3.mlp.w_up.weight`` -> (``layers/mlp/w_up/kernel``, (3,))."""
    parts = name.split(".")
    axes = STACKS.get(parts[0], 0)
    idx = parts[1:axes + 1]
    if axes and len(parts) > axes + 1 and all(i.isdigit() for i in idx):
        return f"{parts[0]}/{jax_key('.'.join(parts[axes + 1:]))}", tuple(map(int, idx))
    return jax_key(name), None


def to_jax_flat(tensors) -> dict:
    """``state_dict``-keyed tensors (parameters, or per-parameter optimizer
    moments) -> ``{jax/leaf/path: numpy array}``, dense weights as ``[in, out]``
    kernels, the LM's layers stacked along their leading axes. Copies to the
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
        idx = sorted(per_layer)   # row-major over the leading axes
        lead = tuple(n + 1 for n in map(max, zip(*idx)))
        arr = np.stack([per_layer[i] for i in idx])
        out[key] = arr.reshape(lead + arr.shape[1:])
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
            axes, rest = STACKS[path[0]], name.partition(".")[2]
            out.update({f"{path[0]}.{'.'.join(map(str, i))}.{rest}":
                        torch.from_numpy(np.ascontiguousarray(arr[i]))
                        for i in np.ndindex(arr.shape[:axes])})
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _tensor(arr) -> torch.Tensor:
    """A numpy array (a JAX array's host copy) as a CPU tensor; bfloat16,
    which torch cannot take from numpy, through fp32 (exact)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def encdec_caches_from_jax(caches):
    """The JAX ``EncDecCaches`` (``self_caches``: a ``KVCache`` whose
    leaves carry the decoder's leading [L] axis; ``memory``; ``pos``) as
    the port's ``models.transformer.EncDecCaches`` of CPU tensors, one
    ``KVCache`` a layer, in the same dtypes."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.transformer import EncDecCaches

    sc = caches.self_caches
    k, v, length = _tensor(sc.k), _tensor(sc.v), _tensor(sc.length)
    layers = [KVCache(k[i].clone(), v[i].clone(), length[i].clone()) for i in range(k.shape[0])]
    return EncDecCaches(layers, _tensor(caches.memory), _tensor(caches.pos))
