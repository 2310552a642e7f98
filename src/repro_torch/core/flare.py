"""FLARE: Fast Low-rank Attention Routing Engine, the operator in PyTorch.

Counterpart of ``repro/core/flare.py``. The operator (paper §3.2):

    Z_h = SDPA(Q_h, K_h, V_h, scale=1)   # encode: [M,D] latents gather N tokens
    Y_h = SDPA(K_h, Q_h, Z_h, scale=1)   # decode: latents scatter back to N

Layout [B, H, N, D]; the latent queries are a parameter of shape [H, M, D].
The mixer is resolved through :mod:`repro_torch.core.policy`: ``policy`` is
a MixerPolicy, a pre-resolved MixerPlan (what model forwards receive), or
None for the ambient policy. Softmax statistics are fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.nn.modules import (
    LayerNorm,
    ResMLP,
    dense,
    init_dense,
    init_resmlp,
    layernorm,
    resmlp,
    truncated_normal_,
)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float = 1.0,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with an fp32 softmax (fp64 for fp64 operands).
    q: [..., S, D], k/v: [..., T, D]. ``mask`` (boolean, broadcast against
    the scores [..., S, T]) keeps the scores where it is True; the rest are
    -inf before the softmax, as in the reference. A row with no key kept
    has no finite score: its weights, and so its output, are NaN, as
    ``jax.nn.softmax`` gives them."""
    scores = torch.einsum("...sd,...td->...st", q, k)
    scores = scores.to(torch.promote_types(scores.dtype, torch.float32)) * scale
    if mask is not None:
        scores = torch.where(mask, scores, -torch.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("...st,...td->...sd", w.to(v.dtype), v)


def flare_mixer(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, policy=None) -> torch.Tensor:
    """Multi-head FLARE token mixing: q [H, M, D], k/v [B, H, N, D] -> [B, H, N, D].
    A policy (not a plan) is resolved here, for the device of ``k``."""
    from repro_torch.core.dispatch import MixerShape
    from repro_torch.core.policy import resolve_policy, run_plan

    plan = resolve_policy(policy, MixerShape.from_qkv(q, k), k.dtype, device=k.device.type)
    return run_plan(plan, q, k, v)


def _flare_mixer_materialized(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 7: explicitly materializes W_enc [M, N] and W_dec [N, M]."""
    scores = torch.einsum("hmd,bhnd->bhmn", q, k).float()
    w_enc = torch.softmax(scores, dim=-1)   # rows over N
    w_dec = torch.softmax(scores, dim=-2)   # rows over M (decode view [n, m])
    z = torch.einsum("bhmn,bhnd->bhmd", w_enc.to(v.dtype), v)
    return torch.einsum("bhmn,bhmd->bhnd", w_dec.to(v.dtype), z)


def flare_dense_operator(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The induced dense mixing matrix W_h = W_dec @ W_enc (Eq. 9).
    q [H, M, D], k [H, N, D] (one example) -> W [H, N, N], rank <= M.
    For analysis and tests only: O(N^2) memory."""
    scores = torch.einsum("hmd,hnd->hmn", q, k).float()
    w_enc = torch.softmax(scores, dim=-1)   # [H, M, N]
    w_dec = torch.softmax(scores, dim=-2)   # [H, M, N], normalised over m
    return torch.einsum("hmn,hmk->hnk", w_dec, w_enc)


# ---------------------------------------------------------------------------
# FLARE layer: ResMLP K/V projections + mixer + output linear (paper App. B.2)
# ---------------------------------------------------------------------------


class FlareLayer(nn.Module):
    def __init__(self, q_latent: nn.Parameter, k_proj: ResMLP, v_proj: ResMLP,
                 out_proj: nn.Linear):
        super().__init__()
        self.q_latent = q_latent    # [H, M, D]: the paper's Q in R^{M x C}, split per head
        self.k_proj = k_proj
        self.v_proj = v_proj
        self.out_proj = out_proj

    def forward(self, x: torch.Tensor, *, policy=None) -> torch.Tensor:
        return flare_layer(self, x, policy=policy)


def init_flare_layer(dim: int, num_heads: int, num_latents: int, *,
                     generator: torch.Generator, kv_proj_layers: int = 3,
                     device=None, dtype=torch.float32) -> FlareLayer:
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
    head_dim = dim // num_heads
    q = truncated_normal_(torch.empty(num_heads, num_latents, head_dim, device=generator.device),
                          1.0 / math.sqrt(head_dim), generator)
    mk = lambda: init_resmlp(dim, dim, dim, kv_proj_layers, generator=generator,
                             device=device, dtype=dtype)
    return FlareLayer(nn.Parameter(q.to(device=device, dtype=dtype)), mk(), mk(),
                      init_dense(dim, dim, generator=generator, use_bias=True,
                                 device=device, dtype=dtype))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, D], a strided view."""
    return x.unflatten(2, (num_heads, x.shape[2] // num_heads)).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]; a view when x is laid out as [B, N, H, D]."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def flare_layer(layer: FlareLayer, x: torch.Tensor, *, policy=None) -> torch.Tensor:
    """x: [B, N, C] -> [B, N, C]."""
    num_heads = layer.q_latent.shape[0]
    k = _split_heads(resmlp(layer.k_proj, x), num_heads)
    v = _split_heads(resmlp(layer.v_proj, x), num_heads)
    y = flare_mixer(layer.q_latent.to(x.dtype), k, v, policy=policy)
    return dense(layer.out_proj, _merge_heads(y))


# ---------------------------------------------------------------------------
# FLARE block (paper Eq. 10): pre-norm mixer + pre-norm ResMLP
# ---------------------------------------------------------------------------


class FlareBlock(nn.Module):
    def __init__(self, ln1: LayerNorm, mixer: FlareLayer, ln2: LayerNorm, mlp: ResMLP):
        super().__init__()
        self.ln1 = ln1
        self.mixer = mixer
        self.ln2 = ln2
        self.mlp = mlp

    def forward(self, x: torch.Tensor, *, policy=None) -> torch.Tensor:
        return flare_block(self, x, policy=policy)


def init_flare_block(dim: int, num_heads: int, num_latents: int, *,
                     generator: torch.Generator, kv_proj_layers: int = 3,
                     mlp_layers: int = 3, device=None, dtype=torch.float32) -> FlareBlock:
    return FlareBlock(
        LayerNorm(dim, device=device, dtype=dtype),
        init_flare_layer(dim, num_heads, num_latents, generator=generator,
                         kv_proj_layers=kv_proj_layers, device=device, dtype=dtype),
        LayerNorm(dim, device=device, dtype=dtype),
        init_resmlp(dim, dim, dim, mlp_layers, generator=generator, device=device, dtype=dtype),
    )


def flare_block(block: FlareBlock, x: torch.Tensor, *, policy=None) -> torch.Tensor:
    x = x + flare_layer(block.mixer, layernorm(block.ln1, x), policy=policy)
    return x + resmlp(block.mlp, layernorm(block.ln2, x))
