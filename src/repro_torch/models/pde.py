"""PDE surrogate models: the paper's FLARE surrogate and the Table-1 baselines.

Counterpart of ``repro/models/pde.py``. Every mixer shares the input and
output projections the paper holds fixed across mixers (App. D.3):

    in:  ResMLP(L=2, C_in -> C)          out: LN + ResMLP(L=2, C -> C_out)

Token mixers (``mixer=``):
  - flare:        B x FLARE blocks (the paper)
  - vanilla:      pre-LN multi-head self-attention + GELU MLP (ratio 4)
  - perceiver:    one encode cross-attention -> B latent self-attention
                  blocks -> one decode cross-attention (PerceiverIO-lite)
  - linformer:    learned [N, M] K/V down-projections (N <= MAX_TOKENS)
  - transolver:   physics-attention slices (soft assignment -> slice
                  self-attention -> de-slicing), Transolver-lite w/o conv

Parameters are modules whose ``state_dict`` keys are the JAX leaf paths
(``blocks.0.wq.weight`` for ``blocks/0/wq/kernel``, ``perceiver.latents``),
so ``interop`` carries a tree of either package into the other.

The baselines' attention runs through :func:`attention`, SDPA in the
operands' dtype with scale 1/sqrt(D). The reference computes the same
function as the plain ``core.flare.sdpa``, which materialises the fp32
scores: [8, 8, 40,000, 40,000] of them, 410 GB, for a vanilla block at
B=8, N=40,000. SDPA's memory-efficient kernel streams over the keys and
recomputes the scores in its backward; on CUDA the route is pinned to it,
so a shape it cannot take raises rather than falling back to the ``math``
route that materialises them. Every block function takes ``attend``: the
plain ``sdpa`` route (:func:`plain_attention`) is the oracle the tests and
the card's checks hold :func:`attention` against.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.flare import flare_block, init_flare_block, sdpa
from repro_torch.nn.modules import (
    GeluMLP,
    LayerNorm,
    ResMLP,
    dense,
    gelu_mlp,
    init_dense,
    init_gelu_mlp,
    init_resmlp,
    layernorm,
    resmlp,
    truncated_normal_,
)

MIXERS = ("flare", "vanilla", "perceiver", "linformer", "transolver")
MAX_TOKENS = 16384   # the Linformer's learned projection: its N rows cap the tokens

Attend = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over [B, H, S, D] x [B, H, T, D], by
    ``F.scaled_dot_product_attention``; on CUDA its memory-efficient kernel
    only (no materialised scores).

    The keys' mean over T is subtracted first. The softmax ignores a shift
    that every key shares, but SDPA's fused backward takes each query row's
    rowsum(dO * O) from the forward's rounded output, and that rounding
    carries a component every key shares into dq. Where the keys are nearly
    alike (the Perceiver's latents, the Transolver's slices) the shared
    component is large: on the card a Perceiver latent block's q-bias
    gradient read 3.9e-4 of its max off fp64 without the shift, the plain
    route 2.4e-6."""
    k = k - k.mean(dim=-2, keepdim=True)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        from torch.nn.attention import SDPBackend, sdpa_kernel

        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, scale=scale)
    return F.scaled_dot_product_attention(q, k, v, scale=scale)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The reference's route: the plain ``sdpa`` with its scores materialised."""
    return sdpa(q, k, v, scale=1.0 / math.sqrt(q.shape[-1]))


# ---------------------------------------------------------------------------
# Shared scaffold
# ---------------------------------------------------------------------------


class Surrogate(nn.Module):
    """``blocks`` (every mixer but the Perceiver) or ``perceiver``, between
    the shared projections."""

    def __init__(self, in_proj: ResMLP, out_norm: LayerNorm, out_proj: ResMLP, *,
                 blocks: Optional[list] = None, perceiver: Optional["Perceiver"] = None):
        super().__init__()
        self.in_proj = in_proj
        if blocks is not None:
            self.blocks = nn.ModuleList(blocks)
        if perceiver is not None:
            self.perceiver = perceiver
        self.out_norm = out_norm
        self.out_proj = out_proj

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return surrogate_forward(self, x, **kw)


def _check_mixer(mixer: str) -> None:
    if mixer not in MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}; the mixers are {MIXERS}")


def init_surrogate(mixer: str = "flare", *, in_dim: int, out_dim: int, dim: int,
                   num_blocks: int, num_heads: int, num_latents: int,
                   generator: torch.Generator, device=None,
                   dtype=torch.float32) -> Surrogate:
    """``num_latents`` is FLARE's M, the Perceiver's latents, the Linformer's
    projected length and the Transolver's slices, as in the reference."""
    _check_mixer(mixer)
    kw = dict(generator=generator, device=device, dtype=dtype)
    in_proj = init_resmlp(in_dim, dim, dim, 2, **kw)
    out_proj = init_resmlp(dim, dim, out_dim, 2, **kw)
    out_norm = LayerNorm(dim, device=device, dtype=dtype)
    if mixer == "perceiver":
        return Surrogate(in_proj, out_norm, out_proj,
                         perceiver=init_perceiver(dim, num_heads, num_latents, num_blocks, **kw))
    block = {
        "flare": lambda: init_flare_block(dim, num_heads, num_latents, **kw),
        "vanilla": lambda: init_vanilla_block(dim, num_heads, **kw),
        "linformer": lambda: init_linformer_block(dim, num_heads, num_latents, **kw),
        "transolver": lambda: init_transolver_block(dim, num_heads, num_latents, **kw),
    }[mixer]
    return Surrogate(in_proj, out_norm, out_proj, blocks=[block() for _ in range(num_blocks)])


def surrogate_forward(model: Surrogate, x: torch.Tensor, *, mixer: str = "flare",
                      num_heads: int = 8, policy=None, attend: Attend = attention) -> torch.Tensor:
    """x: [B, N, F_in] point features -> [B, N, F_out]. ``policy`` (FLARE's
    mixer): a MixerPolicy, the MixerPlan resolved at model build, or None
    (ambient). ``attend``: the baselines' attention."""
    _check_mixer(mixer)
    h = resmlp(model.in_proj, x)
    if mixer == "perceiver":
        h = perceiver_forward(model.perceiver, h, num_heads, attend=attend)
    elif mixer == "flare":
        for block in model.blocks:
            h = flare_block(block, h, policy=policy)
    else:
        apply = {"vanilla": vanilla_block, "linformer": linformer_block,
                 "transolver": transolver_block}[mixer]
        for block in model.blocks:
            h = apply(block, h, num_heads, attend=attend)
    return resmlp(model.out_proj, layernorm(model.out_norm, h))


def relative_l2(pred: torch.Tensor, target: torch.Tensor, *, group=None) -> torch.Tensor:
    """Paper Eq. 21/22, averaged over the batch. ``group``: the ranks that
    hold the other tokens of each example (``pred`` and ``target`` are this
    rank's slice). The norms need the squares summed over every token before
    the square root, so the other ranks' sums come in by a collective; they
    come in detached, so that each rank's loss carries the gradient of its
    own tokens only and the ranks' gradients sum to the global one (a
    differentiable sum would give each rank the whole gradient)."""
    sq = (pred - target).square().sum(dim=(-2, -1))
    ysq = target.square().sum(dim=(-2, -1))
    if group is not None:
        from repro_torch.distributed.compat import all_reduce_sum_

        both = all_reduce_sum_(torch.stack([sq.detach(), ysq.detach()]), group)
        sq = sq + (both[0] - sq.detach())
        ysq = both[1]
    return (sq.sqrt() / ysq.sqrt().clamp_min(1e-12)).mean()


def surrogate_loss(model: Surrogate, batch, *, mixer: str = "flare", num_heads: int = 8,
                   policy=None, group=None, attend: Attend = attention) -> torch.Tensor:
    """The relative L2 of the forward on ``batch["x"]`` against ``batch["y"]``,
    under ``mixer_policy(requires_grad=True)``: the loss is the differentiated
    entry point, so a bare (plan-less) call never lands on a forward-only
    mixer. ``group`` as for :func:`relative_l2`."""
    from repro_torch.core.policy import mixer_policy

    with mixer_policy(requires_grad=True):
        pred = surrogate_forward(model, batch["x"], mixer=mixer, num_heads=num_heads,
                                 policy=policy, attend=attend)
    return relative_l2(pred, batch["y"], group=group)


# ---------------------------------------------------------------------------
# Vanilla transformer block (pre-LN MHA + GELU MLP, ratio 4)
# ---------------------------------------------------------------------------


class VanillaBlock(nn.Module):
    def __init__(self, ln1: LayerNorm, wq: nn.Linear, wk: nn.Linear, wv: nn.Linear,
                 wo: nn.Linear, ln2: LayerNorm, mlp: GeluMLP):
        super().__init__()
        self.ln1, self.wq, self.wk, self.wv, self.wo = ln1, wq, wk, wv, wo
        self.ln2, self.mlp = ln2, mlp


def _vanilla_parts(dim: int, num_heads: int, *, generator: torch.Generator, device=None,
                   dtype=torch.float32) -> list:
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by heads {num_heads}")
    lin = lambda: init_dense(dim, dim, generator=generator, use_bias=True, device=device,
                             dtype=dtype)
    ln = lambda: LayerNorm(dim, device=device, dtype=dtype)
    return [ln(), lin(), lin(), lin(), lin(), ln(),
            init_gelu_mlp(dim, 4 * dim, generator=generator, device=device, dtype=dtype)]


def init_vanilla_block(dim: int, num_heads: int, **kw) -> VanillaBlock:
    return VanillaBlock(*_vanilla_parts(dim, num_heads, **kw))


def _mh(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, N, C] -> [B, H, N, C/H]."""
    b, n, c = x.shape
    return x.reshape(b, n, h, c // h).transpose(1, 2)


def _unmh(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, D] -> [B, N, H*D]."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _mlp_residual(p: VanillaBlock, x: torch.Tensor) -> torch.Tensor:
    return x + gelu_mlp(p.mlp, layernorm(p.ln2, x))


def vanilla_block(p: VanillaBlock, x: torch.Tensor, num_heads: int, *,
                  attend: Attend = attention) -> torch.Tensor:
    y = layernorm(p.ln1, x)
    q, k, v = (_mh(dense(w, y), num_heads) for w in (p.wq, p.wk, p.wv))
    x = x + dense(p.wo, _unmh(attend(q, k, v)))
    return _mlp_residual(p, x)


# ---------------------------------------------------------------------------
# PerceiverIO-lite
# ---------------------------------------------------------------------------


class Perceiver(nn.Module):
    """``enc`` and ``dec`` are vanilla blocks of which the cross-attention
    reads ``ln1`` and the projections only; their ``ln2`` and ``mlp`` are
    kept, unread, as the reference's tree holds them (they train by weight
    decay alone, as in JAX, whose gradient there is zero)."""

    def __init__(self, latents: nn.Parameter, enc: VanillaBlock, latent_blocks: list,
                 dec: VanillaBlock):
        super().__init__()
        self.latents = latents   # [M, C]
        self.enc = enc
        self.latent_blocks = nn.ModuleList(latent_blocks)
        self.dec = dec


def init_perceiver(dim: int, num_heads: int, num_latents: int, num_blocks: int, *,
                   generator: torch.Generator, device=None, dtype=torch.float32) -> Perceiver:
    kw = dict(generator=generator, device=device, dtype=dtype)
    latents = truncated_normal_(torch.empty(num_latents, dim), 1.0 / math.sqrt(dim), generator)
    return Perceiver(nn.Parameter(latents.to(device=device, dtype=dtype)),
                     init_vanilla_block(dim, num_heads, **kw),
                     [init_vanilla_block(dim, num_heads, **kw) for _ in range(num_blocks)],
                     init_vanilla_block(dim, num_heads, **kw))


def _cross(p: VanillaBlock, q_in: torch.Tensor, kv_in: torch.Tensor, num_heads: int, *,
           attend: Attend = attention) -> torch.Tensor:
    """q_in attends over kv_in; the one ``ln1`` normalises both inputs."""
    q = _mh(dense(p.wq, layernorm(p.ln1, q_in)), num_heads)
    kv = layernorm(p.ln1, kv_in)
    k, v = _mh(dense(p.wk, kv), num_heads), _mh(dense(p.wv, kv), num_heads)
    return q_in + dense(p.wo, _unmh(attend(q, k, v)))


def perceiver_forward(p: Perceiver, x: torch.Tensor, num_heads: int, *,
                      attend: Attend = attention) -> torch.Tensor:
    z = p.latents.to(x.dtype).expand(x.shape[0], *p.latents.shape)
    z = _cross(p.enc, z, x, num_heads, attend=attend)   # encode: latents attend to inputs
    for block in p.latent_blocks:
        z = vanilla_block(block, z, num_heads, attend=attend)
    return _cross(p.dec, x, z, num_heads, attend=attend)   # decode: inputs attend to latents


# ---------------------------------------------------------------------------
# Linformer-lite: a learned [N, M] projection of K and V (N <= MAX_TOKENS)
# ---------------------------------------------------------------------------


class LinformerBlock(VanillaBlock):
    def __init__(self, *parts, proj_e: nn.Parameter):
        super().__init__(*parts)
        self.proj_e = proj_e   # [MAX_TOKENS, M], a plain parameter (not a dense kernel)


def init_linformer_block(dim: int, num_heads: int, num_latents: int, *,
                         generator: torch.Generator, device=None, dtype=torch.float32,
                         max_tokens: int = MAX_TOKENS) -> LinformerBlock:
    parts = _vanilla_parts(dim, num_heads, generator=generator, device=device, dtype=dtype)
    e = torch.randn((max_tokens, num_latents), generator=generator) / math.sqrt(max_tokens)
    return LinformerBlock(*parts, proj_e=nn.Parameter(e.to(device=device, dtype=dtype)))


def linformer_block(p: LinformerBlock, x: torch.Tensor, num_heads: int, *,
                    attend: Attend = attention) -> torch.Tensor:
    n = x.shape[1]
    if n > p.proj_e.shape[0]:
        raise ValueError(f"the Linformer block takes at most {p.proj_e.shape[0]} tokens "
                         f"(its learned projection's rows, max_tokens), not {n}")
    y = layernorm(p.ln1, x)
    e = p.proj_e[:n].to(y.dtype)   # [N, M]: the O(N*M) parameter cost
    q, k, v = (_mh(dense(w, y), num_heads) for w in (p.wq, p.wk, p.wv))
    k = torch.einsum("nm,bhnd->bhmd", e, k)
    v = torch.einsum("nm,bhnd->bhmd", e, v)
    x = x + dense(p.wo, _unmh(attend(q, k, v)))
    return _mlp_residual(p, x)


# ---------------------------------------------------------------------------
# Transolver-lite (physics attention, w/o conv): soft slices shared across heads
# ---------------------------------------------------------------------------


class TransolverBlock(VanillaBlock):
    def __init__(self, *parts, slice_proj: nn.Linear):
        super().__init__(*parts)
        self.slice_proj = slice_proj   # C -> S, one for all heads


def init_transolver_block(dim: int, num_heads: int, num_slices: int, *,
                          generator: torch.Generator, device=None,
                          dtype=torch.float32) -> TransolverBlock:
    parts = _vanilla_parts(dim, num_heads, generator=generator, device=device, dtype=dtype)
    return TransolverBlock(*parts, slice_proj=init_dense(
        dim, num_slices, generator=generator, use_bias=True, device=device, dtype=dtype))


def transolver_block(p: TransolverBlock, x: torch.Tensor, num_heads: int, *,
                     attend: Attend = attention) -> torch.Tensor:
    y = layernorm(p.ln1, x)
    # soft assignment of points to slices, shared across heads (the paper's
    # Fig. 6 footnote: Transolver uses the same projection weights per head);
    # the softmax over S in fp32 (or wider)
    logits = dense(p.slice_proj, y)
    w = torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
    wsum = w.sum(dim=1, keepdim=True).clamp_min(1e-9)                     # [B, 1, S]
    tokens = torch.einsum("bns,bnc->bsc", (w / wsum).to(y.dtype), y)     # slice tokens
    q, k, v = (_mh(dense(m, tokens), num_heads) for m in (p.wq, p.wk, p.wv))
    tokens = dense(p.wo, _unmh(attend(q, k, v)))   # self-attention over the slices
    x = x + torch.einsum("bns,bsc->bnc", w.to(y.dtype), tokens)          # de-slice
    return _mlp_residual(p, x)
