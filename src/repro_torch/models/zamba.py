"""The Zamba2-style hybrid: a Mamba2 backbone and one SHARED attention block
applied every k layers with per-invocation LoRA adapters (the ``hybrid``
family).

Counterpart of ``repro/models/zamba.py``. For num_layers = G*k + r: G
groups of (k-1 Mamba2 layers, then one invocation of the shared block),
then r trailing Mamba2 layers. The shared block's input is concat(hidden,
the token embedding x0) -> Linear(2C -> C) (Zamba's re-injection of the
embedding stream), then rope'd GQA and a SwiGLU, with LoRA deltas on q, k,
v and the MLP gate indexed by invocation.

Layout. The JAX package stacks the Mamba2 layers ``[G, per_group]`` and
``[r]`` and scans them; here they are ``nn.ModuleList``s
(``mamba_groups.{g}.{j}``, ``mamba_tail.{j}``). The LoRA adapters stay
stacked as the JAX tree holds them, one ``[G, ...]`` tensor a matrix
(``shared.lora_q.a`` [G, C, r], ``.b`` [G, r, q_dim]), indexed by
invocation at use: they are per-invocation tensors of one module, not
layers. The caches keep one :class:`~repro_torch.models.attention.KVCache`
an invocation in a list (``ZambaCaches.attn``), where the JAX package
stacks them ``[G, B, Hkv, cap, D]``: the serving pool then pages each as
``[NB + 1, block, Hkv, D]``, the paged-attention kernel's own layout, and
the engine's "auto" route reads it through the kernel. Each Mamba2 state
is a :class:`~repro_torch.models.ssm.Mamba2State` in a list of lists.

Decode attends through ``attention.gqa_cache_attend``: a dense cache is
written in place and read in fp32; a paged pool's kernel view
(``PagedTokenView``) takes the paged-attention kernel. Prefill attends
through ``attn_sdpa``'s ``impl`` route ("pallas": the flash kernel, on the
KV heads unexpanded).

The conv state is held in the compute dtype (the JAX package's pool holds
it in bf16 whatever the compute dtype, and its decode step returns it in
the compute dtype); the SSD state and the logits are fp32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.attention import (
    GQA,
    KVCache,
    _expand_kv,
    _heads,
    _unheads,
    attn_sdpa,
    gqa_cache_attend,
    init_gqa,
    init_kv_cache,
    prefill_kv_cache,
)
from repro_torch.models.rope import apply_rope, rope_angles, text_positions
from repro_torch.models.ssm import Mamba2State, init_mamba2_layer, mamba2_block, mamba2_dims
from repro_torch.models.transformer import (
    _decode_positions,
    _last_valid,
    _norm,
    _remat,
    mask_padded_logits,
    padded_vocab,
)
from repro_torch.nn.modules import (
    Embedding,
    RMSNorm,
    SwiGLU,
    dense,
    embedding,
    init_dense,
    init_embedding,
    init_rmsnorm,
    init_swiglu,
)


def _plan(cfg: ModelConfig) -> tuple:
    """(G shared invocations, Mamba2 layers a group, trailing Mamba2 layers)."""
    k = cfg.shared_attn_every
    g = cfg.num_layers // k
    return g, k - 1, cfg.num_layers - g * k


class LoRA(nn.Module):
    """Per-invocation LoRA stacks: ``a`` [G, in, r], ``b`` [G, r, out]."""

    def __init__(self, a: nn.Parameter, b: nn.Parameter):
        super().__init__()
        self.a, self.b = a, b


def init_lora(g: int, din: int, dout: int, rank: int, *, generator: torch.Generator,
              device=None, dtype=torch.float32) -> LoRA:
    """``a`` normal with stddev 0.02, ``b`` zero (each adapter starts as a no-op)."""
    a = torch.empty(g, din, rank, device=generator.device).normal_(generator=generator)
    return LoRA(nn.Parameter((a * 0.02).to(device=device, dtype=dtype)),
                nn.Parameter(torch.zeros(g, rank, dout, device=device, dtype=dtype)))


def lora_dense(base: nn.Linear, lora: LoRA, i: int, x: torch.Tensor) -> torch.Tensor:
    """y = x W + (x A_i) B_i, in x's dtype."""
    return dense(base, x) + (x @ lora.a[i].to(x.dtype)) @ lora.b[i].to(x.dtype)


class SharedBlock(nn.Module):
    """``in_proj`` (2C -> C), ``norm1``, ``attn`` (GQA), ``norm2``, ``mlp``
    (SwiGLU) and the LoRA stacks ``lora_q``, ``lora_k``, ``lora_v``,
    ``lora_gate``, as the JAX tree's ``shared``."""

    def __init__(self, in_proj: nn.Linear, norm1: RMSNorm, attn: GQA, norm2: RMSNorm,
                 mlp: SwiGLU, lora_q: LoRA, lora_k: LoRA, lora_v: LoRA, lora_gate: LoRA):
        super().__init__()
        self.in_proj, self.norm1, self.attn, self.norm2, self.mlp = (in_proj, norm1, attn,
                                                                     norm2, mlp)
        self.lora_q, self.lora_k, self.lora_v, self.lora_gate = lora_q, lora_k, lora_v, lora_gate


class Zamba(nn.Module):
    """``embed``, ``mamba_groups`` (G lists of per-group Mamba2 layers),
    ``mamba_tail``, ``shared``, ``final_norm``, ``lm_head``."""

    def __init__(self, embed: Embedding, mamba_groups: list, mamba_tail: list,
                 shared: SharedBlock, final_norm: RMSNorm, lm_head: nn.Linear):
        super().__init__()
        self.embed = embed
        self.mamba_groups = nn.ModuleList(nn.ModuleList(g) for g in mamba_groups)
        self.mamba_tail = nn.ModuleList(mamba_tail)
        self.shared = shared
        self.final_norm = final_norm
        self.lm_head = lm_head


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.norm != "rmsnorm" or cfg.attn.kind != "gqa" or cfg.ssm is None:
        raise ValueError(f"the port's hybrid has gqa attention, Mamba2 and rmsnorm, not "
                         f"{cfg.attn.kind!r} / {cfg.norm!r}")


def init_zamba(cfg: ModelConfig, *, generator: torch.Generator, device=None) -> Zamba:
    """Weights drawn from ``generator`` (on its device) and moved to ``device``."""
    _check_cfg(cfg)
    kw = dict(device=device, dtype=getattr(torch, cfg.param_dtype))
    g, per_group, trailing = _plan(cfg)
    a, c, r = cfg.attn, cfg.d_model, cfg.lora_rank
    vp = padded_vocab(cfg.vocab)
    mamba = lambda: init_mamba2_layer(c, cfg.ssm, generator=generator, **kw)
    embed = init_embedding(vp, c, generator=generator, **kw)
    groups = [[mamba() for _ in range(per_group)] for _ in range(g)]
    tail = [mamba() for _ in range(trailing)]
    shared = SharedBlock(
        init_dense(2 * c, c, generator=generator, **kw), init_rmsnorm(c, **kw),
        init_gqa(a, c, generator=generator, **kw), init_rmsnorm(c, **kw),
        init_swiglu(c, cfg.d_ff, generator=generator, **kw),
        *(init_lora(g, c, dout, r, generator=generator, **kw)
          for dout in (a.q_dim, a.kv_dim, a.kv_dim, cfg.d_ff)))
    return Zamba(embed, groups, tail, shared, init_rmsnorm(c, **kw),
                 init_dense(c, vp, generator=generator, **kw))


def _shared_block(shared: SharedBlock, i: int, x: torch.Tensor, x0: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  cache: Optional[KVCache] = None, impl: str = "auto", capacity: int = 0,
                  lengths: Optional[torch.Tensor] = None):
    """Invocation ``i`` of the shared attention block -> (x', its cache or
    None). With ``cache`` (decode) the new token's K/V go into it through
    ``gqa_cache_attend``; without (forward, prefill) attention runs through
    ``attn_sdpa``'s ``impl`` route, and ``capacity`` packs the prompt's K/V
    into a fresh cache of that many rows."""
    a = cfg.attn
    h = dense(shared.in_proj, torch.cat([x, x0], dim=-1))
    hin = _norm(cfg, shared.norm1, h)
    q = _heads(lora_dense(shared.attn.wq, shared.lora_q, i, hin), a.num_heads)
    k = _heads(lora_dense(shared.attn.wk, shared.lora_k, i, hin), a.num_kv_heads)
    v = _heads(lora_dense(shared.attn.wv, shared.lora_v, i, hin), a.num_kv_heads)
    ang = rope_angles(positions, a.head_dim, a.rope_theta)
    q, k = apply_rope(q, ang), apply_rope(k, ang)
    groups = a.num_heads // a.num_kv_heads
    new_cache = None
    if cache is not None:
        out, new_cache = gqa_cache_attend(q, k, v, cache, groups=groups, head_dim=a.head_dim)
    else:
        # the flash kernel reads each KV head for its query heads: no expanded copy
        kx, vx = (k, v) if impl == "pallas" else (_expand_kv(k, groups), _expand_kv(v, groups))
        out = attn_sdpa(q, kx, vx, scale=1.0 / math.sqrt(a.head_dim), causal=True,
                        window=a.sliding_window, impl=impl)
        if capacity:
            new_cache = prefill_kv_cache(k, v, a, capacity, lengths)
    h = h + dense(shared.attn.wo, _unheads(out))
    hin = _norm(cfg, shared.norm2, h)
    gate = F.silu(lora_dense(shared.mlp.w_gate, shared.lora_gate, i, hin))
    h = h + dense(shared.mlp.w_down, gate * dense(shared.mlp.w_up, hin))
    return h, new_cache


def _logits(net: Zamba, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return dense(net.lm_head, _norm(cfg, net.final_norm, x)).float()


def zamba_forward(net: Zamba, tokens: torch.Tensor, cfg: ModelConfig, *,
                  impl: str = "auto") -> tuple:
    """tokens [B, S] -> (logits fp32 [B, S, V_padded] with the padded tail
    at -inf, a zero aux loss). Under autograd each group (its Mamba2 layers
    and the shared invocation) and each trailing layer runs through
    ``_remat(..., cfg.remat)``."""
    x0 = embedding(net.embed, tokens, getattr(torch, cfg.compute_dtype))
    positions = text_positions(*tokens.shape, device=tokens.device)

    def group(layers, i, x):
        for layer in layers:
            x, _ = mamba2_block(layer, x, cfg.ssm, impl="chunked")
        return _shared_block(net.shared, i, x, x0, cfg, positions=positions, impl=impl)[0]

    group_fn = _remat(group, cfg.remat)
    tail_fn = _remat(lambda layer, x: mamba2_block(layer, x, cfg.ssm, impl="chunked")[0],
                     cfg.remat)
    x = x0
    for i, layers in enumerate(net.mamba_groups):
        x = group_fn(layers, i, x)
    for layer in net.mamba_tail:
        x = tail_fn(layer, x)
    return mask_padded_logits(_logits(net, x, cfg), cfg.vocab), torch.zeros((), device=x.device)


def zamba_loss(net: Zamba, batch: dict, cfg: ModelConfig, *, impl: str = "auto"):
    """Next-token cross-entropy: ``mean(logsumexp(logits) - gold)``."""
    logits, _ = zamba_forward(net, batch["tokens"], cfg, impl=impl)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


class ZambaCaches(NamedTuple):
    """The JAX ``ZambaCaches`` without its unused ``x0_tok`` placeholder
    (the embedding is recomputed a token)."""
    mamba_groups: list    # G lists of Mamba2State, one a group's layer
    mamba_tail: list      # one Mamba2State a trailing layer
    attn: list            # one KVCache a shared invocation
    pos: torch.Tensor     # [B] int32, the next position of each sequence slot


def init_zamba_caches(batch: int, cfg: ModelConfig, capacity: int, *,
                      device=None) -> ZambaCaches:
    """Zero states: each Mamba2 layer's conv state [B, conv_dim, K-1] in the
    compute dtype and SSD state [B, H, P, N] fp32, each invocation's bf16
    KV cache of ``capacity`` rows."""
    g, per_group, trailing = _plan(cfg)
    _, h, p, n, conv_dim = mamba2_dims(cfg.d_model, cfg.ssm)
    cd = getattr(torch, cfg.compute_dtype)

    def mstate():
        return Mamba2State(
            torch.zeros(batch, conv_dim, cfg.ssm.conv_kernel - 1, dtype=cd, device=device),
            torch.zeros(batch, h, p, n, dtype=torch.float32, device=device))

    return ZambaCaches(
        mamba_groups=[[mstate() for _ in range(per_group)] for _ in range(g)],
        mamba_tail=[mstate() for _ in range(trailing)],
        attn=[init_kv_cache(batch, cfg.attn, capacity, device=device) for _ in range(g)],
        pos=torch.zeros(batch, dtype=torch.int32, device=device))


def zamba_decode_step(net: Zamba, token: torch.Tensor, caches, cfg: ModelConfig) -> tuple:
    """One token a sequence: token [B, 1] -> (logits fp32 [B, V], caches one
    position on), the Mamba2 layers through the scan form.

    ``caches`` may be a paged pool's ``PagedCacheView``: it resolves into
    caches whose KV leaves are a dense gather or the kernel route's
    ``PagedTokenView`` handles (the Mamba2 states are dense either way) and
    a write-back, which returns the view the engine carries on."""
    from repro_torch.serve.pool.views import resolve_cache_view

    caches, writeback = resolve_cache_view(caches)
    x0 = embedding(net.embed, token, getattr(torch, cfg.compute_dtype))   # [B, 1, C]
    positions = _decode_positions(caches.pos, token.shape[0], False)

    def mamba(layers, states, x):
        out = []
        for layer, st in zip(layers, states):
            x, st = mamba2_block(layer, x, cfg.ssm, state=st, impl="scan")
            out.append(st)
        return x, out

    x, groups, attn = x0, [], []
    for i, (layers, states, cache) in enumerate(zip(net.mamba_groups, caches.mamba_groups,
                                                    caches.attn)):
        x, st = mamba(layers, states, x)
        groups.append(st)
        x, cache = _shared_block(net.shared, i, x, x0, cfg, positions=positions, cache=cache)
        attn.append(cache)
    x, tail = mamba(net.mamba_tail, caches.mamba_tail, x)
    logits = _logits(net, x, cfg)[:, 0, : cfg.vocab]
    return logits, writeback(ZambaCaches(groups, tail, attn, caches.pos + 1))


def zamba_prefill(net: Zamba, batch: dict, cfg: ModelConfig, capacity: int, *,
                  impl: str = "auto") -> tuple:
    """The prompt pass collecting the Mamba2 states and the shared
    invocations' KV caches of ``capacity`` rows -> (the last real token's
    logits fp32 [B, V], caches).

    ``batch["lengths"]`` ([B] int, optional): the true prompt lengths of a
    right-padded bucket, threaded into the Mamba2 blocks (padded positions
    are no-ops) and the KV packing, so the carried state is the unpadded
    prompt's. ``impl`` is the attention route ("pallas": the flash kernel)."""
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x0 = embedding(net.embed, tokens, getattr(torch, cfg.compute_dtype))
    b, s = tokens.shape
    positions = text_positions(b, s, device=tokens.device)

    def mamba(layers, x):
        out = []
        for layer in layers:
            x, st = mamba2_block(layer, x, cfg.ssm, impl="chunked", lengths=lengths)
            out.append(st)
        return x, out

    x, groups, attn = x0, [], []
    for i, layers in enumerate(net.mamba_groups):
        x, st = mamba(layers, x)
        groups.append(st)
        x, cache = _shared_block(net.shared, i, x, x0, cfg, positions=positions, impl=impl,
                                 capacity=capacity, lengths=lengths)
        attn.append(cache)
    x, tail = mamba(net.mamba_tail, x)
    logits = _logits(net, _last_valid(x, lengths), cfg)[:, 0, : cfg.vocab]
    pos = (torch.full((b,), s, dtype=torch.int32, device=tokens.device) if lengths is None
           else lengths.to(torch.int32))
    return logits, ZambaCaches(groups, tail, attn, pos)
