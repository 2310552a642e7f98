"""The RWKV-6 ("Finch") language model, attention-free: the ``ssm`` family.

Counterpart of ``repro/models/rwkv_lm.py``. Structure: embed -> LN0 ->
N x (time mix + channel mix) -> LN -> head. Decode carries (tm_last,
cm_last, wkv) a layer: a state whose size does not grow with the sequence.
The JAX package stacks the layers and runs them with ``jax.lax.scan``; here
they are an ``nn.ModuleList`` walked in a loop, and the caches keep one
:class:`RWKVState` a layer in a list (``RWKVCaches.states``), as the gqa
LM's ``LMCaches.layers`` does. Parameters are stored in ``cfg.param_dtype``
and cast to ``cfg.compute_dtype`` at use; the norms keep fp32 statistics,
the WKV runs in fp32 and the logits are fp32.

Training (``rwkv_loss``) runs ``rwkv_forward`` under autograd, each layer
through ``transformer._remat(fn, cfg.remat)``; the scans are plain torch
(the JAX package has no kernel for them either).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.ssm import RWKVState, init_rwkv6_layer, rwkv6_block
from repro_torch.models.transformer import (
    _last_valid,
    _remat,
    mask_padded_logits,
    padded_vocab,
)
from repro_torch.nn.modules import (
    Embedding,
    LayerNorm,
    dense,
    embedding,
    init_dense,
    init_embedding,
    init_layernorm,
    layernorm,
)


class RWKVLM(nn.Module):
    """``embed``, ``ln0``, ``layers`` (RWKV-6 layers), ``final_norm``,
    ``lm_head``: the JAX tree's leaves, its stacked ``layers`` split."""

    def __init__(self, embed: Embedding, ln0: LayerNorm, layers: list, final_norm: LayerNorm,
                 lm_head: nn.Linear):
        super().__init__()
        self.embed = embed
        self.ln0 = ln0
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head


def init_rwkv_lm(cfg: ModelConfig, *, generator: torch.Generator, device=None) -> RWKVLM:
    """Weights drawn from ``generator`` (on its device) and moved to ``device``."""
    kw = dict(device=device, dtype=getattr(torch, cfg.param_dtype))
    vp = padded_vocab(cfg.vocab)
    embed = init_embedding(vp, cfg.d_model, generator=generator, **kw)
    layers = [init_rwkv6_layer(cfg.d_model, cfg.ssm, cfg.d_ff, generator=generator, **kw)
              for _ in range(cfg.num_layers)]
    head = init_dense(cfg.d_model, vp, generator=generator, **kw)
    return RWKVLM(embed, init_layernorm(cfg.d_model, **kw), layers,
                  init_layernorm(cfg.d_model, **kw), head)


def _embed(net: RWKVLM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return layernorm(net.ln0, embedding(net.embed, tokens, getattr(torch, cfg.compute_dtype)))


def rwkv_forward(net: RWKVLM, tokens: torch.Tensor, cfg: ModelConfig, *,
                 impl: str = "chunked") -> tuple:
    """tokens [B, S] -> (logits fp32 [B, S, V_padded] with the padded tail
    at -inf, a zero aux loss)."""
    x = _embed(net, tokens, cfg)
    layer_fn = _remat(lambda layer, h: rwkv6_block(layer, h, cfg.ssm, impl=impl)[0], cfg.remat)
    for layer in net.layers:
        x = layer_fn(layer, x)
    logits = dense(net.lm_head, layernorm(net.final_norm, x)).float()
    return mask_padded_logits(logits, cfg.vocab), torch.zeros((), device=x.device)


def rwkv_loss(net: RWKVLM, batch: dict, cfg: ModelConfig, *, impl: str = "chunked"):
    """Next-token cross-entropy: ``mean(logsumexp(logits) - gold)``."""
    logits, _ = rwkv_forward(net, batch["tokens"], cfg, impl=impl)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


class RWKVCaches(NamedTuple):
    states: list          # one RWKVState a layer
    pos: torch.Tensor     # [B] int32, the next position of each sequence slot


def init_rwkv_caches(batch: int, cfg: ModelConfig, capacity: int = 0, *,
                     device=None) -> RWKVCaches:
    """Zero states (fp32). The state does not grow with the sequence, so
    ``capacity`` sizes nothing; it is taken for the serving pools'
    ``init_caches(batch, capacity, device=)`` contract."""
    d = cfg.ssm.head_dim
    h = cfg.d_model // d
    zeros = lambda *shape: torch.zeros(*shape, dtype=torch.float32, device=device)
    states = [RWKVState(zeros(batch, cfg.d_model), zeros(batch, cfg.d_model),
                        zeros(batch, h, d, d)) for _ in range(cfg.num_layers)]
    return RWKVCaches(states, torch.zeros(batch, dtype=torch.int32, device=device))


def rwkv_prefill(net: RWKVLM, batch: dict, cfg: ModelConfig, capacity: int = 0, *,
                 impl: str = "chunked") -> tuple:
    """Run whole prompts and collect each layer's recurrent state -> (the
    last real token's logits fp32 [B, V], caches).

    ``batch["lengths"]`` ([B] int, optional): the true prompt lengths of a
    right-padded bucket; padded positions are recurrence no-ops (see
    ``ssm.rwkv6_time_mix``), so the carried states are the unpadded
    prompt's. ``capacity`` sizes nothing (the state has no token axis)."""
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    x = _embed(net, tokens, cfg)
    states = []
    for layer in net.layers:
        x, st = rwkv6_block(layer, x, cfg.ssm, impl=impl, lengths=lengths)
        states.append(st)
    b, s = tokens.shape
    x = layernorm(net.final_norm, _last_valid(x, lengths))
    logits = dense(net.lm_head, x)[:, 0, : cfg.vocab].float()
    pos = (torch.full((b,), s, dtype=torch.int32, device=tokens.device) if lengths is None
           else lengths.to(torch.int32))
    return logits, RWKVCaches(states, pos)


def rwkv_decode_step(net: RWKVLM, token: torch.Tensor, caches, cfg: ModelConfig) -> tuple:
    """One token a sequence: token [B, 1] -> (logits fp32 [B, V], caches one
    position on), every layer through the scan form.

    ``caches`` may be a paged pool's ``PagedCacheView``: the state has no
    token axis, so the view holds it dense and resolves to it as it is."""
    from repro_torch.serve.pool.views import resolve_cache_view

    caches, writeback = resolve_cache_view(caches)
    x = _embed(net, token, cfg)
    states = []
    for layer, st in zip(net.layers, caches.states):
        x, st = rwkv6_block(layer, x, cfg.ssm, state=st, impl="scan")
        states.append(st)
    logits = dense(net.lm_head, layernorm(net.final_norm, x))[:, 0, : cfg.vocab].float()
    return logits, writeback(RWKVCaches(states, caches.pos + 1))
