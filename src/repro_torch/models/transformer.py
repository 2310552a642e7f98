"""Decoder-only LMs: the causal FLARE LM (``flare_lm``), the gqa and MLA
decoders (the ``dense`` family, e.g. qwen2 and minicpm3) and the MLA + MoE
decoder (the ``moe`` family, deepseek-v2-lite): forward, loss, prefill,
decode; and the encoder-decoder (the ``encdec`` / ``audio`` family,
seamless-m4t-large-v2): encode, forward, loss, prefill, decode.

Counterpart of ``repro/models/transformer.py``.
The JAX package stacks the layers (a leading [L] axis on every leaf) and
runs them with ``jax.lax.scan``; here they are ``nn.ModuleList``s walked in
a loop, and ``repro_torch.interop.unstack_layers`` carries a JAX tree in.
An MoE config's ``first_dense_layers`` leading layers take a SwiGLU FFN
(``LM.dense_layers``, the JAX tree's ``dense_layers`` stack) and run before
``LM.layers``, whose FFN is the MoE (``models/moe.py``); a layer's FFN is
the module it holds. Parameters are stored in ``cfg.param_dtype`` (fp32)
and cast to ``cfg.compute_dtype`` at use; norms keep fp32 statistics and
the logits are fp32. The norms are rmsnorms or layernorms as ``cfg.norm``
says (the decoder-only LMs take rmsnorms; the encoder-decoder's are
layernorms).

Each layer is pre-norm: ``x += mix(norm1(x)); x += ffn(norm2(x))``. For
``flare_lm`` the mixer is causal FLARE over ResMLP K/V projections with
per-head latent queries (``core/flare.py::FlareLayer``): ``lm_forward`` runs
it through the model's resolved plan (the causal kernel on the card);
``lm_prefill`` is pinned to the stateful chunked scan
(``flare_causal_with_state``), since it must return each layer's latent
state, and ``lm_decode_step`` appends one token to every state
(``stream_append``). For ``gqa`` the mixer is rope'd grouped-query attention,
for ``mla`` multi-head latent attention (``models/attention.py``); forward
and prefill attend through ``attn_sdpa``'s ``impl`` route ("auto", or
"pallas" for the flash kernel, which MLA's unequal q/v head dims do not
take), prefill returns each layer's KV or latent cache, and decode reads it
densely or, when the caches are a paged pool's kernel view, through the
paged-attention kernel (MLA in the absorbed form). ``lm_prefill_suffix``
continues caches that already hold a shared prompt prefix (the serving
engine's prefix cache) by the suffix alone. ``lm_forward`` returns the sum
of the MoE layers' load-balancing losses beside the logits, and
``lm_loss`` adds ``0.01`` times it.

Training (``lm_loss``) runs ``lm_forward`` under autograd, each decoder
layer through ``_remat(fn, cfg.remat)``, the counterpart of the JAX
package's ``jax.checkpoint`` around its scanned layer: with ``"full"`` the
backward keeps only each layer's input and recomputes the layer. The
mixers train on plain torch (``causal_stream`` for flare_lm; ``attn_sdpa``'s
``xla`` / ``chunked`` routes for gqa), as in the JAX package, whose causal
and flash kernels are forward-only.

The encoder-decoder (``EncDec``): ``encode`` runs the source embeddings
(the stubbed speech frontend's frames) through ``cfg.num_encoder_layers``
bidirectional pre-norm layers, each mixing by non-causal GQA (through
``attn_sdpa``'s ``impl`` route: "pallas" is the flash kernel) or, with
``encoder_mixer="flare"``, by a ``FlareLayer`` through the model's resolved
plan (on the card the fused FLARE kernel, in the compute dtype). Each
decoder layer runs causal self-attention, then cross-attention whose
queries are rope'd at the decoder's positions and whose keys at the
memory's, then the FFN. ``encdec_forward`` computes every layer's
cross-attention K/V from the memory before the decoder runs
(``_precompute_cross_kv``); ``encdec_prefill`` and ``encdec_decode_step``
compute them in each layer from the memory the caches carry, every step,
as the JAX package does (no cross-attention K/V cache). The decode step's
cross-attention is on "auto" whatever route the prefill took.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.config import ModelConfig, replace
from repro_torch.core.flare import (
    FlareLayer,
    _merge_heads,
    _split_heads,
    flare_layer,
    init_flare_layer,
)
from repro_torch.core.flare_stream import flare_causal_with_state, stream_append, stream_init
from repro_torch.models.attention import (
    GQA,
    _expand_kv,
    _heads,
    _unheads,
    attn_sdpa,
    gqa_decode,
    gqa_extend,
    gqa_forward,
    init_gqa,
    init_kv_cache,
    init_mla,
    init_mla_cache,
    mla_decode,
    mla_extend,
    mla_forward,
    prefill_kv_cache,
    prefill_mla_cache,
)
from repro_torch.models.moe import MoE, init_moe, moe_ffn
from repro_torch.models.rope import apply_rope, rope_angles, text_mrope_positions, text_positions
from repro_torch.nn.modules import (
    Embedding,
    RMSNorm,
    dense,
    embedding,
    init_dense,
    init_embedding,
    init_layernorm,
    init_rmsnorm,
    init_swiglu,
    layernorm,
    resmlp,
    rmsnorm,
    swiglu,
)

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(vocab: int) -> int:
    """The vocab rounded up to a multiple of 256, as the JAX package stores
    the embedding and the head (there, for tensor-parallel sharding)."""
    return -(-vocab // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def mask_padded_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """-inf on the padded tail, so softmax, logsumexp and argmax ignore it."""
    if logits.shape[-1] == vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= vocab, -torch.inf)


def _last_valid(x: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """x [B, S, C] -> [B, 1, C] at each row's last real position (prefill
    right-pads prompts to a bucket)."""
    if lengths is None:
        return x[:, -1:]
    idx = (lengths - 1).clamp(0, x.shape[1] - 1).to(torch.long)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


class DecoderLayer(nn.Module):
    """Parameters ``norm1``, ``attn`` (a FlareLayer, a GQA or an MLA),
    ``norm2``, ``mlp`` (a SwiGLU or an MoE), as one layer of the JAX tree's
    stacked ``layers`` (or ``dense_layers``)."""

    def __init__(self, norm1: RMSNorm, attn, norm2: RMSNorm, mlp):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn
        self.norm2 = norm2
        self.mlp = mlp


class LM(nn.Module):
    """``dense_layers`` (an MoE config's leading dense-FFN layers; empty
    otherwise) run before ``layers``."""

    def __init__(self, embed: Embedding, final_norm: RMSNorm, layers: list,
                 lm_head: Optional[nn.Linear], dense_layers: tuple = ()):
        super().__init__()
        self.embed = embed
        self.final_norm = final_norm
        self.dense_layers = nn.ModuleList(dense_layers)
        self.layers = nn.ModuleList(layers)
        self.lm_head = lm_head


def _check_cfg(cfg: ModelConfig) -> None:
    if cfg.attn.kind not in ("flare_stream", "gqa", "mla") or cfg.norm != "rmsnorm":
        raise ValueError(f"the port's LM has flare_stream, gqa or mla mixers and rmsnorm, not "
                         f"{cfg.attn.kind!r} / {cfg.norm!r}")


def init_decoder_layer(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                       dtype=torch.float32) -> DecoderLayer:
    """A layer of ``cfg``'s mixer whose FFN is the MoE when ``cfg.moe`` is
    set, the SwiGLU otherwise."""
    kw = dict(device=device, dtype=dtype)
    norm1 = _norm_init(cfg, cfg.d_model, **kw)
    if cfg.attn.kind == "gqa":
        attn = init_gqa(cfg.attn, cfg.d_model, generator=generator, **kw)
    elif cfg.attn.kind == "mla":
        attn = init_mla(cfg.attn, cfg.d_model, generator=generator, **kw)
    else:
        attn = init_flare_layer(cfg.d_model, cfg.attn.num_heads, cfg.attn.flare_latents,
                                generator=generator, kv_proj_layers=3, **kw)
    mlp = (init_moe(cfg.moe, cfg.d_model, generator=generator, **kw) if cfg.moe is not None
           else init_swiglu(cfg.d_model, cfg.d_ff, generator=generator, **kw))
    return DecoderLayer(norm1, attn, _norm_init(cfg, cfg.d_model, **kw), mlp)


def init_dense_ffn_layer(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                         dtype=torch.float32) -> DecoderLayer:
    """As :func:`init_decoder_layer` with a SwiGLU FFN of ``cfg.d_ff``
    whatever ``cfg.moe`` says (deepseek's leading layer)."""
    return init_decoder_layer(replace(cfg, moe=None), generator=generator, device=device,
                              dtype=dtype)


def _num_dense(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def init_lm(cfg: ModelConfig, *, generator: torch.Generator, device=None) -> LM:
    """Weights drawn from ``generator`` (on its device: the CPU's, or a
    card's) and moved to ``device`` tensor by tensor."""
    _check_cfg(cfg)
    kw = dict(device=device, dtype=_dtype(cfg.param_dtype))
    vp = padded_vocab(cfg.vocab)
    n_dense = _num_dense(cfg)
    embed = init_embedding(vp, cfg.d_model, generator=generator, **kw)
    final_norm = _norm_init(cfg, cfg.d_model, **kw)
    layers = [init_decoder_layer(cfg, generator=generator, **kw)
              for _ in range(cfg.num_layers - n_dense)]
    dense_layers = [init_dense_ffn_layer(cfg, generator=generator, **kw) for _ in range(n_dense)]
    head = None if cfg.tie_embeddings else init_dense(cfg.d_model, vp, generator=generator, **kw)
    return LM(embed, final_norm, layers, head, dense_layers)


def _norm_init(cfg: ModelConfig, dim: int, *, device=None, dtype=torch.float32):
    """An RMSNorm or a LayerNorm, as ``cfg.norm`` says."""
    if cfg.norm == "rmsnorm":
        return init_rmsnorm(dim, device=device, dtype=dtype)
    return init_layernorm(dim, device=device, dtype=dtype)


def _norm(cfg: ModelConfig, norm, x: torch.Tensor) -> torch.Tensor:
    """``cfg.norm`` of x at ``cfg.norm_eps`` (fp32 statistics, x's dtype out)."""
    if cfg.norm == "rmsnorm":
        return rmsnorm(norm, x, eps=cfg.norm_eps)
    return layernorm(norm, x, eps=cfg.norm_eps)


def _kv(fl: FlareLayer, xin: torch.Tensor, heads: int):
    """The mixer's k and v [B, H, S, D], strided split-head views."""
    return _split_heads(resmlp(fl.k_proj, xin), heads), _split_heads(resmlp(fl.v_proj, xin), heads)


def _flare_stream_mix(fl: FlareLayer, x: torch.Tensor, cfg: ModelConfig, plan) -> torch.Tensor:
    """Causal FLARE as the LM mixer, through the plan resolved at model build
    (a registry lookup, never a re-resolve)."""
    from repro_torch.core.policy import run_plan

    k, v = _kv(fl, x, cfg.attn.num_heads)
    y = run_plan(plan, fl.q_latent.to(x.dtype), k, v)
    return dense(fl.out_proj, _merge_heads(y))


def _ffn_aux(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor) -> tuple:
    """(x plus the layer's FFN of norm2(x), the MoE's aux loss or None): the
    module the layer holds decides (a dense layer of an MoE model holds a
    SwiGLU)."""
    xin = _norm(cfg, layer.norm2, x)
    if isinstance(layer.mlp, MoE):
        m, aux = moe_ffn(layer.mlp, xin, cfg.moe)
        return x + m, aux
    return x + swiglu(layer.mlp, xin), None


def _ffn(cfg: ModelConfig, layer: DecoderLayer, x: torch.Tensor) -> torch.Tensor:
    return _ffn_aux(cfg, layer, x)[0]


def _embed(net: LM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return embedding(net.embed, tokens, _dtype(cfg.compute_dtype))


def _logits(net: LM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The head of the final-normed x, fp32 (the padded vocab kept)."""
    if cfg.tie_embeddings:
        return (x @ net.embed.table.to(x.dtype).T).float()
    return dense(net.lm_head, x).float()


def _positions(cfg: ModelConfig, b: int, s: int, device) -> torch.Tensor:
    """Text positions [B, S] (M-RoPE: [3, B, S])."""
    if cfg.attn.mrope_sections is not None:
        return text_mrope_positions(b, s, device=device)
    return text_positions(b, s, device=device)


# the batch-free matmuls (projections, MLPs, the head) that "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under activation checkpointing while autograd records:
    "full" keeps only its inputs for the backward and recomputes the rest;
    "dots" also keeps the outputs of the batch-free matmuls (``aten.mm`` /
    ``aten.addmm``), the counterpart of ``dots_with_no_batch_dims_saveable``,
    and recomputes the rest, attention's batched products included; "none"
    keeps everything. Without autograd ``fn`` runs plain."""
    if mode not in ("full", "dots", "none"):
        raise ValueError(f"remat must be 'full', 'dots' or 'none', not {mode!r}")
    if mode == "none":
        return fn
    context_fn = (ckpt.noop_context_fn if mode == "full" else
                  lambda: ckpt.create_selective_checkpoint_contexts(_save_dots))

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)

    return run


def _decoder_layer(layer: DecoderLayer, x: torch.Tensor, cfg: ModelConfig, positions,
                   impl: str, plan) -> tuple:
    """One pre-norm layer: the mixer's residual, then the FFN's -> (x, the
    MoE's aux loss or None)."""
    xin = _norm(cfg, layer.norm1, x)
    if cfg.attn.kind == "gqa":
        x = x + gqa_forward(layer.attn, xin, cfg.attn, positions=positions, impl=impl)
    elif cfg.attn.kind == "mla":
        x = x + mla_forward(layer.attn, xin, cfg.attn, positions=positions, impl=impl)
    else:
        x = x + _flare_stream_mix(layer.attn, xin, cfg, plan)
    return _ffn_aux(cfg, layer, x)


def _all_layers(net: LM) -> list:
    """The leading dense-FFN layers, then the rest, in the order they run."""
    return [*net.dense_layers, *net.layers]


def lm_forward(net: LM, tokens: torch.Tensor, cfg: ModelConfig, *, impl: str = "auto",
               plan=None) -> tuple:
    """Full-sequence forward: tokens [B, S] -> (logits fp32 [B, S, V_padded]
    with the padded tail at -inf, the sum of the MoE layers' aux losses,
    fp32, 0 without MoE). ``plan`` is the causal MixerPlan resolved at model
    build (flare_lm); gqa and mla attention take ``attn_sdpa``'s ``impl``
    route ("pallas": the flash kernel), which flare_lm ignores, as in the
    JAX package. Under autograd each layer runs through
    ``_remat(..., cfg.remat)``."""
    x = _embed(net, tokens, cfg)
    positions = (_positions(cfg, *tokens.shape, tokens.device)
                 if cfg.attn.kind in ("gqa", "mla") else None)
    layer_fn = _remat(lambda layer, h: _decoder_layer(layer, h, cfg, positions, impl, plan),
                      cfg.remat)
    aux = torch.zeros((), device=x.device)
    for layer in _all_layers(net):
        x, a = layer_fn(layer, x)
        if a is not None:
            aux = aux + a
    logits = _logits(net, _norm(cfg, net.final_norm, x), cfg)
    return mask_padded_logits(logits, cfg.vocab), aux


def lm_loss(net: LM, batch: dict, cfg: ModelConfig, *, impl: str = "auto",
            plan=None) -> torch.Tensor:
    """Next-token cross-entropy over ``batch["tokens"]`` [B, S] and
    ``batch["labels"]`` [B, S] (int32 from ``TokenStream``):
    ``mean(logsumexp(logits) - gold) + 0.01 * aux`` on the fp32 logits, the
    padded vocab at -inf, aux the MoE layers' summed load-balancing loss.
    ``plan``: flare_lm's train plan (a grad-capable one); gqa and mla
    attend through ``impl``."""
    logits, aux = lm_forward(net, batch["tokens"], cfg, impl=impl, plan=plan)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean() + 0.01 * aux


class LMCaches(NamedTuple):
    """The JAX ``LMCaches``. ``dense`` is an empty list where the JAX
    package has None (no leading dense layers): a torch pytree takes None
    for a leaf."""
    dense: list           # one cache per leading dense-FFN layer (``LM.dense_layers``)
    layers: list          # one FlareState (flare_lm), KVCache (gqa) or MLACache (mla) a layer
    pos: torch.Tensor     # [B] int32, the next position of each sequence


def init_lm_caches(batch: int, cfg: ModelConfig, capacity: int, *, device=None) -> LMCaches:
    """Fresh caches. A FLARE state is O(M*D) per head whatever the sequence
    length, so ``capacity`` does not size it; a gqa layer's KV cache holds
    ``capacity`` rows (``min(capacity, window)`` when windowed), an mla
    layer's latent cache ``capacity`` rows, both in bf16."""
    heads = cfg.attn.num_heads

    def one():
        if cfg.attn.kind == "gqa":
            return init_kv_cache(batch, cfg.attn, capacity, device=device)
        if cfg.attn.kind == "mla":
            return init_mla_cache(batch, cfg.attn, capacity, device=device)
        return stream_init(batch, heads, cfg.attn.flare_latents, cfg.d_model // heads,
                           device=device)

    n_dense = _num_dense(cfg)
    return LMCaches(dense=[one() for _ in range(n_dense)],
                    layers=[one() for _ in range(cfg.num_layers - n_dense)],
                    pos=torch.zeros(batch, dtype=torch.int32, device=device))


def lm_prefill(net: LM, batch: dict, cfg: ModelConfig, capacity: int, *,
               impl: str = "auto") -> tuple:
    """Run whole prompts and return (last-token logits fp32 [B, V], caches).

    ``batch["tokens"]`` [B, S]; ``batch["lengths"]`` ([B] int, optional)
    gives the true prompt lengths of a right-padded bucket: the mask keeps
    the padding out of the carried states, and the logits are taken at each
    row's last real position. Each layer runs the stateful chunked scan of
    ``cfg.attn.flare_chunk`` tokens, not the model's plan: the plan's
    kernel returns no state. A gqa or mla layer attends through
    ``attn_sdpa``'s ``impl`` route ("pallas": the flash kernel) and returns
    its KV or latent cache of ``capacity`` rows; flare_lm ignores ``impl``."""
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    if cfg.attn.kind in ("gqa", "mla"):
        return _attn_prefill(net, tokens, lengths, cfg, capacity, impl)
    x = _embed(net, tokens, cfg)
    b, s = tokens.shape
    mask = None
    if lengths is not None:
        mask = torch.arange(s, device=tokens.device)[None, :] < lengths[:, None]
    states = []
    for layer in net.layers:
        fl = layer.attn
        k, v = _kv(fl, _norm(cfg, layer.norm1, x), cfg.attn.num_heads)
        st, y = flare_causal_with_state(fl.q_latent.to(x.dtype), k, v,
                                        chunk_size=cfg.attn.flare_chunk, mask=mask)
        states.append(st)
        x = _ffn(cfg, layer, x + dense(fl.out_proj, _merge_heads(y)))
    x = _norm(cfg, net.final_norm, _last_valid(x, lengths))
    logits = _logits(net, x, cfg)[:, 0, : cfg.vocab]
    pos = (torch.full((b,), s, dtype=torch.int32, device=tokens.device) if lengths is None
           else lengths.to(torch.int32))
    return logits, LMCaches([], states, pos)


def _attn_prefill(net: LM, tokens: torch.Tensor, lengths: Optional[torch.Tensor],
                  cfg: ModelConfig, capacity: int, impl: str) -> tuple:
    """The gqa / mla prefill: causal attention over the bucket (right-padding
    cannot reach a real position), each layer's rope'd K/V (gqa) or latents
    and rotary key (mla) packed into a cache of ``capacity`` rows with the
    true ``lengths``; the leading dense-FFN layers first."""
    x = _embed(net, tokens, cfg)
    b, s = tokens.shape
    positions = _positions(cfg, b, s, tokens.device)

    def run(layers, x):
        caches = []
        for layer in layers:
            xin = _norm(cfg, layer.norm1, x)
            if cfg.attn.kind == "gqa":
                a, (k, v) = gqa_forward(layer.attn, xin, cfg.attn, positions=positions,
                                        impl=impl, return_kv=True)
                caches.append(prefill_kv_cache(k, v, cfg.attn, capacity, lengths))
            else:
                a, (c, kr) = mla_forward(layer.attn, xin, cfg.attn, positions=positions,
                                         impl=impl, return_kv=True)
                caches.append(prefill_mla_cache(c, kr, capacity, lengths))
            x = _ffn(cfg, layer, x + a)
        return x, caches

    x, dense_caches = run(net.dense_layers, x)
    x, caches = run(net.layers, x)
    x = _norm(cfg, net.final_norm, _last_valid(x, lengths))
    logits = _logits(net, x, cfg)[:, 0, : cfg.vocab]
    pos = (torch.full((b,), s, dtype=torch.int32, device=tokens.device) if lengths is None
           else lengths.to(torch.int32))
    return logits, LMCaches(dense_caches, caches, pos)


def lm_prefill_suffix(net: LM, batch: dict, caches: LMCaches, cfg: ModelConfig) -> tuple:
    """The prefix cache's suffix prefill: ``caches`` already hold each row's
    shared prompt prefix (``batch["offsets"]`` [B] tokens, gathered from
    block storage by the serving pool); run only the suffix,
    ``batch["tokens"]`` [B, S] right-padded with true ``batch["lengths"]``,
    at absolute positions ``offset + i`` through ``gqa_extend`` (or
    ``mla_extend``), and return (the last real token's logits fp32 [B, V],
    the caches at the full prompt's length). gqa and mla only: a FLARE
    state is a running summary that no range of shared blocks can rebuild,
    so ``flare_lm`` keeps the full prompt path (``models/api.py`` leaves its
    ``prefill_suffix`` unset)."""
    if cfg.attn.kind not in ("gqa", "mla"):
        raise ValueError(f"prefill_suffix supports gqa and mla, not {cfg.attn.kind!r}")
    tokens, lengths, offsets = batch["tokens"], batch["lengths"], batch["offsets"]
    b, s = tokens.shape
    x = _embed(net, tokens, cfg)
    pos = offsets.long()[:, None] + torch.arange(s, device=tokens.device)[None, :]
    positions = pos[None].expand(3, b, s) if cfg.attn.mrope_sections is not None else pos
    ext = gqa_extend if cfg.attn.kind == "gqa" else mla_extend

    def run(layers, caches, x):
        out = []
        for layer, cache in zip(layers, caches):
            a, cache = ext(layer.attn, _norm(cfg, layer.norm1, x), cfg.attn, cache,
                           positions=positions, offsets=offsets, lengths=lengths)
            out.append(cache)
            x = _ffn(cfg, layer, x + a)
        return x, out

    x, dense_caches = run(net.dense_layers, caches.dense, x)
    x, layer_caches = run(net.layers, caches.layers, x)
    x = _norm(cfg, net.final_norm, _last_valid(x, lengths))
    logits = _logits(net, x, cfg)[:, 0, : cfg.vocab]
    return logits, LMCaches(dense_caches, layer_caches,
                            offsets.to(torch.int32) + lengths.to(torch.int32))


def _decode_positions(pos: torch.Tensor, b: int, mrope: bool) -> torch.Tensor:
    """Per-slot decode positions [B, 1] (M-RoPE: [3, B, 1]) from the caches'
    [B] position vector (a scalar broadcasts)."""
    if pos.dim() == 0:
        pos = pos.expand(b)
    if mrope:
        return pos[None, :, None].expand(3, b, 1)
    return pos[:, None]


def lm_decode_step(net: LM, token: torch.Tensor, caches, cfg: ModelConfig) -> tuple:
    """One token per sequence: token [B, 1] -> (logits fp32 [B, V], caches
    advanced by one position). A flare_lm layer appends the token to its
    state; a gqa layer writes its row into the KV cache and attends over it,
    an mla layer its latent row, attending in the latent space. The leading
    dense-FFN layers run first, over ``caches.dense``.

    ``caches`` may be a :class:`repro_torch.serve.pool.views.PagedCacheView`
    (the serving engine's block-paged pool): it resolves here into caches
    (a dense gather, or kernel views of the pages) and a write-back, which
    returns the view whose ``pool`` the engine carries on."""
    from repro_torch.serve.pool.views import resolve_cache_view

    caches, writeback = resolve_cache_view(caches)
    x = _embed(net, token, cfg)
    heads = cfg.attn.num_heads
    positions = None
    if cfg.attn.kind in ("gqa", "mla"):
        positions = _decode_positions(caches.pos, token.shape[0],
                                      cfg.attn.mrope_sections is not None)

    def run(layers, states, x):
        out = []
        for layer, state in zip(layers, states):
            xin = _norm(cfg, layer.norm1, x)
            if cfg.attn.kind == "gqa":
                a, state = gqa_decode(layer.attn, xin, cfg.attn, state, positions=positions)
            elif cfg.attn.kind == "mla":
                a, state = mla_decode(layer.attn, xin, cfg.attn, state, positions=positions)
            else:
                fl = layer.attn
                k, v = _kv(fl, xin, heads)
                state, y = stream_append(state, fl.q_latent.to(x.dtype), k[:, :, 0], v[:, :, 0])
                a = dense(fl.out_proj, y.reshape(y.shape[0], 1, -1))
            out.append(state)
            x = _ffn(cfg, layer, x + a)
        return x, out

    x, dense_states = run(net.dense_layers, caches.dense, x)
    x, states = run(net.layers, caches.layers, x)
    logits = _logits(net, _norm(cfg, net.final_norm, x), cfg)[:, 0, : cfg.vocab]
    return logits, writeback(LMCaches(dense_states, states, caches.pos + 1))


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t backbone)
# ---------------------------------------------------------------------------


class EncoderLayer(nn.Module):
    """Parameters ``norm1``, ``attn`` (a FlareLayer, or a GQA with biases),
    ``norm2``, ``mlp`` (a SwiGLU), as one layer of the JAX tree's stacked
    ``encoder``."""

    def __init__(self, norm1, attn, norm2, mlp):
        super().__init__()
        self.norm1 = norm1
        self.attn = attn
        self.norm2 = norm2
        self.mlp = mlp


class CrossDecoderLayer(nn.Module):
    """Parameters ``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``,
    ``norm2``, ``mlp``, as one layer of the JAX tree's stacked ``decoder``."""

    def __init__(self, norm1, self_attn: GQA, norm_x, cross_attn: GQA, norm2, mlp):
        super().__init__()
        self.norm1 = norm1
        self.self_attn = self_attn
        self.norm_x = norm_x
        self.cross_attn = cross_attn
        self.norm2 = norm2
        self.mlp = mlp


class EncDec(nn.Module):
    """``embed`` (the padded vocab's rows), ``encoder``, ``enc_norm``,
    ``decoder``, ``final_norm``, ``lm_head``, as the JAX tree."""

    def __init__(self, embed: Embedding, encoder: list, enc_norm, decoder: list, final_norm,
                 lm_head: nn.Linear):
        super().__init__()
        self.embed = embed
        self.encoder = nn.ModuleList(encoder)
        self.enc_norm = enc_norm
        self.decoder = nn.ModuleList(decoder)
        self.final_norm = final_norm
        self.lm_head = lm_head


def _check_encdec_cfg(cfg: ModelConfig) -> None:
    if cfg.attn.kind != "gqa" or cfg.encoder_mixer not in ("attn", "flare"):
        raise ValueError(f"the port's encoder-decoder has gqa attention and an 'attn' or "
                         f"'flare' encoder, not {cfg.attn.kind!r} / {cfg.encoder_mixer!r}")


def init_encoder_layer(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                       dtype=torch.float32) -> EncoderLayer:
    """A FLARE layer (``flare_heads or num_heads`` heads, ``flare_latents or
    256`` latents, 3-layer ResMLP K/V projections) when ``encoder_mixer`` is
    "flare", else a GQA, and a SwiGLU FFN."""
    kw = dict(device=device, dtype=dtype)
    if cfg.encoder_mixer == "flare":
        attn = init_flare_layer(cfg.d_model, cfg.flare_heads or cfg.attn.num_heads,
                                cfg.flare_latents or 256, generator=generator,
                                kv_proj_layers=3, **kw)
    else:
        attn = init_gqa(cfg.attn, cfg.d_model, generator=generator, **kw)
    return EncoderLayer(_norm_init(cfg, cfg.d_model, **kw), attn,
                        _norm_init(cfg, cfg.d_model, **kw),
                        init_swiglu(cfg.d_model, cfg.d_ff, generator=generator, **kw))


def init_crossdec_layer(cfg: ModelConfig, *, generator: torch.Generator, device=None,
                        dtype=torch.float32) -> CrossDecoderLayer:
    kw = dict(device=device, dtype=dtype)
    norm = lambda: _norm_init(cfg, cfg.d_model, **kw)
    return CrossDecoderLayer(norm(), init_gqa(cfg.attn, cfg.d_model, generator=generator, **kw),
                             norm(), init_gqa(cfg.attn, cfg.d_model, generator=generator, **kw),
                             norm(), init_swiglu(cfg.d_model, cfg.d_ff, generator=generator,
                                                 **kw))


def init_encdec(cfg: ModelConfig, *, generator: torch.Generator, device=None) -> EncDec:
    """Weights drawn from ``generator`` (on its device: the CPU's, or a
    card's) and moved to ``device`` tensor by tensor."""
    _check_encdec_cfg(cfg)
    kw = dict(device=device, dtype=_dtype(cfg.param_dtype))
    vp = padded_vocab(cfg.vocab)
    embed = init_embedding(vp, cfg.d_model, generator=generator, **kw)
    encoder = [init_encoder_layer(cfg, generator=generator, **kw)
               for _ in range(cfg.num_encoder_layers)]
    decoder = [init_crossdec_layer(cfg, generator=generator, **kw)
               for _ in range(cfg.num_layers)]
    return EncDec(embed, encoder, _norm_init(cfg, cfg.d_model, **kw), decoder,
                  _norm_init(cfg, cfg.d_model, **kw),
                  init_dense(cfg.d_model, vp, generator=generator, **kw))


def encode(net: EncDec, src_embeds: torch.Tensor, cfg: ModelConfig, *, impl: str = "auto",
           plan=None) -> torch.Tensor:
    """src_embeds [B, S, C] from the (stubbed) modality frontend -> the
    memory [B, S, C] in the compute dtype. ``impl`` is the attention
    encoder's ``attn_sdpa`` route (non-causal); ``plan`` the FLARE encoder's
    resolved MixerPlan (None: the ambient policy). Under autograd each layer
    runs through ``_remat(..., cfg.remat)``."""
    x = src_embeds.to(_dtype(cfg.compute_dtype))
    positions = text_positions(x.shape[0], x.shape[1], device=x.device)

    def body(layer: EncoderLayer, x: torch.Tensor) -> torch.Tensor:
        xin = _norm(cfg, layer.norm1, x)
        if cfg.encoder_mixer == "flare":
            a = flare_layer(layer.attn, xin, policy=plan)
        else:
            a = gqa_forward(layer.attn, xin, cfg.attn, positions=positions, causal=False,
                            impl=impl)
        x = x + a
        return x + swiglu(layer.mlp, _norm(cfg, layer.norm2, x))

    layer_fn = _remat(body, cfg.remat)
    for layer in net.encoder:
        x = layer_fn(layer, x)
    return _norm(cfg, net.enc_norm, x)


def _rope(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return apply_rope(x, rope_angles(positions, cfg.attn.head_dim, cfg.attn.rope_theta))


def _memory_kv(attn: GQA, memory: torch.Tensor, cfg: ModelConfig, mem_pos: torch.Tensor):
    """One cross-attention's K (rope'd at the memory's positions) and V
    [B, Hkv, S, D] from the memory."""
    hkv = cfg.attn.num_kv_heads
    k = _heads(dense(attn.wk, memory), hkv)
    v = _heads(dense(attn.wv, memory), hkv)
    return _rope(cfg, k, mem_pos), v


def _precompute_cross_kv(net: EncDec, memory: torch.Tensor, cfg: ModelConfig) -> list:
    """Every decoder layer's cross-attention (K, V) [B, Hkv, S, D] at once,
    before the decoder runs: they depend on the memory alone."""
    mem_pos = text_positions(memory.shape[0], memory.shape[1], device=memory.device)
    return [_memory_kv(layer.cross_attn, memory, cfg, mem_pos) for layer in net.decoder]


def _cross_attend_kv(attn: GQA, q_in: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cfg: ModelConfig, q_pos: torch.Tensor, impl: str) -> torch.Tensor:
    """Cross-attention over precomputed (rope'd) memory K/V: q rope'd at the
    decoder's positions, no mask, through ``attn_sdpa``'s ``impl`` route."""
    a = cfg.attn
    q = _rope(cfg, _heads(dense(attn.wq, q_in), a.num_heads), q_pos)
    g = a.num_heads // a.num_kv_heads
    out = attn_sdpa(q, _expand_kv(k, g), _expand_kv(v, g), scale=1.0 / math.sqrt(a.head_dim),
                    causal=False, impl=impl)
    return dense(attn.wo, _unheads(out))


def _cross_attend(attn: GQA, q_in: torch.Tensor, memory: torch.Tensor, cfg: ModelConfig,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, impl: str) -> torch.Tensor:
    """Cross-attention with its K/V computed from the memory here."""
    k, v = _memory_kv(attn, memory, cfg, kv_pos)
    return _cross_attend_kv(attn, q_in, k, v, cfg, q_pos, impl)


def encdec_forward(net: EncDec, batch: dict, cfg: ModelConfig, *, impl: str = "auto",
                   plan=None) -> tuple:
    """Teacher-forced forward: ``batch["embeds"]`` [B, S, C] and
    ``batch["tokens"]`` [B, T] -> (logits fp32 [B, T, V_padded] with the
    padded tail at -inf, 0). Under autograd each encoder and decoder layer
    runs through ``_remat(..., cfg.remat)``."""
    memory = encode(net, batch["embeds"], cfg, impl=impl, plan=plan)
    tokens = batch["tokens"]
    y = _embed(net, tokens, cfg)
    positions = text_positions(*tokens.shape, device=tokens.device)
    cross_kv = _precompute_cross_kv(net, memory, cfg)

    def body(layer: CrossDecoderLayer, y: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
        y = y + gqa_forward(layer.self_attn, _norm(cfg, layer.norm1, y), cfg.attn,
                            positions=positions, causal=True, impl=impl)
        y = y + _cross_attend_kv(layer.cross_attn, _norm(cfg, layer.norm_x, y), k, v, cfg,
                                 positions, impl)
        return y + swiglu(layer.mlp, _norm(cfg, layer.norm2, y))

    layer_fn = _remat(body, cfg.remat)
    for layer, (k, v) in zip(net.decoder, cross_kv):
        y = layer_fn(layer, y, k, v)
    logits = dense(net.lm_head, _norm(cfg, net.final_norm, y)).float()
    return mask_padded_logits(logits, cfg.vocab), torch.zeros((), device=y.device)


def encdec_loss(net: EncDec, batch: dict, cfg: ModelConfig, *, impl: str = "auto",
                plan=None) -> torch.Tensor:
    """Cross-entropy of ``batch["labels"]`` [B, T] under the teacher-forced
    logits, ``mean(logsumexp(logits) - gold)``. The forward runs under
    ``mixer_policy(requires_grad=True)``: a bare (plan-less) FLARE encoder
    then resolves only grad-capable backends."""
    from repro_torch.core.policy import mixer_policy

    with mixer_policy(requires_grad=True):
        logits, _ = encdec_forward(net, batch, cfg, impl=impl, plan=plan)
    gold = logits.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


class EncDecCaches(NamedTuple):
    """The JAX ``EncDecCaches``: the decoder's self-attention caches (one
    per layer, the JAX tree's stacked ``KVCache``), the encoder's output and
    each sequence's next position."""
    self_caches: list      # one KVCache a decoder layer
    memory: torch.Tensor   # [B, S_src, C] the encoder's output, compute dtype
    pos: torch.Tensor      # [B] int32, per sequence slot


def encdec_prefill(net: EncDec, batch: dict, cfg: ModelConfig, capacity: int, *,
                   impl: str = "auto", plan=None) -> tuple:
    """Encode ``batch["embeds"]`` and teacher-force the target prefix
    ``batch["tokens"]`` [B, T] (no ``lengths``: every row is T long) ->
    (the last token's logits fp32 [B, V], EncDecCaches with each layer's
    self-attention K/V in a bf16 cache of ``capacity`` rows). ``impl``
    routes all three attentions (the encoder's, the decoder's causal
    self-attention and the cross-attention); ``plan`` is the FLARE
    encoder's."""
    memory = encode(net, batch["embeds"], cfg, impl=impl, plan=plan)
    tokens = batch["tokens"]
    b, s = tokens.shape
    y = _embed(net, tokens, cfg)
    positions = text_positions(b, s, device=tokens.device)
    mem_pos = text_positions(memory.shape[0], memory.shape[1], device=memory.device)
    caches = []
    for layer in net.decoder:
        a, (k, v) = gqa_forward(layer.self_attn, _norm(cfg, layer.norm1, y), cfg.attn,
                                positions=positions, causal=True, impl=impl, return_kv=True)
        caches.append(prefill_kv_cache(k, v, cfg.attn, capacity))
        y = y + a
        y = y + _cross_attend(layer.cross_attn, _norm(cfg, layer.norm_x, y), memory, cfg,
                              positions, mem_pos, impl)
        y = y + swiglu(layer.mlp, _norm(cfg, layer.norm2, y))
    y = _norm(cfg, net.final_norm, y[:, -1:])
    logits = dense(net.lm_head, y)[:, 0, : cfg.vocab].float()
    pos = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, EncDecCaches(caches, memory, pos)


def encdec_decode_step(net: EncDec, token: torch.Tensor, caches: EncDecCaches,
                       cfg: ModelConfig) -> tuple:
    """One token per sequence: token [B, 1] -> (logits fp32 [B, V], caches
    one position on). Each layer writes its self-attention row into its
    cache (in place) and attends over it, then attends over the memory,
    whose K/V it computes anew, on the "auto" route."""
    y = _embed(net, token, cfg)
    positions = _decode_positions(caches.pos, token.shape[0], False)
    memory = caches.memory
    mem_pos = text_positions(memory.shape[0], memory.shape[1], device=memory.device)
    new_caches = []
    for layer, cache in zip(net.decoder, caches.self_caches):
        a, cache = gqa_decode(layer.self_attn, _norm(cfg, layer.norm1, y), cfg.attn, cache,
                              positions=positions)
        new_caches.append(cache)
        y = y + a
        y = y + _cross_attend(layer.cross_attn, _norm(cfg, layer.norm_x, y), memory, cfg,
                              positions, mem_pos, "auto")
        y = y + swiglu(layer.mlp, _norm(cfg, layer.norm2, y))
    logits = dense(net.lm_head, _norm(cfg, net.final_norm, y))[:, 0, : cfg.vocab].float()
    return logits, EncDecCaches(new_caches, memory, caches.pos + 1)
